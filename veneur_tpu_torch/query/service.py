"""gRPC front for the live query subsystem: veneurtpu.Query/Query.

Rides the same plumbing idiom as distributed/rpc.py (hand-wired generic
handlers, insecure port, thread-pool executor). The one method is a
unary JSON-over-raw-bytes call — requests and responses are UTF-8 JSON
documents with identity (de)serializers, the same hand-framed-wire
pattern rpc.py uses for its raw handler path. A proto message would buy
nothing here: the query API is a small dict protocol shared verbatim
with the HTTP /query endpoint (both call QueryEngine.dispatch), and
keeping one schema for both fronts is the point.
"""

from __future__ import annotations

import json
from concurrent import futures
from typing import Optional

import grpc

SERVICE_NAME = "veneurtpu.Query"
QUERY_METHOD = f"/{SERVICE_NAME}/Query"


def make_query_server(engine, address: str = "127.0.0.1:0",
                      max_workers: int = 4) -> tuple[grpc.Server, int]:
    """Start a Query gRPC server over `engine`; returns (server, port)."""

    def query(request: bytes, context) -> bytes:
        try:
            req = json.loads(request.decode("utf-8")) if request else {}
        except (ValueError, UnicodeDecodeError) as exc:
            return json.dumps(
                {"error": f"bad request: {exc}"}).encode("utf-8")
        return json.dumps(engine.dispatch(req)).encode("utf-8")

    handlers = grpc.method_handlers_generic_handler(SERVICE_NAME, {
        "Query": grpc.unary_unary_rpc_method_handler(
            query,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        ),
    })
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((handlers,))
    port = server.add_insecure_port(address)
    server.start()
    return server, port


class QueryClient:
    """Thin client for the Query service (benchmarks, tests)."""

    def __init__(self, address: str, timeout_s: float = 5.0) -> None:
        self.address = address
        self.timeout_s = timeout_s
        self.channel = grpc.insecure_channel(address)
        self._call = self.channel.unary_unary(
            QUERY_METHOD,
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )

    def query(self, req: dict, timeout_s: Optional[float] = None) -> dict:
        body = json.dumps(req).encode("utf-8")
        resp = self._call(body, timeout=timeout_s or self.timeout_s)
        return json.loads(resp.decode("utf-8"))

    def close(self) -> None:
        self.channel.close()
