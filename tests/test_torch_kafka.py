"""The port's Kafka producer and sinks against the JAX package's, on the CPU
(after tests/test_kafka_wire.py and tests/test_sinks.py's Kafka case).

A scripted broker speaks real Kafka frames (Metadata v0, Produce v1,
every message CRC-checked) and records each request frame it reads. Each
scenario runs once against the JAX package's ``KafkaWireProducer`` and
once against the port's, each with a fresh broker, the message clock
pinned and ``random`` seeded alike: the request frames (metadata and produce, correlation ids
included), the messages the broker appended and the producer's delivered
and dropped counts are equal byte for byte. Concurrent senders are
compared as multisets, their interleaving being the scheduler's.
"""

from __future__ import annotations

import json
import random
import socket
import struct
import threading
import time
import zlib
from collections import Counter

import pytest

from veneur_tpu.core.metrics import InterMetric as JInter
from veneur_tpu.core.metrics import MetricType as JType
from veneur_tpu.sinks import kafka as jkafka
from veneur_tpu.sinks import kafka_wire as jkw
from veneur_tpu.ssf import SSFSpan as JSpan
from veneur_tpu_torch.core.metrics import InterMetric as TInter
from veneur_tpu_torch.core.metrics import MetricType as TType
from veneur_tpu_torch.protocol import ssf_wire as tssf_wire
from veneur_tpu_torch.sinks import kafka as tkafka
from veneur_tpu_torch.sinks import kafka_wire as tkw
from veneur_tpu_torch.sinks.kafka_wire import _Reader, enc_string
from veneur_tpu_torch.ssf import SSFSpan as TSpan

NOW = 1_700_000_000.25
PKGS = {"jax": dict(kw=jkw, kafka=jkafka, Inter=JInter, Type=JType,
                    Span=JSpan),
        "port": dict(kw=tkw, kafka=tkafka, Inter=TInter, Type=TType,
                     Span=TSpan)}


class FakeBroker:
    """A scripted one-node broker with N partitions a topic.

    ``produce_errors`` is a queue of error codes: each produce request
    takes one and answers it for every partition (0 is success). Messages
    are CRC-checked and appended on success only; every request frame is
    kept in ``frames``."""

    def __init__(self, partitions: int = 4) -> None:
        self.partitions = partitions
        self.unknown_topics: set[str] = set()
        self.node_id = 0
        self.received: list = []
        self.frames: list[bytes] = []
        self.metadata_requests = 0
        self.produce_requests = 0
        self.produce_errors: list[int] = []
        self.acks_seen: list[int] = []
        self._lock = threading.Lock()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.sock.listen(8)
        self._shutdown = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        try:
            self.sock.close()
        except OSError:
            pass

    def _serve(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                head = self._read_exact(conn, 4)
                if head is None:
                    return
                (size,) = struct.unpack(">i", head)
                frame = self._read_exact(conn, size)
                if frame is None:
                    return
                resp = self._dispatch(frame)
                if resp is not None:
                    conn.sendall(struct.pack(">i", len(resp)) + resp)
        except OSError:
            pass
        finally:
            conn.close()

    @staticmethod
    def _read_exact(conn, n):
        buf = b""
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def _dispatch(self, frame: bytes):
        with self._lock:
            self.frames.append(frame)
        r = _Reader(frame)
        api_key = r.i16()
        api_version = r.i16()
        corr = r.i32()
        r.string()
        if api_key == 3:
            assert api_version == 0
            with self._lock:
                self.metadata_requests += 1
            return self._metadata_response(r, corr)
        if api_key == 0:
            assert api_version == 1
            return self._produce_response(r, corr)
        raise AssertionError(f"unexpected api_key {api_key}")

    def _metadata_response(self, r: _Reader, corr: int) -> bytes:
        topics = [r.string() for _ in range(r.i32())]
        out = [struct.pack(">i", corr), struct.pack(">i", 1),
               struct.pack(">i", self.node_id), enc_string("127.0.0.1"),
               struct.pack(">i", self.port), struct.pack(">i", len(topics))]
        for t in topics:
            if t in self.unknown_topics:
                out += [struct.pack(">h", 3), enc_string(t),
                        struct.pack(">i", 0)]
                continue
            out += [struct.pack(">h", 0), enc_string(t),
                    struct.pack(">i", self.partitions)]
            for pid in range(self.partitions):
                out += [struct.pack(">hii", 0, pid, self.node_id),
                        struct.pack(">ii", 1, self.node_id),
                        struct.pack(">ii", 1, self.node_id)]
        return b"".join(out)

    def _parse_message_set(self, topic: str, part: int, mset: bytes):
        r = _Reader(mset)
        msgs = []
        while r.pos < len(mset):
            r.i64()
            msize = r.i32()
            msg = r._take(msize)
            (crc,) = struct.unpack(">I", msg[:4])
            assert crc == (zlib.crc32(msg[4:]) & 0xFFFFFFFF), "bad CRC"
            mr = _Reader(msg[4:])
            assert mr._take(1)[0] == 1
            mr._take(1)
            ts = mr.i64()
            klen = mr.i32()
            key = mr._take(klen) if klen >= 0 else None
            vlen = mr.i32()
            value = mr._take(vlen) if vlen >= 0 else None
            msgs.append((topic, part, key, value, ts))
        return msgs

    def _produce_response(self, r: _Reader, corr: int):
        acks = r.i16()
        r.i32()
        with self._lock:
            self.produce_requests += 1
            self.acks_seen.append(acks)
            err = self.produce_errors.pop(0) if self.produce_errors else 0
        resp_topics = []
        for _ in range(r.i32()):
            topic = r.string() or ""
            parts = []
            for _ in range(r.i32()):
                pid = r.i32()
                mset = r._take(r.i32())
                msgs = self._parse_message_set(topic, pid, mset)
                if err == 0:
                    with self._lock:
                        self.received.extend(msgs)
                parts.append(pid)
            resp_topics.append((topic, parts))
        if acks == 0:
            return None
        out = [struct.pack(">i", corr), struct.pack(">i", len(resp_topics))]
        for topic, parts in resp_topics:
            out += [enc_string(topic), struct.pack(">i", len(parts))]
            for pid in parts:
                out.append(struct.pack(">ihq", pid, err, 0))
        out.append(struct.pack(">i", 0))
        return b"".join(out)


@pytest.fixture
def pinned_time(monkeypatch):
    """The messages' timestamp clock, the same in both packages."""
    monkeypatch.setattr(time, "time", lambda: NOW)


def run_both(scenario, **broker_kw) -> dict:
    """``scenario(pkg, broker, producer)`` once a package, each against a
    fresh broker and with ``random`` seeded alike (a message without a key
    takes a random partition); per package what the broker saw and the
    counts."""
    out = {}
    for pkg, p in PKGS.items():
        broker = FakeBroker(**broker_kw)
        random.seed(12)
        try:
            prods = []

            def producer(**kw):
                prod = p["kw"].KafkaWireProducer(
                    f"127.0.0.1:{broker.port}", retry_max=3, **kw)
                prods.append(prod)
                return prod

            extra = scenario(pkg, broker, producer)
            for prod in prods:
                prod.close()
            out[pkg] = dict(
                frames=list(broker.frames), received=list(broker.received),
                metadata=broker.metadata_requests,
                produce=broker.produce_requests, acks=broker.acks_seen,
                counts=[(x.delivered, x.dropped) for x in prods],
                extra=extra)
        finally:
            broker.stop()
    return out


def test_produce_roundtrip(pinned_time):
    def scenario(pkg, broker, producer):
        prod = producer()
        for i in range(20):
            prod.send("spans", b"key%d" % i, b"value%d" % i)
        prod.flush()

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    rec = got["port"]["received"]
    assert len(rec) == 20
    assert (b"key7", b"value7") in {(k, v) for (_t, _p, k, v, _ts) in rec}
    assert all(t == "spans" and ts == int(NOW * 1000)
               for (t, _p, _k, _v, ts) in rec)


def test_hash_partitioning_matches_sarama(pinned_time):
    def scenario(pkg, broker, producer):
        prod = producer()
        for _ in range(3):
            prod.send("t", b"stable-key", b"v")
        prod.flush()
        return PKGS[pkg]["kw"]._fnv1a32(b"stable-key")

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    parts = {p for (_t, p, _k, _v, _ts) in got["port"]["received"]}
    h = got["port"]["extra"]
    if h >= 1 << 31:
        h -= 1 << 32
    assert parts == {abs(h) % 4}


def test_null_key_and_value(pinned_time):
    def scenario(pkg, broker, producer):
        prod = producer()
        prod.send("t", None, b"no-key")
        prod.send("t", b"no-value", None)
        prod.flush()

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    vals = {(k, v) for (_t, _p, k, v, _ts) in got["port"]["received"]}
    assert vals == {(None, b"no-key"), (b"no-value", None)}


def test_retriable_error_refreshes_metadata_and_retries(pinned_time):
    def scenario(pkg, broker, producer):
        broker.produce_errors = [6]
        prod = producer()
        prod.send("t", b"k", b"v")
        prod.flush()

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    g = got["port"]
    assert [(k, v) for (_t, _p, k, v, _ts) in g["received"]] == [(b"k", b"v")]
    assert g["counts"] == [(1, 0)]
    assert g["produce"] == 2 and g["metadata"] >= 2


def test_fatal_error_drops(pinned_time):
    def scenario(pkg, broker, producer):
        broker.produce_errors = [2]
        prod = producer()
        prod.send("t", b"k", b"v")
        prod.flush()

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"]["produce"] == 1
    assert got["port"]["counts"] == [(0, 1)]


def test_acks_none_fire_and_forget(pinned_time):
    def scenario(pkg, broker, producer):
        prod = producer(require_acks="none")
        prod.send("t", b"k", b"v")
        prod.flush()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not broker.received:
            time.sleep(0.01)

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"]["acks"] == [0]
    assert [(k, v) for (_t, _p, k, v, _ts) in got["port"]["received"]] == [
        (b"k", b"v")]


def test_buffer_messages_threshold_autoflushes(pinned_time):
    def scenario(pkg, broker, producer):
        prod = producer(buffer_messages=5)
        for i in range(5):
            prod.send("t", b"k%d" % i, b"v")
        return len(broker.received)

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    assert got["port"]["extra"] == 5


def test_unknown_topic_drops_with_backoff(pinned_time):
    def scenario(pkg, broker, producer):
        broker.unknown_topics.add("ghost")
        prod = producer()
        for _ in range(50):
            prod.send("ghost", b"k", b"v")
        dropped = prod.dropped
        prod.send("real", b"k", b"v")
        prod.flush()
        return dropped

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    g = got["port"]
    assert g["extra"] == 50 and g["metadata"] <= 2
    assert [(t, k) for (t, _p, k, _v, _ts) in g["received"]] == [
        ("real", b"k")]


def test_concurrent_senders_one_socket(pinned_time):
    def scenario(pkg, broker, producer):
        prod = producer(buffer_messages=3)
        errs = []

        def worker(n):
            try:
                for i in range(60):
                    prod.send("t", b"w%d-%d" % (n, i), b"v")
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(n,))
                   for n in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        prod.flush()
        return errs

    got = run_both(scenario)
    for g in got.values():
        assert g["extra"] == []
        assert len(g["received"]) == 240
        assert g["counts"] == [(240, 0)]
    assert Counter(got["port"]["received"]) == Counter(
        got["jax"]["received"])


def test_sink_over_real_wire(pinned_time):
    def scenario(pkg, broker, producer):
        p = PKGS[pkg]
        prod = producer()
        span_sink = p["kafka"].KafkaSpanSink(prod, "spans",
                                             serialization="json")
        span_sink.ingest(p["Span"](trace_id=1, id=2, service="svc",
                                   name="op", start_timestamp=1,
                                   end_timestamp=2))
        span_sink.flush()
        metric_sink = p["kafka"].KafkaMetricSink(prod, metric_topic="metrics")
        metric_sink.flush([p["Inter"](name="m", timestamp=1, value=2.0,
                                      tags=["a:1"], type=p["Type"].COUNTER)])

    got = run_both(scenario)
    assert got["port"] == got["jax"]
    rec = got["port"]["received"]
    assert {t for (t, _p, _k, _v, _ts) in rec} == {"spans", "metrics"}
    span_payload = next(v for (t, _p, _k, v, _ts) in rec if t == "spans")
    assert json.loads(span_payload)["service"] == "svc"


class FakeProducer:
    def __init__(self):
        self.messages = []

    def send(self, topic, key, value):
        self.messages.append((topic, key, value))

    def flush(self):
        pass


def test_kafka_metric_and_span_sinks():
    """tests/test_sinks.py's Kafka case: the metric sink's JSON messages
    and the span sink's SSF protobuf messages, equal across packages."""
    got = {}
    for pkg, p in PKGS.items():
        prod = FakeProducer()
        msink = p["kafka"].KafkaMetricSink(prod, metric_topic="metrics")
        msink.flush([p["Inter"](name="km", timestamp=1000, value=1.0,
                                tags=[], type=p["Type"].COUNTER),
                     p["Inter"](name="kg", timestamp=1000, value=0.1 + 0.2,
                                tags=["a:1", "b:2"], type=p["Type"].GAUGE)])
        ssink = p["kafka"].KafkaSpanSink(prod, "spans",
                                         serialization="protobuf")
        ssink.ingest(p["Span"](trace_id=7, id=8, parent_id=2,
                               start_timestamp=1_000_000_000,
                               end_timestamp=3_000_000_000, service="svc",
                               name="op", tags={"k": "v"}))
        got[pkg] = (prod.messages, msink.flushed_metrics, ssink.spans_flushed)
    assert got["port"] == got["jax"]
    messages = got["port"][0]
    assert messages[0][0] == "metrics"
    assert json.loads(messages[0][2])["name"] == "km"
    topic, _key, value = messages[-1]
    assert topic == "spans"
    assert tssf_wire.parse_ssf(value).name == "op"
