"""Journal codec for HTTP-sink spill payloads.

The delivery spill holds send CLOSURES (one attempt over serialized
wire bytes) — closures don't survive a process, so the write-ahead
journal (utils/journal.py) needs the request itself.  Sinks that want
durable spill pass an :class:`HttpEnvelope` as the opaque ``payload``
context on ``DeliveryManager.deliver``: everything needed to re-issue
the POST after a restart (url, pre-serialized body, headers) plus the
metric count for honest payload-level accounting.

Recovered sends go through ``utils.http.post_bytes`` with the process
default opener.  Sink-level flushed-metric counters are NOT rebuilt
across a restart (the closure that incremented them died with the old
process) — recovery accounting lives at the delivery layer
(``journal_recovered`` / ``delivered_payloads``), which is the layer
the conservation contract is stated at.

Wire format: one JSON line (url, headers, count, tenant) + ``\\n`` +
raw body bytes.  The journal already checksums the whole record.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Optional

from veneur_tpu_torch.utils.http import Opener, default_opener, post_bytes


@dataclass
class HttpEnvelope:
    """A journalable HTTP POST: the spill entry's durable context."""

    url: str
    body: bytes
    headers: dict = field(default_factory=dict)
    count: int = 0      # metrics/spans carried, for payload accounting
    tenant: str = ""


def encode_envelope(env: HttpEnvelope) -> bytes:
    meta = {
        "url": env.url,
        "headers": env.headers,
        "count": env.count,
        "tenant": env.tenant,
    }
    return json.dumps(meta, separators=(",", ":")).encode() + b"\n" + env.body


def decode_envelope(blob: bytes) -> Optional[HttpEnvelope]:
    nl = blob.find(b"\n")
    if nl < 0:
        return None
    try:
        meta = json.loads(blob[:nl])
        return HttpEnvelope(
            url=str(meta["url"]),
            body=blob[nl + 1:],
            headers=dict(meta.get("headers") or {}),
            count=int(meta.get("count", 0)),
            tenant=str(meta.get("tenant", "")),
        )
    except (ValueError, KeyError, TypeError):
        return None


def make_entry_codec(opener: Opener = default_opener):
    """(encode, decode) pair for DeliveryManager.attach_journal/recover.

    encode: spill entries whose ``payload`` is an HttpEnvelope get a
    durable record; anything else returns None and stays RAM-only.
    decode: rebuilds a fresh ``_SpillEntry`` whose send closure re-POSTs
    the identical bytes through `opener`.
    """
    from veneur_tpu_torch.sinks.delivery import _SpillEntry

    def encode(entry) -> Optional[bytes]:
        env = entry.payload
        if not isinstance(env, HttpEnvelope):
            return None
        return encode_envelope(env)

    def decode(blob: bytes):
        env = decode_envelope(blob)
        if env is None:
            return None

        def send(timeout: float, _env=env) -> None:
            post_bytes(_env.url, _env.body, _env.headers, timeout, opener)

        return _SpillEntry(send, len(env.body), payload=env,
                           tenant=env.tenant)

    return encode, decode
