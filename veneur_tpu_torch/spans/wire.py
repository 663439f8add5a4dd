"""VSB1: the self-contained columnar span-batch wire format.

One frame per sealed batch, in the journal's checksummed-record
discipline (utils/journal.py): magic, a CRC-32 over the payload, then
the payload — a local string table (arena ids remapped to a compact
per-batch table, so a frame never references process-local state), the
flat row arrays, the referenced sample templates, and the flattened
samples. All integers little-endian; decode refuses a bad magic or CRC
rather than guessing (torn tails surface as errors, not garbage spans).

This is what SpanBatchSink ships — one Kafka message or one segmented-
log record per batch — replacing the per-span protobuf/JSON encode of
the drop-only kafka span lane with an O(distinct strings) columnar
serialization.
"""

from __future__ import annotations

import struct
import sys
import zlib
from array import array

from veneur_tpu_torch.spans.batch import SealedBatch

MAGIC = b"VSB1"
_NO_STRING = 0xFFFFFFFF


def _le(a: array) -> bytes:
    if sys.byteorder != "little":  # pragma: no cover - LE-only CI
        a = array(a.typecode, a)
        a.byteswap()
    return a.tobytes()

def _from_le(typecode: str, buf: bytes) -> array:
    a = array(typecode)
    a.frombytes(buf)
    if sys.byteorder != "little":  # pragma: no cover - LE-only CI
        a.byteswap()
    return a


def encode_batch(sealed: SealedBatch) -> bytes:
    b, arena, store = sealed
    lstrings: list[bytes] = []
    lids: dict[str, int] = {}

    def sid(s: str) -> int:
        i = lids.get(s)
        if i is None:
            i = len(lstrings)
            lstrings.append(s.encode("utf-8"))
            lids[s] = i
        return i

    strings = arena.strings
    rows = b.rows
    service = array("I", (sid(strings[i]) for i in b.service_id))
    name = array("I", (sid(strings[i]) for i in b.name_id))
    objective = array("I", (sid(strings[i]) for i in b.objective_id))
    tags = array("I", (sid(strings[i]) for i in b.tags_id))

    # only the templates this batch references, remapped densely
    tpl_local: dict[int, int] = {}
    tpl_entries: list[tuple[int, int, int, int]] = []
    s_row = array("I")
    s_tpl = array("I")
    s_num = array("d")
    s_rate = array("d")
    s_msg = array("I")
    for j in range(b.samples):
        t = b.sample_tpl[j]
        lt = tpl_local.get(t)
        if lt is None:
            kind, tpl = store.templates[t]
            lt = len(tpl_entries)
            tpl_local[t] = lt
            tpl_entries.append((kind, int(tpl.scope), sid(tpl.key.name),
                                sid(tpl.key.joined_tags)))
        v = b.sample_value[j]
        if isinstance(v, str):
            s_num.append(0.0)
            s_msg.append(sid(v))
        else:
            s_num.append(float(v))
            s_msg.append(_NO_STRING)
        s_row.append(b.sample_row[j])
        s_tpl.append(lt)
        s_rate.append(b.sample_rate[j])

    out = bytearray()
    out += struct.pack("<IIII", rows, b.samples, len(lstrings),
                       len(tpl_entries))
    for raw in lstrings:
        out += struct.pack("<I", len(raw))
        out += raw
    for col in (b.trace_id, b.span_id, b.parent_id, b.start_ns, b.end_ns):
        out += _le(col)
    out += bytes(b.error)
    out += bytes(b.indicator)
    for col in (service, name, objective, tags):
        out += _le(col)
    for kind, scope, nsid, tsid in tpl_entries:
        out += struct.pack("<BBII", kind, scope, nsid, tsid)
    out += _le(s_row)
    out += _le(s_tpl)
    out += _le(s_num)
    out += _le(s_rate)
    out += _le(s_msg)
    payload = bytes(out)
    return MAGIC + struct.pack("<I", zlib.crc32(payload)) + payload


def decode_batch(frame: bytes) -> dict:
    """Inverse of encode_batch: a plain dict of columns + the local
    string/template tables (replay tooling and the roundtrip tests).
    Raises ValueError on bad magic/CRC/truncation."""
    if frame[:4] != MAGIC:
        raise ValueError("bad VSB1 magic")
    (crc,) = struct.unpack_from("<I", frame, 4)
    payload = frame[8:]
    if zlib.crc32(payload) != crc:
        raise ValueError("VSB1 CRC mismatch")
    off = 0

    def take(n: int) -> bytes:
        nonlocal off
        if off + n > len(payload):
            raise ValueError("truncated VSB1 frame")
        chunk = payload[off:off + n]
        off += n
        return chunk

    rows, nsamples, nstrings, ntpls = struct.unpack("<IIII", take(16))
    strings = []
    for _ in range(nstrings):
        (slen,) = struct.unpack("<I", take(4))
        strings.append(take(slen).decode("utf-8"))
    cols = {}
    for key in ("trace_id", "span_id", "parent_id", "start_ns", "end_ns"):
        cols[key] = _from_le("q", take(8 * rows))
    cols["error"] = bytearray(take(rows))
    cols["indicator"] = bytearray(take(rows))
    for key in ("service", "name", "objective", "tags"):
        cols[key] = _from_le("I", take(4 * rows))
    templates = []
    for _ in range(ntpls):
        kind, scope, nsid, tsid = struct.unpack("<BBII", take(10))
        templates.append({"kind": kind, "scope": scope,
                          "name": strings[nsid],
                          "joined_tags": strings[tsid]})
    s_row = _from_le("I", take(4 * nsamples))
    s_tpl = _from_le("I", take(4 * nsamples))
    s_num = _from_le("d", take(8 * nsamples))
    s_rate = _from_le("d", take(8 * nsamples))
    s_msg = _from_le("I", take(4 * nsamples))
    if off != len(payload):
        raise ValueError("trailing bytes in VSB1 frame")
    samples = []
    for j in range(nsamples):
        value = (strings[s_msg[j]] if s_msg[j] != _NO_STRING
                 else s_num[j])
        samples.append({"row": s_row[j], "template": s_tpl[j],
                        "value": value, "sample_rate": s_rate[j]})
    return {"rows": rows, "strings": strings, "columns": cols,
            "templates": templates, "samples": samples}
