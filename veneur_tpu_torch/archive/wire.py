"""VMB1: the self-contained columnar metric flush-frame format.

One frame per flushed interval, in the journal's checksummed-record
discipline (VSB1, spans/wire.py): magic, a CRC-32 over the payload, then
the payload — a small header (flush timestamp, hostname) and a list of
sections. Two section kinds:

* ``SECTION_COLUMNAR`` (0) — one ColumnGroup, dense: a local
  first-appearance string table (per-row name then tags, then family
  suffixes), the row metadata table, the family table, and the raw f64
  value / u8 mask planes memcpy'd straight out of the flush arrays. This
  is the zero-copy body the native serializer
  (native/emit.cpp vn_encode_archive_section) builds GIL-free; the
  Python encoder here produces byte-identical sections (pinned by
  tests/test_archive.py).
* ``SECTION_SAMPLES`` (1) — per-sample rows (name, tags, type, value,
  message, hostname) for everything the dense layout can't carry:
  status-check extras, per-row ``veneursinkonly`` routed groups, and
  the legacy object-path ``flush(list)`` surface.

``SECTION_COUNTS`` tallies the columnar sections each encoder built, so
a run that asked for the native tier can see a quiet fallback to Python
(``reset_section_counts`` starts a window).

All integers little-endian; values are raw IEEE-754 f64 bits, so a
decoded sample reproduces the flushed value exactly (the bit-identical
replay contract). Decode refuses a bad magic, CRC, truncation, or
trailing bytes rather than guessing — torn tails surface as errors, not
garbage metrics (the corruption matrix in tests/test_archive.py).
"""

from __future__ import annotations

import struct
import threading
from typing import Optional
from zlib import crc32

import numpy as np

from veneur_tpu_torch import native
from veneur_tpu_torch.core.metrics import InterMetric

MAGIC = b"VMB1"
SECTION_COLUMNAR = 0
SECTION_SAMPLES = 1

# columnar sections built by each encoder since reset_section_counts()
SECTION_COUNTS = {"native": 0, "python": 0}
_counts_lock = threading.Lock()


def reset_section_counts() -> None:
    with _counts_lock:
        for k in SECTION_COUNTS:
            SECTION_COUNTS[k] = 0


def _count_section(kind: str) -> None:
    with _counts_lock:
        SECTION_COUNTS[kind] += 1


class _Interner:
    """First-appearance local string table (the VSB1 sid() discipline —
    and the exact order vn_encode_archive_section interns in, which is
    what makes native and Python sections byte-identical)."""

    def __init__(self) -> None:
        self.strings: list[bytes] = []
        self._ids: dict[str, int] = {}

    def sid(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self.strings)
            self.strings.append(s.encode("utf-8"))
            self._ids[s] = i
        return i

    def table(self) -> bytes:
        out = bytearray(struct.pack("<I", len(self.strings)))
        for raw in self.strings:
            out += struct.pack("<I", len(raw))
            out += raw
        return bytes(out)


def _filter_tags(tags, excluded_tags):
    if not excluded_tags:
        return tags
    return [t for t in tags if t.split(":", 1)[0] not in excluded_tags]


def _columnar_section_py(group, excluded_tags=None) -> tuple[bytes, int]:
    """(section body, emitted sample count) for one ColumnGroup, dense.
    The pure-Python twin of vn_encode_archive_section — identical bytes
    when no tags are excluded (exclusion rewrites the row table, which
    only this path supports)."""
    intern = _Interner()
    sid = intern.sid
    rows = bytearray()
    meta_at = group.meta_at
    for i in range(group.nrows):
        name, tags, _sinks = meta_at(i)
        tags = _filter_tags(tags, excluded_tags)
        rows += struct.pack("<IH", sid(name), len(tags))
        for t in tags:
            rows += struct.pack("<I", sid(t))
    fams = bytearray(struct.pack("<I", len(group.families)))
    planes = bytearray()
    count = 0
    values = np.ascontiguousarray(
        np.stack([f.values for f in group.families]), np.float64)
    masks = np.ascontiguousarray(
        np.stack([f.mask.astype(np.uint8) if f.mask is not None
                  else np.ones(group.nrows, np.uint8)
                  for f in group.families]), np.uint8)
    for f in group.families:
        fams += struct.pack("<BI", int(f.type), sid(f.suffix))
    count = int(masks.sum())
    planes += values.tobytes()
    planes += masks.tobytes()
    body = (intern.table() + struct.pack("<I", group.nrows) + bytes(rows)
            + bytes(fams) + bytes(planes))
    return body, count


def _columnar_section_native(plan) -> Optional[bytes]:
    """The GIL-released body build over one EmitGroupPlan; None when the
    library (or the symbol) is unavailable."""
    return native.encode_archive_section(
        plan.meta_blob, plan.nrows, plan.suffixes, plan.family_types,
        plan.values, plan.masks)


def _samples_section(samples) -> tuple[bytes, int]:
    """Per-sample section body from (name, tags, type, value, message,
    hostname) tuples."""
    intern = _Interner()
    sid = intern.sid
    rows = bytearray()
    count = 0
    for name, tags, mtype, value, message, hostname in samples:
        rows += struct.pack("<IH", sid(name), len(tags))
        for t in tags:
            rows += struct.pack("<I", sid(t))
        rows += struct.pack("<BdII", int(mtype) & 0xFF, float(value),
                            sid(message or ""), sid(hostname or ""))
        count += 1
    body = intern.table() + struct.pack("<I", count) + bytes(rows)
    return body, count


def _routed_samples(group, sink_name, excluded_tags):
    """Samples of a veneursinkonly-routed group, filtered the way the
    base MetricSink.flush_columnar would route them to ``sink_name``."""
    meta_at = group.meta_at
    for fam in group.families:
        suffix = fam.suffix
        mtype = int(fam.type)
        vals = fam.values.tolist()
        for i in group.rows_for(fam).tolist():
            name, tags, sinks = meta_at(i)
            if sink_name is not None and sinks is not None \
                    and sink_name not in sinks:
                continue
            yield (name + suffix if suffix else name,
                   _filter_tags(tags, excluded_tags), mtype, vals[i],
                   "", "")


def _frame(timestamp: int, hostname: str,
           sections: list[tuple[int, bytes]]) -> bytes:
    host = hostname.encode("utf-8")
    out = bytearray(struct.pack("<qI", int(timestamp), len(host)))
    out += host
    out += struct.pack("<I", len(sections))
    for kind, body in sections:
        out += struct.pack("<BI", kind, len(body))
        out += body
    payload = bytes(out)
    return MAGIC + struct.pack("<I", crc32(payload)) + payload


def encode_flush(batch, hostname: str = "", *,
                 sink_name: Optional[str] = None,
                 excluded_tags: Optional[set] = None,
                 use_native: Optional[bool] = None) -> tuple[bytes, int]:
    """One VMB1 frame for a ColumnarMetrics flush; returns
    ``(frame, archived sample count)``.

    Plan-capable groups (emit_plan) serialize dense — through the
    native tier when ``use_native`` (default: availability) and no tags
    are excluded, byte-identically in Python otherwise. Routed groups
    and extras go per-sample, honoring ``sink_name`` routing exactly as
    the base flush_columnar does."""
    if use_native is None:
        use_native = native.emit_available()
    sections: list[tuple[int, bytes]] = []
    total = 0
    plans = batch.emit_plan()
    for g, plan in zip(batch.groups, plans):
        if not g.families or g.nrows == 0:
            continue
        if g.has_routing and sink_name is not None:
            body, n = _samples_section(
                _routed_samples(g, sink_name, excluded_tags))
            sections.append((SECTION_SAMPLES, body))
            total += n
            continue
        body = None
        if plan is not None and use_native and not excluded_tags:
            body = _columnar_section_native(plan)
            if body is not None:
                n = sum(f.count(g.nrows) for f in g.families)
                _count_section("native")
        if body is None:
            body, n = _columnar_section_py(g, excluded_tags)
            _count_section("python")
        sections.append((SECTION_COLUMNAR, body))
        total += n
    extras = [
        (m.name, _filter_tags(m.tags, excluded_tags), int(m.type),
         m.value, m.message, m.hostname)
        for m in batch.extras
        if sink_name is None or m.sinks is None or sink_name in m.sinks]
    if extras:
        body, n = _samples_section(extras)
        sections.append((SECTION_SAMPLES, body))
        total += n
    return _frame(batch.timestamp, hostname, sections), total


def encode_metrics(metrics: list[InterMetric], timestamp: int = 0,
                   hostname: str = "") -> tuple[bytes, int]:
    """Object-path frame: one per-sample section over an InterMetric
    list (the legacy ``flush(list)`` sink surface and the plugins'
    metrics argument when the columnar path is off)."""
    if timestamp == 0 and metrics:
        timestamp = metrics[0].timestamp
    body, n = _samples_section(
        (m.name, m.tags, int(m.type), m.value, m.message, m.hostname)
        for m in metrics)
    return _frame(timestamp, hostname, [(SECTION_SAMPLES, body)]), n


def decode_flush(frame: bytes) -> dict:
    """Inverse of encode_flush/encode_metrics: the frame header plus the
    flat sample list (family-major within a columnar section, mirroring
    ColumnarMetrics.materialize order). Raises ValueError on bad
    magic/CRC/truncation/trailing bytes."""
    if frame[:4] != MAGIC:
        raise ValueError("bad VMB1 magic")
    if len(frame) < 8:
        raise ValueError("truncated VMB1 frame")
    (crc,) = struct.unpack_from("<I", frame, 4)
    payload = frame[8:]
    if crc32(payload) != crc:
        raise ValueError("VMB1 CRC mismatch")
    off = 0

    def take(n: int) -> bytes:
        nonlocal off
        if off + n > len(payload):
            raise ValueError("truncated VMB1 frame")
        chunk = payload[off:off + n]
        off += n
        return chunk

    ts, host_len = struct.unpack("<qI", take(12))
    hostname = take(host_len).decode("utf-8")
    (nsections,) = struct.unpack("<I", take(4))
    samples: list[dict] = []
    for _ in range(nsections):
        kind, body_len = struct.unpack("<BI", take(5))
        body = take(body_len)
        if kind == SECTION_COLUMNAR:
            samples.extend(_decode_columnar(body))
        elif kind == SECTION_SAMPLES:
            samples.extend(_decode_samples(body))
        else:
            raise ValueError(f"unknown VMB1 section kind {kind}")
    if off != len(payload):
        raise ValueError("trailing bytes in VMB1 frame")
    return {"timestamp": ts, "hostname": hostname,
            "nsections": nsections, "samples": samples}


def _take_strings(body: bytes, off: int) -> tuple[list[str], int]:
    if off + 4 > len(body):
        raise ValueError("truncated VMB1 section")
    (nstrings,) = struct.unpack_from("<I", body, off)
    off += 4
    strings = []
    for _ in range(nstrings):
        if off + 4 > len(body):
            raise ValueError("truncated VMB1 section")
        (slen,) = struct.unpack_from("<I", body, off)
        off += 4
        if off + slen > len(body):
            raise ValueError("truncated VMB1 section")
        strings.append(body[off:off + slen].decode("utf-8"))
        off += slen
    return strings, off


def _decode_columnar(body: bytes):
    strings, off = _take_strings(body, 0)
    if off + 4 > len(body):
        raise ValueError("truncated VMB1 section")
    (nrows,) = struct.unpack_from("<I", body, off)
    off += 4
    names: list[str] = []
    tags: list[list[str]] = []
    for _ in range(nrows):
        if off + 6 > len(body):
            raise ValueError("truncated VMB1 section")
        nsid, ntags = struct.unpack_from("<IH", body, off)
        off += 6
        if off + 4 * ntags > len(body):
            raise ValueError("truncated VMB1 section")
        names.append(strings[nsid])
        tags.append([strings[t] for t in
                     struct.unpack_from(f"<{ntags}I", body, off)])
        off += 4 * ntags
    if off + 4 > len(body):
        raise ValueError("truncated VMB1 section")
    (nfam,) = struct.unpack_from("<I", body, off)
    off += 4
    fams = []
    for _ in range(nfam):
        if off + 5 > len(body):
            raise ValueError("truncated VMB1 section")
        ftype, ssid = struct.unpack_from("<BI", body, off)
        off += 5
        fams.append((ftype, strings[ssid]))
    need = nfam * nrows * 9
    if off + need != len(body):
        raise ValueError("VMB1 columnar plane size mismatch")
    values = np.frombuffer(body, "<f8", nfam * nrows, off)
    values = values.reshape(nfam, nrows)
    off += nfam * nrows * 8
    masks = np.frombuffer(body, np.uint8, nfam * nrows, off)
    masks = masks.reshape(nfam, nrows)
    for f, (ftype, suffix) in enumerate(fams):
        vals = values[f].tolist()
        mask = masks[f]
        for i in range(nrows):
            if not mask[i]:
                continue
            yield {"name": names[i] + suffix if suffix else names[i],
                   "tags": tags[i], "type": ftype, "value": vals[i],
                   "message": "", "hostname": ""}


def _decode_samples(body: bytes):
    strings, off = _take_strings(body, 0)
    if off + 4 > len(body):
        raise ValueError("truncated VMB1 section")
    (nrows,) = struct.unpack_from("<I", body, off)
    off += 4
    for _ in range(nrows):
        if off + 6 > len(body):
            raise ValueError("truncated VMB1 section")
        nsid, ntags = struct.unpack_from("<IH", body, off)
        off += 6
        if off + 4 * ntags > len(body):
            raise ValueError("truncated VMB1 section")
        tag_sids = struct.unpack_from(f"<{ntags}I", body, off)
        off += 4 * ntags
        if off + 17 > len(body):
            raise ValueError("truncated VMB1 section")
        mtype, value, msid, hsid = struct.unpack_from("<BdII", body, off)
        off += 17
        yield {"name": strings[nsid], "tags": [strings[t] for t in tag_sids],
               "type": mtype, "value": value, "message": strings[msid],
               "hostname": strings[hsid]}
    if off != len(body):
        raise ValueError("trailing bytes in VMB1 section")
