"""Columnar span batches: interned string columns + flat scalar arrays.

The scalar pools' frag-arena discipline applied to spans: every string a span
carries (service, operation name, the canonical tag frag, the objective
override) interns exactly once into an append-only ``StringArena``; a
batch row is then a handful of int32 arena ids plus flat int64/byte
scalars. A 10k-span interval with 4 services and ~200 operations costs
~200 interned strings and zero per-span dict/object churn on the flush
path.

Attached SSF samples flatten the same way: the (type, name, tags) key
combination of each sample resolves once through the derivation template
cache (spans/derive.py) and the batch stores only (row, template id,
value, sample_rate) — the parse work the per-span path redoes per sample
happens once per distinct key.
"""

from __future__ import annotations

import threading
from array import array
from typing import NamedTuple, Optional

# The frag separators of the scalar pools' intern discipline: \x1f joins
# key and value inside one tag, \x1e joins tags inside the canonical frag. Both
# are illegal in DogStatsD/SSF tag material, so the mapping is bijective.
FRAG_KV = "\x1f"
FRAG_SEP = "\x1e"


def tags_frag(tags: dict) -> str:
    """Canonical frag for a span's tag dict (sorted, so equal dicts
    intern to one arena entry regardless of insertion order)."""
    if not tags:
        return ""
    return FRAG_SEP.join(
        k + FRAG_KV + v for k, v in sorted(tags.items()))


def frag_tags(frag: str) -> dict:
    """Inverse of tags_frag."""
    if not frag:
        return {}
    out = {}
    for part in frag.split(FRAG_SEP):
        k, _, v = part.partition(FRAG_KV)
        out[k] = v
    return out


class StringArena:
    """Append-only string intern pool; id == insertion index. Lookups by
    id are plain list indexing, safe against concurrent appends."""

    __slots__ = ("_ids", "strings")

    def __init__(self) -> None:
        self._ids: dict[str, int] = {}
        self.strings: list[str] = []

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self.strings)
            self.strings.append(s)
            self._ids[s] = i
        return i

    def __len__(self) -> int:
        return len(self.strings)


class SpanBatch:
    """One unit of columnar span rows plus their flattened samples.

    Parallel arrays only — no per-span objects survive ingest. ``error``
    / ``indicator`` are 0/1 bytes; ids are int64 (SSF ids are uint64-ish
    randoms below 2^62); string columns are int32 arena ids."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "start_ns", "end_ns",
        "error", "indicator", "service_id", "name_id", "objective_id",
        "tags_id", "sample_row", "sample_tpl", "sample_rate",
        "sample_value",
    )

    def __init__(self) -> None:
        self.trace_id = array("q")
        self.span_id = array("q")
        self.parent_id = array("q")
        self.start_ns = array("q")
        self.end_ns = array("q")
        self.error = bytearray()
        self.indicator = bytearray()
        self.service_id = array("i")
        self.name_id = array("i")
        # span.tags["ssf_objective"] or span.name, resolved at append so
        # derivation never touches a tag dict
        self.objective_id = array("i")
        self.tags_id = array("i")
        # attached samples, flattened across rows (sample_row ascending)
        self.sample_row = array("i")
        self.sample_tpl = array("i")
        self.sample_rate = array("d")
        # float for counter/gauge/histogram, str for set, raw status for
        # status checks — exactly what parse_metric_ssf would produce
        self.sample_value: list = []

    @property
    def rows(self) -> int:
        return len(self.span_id)

    @property
    def samples(self) -> int:
        return len(self.sample_row)


class SealedBatch(NamedTuple):
    """A sealed batch plus the (append-only, shared) arena and template
    store its ids index into — everything egress needs to serialize it."""

    batch: SpanBatch
    arena: StringArena
    store: "TemplateStore"  # noqa: F821 - duck-typed, spans/derive.py


class SpanColumnizer:
    """Thread-safe span→columns appender with bounded pending memory.

    Shared by the server's ColumnarSpanPipeline and by SpanBatchSink's
    per-span fallback path (columnar disabled): both need the same
    intern + template-resolution discipline."""

    def __init__(self, arena: StringArena, store,
                 common_tags: Optional[dict] = None,
                 batch_rows: int = 512,
                 pending_cap: int = 1 << 20) -> None:
        self.arena = arena
        self.store = store
        self.common_tags = dict(common_tags or {})
        self.batch_rows = max(1, int(batch_rows))
        self.pending_cap = max(1, int(pending_cap))
        self._open = SpanBatch()
        self._sealed: list[SealedBatch] = []
        self._sealed_rows = 0
        self._lock = threading.Lock()
        self.spans_appended = 0
        self.spans_dropped = 0
        self.invalid_samples = 0

    @property
    def pending(self) -> int:
        with self._lock:
            return self._open.rows + self._sealed_rows

    def append(self, span) -> bool:
        """Columnarize one span; False when the pending cap sheds it
        (loss-over-stall, same policy as the SpanWorker channel)."""
        # common tags fill in missing span tags before anything reads
        # them (same setdefault the SpanWorker applies, worker.go:627-634)
        for k, v in self.common_tags.items():
            span.tags.setdefault(k, v)
        arena = self.arena
        store = self.store
        with self._lock:
            if self._open.rows + self._sealed_rows >= self.pending_cap:
                self.spans_dropped += 1
                return False
            b = self._open
            row = b.rows
            b.trace_id.append(span.trace_id)
            b.span_id.append(span.id)
            b.parent_id.append(span.parent_id)
            b.start_ns.append(span.start_timestamp)
            b.end_ns.append(span.end_timestamp)
            b.error.append(1 if span.error else 0)
            b.indicator.append(1 if span.indicator else 0)
            b.service_id.append(arena.intern(span.service))
            b.name_id.append(arena.intern(span.name))
            b.objective_id.append(arena.intern(
                span.tags.get("ssf_objective") or span.name))
            b.tags_id.append(arena.intern(tags_frag(span.tags)))
            for sample in span.metrics:
                resolved = store.sample_template(sample)
                if resolved is None:
                    # ParseError or empty metric name — the per-span
                    # path's convert_metrics skip-and-count
                    self.invalid_samples += 1
                    continue
                tpl_id, kind = resolved
                value = store.sample_value(sample, kind)
                if value is None:
                    self.invalid_samples += 1
                    continue
                b.sample_row.append(row)
                b.sample_tpl.append(tpl_id)
                b.sample_rate.append(sample.sample_rate)
                b.sample_value.append(value)
            self.spans_appended += 1
            if b.rows >= self.batch_rows:
                self._seal_locked()
        return True

    def _seal_locked(self) -> None:
        if self._open.rows:
            self._sealed.append(
                SealedBatch(self._open, self.arena, self.store))
            self._sealed_rows += self._open.rows
            self._open = SpanBatch()

    def take_sealed(self) -> list[SealedBatch]:
        """Seal the open batch and hand back everything pending (FIFO —
        derivation preserves span arrival order)."""
        with self._lock:
            self._seal_locked()
            out, self._sealed = self._sealed, []
            self._sealed_rows = 0
        return out
