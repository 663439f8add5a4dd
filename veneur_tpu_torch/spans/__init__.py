"""Columnar SSF trace-span pipeline (ROADMAP item 3: the second workload).

The per-span path (core/spans.py) walks Python ``SSFSpan`` objects through
``SpanWorker`` lanes and derives indicator/objective/uniqueness metrics one
span at a time via per-span callbacks. This package is the batched twin:

* ``batch``    — columnar span batches: service/operation/tag strings
  interned once into an append-only arena (the scalar pools' frag
  discipline),
  start/end/error/indicator as flat arrays.
* ``derive``   — span→metric derivation over a sealed batch, bit-identical
  to the per-span ``convert_metrics`` / ``convert_indicator_metrics`` /
  ``convert_span_uniqueness_metrics`` path by construction: every distinct
  key combination parses ONCE through ``parse_metric_ssf`` (same fnv1a
  digest chain, same magic-tag scope extraction) and is cached as a
  template; rows emit copies varying only in value/sample_rate.
* ``pipeline`` — the flush-driven ``ColumnarSpanPipeline`` the server
  ingests into when every configured span sink is batch-capable.
* ``wire``     — the self-contained VSB1 batch serialization (checksummed,
  local string table) span egress ships.
* ``sink``     — ``SpanBatchSink``: batch egress through the sinks'
  ``DeliveryManager`` (retry/breaker/spill/journal) over a pluggable
  writer (Kafka wire producer or segmented local log).

``VENEUR_SPAN_COLUMNAR=0`` is the env escape hatch (the CI parity lane
runs the suite once per side), mirroring VENEUR_MICRO_FOLD /
VENEUR_SERIES_SHARDS.
"""

from __future__ import annotations

import os

_ENV_KEY = "VENEUR_SPAN_COLUMNAR"


def columnar_enabled(cfg_value: bool) -> bool:
    """Config value with the env escape hatch applied."""
    env = os.environ.get(_ENV_KEY)
    if env is not None:
        return env.strip().lower() not in ("0", "false", "no", "off")
    return bool(cfg_value)


from veneur_tpu_torch.spans.batch import (  # noqa: E402
    SpanBatch, SpanColumnizer, StringArena, SealedBatch,
    frag_tags, tags_frag,
)
from veneur_tpu_torch.spans.derive import TemplateStore, derive_batch  # noqa: E402
from veneur_tpu_torch.spans.pipeline import ColumnarSpanPipeline  # noqa: E402
from veneur_tpu_torch.spans.wire import decode_batch, encode_batch  # noqa: E402
from veneur_tpu_torch.spans.sink import (  # noqa: E402
    DiscardWriter, KafkaBatchWriter, SegmentedLogWriter, SpanBatchSink,
)

__all__ = [
    "ColumnarSpanPipeline", "DiscardWriter", "KafkaBatchWriter",
    "SealedBatch", "SegmentedLogWriter", "SpanBatch", "SpanBatchSink",
    "SpanColumnizer", "StringArena", "TemplateStore", "columnar_enabled",
    "decode_batch", "derive_batch", "encode_batch", "frag_tags",
    "tags_frag",
]
