"""Flush archival & replay: the VMB1 segmented metric archive.

The reference ships an s3 plugin that archives every flush as TSV —
unbounded, row-at-a-time, and write-only (nothing reads it back). This
package closes the capture→replay loop at the flush level:

* ``wire``   — VMB1, a checksummed columnar flush-frame format (magic +
  local string table + dense sample columns + CRC), serialized zero-copy
  from the ColumnarMetrics flush arrays — natively (GIL-released,
  native/emit.cpp) when the emit tier is loaded, byte-identically in
  Python otherwise.
* ``sink``   — MetricArchiveSink: a rotated, size-and-count-bounded
  append-only local archive behind the DeliveryManager (retry / breaker
  / bounded spill, exact payload conservation).
* ``blob``   — ArchiveBlobPlugin: the same frames PUT to S3-compatible
  blob storage through the existing SigV4 machinery (plugins/s3.py).
* ``replay`` — decoded frames re-ingested bit-identically through the
  global tier's import path (distributed/import_server.py), optionally
  under VDE1 dedup envelopes so a twice-replayed archive double-counts
  nothing.
"""

from veneur_tpu_torch.archive.blob import ArchiveBlobPlugin
from veneur_tpu_torch.archive.sink import (MetricArchiveSink,
                                     SegmentedArchiveWriter, read_archive)
from veneur_tpu_torch.archive.wire import (decode_flush, encode_flush,
                                     encode_metrics)

__all__ = [
    "ArchiveBlobPlugin", "MetricArchiveSink", "SegmentedArchiveWriter",
    "read_archive", "encode_flush", "encode_metrics", "decode_flush",
]
