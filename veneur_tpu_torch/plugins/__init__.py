"""Flush-time archival plugins.

Parity: reference plugins/plugins.go:16-19 — a Plugin receives every
flush's final InterMetrics (after the sinks) and archives them; shipped
implementations are localfile and s3 (registered in server.go:737-785).
"""

from __future__ import annotations

import abc
import csv
import io
import time

from veneur_tpu_torch.core.metrics import InterMetric


class Plugin(abc.ABC):
    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def flush(self, metrics: list[InterMetric], hostname: str) -> None: ...


def encode_inter_metrics_tsv(metrics: list[InterMetric], hostname: str,
                             interval_s: float) -> bytes:
    """TSV encoding of a flush (the reference's CSV/TSV flush-file format:
    name, tags, type, veneur hostname, interval, timestamp, value, and a
    date partition column)."""
    buf = io.StringIO()
    w = csv.writer(buf, delimiter="\t", lineterminator="\n")
    for m in metrics:
        ts = time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(m.timestamp))
        partition = time.strftime("%Y%m%d", time.gmtime(m.timestamp))
        w.writerow([
            m.name,
            ",".join(m.tags),
            m.type.name.lower(),
            hostname,
            int(interval_s),
            ts,
            repr(m.value),
            partition,
        ])
    return buf.getvalue().encode("utf-8")
