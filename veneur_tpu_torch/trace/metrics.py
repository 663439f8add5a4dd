"""Metrics-only reporting through the trace client.

Parity: reference trace/metrics/client.go:21-51 — ReportOne/ReportBatch
wrap SSF samples in a metrics-only span (no trace identity) and record it;
used for all internal self-telemetry that flows through SSF.
"""

from __future__ import annotations

from veneur_tpu_torch import ssf
from veneur_tpu_torch.trace.client import Client, ErrWouldBlock


def report_batch(client: Client, samples: list[ssf.SSFSample]) -> bool:
    """Submit samples on a metrics-only span; returns False if dropped."""
    if client is None or not samples:
        return False
    span = ssf.SSFSpan(metrics=list(samples))
    try:
        client.record(span)
    except ErrWouldBlock:
        return False
    return True


def report_one(client: Client, sample: ssf.SSFSample) -> bool:
    return report_batch(client, [sample])


class Samples:
    """Accumulate samples across a code path, then report once
    (reference ssf.Samples + metrics.Report pattern)."""

    def __init__(self) -> None:
        self.samples: list[ssf.SSFSample] = []

    def add(self, *samples: ssf.SSFSample) -> None:
        self.samples.extend(samples)

    def report(self, client: Client) -> bool:
        return report_batch(client, self.samples)
