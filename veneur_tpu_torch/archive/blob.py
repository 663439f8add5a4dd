"""ArchiveBlobPlugin: VMB1 flush frames PUT to S3-compatible storage.

The reference's s3 plugin uploads row-at-a-time gzipped TSV with a
single log-and-count on failure. This plugin ships the same checksummed
columnar frames the local archive writes (archive/wire.py) — encoded
once, natively when the emit tier is loaded — and drives every PUT
through a DeliveryManager, so blob egress gets retry / breaker /
bounded-spill semantics and exact payload conservation instead of
drop-on-first-503. Objects land under
``archive/<hostname>/<timestamp>-<seq>.vmb``; SigV4 signing reuses
plugins/s3.sigv4_headers (the headers are minted inside the send
closure, so a spilled payload retried next interval re-signs with a
fresh date).
"""

from __future__ import annotations

import logging
import urllib.request

from veneur_tpu_torch.archive.wire import encode_flush, encode_metrics
from veneur_tpu_torch.plugins import Plugin
from veneur_tpu_torch.plugins.s3 import sigv4_headers
from veneur_tpu_torch.sinks.delivery import make_manager
from veneur_tpu_torch.utils.http import default_opener

log = logging.getLogger("veneur_tpu_torch.archive.blob")


class ArchiveBlobPlugin(Plugin):
    def __init__(self, bucket: str, region: str, access_key: str,
                 secret_key: str, delivery=None,
                 opener=default_opener) -> None:
        self.bucket = bucket
        self.region = region
        self.access_key = access_key
        self.secret_key = secret_key
        self.opener = opener
        self.delivery = make_manager("archive_blob", delivery)
        self.uploads = 0
        self.flush_errors = 0
        self.frames_encoded = 0
        self.bytes_encoded = 0
        self._seq = 0

    def name(self) -> str:
        return "archive_blob"

    def flush(self, metrics, hostname: str) -> None:
        """``metrics`` is the ColumnarMetrics batch on the columnar
        flush path, or an InterMetric list on the legacy object path —
        either way, one frame, one PUT."""
        if hasattr(metrics, "emit_plan"):
            frame, count = encode_flush(metrics, hostname)
            ts = metrics.timestamp
        else:
            frame, count = encode_metrics(list(metrics), hostname=hostname)
            ts = metrics[0].timestamp if metrics else 0
        man = self.delivery
        man.begin_flush()
        man.retry_spill()
        if count == 0:
            return
        self.frames_encoded += 1
        self.bytes_encoded += len(frame)
        self._seq += 1
        key = f"archive/{hostname}/{int(ts)}-{self._seq:06d}.vmb"
        status = man.deliver(self._send_fn(key, frame), len(frame),
                             payload=frame)
        if status == "delivered":
            self.uploads += 1
        elif status == "dropped":
            self.flush_errors += 1

    def _send_fn(self, key: str, frame: bytes):
        host = f"{self.bucket}.s3.{self.region}.amazonaws.com"
        path = f"/{key}"

        def send(timeout_s: float) -> None:
            headers = sigv4_headers(
                "PUT", host, path, self.region, self.access_key,
                self.secret_key, frame)
            headers["Content-Type"] = "application/octet-stream"
            req = urllib.request.Request(
                f"https://{host}{path}", data=frame, method="PUT",
                headers=headers)
            self.opener(req, timeout_s)

        return send
