"""Local-file plugin: append each flush as TSV to a file.

Parity: reference plugins/localfile/localfile.go (the flush_file config),
plus size-bounded rotation the reference lacks — an append that would
push the file past ``max_bytes`` first rotates it aside to ``<path>.1``
(one generation, the previous one replaced), so a long-lived process
never grows the flush file without bound.
"""

from __future__ import annotations

import logging
import os

from veneur_tpu_torch.plugins import Plugin, encode_inter_metrics_tsv

log = logging.getLogger("veneur_tpu_torch.plugins.localfile")


class LocalFilePlugin(Plugin):
    def __init__(self, path: str, interval_s: float = 10.0,
                 max_bytes: int = 0) -> None:
        self.path = path
        self.interval_s = interval_s
        self.max_bytes = max(0, int(max_bytes))
        self.flush_errors = 0
        self.rotations = 0

    def name(self) -> str:
        return "localfile"

    def _maybe_rotate(self, incoming: int) -> None:
        if not self.max_bytes:
            return
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return  # no file yet: nothing to rotate
        if size and size + incoming > self.max_bytes:
            os.replace(self.path, self.path + ".1")
            self.rotations += 1

    def flush(self, metrics, hostname: str) -> None:
        try:
            data = encode_inter_metrics_tsv(metrics, hostname,
                                            self.interval_s)
            self._maybe_rotate(len(data))
            with open(self.path, "ab") as f:
                f.write(data)
        except OSError as e:
            self.flush_errors += 1
            log.warning("localfile flush failed: %s", e)
