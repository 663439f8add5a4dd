"""Process introspection helpers with no framework dependencies — safe to
import from lightweight processes (the proxy) that must not drag in the
device stack."""

from __future__ import annotations

import os
from typing import Optional


def current_rss_bytes() -> Optional[int]:
    """Current resident set size (Linux /proc; None where unavailable)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None
