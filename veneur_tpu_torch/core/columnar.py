"""Packed extract columns: the one piece of veneur_tpu/core/columnar.py
this slice needs (the columnar InterMetric batches are not ported; the
port's flusher builds InterMetric objects row by row)."""

from __future__ import annotations

import numpy as np

# aggregate columns appended after the [S, P] quantile block by the
# worker's packed extract: dmin, dmax, dsum, dcount, drecip, lmin, lmax,
# lsum, lweight, lrecip
EXTRACT_AGG_COLUMNS = 10


def unpack_extract_columns(packed: np.ndarray, p: int):
    """Split a packed extract array [S, P+10] back into the [S, P]
    quantile block and the ten [S] aggregate columns."""
    qv = packed[:, :p]
    aggs = tuple(packed[:, p + i] for i in range(EXTRACT_AGG_COLUMNS))
    return qv, aggs
