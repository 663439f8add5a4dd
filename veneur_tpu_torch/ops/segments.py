"""Scatter-free segmented scans, PyTorch twins of veneur_tpu/ops/segments.py.

* ``segmented_cumsum``: chunked Hillis-Steele scan with a segmented
  cross-chunk carry, the same loops as the reference.
* ``last_marked_carry``: exclusive "value at the last marked position"
  scan, which turns per-run sums into differences of prefix sums at run
  boundaries (t-digest bucket accumulation).

Every float add runs in the reference's fixed order, so results are
bitwise equal to the JAX package's.
"""

from __future__ import annotations

import torch

CHUNK = 128  # the reference's chunk width (one TPU lane tile)


def _pad_to_chunks(x: torch.Tensor, fill) -> torch.Tensor:
    n = x.shape[0]
    pad = (-n) % CHUNK
    if pad:
        x = torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                     device=x.device)])
    return x.reshape(-1, CHUNK)


def _shift_right(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """``pad(x, (k, 0))[..., :n]`` along the last axis."""
    n = x.shape[-1]
    k = min(k, n)
    pad = torch.full(x.shape[:-1] + (k,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :n - k]], dim=-1)


def segmented_cumsum(values: torch.Tensor, starts: torch.Tensor
                     ) -> torch.Tensor:
    """Inclusive cumulative sum of `values` that restarts wherever
    `starts` is True (position 0 is implicitly a start).

    values: f32[N]; starts: bool[N]. Returns f32[N]."""
    n = values.shape[0]
    v = _pad_to_chunks(values, 0.0)
    s2 = _pad_to_chunks(starts, False).clone()
    s2[0, 0] = True
    g, l = v.shape

    # per-chunk segmented Hillis-Steele scan (column 0 acts as a reset;
    # the true cross-chunk carry is stitched below)
    f = s2.clone()
    f[:, 0] = True
    shift = 1
    while shift < l:
        vs = _shift_right(v, shift, 0.0)
        fs = _shift_right(f, shift, True)
        v = torch.where(f, v, v + vs)
        f = f | fs
        shift *= 2

    # cross-chunk carry: a segmented inclusive cumsum of the chunks'
    # last-column values, restarting at any chunk holding a real start
    cv = v[:, -1]
    cf = s2.any(dim=1)
    cf[0] = True
    shift = 1
    while shift < g:
        cvs = _shift_right(cv, shift, 0.0)
        cfs = _shift_right(cf, shift, True)
        cv = torch.where(cf, cv, cv + cvs)
        cf = cf | cfs
        shift *= 2
    carry_in = _shift_right(cv, 1, 0.0)
    # the carry applies to the head run only: elements before the
    # chunk's first real start
    before_first = torch.cumsum(s2.to(torch.int32), dim=1) == 0
    out = torch.where(before_first, v + carry_in[:, None], v)
    return out.reshape(-1)[:n]


def last_marked_carry(mask: torch.Tensor, *values: torch.Tensor
                      ) -> tuple[torch.Tensor, ...]:
    """Along the last axis, carry each payload forward from the most
    recent *strictly earlier* position where ``mask`` is True (exclusive
    scan; positions before any mark carry 0).

    mask: bool[..., L]; values: f32[..., L] each. Returns one tensor per
    payload, in log2(L) select steps."""
    m = _shift_right(mask, 1, False)
    vs = [_shift_right(v, 1, 0.0) for v in values]
    n = m.shape[-1]
    shift = 1
    while shift < n:
        # invariant: (m, vs) at i reflect the last mark in (i-2^k, i]
        m_s = _shift_right(m, shift, False)
        vs = [torch.where(m, v, _shift_right(v, shift, 0.0)) for v in vs]
        m = m | m_s
        shift *= 2
    return tuple(vs)
