"""Two-tier (sparse host / dense device) HyperLogLog set store, PyTorch port
of veneur_tpu/ops/staged_sets.py.

The dense pool of ops/hll.py costs 2^p bytes per series (16 KB at
p = 14). Small sets instead live on the host as (row, register-index,
rank) triples; compaction lexsorts by (row, idx) and keeps the max rank
per pair — exactly the register content, at ~9 bytes per distinct
register. A row crossing ``promote_entries`` distinct registers replays
its triples into a dense int8 row on the worker's device through the same
scatter-max insert (ops/hll.HostInserter, the hll_insert kernel on the
card); later inserts route straight to the device. Imported full-register
rows are dense by nature and promote at the next flush.

The sparse tier is the reference's NumPy code, copied; the dense tier is
one torch int8 tensor on ``device``, updated in place. Estimates use the
same estimator on both sides (ops/hll.estimate, the hll_estimate kernel
on the card, for dense rows), so a series reports identically on either
side of promotion.

Device fault domain (ops/device_guard.py): every dense-tier device op
(inserts, growth, estimates, the register readback) runs under the
worker's guard as op "sets". Register updates are max-merges, idempotent
and order-free, so on a classified fault the dense tier moves to the CPU
(``to_host``: the same torch int8 tensor on the CPU, where ops/hll takes
its plain versions) and the faulted update is applied again there;
``to_device`` moves it back when the probe re-admits the card.

Not ported here: the series-sharded dense tier (``shard=``; the factory
refuses series sharding).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops.device_guard import DeviceFaultError, host_copy


class StagedSetStore:
    """Per-epoch set-sketch state for one worker (staged representation).

    All rows are identified by the worker directory's set-row index."""

    def __init__(self, precision: int = hll_ops.DEFAULT_PRECISION,
                 promote_entries: Optional[int] = None,
                 compact_every: int = 1 << 16, device=None,
                 guard=None, host: bool = False) -> None:
        self.precision = precision
        # the device of the dense tier; in host mode it lives on the CPU
        self.device = device
        self.m = hll_ops.num_registers(precision)
        self.promote_entries = promote_entries or max(self.m // 8, 64)
        self.compact_every = compact_every
        # sparse tier: compacted sorted-unique keys row*m+idx with max rank
        self._ckeys = np.empty(0, np.int64)
        self._crank = np.empty(0, np.int8)
        # pending (uncompacted) triples
        self._p_keys: list[np.ndarray] = []
        self._p_rank: list[np.ndarray] = []
        self._pend = 0
        # dense tier
        self._slot_of_row: dict[int, int] = {}
        # vectorized row→slot lookup (-1 = sparse); grows with max row
        self._slot_lut = np.full(64, -1, np.int32)
        self._dense: Optional[torch.Tensor] = None  # int8 [slots, m]
        self._inserter = hll_ops.HostInserter()
        self._guard = guard
        # host mode: the dense tier is a CPU tensor (a quarantined worker,
        # or the failover after a dense-tier fault)
        self._host = bool(host)
        # imported full-register rows max-merge host-side and batch onto
        # the device once per flush
        self._imp_dense: dict[int, np.ndarray] = {}

    # -- device fault domain ------------------------------------------------

    @property
    def host_mode(self) -> bool:
        return self._host

    @property
    def _dense_device(self):
        return "cpu" if self._host else self.device

    def _dev_call(self, fn, *args, retryable: bool = False):
        """One dense-tier device op through the worker's guard (in host
        mode, or without a guard, a plain call)."""
        if self._guard is None or self._host:
            return fn(*args)
        return self._guard.call("sets", fn, *args, retryable=retryable)

    def to_host(self) -> None:
        """Move the dense tier to the CPU. Safe after a partly applied
        faulted update: max-merges applied again only re-assert ranks."""
        if self._host:
            return
        self._host = True
        if self._dense is not None:
            self._dense = host_copy(self._dense, "set dense tier")

    def to_device(self) -> None:
        """Move the dense tier back to the device (the probe succeeded).
        Nothing changes if the upload raises."""
        if not self._host:
            return
        if self._dense is not None:
            self._dense = self._dense.to(self.device)
        self._host = False

    # -- ingest -------------------------------------------------------------

    def insert(self, rows: np.ndarray, idx: np.ndarray,
               rank: np.ndarray) -> None:
        """Batch of (row, register, rank) updates (host arrays)."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        idx = np.asarray(idx, np.int64)
        rank = np.asarray(rank, np.int8)
        if self._slot_of_row:
            dense_slot = self._slot_lut[
                np.minimum(rows, self._slot_lut.size - 1)]
            dense_slot = np.where(rows < self._slot_lut.size, dense_slot, -1)
            dmask = dense_slot >= 0
            if dmask.any():
                self._dense_insert(dense_slot[dmask], idx[dmask],
                                   rank[dmask])
            smask = ~dmask
            rows, idx, rank = rows[smask], idx[smask], rank[smask]
            if rows.size == 0:
                return
        self._p_keys.append(rows * self.m + idx)
        self._p_rank.append(rank)
        self._pend += rows.size
        if self._pend >= self.compact_every:
            self._compact()

    def import_dense(self, row: int, registers: np.ndarray) -> None:
        """Merge a full register row (wire import) — dense by nature.
        Max-merged host-side; promoted to the device in one batched
        update at flush (_apply_imports)."""
        row = int(row)
        regs = np.asarray(registers, np.int8)
        prev = self._imp_dense.get(row)
        self._imp_dense[row] = (regs.copy() if prev is None
                                else np.maximum(prev, regs))

    def _apply_imports(self) -> None:
        if not self._imp_dense:
            return
        rows = sorted(self._imp_dense)
        slots = np.asarray([self._promote(r) for r in rows], np.int64)
        stacked = np.stack([self._imp_dense[r] for r in rows])
        self._imp_dense = {}
        assert self._dense is not None

        def merge_rows(dense):
            # slots are distinct (one per imported row): a row-wise max
            at = torch.from_numpy(slots).to(dense.device)
            dense[at] = torch.maximum(
                dense[at], torch.from_numpy(stacked).to(dense.device))

        try:
            self._dev_call(merge_rows, self._dense, retryable=True)
        except DeviceFaultError:
            self.to_host()
            merge_rows(self._dense)

    # -- internals ----------------------------------------------------------

    def _dense_insert(self, slots: np.ndarray, idx: np.ndarray,
                      rank: np.ndarray) -> None:
        assert self._dense is not None
        try:
            self._dev_call(self._inserter.insert, self._dense, slots, idx,
                           rank, retryable=True)
        except DeviceFaultError:
            self.to_host()
            self._inserter.insert(self._dense, slots, idx, rank)

    def _compact(self) -> None:
        self._compact_no_promote()
        self._maybe_promote()

    def _maybe_promote(self) -> None:
        rows = self._ckeys // self.m
        # distinct-register count per row (keys are sorted ⇒ rows grouped)
        urows, counts = np.unique(rows, return_counts=True)
        for r in urows[counts >= self.promote_entries]:
            self._promote(int(r))

    def _promote(self, row: int) -> int:
        """Move one row's sparse entries into a dense device row."""
        if row in self._slot_of_row:
            return self._slot_of_row[row]
        self._compact_pending_row(row)
        slot = len(self._slot_of_row)
        self._slot_of_row[row] = slot
        if row >= self._slot_lut.size:
            grown = np.full(max(self._slot_lut.size * 2, row + 1), -1,
                            np.int32)
            grown[:self._slot_lut.size] = self._slot_lut
            self._slot_lut = grown
        self._slot_lut[row] = slot
        if self._dense is None or slot >= self._dense.shape[0]:
            grown = max(16, (slot + 1) * 2)

            def grow(old, device):
                fresh = hll_ops.init_pool(grown, self.precision, device)
                if old is not None:
                    fresh[:old.shape[0]] = old
                return fresh

            try:
                self._dense = self._dev_call(grow, self._dense,
                                             self._dense_device,
                                             retryable=True)
            except DeviceFaultError:
                self.to_host()
                self._dense = grow(self._dense, "cpu")
        mask = (self._ckeys // self.m) == row
        if mask.any():
            idx = (self._ckeys[mask] % self.m).astype(np.int32)
            rank = self._crank[mask]
            self._dense_insert(np.full(idx.shape, slot, np.int32), idx, rank)
            keep = ~mask
            self._ckeys, self._crank = self._ckeys[keep], self._crank[keep]
        return slot

    def _compact_pending_row(self, row: int) -> None:
        # promotion needs the row's full sparse content; cheapest correct
        # move is a full compaction (amortized by compact_every)
        if self._p_keys:
            self._compact_no_promote()

    def _compact_no_promote(self) -> None:
        if not self._p_keys:
            return
        keys = np.concatenate([self._ckeys] + self._p_keys)
        rank = np.concatenate([self._crank] + self._p_rank)
        self._p_keys, self._p_rank, self._pend = [], [], 0
        if keys.size == 0:
            self._ckeys, self._crank = keys, rank
            return
        order = np.lexsort((rank, keys))
        keys, rank = keys[order], rank[order]
        # last element of each equal-key run holds the max rank
        is_end = np.r_[keys[1:] != keys[:-1], True]
        self._ckeys, self._crank = keys[is_end], rank[is_end]

    # -- flush --------------------------------------------------------------

    def estimates(self, num_rows: int) -> np.ndarray:
        """Cardinality estimate per directory set row [num_rows] (f32).

        Sparse rows evaluate the same estimator as the device kernel
        (harmonic mean + linear counting) over their distinct registers;
        dense rows read the device result.
        """
        self._apply_imports()
        self._compact_no_promote()
        m = float(self.m)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        out = np.zeros(num_rows, np.float32)
        rows = self._ckeys // self.m
        inv = np.power(2.0, -self._crank.astype(np.float64))
        # segmented sums per row over the sorted keys
        urows, starts = np.unique(rows, return_index=True)
        ends = np.r_[starts[1:], rows.size]
        csum = np.r_[0.0, np.cumsum(inv)]
        for r, a, b in zip(urows, starts, ends):
            if r >= num_rows:
                continue
            d = b - a  # distinct registers
            zeros = m - d
            inv_sum = zeros + (csum[b] - csum[a])
            raw = alpha * m * m / inv_sum
            if raw <= 2.5 * m and zeros > 0:
                out[r] = m * np.log(m / zeros)
            else:
                out[r] = raw
        if self._slot_of_row and self._dense is not None:
            def est(dense):
                return hll_ops.estimate(dense, self.precision).cpu().numpy()

            try:
                dense_est = self._dev_call(est, self._dense, retryable=True)
            except DeviceFaultError:
                # the CPU's plain estimate is bitwise the kernel's
                self.to_host()
                dense_est = est(self._dense)
            for r, s in self._slot_of_row.items():
                if r < num_rows:
                    out[r] = dense_est[s]
        return out

    def registers(self, num_rows: int) -> np.ndarray:
        """Materialize dense int8 register rows [num_rows, m] (the
        forwarding codec's wire form). Transient — only built at flush
        for rows that actually forward."""
        self._apply_imports()
        self._compact_no_promote()
        out = np.zeros((num_rows, self.m), np.int8)
        rows = (self._ckeys // self.m).astype(np.int64)
        idx = (self._ckeys % self.m).astype(np.int64)
        mask = rows < num_rows
        out[rows[mask], idx[mask]] = self._crank[mask]
        if self._slot_of_row and self._dense is not None:
            try:
                dense_np = self._dev_call(lambda d: d.cpu().numpy(),
                                          self._dense, retryable=True)
            except DeviceFaultError:
                self.to_host()
                dense_np = self._dense.numpy()
            for r, s in self._slot_of_row.items():
                if r < num_rows:
                    out[r] = dense_np[s]
        return out

    @property
    def sparse_entries(self) -> int:
        return int(self._ckeys.size) + self._pend

    @property
    def dense_rows(self) -> int:
        return len(self._slot_of_row)
