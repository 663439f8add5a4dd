"""Streaming micro-fold mirror, PyTorch port of veneur_tpu/ops/microfold.py.

A micro-fold drains the staged samples accumulated since the last drain
as COO deltas (row, absolute slot, value, weight) and scatters them into
a persistent [M, B] mirror of the staging plane on the worker's device,
so by flush time the staged state is already resident and the flush's
fold starts from it instead of an upload.

Bit-identity by construction: slots are ABSOLUTE positions in the host
staging plane, so after the final drain the mirror holds exactly the
dense [S, B] plane the batch path uploads (values and weights at filled
slots, zeros elsewhere), and the flush runs the same staged fold
(core/worker.fold_staged) over the mirror's first s_eff rows, rows past
the mirror empty (``mirror_dense`` is that plane, as the plain chain
pads it).

Uploads go out in fixed MICRO_CHUNK-entry chunks of 16 bytes an entry
(row, slot, and the f32 bits of value and weight, one int32[chunk, 4]
record block); the remainder carries host-side across drains and the
final partial chunk is padded with DROP_ROW entries, so the bytes are
ceil(samples / MICRO_CHUNK) x MICRO_CHUNK x 16 however many micro-folds
ran. ``index_put_`` has no drop mode: the mirror keeps one spare row past
its M logical rows, padding entries land there, and the mirror's views
(``MirrorState``, ``mirror_dense``) never include it.

With a ``ledger`` (health/ledger.TransferLedger) every chunk's upload
books its 16 bytes an entry, as the JAX mirror books its four arrays:
into the ledger's epoch tally while the epoch is live, into the open
flush window once the swap handed the mirror to the extraction
(``book_in_flush``), where the residual feeds land.

On the card the record blocks are two pinned buffers used in turns
behind CUDA events (the pattern of ops/hll.HostInserter): a buffer is
refilled only after the copy out of it has landed, which also bounds the
queue of scatters to two. The scatters run on the current stream, the
one the flush's fold runs on, so the fold sees every scatter issued
before it.

Series-sharded (``shard``, ops/series_shard.SeriesSharding): the mirror
is D per-shard blocks of [M/D + 1, B] (each with its spare row), the
record blocks keep LOGICAL rows, and every chunk goes to every shard,
which keeps the entries of the rows it owns (r % D == d, at local index
r // D) and sends the rest to its spare row. Each shard's block is then
bitwise the plane the sharded batch path uploads to it. The upload books
its bytes once per shard, as the reference's replicated chunk does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# COO entries per upload chunk (1 MiB of records)
MICRO_CHUNK = 65536
# 16 bytes an entry: row, slot, value bits, weight bits
ENTRY_BYTES = 16
# the padding entries' row: past every mirror, so it lands on the spare row
DROP_ROW = np.int32(np.iinfo(np.int32).max)


def mirror_dense(arr: torch.Tensor, s_eff: int) -> torch.Tensor:
    """The mirror as a dense [s_eff, B] plane: sliced when the mirror is
    larger, zero-padded when the directory outgrew it. Either way it is
    bitwise the plane the batch path would have built."""
    m = arr.shape[0]
    if m == s_eff:
        return arr
    if m > s_eff:
        return arr[:s_eff]
    out = torch.zeros((s_eff, arr.shape[1]), dtype=arr.dtype,
                      device=arr.device)
    out[:m] = arr
    return out


class MirrorState(NamedTuple):
    """A finished epoch's mirror, handed to the swapped epoch's extract:
    the [M, B] value and weight planes (the spare row excluded; sharded:
    tuples of the D [M/D, B] blocks)."""

    vals: object
    wts: object
    rows_hi: int
    samples: int
    chunks: int
    nbytes: int


class MicroFoldMirror:
    """Device-side [M, B] mirror of one epoch's staging plane.

    Single-threaded by contract: the worker's ingest lock serializes
    feed() (the micro-fold scheduler) against the swap that hands the
    mirror to the flush, which alone feeds and finishes it afterwards."""

    def __init__(self, depth: int, device, initial_rows: int = 1024,
                 chunk: int = MICRO_CHUNK, guard=None, ledger=None,
                 shard=None) -> None:
        self.depth = int(depth)
        self.chunk = int(chunk)
        self.device = torch.device(device)
        self._ledger = ledger
        self._shard = shard
        # the devices the record blocks are copied to
        self._targets = (list(shard.devices) if shard is not None
                         else [self.device])
        # False while the epoch is live; the swap sets it for the residual
        # feeds the extraction makes
        self.book_in_flush = False
        # device guard (ops/device_guard.DeviceGuard): each chunk's upload
        # and scatter is one guarded op "micro". A fault surfaces as
        # DeviceFaultError to the caller, which drops the mirror: it is a
        # cache of the staging plane, never the only copy.
        self._guard = guard
        self._rows0 = max(1, int(initial_rows))
        if shard is not None:
            # mirror rows stay pow2 multiples of the shard count, so the
            # local blocks are equal-sized
            r = 1
            while r < max(self._rows0, shard.shards):
                r *= 2
            self._rows0 = r
        # the planes with their spare row(s): a tensor, or sharded a list
        # of the D blocks
        self._dvals = None
        self._dwts = None
        self._m = 0
        self.rows_hi = 0   # 1 + highest real row scattered this epoch
        self.samples = 0   # real COO entries fed (padding excluded)
        self.chunks = 0    # fixed-size scatter dispatches
        # two record blocks used in turns (pinned on the card), each with
        # the events of the last copies out of it
        pin = any(d.type == "cuda" for d in self._targets)
        self._blocks = []
        for _ in range(2):
            t = torch.empty((self.chunk, 4), dtype=torch.int32,
                            pin_memory=pin)
            self._blocks.append((t, t.numpy()))
        self._events: list = [[], []]
        self._turn = 0
        self._c_n = 0

    @property
    def nbytes(self) -> int:
        """Bytes uploaded so far (whole chunks, padding included)."""
        return self.chunks * self.chunk * ENTRY_BYTES

    def feed(self, rows, slots, vals, wts) -> None:
        """Buffer one drained COO delta; dispatch every full chunk."""
        n = len(rows)
        if n == 0:
            return
        self.samples += n
        hi = int(rows.max()) + 1
        if hi > self.rows_hi:
            self.rows_hi = hi
        vbits = np.ascontiguousarray(vals, np.float32).view(np.int32)
        wbits = np.ascontiguousarray(wts, np.float32).view(np.int32)
        i = 0
        while i < n:
            take = min(self.chunk - self._c_n, n - i)
            blk = self._blocks[self._turn][1]
            s = slice(self._c_n, self._c_n + take)
            blk[s, 0] = rows[i:i + take]
            blk[s, 1] = slots[i:i + take]
            blk[s, 2] = vbits[i:i + take]
            blk[s, 3] = wbits[i:i + take]
            self._c_n += take
            i += take
            if self._c_n == self.chunk:
                self._dispatch()
                self._c_n = 0

    def finish(self) -> Optional[MirrorState]:
        """Flush the carry (padded to a full chunk with DROP_ROW
        entries), detach the mirror for the swapped epoch, and reset.
        None when nothing was staged this epoch."""
        if self.samples == 0:
            self._c_n = 0
            return None
        if self._c_n > 0:
            blk = self._blocks[self._turn][1]
            blk[self._c_n:, 0] = DROP_ROW
            blk[self._c_n:, 1:] = 0
            self._dispatch()
            self._c_n = 0
        m = self._m
        if self._shard is None:
            vals, wts = self._dvals[:m], self._dwts[:m]
        else:
            cap = m // self._shard.shards
            vals = tuple(t[:cap] for t in self._dvals)
            wts = tuple(t[:cap] for t in self._dwts)
        state = MirrorState(vals, wts, self.rows_hi, self.samples,
                            self.chunks, self.nbytes)
        self._dvals = self._dwts = None
        self._m = 0
        self.rows_hi = self.samples = self.chunks = 0
        return state

    # -- internals --------------------------------------------------------

    def _dispatch(self) -> None:
        led = self._ledger
        if led is not None:
            nbytes = self.chunk * ENTRY_BYTES * len(self._targets)
            if self.book_in_flush:
                led.count_h2d(nbytes, "micro_fold")
            else:
                led.count_epoch_h2d(nbytes, "micro_fold")
        if self._guard is not None:
            self._guard.call("micro", self._scatter)
        else:
            self._scatter()
        self.chunks += 1

    def _scatter(self) -> None:
        """Upload the current record block and scatter it into the
        mirror (the padding onto the spare row; sharded, onto every
        shard, each keeping its own rows); then wait for the copies out
        of the other block, which the next feed refills."""
        i = self._turn
        host, blk = self._blocks[i]
        m = self._ensure_rows(self.rows_hi)
        np.minimum(blk[:, 0], m, out=blk[:, 0])
        events = self._events[i]
        for d, dev in enumerate(self._targets):
            recs = host.to(dev, non_blocking=True)
            rows = recs[:, 0].long()
            if self._shard is not None:
                shards = self._shard.shards
                owned = (rows < m) & (rows % shards == d)
                rows = torch.where(owned, rows // shards, m // shards)
                dv, dw = self._dvals[d], self._dwts[d]
            else:
                dv, dw = self._dvals, self._dwts
            at = (rows, recs[:, 1].long())
            dv.index_put_(at, recs[:, 2].view(torch.float32))
            dw.index_put_(at, recs[:, 3].view(torch.float32))
            if dev.type == "cuda":
                if len(events) <= d:
                    events.append(torch.cuda.Event())
                events[d].record(torch.cuda.current_stream(dev))
        self._turn ^= 1
        for ev in self._events[self._turn]:
            ev.synchronize()

    def _ensure_rows(self, needed: int) -> int:
        """Size the mirror to at least ``needed`` logical rows (pow2
        growth from ``initial_rows``), plus the spare row (one a shard);
        returns M. Sharded growth pads each shard's local block, which
        keeps every row at its local index."""
        if self._dvals is not None and needed <= self._m:
            return self._m
        m = self._m or self._rows0
        while m < needed:
            m *= 2
        if self._shard is None:
            self._dvals, self._dwts = (
                self._grown(self._dvals, m, self._m, self.device),
                self._grown(self._dwts, m, self._m, self.device))
        else:
            shards = self._shard.shards
            old = self._m // shards
            self._dvals, self._dwts = ([
                self._grown(None if planes is None else planes[d],
                            m // shards, old, dev)
                for d, dev in enumerate(self._targets)]
                for planes in (self._dvals, self._dwts))
        self._m = m
        return m

    def _grown(self, old, rows: int, old_rows: int, device):
        """A zero [rows + 1, B] plane holding ``old``'s first
        ``old_rows`` rows."""
        out = torch.zeros((rows + 1, self.depth), dtype=torch.float32,
                          device=device)
        if old is not None:
            out[:old_rows] = old[:old_rows]
        return out
