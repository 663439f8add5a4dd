"""Consistent hash ring for cross-host series sharding.

Plays the role of the reference's vendored stathat.com/c/consistent ring
(proxy.go:587-628, proxysrv/server.go:273-282): metric keys hash onto a
ring of virtual nodes so each series consistently lands on one global
instance, and membership churn only remaps the affected arc.

Live-membership additions (the reshard-handoff machinery in
distributed/proxy.py builds on these):

- a monotonic `version`, bumped once per membership mutation, so the
  proxy can stamp spilled batches and telemetry with the ring they were
  routed under;
- `set_members` returns a RingChange carrying the version, the joined/
  departed members, and the DIFF OF MOVED HASH RANGES — the arcs whose
  owner changed, which is exactly the set of keys a reshard re-homes
  (the Dynamo-style minimal-remap property, asserted by
  tests/test_distributed.py: a leave only moves arcs the departed
  member owned);
- lookups (`get`, `owners_for_hashes`) read an immutable snapshot view
  swapped atomically on mutation, so a placement racing a reshard sees
  one consistent membership — never a frankenstein ring that could
  return a member no version ever contained.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Optional

from veneur_tpu_torch.utils.hashing import fnv1a_64, fmix64

DEFAULT_REPLICAS = 64

HASH_SPACE = 1 << 64


class _RingView:
    """Immutable placement snapshot: one consistent (hashes, owners,
    members) triple. Mutations build a new view and swap the reference;
    readers grab the reference once, so every owner they return belongs
    to this single version's membership."""

    __slots__ = ("hashes", "owners", "members", "version", "_np_hashes")

    def __init__(self, hashes: tuple, owners: tuple, members: frozenset,
                 version: int) -> None:
        self.hashes = hashes
        self.owners = owners          # aligned with hashes
        self.members = members
        self.version = version
        self._np_hashes = None        # lazy, built on first vectorized use

    def get_hashed(self, h: int) -> str:
        """Owner of a pre-hashed key (first virtual node clockwise)."""
        if not self.hashes:
            raise LookupError("empty ring")
        idx = bisect.bisect_right(self.hashes, h)
        if idx == len(self.hashes):
            idx = 0
        return self.owners[idx]

    def owners_for_hashes(self, hashes) -> list:
        import numpy as np

        if not self.hashes:
            raise LookupError("empty ring")
        if self._np_hashes is None:
            self._np_hashes = np.asarray(self.hashes, dtype=np.uint64)
        idx = np.searchsorted(self._np_hashes,
                              np.asarray(hashes, np.uint64), side="right")
        idx[idx == len(self.hashes)] = 0
        owners = self.owners
        return [owners[i] for i in idx.tolist()]


@dataclass
class RingChange:
    """What one membership mutation did: the new version, who joined and
    left, and the half-open [lo, hi) hash ranges whose owner changed
    (old_owner/new_owner are None for an empty before/after ring). A
    RingChange is always truthy — set_members returns None on no
    change, preserving the old boolean contract."""

    version: int
    added: list = field(default_factory=list)
    removed: list = field(default_factory=list)
    # (lo, hi, old_owner, new_owner) half-open ranges, wraparound split
    # into its two linear pieces
    moved_ranges: list = field(default_factory=list)
    # provenance of the mutation ("discovery", "quarantine", "scale_in",
    # ...) — the elastic tier stamps it so a reshard in telemetry or a
    # soak event log names WHY membership moved, not just what moved
    cause: str = ""

    def __bool__(self) -> bool:
        return True

    def moved_fraction(self) -> float:
        """Fraction of the hash space whose owner changed — the minimal-
        remap witness (a clean join/leave of one member among N moves
        ~1/N of the space, never everything)."""
        return sum(hi - lo for lo, hi, _, _ in self.moved_ranges) \
            / float(HASH_SPACE)

    def owner_changed(self, h: int) -> bool:
        """Whether a pre-hashed key's owner moved in this change."""
        for lo, hi, _, _ in self.moved_ranges:
            if lo <= h < hi:
                return True
        return False


def _moved_ranges(old: _RingView, new: _RingView) -> list:
    """Diff two views into the arcs whose owner changed. The owner
    function is piecewise-constant between ring points, so evaluating
    each segment of the merged breakpoint set at its left edge covers
    the whole space exactly once (the wrap segment is split into its
    [last, 2^64) and [0, first) pieces)."""
    points = sorted(set(old.hashes) | set(new.hashes))
    if not points:
        return []

    def own(view: _RingView, h: int) -> Optional[str]:
        try:
            return view.get_hashed(h)
        except LookupError:
            return None

    raw = []
    for i in range(len(points) - 1):
        a = points[i]
        o, n = own(old, a), own(new, a)
        if o != n:
            raw.append((a, points[i + 1], o, n))
    # wrap region: every h >= the last point (and every h < the first)
    # maps to the first point clockwise, i.e. the global minimum
    o, n = own(old, points[-1]), own(new, points[-1])
    if o != n:
        raw.append((points[-1], HASH_SPACE, o, n))
        if points[0] > 0:
            raw.insert(0, (0, points[0], o, n))
    merged: list = []
    for seg in raw:
        if (merged and merged[-1][1] == seg[0]
                and merged[-1][2] == seg[2] and merged[-1][3] == seg[3]):
            merged[-1] = (merged[-1][0], seg[1], seg[2], seg[3])
        else:
            merged.append(seg)
    return merged


class ConsistentRing:
    def __init__(self, members: Optional[list[str]] = None,
                 replicas: int = DEFAULT_REPLICAS) -> None:
        self.replicas = replicas
        self.version = 0
        self._members: set[str] = set()
        self._hashes: list[int] = []
        self._owners: dict[int, str] = {}
        self._view = _RingView((), (), frozenset(), 0)
        if members:
            for m in members:
                self._add(m)
            self.version = 1 if self._members else 0
            self._rebuild_view()

    @staticmethod
    def _hash(s: str) -> int:
        return fmix64(fnv1a_64(s.encode("utf-8")))

    def _rebuild_view(self) -> None:
        self._view = _RingView(
            tuple(self._hashes),
            tuple(self._owners[h] for h in self._hashes),
            frozenset(self._members),
            self.version)

    def view(self) -> _RingView:
        """The current immutable placement snapshot (one consistent
        membership for a whole multi-key routing pass)."""
        return self._view

    def _add(self, member: str) -> bool:
        if member in self._members:
            return False
        self._members.add(member)
        for i in range(self.replicas):
            h = self._hash(f"{member}#{i}")
            if h in self._owners:
                continue
            bisect.insort(self._hashes, h)
            self._owners[h] = member
        return True

    def _remove(self, member: str) -> bool:
        if member not in self._members:
            return False
        self._members.discard(member)
        for i in range(self.replicas):
            h = self._hash(f"{member}#{i}")
            if self._owners.get(h) == member:
                del self._owners[h]
                idx = bisect.bisect_left(self._hashes, h)
                if idx < len(self._hashes) and self._hashes[idx] == h:
                    del self._hashes[idx]
        return True

    def add(self, member: str) -> Optional[RingChange]:
        old = self._view
        if not self._add(member):
            return None
        self.version += 1
        self._rebuild_view()
        return RingChange(self.version, added=[member],
                          moved_ranges=_moved_ranges(old, self._view))

    def remove(self, member: str) -> Optional[RingChange]:
        old = self._view
        if not self._remove(member):
            return None
        self.version += 1
        self._rebuild_view()
        return RingChange(self.version, removed=[member],
                          moved_ranges=_moved_ranges(old, self._view))

    def set_members(self, members: list[str],
                    cause: str = "") -> Optional[RingChange]:
        """Replace membership; returns the RingChange (truthy) if
        anything changed, None otherwise. `cause` stamps the change's
        provenance for telemetry (see RingChange.cause)."""
        new = set(members)
        if new == self._members:
            return None
        old = self._view
        added = sorted(new - self._members)
        removed = sorted(self._members - new)
        for m in removed:
            self._remove(m)
        for m in added:
            self._add(m)
        self.version += 1
        self._rebuild_view()
        return RingChange(self.version, added=added, removed=removed,
                          moved_ranges=_moved_ranges(old, self._view),
                          cause=cause)

    def members(self) -> list[str]:
        return sorted(self._view.members)

    def get(self, key: str) -> str:
        """Owner of a key (the first virtual node clockwise)."""
        return self._view.get_hashed(self._hash(key))

    def owners_for_hashes(self, hashes) -> list:
        """Vectorized placement for pre-hashed keys (the native wire
        decoder emits fmix64(fnv1a64(key)) per metric): one searchsorted
        over the ring points instead of a Python hash + bisect per key.
        Returns one owner per input hash, all placed on ONE consistent
        membership snapshot even while a reshard runs concurrently."""
        return self._view.owners_for_hashes(hashes)

    def __len__(self) -> int:
        return len(self._view.members)
