"""Write-ahead spill journal: crash-consistent backing for bounded spill.

The delivery layer (sinks/delivery.py) and the proxy forward path
(distributed/proxy.py) hold spilled payloads in RAM; a SIGKILL destroys
them and silently breaks the conservation contract across process
incarnations.  This module gives that spill a durable shadow:

  - append-only **segment files** (``seg-<seq:08d>.wal``) in a directory,
    rolled at a fixed size, bounded by total bytes AND segment count with
    oldest-first eviction (evicting live records is *counted*, never
    silent);
  - each record is length-prefixed and CRC-checksummed:
    ``u32 body_len | u32 crc32(body) | body`` where
    ``body = type(1B) | record_id(u64 LE) | payload``;
  - three record types: ``D`` (DATA: a spilled payload), ``A`` (ACK: the
    payload reached a terminal state — delivered, dropped, or evicted),
    and ``R`` (RESERVE: the id space below the record's id is claimed —
    ``mint_id`` hands out dedup ids from durably reserved blocks so an id
    used on the wire before its payload ever spilled can still never be
    re-minted by a later incarnation);
  - replay tolerates a **torn tail** (partial final record from a crash
    mid-append: stop that segment, keep everything before it) and
    **bit flips** (CRC-failing record mid-segment: skip it, keep going);
  - a configurable fsync policy: ``always`` (fsync per append),
    ``interval`` (fsync on explicit ``sync()``, called at flush edges),
    ``never`` (OS page cache only).

Record ids are unique across incarnations (next id resumes past the max
seen at replay), so an ACK written after a restart still cancels a DATA
record written before the crash.  Compaction deletes the oldest segment
once every DATA record in it is acked; ACK records referencing deleted
segments are no-ops on replay.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Callable, Dict, List, Optional, Set, Tuple

_HDR = struct.Struct("<II")  # body_len, crc32(body)
_ID = struct.Struct("<Q")
_TYPE_DATA = 0x44  # 'D'
_TYPE_ACK = 0x41  # 'A'
_TYPE_RESERVE = 0x52  # 'R' — rid is the exclusive upper bound of a minted block

# A single journal record larger than this is insane for metric payloads;
# a length field above it is treated as a torn/corrupt tail.
MAX_RECORD_BYTES = 32 << 20

SEGMENT_PREFIX = "seg-"
SEGMENT_SUFFIX = ".wal"

FSYNC_POLICIES = ("always", "interval", "never")


def _segment_name(seq: int) -> str:
    return f"{SEGMENT_PREFIX}{seq:08d}{SEGMENT_SUFFIX}"


def _segment_seq(name: str) -> Optional[int]:
    if not (name.startswith(SEGMENT_PREFIX) and name.endswith(SEGMENT_SUFFIX)):
        return None
    mid = name[len(SEGMENT_PREFIX) : -len(SEGMENT_SUFFIX)]
    try:
        return int(mid, 10)
    except ValueError:
        return None


def _scan_segment(path: str) -> Tuple[List[Tuple[int, int, bytes]], int, int]:
    """Parse one segment file tolerantly.

    Returns ``(events, skipped_corrupt, torn_tails)`` where each event is
    ``(type, record_id, payload)`` in file order.  A CRC-failing record is
    skipped (the length prefix is trusted to resynchronise); an impossible
    length or a short read stops the segment as a torn tail.
    """
    events: List[Tuple[int, int, bytes]] = []
    skipped = 0
    torn = 0
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return events, skipped, torn
    off = 0
    end = len(data)
    while off < end:
        if end - off < _HDR.size:
            torn += 1
            break
        body_len, crc = _HDR.unpack_from(data, off)
        if body_len > MAX_RECORD_BYTES or off + _HDR.size + body_len > end:
            torn += 1
            break
        body = data[off + _HDR.size : off + _HDR.size + body_len]
        off += _HDR.size + body_len
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            skipped += 1
            continue
        if body_len < 1 + _ID.size:
            skipped += 1
            continue
        rtype = body[0]
        if rtype not in (_TYPE_DATA, _TYPE_ACK, _TYPE_RESERVE):
            skipped += 1
            continue
        (rid,) = _ID.unpack_from(body, 1)
        events.append((rtype, rid, bytes(body[1 + _ID.size :])))
    return events, skipped, torn


def scan_pending(directory: str) -> List[Tuple[int, bytes]]:
    """Read-only scan of a journal directory: unacked DATA, oldest first.

    Safe to call on a live journal from another process (the crash soak
    uses it to count what a SIGKILLed incarnation left durable); a record
    being appended concurrently parses as a torn tail and is ignored.
    """
    try:
        names = sorted(
            n for n in os.listdir(directory) if _segment_seq(n) is not None
        )
    except OSError:
        return []
    pending: Dict[int, bytes] = {}
    for name in names:
        events, _, _ = _scan_segment(os.path.join(directory, name))
        for rtype, rid, payload in events:
            if rtype == _TYPE_DATA:
                pending[rid] = payload
            elif rtype == _TYPE_ACK:
                pending.pop(rid, None)
            # RESERVE claims id space; it never cancels a pending DATA
    return list(pending.items())


SENDER_TOKEN_FILE = "sender.id"


def sender_token(directory: str) -> str:
    """Stable per-journal sender identity for wire-level dedup keys.

    A dedup id is only unique within one minting sequence; the receiver
    keys its window on ``(sender, id)``.  The token lives next to the
    segments (``sender.id``) so it survives restarts with the journal —
    a wiped journal directory is a new id sequence AND a new sender, so
    stale receiver windows can never falsely dedup the fresh sequence.
    """
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, SENDER_TOKEN_FILE)
    try:
        with open(path, "r", encoding="ascii") as fh:
            tok = fh.read().strip()
        if tok:
            return tok
    except OSError:
        pass
    tok = os.urandom(8).hex()
    tmp = path + ".tmp"
    try:
        with open(tmp, "w", encoding="ascii") as fh:
            fh.write(tok)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except OSError:
        pass  # unwritable dir: token is process-lifetime only
    return tok


class SpillJournal:
    """Append-only, checksummed, bounded write-ahead journal.

    Thread-safe.  ``append`` never raises to the caller on I/O failure —
    durability is best-effort on a degraded disk and the in-RAM spill
    still holds the payload; failures are counted in ``append_failed``.
    """

    def __init__(
        self,
        directory: str,
        *,
        fsync: str = "interval",
        max_bytes: int = 64 << 20,
        max_segments: int = 8,
        segment_bytes: int = 0,
        log: Optional[Callable[[str], None]] = None,
    ) -> None:
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"journal fsync policy must be one of {FSYNC_POLICIES}, got {fsync!r}"
            )
        self.directory = directory
        self.fsync = fsync
        self.max_bytes = int(max_bytes)
        self.max_segments = max(1, int(max_segments))
        self.segment_bytes = int(segment_bytes) or max(
            64 << 10, self.max_bytes // self.max_segments
        )
        self._log = log or (lambda msg: None)
        self._lock = threading.RLock()
        self._fh = None  # current open segment file handle
        self._active_seq = 0
        self._active_size = 0
        # id -> owning segment seq, for every unacked DATA record
        self._pending_seg: Dict[int, int] = {}
        # seq -> unacked ids in that segment (insertion ordered via dict)
        self._seg_pending: Dict[int, Dict[int, None]] = {}
        self._seg_sizes: Dict[int, int] = {}
        self._next_id = 1
        # dedup-id minting: ids below _reserved_to are durably claimed by
        # a RESERVE record, so mint_id() is one fsync per block, not per id
        self._reserved_to = 1
        self.reserve_block = 4096
        # payloads recovered at open, released by replay_pending()
        self._recovered: List[Tuple[int, bytes]] = []
        # counters
        self.appended = 0
        self.acked = 0
        self.append_failed = 0
        self.minted = 0
        self.reserved_blocks = 0
        self.replayed = 0
        self.skipped_corrupt = 0
        self.torn_tails = 0
        self.evicted_records = 0
        self.compacted_segments = 0
        self._open()

    # ------------------------------------------------------------- setup

    def _open(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        names = sorted(
            n for n in os.listdir(self.directory) if _segment_seq(n) is not None
        )
        pending: Dict[int, bytes] = {}
        pending_seg: Dict[int, int] = {}
        max_id = 0
        max_seq = 0
        for name in names:
            seq = _segment_seq(name)
            assert seq is not None
            path = os.path.join(self.directory, name)
            events, skipped, torn = _scan_segment(path)
            self.skipped_corrupt += skipped
            self.torn_tails += torn
            self._seg_sizes[seq] = os.path.getsize(path) if os.path.exists(path) else 0
            self._seg_pending.setdefault(seq, {})
            max_seq = max(max_seq, seq)
            for rtype, rid, payload in events:
                if rtype == _TYPE_RESERVE:
                    # rid is an exclusive bound: the previous incarnation
                    # may have minted any id below it onto the wire
                    max_id = max(max_id, rid - 1)
                    continue
                max_id = max(max_id, rid)
                if rtype == _TYPE_DATA:
                    pending[rid] = payload
                    pending_seg[rid] = seq
                else:
                    old = pending_seg.pop(rid, None)
                    pending.pop(rid, None)
                    if old is not None:
                        self._seg_pending.get(old, {}).pop(rid, None)
        for rid, seq in pending_seg.items():
            self._seg_pending.setdefault(seq, {})[rid] = None
        self._pending_seg = pending_seg
        self._recovered = list(pending.items())
        self._next_id = max_id + 1
        self._reserved_to = self._next_id  # no live reservation headroom
        # Never append to a pre-existing segment (its tail may be torn);
        # start a fresh one past everything seen.
        self._active_seq = max_seq + 1
        self._roll_to(self._active_seq)
        self._drop_fully_acked_oldest()

    def _roll_to(self, seq: int) -> None:
        if self._fh is not None:
            try:
                self._fh.flush()
                if self.fsync == "always":
                    os.fsync(self._fh.fileno())
                self._fh.close()
            except OSError:
                pass
        path = os.path.join(self.directory, _segment_name(seq))
        self._fh = open(path, "ab")
        self._active_seq = seq
        self._active_size = os.path.getsize(path)
        self._seg_sizes[seq] = self._active_size
        self._seg_pending.setdefault(seq, {})
        if self._reserved_to > self._next_id:
            # Re-assert the live reservation in the fresh segment: the
            # active segment is never evicted, so compaction deleting the
            # segment the original R landed in can't lose the bound.
            if self._write_record(
                bytes([_TYPE_RESERVE]) + _ID.pack(self._reserved_to)
            ):
                try:
                    os.fsync(self._fh.fileno())
                except OSError:
                    pass
        self._sync_dir()

    def _sync_dir(self) -> None:
        try:
            dfd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass

    # ----------------------------------------------------------- records

    def _write_record(self, body: bytes) -> bool:
        hdr = _HDR.pack(len(body), zlib.crc32(body) & 0xFFFFFFFF)
        try:
            assert self._fh is not None
            self._fh.write(hdr)
            self._fh.write(body)
            self._fh.flush()
            if self.fsync == "always":
                os.fsync(self._fh.fileno())
        except (OSError, AssertionError):
            return False
        n = len(hdr) + len(body)
        self._active_size += n
        self._seg_sizes[self._active_seq] = self._active_size
        return True

    def append(self, payload: bytes) -> Optional[int]:
        """Durably record a spilled payload; returns its record id.

        Returns None if the write failed (degraded disk) — the caller's
        in-RAM copy is then the only copy, same as journaling off.
        """
        with self._lock:
            rid = self._next_id
            body = bytes([_TYPE_DATA]) + _ID.pack(rid) + payload
            if self._active_size + _HDR.size + len(body) > self.segment_bytes:
                self._roll_to(self._active_seq + 1)
                self._enforce_caps()
            if not self._write_record(body):
                self.append_failed += 1
                return None
            self._next_id = rid + 1
            self.appended += 1
            self._pending_seg[rid] = self._active_seq
            self._seg_pending.setdefault(self._active_seq, {})[rid] = None
            self._enforce_caps()
            return rid

    def mint_id(self) -> int:
        """Mint an id unique across incarnations WITHOUT journaling data.

        ``append`` already makes spilled payloads' ids crash-unique; this
        extends the same discipline to ids used purely as wire dedup keys
        (in-flight fragments that may never spill).  Ids come from the
        same sequence as record ids, pre-claimed in durable blocks: one
        RESERVE record (fsynced regardless of policy) covers the next
        ``reserve_block`` mints, so a restarted incarnation resumes past
        everything a dead one could possibly have put on the wire.
        """
        with self._lock:
            if self._next_id >= self._reserved_to:
                bound = self._next_id + max(1, int(self.reserve_block))
                body = bytes([_TYPE_RESERVE]) + _ID.pack(bound)
                if self._active_size + _HDR.size + len(body) > self.segment_bytes:
                    self._roll_to(self._active_seq + 1)
                    self._enforce_caps()
                if self._write_record(body):
                    # the reservation must hit the platter BEFORE any id
                    # from the block rides the wire as a dedup key
                    try:
                        assert self._fh is not None
                        os.fsync(self._fh.fileno())
                    except (OSError, AssertionError):
                        pass
                    self.reserved_blocks += 1
                else:
                    # degraded disk: keep minting (uniqueness within this
                    # incarnation still holds); counted, never silent
                    self.append_failed += 1
                self._reserved_to = bound
            rid = self._next_id
            self._next_id = rid + 1
            self.minted += 1
            return rid

    def ack(self, rid: int) -> None:
        """Record that payload `rid` reached a terminal state."""
        with self._lock:
            seq = self._pending_seg.pop(rid, None)
            if seq is None:
                return  # already acked, or evicted with its segment
            self._seg_pending.get(seq, {}).pop(rid, None)
            body = bytes([_TYPE_ACK]) + _ID.pack(rid)
            if self._write_record(body):
                self.acked += 1
            self._drop_fully_acked_oldest()

    def replay_pending(self) -> List[Tuple[int, bytes]]:
        """Unacked DATA records found at open, oldest first.

        The payload bytes are released after the first call (the ids stay
        pending until acked); a second call returns [].
        """
        with self._lock:
            out, self._recovered = self._recovered, []
            self.replayed += len(out)
            return out

    # ------------------------------------------------------------ bounds

    def _closed_segments(self) -> List[int]:
        return sorted(s for s in self._seg_sizes if s != self._active_seq)

    def _total_bytes(self) -> int:
        return sum(self._seg_sizes.values())

    def _delete_segment(self, seq: int) -> None:
        ids = self._seg_pending.pop(seq, {})
        for rid in ids:
            self._pending_seg.pop(rid, None)
        self.evicted_records += len(ids)
        self._seg_sizes.pop(seq, None)
        try:
            os.unlink(os.path.join(self.directory, _segment_name(seq)))
        except OSError:
            pass
        self._sync_dir()

    def _enforce_caps(self) -> None:
        # Oldest-first eviction; the active segment is never deleted.
        while True:
            closed = self._closed_segments()
            over_segments = len(closed) + 1 > self.max_segments
            over_bytes = self._total_bytes() > self.max_bytes
            if not closed or not (over_segments or over_bytes):
                break
            victim = closed[0]
            live = len(self._seg_pending.get(victim, {}))
            if live:
                self._log(
                    f"journal {self.directory}: evicting segment {victim} "
                    f"with {live} unacked records (over cap)"
                )
            self._delete_segment(victim)

    def _drop_fully_acked_oldest(self) -> None:
        # Compaction: delete oldest closed segments whose DATA are all
        # acked.  Only oldest-first — a middle segment may hold ACKs for
        # older DATA and must outlive them.
        for seq in self._closed_segments():
            if self._seg_pending.get(seq):
                break
            self._delete_segment(seq)  # fully acked: nothing live lost
            self.compacted_segments += 1

    # ------------------------------------------------------------- admin

    def set_policy(
        self,
        *,
        fsync: Optional[str] = None,
        max_bytes: Optional[int] = None,
        max_segments: Optional[int] = None,
    ) -> None:
        """Hot-reload knobs; takes effect on the next append/roll."""
        with self._lock:
            if fsync is not None:
                if fsync not in FSYNC_POLICIES:
                    raise ValueError(f"bad fsync policy {fsync!r}")
                self.fsync = fsync
            if max_bytes is not None:
                self.max_bytes = int(max_bytes)
            if max_segments is not None:
                self.max_segments = max(1, int(max_segments))
            self.segment_bytes = max(64 << 10, self.max_bytes // self.max_segments)
            self._enforce_caps()

    def sync(self) -> None:
        """Flush+fsync the active segment (the ``interval`` policy edge)."""
        with self._lock:
            if self._fh is None or self.fsync == "never":
                return
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except OSError:
                pass

    def pending_records(self) -> int:
        with self._lock:
            return len(self._pending_seg)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "appended": self.appended,
                "acked": self.acked,
                "append_failed": self.append_failed,
                "minted": self.minted,
                "reserved_blocks": self.reserved_blocks,
                "replayed": self.replayed,
                "skipped_corrupt": self.skipped_corrupt,
                "torn_tails": self.torn_tails,
                "evicted_records": self.evicted_records,
                "compacted_segments": self.compacted_segments,
                "pending_records": len(self._pending_seg),
                "segments": len(self._seg_sizes),
                "bytes": self._total_bytes(),
            }

    def close(self) -> None:
        with self._lock:
            if self._fh is None:
                return
            try:
                self._fh.flush()
                if self.fsync != "never":
                    os.fsync(self._fh.fileno())
                self._fh.close()
            except OSError:
                pass
            self._fh = None
