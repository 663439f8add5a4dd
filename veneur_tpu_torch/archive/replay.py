"""Re-ingest a VMB1 archive through the global tier's import path.

A replayed archive flows through the exact merge entrypoint forwarded
sketches use — ``ImportServer.handle_batch`` in-process, or a
ForwardClient RPC against a remote global — so backfill lands in the
same worker shards, under the same locks and tenant budgets, as live
traffic. Archived counter and gauge samples carry raw IEEE-754 flush
values (archive/wire.py), and the import path merges scalars exactly
(worker.import_counter / import_gauge), so a replayed flush re-emits the
archived series bit-for-bit (pinned by tools/soak_archive_replay.py).

With ``dedup=True`` every frame's batch is wrapped in a VDE1
idempotency envelope keyed by a stable, archive-derived (sender, id)
pair — the sender token hashes the archive's frame CRCs, the id is the
frame's position + CRC — so replaying the same archive twice merges
once: the second pass is absorbed by the receiver's DedupWindow with
honest ``metrics_deduped`` counters.

Status-check extras can't ride the import path (no pb representation)
and non-integral counter values can't merge exactly; both are counted,
never silently dropped.
"""

from __future__ import annotations

import logging
from zlib import crc32

from veneur_tpu_torch.archive.wire import decode_flush
from veneur_tpu_torch.core.metrics import MetricType
from veneur_tpu_torch.distributed import codec
from veneur_tpu_torch.gen import veneur_tpu_pb2 as pb

log = logging.getLogger("veneur_tpu_torch.archive.replay")


def samples_to_batch(samples) -> tuple["pb.MetricBatch", dict]:
    """Decoded VMB1 samples → one importable MetricBatch. Returns the
    batch plus the skip tally: ``status`` (extras the import path can't
    represent) and ``inexact`` (counters whose archived value isn't
    integral — int() would silently change the replayed bits)."""
    batch = pb.MetricBatch()
    skipped = {"status": 0, "inexact": 0}
    for s in samples:
        mtype = s["type"]
        value = s["value"]
        if mtype == int(MetricType.COUNTER):
            if value != int(value):
                skipped["inexact"] += 1
                continue
            m = batch.metrics.add()
            m.name = s["name"]
            m.tags.extend(s["tags"])
            m.kind = pb.KIND_COUNTER
            m.scope = pb.SCOPE_GLOBAL
            m.counter.value = int(value)
        elif mtype == int(MetricType.GAUGE):
            m = batch.metrics.add()
            m.name = s["name"]
            m.tags.extend(s["tags"])
            m.kind = pb.KIND_GAUGE
            m.scope = pb.SCOPE_GLOBAL
            m.gauge.value = float(value)
        else:
            skipped["status"] += 1
    return batch, skipped


def archive_sender_token(frames: list[bytes]) -> str:
    """Stable dedup sender token derived from the archive's content
    (the frame CRCs chained), so two replay runs of the same archive
    present as the SAME sender and absorb each other's duplicates."""
    acc = 0
    for frame in frames:
        acc = crc32(frame, acc)
    return f"archive:{acc:08x}"


def replay_frames(frames: list[bytes], apply_batch=None, apply_wire=None,
                  dedup: bool = False, sender: str = "") -> dict:
    """Drive every frame through one of the import entrypoints.

    ``apply_batch(pb.MetricBatch)`` is ImportServer.handle_batch (or a
    ForwardClient send); with ``dedup`` the frames go through
    ``apply_wire(blob)`` (ImportServer.handle_wire or send_raw) wrapped
    in VDE1 envelopes instead. Undecodable frames (corruption that beat
    both CRC layers, or a newer format) are counted, not fatal — a
    partial archive still backfills."""
    if dedup and apply_wire is None:
        raise ValueError("dedup replay needs an apply_wire entrypoint")
    if dedup and not sender:
        sender = archive_sender_token(frames)
    stats = {"frames": len(frames), "frames_applied": 0,
             "frames_undecodable": 0, "samples": 0, "imported": 0,
             "skipped_status": 0, "skipped_inexact": 0, "sender": sender}
    for idx, frame in enumerate(frames):
        try:
            decoded = decode_flush(frame)
        except ValueError as e:
            stats["frames_undecodable"] += 1
            log.warning("archive frame %d undecodable: %s", idx, e)
            continue
        stats["samples"] += len(decoded["samples"])
        batch, skipped = samples_to_batch(decoded["samples"])
        stats["skipped_status"] += skipped["status"]
        stats["skipped_inexact"] += skipped["inexact"]
        n = len(batch.metrics)
        if n:
            if dedup:
                # position + content keyed: stable across replay runs,
                # unique across the archive's frames
                dedup_id = (idx << 32) | crc32(frame)
                blob = codec.encode_dedup_envelope(
                    sender, dedup_id, n, batch.SerializeToString())
                apply_wire(blob)
            else:
                apply_batch(batch)
            stats["imported"] += n
        stats["frames_applied"] += 1
    return stats
