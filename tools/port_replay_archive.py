#!/usr/bin/env python3
"""Replay a VMB1 metric archive into a running global tier, with the port.

The counterpart of tools/replay_archive.py over veneur_tpu_torch: reads
every frame of a segmented archive directory (the ``metrics-*.vmb`` log
MetricArchiveSink writes, or any directory of ``.vmb`` frames fetched
back from blob storage) and re-ingests the archived counter and gauge
samples through the import path, the merge entrypoint that live
forwarded traffic uses, so a backfill is bit-identical to the original
flush (archive/replay.py).

Modes:

* ``--inspect`` (or no --target): decode-only census: frames, samples,
  per-type counts, skip tally, the archive's stable sender token. No
  network.
* ``--target host:port``: replay over the Forward gRPC service
  (distributed/rpc.ForwardClient) into a global instance.
* ``--dedup``: wrap every frame's batch in a VDE1 idempotency envelope
  keyed by the archive's content (sender = chained frame CRCs, id =
  frame position + CRC), so running the tool twice against the same
  target merges once; the receiver's dedup window absorbs the second run
  and counts it in ``metrics_deduped``.

The tool runs no device work: decoding is host code and the target
server merges on its own device. Prints one JSON stats line; exits
nonzero if any frame failed to decode or any send raised.

Usage: python3 tools/port_replay_archive.py --dir /var/veneur/archive
         [--target host:port] [--dedup] [--inspect] [--timeout-s 10]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def inspect(frames) -> dict:
    from veneur_tpu_torch.archive.replay import (archive_sender_token,
                                                 samples_to_batch)
    from veneur_tpu_torch.archive.wire import decode_flush

    stats = {"frames": len(frames), "frames_undecodable": 0,
             "samples": 0, "importable": 0, "skipped_status": 0,
             "skipped_inexact": 0, "by_type": collections.Counter(),
             "sender": archive_sender_token(frames)}
    for frame in frames:
        try:
            decoded = decode_flush(frame)
        except ValueError:
            stats["frames_undecodable"] += 1
            continue
        stats["samples"] += len(decoded["samples"])
        for s in decoded["samples"]:
            stats["by_type"][s["type"]] += 1
        batch, skipped = samples_to_batch(decoded["samples"])
        stats["importable"] += len(batch.metrics)
        stats["skipped_status"] += skipped["status"]
        stats["skipped_inexact"] += skipped["inexact"]
    stats["by_type"] = dict(stats["by_type"])
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True,
                    help="archive directory (metrics-*.vmb segments)")
    ap.add_argument("--target", default="",
                    help="global instance forward gRPC host:port;"
                         " empty = inspect only")
    ap.add_argument("--dedup", action="store_true",
                    help="wrap batches in VDE1 idempotency envelopes"
                         " (replaying twice merges once)")
    ap.add_argument("--inspect", action="store_true",
                    help="decode-only census, no sends")
    ap.add_argument("--timeout-s", type=float, default=10.0)
    args = ap.parse_args(argv)

    from veneur_tpu_torch.archive.sink import read_archive

    frames = read_archive(args.dir)
    if not frames:
        print(json.dumps({"error": f"no frames under {args.dir}"}))
        return 1

    if args.inspect or not args.target:
        stats = inspect(frames)
        stats["mode"] = "inspect"
        print(json.dumps(stats))
        return 0 if not stats["frames_undecodable"] else 1

    from veneur_tpu_torch.archive.replay import replay_frames
    from veneur_tpu_torch.distributed.rpc import ForwardClient

    client = ForwardClient(args.target, timeout_s=args.timeout_s)
    try:
        # n_metrics rides the envelope; the count given with a raw blob
        # only feeds the client's own sent-metric telemetry
        stats = replay_frames(
            frames, apply_batch=client.send_or_raise,
            apply_wire=lambda blob: client.send_raw_or_raise(blob, 0),
            dedup=args.dedup)
    except Exception as e:  # noqa: BLE001 — one JSON line, honest exit
        print(json.dumps({"error": f"send failed: {e}"}))
        return 1
    finally:
        client.close()
    stats["mode"] = "dedup" if args.dedup else "replay"
    stats["target"] = args.target
    print(json.dumps(stats))
    return 0 if not stats["frames_undecodable"] else 1


if __name__ == "__main__":
    sys.exit(main())
