"""veneur-tpu-emit: CLI metric/event/service-check/span emitter.

Parity: reference cmd/veneur-emit/main.go (763 LoC) — emit one-off
metrics via statsd or SSF, events and service checks, and `-command` mode
which times a subprocess and emits a timer (statsd) or a span (SSF) with
its exit status.
"""

from __future__ import annotations

import argparse
import random
import shlex
import socket
import subprocess
import sys
import time

from veneur_tpu_torch import ssf
from veneur_tpu_torch.protocol import ssf_wire


def _parse_hostport(hostport: str) -> tuple[str, str]:
    """Returns (scheme, address)."""
    if "://" in hostport:
        scheme, _, rest = hostport.partition("://")
        return scheme, rest
    return "udp", hostport


def _send_statsd(address: str, lines: list[bytes]) -> None:
    host, _, port = address.rpartition(":")
    payload = b"\n".join(lines)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.sendto(payload, (host or "127.0.0.1", int(port)))
    sock.close()


def _send_ssf(scheme: str, address: str, span: ssf.SSFSpan) -> None:
    if scheme in ("udp", "ssf"):
        host, _, port = address.rpartition(":")
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.sendto(ssf_wire.encode_datagram(span),
                    (host or "127.0.0.1", int(port)))
        sock.close()
    elif scheme == "unix":
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(address)
        f = sock.makefile("wb")
        ssf_wire.write_ssf(f, span)
        f.flush()
        sock.close()
    else:
        raise ValueError(f"unsupported ssf scheme {scheme}")


def _tag_arg_to_dict(tag_args: list[str]) -> dict[str, str]:
    tags = {}
    for entry in tag_args:
        for t in entry.split(","):
            if not t:
                continue
            k, _, v = t.partition(":")
            tags[k] = v
    return tags


def _parse_time_ns(spec: str) -> int:
    """Accepts unix seconds (int/float) or an ISO-8601 datetime
    (reference -span_starttime/-span_endtime take free-form dates).
    Raises SystemExit(2) with a usage message on unparseable input."""
    try:
        secs = float(spec)
        if secs != secs or secs in (float("inf"), float("-inf")):
            raise ValueError(spec)
        return int(secs * 1e9)
    except ValueError:
        pass
    import datetime

    try:
        dt = datetime.datetime.fromisoformat(spec)
    except ValueError:
        print(f"invalid time {spec!r}: pass unix seconds or an ISO-8601 "
              "datetime", file=sys.stderr)
        raise SystemExit(2) from None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return int(dt.timestamp() * 1e9)


def build_statsd_lines(args, timing_ms=None) -> list[bytes]:
    tags = ""
    tag_map = _tag_arg_to_dict(args.tag)
    if tag_map:
        joined = ",".join(f"{k}:{v}" if v else k for k, v in tag_map.items())
        tags = f"|#{joined}"
    lines = []
    if args.count is not None:
        lines.append(f"{args.name}:{args.count}|c{tags}".encode())
    if args.gauge is not None:
        lines.append(f"{args.name}:{args.gauge}|g{tags}".encode())
    if args.timing is not None:
        lines.append(f"{args.name}:{args.timing}|ms{tags}".encode())
    if timing_ms is not None:
        lines.append(f"{args.name}:{timing_ms}|ms{tags}".encode())
    if args.set is not None:
        lines.append(f"{args.name}:{args.set}|s{tags}".encode())
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="veneur-tpu-emit")
    parser.add_argument("-hostport", default="udp://127.0.0.1:8125",
                        help="destination, e.g. udp://127.0.0.1:8125")
    parser.add_argument("-name", default="", help="metric name")
    parser.add_argument("-count", type=int, default=None)
    parser.add_argument("-gauge", type=float, default=None)
    parser.add_argument("-timing", type=float, default=None,
                        help="timing value in ms")
    parser.add_argument("-set", default=None)
    parser.add_argument("-tag", action="append", default=[],
                        help="tag(s), k:v comma separated; repeatable")
    parser.add_argument("-ssf", action="store_true",
                        help="emit over SSF instead of statsd")
    parser.add_argument("-mode", default="metric",
                        choices=["metric", "event", "sc"])
    parser.add_argument("-debug", action="store_true",
                        help="print what gets emitted")
    # event fields
    parser.add_argument("-e_title", default="")
    parser.add_argument("-e_text", default="")
    parser.add_argument("-e_time", type=int, default=None)
    parser.add_argument("-e_hostname", default="")
    parser.add_argument("-e_aggr_key", default="")
    parser.add_argument("-e_priority", default="")
    parser.add_argument("-e_source_type", default="")
    parser.add_argument("-e_alert_type", default="")
    parser.add_argument("-e_event_tags", default="",
                        help="event-only tags, comma separated")
    # service-check fields
    parser.add_argument("-sc_name", default="")
    parser.add_argument("-sc_status", type=int, default=None)
    parser.add_argument("-sc_time", type=int, default=None)
    parser.add_argument("-sc_hostname", default="")
    parser.add_argument("-sc_msg", default="")
    parser.add_argument("-sc_tags", default="",
                        help="service-check-only tags, comma separated")
    # span fields (SSF mode)
    parser.add_argument("-trace_id", type=int, default=None)
    parser.add_argument("-parent_span_id", type=int, default=None)
    parser.add_argument("-span_service", default="veneur-emit")
    parser.add_argument("-span_starttime", default="",
                        help="span start (unix seconds or RFC3339)")
    parser.add_argument("-span_endtime", default="",
                        help="span end; same formats as -span_starttime")
    parser.add_argument("-span_tags", default="",
                        help="span-only tags, comma separated")
    parser.add_argument("-indicator", action="store_true")
    parser.add_argument("-error", action="store_true")
    parser.add_argument("-command", nargs=argparse.REMAINDER, default=None,
                        help="run a command, time it, and emit the timing")
    args = parser.parse_args(argv)

    scheme, address = _parse_hostport(args.hostport)
    exit_code = 0
    timing_ms = None
    cmd_error = False
    start_ns = time.time_ns()

    if args.command:
        cmd = args.command
        if len(cmd) == 1:
            cmd = shlex.split(cmd[0])
        t0 = time.time_ns()
        proc = subprocess.run(cmd)
        timing_ms = (time.time_ns() - t0) / 1e6
        exit_code = proc.returncode
        cmd_error = exit_code != 0

    def _emit_statsd(lines: list[bytes]) -> None:
        if args.debug:
            for ln in lines:
                print(f"emitting: {ln.decode(errors='replace')}",
                      file=sys.stderr)
        _send_statsd(address, lines)

    if args.mode == "event":
        title, text = args.e_title, args.e_text
        packet = f"_e{{{len(title)},{len(text)}}}:{title}|{text}"
        for flag, prefix in [
            (args.e_time, "d:"), (args.e_hostname, "h:"),
            (args.e_aggr_key, "k:"), (args.e_priority, "p:"),
            (args.e_source_type, "s:"), (args.e_alert_type, "t:"),
        ]:
            if flag:
                packet += f"|{prefix}{flag}"
        # global -tag applies everywhere; -e_event_tags only to the event
        tag_map = _tag_arg_to_dict(args.tag + [args.e_event_tags])
        if tag_map:
            packet += "|#" + ",".join(
                f"{k}:{v}" if v else k for k, v in tag_map.items())
        _emit_statsd([packet.encode()])
        return exit_code

    if args.mode == "sc":
        packet = f"_sc|{args.sc_name}|{args.sc_status}"
        if args.sc_time:
            packet += f"|d:{args.sc_time}"
        if args.sc_hostname:
            packet += f"|h:{args.sc_hostname}"
        tag_map = _tag_arg_to_dict(args.tag + [args.sc_tags])
        if tag_map:
            packet += "|#" + ",".join(
                f"{k}:{v}" if v else k for k, v in tag_map.items())
        if args.sc_msg:
            packet += f"|m:{args.sc_msg}"
        _emit_statsd([packet.encode()])
        return exit_code

    if args.ssf:
        span_id = random.getrandbits(62) + 1
        trace_id = args.trace_id or span_id
        span = ssf.SSFSpan(
            trace_id=trace_id, id=span_id,
            parent_id=args.parent_span_id or 0,
            start_timestamp=(_parse_time_ns(args.span_starttime)
                             if args.span_starttime else start_ns),
            end_timestamp=(_parse_time_ns(args.span_endtime)
                           if args.span_endtime else time.time_ns()),
            error=args.error or cmd_error,
            service=args.span_service, name=args.name or "veneur-emit",
            indicator=args.indicator,
            tags=_tag_arg_to_dict(args.tag + [args.span_tags]),
        )
        if args.debug:
            print(f"emitting span: trace_id={span.trace_id} "
                  f"id={span.id} service={span.service} "
                  f"tags={span.tags}", file=sys.stderr)
        tag_map = _tag_arg_to_dict(args.tag)
        if args.count is not None:
            span.metrics.append(ssf.count(args.name, args.count, tag_map))
        if args.gauge is not None:
            span.metrics.append(ssf.gauge(args.name, args.gauge, tag_map))
        if args.timing is not None:
            span.metrics.append(ssf.timing_ns(
                args.name, int(args.timing * 1e6), tag_map))
        if timing_ms is not None:
            span.metrics.append(ssf.timing_ns(
                args.name or "veneur-emit.command",
                int(timing_ms * 1e6), tag_map))
        if args.set is not None:
            span.metrics.append(ssf.set_sample(args.name, args.set, tag_map))
        _send_ssf(scheme, address, span)
        return exit_code

    lines = build_statsd_lines(args, timing_ms)
    if not lines:
        print("nothing to emit: pass -count/-gauge/-timing/-set or -command",
              file=sys.stderr)
        return exit_code or 1
    _emit_statsd(lines)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
