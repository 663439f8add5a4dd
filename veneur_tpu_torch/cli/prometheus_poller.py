"""veneur-tpu-prometheus: poll a Prometheus /metrics endpoint and repeat
it as statsd.

Parity: reference cmd/veneur-prometheus — scrapes on an interval
(mTLS-capable), parses the Prometheus text exposition format, translates
counters/gauges/histograms/summaries to statsd, and dedupes monotonic
counters through a count cache so only deltas are emitted
(cmd/veneur-prometheus/main.go:27-100, translate.go, prometheus.go).
"""

from __future__ import annotations

import argparse
import logging
import re
import socket
import ssl
import sys
import time
import urllib.parse
import urllib.request
from typing import Optional

log = logging.getLogger("veneur_tpu_torch.prometheus-poller")

_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>[^ ]+)(?:\s+\d+)?$")
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(body: str) -> tuple[dict[str, str], list[tuple]]:
    """Parse the exposition format → (type-by-name, [(name, labels, value)]).
    """
    types: dict[str, str] = {}
    samples: list[tuple] = []
    for line in body.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) >= 4:
                types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _LINE.match(line)
        if not m:
            continue
        labels = {}
        if m.group("labels"):
            for lm in _LABEL.finditer(m.group("labels")):
                labels[lm.group(1)] = lm.group(2).replace('\\"', '"')
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        samples.append((m.group("name"), labels, value))
    return types, samples


class CountCache:
    """Monotonic-counter dedupe: remembers the last seen value per series
    and emits only positive deltas; resets (counter restarts) emit the new
    value whole (reference countCache)."""

    def __init__(self) -> None:
        self._last: dict[tuple, float] = {}

    def delta(self, key: tuple, value: float) -> Optional[float]:
        last = self._last.get(key)
        self._last[key] = value
        if last is None:
            return None  # first scrape: establish the baseline only
        if value < last:
            return value  # counter reset
        return value - last


def translate(types: dict[str, str], samples: list[tuple],
              cache: CountCache, added_tags: list[str],
              ignored: Optional[list] = None,
              ignored_labels: Optional[list] = None,
              prefix: str = "") -> list[bytes]:
    """Prometheus samples → statsd lines (reference translate.go).

    ignored / ignored_labels: lists of compiled regexes — metric names
    matching any `ignored` entry are skipped, labels whose NAME matches
    any `ignored_labels` entry are dropped from the tag set (reference
    -ignored-metrics / -ignored-labels). prefix is prepended verbatim
    (reference -p, e.g. "myservice.")."""
    lines = []
    for name, labels, value in samples:
        if ignored and any(rx.search(name) for rx in ignored):
            continue
        base = name
        mtype = types.get(name)
        if mtype is None:
            # histogram/summary series carry suffixed names
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix):
                    base = name[: -len(suffix)]
                    mtype = types.get(base)
                    break
        kept_labels = {
            k: v for k, v in labels.items()
            if not (ignored_labels
                    and any(rx.search(k) for rx in ignored_labels))
        }
        tags = [f"{k}:{v}" for k, v in sorted(kept_labels.items())]
        tags += added_tags
        tag_part = ("|#" + ",".join(tags)) if tags else ""
        key = (name, tuple(sorted(labels.items())))
        out_name = prefix + name

        if mtype == "counter":
            d = cache.delta(key, value)
            if d is not None and d != 0:
                lines.append(f"{out_name}:{d}|c{tag_part}".encode())
        elif mtype == "gauge" or mtype is None:
            lines.append(f"{out_name}:{value}|g{tag_part}".encode())
        elif mtype in ("histogram", "summary"):
            if name.endswith(("_bucket", "_count", "_sum")):
                d = cache.delta(key, value)
                if d is not None and d != 0:
                    lines.append(f"{out_name}:{d}|c{tag_part}".encode())
            else:
                # summary quantile series: instantaneous gauge
                lines.append(f"{out_name}:{value}|g{tag_part}".encode())
    return lines


def scrape(url: str, cert: str = "", key: str = "", cacert: str = "",
           timeout: float = 10.0, unix_socket: str = "") -> str:
    if unix_socket:
        # scrape over a unix socket (reference -socket: proxy-style
        # transports); plain HTTP semantics over an AF_UNIX stream
        import http.client

        class _UDSConn(http.client.HTTPConnection):
            def connect(self):
                self.sock = socket.socket(socket.AF_UNIX,
                                          socket.SOCK_STREAM)
                self.sock.settimeout(timeout)
                self.sock.connect(unix_socket)

        parts = urllib.parse.urlsplit(url)
        path = parts.path or "/metrics"
        if parts.query:
            path += "?" + parts.query
        conn = _UDSConn("localhost", timeout=timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            if resp.status != 200:
                raise RuntimeError(f"scrape returned {resp.status}")
            return resp.read().decode("utf-8")
        finally:
            conn.close()
    ctx = None
    if url.startswith("https"):
        ctx = ssl.create_default_context(cafile=cacert or None)
        if cert and key:
            ctx.load_cert_chain(cert, key)
    with urllib.request.urlopen(url, timeout=timeout, context=ctx) as resp:
        return resp.read().decode("utf-8")


def send_statsd(address: str, lines: list[bytes],
                max_datagram: int = 1400) -> None:
    host, _, port = address.rpartition(":")
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    batch = b""
    for line in lines:
        if batch and len(batch) + 1 + len(line) > max_datagram:
            sock.sendto(batch, (host or "127.0.0.1", int(port)))
            batch = b""
        batch = batch + b"\n" + line if batch else line
    if batch:
        sock.sendto(batch, (host or "127.0.0.1", int(port)))
    sock.close()


def main(argv=None) -> int:
    # -h is the metrics URL (matching the reference's flag surface,
    # cmd/veneur-prometheus/main.go:12-24), so argparse's automatic -h
    # help is disabled; --help still works
    parser = argparse.ArgumentParser(prog="veneur-tpu-prometheus",
                                     add_help=False)
    parser.add_argument("--help", "-help", action="help",
                        help="show this help message and exit")
    parser.add_argument("-h", "--host", dest="prometheus_host",
                        default="http://localhost:9090/metrics",
                        help="prometheus metrics endpoint URL")
    parser.add_argument("-s", dest="statsd_host",
                        default="127.0.0.1:8126",
                        help="statsd destination host:port")
    parser.add_argument("-i", dest="interval", default="10s")
    parser.add_argument("-p", dest="prefix", default="",
                        help="prefix prepended to every metric name "
                             "(include the trailing period)")
    parser.add_argument("-d", dest="debug", action="store_true")
    parser.add_argument("-t", dest="tags", action="append", default=[],
                        help="tag to add to every metric")
    parser.add_argument("-ignored-metrics", default="",
                        help="comma-separated metric-name regexes to skip")
    parser.add_argument("-ignored-labels", default="",
                        help="comma-separated label-name regexes to drop")
    parser.add_argument("-cert", default="")
    parser.add_argument("-key", default="")
    parser.add_argument("-cacert", default="")
    parser.add_argument("-socket", default="",
                        help="unix socket path for the scrape transport")
    parser.add_argument("-once", action="store_true",
                        help="scrape once and exit (for testing)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO)
    from veneur_tpu_torch.core.config import parse_duration

    interval = parse_duration(args.interval)

    def _regexes(spec: str):
        # comma-separated regex list (the reference splits the same way,
        # so comma-containing regexes are inexpressible there too)
        try:
            return [re.compile(s) for s in spec.split(",") if s] or None
        except re.error as e:
            parser.error(f"bad regex in {spec!r}: {e}")

    ignored = _regexes(args.ignored_metrics)
    ignored_labels = _regexes(args.ignored_labels)
    cache = CountCache()

    while True:
        try:
            body = scrape(args.prometheus_host, args.cert, args.key,
                          args.cacert, unix_socket=args.socket)
            types, samples = parse_prometheus_text(body)
            lines = translate(types, samples, cache, args.tags, ignored,
                              ignored_labels=ignored_labels,
                              prefix=args.prefix)
            if lines:
                send_statsd(args.statsd_host, lines)
            log.info("scraped %d samples → %d statsd lines",
                     len(samples), len(lines))
        except Exception as e:
            log.warning("scrape failed: %s", e)
            if args.once:
                return 1
        if args.once:
            return 0
        time.sleep(interval)


if __name__ == "__main__":
    sys.exit(main())
