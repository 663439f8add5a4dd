"""SignalFx sink: datapoints + events, per-tag API-key fan-out.

Parity: reference sinks/signalfx/signalfx.go — counters and gauges become
SignalFx datapoints (counter → cumulative counter-style rate point), the
`vary_key_by` tag selects a per-key client so each customer's traffic uses
its own API key (:per-tag clients), metric/tag prefix drops, and events
via FlushOtherSamples.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
from typing import Optional

from veneur_tpu_torch.core.metrics import InterMetric, MetricType
from veneur_tpu_torch.protocol import dogstatsd as ddproto
from veneur_tpu_torch.sinks import MetricSink
from veneur_tpu_torch.sinks.delivery import make_manager
from veneur_tpu_torch.sinks.journal_codec import HttpEnvelope
from veneur_tpu_torch.ssf import SSFSample
from veneur_tpu_torch.utils.http import default_opener, json_body, post_bytes

log = logging.getLogger("veneur_tpu_torch.sinks.signalfx")


class SignalFxMetricSink(MetricSink):
    def __init__(
        self,
        api_key: str,
        hostname: str,
        hostname_tag: str = "host",
        endpoint_base: str = "https://ingest.signalfx.com",
        per_tag_api_keys: Optional[dict[str, str]] = None,
        vary_key_by: str = "",
        metric_name_prefix_drops: Optional[list[str]] = None,
        metric_tag_prefix_drops: Optional[list[str]] = None,
        flush_max_per_body: int = 0,
        dynamic_per_tag_keys: bool = False,
        dynamic_key_refresh_period_s: float = 300.0,
        api_endpoint: str = "https://api.signalfx.com",
        opener=default_opener,
        delivery=None,
    ) -> None:
        self.api_key = api_key
        self.hostname = hostname
        self.hostname_tag = hostname_tag or "host"
        self.endpoint_base = endpoint_base.rstrip("/")
        self.per_tag_api_keys = dict(per_tag_api_keys or {})
        # statically-configured entries survive dynamic refresh; entries
        # absent from a successful token fetch are otherwise dropped so a
        # revoked token stops being used (the reference rebuilds the
        # client map from each poll)
        self._static_keys = dict(per_tag_api_keys or {})
        self.vary_key_by = vary_key_by
        self.name_drops = metric_name_prefix_drops or []
        self.tag_drops = metric_tag_prefix_drops or []
        self.flush_max_per_body = flush_max_per_body or 5000
        self.dynamic_per_tag_keys = dynamic_per_tag_keys
        self.dynamic_key_refresh_period_s = dynamic_key_refresh_period_s
        self.api_endpoint = api_endpoint.rstrip("/")
        self.opener = opener
        self.delivery = make_manager("signalfx", delivery)
        self.flushed_metrics = 0
        self.flush_errors = 0
        self.key_refreshes = 0
        self._keys_lock = threading.Lock()
        self._refresh_stop = threading.Event()

    def name(self) -> str:
        return "signalfx"

    # -- dynamic per-tag API keys (reference clientByTagUpdater,
    # sinks/signalfx/signalfx.go:250-270: poll the token API on a period,
    # swapping in a client per named token) ------------------------------

    def fetch_api_keys(self) -> dict[str, str]:
        """Page through GET {api_endpoint}/v2/token (auth: default key)
        until an empty page; returns {token name: secret}
        (reference fetchAPIKeys, signalfx.go:321-342)."""
        out: dict[str, str] = {}
        offset = 0
        while True:
            url = (f"{self.api_endpoint}/v2/token"
                   f"?limit=200&name=&offset={offset}")
            req = urllib.request.Request(
                url, headers={"X-SF-TOKEN": self.api_key,
                              "Content-Type": "application/json"})
            body = json.loads(self.opener(req, 10.0))
            results = body.get("results")
            if not isinstance(results, list):
                raise ValueError("unknown results structure from "
                                 "signalfx api")
            for r in results:
                if isinstance(r, dict) and "name" in r and "secret" in r:
                    out[str(r["name"])] = str(r["secret"])
            if not results:
                return out
            # advance by what actually arrived: the API may clamp the
            # page size below the requested limit
            offset += len(results)

    def refresh_keys_once(self) -> None:
        try:
            keys = self.fetch_api_keys()
        except Exception as e:
            # failure keeps the last-good key set
            log.warning("signalfx token refresh failed: %s", e)
            return
        with self._keys_lock:
            # fetched tokens override static config (the reference
            # overwrites the client per fetched token); dynamic entries
            # absent from this poll drop, static ones remain as fallback
            self.per_tag_api_keys = {**self._static_keys, **keys}
        self.key_refreshes += 1

    def start(self, trace_client=None) -> None:
        if (not self.dynamic_per_tag_keys
                or self.dynamic_key_refresh_period_s <= 0):
            return

        def loop():
            # fetch immediately: per-tag routing should not wait a full
            # period after startup
            self.refresh_keys_once()
            while not self._refresh_stop.wait(
                    self.dynamic_key_refresh_period_s):
                self.refresh_keys_once()

        threading.Thread(target=loop, daemon=True,
                         name="signalfx-key-refresh").start()

    def stop(self) -> None:
        self._refresh_stop.set()

    def _convert(self, m: InterMetric,
                 keys: Optional[dict[str, str]] = None
                 ) -> Optional[tuple[str, dict]]:
        return self._convert_fields(m.name, m.value, m.tags, m.type,
                                    m.timestamp, m.hostname, keys)

    def _convert_fields(self, name, value, tags, mtype, ts, hostname,
                        keys) -> Optional[tuple[str, dict]]:
        if any(name.startswith(p) for p in self.name_drops):
            return None
        dims = {self.hostname_tag: hostname or self.hostname}
        vary_value = ""
        drop = False
        for tag in tags:
            if any(tag.startswith(p) for p in self.tag_drops):
                drop = True
                break
            k, _, v = tag.partition(":")
            dims[k] = v
            if self.vary_key_by and k == self.vary_key_by:
                vary_value = v
        if drop:
            return None
        if mtype == MetricType.COUNTER:
            kind = "counter"
        elif mtype == MetricType.GAUGE:
            kind = "gauge"
        else:
            return None
        point = {
            "metric": name,
            "value": value,
            "timestamp": ts * 1000,
            "dimensions": dims,
        }
        if keys is None:
            with self._keys_lock:
                keys = self.per_tag_api_keys
        api_key = keys.get(vary_value, self.api_key)
        return api_key, {kind: point}

    supports_columnar = True
    supports_native_emit = True

    def _convert_group(self, g, ts: int, excluded_tags, keys,
                       by_key: dict) -> None:
        """Per-row Python converter for one column group (the fallback
        when the native emit tier can't take it)."""
        for fam in g.families:
            vals = fam.values.tolist()
            suffix = fam.suffix
            for i in g.rows_for(fam).tolist():
                name, tags, sinks = g.meta_at(i)
                if g.has_routing and sinks is not None \
                        and self.name() not in sinks:
                    continue
                if excluded_tags:
                    tags = [t for t in tags
                            if t.split(":", 1)[0] not in excluded_tags]
                conv = self._convert_fields(
                    name + suffix if suffix else name, vals[i],
                    tags, fam.type, ts, "", keys)
                if conv is None:
                    continue
                api_key, kinds = conv
                bucket = by_key.setdefault(
                    api_key, {"counter": [], "gauge": []})
                for kind, point in kinds.items():
                    bucket[kind].append(point)

    def flush_columnar(self, batch, excluded_tags=None) -> None:
        """Columnar Python path (core/columnar.py): datapoints built
        straight from the batch columns. Only counter/gauge rows are
        convertible (as in _convert), and group rows never carry a
        hostname field, so the per-row feed loses nothing. The native
        serializer path is flush_columnar_native; the server negotiates
        between the two per flush."""
        with self._keys_lock:
            keys = dict(self.per_tag_api_keys)
        by_key: dict[str, dict[str, list]] = {}
        for g in batch.groups:
            self._convert_group(g, batch.timestamp, excluded_tags, keys,
                                by_key)
        self._post_buckets(by_key)

    def flush_columnar_native(self, batch, excluded_tags=None) -> bool:
        """Native emit path: one {"counter":[...],"gauge":[...]} body
        per group from vn_encode_signalfx_body, GIL released. Refuses
        the batch (returns False) when per-tag key routing
        (vary_key_by) is configured — key selection depends on tag
        values the native body emitter doesn't route on — or the native
        tier is unavailable; groups without a plan fall back to the
        Python converter."""
        from veneur_tpu_torch import native as native_mod

        if self.vary_key_by or not native_mod.emit_available():
            return False
        with self._keys_lock:
            keys = dict(self.per_tag_api_keys)
        by_key: dict[str, dict[str, list]] = {}
        raw_bodies: list[tuple[bytes, int]] = []
        excl = sorted(excluded_tags) if excluded_tags else []
        plans = batch.emit_plan()
        for g, plan in zip(batch.groups, plans):
            out = None
            if plan is not None:
                out = native_mod.encode_signalfx_body(
                    plan.meta_blob, plan.nrows, plan.suffixes,
                    plan.family_types, plan.values, plan.masks,
                    batch.timestamp * 1000, self.hostname_tag,
                    self.hostname, self.name_drops, self.tag_drops,
                    excl)
            if out is None:
                self._convert_group(g, batch.timestamp, excluded_tags,
                                    keys, by_key)
                continue
            body, n = out
            if n:
                raw_bodies.append((body, n))
        self._post_buckets(by_key, raw_bodies)
        return True

    def flush(self, metrics: list[InterMetric]) -> None:
        # group by API key (per-tag clients); snapshot the key map once —
        # the refresh thread may swap entries mid-flush
        with self._keys_lock:
            keys = dict(self.per_tag_api_keys)
        by_key: dict[str, dict[str, list]] = {}
        for m in metrics:
            conv = self._convert(m, keys)
            if conv is None:
                continue
            api_key, kinds = conv
            bucket = by_key.setdefault(api_key, {"counter": [], "gauge": []})
            for kind, point in kinds.items():
                bucket[kind].append(point)
        self._post_buckets(by_key)

    def _deliver(self, url: str, body: bytes, headers: dict,
                 count: int, what: str) -> None:
        def send(timeout: float) -> None:
            post_bytes(url, body, headers, timeout, self.opener)
            self.flushed_metrics += count

        # durable spill context: with a journal attached a spilled body
        # survives SIGKILL and is re-POSTed by the next incarnation
        env = HttpEnvelope(url=url, body=body, headers=headers, count=count)
        if self.delivery.deliver(send, len(body), payload=env) != "delivered":
            self.flush_errors += 1
            log.warning("signalfx %s post not delivered this flush", what)

    def _post_buckets(self, by_key: dict[str, dict[str, list]],
                      raw_bodies=None) -> None:
        self.delivery.begin_flush()
        self.delivery.retry_spill()
        threads = []
        for body, count in raw_bodies or ():
            t = threading.Thread(
                target=self._post_raw, args=(self.api_key, body, count),
                daemon=True)
            t.start()
            threads.append(t)
        for api_key, payload in by_key.items():
            body = {k: v for k, v in payload.items() if v}
            t = threading.Thread(
                target=self._post, args=(api_key, body), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=30)

    def _post(self, api_key: str, body: dict) -> None:
        count = sum(len(v) for v in body.values())
        raw, hdrs = json_body(body, headers={"X-SF-Token": api_key})
        self._deliver(f"{self.endpoint_base}/v2/datapoint", raw, hdrs,
                      count, "datapoint")

    def _post_raw(self, api_key: str, body: bytes, count: int) -> None:
        """POST one pre-built JSON body (the native emitter's output)."""
        self._deliver(
            f"{self.endpoint_base}/v2/datapoint", body,
            {"Content-Type": "application/json", "X-SF-Token": api_key},
            count, "datapoint")

    def flush_other_samples(self, samples: list[SSFSample]) -> None:
        events = []
        for s in samples:
            if ddproto.EVENT_IDENTIFIER_KEY not in s.tags:
                continue
            dims = {
                k: v for k, v in s.tags.items()
                if not k.startswith("vdogstatsd_")
            }
            events.append({
                "eventType": s.name,
                "category": "USER_DEFINED",
                "dimensions": dims,
                "properties": {"description": s.message},
                "timestamp": s.timestamp * 1000,
            })
        if not events:
            return
        body, hdrs = json_body(events, headers={"X-SF-Token": self.api_key})
        self._deliver(f"{self.endpoint_base}/v2/event", body, hdrs,
                      0, "event")
