"""Server assembly from config, PyTorch port.

The counterpart of veneur_tpu/core/factory.py for this slice: the same
YAML loads (core/config.py is a copy), and every key that turns on a
feature the port does not have yet is refused by name, so no deployment
silently runs without something it asked for. One key is on by default
and does not change results (the JAX package's own parity tests show
it), ``flush_emit_native``; the port logs one warning that it runs
without it.

The micro-fold (``micro_fold``, ``micro_fold_rows``,
``micro_fold_max_age_s``) and the device fault domain (``device_guard``,
``device_fault_streak``, ``device_probe_interval_s``, and the
``VENEUR_DEVICE_GUARD=0`` escape hatch) are ported and on by default, as
in the JAX package.

The native C++ ingest path is ported: ``tpu_native_ingest`` and
``tpu_native_readers`` (both on by default) load as they do in the JAX
package, with UDP listeners only; ``reader_shards`` stays refused.

Sets are ported: both set stores (``tpu_set_store: staged | dense``),
both set hashes (``set_hash: fnv | metro``), every ``tpu_hll_precision``
the config accepts (4 to 18) and ``count_unique_timeseries`` load as
they do in the JAX package.
"""

from __future__ import annotations

import logging
from typing import Optional

from veneur_tpu_torch.core.config import Config
from veneur_tpu_torch.core.server import Server

log = logging.getLogger("veneur_tpu_torch.factory")


class UnportedConfigError(ValueError):
    """A config key asks for a feature outside the port's slice."""


def _on(v) -> bool:
    return bool(v)


# key → predicate: the config turns an unported feature on
REFUSED_KEYS = {
    # device-side schedulers and layouts
    "series_shards": lambda v: v not in (0, 1),
    "reader_shards": lambda v: v > 0,
    "tpu_mesh_devices": lambda v: v > 1,
    "flush_pipeline": _on,
    "flush_chunk_target_ms": lambda v: v > 0,
    # tenancy budgets
    "tenant_default_budget": lambda v: v > 0,
    "tenant_budgets": _on,
    # query listeners
    "query_listen_addrs": _on,
    # forward / proxy / import
    "forward_address": _on,
    "forward_discovery_file": _on,
    "grpc_address": _on,
    "http_address": _on,
    "spill_journal_dir": _on,
    # SSF / TCP / TLS / unixgram listeners
    "ssf_listen_addresses": _on,
    "tls_key": _on,
    "tls_certificate": _on,
    "tls_authority_certificate": _on,
    # archive and plugins
    "archive_dir": _on,
    "archive_blob_bucket": _on,
    "flush_file": _on,
    "aws_s3_bucket": _on,
    # network sinks (only channel, debug and blackhole are ported)
    "datadog_api_key": _on,
    "datadog_trace_api_address": _on,
    "signalfx_api_key": _on,
    "prometheus_repeater_address": _on,
    "prometheus_pushgateway_address": _on,
    "forward_statsd_address": _on,
    "newrelic_insert_key": _on,
    "kafka_broker": _on,
    "splunk_hec_address": _on,
    "xray_address": _on,
    "lightstep_access_token": _on,
    "trace_lightstep_access_token": _on,
    "falconer_address": _on,
    "span_log_dir": _on,
    "debug_ingested_spans": _on,
    # operations
    "stats_address": _on,
    "flush_watchdog_missed_flushes": lambda v: v > 0,
    "config_reload_s": lambda v: v > 0,
    "enable_profiling": _on,
}

# on by default, result-neutral: the port runs without them
RUNS_WITHOUT_KEYS = ("flush_emit_native",)


def check_config(cfg: Config) -> None:
    """Raise UnportedConfigError naming the first key that asks for a
    feature outside this slice; warn once about the result-neutral
    default-on keys the port runs without."""
    for key, enabled in REFUSED_KEYS.items():
        if enabled(getattr(cfg, key)):
            raise UnportedConfigError(
                f"config key {key!r} is not supported by the PyTorch port "
                f"yet (value {getattr(cfg, key)!r}); see ROADMAP.md")
    for spec in cfg.statsd_listen_addresses:
        if not spec.startswith("udp://"):
            raise UnportedConfigError(
                f"config key 'statsd_listen_addresses': {spec!r} — only "
                f"udp:// listeners are supported by the PyTorch port yet")
    on = [k for k in RUNS_WITHOUT_KEYS if getattr(cfg, k)]
    if on:
        log.warning("the PyTorch port runs without %s (result-neutral; "
                    "not ported yet)", ", ".join(on))


def build_server(cfg: Config, extra_metric_sinks=None,
                 device: Optional[str] = None) -> Server:
    """Construct a Server from configuration on ``device`` (the card
    unless the caller asks for another)."""
    check_config(cfg)
    metric_sinks = list(extra_metric_sinks or [])
    if cfg.debug_flushed_metrics:
        from veneur_tpu_torch.sinks.debug import DebugMetricSink

        metric_sinks.append(DebugMetricSink())
    server = Server(cfg, metric_sinks=metric_sinks, device=device)
    # per-sink excluded tags (reference setSinkExcludedTags,
    # server.go:1522-1548): a plain entry excludes the tag everywhere;
    # "tag|sink" limits it to one sink
    for entry in cfg.tags_exclude:
        if "|" in entry:
            tag, _, sink_name = entry.partition("|")
            server.sink_excluded_tags.setdefault(sink_name, set()).add(tag)
        else:
            for sink in metric_sinks:
                server.sink_excluded_tags.setdefault(
                    sink.name(), set()).add(entry)
    return server
