"""Server assembly from config, PyTorch port.

The counterpart of veneur_tpu/core/factory.py: the same YAML loads
(core/config.py is a copy), the metric sinks are built as the JAX
package builds them, and every key that turns on a feature the port does
not have yet is refused by name, so no deployment silently runs without
something it asked for.

Metric sinks (the metric half of veneur_tpu/core/factory.py): Datadog
(``datadog_api_key`` with ``datadog_api_hostname``), SignalFx
(``signalfx_api_key``), the Prometheus repeater
(``prometheus_repeater_address``) and pushgateway
(``prometheus_pushgateway_address``), forward-statsd
(``forward_statsd_address``), New Relic (``newrelic_insert_key`` with
``newrelic_account_id``) and the debug sink. Every network sink but New
Relic gets its own DeliveryManager from one ``DeliveryPolicy`` (retry,
breaker, deadline clip, spill). ``opener`` is injected into every HTTP
sink for tests. With ``flush_emit_native`` (on by default) the native
library is loaded here, so a library that does not build fails the
start, not each flush. Span sinks, Kafka and the spill journal stay
refused.

The micro-fold (``micro_fold``, ``micro_fold_rows``,
``micro_fold_max_age_s``) and the device fault domain (``device_guard``,
``device_fault_streak``, ``device_probe_interval_s``, and the
``VENEUR_DEVICE_GUARD=0`` escape hatch) are ported and on by default, as
in the JAX package.

The native C++ ingest path is ported: ``tpu_native_ingest`` and
``tpu_native_readers`` (both on by default) load as they do in the JAX
package, with UDP listeners only. Reader shards are not: an explicit
``reader_shards`` above 0, or ``VENEUR_READER_SHARDS`` above 0, is
refused; the default -1, where the JAX package resolves it to
``num_readers``, runs the legacy routed path with one warning (the JAX
package pins the two paths bitwise equal).

Sets are ported: both set stores (``tpu_set_store: staged | dense``),
both set hashes (``set_hash: fnv | metro``), every ``tpu_hll_precision``
the config accepts (4 to 18) and ``count_unique_timeseries`` load as
they do in the JAX package.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from veneur_tpu_torch.core.config import (Config, parse_duration,
                                          resolve_reader_shards)
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
    # span sinks and Kafka (the metric network sinks are ported)
    "datadog_trace_api_address": _on,
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
RUNS_WITHOUT_KEYS = ()


def _refuse(key: str, value) -> None:
    raise UnportedConfigError(
        f"config key {key!r} is not supported by the PyTorch port yet "
        f"(value {value!r}); see ROADMAP.md")


def _check_reader_shards(cfg: Config) -> None:
    """Reader shards are not ported. An explicit request (the key or
    VENEUR_READER_SHARDS above 0) is refused by name; the default -1,
    which the JAX package resolves to num_readers when native ingest and
    readers are on with one worker, runs the legacy routed path."""
    env = os.environ.get("VENEUR_READER_SHARDS")
    try:
        env_value = int(env) if env is not None else None
    except ValueError:
        env_value = None
    if env_value is not None and env_value > 0:
        _refuse("reader_shards", f"VENEUR_READER_SHARDS={env}")
    if cfg.reader_shards > 0:
        _refuse("reader_shards", cfg.reader_shards)
    resolved = resolve_reader_shards(cfg)
    if resolved > 0:
        log.warning(
            "reader_shards: -1 resolves to %d reader shards in the JAX "
            "package; the PyTorch port runs the legacy routed path "
            "instead (bitwise equal, tests/test_reader_shards.py)",
            resolved)


def check_config(cfg: Config) -> None:
    """Raise UnportedConfigError naming the first key that asks for a
    feature outside this slice; warn once about the result-neutral
    default-on keys the port runs without."""
    for key, enabled in REFUSED_KEYS.items():
        if enabled(getattr(cfg, key)):
            _refuse(key, getattr(cfg, key))
    if cfg.newrelic_insert_key and cfg.newrelic_trace_observer_url:
        # the New Relic span sink needs the SSF span path
        _refuse("newrelic_trace_observer_url",
                cfg.newrelic_trace_observer_url)
    for spec in cfg.statsd_listen_addresses:
        if not spec.startswith("udp://"):
            raise UnportedConfigError(
                f"config key 'statsd_listen_addresses': {spec!r} — only "
                f"udp:// listeners are supported by the PyTorch port yet")
    _check_reader_shards(cfg)
    on = [k for k in RUNS_WITHOUT_KEYS if getattr(cfg, k)]
    if on:
        log.warning("the PyTorch port runs without %s (result-neutral; "
                    "not ported yet)", ", ".join(on))


def build_server(cfg: Config, extra_metric_sinks=None,
                 device: Optional[str] = None, opener=None) -> Server:
    """Construct a Server from configuration on ``device`` (the card
    unless the caller asks for another). ``opener`` (optional) is
    injected into every HTTP-based sink for tests."""
    check_config(cfg)
    from veneur_tpu_torch.sinks.delivery import DeliveryPolicy

    metric_sinks = list(extra_metric_sinks or [])
    interval = cfg.interval_seconds()
    # one shared delivery policy: every network sink gets its own
    # DeliveryManager built from it (sinks/delivery.py)
    policy = DeliveryPolicy.from_config(cfg, interval)
    kw = {"opener": opener} if opener else {}
    dkw = {**kw, "delivery": policy}

    hostname = cfg.hostname
    if not hostname and not cfg.omit_empty_hostname:
        import socket as _socket

        hostname = _socket.gethostname()

    if cfg.datadog_api_key and cfg.datadog_api_hostname:
        from veneur_tpu_torch.sinks.datadog import DatadogMetricSink

        metric_sinks.append(DatadogMetricSink(
            interval=interval,
            flush_max_per_body=cfg.datadog_flush_max_per_body,
            hostname=hostname,
            tags=list(cfg.tags),
            dd_hostname=cfg.datadog_api_hostname,
            api_key=cfg.datadog_api_key,
            metric_name_prefix_drops=cfg.datadog_metric_name_prefix_drops,
            exclude_tags_prefix_by_prefix_metric={
                e.metric_prefix: e.tags
                for e in cfg.datadog_exclude_tags_prefix_by_prefix_metric
            },
            **dkw,
        ))

    if cfg.signalfx_api_key:
        from veneur_tpu_torch.sinks.signalfx import SignalFxMetricSink

        metric_sinks.append(SignalFxMetricSink(
            api_key=cfg.signalfx_api_key,
            hostname=hostname,
            hostname_tag=cfg.signalfx_hostname_tag,
            endpoint_base=(cfg.signalfx_endpoint_base
                           or "https://ingest.signalfx.com"),
            per_tag_api_keys={
                k.name: k.api_key for k in cfg.signalfx_per_tag_api_keys
            },
            vary_key_by=cfg.signalfx_vary_key_by,
            metric_name_prefix_drops=cfg.signalfx_metric_name_prefix_drops,
            metric_tag_prefix_drops=cfg.signalfx_metric_tag_prefix_drops,
            flush_max_per_body=cfg.signalfx_flush_max_per_body,
            dynamic_per_tag_keys=(
                cfg.signalfx_dynamic_per_tag_api_keys_enable),
            dynamic_key_refresh_period_s=(
                parse_duration(
                    cfg.signalfx_dynamic_per_tag_api_keys_refresh_period)
                if cfg.signalfx_dynamic_per_tag_api_keys_refresh_period
                else 300.0),
            api_endpoint=(cfg.signalfx_endpoint_api
                          or "https://api.signalfx.com"),
            **dkw,
        ))

    if cfg.prometheus_repeater_address:
        from veneur_tpu_torch.sinks.prometheus import PrometheusMetricSink

        metric_sinks.append(PrometheusMetricSink(
            cfg.prometheus_repeater_address, cfg.prometheus_network_type,
            flush_timeout_s=cfg.flush_timeout_s, delivery=policy))

    if cfg.prometheus_pushgateway_address:
        from veneur_tpu_torch.sinks.prometheus import (
            PrometheusExpositionSink)

        metric_sinks.append(PrometheusExpositionSink(
            cfg.prometheus_pushgateway_address, **dkw))

    if cfg.forward_statsd_address:
        from veneur_tpu_torch.sinks.forward_statsd import ForwardStatsdSink

        metric_sinks.append(ForwardStatsdSink(
            cfg.forward_statsd_address, cfg.forward_statsd_network,
            flush_timeout_s=cfg.flush_timeout_s, delivery=policy))

    if cfg.newrelic_insert_key and cfg.newrelic_account_id:
        from veneur_tpu_torch.sinks.newrelic import NewRelicMetricSink

        metric_sinks.append(NewRelicMetricSink(
            account_id=cfg.newrelic_account_id,
            insert_key=cfg.newrelic_insert_key,
            event_type=cfg.newrelic_event_type,
            service_check_event_type=cfg.newrelic_service_check_event_type,
            common_tags=cfg.newrelic_common_tags,
            region=cfg.newrelic_region,
            **kw,
        ))

    if cfg.debug_flushed_metrics:
        from veneur_tpu_torch.sinks.debug import DebugMetricSink

        metric_sinks.append(DebugMetricSink())
    if cfg.flush_emit_native and any(
            getattr(s, "supports_native_emit", False) for s in metric_sinks):
        from veneur_tpu_torch import native

        native.load_library()
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
