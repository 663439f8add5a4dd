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
``newrelic_account_id``), Kafka (``kafka_broker`` with
``kafka_metric_topic`` or ``kafka_check_topic``), the flush archive
(``archive_dir``: a ``MetricArchiveSink`` over a
``SegmentedArchiveWriter``) and the debug sink. Every network sink but
New Relic and Kafka gets its own DeliveryManager from one
``DeliveryPolicy`` (retry, breaker, deadline clip, spill). ``opener`` is
injected into every HTTP sink and plugin for tests. With
``flush_emit_native`` (on by default) the native library is loaded
here, so a library that does not build fails the start, not each flush.
``spill_journal_dir`` backs every network sink's delivery spill with a
write-ahead journal (utils/journal.py; the server attaches and replays
it at ``start()``).

Plugins, run after the sinks on each flush: the local flush file
(``flush_file``), the S3 TSV upload (``aws_s3_bucket`` with
``aws_access_key_id``) and the archive's blob upload
(``archive_blob_bucket`` with ``archive_blob_access_key``).

Spans: ``ssf_listen_addresses`` (udp://, unix://, unixgram://) start the
SSF listeners, and statsd listeners take tcp:// (TLS with ``tls_key``
and ``tls_certificate``, mutual TLS with ``tls_authority_certificate``)
and unixgram:// besides udp://. The span sinks built: Datadog trace
(``datadog_trace_api_address``), New Relic spans
(``newrelic_trace_observer_url`` with ``newrelic_insert_key``), Kafka
(``kafka_span_topic``; ``kafka_span_serialization_format: columnar``
builds a ``SpanBatchSink`` over a ``KafkaBatchWriter``), Splunk HEC
(``splunk_hec_address`` with ``splunk_hec_token``), X-Ray
(``xray_address``), LightStep (``lightstep_access_token`` or
``trace_lightstep_access_token``), falconer (``falconer_address``),
debug (``debug_ingested_spans``) and the span log (``span_log_dir``: a
``SpanBatchSink`` over a ``SegmentedLogWriter``), plus
``extra_span_sinks``.

The micro-fold (``micro_fold``, ``micro_fold_rows``,
``micro_fold_max_age_s``) and the device fault domain (``device_guard``,
``device_fault_streak``, ``device_probe_interval_s``, and the
``VENEUR_DEVICE_GUARD=0`` escape hatch) are ported and on by default, as
in the JAX package.

The native C++ ingest path is ported: ``tpu_native_ingest`` and
``tpu_native_readers`` (both on by default) load as they do in the JAX
package, and so are reader shards:
``reader_shards``, ``VENEUR_READER_SHARDS`` and the default -1 resolve
as in the JAX package (core/config.resolve_reader_shards; the server
attaches the shards).

The global tier: a single ``forward_address`` installs the forwarder
(gRPC with ``forward_use_grpc``, streaming with ``forward_streaming``,
or HTTP ``/import``; ``forward_format: forwardrpc`` or ``jsonmetric``
speaks to a stock Go veneur global); a ``forward_address`` naming more
than one proxy, or ``forward_discovery_file``, installs the sharded
proxy tier's ``SpreadForwarder`` (distributed/spread.py); ``grpc_address``
and ``http_address`` start the import servers. The proxy itself runs as
``python -m veneur_tpu_torch.cli.proxy_main -f proxy.yaml``.

Per-tenant QoS and the live query path are ported: the server builds
the tenant ledger and sketches from ``tenant_default_budget`` and
``tenant_budgets`` (with ``tenant_tag_key``, ``tenant_sketch_depth``,
``tenant_sketch_width``, ``tenant_topk``), and the query engine from
``query_listen_addrs``, whose fronts bind at ``start()``, as the JAX
server does.

Flush governance and the process lifecycle are ported:
``flush_chunk_target_ms`` (chunked extraction), ``flush_pipeline`` with
``flush_pipeline_backlog``, ``stats_address`` (self-telemetry over UDP,
with ``veneur_metrics_additional_tags`` and ``veneur_metrics_scopes``),
``flush_watchdog_missed_flushes`` (cli/veneur_main.py starts the
watchdog), ``config_reload_s`` (core/reload.py, run by the CLI),
``enable_profiling`` with ``profile_dir``, ``synchronize_with_interval``
and ``sentry_dsn``; ``inherited_fds`` hands a re-exec'd process its
listeners.

Sets are ported: both set stores (``tpu_set_store: staged | dense``),
both set hashes (``set_hash: fnv | metro``), every ``tpu_hll_precision``
the config accepts (4 to 18) and ``count_unique_timeseries`` load as
they do in the JAX package.
"""

from __future__ import annotations

import logging
from typing import Optional

from veneur_tpu_torch.core.config import Config, parse_duration
from veneur_tpu_torch.core.server import Server

log = logging.getLogger("veneur_tpu_torch.factory")


class UnportedConfigError(ValueError):
    """A config key asks for a feature outside the port's slice."""


# key → predicate: the config turns an unported feature on (the
# multi-device schedulers and layouts)
REFUSED_KEYS = {
    "series_shards": lambda v: v not in (0, 1),
    "tpu_mesh_devices": lambda v: v > 1,
}

# on by default, result-neutral: the port runs without them
RUNS_WITHOUT_KEYS = ()


def _refuse(key: str, value) -> None:
    raise UnportedConfigError(
        f"config key {key!r} is not supported by the PyTorch port yet "
        f"(value {value!r}); see ROADMAP.md")


def check_config(cfg: Config) -> None:
    """Raise UnportedConfigError naming the first key that asks for a
    feature outside this slice; warn once about the result-neutral
    default-on keys the port runs without."""
    for key, enabled in REFUSED_KEYS.items():
        if enabled(getattr(cfg, key)):
            _refuse(key, getattr(cfg, key))
    on = [k for k in RUNS_WITHOUT_KEYS if getattr(cfg, k)]
    if on:
        log.warning("the PyTorch port runs without %s (result-neutral; "
                    "not ported yet)", ", ".join(on))


def build_server(cfg: Config, extra_metric_sinks=None,
                 device: Optional[str] = None, opener=None,
                 extra_span_sinks=None, inherited_fds=None) -> Server:
    """Construct a Server from configuration on ``device`` (the card
    unless the caller asks for another). ``opener`` (optional) is
    injected into every HTTP-based sink for tests. ``inherited_fds``
    carries listener fds across a zero-downtime re-exec (spec -> fds,
    cli/veneur_main.py)."""
    check_config(cfg)
    from veneur_tpu_torch.sinks.delivery import DeliveryPolicy

    metric_sinks = list(extra_metric_sinks or [])
    span_sinks = list(extra_span_sinks or [])
    interval = cfg.interval_seconds()
    # one shared delivery policy: every network sink gets its own
    # DeliveryManager built from it (sinks/delivery.py)
    policy = DeliveryPolicy.from_config(cfg, interval)
    kw = {"opener": opener} if opener else {}
    # sinks that have grown the delivery layer take the policy; the
    # rest (kafka, xray, newrelic, lightstep) keep their own handling
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
    if cfg.datadog_trace_api_address:
        from veneur_tpu_torch.sinks.datadog import DatadogSpanSink

        span_sinks.append(DatadogSpanSink(
            cfg.datadog_trace_api_address,
            buffer_size=cfg.datadog_span_buffer_size,
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
    if cfg.newrelic_insert_key and cfg.newrelic_trace_observer_url:
        from veneur_tpu_torch.sinks.newrelic import NewRelicSpanSink

        span_sinks.append(NewRelicSpanSink(
            insert_key=cfg.newrelic_insert_key,
            trace_observer_url=cfg.newrelic_trace_observer_url,
            common_tags=cfg.newrelic_common_tags,
            **kw,
        ))

    if cfg.kafka_broker:
        from veneur_tpu_torch.sinks.kafka import (
            KafkaMetricSink, KafkaSpanSink, default_producer)

        def _buf_ms(spec: str) -> float:
            return parse_duration(spec) * 1000.0 if spec else 0.0

        # one producer per sink, each with its own ack/buffer tuning
        # (reference builds a sarama config per sink,
        # sinks/kafka/kafka.go:83,264)
        try:
            if cfg.kafka_metric_topic or cfg.kafka_check_topic:
                producer = default_producer(
                    cfg.kafka_broker, cfg.kafka_retry_max,
                    cfg.kafka_metric_require_acks,
                    buffer_bytes=cfg.kafka_metric_buffer_bytes,
                    buffer_ms=_buf_ms(cfg.kafka_metric_buffer_frequency),
                    buffer_messages=cfg.kafka_metric_buffer_messages,
                    partitioner=cfg.kafka_partitioner or "hash")
                metric_sinks.append(KafkaMetricSink(
                    producer, cfg.kafka_check_topic, cfg.kafka_event_topic,
                    cfg.kafka_metric_topic))
            if cfg.kafka_span_topic:
                span_producer = default_producer(
                    cfg.kafka_broker, cfg.kafka_retry_max,
                    (cfg.kafka_span_require_acks
                     or cfg.kafka_metric_require_acks),
                    buffer_bytes=cfg.kafka_span_buffer_bytes,
                    buffer_ms=_buf_ms(cfg.kafka_span_buffer_frequency),
                    buffer_messages=cfg.kafka_span_buffer_mesages,
                    partitioner=cfg.kafka_partitioner or "hash")
                if cfg.kafka_span_serialization_format == "columnar":
                    # columnar batch lane: one VSB1 frame per sealed
                    # batch through the delivery manager (retry/breaker/
                    # spill) instead of the drop-only per-span sink
                    from veneur_tpu_torch.spans import (
                        KafkaBatchWriter, SpanBatchSink)

                    span_sinks.append(SpanBatchSink(
                        KafkaBatchWriter(span_producer,
                                         cfg.kafka_span_topic),
                        name="kafka",
                        delivery=policy,
                        batch_rows=cfg.span_batch_rows,
                        pending_cap=cfg.span_pending_cap))
                else:
                    span_sinks.append(KafkaSpanSink(
                        span_producer, cfg.kafka_span_topic,
                        cfg.kafka_span_serialization_format,
                        cfg.kafka_span_sample_rate_percent,
                        cfg.kafka_span_sample_tag))
        except RuntimeError as e:
            log.warning("kafka sink disabled: %s", e)

    if cfg.splunk_hec_address and cfg.splunk_hec_token:
        from veneur_tpu_torch.sinks.splunk import SplunkSpanSink

        span_sinks.append(SplunkSpanSink(
            hec_address=cfg.splunk_hec_address,
            token=cfg.splunk_hec_token,
            hostname=hostname,
            batch_size=cfg.splunk_hec_batch_size,
            submission_workers=cfg.splunk_hec_submission_workers,
            span_sample_rate=cfg.splunk_span_sample_rate,
            send_timeout_s=(parse_duration(cfg.splunk_hec_send_timeout)
                            if cfg.splunk_hec_send_timeout else 10.0),
            ingest_timeout_s=(
                parse_duration(cfg.splunk_hec_ingest_timeout)
                if cfg.splunk_hec_ingest_timeout else 0.0),
            connection_lifetime_s=(
                parse_duration(cfg.splunk_hec_max_connection_lifetime)
                if cfg.splunk_hec_max_connection_lifetime else 60.0),
            connection_lifetime_jitter_s=(
                parse_duration(cfg.splunk_hec_connection_lifetime_jitter)
                if cfg.splunk_hec_connection_lifetime_jitter else 30.0),
            tls_validate_hostname=cfg.splunk_hec_tls_validate_hostname,
            **dkw,
        ))

    if cfg.xray_address:
        from veneur_tpu_torch.sinks.xray import XRaySpanSink

        span_sinks.append(XRaySpanSink(
            cfg.xray_address, cfg.xray_sample_percentage,
            cfg.xray_annotation_tags))

    if cfg.lightstep_access_token or cfg.trace_lightstep_access_token:
        from veneur_tpu_torch.sinks.lightstep import LightStepSpanSink

        span_sinks.append(LightStepSpanSink(
            access_token=(cfg.lightstep_access_token
                          or cfg.trace_lightstep_access_token),
            collector_host=(cfg.lightstep_collector_host
                            or cfg.trace_lightstep_collector_host
                            or "https://collector.lightstep.com"),
            num_clients=(cfg.lightstep_num_clients
                         or cfg.trace_lightstep_num_clients or 1),
            maximum_spans=(cfg.lightstep_maximum_spans
                           or cfg.trace_lightstep_maximum_spans or 100000),
            reconnect_period_s=(
                parse_duration(cfg.lightstep_reconnect_period
                               or cfg.trace_lightstep_reconnect_period)
                if (cfg.lightstep_reconnect_period
                    or cfg.trace_lightstep_reconnect_period) else 0.0),
            **kw,
        ))

    if cfg.falconer_address:
        from veneur_tpu_torch.sinks.grpsink import FalconerSpanSink

        span_sinks.append(FalconerSpanSink(cfg.falconer_address))

    if cfg.span_log_dir:
        from veneur_tpu_torch.spans import SegmentedLogWriter, SpanBatchSink

        span_sinks.append(SpanBatchSink(
            SegmentedLogWriter(cfg.span_log_dir),
            name="span_log",
            delivery=policy,
            batch_rows=cfg.span_batch_rows,
            pending_cap=cfg.span_pending_cap))

    if cfg.archive_dir:
        from veneur_tpu_torch.archive import (
            MetricArchiveSink, SegmentedArchiveWriter)

        metric_sinks.append(MetricArchiveSink(
            SegmentedArchiveWriter(cfg.archive_dir,
                                   max_segment_bytes=cfg.archive_max_bytes,
                                   max_segments=cfg.archive_max_segments),
            hostname=hostname,
            delivery=policy))

    if cfg.debug_flushed_metrics:
        from veneur_tpu_torch.sinks.debug import DebugMetricSink

        metric_sinks.append(DebugMetricSink())
    if cfg.debug_ingested_spans:
        from veneur_tpu_torch.sinks.debug import DebugSpanSink

        span_sinks.append(DebugSpanSink())
    if cfg.flush_emit_native and any(
            getattr(s, "supports_native_emit", False) for s in metric_sinks):
        from veneur_tpu_torch import native

        native.load_library()
    server = Server(cfg, metric_sinks=metric_sinks, device=device,
                    span_sinks=span_sinks, inherited_fds=inherited_fds)

    # plugins (reference server.go:737-785)
    if cfg.flush_file:
        from veneur_tpu_torch.plugins.localfile import LocalFilePlugin

        server.plugins.append(LocalFilePlugin(cfg.flush_file, interval))
    if cfg.aws_s3_bucket and cfg.aws_access_key_id:
        from veneur_tpu_torch.plugins.s3 import S3Plugin

        server.plugins.append(S3Plugin(
            cfg.aws_s3_bucket, cfg.aws_region or "us-east-1",
            cfg.aws_access_key_id, cfg.aws_secret_access_key, interval,
            **kw,
        ))
    if cfg.archive_blob_bucket and cfg.archive_blob_access_key:
        from veneur_tpu_torch.archive import ArchiveBlobPlugin

        server.plugins.append(ArchiveBlobPlugin(
            cfg.archive_blob_bucket, cfg.archive_blob_region,
            cfg.archive_blob_access_key, cfg.archive_blob_secret_key,
            **dkw,
        ))

    # forwarding (a local): one static upstream, or the sharded proxy
    # tier (comma-separated forward_address / discovered fleet)
    if cfg.forward_address or cfg.forward_discovery_file:
        from veneur_tpu_torch.distributed.forward import install_forwarder

        install_forwarder(server)

    # import servers (a global; reference server.go:807-817 for gRPC,
    # http.go:22-60 for the HTTP /import and healthcheck API)
    if cfg.grpc_address:
        from veneur_tpu_torch.distributed.import_server import ImportServer

        server.import_server = ImportServer(server)
        server.import_server.start_grpc(cfg.grpc_address)
    if cfg.http_address:
        from veneur_tpu_torch.distributed.import_server import (
            ImportHTTPServer, ImportServer)
        from veneur_tpu_torch.utils.http import parse_host_port

        if server.import_server is None:
            server.import_server = ImportServer(server)
        host, port = parse_host_port(cfg.http_address, what="http_address")
        server.import_http = ImportHTTPServer(server.import_server)
        server.import_http.start(host, port)
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
