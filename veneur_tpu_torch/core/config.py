"""Configuration: YAML file + VENEUR_* environment overlay.

Parity spec: reference config.go:3-131 (field inventory), config_parse.go
(strict-then-loose YAML parse with unknown-key warnings, envconfig overlay,
defaults struct :14-30). The reference generates its struct from
example.yaml; here the dataclass is the source of truth and yaml keys are
derived from field names.
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass, field, fields
from typing import Any, Optional

import yaml

log = logging.getLogger("veneur_tpu_torch.config")

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNITS = {
    "ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
    "s": 1.0, "m": 60.0, "h": 3600.0,
}


def parse_duration(s: str) -> float:
    """Go-style duration string → seconds ("10s", "500ms", "2m30s")."""
    if not s:
        raise ValueError("empty duration")
    if s in ("0",):
        return 0.0
    pos = 0
    total = 0.0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration {s!r}")
        total += float(m.group(1)) * _DURATION_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration {s!r}")
    return total


@dataclass
class PerTagApiKey:
    name: str = ""
    api_key: str = ""


@dataclass
class ExcludeTagsPrefixByPrefixMetric:
    metric_prefix: str = ""
    tags: list[str] = field(default_factory=list)


@dataclass
class MetricsScopes:
    counter: str = ""
    gauge: str = ""
    histogram: str = ""
    set: str = ""
    status: str = ""


@dataclass
class Config:
    """Server configuration; field names are the yaml keys
    (reference config.go:3-131)."""

    # core pipeline
    aggregates: list[str] = field(
        default_factory=lambda: ["min", "max", "count"])
    percentiles: list[float] = field(default_factory=list)
    interval: str = "10s"
    synchronize_with_interval: bool = False
    metric_max_length: int = 4096
    trace_max_length_bytes: int = 16 * 1024 * 1024
    num_workers: int = 1
    num_readers: int = 1
    num_span_workers: int = 1
    count_unique_timeseries: bool = False
    flush_watchdog_missed_flushes: int = 0
    # flush-deadline governor (veneur_tpu/health/): >0 slices the flush
    # extraction into power-of-two row chunks sized so each chunk takes
    # about this long, giving an extraction-bound host (CPU fallback at
    # high cardinality) longer-but-BOUNDED flushes with per-chunk
    # progress — which the flush watchdog's deferral rule consumes
    # instead of killing a flush that is demonstrably draining. 0 (the
    # default, right for TPU) keeps the single-program extraction and
    # the reference's unconditional watchdog behavior.
    flush_chunk_target_ms: int = 0
    # stage-parallel flush executor (core/pipeline.py): the flush tick
    # stays a cheap snapshot swap, but device extract for interval N,
    # InterMetric generation for N-1, and sink emission for N-2 run
    # concurrently on dedicated single-worker stages, so flush cadence
    # decouples from flush latency (JAX async dispatch covers the
    # device work while the host stages drain earlier intervals).
    # Output is bit-identical to the serial flush per interval
    # (tests/test_pipeline.py). Off by default: serial flush remains
    # the reference-shaped path.
    flush_pipeline: bool = False
    # intervals a stage queue may hold beyond the in-progress one
    # before the tick sheds instead of enqueueing (health/policy.py
    # MAX_STAGE_BACKLOG documents why the default is one).
    flush_pipeline_backlog: int = 1
    # native emit tier (native/emit.cpp): sinks that can hand their wire
    # serialization (JSON bodies, exposition text, statsd lines, deflate)
    # to the C++ serializers do so with the GIL released; per-sink
    # negotiation falls back to the Python formatters automatically when
    # the library is absent or a batch uses an uncovered feature. Off
    # forces the Python columnar formatters everywhere.
    flush_emit_native: bool = True
    # sink delivery reliability (sinks/delivery.py): every network sink
    # posts through a shared retry/breaker/spill layer.
    # flush_timeout_s is the per-attempt network timeout (connects and
    # POSTs — the one knob that replaced the hardcoded 10s openers) and
    # the unit of the retry deadline math: the whole retry budget for a
    # flush is clipped to the remaining flush interval, so a sick sink
    # can never stall the emit stage past its tick.
    flush_timeout_s: float = 10.0
    # retries after the first attempt on RETRYABLE failures only
    # (connect refused/reset, timeouts, HTTP 408/429/5xx; other 4xx are
    # payload errors and never retry), exponential backoff + full jitter
    sink_retry_max: int = 2
    # consecutive delivery failures before a sink's circuit breaker
    # opens (then: one half-open probe per flush interval until the
    # endpoint recovers). 0 disables the breaker.
    sink_breaker_threshold: int = 3
    # bounded per-sink spill of failed serialized payloads, retried
    # ahead of fresh data next interval; when EITHER cap is exceeded the
    # oldest payloads drop with honest delivery.dropped_payloads/_bytes
    # counters — graceful degradation, never unbounded memory
    sink_spill_max_bytes: int = 4194304
    sink_spill_max_payloads: int = 256
    # write-ahead spill journal (utils/journal.py): when a directory is
    # set, every journalable sink's spill gets a durable shadow — a
    # SIGKILL no longer destroys deferred payloads; the next incarnation
    # replays them AHEAD of fresh data and the conservation contract
    # extends across process lifetimes. Empty (the default) = off,
    # byte-identical to the in-RAM-only behaviour.
    spill_journal_dir: str = ""
    # fsync policy: "always" (per append — strongest, slowest),
    # "interval" (at each flush edge — the default), "never" (OS cache)
    spill_journal_fsync: str = "interval"
    # journal bounds: total bytes across segment files and segment-file
    # count; oldest segment evicted first when either cap bites (live
    # records evicted are counted, never silent)
    spill_journal_max_bytes: int = 64 << 20
    spill_journal_max_segments: int = 8
    # graceful drain (SIGTERM): final-epoch flush then bounded
    # spill-settling passes before exit; whatever the deadline clips is
    # counted under shutdown.* (and stays journaled when the journal is
    # on). 0 disables the drain (the pre-PR-9 hard stop).
    shutdown_drain_deadline_s: float = 10.0
    # config hot-reload: poll the config file's mtime every N seconds
    # and re-apply WHITELISTED keys (tenant budgets, journal knobs,
    # drain deadline) without a restart; other changed keys log-and-
    # ignore with a counter. 0 (default) = off.
    config_reload_s: float = 0.0
    flush_max_per_body: int = 0
    flush_file: str = ""
    omit_empty_hostname: bool = False
    hostname: str = ""
    tags: list[str] = field(default_factory=list)
    tags_exclude: list[str] = field(default_factory=list)
    span_channel_capacity: int = 100
    # accepted for config compatibility only: upstream this is a
    # deprecated alias for datadog_span_buffer_size (config_parse.go:
    # 172-176), a span-count knob — NOT a recv-buffer size. SSF recv
    # buffers are sized from trace_max_length_bytes (server.go:859-863).
    ssf_buffer_size: int = 16 * 1024
    read_buffer_size_bytes: int = 2 * 1048576

    # listeners
    statsd_listen_addresses: list[str] = field(default_factory=list)
    ssf_listen_addresses: list[str] = field(default_factory=list)
    http_address: str = ""
    grpc_address: str = ""
    http_quit: bool = False
    stats_address: str = ""
    # live query subsystem (veneur_tpu/query/): addresses to serve
    # epoch-fenced reads on, each "http://host:port" (exposition /metrics
    # + JSON /query) or "grpc://host:port" (veneurtpu.Query/Query).
    # Port 0 binds ephemerally (tests). Empty list keeps the whole query
    # path dormant — no retained device views, no listeners.
    query_listen_addrs: list[str] = field(default_factory=list)

    # TLS
    tls_key: str = ""
    tls_certificate: str = ""
    tls_authority_certificate: str = ""

    # forwarding
    forward_address: str = ""
    forward_use_grpc: bool = False
    # wire format for gRPC forwarding: "veneurtpu" (this framework's own
    # proto) or "forwardrpc" (the reference Go fleet's
    # forwardrpc.Forward/SendMetrics + metricpb wire, for forwarding into
    # a stock veneur global — see distributed/interop.py)
    forward_format: str = "veneurtpu"
    # exactly-once forwards: the import path keeps a bounded per-sender
    # window of recently seen dedup ids and drops replays
    # (distributed/import_server.py DedupWindow). Sized by ids AND
    # bytes; eviction degrades to at-least-once (counted), never blocks
    # ingest. forward_dedup: false applies payloads without the window
    # check (envelopes still decode for interop).
    forward_dedup: bool = True
    forward_dedup_window_ids: int = 65536
    forward_dedup_window_bytes: int = 8 << 20
    # streaming forwards: ride one long-lived StreamMetrics channel to
    # the upstream instead of a unary call per flush payload, with at
    # most forward_stream_window unacked frames in flight (client
    # buffer ≈ window × flush payload bytes). An old upstream answers
    # UNIMPLEMENTED once and the client downgrades to unary for the
    # connection's lifetime, so mixed fleets interop either way.
    forward_streaming: bool = True
    forward_stream_window: int = 32
    # adaptive ack window (distributed/rpc.py _WindowController): the
    # in-flight window self-tunes AIMD-style per destination — +1/W per
    # clean ack, halved on busy-acks/ack-timeouts — clamped to
    # [forward_stream_window_min, forward_stream_window_max];
    # forward_stream_window is the starting point. Off (or the
    # VENEUR_STREAM_ADAPTIVE=0 escape hatch) pins the PR-15 fixed
    # window for old-peer interop, byte-identical on the wire.
    forward_stream_adaptive: bool = True
    forward_stream_window_min: int = 1
    forward_stream_window_max: int = 128
    # byte target per stream frame: senders coalesce flush payloads up
    # to ~this many bytes per frame (a frame's cost becomes predictable,
    # making the window controller's unit meaningful); per-destination
    # frame memory is bounded by window_max × frame_bytes. The import
    # side's StreamCoalescer group-commits on a multiple of the same
    # budget.
    forward_stream_frame_bytes: int = 262144
    # sharded proxy tier (distributed/spread.py): instead of pinning ONE
    # upstream in forward_address, the local tier can discover the proxy
    # FLEET and spread each flush's forward payloads across live proxies
    # (per-proxy streaming client + delivery manager; spread policy
    # below). forward_discovery_file names a FileWatchDiscoverer
    # members/standby file — the same watchable membership format the
    # elastic global tier uses, so one fleet file feeds both the senders
    # (read) and a proxy-tier autoscale controller (write).
    # forward_address doubles as a STATIC fleet when it holds a
    # comma-separated address list (no discovery daemon needed).
    forward_discovery_file: str = ""
    forward_discovery_interval: str = "10s"
    # probe-gate discovered proxies (elastic.HealthGate over tcp_probe):
    # unreachable candidates never enter the spread; a proxy whose
    # breaker stays open across refreshes is quarantined out and
    # re-admitted only on probe success
    forward_discovery_probe: bool = True
    # "p2c" = power-of-two-choices on in-flight window depth with a
    # sticky round-robin fallback when depths tie; "round_robin" = plain
    # rotation
    forward_spread_policy: str = "p2c"
    # per-proxy delivery knobs for the spread lanes (sinks/delivery.py
    # DeliveryPolicy — the same machinery the proxies run per global)
    forward_retry_max: int = 2
    forward_breaker_threshold: int = 3
    forward_spill_max_bytes: int = 8 << 20
    forward_spill_max_payloads: int = 256
    # set-element hash: "fnv" (this framework's own, utils/hashing.hll_hash)
    # or "metro" (metro64 seed=1337, what the Go fleet inserts with —
    # REQUIRED on any instance that shares set series with Go veneur
    # instances, since HLL unions are only valid under one element hash)
    set_hash: str = "fnv"

    # device / TPU execution
    # mesh sharding (global aggregation tier): >1 shards histogram state
    # over a (tpu_mesh_hosts × series-shards) device mesh; imported
    # digests merge via ICI collectives at flush (distributed/mesh.py).
    # Requires num_workers: 1 (the mesh IS the sharding).
    tpu_mesh_devices: int = 0
    tpu_mesh_hosts: int = 0  # 0 = auto (2 when the device count is even)
    tpu_native_ingest: bool = True
    # C++ reader threads own the UDP recv loop (datagram -> parse ->
    # staged sample, no Python/GIL on the path); requires
    # tpu_native_ingest. Python readers remain for TCP/TLS/unixgram/SSF.
    tpu_native_readers: bool = True
    tpu_batch_size: int = 16384
    # raw-sample staging slots per histogram row: ingest stores samples
    # into a host [rows, depth] plane and the digest compress runs once
    # per interval (worker.fold_staged); rows that fill their
    # staging mid-interval spill through the direct device fold
    tpu_stage_depth: int = 64
    # always-hot flush (ops/microfold.py): stream the staging plane to a
    # device mirror in sub-interval micro-folds, every time the staged
    # backlog crosses micro_fold_rows samples or ages past
    # micro_fold_max_age_s, so the flush tick's fold collapses to a
    # residual drain. Bit-identical to the batch fold per metric class
    # (tests/test_torch_microfold.py). Inert when staging is off
    # (tpu_stage_depth 0), and while the device guard has quarantined the
    # worker.
    micro_fold: bool = True
    micro_fold_rows: int = 8192
    micro_fold_max_age_s: float = 0.25
    # device-sharded series axis (ops/series_shard.py): >1 partitions
    # each worker's sketch pools (t-digest rows, HLL registers, the
    # micro-fold mirror) over that many devices with a shard_map row
    # interleave — upload, micro-fold, and fold all run shard-local, one
    # packed readback at extract. Must be a power of two <= the visible
    # device count; bit-identical to the single-device path per metric
    # class (tests/test_series_shard.py). VENEUR_SERIES_SHARDS=0 is the
    # env escape hatch. Mutually exclusive with tpu_mesh_devices (the
    # global tier's mesh owns its own layout).
    series_shards: int = 0
    # shared-nothing multi-reader ingest: each C++ UDP reader thread
    # commits into its OWN native context (private directory + staging
    # plane + SoA spill epoch — no shared mutex on the line path), and
    # the flush reconciles the per-reader row spaces at the series sync
    # and folds all planes on-device as one stacked batch
    # (ops/reader_stack.py). -1 (default) = auto: one shard per reader
    # when native ingest + native readers are on, num_workers is 1 and
    # num_readers > 1; 0 disables (legacy digest-routed commits through
    # the shared per-worker context). Explicit N requests N shards.
    # Bit-identical flush output either way per metric class
    # (tests/test_reader_shards.py); VENEUR_READER_SHARDS=0 is the env
    # escape hatch. Requires num_workers: 1 (the canonical row space is
    # the single worker's directory); incompatible requests degrade to
    # the legacy path with a warning rather than failing ingest.
    reader_shards: int = -1
    # device fault domain (ops/device_guard.py): every device entry
    # point on the worker hot path runs under a guarded executor that
    # classifies device errors (device.fault.{oom,compile,lost,other}),
    # retries once where operands are not donated, and — after
    # device_fault_streak CONSECUTIVE faults — trips a per-worker
    # breaker that quarantines the device path and fails over to the
    # CPU (the same torch programs), bit-identical per metric class.
    # While quarantined, a compile+fold+extract probe runs every
    # device_probe_interval_s; success re-admits the device path and
    # re-uploads the host state. VENEUR_DEVICE_GUARD=0 is the env
    # escape hatch (disables the guard entirely for bisection).
    device_guard: bool = True
    device_fault_streak: int = 3
    device_probe_interval_s: float = 30.0
    # entries per pending-batch (SoA) class before ingest sheds samples
    # (drop-don't-block under overload; counted in
    # veneur.ingest.overload_dropped_total). Bounds native ingest memory
    # the way the reference's fixed worker channels do (worker.go:31-48)
    tpu_spill_cap: int = 1 << 22
    tpu_compression: float = 100.0
    tpu_hll_precision: int = 14
    # loadgen workload spec (veneur_tpu/loadgen): declarative shape of
    # synthesized DogStatsD traffic — the standing load harness every
    # ingest change is measured against (tools/bench_sustained.py).
    # Type mix is {c, g, ms, h, s} weights in that fixed order.
    loadgen_seed: int = 7
    loadgen_num_keys: int = 10000
    loadgen_zipf_s: float = 1.1  # 0 = uniform key popularity
    loadgen_type_mix: list[float] = field(
        default_factory=lambda: [0.35, 0.15, 0.25, 0.15, 0.10])
    loadgen_num_tags: int = 3
    loadgen_tag_cardinality: int = 50
    loadgen_prefix: str = "lg"
    loadgen_datagram_bytes: int = 1400  # pack target per datagram
    loadgen_ring_lines: int = 200000  # distinct lines in the send ring
    # multi-tenant workloads (per-tenant QoS soak): >1 stamps every line
    # with a tenant:tN tag. The LAST tenant (t{count-1}) is the abusive
    # one: abusive_frac of all lines go to it, and its key space churns
    # over tenant_churn_keys extra names (the cardinality attack the
    # series budget defends against). Innocent tenants draw Zipf
    # (tenant_zipf_s; 0 = uniform) over the remaining ids. 1 (default)
    # emits byte-identical legacy output — no tenant tag at all.
    loadgen_tenant_count: int = 1
    loadgen_tenant_abusive_frac: float = 0.0
    loadgen_tenant_zipf_s: float = 0.0
    loadgen_tenant_churn_keys: int = 0
    # per-tenant QoS (core/tenancy.py): tag key whose value names the
    # owning tenant (samples without it belong to the "default" tenant),
    # a per-tenant distinct-series budget enforced at series-adopt time
    # (over budget: NEW series are rejected with honest
    # tenant.samples_rejected_total counters; existing series keep
    # aggregating — reject-new, never evict-live), and the on-device
    # heavy-hitter sketch dimensions (ops/heavyhitter.py) behind the
    # per-tenant top-k telemetry. tenant_default_budget 0 with no
    # per-tenant override disables the whole layer (zero overhead).
    tenant_tag_key: str = "tenant"
    tenant_default_budget: int = 0  # distinct series per tenant; 0 = off
    tenant_budgets: dict = field(default_factory=dict)  # tenant → budget
    tenant_sketch_depth: int = 4
    tenant_sketch_width: int = 2048  # power of two
    tenant_topk: int = 8
    # set-sketch storage: "staged" keeps small sets host-side sparse and
    # promotes rows past 2^p/8 distinct registers to dense device rows
    # (the scalable default — 1M small-set series costs ~MBs instead of
    # 16GB of HBM; see ops/staged_sets.py for the crossover math);
    # "dense" keeps the all-dense device pool
    tpu_set_store: str = "staged"
    tpu_initial_histo_rows: int = 4096
    tpu_initial_set_rows: int = 512
    # persistent XLA compilation cache: first compile of each flush/fold
    # program shape costs ~20-40s on TPU; with a cache dir set, restarts
    # (watchdog, fd-handoff upgrades) reuse compiled programs instead of
    # re-paying it. Empty = disabled.
    tpu_compilation_cache_dir: str = ""
    # precompile the flush programs at startup (background thread, first
    # row bucket) so the first real flush doesn't pay the per-shape XLA
    # compile inside the interval
    tpu_warmup_compile: bool = True

    # self-telemetry & debugging
    debug: bool = False
    debug_flushed_metrics: bool = False
    debug_ingested_spans: bool = False
    enable_profiling: bool = False
    # where the XLA/JAX profiler trace is written when enable_profiling
    # (TPU-native analog of the reference's pprof profile.Start())
    profile_dir: str = ""
    block_profile_rate: int = 0
    mutex_profile_fraction: int = 0
    sentry_dsn: str = ""
    veneur_metrics_additional_tags: list[str] = field(default_factory=list)
    veneur_metrics_scopes: MetricsScopes = field(default_factory=MetricsScopes)

    # spans → derived metrics
    indicator_span_timer_name: str = ""
    objective_span_timer_name: str = ""
    # span-name uniqueness Set sampling rate; the reference hardcodes 0.01
    # (sinks/ssfmetrics/metrics.go ConvertSpanUniquenessMetrics)
    ssf_span_uniqueness_rate: float = 0.01
    # columnar span pipeline (veneur_tpu/spans/): ingest batches spans
    # into interned columns, derivation runs at the flush edge straight
    # into the device workers, and batch-capable sinks get sealed batches
    # instead of per-span objects. Env escape hatch: VENEUR_SPAN_COLUMNAR=0
    # falls back to the per-span SpanWorker path.
    span_columnar: bool = True
    # rows per sealed columnar batch (one VSB1 frame per batch on egress)
    span_batch_rows: int = 512
    # span rows buffered between flushes before ingest sheds
    # (loss-over-stall, counted; the columnar analog of
    # span_channel_capacity)
    span_pending_cap: int = 1 << 20
    # shared lane-drain budget per SpanWorker.flush pass (seconds);
    # was a hardcoded 0.5s
    span_flush_drain_s: float = 0.5
    # when set, a SegmentedLogWriter SpanBatchSink appends VSB1 frames
    # to this directory (brokerless columnar span egress)
    span_log_dir: str = ""

    # sink: datadog
    datadog_api_hostname: str = ""
    datadog_api_key: str = ""
    datadog_flush_max_per_body: int = 25000
    datadog_metric_name_prefix_drops: list[str] = field(default_factory=list)
    datadog_exclude_tags_prefix_by_prefix_metric: list[
        ExcludeTagsPrefixByPrefixMetric] = field(default_factory=list)
    datadog_span_buffer_size: int = 1 << 14
    datadog_trace_api_address: str = ""

    # sink: signalfx
    signalfx_api_key: str = ""
    signalfx_dynamic_per_tag_api_keys_enable: bool = False
    signalfx_dynamic_per_tag_api_keys_refresh_period: str = ""
    signalfx_endpoint_base: str = ""
    signalfx_endpoint_api: str = ""
    signalfx_flush_max_per_body: int = 0
    signalfx_hostname_tag: str = ""
    signalfx_metric_name_prefix_drops: list[str] = field(default_factory=list)
    signalfx_metric_tag_prefix_drops: list[str] = field(default_factory=list)
    signalfx_per_tag_api_keys: list[PerTagApiKey] = field(default_factory=list)
    signalfx_vary_key_by: str = ""

    # sink: kafka
    kafka_broker: str = ""
    kafka_check_topic: str = ""
    kafka_event_topic: str = ""
    kafka_metric_topic: str = ""
    kafka_span_topic: str = ""
    kafka_metric_buffer_bytes: int = 0
    kafka_metric_buffer_frequency: str = ""
    kafka_metric_buffer_messages: int = 0
    kafka_metric_require_acks: str = ""
    kafka_partitioner: str = ""
    kafka_retry_max: int = 0
    kafka_span_buffer_bytes: int = 0
    kafka_span_buffer_frequency: str = ""
    kafka_span_buffer_mesages: int = 0
    kafka_span_require_acks: str = ""
    kafka_span_sample_rate_percent: float = 100.0
    kafka_span_sample_tag: str = ""
    kafka_span_serialization_format: str = "protobuf"

    # sink: splunk
    splunk_hec_address: str = ""
    splunk_hec_token: str = ""
    splunk_hec_batch_size: int = 100
    splunk_hec_connection_lifetime_jitter: str = ""
    splunk_hec_ingest_timeout: str = ""
    splunk_hec_max_connection_lifetime: str = "10s"
    splunk_hec_send_timeout: str = ""
    splunk_hec_submission_workers: int = 1
    splunk_hec_tls_validate_hostname: str = ""
    splunk_span_sample_rate: int = 100

    # sink: newrelic
    newrelic_account_id: int = 0
    newrelic_common_tags: list[str] = field(default_factory=list)
    newrelic_event_type: str = ""
    newrelic_insert_key: str = ""
    newrelic_region: str = ""
    newrelic_service_check_event_type: str = ""
    newrelic_trace_observer_url: str = ""

    # sink: lightstep
    lightstep_access_token: str = ""
    lightstep_collector_host: str = ""
    lightstep_maximum_spans: int = 0
    lightstep_num_clients: int = 0
    lightstep_reconnect_period: str = ""
    trace_lightstep_access_token: str = ""
    trace_lightstep_collector_host: str = ""
    trace_lightstep_maximum_spans: int = 0
    trace_lightstep_num_clients: int = 0
    trace_lightstep_reconnect_period: str = ""

    # sink: xray
    xray_address: str = ""
    xray_annotation_tags: list[str] = field(default_factory=list)
    xray_sample_percentage: float = 100.0

    # sink: falconer (grpsink)
    falconer_address: str = ""

    # sink: prometheus repeater
    prometheus_repeater_address: str = ""
    prometheus_network_type: str = "tcp"
    # sink: prometheus pushgateway (exposition-text POST per flush)
    prometheus_pushgateway_address: str = ""

    # sink: forward-statsd (flushed series re-emitted as verbatim
    # DogStatsD lines to a downstream aggregator)
    forward_statsd_address: str = ""
    forward_statsd_network: str = "udp"

    # plugins: s3
    aws_access_key_id: str = ""
    aws_secret_access_key: str = ""
    aws_region: str = ""
    aws_s3_bucket: str = ""

    # flush archival (veneur_tpu/archive/): a rotated, size-and-count-
    # bounded local VMB1 archive of every flush, replayable through the
    # import path (tools/replay_archive.py). Empty archive_dir = off.
    archive_dir: str = ""
    archive_max_bytes: int = 64 << 20    # per-segment rotation size
    archive_max_segments: int = 8        # oldest segment unlinked past this
    # blob egress: the same VMB1 frames PUT to S3-compatible storage
    # under archive/<hostname>/<timestamp>-<seq>.vmb, through the
    # delivery layer (retry/breaker/spill). Empty bucket = off.
    archive_blob_bucket: str = ""
    archive_blob_region: str = "us-east-1"
    archive_blob_access_key: str = ""
    archive_blob_secret_key: str = ""

    def interval_seconds(self) -> float:
        return parse_duration(self.interval)

    def is_local(self) -> bool:
        """A server is 'local' iff it forwards upstream — through a
        static address (or comma-separated fleet) OR a discovered proxy
        fleet (reference server.go:1489-1491)."""
        return bool(self.forward_address or self.forward_discovery_file)

    def forward_destinations(self) -> list[str]:
        """forward_address split as a static destination list (scheme
        prefixes stripped for the gRPC path by the forwarder)."""
        return [a.strip() for a in self.forward_address.split(",")
                if a.strip()]


@dataclass
class ProxyConfig:
    """veneur-proxy configuration (reference config_proxy.go:3-27)."""

    consul_forward_grpc_service_name: str = ""
    consul_forward_service_name: str = ""
    consul_refresh_interval: str = "30s"
    consul_trace_service_name: str = ""
    consul_url: str = "http://127.0.0.1:8500"
    idle_connection_timeout: str = ""  # downstream conn idle timeout
    runtime_metrics_interval: str = "10s"
    kubernetes_forward_service_name: str = ""
    kubernetes_namespace: str = "default"
    debug: bool = False
    enable_profiling: bool = False
    forward_address: str = ""  # static destination (no discovery)
    forward_timeout: str = "10s"
    # exactly-once forwards: mint a journal-backed dedup id per forward
    # fragment and carry it in a versioned wire envelope so the import
    # path can reject replays (retries, handoff re-sends, network
    # duplicates). Escape hatch: VENEUR_FORWARD_DEDUP=0. The window
    # keys size this proxy's OWN import window when it receives
    # forwards (same keys as the server config).
    forward_dedup: bool = True
    forward_dedup_window_ids: int = 65536
    forward_dedup_window_bytes: int = 8 << 20
    # streaming forwards (the PR-15 hop): one long-lived StreamMetrics
    # channel per destination with a bounded in-flight ack window
    # replacing a unary call per fragment. A frame is delivered only on
    # its ack, so retry/breaker/spill and the dedup keys behave exactly
    # as on the unary path; old destinations downgrade the client to
    # unary via UNIMPLEMENTED. Escape hatch: VENEUR_FORWARD_STREAMING=0.
    forward_streaming: bool = True
    forward_stream_window: int = 32
    # adaptive AIMD ack window + byte-sized frames (same keys and
    # semantics as the server config; see Config above). Escape hatch:
    # VENEUR_STREAM_ADAPTIVE=0 pins the fixed PR-15 window.
    forward_stream_adaptive: bool = True
    forward_stream_window_min: int = 1
    forward_stream_window_max: int = 128
    forward_stream_frame_bytes: int = 262144
    # forward-path delivery guarantees (the PR-5 sink delivery layer
    # applied per destination; sinks/delivery.py DeliveryPolicy):
    # bounded retry on transient failures, per-destination circuit
    # breaker, bounded spill re-routed on the current ring each drain
    forward_retry_max: int = 2
    forward_breaker_threshold: int = 3
    forward_spill_max_bytes: int = 8 << 20
    forward_spill_max_payloads: int = 512
    # bounded reshard-handoff window: the drain cadence and the budget
    # for re-routing spilled fragments after a membership change
    handoff_window_s: float = 5.0
    # write-ahead spill journal for the forward-path spill (shared
    # across per-destination managers; utils/journal.py). Empty = off.
    spill_journal_dir: str = ""
    spill_journal_fsync: str = "interval"
    spill_journal_max_bytes: int = 64 << 20
    spill_journal_max_segments: int = 8
    # SIGTERM drain budget: bounded spill-settling passes before exit
    shutdown_drain_deadline_s: float = 10.0
    # bounded routing executor replacing per-batch thread spawn
    routing_pool_workers: int = 4
    routing_queue_max: int = 128
    grpc_address: str = ""
    grpc_forward_address: str = ""
    http_address: str = ""
    # total cap on kept-alive downstream connections across all
    # destinations (reference config_proxy.go:16 -> http.Transport
    # MaxIdleConns); 0 = unlimited, matching the Go zero value
    max_idle_conns: int = 0
    max_idle_conns_per_host: int = 100
    sentry_dsn: str = ""
    # elastic tier (distributed/elastic.py): watchable file-based
    # membership + health-gated admission/quarantine + optional
    # load-driven autoscaling. Setting elastic_membership_file selects
    # the FileWatchDiscoverer (takes precedence over consul/k8s) and
    # arms the HealthGate on the refresh path.
    elastic_membership_file: str = ""
    elastic_probe_timeout_s: float = 1.0
    # refresh intervals a member's breaker must stay open before it is
    # quarantined out of the ring
    elastic_quarantine_intervals: int = 3
    # autoscale controller: K consecutive pressured (calm) observation
    # intervals before scale-out (scale-in), plus a cooldown between
    # actions so one reshard settles before the next reading
    elastic_autoscale: bool = False
    elastic_hysteresis_intervals: int = 3
    elastic_cooldown_s: float = 60.0
    elastic_min_members: int = 1
    elastic_max_members: int = 0       # 0 = uncapped
    elastic_observe_interval_s: float = 10.0
    # proxy-TIER elastics (the other half of "elastic both tiers"): this
    # proxy can run the FLEET's autoscale controller over a shared
    # members/standby file — the same watchable file the local tier's
    # senders read through forward_discovery_file. Pressure comes from
    # the proxy's OWN fan-in signals (routing-queue admission timeouts,
    # stream window stalls, routing sheds; elastic.ProxyTierPressureSource)
    # and the controller applies the same hysteresis/cooldown/
    # graceful-leave semantics (elastic_* keys above) to the proxy
    # fleet. Exactly one proxy per fleet should arm fleet_autoscale.
    fleet_membership_file: str = ""
    fleet_autoscale: bool = False
    # accepted for YAML compatibility with reference proxy configs;
    # nothing consumes it there either (config_proxy.go:23 has no
    # reader outside the config struct)
    trace_api_address: str = ""
    ssf_destination_address: str = ""
    stats_address: str = ""
    trace_address: str = ""  # static trace destination (no discovery)
    tracing_client_capacity: int = 1024
    tracing_client_flush_interval: str = "500ms"
    tracing_client_metrics_interval: str = "1s"


def load_proxy_config(path: Optional[str] = None,
                      data: Optional[dict] = None,
                      env: Optional[dict] = None) -> ProxyConfig:
    """reference ReadProxyConfig (config_parse.go:33)."""
    raw: dict[str, Any] = {}
    if path is not None:
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    if data is not None:
        raw.update(data)
    cfg = ProxyConfig()
    known = {f.name for f in fields(cfg)}
    unknown = [k for k in raw if k not in known]
    if unknown:
        log.warning("unknown proxy config keys: %s", sorted(unknown))
    for key, value in raw.items():
        if key in known and value is not None:
            setattr(cfg, key, _coerce(value, getattr(cfg, key), key))
    env = os.environ if env is None else env
    for name in known:
        for candidate in ("VENEUR_" + name.upper(),
                          "VENEUR_" + name.upper().replace("_", "")):
            if candidate in env:
                setattr(cfg, name,
                        _coerce(env[candidate], getattr(cfg, name), name))
                break
    validate_proxy_config(cfg)
    return cfg


def _validate_journal_keys(cfg) -> None:
    """Shared journal/drain key validation (Config and ProxyConfig carry
    the same spill_journal_* / shutdown_drain_deadline_s knobs)."""
    from veneur_tpu_torch.utils.journal import FSYNC_POLICIES

    if cfg.spill_journal_fsync not in FSYNC_POLICIES:
        raise ValueError(
            f"spill_journal_fsync must be one of {FSYNC_POLICIES}")
    if cfg.spill_journal_max_bytes < 1:
        raise ValueError("spill_journal_max_bytes must be >= 1 (unset"
                         " spill_journal_dir to disable journaling)")
    if cfg.spill_journal_max_segments < 1:
        raise ValueError("spill_journal_max_segments must be >= 1")
    if cfg.shutdown_drain_deadline_s < 0:
        raise ValueError("shutdown_drain_deadline_s must be >= 0"
                         " (0 disables the graceful drain)")


def _validate_dedup_keys(cfg) -> None:
    """Shared dedup-window validation (Config and ProxyConfig carry the
    same forward_dedup_* knobs)."""
    if cfg.forward_dedup_window_ids < 1:
        raise ValueError("forward_dedup_window_ids must be >= 1 (set"
                         " forward_dedup: false to disable dedup)")
    if cfg.forward_dedup_window_bytes < 1:
        raise ValueError("forward_dedup_window_bytes must be >= 1 (set"
                         " forward_dedup: false to disable dedup)")


def _validate_stream_keys(cfg) -> None:
    """Shared streaming-forward validation (Config and ProxyConfig carry
    the same forward_streaming/forward_stream_* knobs)."""
    if cfg.forward_stream_window < 1:
        raise ValueError("forward_stream_window must be >= 1 (set"
                         " forward_streaming: false to disable streaming)")
    if cfg.forward_stream_window_min < 1:
        raise ValueError("forward_stream_window_min must be >= 1 (a"
                         " zero window can never admit a frame)")
    if cfg.forward_stream_window_max < cfg.forward_stream_window_min:
        raise ValueError("forward_stream_window_max must be >="
                         " forward_stream_window_min")
    if not (cfg.forward_stream_window_min <= cfg.forward_stream_window
            <= cfg.forward_stream_window_max):
        raise ValueError("forward_stream_window (the adaptive starting"
                         " point) must lie in [forward_stream_window_min,"
                         " forward_stream_window_max]")
    if cfg.forward_stream_frame_bytes < 1:
        raise ValueError("forward_stream_frame_bytes must be >= 1")


def _validate_elastic_keys(cfg) -> None:
    if cfg.elastic_probe_timeout_s <= 0:
        raise ValueError("elastic_probe_timeout_s must be positive")
    if cfg.elastic_quarantine_intervals < 1:
        raise ValueError("elastic_quarantine_intervals must be >= 1")
    if cfg.elastic_hysteresis_intervals < 1:
        raise ValueError("elastic_hysteresis_intervals must be >= 1")
    if cfg.elastic_cooldown_s < 0:
        raise ValueError("elastic_cooldown_s must be >= 0")
    if cfg.elastic_min_members < 1:
        raise ValueError("elastic_min_members must be >= 1 (an empty"
                         " ring loses routing entirely)")
    if cfg.elastic_max_members and \
            cfg.elastic_max_members < cfg.elastic_min_members:
        raise ValueError("elastic_max_members must be 0 (uncapped) or"
                         " >= elastic_min_members")
    if cfg.elastic_observe_interval_s <= 0:
        raise ValueError("elastic_observe_interval_s must be positive")
    if cfg.elastic_autoscale and not cfg.elastic_membership_file:
        raise ValueError("elastic_autoscale requires"
                         " elastic_membership_file (the controller"
                         " writes the desired member set back through"
                         " the watchable file)")
    if getattr(cfg, "fleet_autoscale", False) \
            and not getattr(cfg, "fleet_membership_file", ""):
        raise ValueError("fleet_autoscale requires fleet_membership_file"
                         " (the proxy-tier controller writes the fleet's"
                         " desired member set back through the watchable"
                         " file the senders discover from)")


def validate_proxy_config(cfg: ProxyConfig) -> None:
    parse_duration(cfg.forward_timeout)  # raises on nonsense
    parse_duration(cfg.consul_refresh_interval)
    parse_duration(cfg.runtime_metrics_interval)
    if (cfg.forward_address and cfg.grpc_forward_address
            and cfg.forward_address != cfg.grpc_forward_address):
        # this proxy routes ALL forwards over one gRPC ring, so two
        # different static addresses is an ambiguous config that used to
        # be silently resolved by dropping forward_address — reject it
        # at validation instead (set exactly one, or the same value)
        raise ValueError(
            "forward_address and grpc_forward_address are both set (to"
            f" {cfg.forward_address!r} and {cfg.grpc_forward_address!r})"
            " but this proxy routes all forwards over one gRPC ring —"
            " set exactly one of them")
    if cfg.idle_connection_timeout:
        parse_duration(cfg.idle_connection_timeout)
    if cfg.forward_retry_max < 0:
        raise ValueError("forward_retry_max must be >= 0 (0 means one"
                         " attempt, no retries)")
    if cfg.forward_breaker_threshold < 0:
        raise ValueError("forward_breaker_threshold must be >= 0"
                         " (0 disables the circuit breaker)")
    if cfg.forward_spill_max_bytes < 0 or cfg.forward_spill_max_payloads < 0:
        raise ValueError("forward spill caps must be >= 0 (0 drops failed"
                         " fragments instead of spilling them)")
    if cfg.handoff_window_s <= 0:
        raise ValueError("handoff_window_s must be positive (it bounds"
                         " the reshard drain AND paces the drain thread)")
    _validate_journal_keys(cfg)
    _validate_dedup_keys(cfg)
    _validate_stream_keys(cfg)
    _validate_elastic_keys(cfg)
    if cfg.routing_pool_workers < 1:
        raise ValueError("routing_pool_workers must be >= 1")
    if cfg.routing_queue_max < 1:
        raise ValueError("routing_queue_max must be >= 1 (the bound is"
                         " the whole point of the routing executor)")
    if cfg.max_idle_conns < 0:
        raise ValueError("max_idle_conns must be >= 0 (0 = unlimited)")


SECRET_FIELDS = {
    "datadog_api_key", "signalfx_api_key", "sentry_dsn",
    "aws_access_key_id", "aws_secret_access_key", "newrelic_insert_key",
    "splunk_hec_token", "lightstep_access_token",
    "trace_lightstep_access_token", "tls_key",
    "archive_blob_secret_key",
}


def redacted_dict(cfg: Config) -> dict[str, Any]:
    """Config as a dict with secrets masked, for debug logging
    (reference server.go:794-802)."""
    out = {}
    for f in fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in SECRET_FIELDS and v:
            v = "REDACTED"
        out[f.name] = v
    return out


class UnknownConfigKeys(Warning):
    pass


def _coerce(value: Any, target: Any, key: str) -> Any:
    if isinstance(target, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(target, int) and not isinstance(target, bool):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, list):
        if isinstance(value, str):
            return [v for v in value.split(",") if v]
        return list(value)
    if isinstance(target, dict):
        # env overlay form: "name:value,name:value" (tenant_budgets)
        if isinstance(value, str):
            out: dict[str, int] = {}
            for part in value.split(","):
                if not part:
                    continue
                name, _, v = part.partition(":")
                out[name] = int(v)
            return out
        return dict(value)
    return value


def load_config(path: Optional[str] = None, data: Optional[dict] = None,
                env: Optional[dict] = None, strict: bool = False) -> Config:
    """Read config: yaml → env overlay → defaults.

    Unknown yaml keys warn (the reference falls back from strict to loose
    parse, config_parse.go:115). Environment variables named VENEUR_<KEY>
    (yaml key uppercased, with or without underscores) override file values
    (reference envconfig overlay).
    """
    raw: dict[str, Any] = {}
    if path is not None:
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    if data is not None:
        raw.update(data)

    cfg = Config()
    known = {f.name: f for f in fields(cfg)}
    unknown = []
    for key, value in raw.items():
        if key not in known:
            unknown.append(key)
            continue
        if value is None:
            continue
        current = getattr(cfg, key)
        if key == "veneur_metrics_scopes" and isinstance(value, dict):
            setattr(cfg, key, MetricsScopes(**value))
        elif key == "signalfx_per_tag_api_keys":
            setattr(cfg, key, [PerTagApiKey(**v) for v in value])
        elif key == "datadog_exclude_tags_prefix_by_prefix_metric":
            setattr(cfg, key,
                    [ExcludeTagsPrefixByPrefixMetric(**v) for v in value])
        else:
            setattr(cfg, key, _coerce(value, current, key))
    if unknown:
        msg = f"unknown config keys: {sorted(unknown)}"
        if strict:
            raise ValueError(msg)
        log.warning(msg)

    env = os.environ if env is None else env
    for name in known:
        for candidate in (
            "VENEUR_" + name.upper(),
            "VENEUR_" + name.upper().replace("_", ""),
        ):
            if candidate in env:
                setattr(
                    cfg, name, _coerce(env[candidate], getattr(cfg, name), name)
                )
                break

    # deprecated-alias fixups (reference config_parse.go:172-183)
    if cfg.ssf_buffer_size != Config.ssf_buffer_size:
        log.warning("ssf_buffer_size has been replaced by"
                    " datadog_span_buffer_size")
        if cfg.datadog_span_buffer_size == Config.datadog_span_buffer_size:
            cfg.datadog_span_buffer_size = cfg.ssf_buffer_size
    if cfg.flush_max_per_body != Config.flush_max_per_body:
        log.warning("flush_max_per_body has been replaced by"
                    " datadog_flush_max_per_body")
        if (cfg.datadog_flush_max_per_body
                == Config.datadog_flush_max_per_body):
            cfg.datadog_flush_max_per_body = cfg.flush_max_per_body

    validate_config(cfg)
    return cfg


def resolve_reader_shards(cfg: Config) -> int:
    """Effective reader-shard count for this process.

    VENEUR_READER_SHARDS overrides the config key (same escape-hatch
    idiom as VENEUR_SERIES_SHARDS, ops/series_shard.py): =0 pins the
    legacy digest-routed path. -1 (auto) resolves to num_readers when
    the shared-nothing layout applies — native ingest + native readers
    on, a single worker (the canonical row space is that worker's
    directory), and more than one reader to shard. Incompatible
    explicit requests degrade to 0 with a warning rather than failing
    ingest."""
    value = cfg.reader_shards
    env = os.environ.get("VENEUR_READER_SHARDS")
    if env is not None:
        try:
            value = int(env)
        except ValueError:
            log.warning("VENEUR_READER_SHARDS=%r is not an integer;"
                        " using reader_shards=%d", env, value)
    if value == 0:
        return 0
    if not (cfg.tpu_native_ingest and cfg.tpu_native_readers):
        if value > 0:
            log.warning("reader_shards=%d needs tpu_native_ingest and"
                        " tpu_native_readers; using the legacy path",
                        value)
        return 0
    if cfg.num_workers != 1:
        if value > 0:
            log.warning("reader_shards=%d requires num_workers: 1 (the"
                        " canonical row space is the single worker's"
                        " directory); using the legacy digest-routed"
                        " path", value)
        return 0
    if cfg.tpu_mesh_devices > 1:
        if value > 0:
            log.warning("reader_shards=%d is incompatible with the"
                        " global tier's mesh; using the legacy path",
                        value)
        return 0
    if value == -1:
        return cfg.num_readers if cfg.num_readers > 1 else 0
    return value


def validate_config(cfg: Config) -> None:
    parse_duration(cfg.interval)  # raises on nonsense
    if cfg.interval_seconds() <= 0:
        raise ValueError("interval must be positive")
    for p in cfg.percentiles:
        if not (0 <= p <= 1):
            raise ValueError(f"percentile {p} out of [0,1]")
    if cfg.num_workers < 1 or cfg.num_readers < 1:
        raise ValueError("num_workers and num_readers must be >= 1")
    if cfg.forward_format not in ("veneurtpu", "forwardrpc", "jsonmetric"):
        raise ValueError("forward_format must be 'veneurtpu', 'forwardrpc'"
                         " or 'jsonmetric'")
    if cfg.forward_format == "forwardrpc" and not cfg.forward_use_grpc:
        raise ValueError("forward_format: forwardrpc requires"
                         " forward_use_grpc: true")
    if cfg.forward_format == "jsonmetric" and cfg.forward_use_grpc:
        raise ValueError("forward_format: jsonmetric is the legacy HTTP"
                         " body; set forward_use_grpc: false")
    # sharded proxy tier: the multi-destination spread rides the
    # native-wire gRPC path only (spread.py sends serialized MetricBatch
    # bytes per lane; the HTTP and forwardrpc interop forwarders stay
    # single-destination)
    multi_dest = (bool(cfg.forward_discovery_file)
                  or len(cfg.forward_destinations()) > 1)
    if multi_dest and not cfg.forward_use_grpc:
        raise ValueError("a proxy fleet (forward_discovery_file or a"
                         " comma-separated forward_address) requires"
                         " forward_use_grpc: true")
    if multi_dest and cfg.forward_format != "veneurtpu":
        raise ValueError("a proxy fleet requires forward_format:"
                         " veneurtpu (interop forwarders are"
                         " single-destination)")
    if cfg.forward_spread_policy not in ("p2c", "round_robin"):
        raise ValueError("forward_spread_policy must be 'p2c' or"
                         " 'round_robin'")
    if cfg.forward_retry_max < 0:
        raise ValueError("forward_retry_max must be >= 0 (0 means one"
                         " attempt, no retries)")
    if cfg.forward_breaker_threshold < 0:
        raise ValueError("forward_breaker_threshold must be >= 0"
                         " (0 disables the circuit breaker)")
    if cfg.forward_spill_max_bytes < 0 or cfg.forward_spill_max_payloads < 0:
        raise ValueError("forward spill caps must be >= 0 (0 drops"
                         " failed payloads instead of spilling them)")
    parse_duration(cfg.forward_discovery_interval)  # raises on nonsense
    if cfg.tpu_mesh_devices > 1 and cfg.num_workers != 1:
        raise ValueError(
            "tpu_mesh_devices requires num_workers: 1 (the mesh shards"
            " series; in-process worker sharding would double it)")
    if cfg.tpu_mesh_devices > 1 and cfg.tpu_mesh_hosts:
        if cfg.tpu_mesh_devices % cfg.tpu_mesh_hosts:
            raise ValueError("tpu_mesh_devices must be divisible by"
                             " tpu_mesh_hosts")
    if cfg.series_shards < 0:
        raise ValueError("series_shards must be >= 0 (0/1 disable"
                         " series sharding)")
    if cfg.series_shards > 1:
        s = cfg.series_shards
        if s & (s - 1):
            raise ValueError("series_shards must be a power of two (the"
                             " row interleave needs shards | pool rows,"
                             " and pool sizes are powers of two)")
        if s > 1024:
            raise ValueError("series_shards must be <= 1024 (chunked"
                             " extraction aligns chunk starts to the"
                             " shard count, floored at 1024 rows)")
        if cfg.tpu_mesh_devices > 1:
            raise ValueError(
                "series_shards and tpu_mesh_devices are mutually"
                " exclusive: the global tier's mesh owns the device"
                " layout; a worker cannot also shard its pools over it")
    if cfg.reader_shards < -1:
        raise ValueError("reader_shards must be >= -1 (-1 auto, 0"
                         " disables reader sharding)")
    if cfg.reader_shards > 256:
        raise ValueError("reader_shards must be <= 256 (each shard is a"
                         " full native context; hundreds of readers"
                         " should be split across processes)")
    if cfg.set_hash not in ("fnv", "metro"):
        raise ValueError("set_hash must be 'fnv' or 'metro'")
    if cfg.tpu_set_store not in ("staged", "dense"):
        raise ValueError("tpu_set_store must be 'staged' or 'dense'")
    if not (4 <= cfg.tpu_hll_precision <= 18):
        raise ValueError("tpu_hll_precision must be in [4,18]")
    if cfg.flush_chunk_target_ms < 0:
        raise ValueError("flush_chunk_target_ms must be >= 0"
                         " (0 disables chunked extraction)")
    if (cfg.flush_chunk_target_ms
            and cfg.flush_chunk_target_ms >= cfg.interval_seconds() * 1000):
        raise ValueError("flush_chunk_target_ms must be below the flush"
                         " interval (a chunk IS a sub-interval unit)")
    if cfg.flush_pipeline_backlog < 1:
        raise ValueError("flush_pipeline_backlog must be >= 1 (a stage"
                         " needs at least the in-progress interval)")
    if cfg.flush_timeout_s <= 0:
        raise ValueError("flush_timeout_s must be positive (it is the"
                         " per-attempt network timeout)")
    if cfg.sink_retry_max < 0:
        raise ValueError("sink_retry_max must be >= 0 (0 means one"
                         " attempt, no retries)")
    if cfg.sink_breaker_threshold < 0:
        raise ValueError("sink_breaker_threshold must be >= 0"
                         " (0 disables the circuit breaker)")
    if cfg.sink_spill_max_bytes < 0 or cfg.sink_spill_max_payloads < 0:
        raise ValueError("sink spill caps must be >= 0 (0 drops failed"
                         " payloads instead of spilling them)")
    _validate_journal_keys(cfg)
    _validate_dedup_keys(cfg)
    _validate_stream_keys(cfg)
    if cfg.config_reload_s < 0:
        raise ValueError("config_reload_s must be >= 0 (0 disables the"
                         " config hot-reload watcher)")
    if cfg.forward_statsd_network not in ("udp", "tcp"):
        raise ValueError("forward_statsd_network must be 'udp' or 'tcp'")
    if cfg.tpu_stage_depth < 1:
        raise ValueError("tpu_stage_depth must be >= 1")
    if cfg.tpu_spill_cap < 1:
        raise ValueError("tpu_spill_cap must be >= 1")
    if cfg.micro_fold_rows < 1:
        raise ValueError("micro_fold_rows must be >= 1")
    if cfg.micro_fold_max_age_s <= 0:
        raise ValueError("micro_fold_max_age_s must be positive (it is"
                         " the staged-backlog age that forces a drain)")
    if cfg.device_fault_streak < 1:
        raise ValueError("device_fault_streak must be >= 1 (the"
                         " consecutive-fault count that trips the"
                         " device breaker)")
    if cfg.device_probe_interval_s <= 0:
        raise ValueError("device_probe_interval_s must be positive (it"
                         " paces re-admission probes while the device"
                         " path is quarantined)")
    if not (1 <= cfg.loadgen_num_keys <= (1 << 24)):
        raise ValueError("loadgen_num_keys must be in [1, 2^24]")
    if cfg.loadgen_zipf_s < 0:
        raise ValueError("loadgen_zipf_s must be >= 0")
    if (len(cfg.loadgen_type_mix) != 5
            or any(w < 0 for w in cfg.loadgen_type_mix)
            or sum(cfg.loadgen_type_mix) <= 0):
        raise ValueError("loadgen_type_mix must be 5 non-negative weights"
                         " ({c,g,ms,h,s} order) with a positive sum")
    if not (0 <= cfg.loadgen_num_tags <= 16):
        raise ValueError("loadgen_num_tags must be in [0,16]")
    if cfg.loadgen_tag_cardinality < 1:
        raise ValueError("loadgen_tag_cardinality must be >= 1")
    if not (64 <= cfg.loadgen_datagram_bytes <= 65507):
        raise ValueError("loadgen_datagram_bytes must be in [64,65507]"
                         " (a UDP datagram)")
    if cfg.loadgen_ring_lines < 1:
        raise ValueError("loadgen_ring_lines must be >= 1")
    if not cfg.loadgen_prefix or cfg.loadgen_prefix[0] in "0123456789":
        raise ValueError("loadgen_prefix must be a valid metric name stem")
    if not (1 <= cfg.loadgen_tenant_count <= 4096):
        raise ValueError("loadgen_tenant_count must be in [1, 4096]")
    if not (0.0 <= cfg.loadgen_tenant_abusive_frac <= 1.0):
        raise ValueError("loadgen_tenant_abusive_frac must be in [0,1]")
    if cfg.loadgen_tenant_zipf_s < 0:
        raise ValueError("loadgen_tenant_zipf_s must be >= 0")
    if cfg.loadgen_tenant_churn_keys < 0:
        raise ValueError("loadgen_tenant_churn_keys must be >= 0")
    if not cfg.tenant_tag_key:
        raise ValueError("tenant_tag_key must be non-empty")
    if cfg.tenant_default_budget < 0:
        raise ValueError("tenant_default_budget must be >= 0 (0 disables"
                         " the tenant QoS layer)")
    if not isinstance(cfg.tenant_budgets, dict) or any(
            not isinstance(k, str) or int(v) < 0
            for k, v in cfg.tenant_budgets.items()):
        raise ValueError("tenant_budgets must map tenant name → series"
                         " budget >= 0 (0 = unlimited for that tenant)")
    if not (1 <= cfg.tenant_sketch_depth <= 8):
        raise ValueError("tenant_sketch_depth must be in [1,8]")
    w = cfg.tenant_sketch_width
    if not (64 <= w <= (1 << 20)) or (w & (w - 1)):
        raise ValueError("tenant_sketch_width must be a power of two"
                         " in [64, 2^20] (the sketch hash masks, never"
                         " mods)")
    if not (1 <= cfg.tenant_topk <= 1024):
        raise ValueError("tenant_topk must be in [1,1024]")
    if cfg.span_flush_drain_s < 0:
        raise ValueError("span_flush_drain_s must be >= 0 (0 skips the"
                         " lane drain entirely; spans accepted late ship"
                         " next flush)")
    if cfg.span_batch_rows < 1:
        raise ValueError("span_batch_rows must be >= 1")
    if cfg.span_pending_cap < 1:
        raise ValueError("span_pending_cap must be >= 1")
    if cfg.kafka_span_serialization_format not in (
            "protobuf", "json", "columnar"):
        raise ValueError("kafka_span_serialization_format must be"
                         " 'protobuf', 'json' or 'columnar' (columnar"
                         " ships one VSB1 frame per sealed span batch"
                         " through the delivery manager)")
    _validate_archive_keys(cfg)
    _validate_query_keys(cfg)


def _validate_archive_keys(cfg) -> None:
    if cfg.archive_max_bytes < 1:
        raise ValueError("archive_max_bytes must be >= 1 (a segment must"
                         " be able to hold at least one byte; rotation"
                         " is checked per-frame, not mid-frame)")
    if cfg.archive_max_segments < 1:
        raise ValueError("archive_max_segments must be >= 1 (the archive"
                         " keeps at least the active segment)")
    if cfg.archive_blob_bucket and not cfg.archive_blob_access_key:
        raise ValueError("archive_blob_bucket requires"
                         " archive_blob_access_key (+ secret); the blob"
                         " egress signs every PUT with SigV4")
    if cfg.archive_blob_access_key and not cfg.archive_blob_secret_key:
        raise ValueError("archive_blob_access_key requires"
                         " archive_blob_secret_key")


def _validate_query_keys(cfg) -> None:
    for addr in cfg.query_listen_addrs:
        scheme, sep, hostport = addr.partition("://")
        if not sep or scheme not in ("http", "grpc"):
            raise ValueError(
                f"query_listen_addrs entry {addr!r} must be"
                " 'http://host:port' or 'grpc://host:port'")
        host, sep, port = hostport.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(
                f"query_listen_addrs entry {addr!r} needs host:port"
                " (port 0 binds ephemerally)")
