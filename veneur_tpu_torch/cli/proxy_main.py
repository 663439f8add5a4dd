"""veneur-tpu-proxy: the consistent-hash proxy tier binary.

Parity: reference cmd/veneur-proxy/main.go:20-58 — reads the proxy config,
starts the gRPC proxy with Consul/Kubernetes discovery (or a static
forward address), and refreshes destinations periodically.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from veneur_tpu_torch.core.config import load_proxy_config, parse_duration
from veneur_tpu_torch.distributed.proxy import (
    DestinationRefresher,
    ProxyHTTPServer,
    ProxyRuntimeReporter,
    ProxyServer,
    TraceProxy,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="veneur-tpu-proxy")
    parser.add_argument("-f", dest="config", required=True)
    parser.add_argument("-validate-config", action="store_true",
                        dest="validate")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    log = logging.getLogger("veneur_tpu_torch.proxy-main")

    try:
        cfg = load_proxy_config(args.config)
    except Exception as e:
        print(f"config invalid: {e}", file=sys.stderr)
        return 1
    if args.validate:
        print("config valid")
        return 0
    if cfg.debug:
        logging.getLogger().setLevel(logging.DEBUG)

    # this proxy forwards downstream over one (gRPC) ring, so the
    # reference's separate HTTP and gRPC forward rings (proxy.go:163-166,
    # 184-187) unify. A DIFFERING pair of static addresses is rejected
    # at validation (validate_proxy_config) — by here at most one
    # distinct address survives.
    static = list(dict.fromkeys(
        a for a in (cfg.forward_address, cfg.grpc_forward_address) if a))
    forward_service = (cfg.consul_forward_service_name
                       or cfg.consul_forward_grpc_service_name)
    accepting_forwards = bool(static or forward_service
                              or cfg.kubernetes_forward_service_name
                              or cfg.elastic_membership_file)
    accepting_traces = bool(cfg.trace_address
                            or cfg.consul_trace_service_name)
    if not accepting_forwards and not accepting_traces:
        # reference proxy.go:190-199: refusing to start with no discovery
        # service names and no static addresses is an error, not a warning
        print("refusing to start with no discovery service names or"
              " static addresses in config", file=sys.stderr)
        return 1
    if not accepting_forwards:
        log.warning("no forward destinations configured: the forward "
                    "endpoints will drop every batch (trace proxying "
                    "only)")

    idle_s = (parse_duration(cfg.idle_connection_timeout)
              if cfg.idle_connection_timeout else 0.0)
    from veneur_tpu_torch.sinks.delivery import DeliveryPolicy

    timeout_s = parse_duration(cfg.forward_timeout)
    policy = DeliveryPolicy(
        retry_max=cfg.forward_retry_max,
        breaker_threshold=cfg.forward_breaker_threshold,
        spill_max_bytes=cfg.forward_spill_max_bytes,
        spill_max_payloads=cfg.forward_spill_max_payloads,
        timeout_s=min(timeout_s, cfg.handoff_window_s),
        deadline_s=cfg.handoff_window_s)
    journal = None
    if cfg.spill_journal_dir:
        from veneur_tpu_torch.utils.journal import SpillJournal

        journal = SpillJournal(
            cfg.spill_journal_dir,
            fsync=cfg.spill_journal_fsync,
            max_bytes=cfg.spill_journal_max_bytes,
            max_segments=cfg.spill_journal_max_segments,
            log=log.warning)
    proxy = ProxyServer(static,
                        timeout_s=timeout_s,
                        idle_timeout_s=idle_s,
                        max_idle_conns=cfg.max_idle_conns,
                        delivery=policy,
                        routing_workers=cfg.routing_pool_workers,
                        routing_queue_max=cfg.routing_queue_max,
                        handoff_window_s=cfg.handoff_window_s,
                        journal=journal,
                        dedup=cfg.forward_dedup,
                        streaming=cfg.forward_streaming,
                        stream_window=cfg.forward_stream_window,
                        stream_adaptive=getattr(
                            cfg, "forward_stream_adaptive", True),
                        stream_window_min=getattr(
                            cfg, "forward_stream_window_min", 1),
                        stream_window_max=getattr(
                            cfg, "forward_stream_window_max", 128))
    if journal is not None:
        # re-route the previous incarnation's durable spill under the
        # current ring before accepting fresh traffic
        rec = proxy.recover_journal()
        if rec["recovered_payloads"]:
            log.info("journal recovery: %s", rec)
    address = cfg.grpc_address or "127.0.0.1:8128"
    port = proxy.start_grpc(address)
    log.info("proxy serving gRPC on %s (port %s)", address, port)

    trace_proxy = None
    if cfg.trace_address or cfg.consul_trace_service_name:
        if cfg.http_address:
            trace_proxy = TraceProxy(
                [cfg.trace_address] if cfg.trace_address else [])
        else:
            # /spans over the HTTP front is the only ingest path into the
            # trace ring; without it the pipeline would be silently dead
            log.warning("trace_address/consul_trace_service_name configured"
                        " but http_address is not: trace proxying disabled"
                        " (spans arrive via POST /spans on http_address)")

    http_front = None
    if cfg.http_address:
        from veneur_tpu_torch.utils.http import parse_host_port

        host, hport = parse_host_port(cfg.http_address, what="http_address")
        http_front = ProxyHTTPServer(proxy, trace_proxy=trace_proxy)
        http_front.start(host, hport)
        log.info("proxy serving HTTP on %s", cfg.http_address)

    refresher = None
    trace_refresher = None
    if cfg.consul_trace_service_name and trace_proxy is not None:
        from veneur_tpu_torch.distributed.discovery import ConsulDiscoverer

        trace_refresher = DestinationRefresher(
            trace_proxy, ConsulDiscoverer(cfg.consul_url),
            cfg.consul_trace_service_name,
            parse_duration(cfg.consul_refresh_interval))
        trace_refresher.start()
    if (cfg.consul_forward_service_name
            and cfg.consul_forward_grpc_service_name
            and cfg.consul_forward_grpc_service_name != forward_service):
        log.warning("consul_forward_grpc_service_name %r ignored: this "
                    "proxy routes HTTP and gRPC forwards over one ring, "
                    "discovered from consul_forward_service_name %r",
                    cfg.consul_forward_grpc_service_name, forward_service)
    controller = None
    if cfg.elastic_membership_file:
        # elastic tier: watchable file membership, health-gated through
        # the refresher (consul/k8s answers are already health-filtered
        # upstream; the file is raw desired state, so the gate probes)
        from veneur_tpu_torch.distributed.discovery import FileWatchDiscoverer
        from veneur_tpu_torch.distributed.elastic import (
            ElasticController,
            HealthGate,
            ProxyPressureSource,
        )

        watcher = FileWatchDiscoverer(cfg.elastic_membership_file)
        gate = HealthGate(
            proxy,
            probe_timeout_s=cfg.elastic_probe_timeout_s,
            quarantine_after=cfg.elastic_quarantine_intervals,
            min_admitted=cfg.elastic_min_members)
        refresher = DestinationRefresher(
            proxy, watcher, "",
            parse_duration(cfg.consul_refresh_interval), gate=gate)
        if cfg.elastic_autoscale:
            psource = ProxyPressureSource(proxy)
            controller = ElasticController(
                watcher, psource,
                hysteresis_k=cfg.elastic_hysteresis_intervals,
                cooldown_s=cfg.elastic_cooldown_s,
                min_members=cfg.elastic_min_members,
                max_members=cfg.elastic_max_members,
                drained_fn=proxy.destination_idle,
                member_load_fn=psource.member_load)
    elif forward_service:
        from veneur_tpu_torch.distributed.discovery import ConsulDiscoverer

        refresher = DestinationRefresher(
            proxy, ConsulDiscoverer(cfg.consul_url),
            forward_service,
            parse_duration(cfg.consul_refresh_interval))
    elif cfg.kubernetes_forward_service_name:
        from veneur_tpu_torch.distributed.discovery import KubernetesDiscoverer

        refresher = DestinationRefresher(
            proxy, KubernetesDiscoverer(namespace=cfg.kubernetes_namespace),
            cfg.kubernetes_forward_service_name,
            parse_duration(cfg.consul_refresh_interval))
    if refresher is not None:
        refresher.start()
    if controller is not None:
        controller.start(cfg.elastic_observe_interval_s)

    fleet_controller = None
    if cfg.fleet_membership_file and cfg.fleet_autoscale:
        # elastic PROXY tier: this proxy observes its own fan-in
        # pressure (admission timeouts, stream window stalls, routing
        # sheds/depth) and writes the desired proxy member set back
        # through the shared fleet file every local-tier sender watches
        # via forward_discovery_file. Exactly one proxy per fleet should
        # arm this. No drained_fn: a demoted proxy keeps draining its
        # own spill toward the globals after it leaves the fleet file —
        # senders simply stop picking it.
        from veneur_tpu_torch.distributed.discovery import FileWatchDiscoverer
        from veneur_tpu_torch.distributed.elastic import (
            ElasticController,
            ProxyTierPressureSource,
        )

        fleet_watcher = FileWatchDiscoverer(cfg.fleet_membership_file)
        tier_source = ProxyTierPressureSource(
            lambda: {address: proxy.forward_stats()})
        fleet_controller = ElasticController(
            fleet_watcher, tier_source,
            hysteresis_k=cfg.elastic_hysteresis_intervals,
            cooldown_s=cfg.elastic_cooldown_s,
            min_members=1,
            max_members=cfg.elastic_max_members,
            member_load_fn=tier_source.member_load)
        fleet_controller.start(cfg.elastic_observe_interval_s)

    reporter = None
    if cfg.stats_address:
        from veneur_tpu_torch import scopedstatsd

        stats = scopedstatsd.ScopedClient(
            scopedstatsd.UDPSender(cfg.stats_address),
            namespace="veneur_proxy.")
        reporter = ProxyRuntimeReporter(
            proxy, stats,
            interval_s=parse_duration(cfg.runtime_metrics_interval),
            trace_proxy=trace_proxy)
        reporter.start()

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    # graceful drain: bounded spill-settling passes before teardown —
    # whatever the deadline clips stays durable in the journal (when
    # configured) for the next incarnation's recover_journal
    if cfg.shutdown_drain_deadline_s > 0:
        import time as _time

        drain_deadline = _time.monotonic() + cfg.shutdown_drain_deadline_s
        while _time.monotonic() < drain_deadline:
            proxy.drain_spill(
                min(cfg.handoff_window_s,
                    max(0.05, drain_deadline - _time.monotonic())))
            if proxy.spilled_metrics <= 0:
                break
            _time.sleep(0.05)
        if proxy.spilled_metrics > 0:
            log.warning("shutdown drain deadline clipped: %d metric(s) "
                        "still spilled%s", proxy.spilled_metrics,
                        " (journaled for next start)" if journal is not None
                        else "")
    if reporter is not None:
        reporter.stop()
    if fleet_controller is not None:
        fleet_controller.stop()
    if controller is not None:
        controller.stop()
    if refresher is not None:
        refresher.stop()
    if trace_refresher is not None:
        trace_refresher.stop()
    if http_front is not None:
        http_front.stop()
    if trace_proxy is not None:
        trace_proxy.stop()
    proxy.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
