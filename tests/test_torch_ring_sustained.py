"""The port's ring sustained-rate tool (tools/port_bench_ring_sustained.py)
on the CPU.

* ``search_ring_sustained`` makes the JAX tool's decisions: on a scripted
  harness whose trial passes below a cliff (and, in one case, fails its
  first confirmations), both searches ask for the same trials in the
  same order (growth, bisection, confirmation) and return the same
  record.
* One ``--smoke`` trial at a low rate through the port's ring (a
  ForwardClient sender, a proxy, three port globals over real gRPC):
  exact conservation after the drain and 0 duplicates, the stream
  engaged, no kernel launched (global counters only), and the payload's
  keys the JAX tool's plus the port's added ones, each tool's smoke run
  once at the same settings. Neither run's pass (a paced rate's
  attainment) is gated here.
* ``ProxyServer.cpu_seconds``'s thread reading falls back to the
  thread's ``stat`` ticks where schedstat is missing.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import bench_ring_sustained as jring  # noqa: E402
import port_bench_ring_sustained as tring  # noqa: E402


class _Scripted:
    """A harness whose trial at ``rate`` passes while the rate is at most
    ``cliff``; the first ``confirm_fails`` trials of the confirmation
    length fail whatever the rate."""

    def __init__(self, cliff: float, confirm_intervals: int,
                 confirm_fails: int = 0) -> None:
        self.cliff = cliff
        self.confirm_intervals = confirm_intervals
        self.confirm_fails = confirm_fails
        self.calls: list = []

    def run_trial(self, rate, n_intervals, max_loss=0.005,
                  min_attain=0.9):
        self.calls.append((rate, n_intervals, max_loss))
        passed = rate <= self.cliff
        if n_intervals == self.confirm_intervals and self.confirm_fails:
            self.confirm_fails -= 1
            passed = False
        got = min(rate, self.cliff)
        return {"offered_metrics_per_s": rate, "ingested_total": got * 3,
                "send_duration_s": 3.0, "ring_metrics_per_s": got,
                "loss_frac": 0.0 if passed else 0.1, "attain_frac": 1.0,
                "duplicates_observed": 0, "conservation_exact": True,
                "proxy_tier_capacity_metrics_per_s": 2.0 * got,
                "passed": passed}


@pytest.mark.parametrize("cliff,confirm_fails", [
    (1e5, 0),      # growth, then bisection inside the bracket
    (2.5e4, 0),    # the first growth step fails
    (1e4, 0),      # below the start rate: the bracket from hi / 4
    (5e6, 0),      # past the maximum: growth stops at max_rate
    (1e5, 2),      # the confirmation falls back by 0.9 twice
    (1e5, 3),      # and gives up unconfirmed
])
def test_search_makes_the_jax_tools_decisions(cliff, confirm_fails,
                                              capsys):
    kw = dict(start_rate=2e4, max_rate=2e6, trial_intervals=3,
              confirm_intervals=6, bisect_steps=4, max_loss=0.005)
    hj = _Scripted(cliff, 6, confirm_fails)
    ht = _Scripted(cliff, 6, confirm_fails)
    rj = jring.search_ring_sustained(hj, **kw)
    rt = tring.search_ring_sustained(ht, **kw)
    assert ht.calls == hj.calls
    assert len(ht.calls) > 2
    assert json.dumps(rt, sort_keys=True) == json.dumps(rj, sort_keys=True)
    assert rt["confirmed"] == (confirm_fails < 3)
    capsys.readouterr()


def _smoke(mod, monkeypatch, tmp_path, name: str, extra: list) -> dict:
    monkeypatch.setenv("VENEUR_ARTIFACT_DIR", str(tmp_path))
    argv = ["--smoke", "--rate", "2000", "--interval-s", "0.5",
            "--intervals", "2", "--senders", "2", "--out", name] + extra
    monkeypatch.setattr(sys, "argv", ["tool"] + argv)
    try:
        mod.main(argv) if mod is tring else mod.main()
    except SystemExit as e:  # a missed attainment exits 1
        assert e.code in (None, 0, 1)
    return json.loads((tmp_path / name).read_text())


def test_smoke_trial_conserves_exactly_with_no_duplicates(tmp_path,
                                                         monkeypatch):
    port = _smoke(tring, monkeypatch, tmp_path, "port_smoke.json",
                  ["--device", "cpu"])
    assert port["conservation_exact"] is True
    assert port["duplicates_observed"] == 0
    assert port["stream_engaged"] is True
    assert port["launches"] == dict.fromkeys(
        ("K1", "K2a", "K2b", "K3", "K4", "K5"), 0)
    assert port["platform"] == "cpu" and port["device"] == "cpu"
    proxied = sum(p["proxied_metrics"] for p in port["per_proxy"].values())
    assert proxied > 0
    # the JAX tool's smoke lane at the same settings: the port's payload
    # has its keys plus the three added ones
    monkeypatch.setattr(jring, "_reexec_scrubbed", lambda: None)
    ref = _smoke(jring, monkeypatch, tmp_path, "jax_smoke.json", [])
    assert ref["conservation_exact"] is True
    assert set(port) == set(ref) | {"device", "cores", "launches"}


def test_proxy_cpu_seconds_reads_stat_where_schedstat_is_missing(
        monkeypatch):
    """The capacity metric's CPU attribution (``ProxyServer.cpu_seconds``)
    on a kernel without schedstats: the thread's ``stat`` ticks, within
    two ticks of its schedstat on a kernel that has both."""
    import builtins
    import threading
    import time

    from veneur_tpu_torch.distributed import proxy

    tid = threading.get_native_id()
    t_end = time.thread_time() + 0.3
    while time.thread_time() < t_end:
        pass
    real_open = builtins.open
    first = proxy.thread_cpu_ns(tid)

    def no_schedstat(path, *a, **kw):
        if str(path).endswith("/schedstat"):
            raise FileNotFoundError(path)
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", no_schedstat)
    ticks = proxy.thread_cpu_ns(tid)
    monkeypatch.undo()
    assert first is not None and ticks is not None
    assert ticks >= 2e8
    assert abs(ticks - first) <= 2 * 1e9 / os.sysconf("SC_CLK_TCK") + 5e7
    assert proxy.thread_cpu_ns(2 ** 22 + 12345) is None
