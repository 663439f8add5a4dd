"""Wire-rate load generation, capture and replay for the port's server.

The C++ half (native/loadgen.cpp, bound in veneur_tpu_torch.native) owns
the per-packet work: ring synthesis from a declarative workload spec,
paced sending with absolute deadlines, and datagram capture for bit-exact
replay. This package owns orchestration: the workload spec
(spec.WorkloadSpec), the in-process server harness, and the closed-loop
sustained-rate search (controller.search_sustained, driven by
tools/port_bench_sustained.py).
"""

from veneur_tpu_torch.loadgen.spec import WorkloadSpec  # noqa: F401
from veneur_tpu_torch.loadgen.controller import (  # noqa: F401
    LoadHarness, run_trial, search_sustained)
