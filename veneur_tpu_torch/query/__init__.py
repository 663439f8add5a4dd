"""Live query subsystem: epoch-fenced reads over the flush's retained
device state, PyTorch port (copied from veneur_tpu/query/).

Between flush ticks every sketch stays resident on the device, but
without this package that state is readable only once per interval,
through the flush. The query subsystem turns the aggregation tier into a
queryable store:

* ``engine``  — QueryEngine: per-worker epoch views staged at the fence
  inside extract_snapshot, committed as ONE epoch by the server after
  every worker extracted (two-phase publish: no torn cross-worker reads)
* ``service`` — the gRPC front (veneurtpu.Query/Query, JSON over raw
  bytes, riding the distributed/rpc.py plumbing)
* ``http``    — the HTTP front: /metrics in Prometheus exposition text
  (the SAME renderer the exposition sink uses, sinks/exposition.py),
  /query for the JSON API, /healthz

Parity contract: a query at the flush quantile vector is bitwise
identical to what the flush itself read back, because the evaluator
runs the same flush extract (the kernel on the card) over the same
retained post-fold field tensors.
"""

from veneur_tpu_torch.query.engine import QueryEngine  # noqa: F401
