"""Health policy and the flush governor, PyTorch port.

``policy``: the pure decision functions of the proxy tier
(``delivery_should_signal_behind``, ``routing_should_shed``), of elastic
membership (``elastic_pressure_reasons``, ``elastic_scale_decision``)
and of the tenant-aware spill shed (``shed_spill_keep``), copied from
veneur_tpu/health/policy.py. ``governor``: ``FlushDeadlineGovernor``,
copied from veneur_tpu/health/governor.py; the port wires only its
per-tenant shed attribution (``note_tenant_shed``,
``tenant_shed_counts``). Chunked extraction (``flush_chunk_target_ms``),
its beats and the watchdog, and the transfer ledger come with the
flush-side operations (ROADMAP §1 item 8); ``ledger`` is not here (the
JAX one imports ``jax.numpy``).
"""

from veneur_tpu_torch.health.governor import ChunkRun, FlushDeadlineGovernor

__all__ = ["ChunkRun", "FlushDeadlineGovernor"]
