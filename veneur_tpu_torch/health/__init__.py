"""Health policy, PyTorch port.

Only ``policy`` is here: the pure decision functions of the proxy tier
(``delivery_should_signal_behind``, ``routing_should_shed``) and of
elastic membership (``elastic_pressure_reasons``,
``elastic_scale_decision``), copied from veneur_tpu/health/policy.py.
The flush-deadline governor and the transfer ledger come with the
flush-side operations (ROADMAP §1 item 8).
"""
