"""veneur_tpu_torch: the PyTorch/CUDA port of veneur_tpu.

The same DogStatsD aggregation server, with its device programs written
as PyTorch tensor code and its hand-written kernels (the flush extract,
the HLL insert and estimate) in CUDA C++ for Hopper. The JAX package ``veneur_tpu`` stays the
reference; this package imports nothing of it and keeps its own copies
of the host-only modules it needs, at the same module paths.

Package layout:
  device.py     device selection (CUDA unless the caller asks for the CPU)
  ops/          exact-numerics scans, t-digest pool programs, the flush
                extract kernel wrapper and its plain version
  csrc/         CUDA C++ sources, built with nvcc at first use
  core/         metric model, series directory, device worker, flusher,
                config, server, factory
  protocol/     DogStatsD wire parsing
  ssf/          SSF sample model
  sinks/        channel, debug, blackhole and the metric network sinks
                (Datadog, SignalFx, Prometheus, forward-statsd, New
                Relic), the delivery layer
  utils/        hashing, device fault injection, HTTP helpers
  native.py     the native C++ ingest and emit library (native/)
  cli/          the server entry point
"""

__version__ = "0.1.0"
