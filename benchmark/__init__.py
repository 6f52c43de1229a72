"""The serving benchmark of the PyTorch/CUDA port.

One run serves one cell (a model configuration under one traffic mix)
through the port's own HTTP server on one card and prints one JSON line:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one cell or one per-layer
metric is a file of its own, found by name:

- ``configs/<config>.json``: the published ``config.json`` keys, the
  quantization and the engine settings of the deployment;
- ``workloads/<cell>.json``: the traffic mix (loop, rate or clients,
  length distributions, sampling, drain limit) and the correctness limit;
- ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` of one
  per-layer metric.

The yardstick lives here too: the traffic generator (``loadgen.py``), the
work and peak arithmetic (``work.py``), the device-trace reduction
(``devtrace.py``) and the plain float32 reference (``reference/``).
Nothing here imports JAX or the JAX package.
"""
