"""The benchmark of `alchemy_tpu_torch` on one NVIDIA H100.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is `workloads/<cell>.json`: a configuration (`configs/<name>.json`,
the deployment with its moduli and guarantees) under a traffic mix
(`traffic/<name>.json`, the parameters of the one closed-loop generator in
`run.py`). The system under test is `systems/<config["system"]>.py`, which
drives the port's public entry; `reference.py` is the plain PyTorch
reference that decides `correct`; `roofline.py` holds the peaks and the
kernels' operation and byte counts; each per-layer metric is a reader of its
own, `metrics/<metric>.py`. The harness finds all of them by name, so a new
cell, configuration or metric is a new file. Nothing here imports JAX or the
JAX package, and the reference imports nothing of the port.
"""
