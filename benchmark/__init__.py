"""The benchmark of jrr_tpu_torch (the PyTorch and CUDA port) on NVIDIA H100s.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json`; README.md says how cells, configurations,
traffic mixes and metrics are added as files. Nothing here imports JAX or
the JAX package; `reference/` imports nothing of the port either.
"""
