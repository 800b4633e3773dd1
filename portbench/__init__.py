"""The benchmark of `aloha_tpu_torch` on NVIDIA GPUs: one cell at a time,

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations and metrics are named in the repository's
BENCHMARK.json; each has files of its own here: configurations under
`configs/`, traffic mixes under `workloads/`, request kinds under
`requests/` (the system's side), `reference/` (inputs, the plain reference
and the cleartext result) and `counts/` (the work a request needs), metric
readers under `metrics/`, kernel families under `kernels/`.
"""
