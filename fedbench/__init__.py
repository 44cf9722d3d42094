"""fedbench: the benchmark of rayfed_tpu_torch's federated rounds on an NVIDIA card.

``python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once and prints one JSON line; see ``fedbench/README.md``.
"""
