"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; ``BENCHMARK.json`` at the repository's
root names the cells, configurations and metrics.
"""
