"""The benchmark of the PyTorch/CUDA port ``repro_torch``: ``python3
bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
Cells, configurations, traffic mixes, per-layer metrics, kernel rooflines,
plain references and input generators each sit in a file of their own,
found by the name that ``BENCHMARK.json`` gives them."""
