"""The H100 benchmark of the PyTorch/CUDA receiver (``liquid_usrp_tpu_torch``).

``python3 rxbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Cells, configurations, traffic mixes, entries and
per-layer metrics are files of their own, found by name (``manifest.py``).
"""
