"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on the card.

``python3 ridgebench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; ``README.md``
says how a configuration, a traffic mix or a metric is added as files.
"""
