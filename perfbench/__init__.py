"""The benchmark of the PyTorch and CUDA port (``manga_ocr_tpu_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
result line.  Configurations, traffic mixes, traffic patterns, drivers of
the program's entry points and metrics are files of their own under this
folder, found by the names in ``BENCHMARK.json`` and in the mix files.
"""
