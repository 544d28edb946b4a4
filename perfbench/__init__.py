"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

Run one cell with ``python3 perfbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``; ``BENCHMARK.json`` at the root of the repo
names the cells, their configurations and traffic, and the metrics.
Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<workload>.json``, ``drivers/<driver>.py``,
``layer_metrics/<metric>.py``, ``counts/`` and the plain references in
``reference/``.
"""
