"""The benchmark of ``audio_matcher_tpu_torch`` on NVIDIA GPUs.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, from the root of a checkout, runs one cell of
``BENCHMARK.json`` and prints one JSON line. Everything a cell uses is
found by name: its configuration in ``configs/<file>``, its traffic mix in
``traffic/<name>.json``, the driver that mix names in ``drivers/`` (the
contract a driver keeps: ``drivers/__init__.py``), and each metric's
reader in ``metrics/<metric>.py``.
"""
