"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once, from the root
of a checkout, and prints one JSON result line.  Everything a cell needs
is found by name: its configuration in ``configs/``, its traffic mix in
``traffic/``, the code of its traffic's kind in ``kinds/``, its limits
in ``limits/`` and each per-layer metric's reader in ``metrics/``.
``reference/`` is the plain float32 model that decides ``correct``.
"""
