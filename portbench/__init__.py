"""The benchmark of ``skdownscale_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell (``workloads/<cell>.json``) and prints one
JSON line.  Everything a cell, a configuration, a traffic mix or a metric
needs is found by its name: ``workloads/``, ``configs/``, ``traffic/``,
``metrics/``, ``roofline/``, ``systems/``; ``reference/`` holds the plain
references that decide ``correct``.
"""
