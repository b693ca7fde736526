"""The benchmark of ``repro_torch``: E2LSH on Storage on an NVIDIA H100.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything a cell
needs is found by name: its configuration (``configs/<config>.json``), its
traffic mix (``traffic/<mix>.json``) and one reader per per-layer metric
(``metrics/<metric>.py``). The yardstick (data and traffic generation, the
plain reference that decides ``correct``, the roofline arithmetic and the
trace reduction) lives here and imports nothing of the program.
"""
