"""The benchmark of ``repro_torch``: E2LSH on Storage on an NVIDIA H100.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything a cell
needs is found by name: its configuration (``configs/<config>.json``), the
tier that builds the program and may bring its own reference
(``tiers/<tier>.py``), its traffic mix (``traffic/<mix>.json``) and one
reader per metric (``metrics/<metric>.py``); a cell of more than one chip
runs a process a card (``ranks.py``). The yardstick (data and traffic
generation, the plain reference that decides ``correct``, the roofline
arithmetic and the trace reduction) lives here and imports nothing of the
program.
"""
