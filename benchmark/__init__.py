"""The benchmark of pygrid_tpu_torch: one command runs one cell once.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
reads the cell from ``BENCHMARK.json`` beside this folder and prints one
JSON line. Everything that belongs to one configuration, traffic mix, cell,
entry kind or per-layer metric sits in a file of its own here and is found
by name (see ``harness.py``).
"""
