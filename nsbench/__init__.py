"""The benchmark of navierstokes_parallel_tpu_torch on NVIDIA cards.

``python3 -m nsbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of BENCHMARK.json once.  Everything that
belongs to one configuration, traffic mix, layer, per-layer metric or work
count is a file of its own here (registry.py); the reference
(reference/cavity.py) imports nothing of the program.
"""
