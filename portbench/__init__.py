"""portbench: the benchmark of eval_driving_safety_tpu_torch on one H100.

`python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`; BENCHMARK.json at the repository root lists the cells.
"""
