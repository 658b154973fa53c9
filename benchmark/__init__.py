"""The benchmark of metagraph_tpu_torch: one cell, one seed, one run.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; README.md says how cells, configurations, traffic mixes
and metrics are added as files.
"""
