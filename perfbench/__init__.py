"""The benchmark of the PyTorch port's cohort-selection service.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; see README.md.
"""
