"""The benchmark of the PyTorch and CUDA port: ``python3 mmbench/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>``."""
