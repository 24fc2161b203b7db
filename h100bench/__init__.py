"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
NVIDIA H100: ``python h100bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once (see ``harness``)."""
