"""The benchmark of the PyTorch and CUDA port (``graphconvgeo_torch``) on one
NVIDIA H100: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``harness.py``)."""
