"""hulkbench: the benchmark of hulk_tpu_torch, the PyTorch/CUDA port of
hulk, on one H100. `python3 -m hulkbench --help`; hulkbench/run.py says
what a run does."""
