"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), each
with its plain PyTorch version beside it."""
