"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), each
with its plain PyTorch version beside it: the chunk step and the HMMU
table gather of the emulator, and the flash attention, flash decode and
RWKV6 chunked-scan kernels behind ``ops``."""
