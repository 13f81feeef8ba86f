"""Device kernels of the port: each module holds a hand-written CUDA
kernel (``csrc/``), its wrapper and its plain PyTorch version."""
