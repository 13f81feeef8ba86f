"""The benchmark of ``snappy_tpu_torch``, the PyTorch and CUDA port:
Silesia-mix loads and saves through its framed device entry points
(``python3 -m portbench --help``).  It imports nothing of the JAX
package and reads nothing of its bench."""
