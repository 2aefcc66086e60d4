"""Distance-tile kernels for the NVIDIA H100.

tile_d2  — the masked Eq. (3) tile: plain PyTorch version and the
           hand-written CUDA kernel ``csrc/tile_d2.cu``
registry — the ``torch`` | ``cuda`` backend registry
build    — builds ``csrc/*.cu`` with nvcc at first use, loads via ctypes
common   — sliding stats, Eq. (3), the exclusion mask
"""
