"""Hand-written Hopper kernels and their plain PyTorch versions.

``ops`` dispatches by the tensors' device: the plain version in ``ref``
for CPU tensors, the CUDA kernel for CUDA tensors (``paged_decode`` for
K1/K2, ``flash_attention`` for K3, ``decode_attention`` for K4,
``grouped_matmul`` for K5, ``ssd_scan`` for K6).
"""
