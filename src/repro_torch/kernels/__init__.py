"""Hand-written Hopper kernels and their plain PyTorch versions.

``ops`` dispatches by the tensors' device: the plain version in ``ref``
for CPU tensors, the CUDA kernel in ``paged_decode`` for CUDA tensors.
"""
