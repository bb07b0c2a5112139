"""PyTorch/CUDA port of the MURS serving system.

Grows beside the JAX package, module for module: ``configs``, ``core``,
``sched`` and the serve bookkeeping are copies; ``kernels`` holds the
hand-written Hopper kernels with their plain PyTorch versions; ``models``
and ``serve.engine`` run on torch tensors on an explicit device.
"""
