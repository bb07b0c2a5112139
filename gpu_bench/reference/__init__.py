"""Plain PyTorch references of the benchmark's models and optimizer: one
file per architecture, float32 (TF32 off), no kernels, no cache, no
batching.  They import nothing of the port and take only the inputs and
weights the benchmark makes."""

import importlib


def module(name: str):
    """The reference module of an architecture, by its file name."""
    return importlib.import_module(f"{__name__}.{name}")
