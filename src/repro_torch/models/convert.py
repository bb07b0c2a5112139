"""Weight bridge: the JAX package's parameter tree, as numpy, onto torch.

The tree keeps its layout (scan-stacked ``layers`` leaves ``[reps, ...]``,
``b<i>`` keys, the ``suffix`` list).  bf16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` rejects: they
cross as their ``uint16`` bit pattern and are viewed back as bf16.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

def tensor_from_numpy(a, device: Union[str, torch.device]) -> torch.Tensor:
    """One numpy array (bf16 as ``ml_dtypes.bfloat16``) → tensor on device."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree: Any, device: Union[str, torch.device]) -> Any:
    """Map a numpy pytree (dicts, lists, tuples of arrays) onto tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)
