"""Move laser_tpu parameter trees into the port.

``params_from_numpy`` takes a laser_tpu params pytree whose leaves are NumPy
arrays (``jax.tree.map(np.asarray, params)`` on the JAX side) and returns
the same tree of torch tensors, so laser_tpu and laser_tpu_torch compute the
same function on the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu", dtype=None):
    """dicts and lists map leaf by leaf; floating leaves are cast to ``dtype``
    when it is given. NumPy bfloat16 leaves (as JAX exports them) arrive
    exactly, through float32."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    target = None
    if arr.dtype.name == "bfloat16":
        arr, target = arr.astype(np.float32), torch.bfloat16
    # a copy: arrays exported from JAX are read-only, torch wants writable
    t = torch.from_numpy(np.array(arr, order="C")).to(device)
    if target is not None:
        t = t.to(target)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t
