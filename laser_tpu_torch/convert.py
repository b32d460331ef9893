"""Move laser_tpu trees into the port and back.

``params_from_numpy`` takes a laser_tpu tree whose leaves are NumPy arrays
(``jax.tree.map(np.asarray, tree)`` on the JAX side): a params pytree of
either model family (llama's rope tables and quantized ``{"q", "s"}`` /
``{"q4", "s4"}`` weights included), or an optimizer state, since tuples
map like lists: AdamW's ``(m, v)`` (``llama_train_init``,
``transformer_train_init``) or the mixed-precision ``(m, v, master)``
(``llama_train_init_mp``), so that a laser_tpu state taken across
continues laser_tpu's training in the port. It returns the same tree of
torch tensors, so laser_tpu and laser_tpu_torch compute the same function
on the same numbers. ``params_to_numpy`` goes the other way. ``packed_from_numpy``
turns laser_tpu's ``PackedMatrix`` (its ``.data`` as NumPy) into the
port's.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cuda", dtype=None):
    """dicts, lists and tuples map leaf by leaf; floating leaves are cast to
    ``dtype`` when it is given, except the f32 scales of a quantized weight,
    and integer leaves (int8 weights) keep their type. NumPy bfloat16
    leaves (as JAX exports them) arrive exactly, through float32. The
    tensors land on ``device``, the card unless the caller names another."""
    if isinstance(tree, dict):
        if "q" in tree or "q4" in tree:
            dtype = None
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


def params_to_numpy(tree):
    """The same tree with NumPy leaves on the host; bfloat16 tensors come
    back as exact float32 arrays (NumPy has no bfloat16 of its own)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def packed_from_numpy(data, rows: int, cols: int, block, operand: str, device="cuda"):
    """The port's ``PackedMatrix`` of laser_tpu's packed operand: ``data`` is
    its 4-D blocked array (``np.asarray(packed.data)``), the other fields
    its own; the bytes stay as they are (an int8 B on CUDA also gets its
    K-major twin, ``PackedMatrix.kmajor``, where its plan wants one)."""
    from .ops.gemm.prepacked import packed_matrix

    if operand not in ("A", "B"):
        raise ValueError(f"operand must be 'A' or 'B', got {operand!r}")
    t = params_from_numpy(data, device)
    if t.ndim != 4 or tuple(t.shape[2:]) != tuple(block):
        raise ValueError(f"packed data of shape {tuple(t.shape)} does not hold blocks {block}")
    return packed_matrix(t, int(rows), int(cols), tuple(int(b) for b in block), operand)
