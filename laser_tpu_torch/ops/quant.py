"""int8 quantization and the quantized GEMM (port of laser_tpu/ops/quant.py:
``quantize_int8``, ``dequantize_int8``, ``gemm_quantized``).

``quantize_int8`` maps a (rows, cols) f32/bf16/f16 tensor to int8 ``q`` and
f32 scales, one per row ((rows, 1)) or one for the tensor ((1, 1)):
scale = max(amax, 1e-30) / 127, q = clip(round(v / scale), -127, 127),
half to even. ``v / scale`` is an IEEE f32 division, as laser_tpu's; the
division by the constant 127 is what XLA compiles laser_tpu's to, a
multiply by f32(1/127) (``INV_127``), so the scales match bit for bit. For a CUDA tensor
it launches the hand-written kernel (csrc/quantize.cu: one block per row;
the global scale from per-block amax partials in a first launch), for a
CPU tensor the plain version; both compute the same bits.

Stochastic rounding is floor(v / scale + u), u in [0, 1) the top 24 bits
of a splitmix64 hash of (seed, row * cols + col), computed alike by the
kernel and the plain version. laser_tpu takes its bits from the TPU's
hardware generator and rounds to nearest in interpret mode and in its
multi-block global branch; the port rounds stochastically whenever asked
(ROADMAP.md, queue 3).

``gemm_quantized`` quantizes A per row and B's columns (the rows of B^T,
seed + 1), runs the int8 GEMM kernel with ``transpose_b`` (int32
accumulator) and rescales: acc * sa * sb, in that order, in f32.

Replaces laser_tpu/ops/quant.py:29 _build_quantize. Bound on the H100:
bytes (each element read, one int8 written).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import registry
from .gemm import gemm
from .sampling import _GOLDEN, _i64, _mix, _srl

QUANTIZE = registry.kernel("quantize_int8", "laser_tpu_torch/csrc/quantize.cu",
                           "laser_tpu/ops/quant.py:29 _build_quantize")

# csrc/quantize.cu MAX_PARTIALS: the global scale's amax partials
MAX_PARTIALS = 1024
# f32(1) / f32(127): XLA folds laser_tpu's amax / 127.0 into amax * (1 / 127)
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def stochastic_noise(seed: int, rows: int, cols: int, device) -> torch.Tensor:
    """(rows, cols) f32 in [0, 1): entry (r, c) the top 24 bits of
    splitmix64(key + (r * cols + c + 1) * golden), key = splitmix64(seed +
    golden), in wrapping int64 arithmetic (the kernel's uint64)."""
    key = _mix(torch.tensor(_i64(int(seed) + _GOLDEN), dtype=torch.int64, device=device))
    flat = torch.arange(1, rows * cols + 1, dtype=torch.int64, device=device)
    h = _mix(key + flat * _i64(_GOLDEN))
    return (_srl(h, 40).float() * 2.0 ** -24).reshape(rows, cols)


def _check(x):
    if x.ndim != 2:
        raise ValueError("quantize_int8 expects a 2D array")
    if x.dtype not in registry.DTYPE_CODES:
        raise TypeError(f"quantize_int8: f32, bf16 or f16 input, got {x.dtype}")


def quantize_int8_plain(x: torch.Tensor, per_row: bool = True, stochastic: bool = False,
                        seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch."""
    QUANTIZE.plain_calls += 1
    _check(x)
    v = x.float()
    if v.numel() == 0:
        amax = torch.zeros((x.shape[0], 1) if per_row else (1, 1), device=x.device)
    elif per_row:
        amax = v.abs().amax(dim=-1, keepdim=True)
    else:
        amax = v.abs().amax().reshape(1, 1)
    scale = torch.clamp(amax, min=1e-30) * INV_127
    scaled = v / scale
    if stochastic:
        r = torch.floor(scaled + stochastic_noise(seed, *x.shape, x.device))
    else:
        r = torch.round(scaled)
    return torch.clamp(r, -127, 127).to(torch.int8), scale


def _quantize_int8_cuda(x, per_row, stochastic, seed):
    _check(x)
    x = x.contiguous()
    rows, cols = x.shape
    q = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, 1) if per_row else (1, 1), dtype=torch.float32, device=x.device)
    if x.numel() == 0:  # amax 0: the scale of an all-zero row
        return q, torch.full_like(scales, 1e-30) * INV_127
    partials = None if per_row else torch.empty(MAX_PARTIALS, dtype=torch.float32,
                                                device=x.device)
    status = registry.load_library().ltt_quantize_int8(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(),
        None if partials is None else partials.data_ptr(), rows, cols, int(per_row),
        int(stochastic), _i64(int(seed)), registry.DTYPE_CODES[x.dtype],
        registry.stream_handle(x))
    registry.check_launch(status, "quantize_int8")
    QUANTIZE.launches += 1
    return q, scales


def quantize_int8(x: torch.Tensor, *, per_row: bool = True, stochastic: bool = False,
                  seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a 2D tensor to int8: (q, scales), scales (rows, 1) per row
    or (1, 1) global. The kernel for a CUDA tensor, the plain version for a
    CPU one."""
    if registry.on_cuda(x):
        return _quantize_int8_cuda(x, per_row, stochastic, seed)
    return quantize_int8_plain(x, per_row, stochastic, seed)


def dequantize_int8(q: torch.Tensor, scales) -> torch.Tensor:
    """int8 + scales -> f32 (scales broadcast: (rows, 1), (1, 1) or a scalar)."""
    return q.float() * torch.as_tensor(scales, dtype=torch.float32, device=q.device)


def gemm_quantized(a: torch.Tensor, b: torch.Tensor, *, stochastic: bool = False,
                   seed: int = 0) -> torch.Tensor:
    """f32 (M, K) @ (K, N) -> f32 through the int8 GEMM: a per-row scales,
    b per-column scales; about 7 bits of mantissa."""
    qa, sa = quantize_int8(a, per_row=True, stochastic=stochastic, seed=seed)
    qbt, sb = quantize_int8(b.t(), per_row=True, stochastic=stochastic, seed=seed + 1)
    acc = gemm(qa, qbt, transpose_b=True)  # int32
    return acc.float() * sa * sb.reshape(1, -1)
