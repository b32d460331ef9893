"""Flash attention forward (port of laser_tpu/ops/attention.py: ``attention``).

``attention(q, k, v, causal=...)`` over (..., S, D) tensors runs the CUDA
kernel (csrc/flash_attention.cu) for CUDA tensors: an online softmax with
fp32 statistics and accumulator, the causal block skip, the S-tail mask,
MHA, any head dim up to 256. ``attention_reference`` is its plain PyTorch
version. GQA, sliding windows, the (m, l) stats output and ring offsets
are not ported yet and raise.

Replaces laser_tpu/ops/attention.py:60 _build_flash. Bound on the H100:
arithmetic at the prefill shapes (S up to 512, D 128). Design: 16 query rows
per block, 32-key tiles staged in shared memory, fp32 FFMA products (exact
for bf16 inputs); tensor cores are later work (csrc/flash_attention.cu).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import registry
from ..config import pin_fp32_matmul

FLASH = registry.kernel("flash_attention", "laser_tpu_torch/csrc/flash_attention.cu",
                        "laser_tpu/ops/attention.py:60 _build_flash")

NEG_INF = -1e30  # finite sentinel, as laser_tpu/ops/attention.py:37
MAX_HEAD_DIM = 256


def masked_softmax_pv(s: torch.Tensor, valid: torch.Tensor, v: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """softmax(s over valid keys) @ v in fp32, as the kernels compute it: P
    is rounded to ``dtype`` before the P.V product while the denominator
    sums the unrounded P, and a row with no valid key gives 0. s (..., q, k)
    fp32, valid broadcastable to s, v (..., k, d)."""
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(dtype).float(), v.float())
    return torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)


def _flash_plain(q3, k3, v3, causal: bool, scale: float):
    FLASH.plain_calls += 1
    pin_fp32_matmul()
    S = q3.shape[1]
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if causal:
        idx = torch.arange(S, device=q3.device)
        valid = idx[None, :] <= idx[:, None]
    else:
        valid = torch.ones((S, S), dtype=torch.bool, device=q3.device)
    return masked_softmax_pv(s, valid, v3, q3.dtype).to(q3.dtype)


def _flash_cuda(q3, k3, v3, causal: bool, scale: float):
    if q3.dtype not in registry.DTYPE_CODES:
        raise TypeError(f"flash kernel: unsupported dtype {q3.dtype}")
    for t in (q3, k3, v3):
        if t.device != q3.device or not t.is_contiguous() or t.dtype != q3.dtype:
            raise ValueError("flash kernel: q, k, v must be contiguous, one "
                             "dtype, one device")
    BH, S, D = q3.shape
    o = torch.empty_like(q3)
    if BH == 0 or S == 0:
        return o
    status = registry.load_library().ltt_flash_fwd(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), BH, S, D,
        int(causal), float(scale), registry.DTYPE_CODES[q3.dtype],
        registry.stream_handle(q3))
    registry.check_launch(status, "flash_attention")
    FLASH.launches += 1
    return o


def _attention(q, k, v, causal, scale, window, plain):
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention shapes must match: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if window is not None:
        raise NotImplementedError("attention: sliding window is not ported")
    *lead, S, D = q.shape
    if D > MAX_HEAD_DIM:
        raise NotImplementedError(f"attention: head dim {D} > {MAX_HEAD_DIM}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q3, k3, v3 = (t.reshape(-1, S, D).contiguous() for t in (q, k, v))
    if plain or not registry.on_cuda(q3):
        o = _flash_plain(q3, k3, v3, causal, scale)
    else:
        o = _flash_cuda(q3, k3, v3, causal, scale)
    return o.reshape(*lead, S, D)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, scale: Optional[float] = None,
              window: Optional[int] = None) -> torch.Tensor:
    """Fused blockwise attention over (..., S, D); leading dims flatten to
    batch x heads."""
    return _attention(q, k, v, causal, scale, window, plain=False)


def attention_reference(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """``attention`` through the kernel's plain version, on any device."""
    return _attention(q, k, v, causal, scale, window, plain=True)
