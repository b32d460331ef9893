"""Paged decode attention (port of laser_tpu/ops/paged_attention.py:
``paged_attention``).

Layouts, as in laser_tpu:
    q        (S, Hq, hd)        one decode token per sequence slot
    k_pool   (P, Hkv, ps, hd)   P pages of ps tokens each, shared pool
    v_pool   (P, Hkv, ps, hd)
    tables   (S, max_pages)     int32 page ids per slot
    lengths  (S,)               int32 valid keys per slot (0 = inactive)

The CUDA kernel (csrc/paged_attention.cu) takes f32/bf16/f16 pools with
GQA (Hq a multiple of Hkv, at most 8 query heads per kv head, consecutive q
heads sharing a kv head). Keys at or past a slot's length are never read;
``length == 0`` gives zeros. int8 pools and ``window`` are not ported yet
and raise. The caller keeps every table entry below ``lengths`` a valid
page id: the kernel does not check them.

Replaces laser_tpu/ops/paged_attention.py:121 build_paged_attention. Bound
on the H100: KV bytes from HBM. Design: one block per (slot, kv head) reads
its own table row (no scalar prefetch on Hopper); four warps stream
interleaved 32-key tiles with their own online softmax and merge at the end
(csrc/paged_attention.cu).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import registry
from ..config import pin_fp32_matmul
from .attention import masked_softmax_pv

PAGED = registry.kernel("paged_attention", "laser_tpu_torch/csrc/paged_attention.cu",
                        "laser_tpu/ops/paged_attention.py:121 build_paged_attention")

MAX_GROUP = 8
MAX_HEAD_DIM = 256


def _paged_plain(q, k_pool, v_pool, tables, lengths, scale):
    """Dense-gather version: materialise each slot's pages, masked softmax."""
    PAGED.plain_calls += 1
    pin_fp32_matmul()
    S, Hq, hd = q.shape
    Hkv = k_pool.shape[1]
    tables = tables.long()
    k = k_pool[tables].transpose(1, 2).reshape(S, Hkv, -1, hd)  # (S, Hkv, T, hd)
    v = v_pool[tables].transpose(1, 2).reshape(S, Hkv, -1, hd)
    qg = q.reshape(S, Hkv, Hq // Hkv, hd)
    s = torch.matmul(qg.float(), k.float().transpose(-1, -2)) * scale
    kpos = torch.arange(k.shape[2], device=q.device)
    valid = kpos[None, None, None, :] < lengths.to(q.device).long()[:, None, None, None]
    o = masked_softmax_pv(s, valid, v, q.dtype)
    return o.reshape(S, Hq, hd).to(q.dtype)


def _paged_cuda(q, k_pool, v_pool, tables, lengths, scale):
    if q.dtype not in registry.DTYPE_CODES:
        raise TypeError(f"paged attention kernel: unsupported dtype {q.dtype}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("tables", tables),
                    ("lengths", lengths)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged attention: {name} must be contiguous on {q.device}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"paged attention kernel: pools {k_pool.dtype} != q {q.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged attention kernel: tables and lengths must be int32")
    S, Hq, hd = q.shape
    _, Hkv, ps, _ = k_pool.shape
    out = torch.empty_like(q)
    if S == 0:
        return out
    status = registry.load_library().ltt_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), S, Hq, Hkv, ps, hd, tables.shape[1],
        float(scale), registry.DTYPE_CODES[q.dtype], registry.stream_handle(q))
    registry.check_launch(status, "paged_attention")
    PAGED.launches += 1
    return out


def _paged(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale,
           window, plain):
    S, Hq, hd = q.shape
    P, Hkv, ps, hd_k = k_pool.shape
    if hd_k != hd or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"inconsistent with q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq {Hq} not a multiple of Hkv {Hkv}")
    if k_pool.dtype == torch.int8 or k_scale is not None or v_scale is not None:
        raise NotImplementedError("paged attention: int8 KV pools are not ported")
    if window is not None:
        raise NotImplementedError("paged attention: sliding window is not ported")
    if Hq // Hkv > MAX_GROUP or hd > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"paged attention: group {Hq // Hkv} > {MAX_GROUP} or head dim "
            f"{hd} > {MAX_HEAD_DIM}")
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if plain or not registry.on_cuda(q):
        return _paged_plain(q, k_pool, v_pool, tables, lengths, scale)
    return _paged_cuda(q, k_pool, v_pool, tables, lengths, scale)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    tables: torch.Tensor, lengths: torch.Tensor, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Decode attention over paged KV; see the module docstring."""
    return _paged(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale,
                  window, plain=False)


def paged_attention_reference(q, k_pool, v_pool, tables, lengths, *,
                              scale: Optional[float] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """``paged_attention`` through the kernel's plain version, on any device."""
    return _paged(q, k_pool, v_pool, tables, lengths, None, None, scale,
                  window, plain=True)
