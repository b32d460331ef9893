"""Flash attention (port of laser_tpu/ops/attention.py: ``attention``,
``attention_with_stats``, ``attention_trainable``, ``attention_gqa``).

``attention(q, k, v, causal=...)`` over (..., S, D) tensors runs the CUDA
kernel (csrc/flash_attention.cu) for CUDA tensors: an online softmax with
fp32 statistics and accumulator, the causal block skip, the S-tail mask,
MHA, any head dim up to 256. ``attention_with_stats`` runs the same kernel
and also returns each row's running max ``m`` of the scaled scores and its
denominator ``l`` (fp32, (..., S)). ``attention_trainable`` is the
differentiable form: under autograd its forward keeps ``(o, m, l)`` and its
backward runs the flash backward kernels (ops/attention_bwd.py), as
laser_tpu's custom VJP does; without grad it is ``attention``.
``attention_reference`` is the kernel's plain PyTorch version, differentiable
by autograd. ``attention_gqa`` is grouped-query attention over q
(B, Hq, S, D) and k, v (B, Hkv, S, D): the same kernel maps each query head
to its kv head, so K and V are read at Hkv heads and never repeated.
``attention_gqa_trainable`` is its differentiable form: the same GQA
forward saving only q, k and v; its backward expands K/V across each group
(``repeat_interleave``, ``jnp.repeat``'s head order), re-runs the flash
forward with stats and the two backward kernels on the expanded tensors,
and sums dk/dv over each group, as laser_tpu's ``_gqa_bwd``.
``attention_with_stats`` also takes keys of their own length Sk and
``k_valid`` (key j visible to query i when j < k_valid and, if causal,
j <= i), as laser_tpu does, through the plain version; on a CUDA tensor
that case raises ``NotImplementedError`` until the kernel has a variant
for it. Sliding windows and ring offsets are not ported yet and raise.

Replaces laser_tpu/ops/attention.py:60 _build_flash (value output, the
``return_stats=True`` variant and the GQA ``kv_heads`` map). Bound on the
H100: arithmetic at the serving prefill (S up to 512, D 128) and the
training shape (S 1024). Two routes, each with its own launch counter:
``flash_attention_mma`` (bf16/f16 at D 64 and 128, 16-byte-aligned
tensors: the tensor cores through mma.sync, 64 query rows a block, 64-key
K/V tiles double-buffered by cp.async in the input dtype) and
``flash_attention`` (f32 and other head dims: fp32 FFMA, 16 query rows a
block); see csrc/flash_attention.cu. ``route="ffma"`` or ``"mma"`` asks
for one, to time the two against each other.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import registry
from ..config import pin_fp32_matmul

FLASH = registry.kernel("flash_attention", "laser_tpu_torch/csrc/flash_attention.cu",
                        "laser_tpu/ops/attention.py:60 _build_flash")
FLASH_MMA = registry.kernel("flash_attention_mma", "laser_tpu_torch/csrc/flash_attention.cu",
                            "laser_tpu/ops/attention.py:60 _build_flash")
# route codes shared with csrc/flash_attention.cu (enum Route), and the
# counter of each
ROUTES = {None: 0, "ffma": 1, "mma": 2}
ROUTE_KERNELS = {1: FLASH, 2: FLASH_MMA}

NEG_INF = -1e30  # finite sentinel, as laser_tpu/ops/attention.py:37
MAX_HEAD_DIM = 256


def masked_softmax_pv(s: torch.Tensor, valid: torch.Tensor, v: torch.Tensor,
                      dtype: torch.dtype, return_stats: bool = False):
    """softmax(s over valid keys) @ v in fp32, as the kernels compute it: P
    is rounded to ``dtype`` before the P.V product while the denominator
    sums the unrounded P, and a row with no valid key gives 0. s (..., q, k)
    fp32, valid broadcastable to s, v (..., k, d). With ``return_stats``
    also the row max ``m`` of the masked scores and the denominator ``l``,
    both (..., q)."""
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(dtype).float(), v.float())
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    if return_stats:
        return o, m.squeeze(-1), l.squeeze(-1)
    return o


def causal_mask(S: int, causal: bool, device, Sk: Optional[int] = None,
                k_valid: Optional[int] = None) -> torch.Tensor:
    """(S, Sk) bool, Sk defaulting to S: key j visible to query i, that is
    j < k_valid (default Sk) and, if causal, j <= i."""
    Sk = S if Sk is None else Sk
    kv = Sk if k_valid is None else min(int(k_valid), Sk)
    kj = torch.arange(Sk, device=device)
    valid = (kj < kv)[None, :].expand(S, Sk)
    if causal:
        valid = valid & (kj[None, :] <= torch.arange(S, device=device)[:, None])
    return valid


def _flash_plain(q3, k3, v3, causal: bool, scale: float, stats: bool, kv_heads,
                 k_valid=None):
    FLASH.plain_calls += 1
    pin_fp32_matmul()
    BH, S, D = q3.shape
    Sk = k3.shape[1]
    # consecutive query heads share a kv head: (B*Hkv, group, S, D)
    qg = q3.reshape(k3.shape[0], kv_heads[0] // kv_heads[1], S, D)
    s = torch.matmul(qg.float(), k3.float()[:, None].transpose(-1, -2)) * scale
    valid = causal_mask(S, causal, q3.device, Sk, k_valid)
    if not stats:
        o = masked_softmax_pv(s, valid, v3[:, None], q3.dtype)
        return o.reshape(BH, S, D).to(q3.dtype)
    o, m, l = masked_softmax_pv(s, valid, v3[:, None], q3.dtype, return_stats=True)
    return o.reshape(BH, S, D).to(q3.dtype), m.reshape(BH, S), l.reshape(BH, S)


def _flash_cuda(q3, k3, v3, causal: bool, scale: float, stats: bool, kv_heads, route=None):
    if q3.dtype not in registry.DTYPE_CODES:
        raise TypeError(f"flash kernel: unsupported dtype {q3.dtype}")
    for t in (q3, k3, v3):
        if t.device != q3.device or not t.is_contiguous() or t.dtype != q3.dtype:
            raise ValueError("flash kernel: q, k, v must be contiguous, one "
                             "dtype, one device")
    BH, S, D = q3.shape
    Hq, Hkv = kv_heads
    o = torch.empty_like(q3)
    m = l = None
    if stats:
        m = torch.empty((BH, S), dtype=torch.float32, device=q3.device)
        l = torch.empty((BH, S), dtype=torch.float32, device=q3.device)
    if BH and S:
        taken = ctypes.c_int(0)
        status = registry.load_library().ltt_flash_fwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
            None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
            BH, S, D, Hq, Hkv, int(causal), float(scale), registry.DTYPE_CODES[q3.dtype],
            registry.route_code(ROUTES, route), ctypes.byref(taken), registry.stream_handle(q3))
        registry.check_launch(status, "flash_attention")
        ROUTE_KERNELS[taken.value].launches += 1
    return (o, m, l) if stats else o


def flash_forward(q3, k3, v3, causal: bool, scale: float, *, stats: bool = False,
                  plain: bool = False, kv_heads=None, k_valid=None, route=None):
    """The kernel for CUDA tensors, its plain version for CPU tensors (or
    ``plain``): o, or (o, m, l) with ``stats``. q3: (BH, S, D); k3, v3
    (BH, Sk, D), or with ``kv_heads=(Hq, Hkv)`` (BH / Hq * Hkv, Sk, D), query
    head h of each batch row reading kv head h // (Hq / Hkv). Key j is
    visible to query i when j < ``k_valid`` (default Sk) and, if causal,
    j <= i. The kernel takes Sk == S without ``k_valid``; anything else
    raises ``NotImplementedError`` on a CUDA tensor. ``route`` (a CUDA
    tensor's): None lets the library pick, "ffma" or "mma" asks for one."""
    Hq, Hkv = kv_heads or (1, 1)
    BH, S, D = q3.shape
    Sk = k3.shape[1] if k3.ndim == 3 else -1
    if Hq % Hkv or BH % Hq or k3.shape != (BH // Hq * Hkv, Sk, D) or v3.shape != k3.shape:
        raise ValueError(f"flash: q {tuple(q3.shape)}, k {tuple(k3.shape)}, "
                         f"v {tuple(v3.shape)} do not fit kv_heads {(Hq, Hkv)}")
    if k_valid is not None and int(k_valid) <= 0:
        raise ValueError(f"k_valid must be positive, got {k_valid}")
    if plain or not registry.on_cuda(q3):
        return _flash_plain(q3, k3, v3, causal, scale, stats, (Hq, Hkv), k_valid)
    if Sk != S or (k_valid is not None and int(k_valid) < Sk):
        raise NotImplementedError(
            f"flash kernel: {S} queries over {Sk} keys, k_valid {k_valid}: the kernel "
            "takes square attention over every key; the plain version "
            "(plain=True) takes this case")
    return _flash_cuda(q3, k3, v3, causal, scale, stats, (Hq, Hkv), route)


def _prepare(q, k, v, scale, window, rect: bool = False):
    """(q3, k3, v3, scale, lead): flat (BH, S, D) heads. q, k and v share
    one shape, or with ``rect`` k and v share one whose key length may
    differ from q's."""
    same = k.shape == q.shape if not rect else (
        k.shape[:-2] == q.shape[:-2] and k.shape[-1] == q.shape[-1])
    if not same or k.shape != v.shape:
        raise ValueError(f"attention shapes must match: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if window is not None:
        raise NotImplementedError("attention: sliding window is not ported")
    *lead, S, D = q.shape
    if D > MAX_HEAD_DIM:
        raise NotImplementedError(f"attention: head dim {D} > {MAX_HEAD_DIM}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    Sk = k.shape[-2]
    q3 = q.reshape(-1, S, D).contiguous()
    k3, v3 = (t.reshape(-1, Sk, D).contiguous() for t in (k, v))
    return q3, k3, v3, scale, lead


def _attention(q, k, v, causal, scale, window, plain):
    q3, k3, v3, scale, lead = _prepare(q, k, v, scale, window)
    return flash_forward(q3, k3, v3, causal, scale, plain=plain).reshape(q.shape)


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


def _prepare_gqa(q, k, v, scale, window):
    """Checks a GQA call (Hq != Hkv); (q3, k3, v3, scale) as flat heads."""
    if window is not None:
        raise NotImplementedError("attention_gqa: sliding window is not ported")
    B, Hq, S, D = q.shape
    if D > MAX_HEAD_DIM:
        raise NotImplementedError(f"attention_gqa: head dim {D} > {MAX_HEAD_DIM}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q3 = q.reshape(B * Hq, S, D).contiguous()
    k3, v3 = (t.reshape(B * k.shape[1], S, D).contiguous() for t in (k, v))
    return q3, k3, v3, scale


def _check_gqa(q, k, v):
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("attention_gqa expects (B, H, S, D) tensors")
    B, Hq, S, D = q.shape
    _, Hkv, Sk, Dk = k.shape
    if Sk != S or Dk != D or k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} {tuple(v.shape)} "
                         f"vs q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")


def _attention_gqa(q, k, v, causal, scale, window, plain):
    _check_gqa(q, k, v)
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hq == Hkv:
        return _attention(q, k, v, causal, scale, window, plain)
    q3, k3, v3, scale = _prepare_gqa(q, k, v, scale, window)
    o = flash_forward(q3, k3, v3, causal, scale, plain=plain, kv_heads=(Hq, Hkv))
    return o.reshape(q.shape)


def attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, scale: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """Grouped-query attention: q (B, Hq, S, D), k and v (B, Hkv, S, D), Hq
    a multiple of Hkv (MQA is Hkv = 1); ``attention`` when Hq == Hkv."""
    return _attention_gqa(q, k, v, causal, scale, window, plain=False)


def attention_gqa_reference(q, k, v, *, causal: bool = False,
                            scale: Optional[float] = None,
                            window: Optional[int] = None) -> torch.Tensor:
    """``attention_gqa`` through the kernel's plain version, on any device."""
    return _attention_gqa(q, k, v, causal, scale, window, plain=True)


def attention_with_stats(q, k, v, *, causal: bool = False,
                         scale: Optional[float] = None,
                         window: Optional[int] = None, k_valid=None,
                         q_offset=None, k_offset=None):
    """(out, m, l): out (..., S, D); m, l (..., S) fp32, the row max of the
    scaled scores and the softmax denominator, enough to merge partial
    attentions or to run the backward. k and v are (..., Sk, D): key j is
    visible to query i when j < ``k_valid`` (default Sk) and, if causal,
    j <= i; ``k_valid <= 0`` raises ``ValueError``. The kernel takes
    Sk == S without ``k_valid``: another case runs the plain version on a
    CPU tensor and raises ``NotImplementedError`` on a CUDA one. The ring
    offsets are not ported and raise."""
    if k_valid is not None and int(k_valid) <= 0:
        raise ValueError(f"k_valid must be positive, got {k_valid}")
    if q_offset is not None or k_offset is not None:
        raise NotImplementedError(
            "attention_with_stats: q_offset/k_offset (ring attention) are not ported")
    q3, k3, v3, scale, lead = _prepare(q, k, v, scale, window, rect=True)
    o, m, l = flash_forward(q3, k3, v3, causal, scale, stats=True, k_valid=k_valid)
    S = q.shape[-2]
    return o.reshape(q.shape), m.reshape(*lead, S), l.reshape(*lead, S)


class _FlashAttention(torch.autograd.Function):
    """Flash forward with stats; backward = the two flash backward kernels
    (laser_tpu/ops/attention.py:547-595, _att_fwd/_att_bwd)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal, scale):
        o, m, l = flash_forward(q3, k3, v3, causal, scale, stats=True)
        ctx.save_for_backward(q3, k3, v3, o, m, l)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o, m, l = ctx.saved_tensors
        dq, dk, dv = attention_bwd.flash_attention_bwd(
            q3, k3, v3, o, m, l, do.contiguous(), causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def attention_trainable(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Differentiable attention: the flash forward (with stats) and the
    fused flash backward kernels when autograd needs a gradient; the
    value-only ``attention`` otherwise."""
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if not needs_grad:
        return attention(q, k, v, causal=causal, scale=scale, window=window)
    q3, k3, v3, scale, lead = _prepare(q, k, v, scale, window)
    return _FlashAttention.apply(q3, k3, v3, causal, scale).reshape(q.shape)


class _GQAFlash(torch.autograd.Function):
    """The GQA flash forward; backward by K/V expansion
    (laser_tpu/ops/attention.py:652-682, _gqa_fwd/_gqa_bwd)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal, scale, kv_heads):
        ctx.save_for_backward(q3, k3, v3)
        ctx.cfg = (causal, scale, kv_heads)
        return flash_forward(q3, k3, v3, causal, scale, kv_heads=kv_heads)

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3 = ctx.saved_tensors
        causal, scale, (Hq, Hkv) = ctx.cfg
        grp = Hq // Hkv
        _, S, D = k3.shape
        ke, ve = (t.reshape(-1, Hkv, S, D).repeat_interleave(grp, dim=1).reshape(q3.shape)
                  for t in (k3, v3))
        o, m, l = flash_forward(q3, ke, ve, causal, scale, stats=True)
        dq, dke, dve = attention_bwd.flash_attention_bwd(
            q3, ke, ve, o, m, l, do.contiguous(), causal=causal, scale=scale)
        dk, dv = (t.reshape(-1, Hkv, grp, S, D).float().sum(2).to(k3.dtype).reshape(k3.shape)
                  for t in (dke, dve))
        return dq, dk, dv, None, None, None


def attention_gqa_trainable(q, k, v, *, causal: bool = False,
                            scale: Optional[float] = None,
                            window: Optional[int] = None) -> torch.Tensor:
    """Differentiable GQA: the native grouped flash forward; the backward
    expands K/V across each group, runs the flash backward kernels and
    group-sums dk/dv. ``attention_trainable`` when Hq == Hkv; the
    value-only ``attention_gqa`` when no gradient is needed."""
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if not needs_grad:
        return attention_gqa(q, k, v, causal=causal, scale=scale, window=window)
    _check_gqa(q, k, v)
    if q.shape[1] == k.shape[1]:
        return attention_trainable(q, k, v, causal=causal, scale=scale, window=window)
    q3, k3, v3, scale = _prepare_gqa(q, k, v, scale, window)
    return _GQAFlash.apply(q3, k3, v3, causal, scale,
                           (q.shape[1], k.shape[1])).reshape(q.shape)


# last, as a module: attention_bwd imports this module's helpers. Importing
# it here registers the backward kernels wherever the forward's are.
from . import attention_bwd  # noqa: E402
