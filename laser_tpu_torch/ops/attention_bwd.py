"""Flash attention backward (port of laser_tpu/ops/attention_bwd.py:
``flash_attention_bwd``).

The forward saves only ``(o, m, l)``; the backward recomputes each score
from ``(m, l)`` and streams the gradients, never keeping the S x S matrix:

    p_ij  = exp(scale * q_i.k_j - m_i) / l_i        (masked; 0 where l_i == 0)
    dp_ij = dO_i.v_j,  ds_ij = scale * p_ij * (dp_ij - dvec_i)
    dvec_i = rowsum(dO_i * O_i)                      (fp32, a torch op, as in JAX)
    dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i p_ij dO_i

Two CUDA kernels (csrc/flash_attention_bwd.cu) replace
laser_tpu/ops/attention_bwd.py:72 _build_bwd_dq and :173 _build_bwd_dkv.
Bound on the H100: arithmetic (3 and 4 products per visible pair). Each
block owns a tile of query rows (dq) or key rows (dk, dv) and loops over the
other axis, so no output is shared and no atomics are needed; the causal
block skip holds on both sides. Two routes of each, each with its own launch
counter: ``flash_attention_bwd_dq_mma`` / ``flash_attention_bwd_dkv_mma``
(bf16/f16 at D 64 and 128, 16-byte-aligned tensors: the tensor cores
through mma.sync, 64 owned rows a block, 64-row tiles double-buffered by
cp.async in the input dtype, P and dS rounded to it before their products)
and ``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv`` (f32 and other
head dims: fp32 FFMA, 16 owned rows a block). ``route="ffma"`` or ``"mma"``
asks for one; ``"mma"`` where it does not fit raises.

``flash_attention_bwd_reference`` is the plain PyTorch version: it recomputes
P from ``(m, l)`` exactly as the kernels do (it is not autograd of the
forward), so the CPU tests exercise the same math. The sliding window, ring
offsets and a ``dvec`` override are not ported and raise.
"""

from __future__ import annotations

import ctypes

import torch

from .. import registry
from ..config import pin_fp32_matmul
from .attention import MAX_HEAD_DIM, NEG_INF, causal_mask

FLASH_BWD_DQ = registry.kernel(
    "flash_attention_bwd_dq", "laser_tpu_torch/csrc/flash_attention_bwd.cu",
    "laser_tpu/ops/attention_bwd.py:72 _build_bwd_dq")
FLASH_BWD_DKV = registry.kernel(
    "flash_attention_bwd_dkv", "laser_tpu_torch/csrc/flash_attention_bwd.cu",
    "laser_tpu/ops/attention_bwd.py:173 _build_bwd_dkv")
FLASH_BWD_DQ_MMA = registry.kernel(
    "flash_attention_bwd_dq_mma", "laser_tpu_torch/csrc/flash_attention_bwd.cu",
    "laser_tpu/ops/attention_bwd.py:72 _build_bwd_dq")
FLASH_BWD_DKV_MMA = registry.kernel(
    "flash_attention_bwd_dkv_mma", "laser_tpu_torch/csrc/flash_attention_bwd.cu",
    "laser_tpu/ops/attention_bwd.py:173 _build_bwd_dkv")
# route codes shared with csrc/flash_attention_bwd.cu (enum Route), and the
# (dq, dk/dv) counters of each
ROUTES = {None: 0, "ffma": 1, "mma": 2}
ROUTE_KERNELS = {1: (FLASH_BWD_DQ, FLASH_BWD_DKV), 2: (FLASH_BWD_DQ_MMA, FLASH_BWD_DKV_MMA)}


def _bwd_plain(q, k, v, do, m, l, dvec, causal: bool, scale: float):
    FLASH_BWD_DQ.plain_calls += 1
    FLASH_BWD_DKV.plain_calls += 1
    pin_fp32_matmul()
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    valid = causal_mask(q.shape[1], causal, q.device)
    s = torch.where(valid, torch.matmul(qf, kf.transpose(1, 2)) * scale, NEG_INF)
    l2, m2 = l[..., None], m[..., None]
    p = torch.exp(s - m2) / torch.where(l2 > 0, l2, 1.0)
    p = torch.where(valid & (l2 > 0), p, 0.0)
    dp = torch.matmul(dof, vf.transpose(1, 2))
    ds = scale * p * (dp - dvec[..., None])
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(1, 2), qf)
    dv = torch.matmul(p.transpose(1, 2), dof)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def _checked_cuda(q, k, v, do, m, l, dvec):
    if q.dtype not in registry.DTYPE_CODES:
        raise TypeError(f"flash backward kernel: unsupported dtype {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash backward kernel: {name} must be a contiguous "
                             f"{q.dtype} tensor on {q.device}")
    for name, t in (("m", m), ("l", l), ("dvec", dvec)):
        if t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash backward kernel: {name} must be contiguous "
                             f"float32 on {q.device}")
    BH, S, D = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(),
            l.data_ptr(), dvec.data_ptr()), (BH, S, D)


def _launch(which: int, outs, q, k, v, do, m, l, dvec, causal, scale, route):
    """Kernel ``which`` (0 dq, 1 dk/dv) into ``outs``; counts the launch on
    the route the library reports."""
    ptrs, (BH, S, D) = _checked_cuda(q, k, v, do, m, l, dvec)
    code = registry.route_code(ROUTES, route)
    if BH and S:
        taken = ctypes.c_int(0)
        fn = getattr(registry.load_library(), ("ltt_flash_bwd_dq", "ltt_flash_bwd_dkv")[which])
        status = fn(*ptrs, *(t.data_ptr() for t in outs), BH, S, D, int(causal), float(scale),
                    registry.DTYPE_CODES[q.dtype], code, ctypes.byref(taken),
                    registry.stream_handle(q))
        registry.check_launch(status, ROUTE_KERNELS[1][which].name)
        ROUTE_KERNELS[taken.value][which].launches += 1


def bwd_dq_cuda(q, k, v, do, m, l, dvec, causal: bool, scale: float, route=None):
    """dq through the dq kernel (CUDA tensors): the tensor cores where they
    fit, else FFMA; ``route`` "ffma" or "mma" asks for one."""
    dq = torch.empty_like(q)
    _launch(0, (dq,), q, k, v, do, m, l, dvec, causal, scale, route)
    return dq


def bwd_dkv_cuda(q, k, v, do, m, l, dvec, causal: bool, scale: float, route=None):
    """(dk, dv) through the dk/dv kernel (CUDA tensors), routed as
    ``bwd_dq_cuda``."""
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch(1, (dk, dv), q, k, v, do, m, l, dvec, causal, scale, route)
    return dk, dv


def _bwd(q, k, v, o, m, l, do, causal, scale, window, q_off, k_off, dvec, plain,
         route=None):
    registry.route_code(ROUTES, route)  # an unknown route raises on any device
    if window is not None or q_off is not None or k_off is not None or dvec is not None:
        raise NotImplementedError(
            "flash_attention_bwd: window, q_off/k_off (ring attention) and a "
            "dvec override are not ported")
    if q.ndim != 3 or not (q.shape == k.shape == v.shape == o.shape == do.shape):
        raise ValueError("flash_attention_bwd: q, k, v, o, do must share one "
                         "(BH, S, D) shape")
    if m.shape != q.shape[:2] or l.shape != q.shape[:2]:
        raise ValueError(f"flash_attention_bwd: m, l must be {tuple(q.shape[:2])}")
    if q.shape[2] > MAX_HEAD_DIM:
        raise NotImplementedError(f"flash_attention_bwd: head dim {q.shape[2]} > "
                                  f"{MAX_HEAD_DIM}")
    dvec = (do.float() * o.float()).sum(dim=-1)
    if plain or not registry.on_cuda(q):
        return _bwd_plain(q, k, v, do, m, l, dvec, causal, scale)
    return (bwd_dq_cuda(q, k, v, do, m, l, dvec, causal, scale, route),
            *bwd_dkv_cuda(q, k, v, do, m, l, dvec, causal, scale, route))


def flash_attention_bwd(q, k, v, o, m, l, do, *, causal: bool, scale: float,
                        window=None, q_off=None, k_off=None, dvec=None, route=None):
    """(dq, dk, dv) of attention, from the forward's output ``o`` and stats
    ``m``, ``l``. q, k, v, o, do: (BH, S, D) in one dtype; m, l: (BH, S)
    fp32. The kernels for CUDA tensors, the plain version for CPU tensors.
    ``route`` (a CUDA tensor's): None lets the library pick, "ffma" or
    "mma" asks for one; an unknown name raises ``ValueError``."""
    return _bwd(q, k, v, o, m, l, do, causal, scale, window, q_off, k_off, dvec,
                plain=False, route=route)


def flash_attention_bwd_reference(q, k, v, o, m, l, do, *, causal: bool,
                                  scale: float):
    """``flash_attention_bwd`` through the kernels' plain version, on any
    device."""
    return _bwd(q, k, v, o, m, l, do, causal, scale, None, None, None, None,
                plain=True)
