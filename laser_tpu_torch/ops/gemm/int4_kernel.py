"""Weight-only int4 GEMM with group-wise scales (port of
laser_tpu/ops/gemm/int4_kernel.py: ``pack_int4``, ``unpack_int4``,
``quantize_int4``, ``dequantize_int4``, ``gemm_w4``).

The layout is laser_tpu's, bit for bit: symmetric int4 values in [-7, 7],
one f32 scale per (row group, output column), the group even and dividing
K; one byte packs rows 2i (low nibble) and 2i+1 (high nibble) of a column.
Rounding is half to even (``torch.round``, as ``jnp.round``).

``gemm_w4(h, wq)`` computes ``h @ dequant(wq)`` in ``h.dtype``: each weight
is its nibble times its group's f32 scale, rounded to ``h.dtype`` before
the product (fp32 accumulation). For a CPU tensor it runs the plain
version, laser_tpu's XLA path: dequantize, cast to ``h.dtype``, one product
(TF32 off). For a CUDA tensor it launches one of three hand-written routes
(csrc/w4_gemm.cu), none of which puts the full-precision weight in device
memory, each with its own launch counter:
``w4_gemm_stream`` (bf16/f16 with M <= 16: the split-K skeleton of
csrc/splitk.cuh streaming the packed bytes and scales through a cp.async
ring, mma.sync B fragments built from two packed bytes a lane, a fixed-order
reduce of the splits in a workspace allocated here), ``w4_gemm_mma``
(bf16/f16 with more rows: wgmma on 128 x 128 tiles, TMA loads of the
activations, packed bytes and scales, two warpgroups dequantizing each
stage's B tile in shared memory) and ``w4_gemm`` (the first port's WMMA kernel for
what the others cannot take, N % 16 != 0 or unaligned bases, and the
full-fp32 FFMA kernel for f32 activations). ``route="classic"``,
``"stream"`` or ``"mma"`` asks for one (an error where it does not fit).

Replaces laser_tpu/ops/gemm/int4_kernel.py:87 build_w4_gemm. Bound on the
H100: the packed weight bytes at decode (a quarter of bf16's), tensor-core
throughput at prefill (details in csrc/w4_gemm.cu).
"""

from __future__ import annotations

import ctypes

import torch

from ... import registry
from ...config import check_f32_precision, pin_fp32_matmul

_REPLACES = "laser_tpu/ops/gemm/int4_kernel.py:87 build_w4_gemm"
W4_GEMM = registry.kernel("w4_gemm", "laser_tpu_torch/csrc/w4_gemm.cu", _REPLACES)
W4_GEMM_STREAM = registry.kernel("w4_gemm_stream", "laser_tpu_torch/csrc/w4_gemm.cu", _REPLACES)
W4_GEMM_MMA = registry.kernel("w4_gemm_mma", "laser_tpu_torch/csrc/w4_gemm.cu", _REPLACES)
# route codes shared with csrc/w4_gemm.cu (enum W4Route), and the counter of each
ROUTES = {None: 0, "classic": 1, "stream": 2, "mma": 3}
ROUTE_KERNELS = {1: W4_GEMM, 2: W4_GEMM_STREAM, 3: W4_GEMM_MMA}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 in [-8, 7] -> (K//2, N) int8, two nibbles per byte."""
    lo = q[0::2].to(torch.uint8) & 0x0F
    hi = (q[1::2].to(torch.uint8) & 0x0F) << 4
    return (lo | hi).view(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """(K//2, N) packed -> (K, N) int8 in [-8, 7], rows re-interleaved; the
    low nibble sign-extends via (x ^ 8) - 8, the high one by an arithmetic
    shift of the sign-extended byte."""
    p32 = p.to(torch.int32)
    hi = p32 >> 4
    lo = ((p32 & 15) ^ 8) - 8
    K2, N = p.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * K2, N).to(torch.int8)


def quantize_int4(w: torch.Tensor, group: int = 64) -> dict:
    """f32/bf16 (K, N) -> {"q4": (K//2, N) int8, "s4": (K//group, N) f32}.
    group must be even and divide K. The dequantized value of row k, column
    n is unpack(q4)[k, n] * s4[k // group, n]."""
    K, N = w.shape
    if K % 2 or group % 2 or K % group:
        raise ValueError(f"int4 quant needs even group | K; got K={K}, group={group}")
    wf = w.float().reshape(K // group, group, N)
    a = wf.abs().amax(dim=1)
    s = torch.where(a > 0, a / 7.0, 1.0)
    q = torch.clamp(torch.round(wf / s[:, None, :]), -7, 7)
    return {"q4": pack_int4(q.reshape(K, N).to(torch.int8)), "s4": s}


def dequantize_int4(wq: dict) -> torch.Tensor:
    """{"q4", "s4"} -> the f32 (K, N) weight."""
    q = unpack_int4(wq["q4"]).float()
    G, N = wq["s4"].shape
    K = q.shape[0]
    return (q.reshape(G, K // G, N) * wq["s4"][:, None, :]).reshape(K, N)


def _check(h, wq):
    if h.ndim != 2:
        raise ValueError(f"gemm_w4: h must be (M, K), got {tuple(h.shape)}")
    q4, s4 = wq["q4"], wq["s4"]
    M, K = h.shape
    G, N = s4.shape
    if q4.dtype != torch.int8 or s4.dtype != torch.float32:
        raise TypeError(f"gemm_w4: q4 {q4.dtype} / s4 {s4.dtype}, want int8 / float32")
    if tuple(q4.shape) != (K // 2, N) or G == 0 or K % G or (K // G) % 2:
        raise ValueError(f"gemm_w4: h {tuple(h.shape)}, q4 {tuple(q4.shape)}, "
                         f"s4 {tuple(s4.shape)} are not an int4 layout")
    return M, N, K, K // G


def gemm_w4_plain(h: torch.Tensor, wq: dict) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dequantize, round to
    ``h.dtype``, one product in fp32 (exact for bf16/f16 operands, TF32 off
    for f32), one cast."""
    W4_GEMM.plain_calls += 1
    _check(h, wq)
    pin_fp32_matmul()
    w = dequantize_int4(wq).to(h.dtype)
    return torch.matmul(h.float(), w.float()).to(h.dtype)


def _gemm_w4_cuda(h, wq, route=None):
    M, N, K, group = _check(h, wq)
    if h.dtype not in registry.DTYPE_CODES:
        raise TypeError(f"w4 gemm kernel: unsupported dtype {h.dtype}")
    if h.dtype == torch.float32:
        check_f32_precision()
    q4, s4 = wq["q4"], wq["s4"]
    for name, t in (("h", h), ("q4", q4), ("s4", s4)):
        if t.device != h.device or not t.is_contiguous():
            raise ValueError(f"gemm_w4: {name} must be contiguous on {h.device}")
    code, dt = registry.route_code(ROUTES, route), registry.DTYPE_CODES[h.dtype]
    out = torch.empty((M, N), dtype=h.dtype, device=h.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    ptrs = (h.data_ptr(), q4.data_ptr(), s4.data_ptr())
    ws = registry.scratch(registry.workspace(
        "ltt_w4_gemm_workspace",
        ("w4", M, N, K, group, dt, code, *(p % 16 == 0 for p in ptrs), h.device.index),
        *ptrs, M, N, K, group, dt, code), h.device)
    taken = ctypes.c_int(0)
    status = registry.load_library().ltt_w4_gemm(
        *ptrs, out.data_ptr(), None if ws is None else ws.data_ptr(), M, N, K, group, dt, code,
        ctypes.byref(taken), registry.stream_handle(h))
    registry.check_launch(status, "w4_gemm")
    ROUTE_KERNELS[taken.value].launches += 1
    return out


def gemm_w4(h: torch.Tensor, wq: dict, route=None) -> torch.Tensor:
    """h (M, K) @ dequant(wq) -> (M, N) in h.dtype; ``wq`` a
    ``quantize_int4`` dict. The kernel for a CUDA tensor (``route``: None
    lets the library pick, "classic", "stream" or "mma" asks for one), the
    plain version for a CPU one (an unknown route name raises on both)."""
    if registry.on_cuda(h):
        return _gemm_w4_cuda(h, wq, route)
    registry.route_code(ROUTES, route)
    return gemm_w4_plain(h, wq)
