"""Prepacked GEMM: pack once, multiply many times (port of
laser_tpu/ops/gemm/prepacked.py).

``gemm_prepack_a``/``_b`` reorder a matrix into laser_tpu's pre-blocked,
zero-padded 4-D layout, the same bytes as laser_tpu's for the same plan:

    packed A: (ceil(M/bm), ceil(K/bk), bm, bk)
    packed B: (ceil(K/bk), ceil(N/bn), bk, bn)

``gemm_packed`` multiplies two packed operands: ``alpha * A @ B + beta * C``
at (M, N). On CUDA tensors it runs the kernels of csrc/packed_gemm.cu
(replace laser_tpu/ops/gemm/prepacked.py:80 ``_build_packed_gemm``); on CPU
tensors its plain version ``gemm_packed_plain``. Four routes, each with
its own launch counter, the library picking one: ``gemm_packed_wgmma``
(bf16 and f16 inputs on a plan whose bm and bn are multiples of 128 and bk
of 64, 16-byte-aligned data, as every 16-bit plan from ``plan_tiles`` is:
the wgmma + TMA skeleton of csrc/gemm.cu's wgmma route, each packed block a
tensor-map coordinate), ``gemm_packed_i8_wgmma`` (int8 inputs to int32 on a
plan whose bm, bn and bk are multiples of 128, 16-byte-aligned data, as
every int8 plan from ``plan_tiles`` is: the int8 wgmma skeleton, reading
B's K-major twin, ``PackedMatrix.kmajor``; the same bits as the classic
int8 kernel), ``gemm_packed_simt`` (f32 inputs on a plan whose bm and bn
are multiples of 128 and bk of 16, 16-byte-aligned data, as every f32 plan
from ``plan_tiles`` is: the FFMA skeleton of csrc/gemm.cu's simt route,
csrc/simt_gemm.cuh; the same bits as the classic f32 kernel) and
``gemm_packed`` (the classic kernels: the plans and operands the other
routes do not take). With a plan whose bm and bn are
multiples of the classic kernels' CTA tile (see ``tiling.py``) those read
every block as one contiguous run and mask nothing in their main loop (the
"blocks" route); any other plan laser_tpu accepts runs their "gather"
route, correct and slower. ``route="classic"``, ``"wgmma"`` (int8 too) or
``"simt"`` on CUDA tensors asks for one (an error where it does not fit).
The int8 wgmma takes both operands K-major, and packed B's blocks keep N
contiguous (laser_tpu's bytes, kept as they are in ``data``), so packing an
int8 B on a CUDA device, on a plan whose bk and bn are multiples of 128,
also stores its K-major twin: B's bytes a second time (16 MiB at 4096^2),
paid once per packed B, never per multiply (on the CPU, and on plans the
route does not take, no twin: nothing would read it). Kernel
dtypes: f32 (full fp32), bf16 and f16 (fp32 accumulators),
int8 (int32 accumulators that wrap). The packing itself is a reshape in
PyTorch, as laser_tpu's is XLA's. Like laser_tpu's, a packed operand bakes
in its plan and dtype: never serialize it.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ... import registry
from ...config import check_f32_precision, pin_fp32_matmul
from ...utils import round_step_up
from .api import _acc_dtype, is_integer
from .kernel import int32_scalar, int_epilogue
from .tiling import CTA, GemmTiles, plan_tiles, smem_per_block, stage_bytes

GEMM_PACKED = registry.kernel("gemm_packed", "laser_tpu_torch/csrc/packed_gemm.cu",
                              "laser_tpu/ops/gemm/prepacked.py:80 _build_packed_gemm")
GEMM_PACKED_WGMMA = registry.kernel("gemm_packed_wgmma", "laser_tpu_torch/csrc/packed_gemm.cu",
                                    "laser_tpu/ops/gemm/prepacked.py:80 _build_packed_gemm")
GEMM_PACKED_SIMT = registry.kernel("gemm_packed_simt", "laser_tpu_torch/csrc/packed_gemm.cu",
                                   "laser_tpu/ops/gemm/prepacked.py:80 _build_packed_gemm")
GEMM_PACKED_I8_WGMMA = registry.kernel("gemm_packed_i8_wgmma",
                                       "laser_tpu_torch/csrc/packed_gemm.cu",
                                       "laser_tpu/ops/gemm/prepacked.py:80 _build_packed_gemm")
# route codes shared with csrc/packed_gemm.cu (enum Route), and the counter of
# each (int8 operands: I8_ROUTE_KERNELS, "wgmma" the int8 wgmma kernel)
ROUTES = {None: 0, "classic": 1, "wgmma": 2, "simt": 3}
ROUTE_KERNELS = {1: GEMM_PACKED, 2: GEMM_PACKED_WGMMA, 3: GEMM_PACKED_SIMT}
I8_ROUTE_KERNELS = {1: GEMM_PACKED, 2: GEMM_PACKED_I8_WGMMA}
# the wgmma and simt routes' (rows, columns, depth) of a tile and a k step: a
# plan's bm, bn and bk must be multiples (csrc/hopper.cuh WG_BM, WG_BN,
# WG_BK, WG_BK_I8; csrc/simt_gemm.cuh kBM, kBN, kBK)
WGMMA_TILE = (128, 128, 64)
WGMMA_I8_TILE = (128, 128, 128)
SIMT_TILE = (128, 128, 16)
# the classic int8 kernel's tile (csrc/int8_tile.cuh kTile): its blocks route
I8_CLASSIC_TILE = 64

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8)
_FLOAT_OUT = (torch.float32, torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class PackedMatrix:
    """Opaque packed operand (do not serialize; see the module docstring).
    ``kmajor``, for an int8 B on CUDA whose blocks ``kmajor_wanted`` takes
    (else None): ``data``'s blocks transposed, (gk, gn, bn, bk), the operand
    of the int8 wgmma route, made once when B is packed; it holds as many
    bytes again as ``data``."""

    data: torch.Tensor  # 4-D blocked layout
    rows: int  # logical (unpadded) rows
    cols: int  # logical cols
    block: tuple  # (block_rows, block_cols)
    operand: str  # "A" or "B"
    kmajor: Optional[torch.Tensor] = None

    @property
    def grid_shape(self):
        return tuple(self.data.shape[:2])


def kmajor_wanted(dtype: torch.dtype, bk: int, bn: int) -> bool:
    """Whether a packed B of ``dtype`` in (bk, bn) blocks gets its K-major
    twin on CUDA: int8 blocks the int8 wgmma route can read (bk and bn
    multiples of its tile), the only route that reads the twin."""
    _, tn, tk = WGMMA_I8_TILE
    return dtype == torch.int8 and bk % tk == 0 and bn % tn == 0


def kmajor_twin(data: torch.Tensor) -> torch.Tensor:
    """The K-major twin of packed B ``data``: its blocks transposed,
    (gk, gn, bn, bk), contiguous."""
    return data.transpose(-1, -2).contiguous()


def packed_matrix(data: torch.Tensor, rows: int, cols: int, block, operand: str) -> PackedMatrix:
    """A PackedMatrix of blocked ``data``, with the K-major twin of an int8 B
    on CUDA where ``kmajor_wanted``."""
    twin = (kmajor_twin(data) if operand == "B" and data.is_cuda
            and kmajor_wanted(data.dtype, *block) else None)
    return PackedMatrix(data, rows, cols, tuple(block), operand, twin)


def _pack(x: torch.Tensor, br: int, bc: int, operand: str) -> PackedMatrix:
    r, c = x.shape
    rp, cp = round_step_up(r, br), round_step_up(c, bc)
    if (rp, cp) != (r, c):
        x = F.pad(x, (0, cp - c, 0, rp - r))
    blocked = x.reshape(rp // br, br, cp // bc, bc).permute(0, 2, 1, 3).contiguous()
    return packed_matrix(blocked, r, c, (br, bc), operand)


def _as_matrix(x, dtype) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if dtype is None else x.to(dtype)


def gemm_prepack_a(a, *, tiles: Optional[GemmTiles] = None, n_hint: int = 1024,
                   dtype=None) -> PackedMatrix:
    """gemm_prepackA analog. ``n_hint`` is the expected N of future
    multiplies, used only for planning."""
    a = _as_matrix(a, dtype)
    M, K = a.shape
    tiles = tiles or plan_tiles(M, n_hint, K, a.dtype)
    return _pack(a, tiles.bm, tiles.bk, "A")


def gemm_prepack_b(b, *, tiles: Optional[GemmTiles] = None, m_hint: int = 1024,
                   dtype=None) -> PackedMatrix:
    """gemm_prepackB analog. ``m_hint``: the expected M, for planning."""
    b = _as_matrix(b, dtype)
    K, N = b.shape
    tiles = tiles or plan_tiles(m_hint, N, K, b.dtype)
    return _pack(b, tiles.bk, tiles.bn, "B")


def gemm_packed_plain(alpha, packed_a: PackedMatrix, packed_b: PackedMatrix, beta, c,
                      in_dtype, acc_dtype, out_dtype) -> torch.Tensor:
    """The kernel's function in plain PyTorch: per-block products summed
    over the k-blocks in the accumulator type (fp32 with TF32 off; int8 in
    f64, exact below 2^53, then wrapped to int32), alpha and beta * C in
    that type, one cast."""
    GEMM_PACKED.plain_calls += 1
    A, B = packed_a.data.to(in_dtype), packed_b.data.to(in_dtype)
    gm, gk, bm, bk = A.shape
    gn, bn = B.shape[1], B.shape[3]
    M, N = packed_a.rows, packed_b.cols
    work = torch.float64 if in_dtype == torch.int8 else torch.float32
    if work == torch.float32:
        pin_fp32_matmul()
    acc = torch.zeros((gm * bm, gn * bn), dtype=work, device=A.device)
    for kb in range(gk):
        a_kb = A[:, kb].reshape(gm * bm, bk).to(work)
        b_kb = B[kb].permute(1, 0, 2).reshape(bk, gn * bn).to(work)
        acc += a_kb @ b_kb
    acc = acc[:M, :N]
    if in_dtype == torch.int8:
        return int_epilogue(acc.to(torch.int64), alpha=alpha, beta=beta, c=c, bias=None,
                            epilogue=None, out_dtype=torch.int32).to(out_dtype)
    r = acc * torch.tensor(float(alpha), dtype=torch.float32)
    if c is not None:
        r = r + torch.tensor(float(beta), dtype=torch.float32) * c.to(torch.float32)
    return r.to(out_dtype)


def blocks_route(dtype: torch.dtype, bm: int, bn: int, bk: int) -> bool:
    """Whether the kernel takes its blocks route for this plan (the
    conditions of csrc/packed_gemm.cu's ``blocks_route_ok`` and its shared
    memory limit; the caller also needs 16-byte aligned data)."""
    if dtype == torch.int8:
        t = I8_CLASSIC_TILE
        return bm % t == 0 and bn % t == 0 and bk % t == 0
    cm, cn, _ = CTA[dtype]
    kalign = 4 if dtype == torch.float32 else 16
    return (bm % cm == 0 and bn % cn == 0 and bk % kalign == 0
            and stage_bytes(dtype, bk) <= smem_per_block())


def wgmma_route(dtype: torch.dtype, bm: int, bn: int, bk: int) -> bool:
    """Whether the kernel library takes its wgmma route for this plan (the
    conditions of csrc/packed_gemm.cu's ``wgmma_fits`` and, for int8,
    ``wgmma_i8_fits``; the caller also needs 16-byte aligned data, a float
    output for 16-bit inputs, and B's K-major twin for int8)."""
    if dtype == torch.int8:
        tm, tn, tk = WGMMA_I8_TILE
    elif dtype in (torch.bfloat16, torch.float16):
        tm, tn, tk = WGMMA_TILE
    else:
        return False
    return bm % tm == 0 and bn % tn == 0 and bk % tk == 0


def simt_route(dtype: torch.dtype, bm: int, bn: int, bk: int) -> bool:
    """Whether the kernel library takes its simt route for this plan (the
    conditions of csrc/packed_gemm.cu's ``simt_fits``; the caller also needs
    16-byte aligned data and a float output)."""
    tm, tn, tk = SIMT_TILE
    return dtype == torch.float32 and bm % tm == 0 and bn % tn == 0 and bk % tk == 0


def _packed_cuda(alpha, packed_a, packed_b, beta, c, in_dtype, out_dtype, route):
    if in_dtype == torch.float32:
        check_f32_precision()
    a, b = packed_a.data, packed_b.data
    if b.device != a.device or (c is not None and c.device != a.device):
        raise ValueError(f"gemm_packed: operands on {a.device}, {b.device}"
                         f"{'' if c is None else f', {c.device}'}")
    a, b = a.to(in_dtype).contiguous(), b.to(in_dtype).contiguous()
    gm, gk, bm, bk = a.shape
    gn, bn = b.shape[1], b.shape[3]
    M, N = packed_a.rows, packed_b.cols
    int8 = in_dtype == torch.int8
    # the int8 wgmma route's B: the K-major twin made at pack time
    bt = packed_b.kmajor if int8 else None
    if bt is not None and bt.device != a.device:
        raise ValueError(f"gemm_packed: B's K-major twin on {bt.device}, A on {a.device}")
    kernel_out = torch.int32 if int8 else out_dtype if out_dtype in _FLOAT_OUT else torch.float32
    out = torch.empty((M, N), dtype=kernel_out, device=a.device)
    if M == 0 or N == 0:
        return out.to(out_dtype)
    c_acc = None if c is None else c.to(torch.int32 if int8 else torch.float32).contiguous()
    if int8:
        alpha, beta = int32_scalar(alpha), int32_scalar(beta)
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    if route == "wgmma" and not (wgmma_route(in_dtype, bm, bn, bk) and aligned
                                 and (not int8 or (bt is not None and bt.data_ptr() % 16 == 0))):
        raise ValueError(f"gemm_packed: route 'wgmma' does not take {in_dtype} on the plan "
                         f"({bm}, {bn}, {bk}) (bf16/f16, multiples of {WGMMA_TILE}; int8 "
                         f"with B's K-major twin, multiples of {WGMMA_I8_TILE})")
    if route == "simt" and not (simt_route(in_dtype, bm, bn, bk) and aligned):
        raise ValueError(f"gemm_packed: route 'simt' does not take {in_dtype} on the plan "
                         f"({bm}, {bn}, {bk}) (f32, multiples of {SIMT_TILE})")
    fast = blocks_route(in_dtype, bm, bn, bk) and aligned
    taken = ctypes.c_int(0)
    status = registry.load_library().ltt_gemm_packed(
        a.data_ptr(), b.data_ptr(), None if bt is None else bt.data_ptr(),
        None if c_acc is None else c_acc.data_ptr(), out.data_ptr(), M, N, gm, gn, gk, bm, bn,
        bk, float(alpha), float(beta),
        registry.GEMM_DTYPE_CODES[in_dtype], registry.GEMM_DTYPE_CODES[kernel_out], int(fast),
        registry.route_code(ROUTES, route), ctypes.byref(taken), registry.stream_handle(a))
    registry.check_launch(status, "gemm_packed")
    (I8_ROUTE_KERNELS if int8 else ROUTE_KERNELS)[taken.value].launches += 1
    return out if kernel_out == out_dtype else out.to(out_dtype)


def gemm_packed(alpha, packed_a: PackedMatrix, packed_b: PackedMatrix, beta=0.0,
                c: Optional[torch.Tensor] = None, *, out_dtype=None,
                acc_dtype=None, route: Optional[str] = None) -> torch.Tensor:
    """gemm_packed analog: multiply two packed operands, returning the (M, N)
    result ``alpha * A @ B + beta * C``. alpha and beta are cast to the
    accumulator type (an int8 product with alpha 0.5 is 0, as in
    laser_tpu). ``route``: None lets the library pick, "classic", "wgmma"
    (bf16, f16, int8) or "simt" asks for one (CUDA operands'; CPU operands run the plain
    version whatever the route, but an unknown name raises on both)."""
    registry.route_code(ROUTES, route)
    if packed_a.operand != "A" or packed_b.operand != "B":
        raise ValueError("need (packed A, packed B)")
    if packed_a.cols != packed_b.rows:
        raise ValueError(f"K mismatch: {packed_a.cols} vs {packed_b.rows}")
    if packed_a.block[1] != packed_b.block[0]:
        raise ValueError("pack tile plans disagree on bk; pack with the same GemmTiles")
    in_dtype = torch.promote_types(packed_a.data.dtype, packed_b.data.dtype)
    if in_dtype not in KERNEL_DTYPES:
        raise NotImplementedError(
            f"gemm_packed: {in_dtype} operands (the packed kernel takes f32, bf16, f16 and "
            "int8; the other dtypes are ROADMAP.md queue 1, item 4)")
    acc = acc_dtype or _acc_dtype(in_dtype)
    if acc != _acc_dtype(in_dtype):
        raise NotImplementedError(
            f"gemm_packed: {in_dtype} inputs accumulate in {_acc_dtype(in_dtype)}, not {acc} "
            "(ROADMAP.md queue 1, item 4)")
    out_dtype = out_dtype or (acc if is_integer(in_dtype) else in_dtype)
    M, N = packed_a.rows, packed_b.cols
    if c is not None and tuple(c.shape) != (M, N):
        raise ValueError(f"gemm_packed: c shape {tuple(c.shape)} != {(M, N)}")
    if registry.on_cuda(packed_a.data):
        return _packed_cuda(alpha, packed_a, packed_b, beta, c, in_dtype, out_dtype, route)
    return gemm_packed_plain(alpha, packed_a, packed_b, beta, c, in_dtype, acc, out_dtype)
