"""Batched GEMM: (B, M, K) x (B, K, N) -> (B, M, N) (port of
laser_tpu/ops/gemm/batched.py: ``gemm_batched``).

f32, bf16, f16 and int8 inputs run one launch of the GEMM kernel with a
batch index (csrc/gemm.cu: blockIdx.z over the batch, fp32 or int32
accumulation, no epilogue) for a CUDA tensor, and its plain version for a
CPU tensor. The output dtype follows laser_tpu: the input dtype for floats,
the accumulator (int32) for int8. Other dtypes go where laser_tpu sends
them to XLA (batched.py:102-108): through ``gemm``'s int32, int64 and f64
routes, entry by entry, with the same accumulator and output rule.

Replaces laser_tpu/ops/gemm/batched.py:28 _build_batched. Bound on the
H100: the tensor-core rate at BASELINE.json's bf16 4096^3 batch. bf16/f16
entries that fit the wgmma route (kernel.py) run it with the batch entry as
the tensor maps' third coordinate (counter ``gemm_batched_wgmma``); f32
entries that fit the simt route run ``gemm_simt_kernel`` with the batch
entry as blockIdx.z (counted on the kernel's own counter, ``gemm_simt``);
every other batch runs the 64 x 64 kernels (``gemm_batched``).
"""

from __future__ import annotations

import ctypes

import torch

from ... import registry
from ...config import check_f32_precision, pin_fp32_matmul
from .api import _acc_dtype, _dispatch, gemm, is_integer
from .kernel import GEMM_SIMT, INT8_OUT_DTYPES, ROUTES, exact_int_product, wrap32

GEMM_BATCHED = registry.kernel("gemm_batched", "laser_tpu_torch/csrc/gemm.cu",
                               "laser_tpu/ops/gemm/batched.py:28 _build_batched")
GEMM_BATCHED_WGMMA = registry.kernel("gemm_batched_wgmma", "laser_tpu_torch/csrc/gemm.cu",
                                     "laser_tpu/ops/gemm/batched.py:28 _build_batched")
ROUTE_KERNELS = {1: GEMM_BATCHED, 2: GEMM_BATCHED_WGMMA, 4: GEMM_SIMT}


def gemm_batched_plain(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 products (TF32 off), or
    for int8 the exact product wrapped to int32; one cast."""
    GEMM_BATCHED.plain_calls += 1
    if a.dtype == torch.int8:
        return wrap32(exact_int_product(a, b)).to(out_dtype)
    pin_fp32_matmul()
    return torch.matmul(a.float(), b.float()).to(out_dtype)


# gridDim.z, the batch index, is at most 65535: larger batches launch in parts
MAX_BATCH = 65535


def _gemm_batched_cuda(a, b, out_dtype, route=None):
    """The kernel; ``route`` as ``gemm_fused``'s."""
    if a.dtype == torch.float32:
        check_f32_precision()
    Bn, M, K = a.shape
    N = b.shape[2]
    if b.device != a.device:
        raise ValueError(f"gemm_batched: b on {b.device}, a on {a.device}")
    int8 = a.dtype == torch.int8
    # the kernel writes these output types; another is one cast afterwards
    kernel_dtypes = INT8_OUT_DTYPES if int8 else tuple(registry.DTYPE_CODES)
    kdt = out_dtype if out_dtype in kernel_dtypes else (torch.int32 if int8 else torch.float32)
    out = torch.empty((Bn, M, N), dtype=kdt, device=a.device)
    if K == 0:
        out.zero_()
    elif out.numel():
        lib = registry.load_library()
        for z0 in range(0, Bn, MAX_BATCH):
            nz = min(MAX_BATCH, Bn - z0)
            taken = ctypes.c_int(0)
            status = lib.ltt_gemm_batched(
                a[z0].data_ptr(), b[z0].data_ptr(), out[z0].data_ptr(), nz, M, N, K,
                registry.GEMM_DTYPE_CODES[a.dtype], registry.GEMM_DTYPE_CODES[kdt],
                registry.route_code(ROUTES, route), ctypes.byref(taken),
                registry.stream_handle(a))
            registry.check_launch(status, "gemm_batched")
            ROUTE_KERNELS[taken.value].launches += 1
    return out if kdt == out_dtype else out.to(out_dtype)


def gemm_batched(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
                 acc_dtype=None) -> torch.Tensor:
    """C[i] = A[i] @ B[i] for every batch entry i."""
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"gemm_batched shapes: {tuple(a.shape)} x {tuple(b.shape)}")
    in_dtype = torch.result_type(a, b)
    acc = acc_dtype or _acc_dtype(in_dtype)
    if _dispatch(in_dtype) != "mxu" or acc != _acc_dtype(in_dtype):
        out = out_dtype or acc
        entries = [gemm(a[i], b[i], acc_dtype=acc, out_dtype=out) for i in range(a.shape[0])]
        return torch.stack(entries) if entries else torch.empty(
            (0, a.shape[1], b.shape[2]), dtype=out, device=a.device)
    out_dtype = out_dtype or (acc if is_integer(in_dtype) else in_dtype)
    a = a.to(in_dtype).contiguous()
    b = b.to(in_dtype).contiguous()
    if registry.on_cuda(a):
        return _gemm_batched_cuda(a, b, out_dtype)
    return gemm_batched_plain(a, b, out_dtype)
