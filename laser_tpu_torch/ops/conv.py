"""2-D convolution (port of laser_tpu/ops/conv.py: ``conv2d_out_shape``,
``conv2d_required_ops``, ``conv2d_im2col``, ``conv2d_direct``).

NCHW activations and OIHW weights at every public function, as laser_tpu.

- ``conv2d_im2col``: the (N*oh*ow, C*kh*kw) patch matrix built in PyTorch,
  then one ``gemm`` call (laser_tpu/ops/conv.py:57-91). ``gemm`` dispatches
  as laser_tpu's does: a plain float product goes to ``torch.matmul``, as
  laser_tpu hands it to XLA; a ``bias`` or ``epilogue`` in the keyword
  arguments runs the fused GEMM kernel.
- ``conv2d_direct`` takes laser_tpu's branches (conv.py:273-344) at stride
  1: a 1x1 unpadded conv as ``gemm`` over channels with ``transpose_b``; a
  conv with C*kh*kw <= 64 on the planewise kernel; every other conv on the
  direct kernel. A strided conv is one launch of the direct kernel, which
  takes the stride; ``plain=True`` (and ``route="classic"``) keeps
  laser_tpu's strided branch, the sum of s_h*s_w stride-1 phase convs on
  subsampled inputs and kernels.

The CUDA kernels (csrc/conv.cu), padding applied while loading:

- ``conv_planewise`` (stride 1) replaces laser_tpu/ops/conv.py:95
  _build_planewise_conv: per-tap FMAs of shifted planes with fp32 weights,
  fp32 accumulation, output in x's dtype.
- ``conv_direct`` replaces both kernels of laser_tpu/ops/conv.py:152
  _build_direct_conv (``kernel_patch``, which writes NCHW, and
  ``kernel_taps``, which writes NHWC for a transpose) and, with the stride
  in the kernel, laser_tpu's strided branch (conv.py:251-270): one implicit
  GEMM per image, patches gathered from NCHW x, NCHW written directly,
  weights cast to x's dtype. Three routes, each with its own launch
  counter, the library picking one from the dtype: ``conv_direct_ffma``
  (f32, full-fp32 FFMA, any stride), ``conv_direct_mma`` (bf16/f16 on the
  tensor cores, mma.sync with fp32 accumulation, any stride) and
  ``conv_direct`` (the first kernels, stride 1 only: FFMA and WMMA on
  64 x 64 tiles). ``route="classic"``, ``"ffma"`` or ``"mma"`` on a CUDA
  tensor asks for one (an error where it does not fit), to time them
  against each other; ``conv2d_direct(..., route="classic")`` at a stride
  > 1 runs laser_tpu's phase decomposition on the classic kernels.

Routing is by shape only. laser_tpu also weighs a VMEM budget (conv.py:
300-338), which sends the same shape down different kernels on a v5e and
on its CPU stand-in and falls back to im2col when nothing fits; the port's
kernels have no residency limit, so the direct kernel takes every shape
past the planewise rule.

Plain versions: ``conv2d_planewise_reference`` (the tap loop of shifted
planes times scalar weights in fp32, conv.py:114-123) and
``conv2d_direct_reference`` (``F.unfold`` at the stride and one fp32
product, TF32 off), shared by the direct kernel's three routes. At a
stride > 1 the kernel route rounds once, where laser_tpu rounds each phase
conv and adds the phases in the dtype: equal in f32 up to summation order,
a few roundings of max apart in bf16/f16 (ROADMAP.md queue 3). On CPU
tensors each wrapper runs its plain version. ``conv2d_trainable`` and
its backward are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import registry
from ..config import check_f32_precision, pin_fp32_matmul
from .gemm import gemm, gemm_reference

CONV_PLANEWISE = registry.kernel("conv_planewise", "laser_tpu_torch/csrc/conv.cu",
                                 "laser_tpu/ops/conv.py:95 _build_planewise_conv")
CONV_DIRECT = registry.kernel("conv_direct", "laser_tpu_torch/csrc/conv.cu",
                              "laser_tpu/ops/conv.py:152 _build_direct_conv")
CONV_DIRECT_FFMA = registry.kernel("conv_direct_ffma", "laser_tpu_torch/csrc/conv.cu",
                                   "laser_tpu/ops/conv.py:152 _build_direct_conv")
CONV_DIRECT_MMA = registry.kernel("conv_direct_mma", "laser_tpu_torch/csrc/conv.cu",
                                  "laser_tpu/ops/conv.py:152 _build_direct_conv")
# route codes shared with csrc/conv.cu (enum Route), and the counter of each
ROUTES = {None: 0, "classic": 1, "ffma": 2, "mma": 3}
ROUTE_KERNELS = {1: CONV_DIRECT, 2: CONV_DIRECT_FFMA, 3: CONV_DIRECT_MMA}

# laser_tpu's small-channel rule (conv.py:310): C * kh * kw taps at most
PLANEWISE_MAX_TAPS = 64
# output channels a planewise block computes (csrc/conv.cu PW_CO)
_PLANEWISE_CO = 32
# the kernels' grid: images (times channel groups) on its z axis
_GRID_Z = 65535
_INT_MAX = 2**31 - 1


def conv2d_out_shape(ishape, kshape, padding, strides) -> Tuple[int, int, int, int]:
    n, _, h, w = ishape
    c_out, _, kh, kw = kshape
    ph, pw = padding
    sh, sw = strides
    return (n, c_out, 1 + (h + 2 * ph - kh) // sh, 1 + (w + 2 * pw - kw) // sw)


def conv2d_required_ops(ishape, kshape, padding, strides) -> int:
    """FLOPs: N * c_out * kh * kw * C * oh * ow * 2."""
    n, c_in, _, _ = ishape
    c_out, _, kh, kw = kshape
    _, _, oh, ow = conv2d_out_shape(ishape, kshape, padding, strides)
    return n * c_out * kh * kw * c_in * oh * ow * 2


def _check(x: torch.Tensor, w: torch.Tensor, padding, strides=(1, 1)):
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"conv2d: x (N, C, H, W) and w (c_out, C, kh, kw), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[1] != x.shape[1]:
        raise ValueError(f"conv2d: channel mismatch {w.shape[1]} vs {x.shape[1]}")
    out = conv2d_out_shape(x.shape, w.shape, padding, strides)
    if out[2] <= 0 or out[3] <= 0:
        raise ValueError(f"conv2d: empty output {out} for x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, padding {padding}, strides {strides}")
    return out


def conv2d_im2col(x: torch.Tensor, w: torch.Tensor, padding: Sequence[int] = (0, 0),
                  strides: Sequence[int] = (1, 1), **gemm_kwargs) -> torch.Tensor:
    """x (N, C, H, W), w (c_out, C, kh, kw) -> (N, c_out, oh, ow)."""
    padding, strides = tuple(padding), tuple(strides)
    N, c_out, oh, ow = _check(x, w, padding, strides)
    kh, kw = w.shape[2:]
    # (N, C*kh*kw, oh*ow), columns in (C, kh, kw) order -> (N*oh*ow, C*kh*kw)
    cols = F.unfold(x, (kh, kw), padding=padding, stride=strides)
    patches = cols.transpose(1, 2).reshape(N * oh * ow, -1)
    out = gemm(patches, w.reshape(c_out, -1), transpose_b=True, **gemm_kwargs)
    return out.reshape(N, oh, ow, c_out).permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------------------
# The kernels' plain versions
# ---------------------------------------------------------------------------

def conv2d_planewise_reference(x: torch.Tensor, w: torch.Tensor,
                               padding: Sequence[int] = (0, 0)) -> torch.Tensor:
    """The planewise kernel's function (stride 1) in plain PyTorch: for every
    tap, the shifted fp32 input plane times the fp32 weight of each output
    channel, accumulated in fp32; one cast to x's dtype."""
    CONV_PLANEWISE.plain_calls += 1
    ph, pw = padding
    N, c_out, oh, ow = _check(x, w, (ph, pw))
    C, kh, kw = w.shape[1:]
    xp = F.pad(x.float(), (pw, pw, ph, ph))
    wf = w.float()
    acc = torch.zeros((N, c_out, oh, ow), dtype=torch.float32, device=x.device)
    for c in range(C):
        for i in range(kh):
            for j in range(kw):
                acc += wf[:, c, i, j].reshape(1, c_out, 1, 1) * xp[:, c:c + 1, i:i + oh, j:j + ow]
    return acc.to(x.dtype)


def conv2d_direct_reference(x: torch.Tensor, w: torch.Tensor,
                            padding: Sequence[int] = (0, 0),
                            strides: Sequence[int] = (1, 1)) -> torch.Tensor:
    """The direct kernel's function in plain PyTorch, at any stride: the
    patch matrix (``F.unfold``) times the weights rounded to x's dtype, one
    fp32 product (TF32 off), one cast."""
    CONV_DIRECT.plain_calls += 1
    padding, strides = tuple(padding), tuple(strides)
    N, c_out, oh, ow = _check(x, w, padding, strides)
    pin_fp32_matmul()
    cols = F.unfold(x.float(), tuple(w.shape[2:]), padding=padding, stride=strides)
    out = torch.matmul(w.to(x.dtype).float().reshape(c_out, -1), cols)
    return out.reshape(N, c_out, oh, ow).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _checked(name: str, x: torch.Tensor, w: torch.Tensor, padding, strides, groups: int):
    """The output shape, after the checks both kernels need."""
    out = _check(x, w, padding, strides)
    if x.dtype not in registry.DTYPE_CODES:
        raise TypeError(f"{name} kernel: unsupported dtype {x.dtype}")
    if x.dtype == torch.float32:
        check_f32_precision()
    if w.device != x.device:
        raise ValueError(f"{name}: w on {w.device}, x on {x.device}")
    N, c_out, oh, ow = out
    C, H, W = x.shape[1:]
    if N * groups > _GRID_Z or max(C * H * W, c_out * oh * ow) > _INT_MAX:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)} exceed the "
                         f"kernel's grid or 32-bit image offsets")
    return out


def conv_planewise(x: torch.Tensor, w: torch.Tensor,
                   padding: Sequence[int] = (0, 0)) -> torch.Tensor:
    """Stride-1 conv with C * kh * kw <= 64: the planewise kernel for a CUDA
    tensor, its plain version for a CPU one."""
    padding = tuple(padding)
    if not registry.on_cuda(x):
        return conv2d_planewise_reference(x, w, padding)
    taps = w.shape[1] * w.shape[2] * w.shape[3]
    if taps > PLANEWISE_MAX_TAPS:
        raise ValueError(f"conv_planewise: C*kh*kw = {taps} > {PLANEWISE_MAX_TAPS}")
    groups = -(-w.shape[0] // _PLANEWISE_CO)
    N, c_out, oh, ow = _checked("conv_planewise", x, w, padding, (1, 1), groups)
    x, w = x.contiguous(), w.float().contiguous()
    out = torch.empty((N, c_out, oh, ow), dtype=x.dtype, device=x.device)
    if N == 0 or c_out == 0:
        return out
    C, H, W = x.shape[1:]
    kh, kw = w.shape[2:]
    status = registry.load_library().ltt_conv_planewise(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), N, C, H, W, c_out, kh, kw, *padding,
        registry.DTYPE_CODES[x.dtype], registry.stream_handle(x))
    registry.check_launch(status, "conv_planewise")
    CONV_PLANEWISE.launches += 1
    return out


# elements of a 16-byte row chunk by dtype (the direct kernel's cp.async)
_VEC = {torch.float32: 4, torch.bfloat16: 8, torch.float16: 8}


def _direct_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """w as (c_out, ldw) rows of ``dtype``: K = C*kh*kw padded with zeros to
    a 16-byte multiple, on a 16-byte-aligned base (the cp.async stages of
    the ffma and mma routes); a view of w where it already is that."""
    c_out, C, kh, kw = w.shape
    K, vec = C * kh * kw, _VEC[dtype]
    if w.dtype == dtype and K % vec == 0 and w.is_contiguous() and w.data_ptr() % 16 == 0:
        return w.view(c_out, K)
    wk = w.reshape(c_out, K).to(dtype)
    if K % vec:
        wk = F.pad(wk, (0, vec - K % vec))
    wk = wk.contiguous()
    return wk if wk.data_ptr() % 16 == 0 else wk.clone()


def conv_direct(x: torch.Tensor, w: torch.Tensor, padding: Sequence[int] = (0, 0),
                strides: Sequence[int] = (1, 1), *, route: Optional[str] = None) -> torch.Tensor:
    """A conv of any shape and stride: the direct (implicit GEMM) kernel for
    a CUDA tensor, its plain version for a CPU one. ``route``: None lets the
    library pick (ffma for f32, mma for bf16/f16), "classic", "ffma" or
    "mma" asks for one (a CUDA tensor's; a CPU tensor runs the plain version
    whatever the route, but an unknown name raises on both). "classic"
    takes stride 1 only."""
    padding, strides = tuple(padding), tuple(strides)
    code = registry.route_code(ROUTES, route)
    if not registry.on_cuda(x):
        return conv2d_direct_reference(x, w, padding, strides)
    return _conv_direct_cuda(x, w, padding, strides, route, code)


def _conv_direct_cuda(x, w, padding, strides, route, code):
    if route == "classic" and strides != (1, 1):
        raise ValueError(f"conv_direct: route 'classic' takes stride 1, not {strides}")
    if route in ("ffma", "mma") and (route == "ffma") != (x.dtype == torch.float32):
        raise ValueError(f"conv_direct: route {route!r} does not take {x.dtype}")
    N, c_out, oh, ow = _checked("conv_direct", x, w, padding, strides, 1)
    out = torch.empty((N, c_out, oh, ow), dtype=x.dtype, device=x.device)
    if N == 0 or c_out == 0:
        return out
    x, wk = x.contiguous(), _direct_weights(w, x.dtype)
    C, H, W = x.shape[1:]
    kh, kw = w.shape[2:]
    taken = ctypes.c_int(0)
    status = registry.load_library().ltt_conv_direct(
        x.data_ptr(), wk.data_ptr(), out.data_ptr(), N, C, H, W, c_out, kh, kw, *padding,
        *strides, wk.shape[1], registry.DTYPE_CODES[x.dtype], code, ctypes.byref(taken),
        registry.stream_handle(x))
    registry.check_launch(status, "conv_direct")
    ROUTE_KERNELS[taken.value].launches += 1
    return out


# ---------------------------------------------------------------------------
# conv2d_direct: laser_tpu's branches
# ---------------------------------------------------------------------------

def _strided_via_phases(x, w, padding, strides, plain: bool, route: Optional[str]):
    """out = sum over phases (p, q) of conv1(x_pad[p::sh, q::sw],
    w[:, :, p::sh, q::sw]), cropped to the strided output (conv.py:251-270)."""
    sh, sw = strides
    ph, pw = padding
    _, _, oh, ow = _check(x, w, padding, strides)
    xp = F.pad(x, (pw, pw, ph, ph))
    total = None
    for p in range(sh):
        for q in range(sw):
            wpq = w[:, :, p::sh, q::sw]
            if wpq.shape[2] == 0 or wpq.shape[3] == 0:
                continue
            sub = conv2d_direct(xp[:, :, p::sh, q::sw], wpq, plain=plain,
                                route=route)[:, :, :oh, :ow]
            total = sub if total is None else total + sub
    return total


def conv2d_direct(x: torch.Tensor, w: torch.Tensor, padding: Sequence[int] = (0, 0),
                  strides: Sequence[int] = (1, 1), *, plain: bool = False,
                  route: Optional[str] = None) -> torch.Tensor:
    """Direct convolution, x (N, C, H, W), w (c_out, C, kh, kw) -> (N,
    c_out, oh, ow), by laser_tpu's branches (see the module docstring).
    ``plain=True`` takes the same branches through the kernels' plain
    versions. ``route`` names the direct kernel's route wherever the conv
    reaches it (see ``conv_direct``); "classic" at a stride > 1 runs the
    phase convs on the classic kernels."""
    padding, strides = tuple(padding), tuple(strides)
    code = registry.route_code(ROUTES, route)
    _check(x, w, padding, strides)
    if strides != (1, 1):
        if plain or route == "classic":
            return _strided_via_phases(x, w, padding, strides, plain, route)
        if registry.on_cuda(x):
            return _conv_direct_cuda(x, w, padding, strides, route, code)
        return conv2d_direct_reference(x, w, padding, strides)
    N, C, H, W = x.shape
    c_out, _, kh, kw = w.shape
    if kh == 1 and kw == 1 and padding == (0, 0):
        # a 1x1 conv is a GEMM over channels (conv.py:285-293)
        xm = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
        out = (gemm_reference if plain else gemm)(xm, w.reshape(c_out, C), transpose_b=True)
        return out.reshape(N, H, W, c_out).permute(0, 3, 1, 2).contiguous()
    if C * kh * kw <= PLANEWISE_MAX_TAPS:
        if plain:
            return conv2d_planewise_reference(x, w, padding)
        return conv_planewise(x, w, padding)
    if plain or not registry.on_cuda(x):
        return conv2d_direct_reference(x, w, padding)
    return _conv_direct_cuda(x, w, padding, strides, route, code)
