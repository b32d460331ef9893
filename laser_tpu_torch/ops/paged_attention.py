"""Paged decode attention and its W-query variant, the speculative verify
(port of laser_tpu/ops/paged_attention.py: ``paged_attention``,
``paged_window_attention``, their references, ``quantize_kv``).

Layouts, as in laser_tpu:
    q        (S, Hq, hd)        one decode token per sequence slot
             (S, W, Hq, hd)     W window tokens per slot (window variant)
    k_pool   (P, Hkv, ps, hd)   P pages of ps tokens each, shared pool
    v_pool   (P, Hkv, ps, hd)
    tables   (S, max_pages)     int32 page ids per slot
    lengths  (S,)               int32 valid keys per slot (0 = inactive)

The CUDA kernels (csrc/paged_attention.cu, csrc/paged_window_attention.cu)
take pools in q's dtype (f32/bf16/f16) or int8 pools with per-(page, kv
head, token) f32 ``k_scale``/``v_scale`` of shape (P, Hkv, ps), as
``quantize_kv`` makes them; GQA: Hq a multiple of Hkv, consecutive q heads
sharing a kv head, at most 8 query heads per kv head for the decode kernel
and at most 64 folded rows W * (Hq / Hkv) for the window kernel. Keys at or
past a slot's length are never read; ``length == 0`` gives zeros. In the
window variant query w of slot s sits at position lengths[s] - W + w and
attends causally (active slots have lengths[s] >= W). The int8 variants fold
the scales into the scores and the probabilities, in laser_tpu's order; for
f32 they compute in f32 throughout: laser_tpu's ``paged_quant_mode="base"``
(its bf16 limb tiers exist for the TPU's matrix unit and are not ported).
``window`` (sliding-window attention) is not ported yet and raises. The
caller keeps every table entry below ``lengths`` a valid page id: the
kernels do not check them.

Replace laser_tpu/ops/paged_attention.py:121 build_paged_attention and :318
build_paged_window_attention. Bound on the H100: KV bytes from HBM. Two
routes for each, each with its own launch counter:

- "split" (``paged_attention_split``, ``paged_window_attention_split``):
  bf16/f16 q at hd 64 or 128, pools in q's dtype or int8, 16-byte-aligned
  operands. One tensor-core skeleton (csrc/paged_split.cuh) for both, the
  decode being its W = 1: blocks over (key chunk, kv head, slot), the chunk
  sized from the table's capacity and the SM count (never from
  ``lengths``: no host read), 64-key tiles gathered by cp.async in the
  pool's dtype, mma.sync, and the chunks' fp32 partials merged in a fixed
  order (a workspace sized here through ``ltt_paged_workspace``). At W = 1
  the decode and the verify give the same bits.
- "classic" (``paged_attention``, ``paged_window_attention``): f32 q and
  other head dims. One block per (slot, kv head): the decode kernel's four
  warps stream interleaved 32-key tiles and merge at the end; the window
  kernel copies each 32-key tile once into shared memory and gives each of
  its eight warps its own rows.

``route="classic"`` or ``"split"`` asks for one (a CUDA tensor's; an
unknown name raises on any device); a route that does not fit raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import registry
from ..config import pin_fp32_matmul
from .attention import masked_softmax_pv

PAGED = registry.kernel("paged_attention", "laser_tpu_torch/csrc/paged_attention.cu",
                        "laser_tpu/ops/paged_attention.py:121 build_paged_attention")
PAGED_SPLIT = registry.kernel("paged_attention_split", "laser_tpu_torch/csrc/paged_split.cuh",
                              "laser_tpu/ops/paged_attention.py:121 build_paged_attention")
PAGED_WINDOW = registry.kernel(
    "paged_window_attention", "laser_tpu_torch/csrc/paged_window_attention.cu",
    "laser_tpu/ops/paged_attention.py:318 build_paged_window_attention")
PAGED_WINDOW_SPLIT = registry.kernel(
    "paged_window_attention_split", "laser_tpu_torch/csrc/paged_split.cuh",
    "laser_tpu/ops/paged_attention.py:318 build_paged_window_attention")
# route codes shared with csrc/paged_split.cuh (enum PagedRoute), and the
# counter of each, for the decode and for the verify
ROUTES = {None: 0, "classic": 1, "split": 2}
ROUTE_KERNELS = {1: PAGED, 2: PAGED_SPLIT}
WINDOW_ROUTE_KERNELS = {1: PAGED_WINDOW, 2: PAGED_WINDOW_SPLIT}

MAX_GROUP = 8
MAX_HEAD_DIM = 256
MAX_WINDOW_ROWS = 64  # W * (Hq / Hkv) rows per (slot, kv head) block


def quantize_kv(x: torch.Tensor):
    """Per-token, per-head symmetric int8 for KV rows: x (..., hd) ->
    (int8 rows, f32 scales (...,)): scale amax / 127 (1 for a zero row),
    rows round half to even and clip to +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = torch.where(amax > 0, amax / 127.0, 1.0)
    qx = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return qx, s


def _paged_plain(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale):
    """Dense-gather version: materialise each slot's pages (dequantized when
    int8), masked softmax."""
    PAGED.plain_calls += 1
    pin_fp32_matmul()
    S, Hq, hd = q.shape
    Hkv = k_pool.shape[1]
    tables = tables.long()
    if k_scale is not None:  # int8 rows times their f32 scales
        k_pool = k_pool.float() * k_scale[..., None]
        v_pool = v_pool.float() * v_scale[..., None]
    k = k_pool[tables].transpose(1, 2).reshape(S, Hkv, -1, hd)  # (S, Hkv, T, hd)
    v = v_pool[tables].transpose(1, 2).reshape(S, Hkv, -1, hd)
    qg = q.reshape(S, Hkv, Hq // Hkv, hd)
    s = torch.matmul(qg.float(), k.float().transpose(-1, -2)) * scale
    kpos = torch.arange(k.shape[2], device=q.device)
    valid = kpos[None, None, None, :] < lengths.to(q.device).long()[:, None, None, None]
    o = masked_softmax_pv(s, valid, v, q.dtype)
    return o.reshape(S, Hq, hd).to(q.dtype)


def _check_cuda_operands(what, q, k_pool, v_pool, tables, lengths, k_scale, v_scale):
    """The kernels' dtype, device and contiguity rules; True for int8 pools."""
    if q.dtype not in registry.DTYPE_CODES:
        raise TypeError(f"{what} kernel: unsupported dtype {q.dtype}")
    quant = k_pool.dtype == torch.int8
    operands = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("tables", tables),
                ("lengths", lengths)]
    if quant:
        operands += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in operands:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {q.device}")
    if v_pool.dtype != k_pool.dtype or k_pool.dtype not in (q.dtype, torch.int8):
        raise TypeError(f"{what} kernel: pools {k_pool.dtype}/{v_pool.dtype} "
                        f"with q {q.dtype}")
    if quant and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError(f"{what} kernel: k_scale and v_scale must be float32")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{what} kernel: tables and lengths must be int32")
    return quant


def _launch(entry, counters, q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale,
            route, W):
    """One call of ``entry`` (the decode's or the verify's), its workspace
    asked for and allocated first; counts the route that launched."""
    what = entry[len("ltt_"):]
    quant = _check_cuda_operands(what.replace("_", " "), q, k_pool, v_pool, tables, lengths,
                                 k_scale, v_scale)
    S, Hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    _, Hkv, ps, _ = k_pool.shape
    out = torch.empty_like(q)
    if S == 0:
        return out
    code, dcode = registry.route_code(ROUTES, route), registry.DTYPE_CODES[q.dtype]
    shape = (S, W, Hq, Hkv, ps, hd, tables.shape[1])
    ptrs = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr())
    try:
        nbytes = registry.workspace(
            "ltt_paged_workspace", ("paged", *shape, dcode, code,
                                    *(p % 16 == 0 for p in ptrs), q.device.index),
            *ptrs, *shape, dcode, code)
    except registry.KernelLaunchError as e:  # the query refuses only a route that does not fit
        raise ValueError(f"{what}: route {route!r} does not fit {q.dtype} at hd {hd}, "
                         f"{W} x {Hq // Hkv} rows, these alignments") from e
    ws = registry.scratch(nbytes, q.device)
    taken = ctypes.c_int(0)
    lib = registry.load_library()
    status = getattr(lib, entry)(
        *ptrs, k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), S, *((W,) if q.ndim == 4 else ()), Hq, Hkv,
        ps, hd, tables.shape[1], float(scale), dcode, registry.POOL_DTYPE_CODES[k_pool.dtype],
        code, ctypes.byref(taken), registry.stream_handle(q))
    registry.check_launch(status, what)
    counters[taken.value].launches += 1
    return out


def _paged_cuda(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale, route=None):
    return _launch("ltt_paged_attention", ROUTE_KERNELS, q, k_pool, v_pool, tables, lengths,
                   k_scale, v_scale, scale, route, 1)


def _check_pools(q_shape, k_pool, v_pool, k_scale, v_scale, window):
    """Shape rules shared by both kernels; returns the scales to use (None
    for float pools, which ignore them, as laser_tpu)."""
    hd = q_shape[-1]
    Hq = q_shape[-2]
    P, Hkv, ps, hd_k = k_pool.shape
    if hd_k != hd or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"inconsistent with q {tuple(q_shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq {Hq} not a multiple of Hkv {Hkv}")
    if window is not None:
        raise NotImplementedError("paged attention: sliding window is not ported")
    if hd > MAX_HEAD_DIM:
        raise NotImplementedError(f"paged attention: head dim {hd} > {MAX_HEAD_DIM}")
    if k_pool.dtype != torch.int8:
        return None, None
    if k_scale is None or v_scale is None:
        raise ValueError("int8 pools need k_scale/v_scale (P, Hkv, ps)")
    if k_scale.shape != k_pool.shape[:3] or v_scale.shape != k_pool.shape[:3]:
        raise ValueError(f"scales {tuple(k_scale.shape)}/{tuple(v_scale.shape)} "
                         f"do not match pools {tuple(k_pool.shape)}")
    return k_scale, v_scale


def _paged(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale,
           window, plain, route=None):
    registry.route_code(ROUTES, route)  # an unknown name raises on any device
    S, Hq, hd = q.shape
    k_scale, v_scale = _check_pools(q.shape, k_pool, v_pool, k_scale, v_scale, window)
    if Hq // k_pool.shape[1] > MAX_GROUP:
        raise NotImplementedError(
            f"paged attention: group {Hq // k_pool.shape[1]} > {MAX_GROUP}")
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if plain or not registry.on_cuda(q):
        return _paged_plain(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale)
    return _paged_cuda(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale, route)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    tables: torch.Tensor, lengths: torch.Tensor, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    window: Optional[int] = None, route: Optional[str] = None) -> torch.Tensor:
    """Decode attention over paged KV; see the module docstring. ``route``
    (a CUDA tensor's): None lets the library pick, "classic" or "split"
    asks for one."""
    return _paged(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale,
                  window, plain=False, route=route)


def paged_attention_reference(q, k_pool, v_pool, tables, lengths, *,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """``paged_attention`` through the kernel's plain version, on any device:
    int8 pools are dequantized first, then the dense-gather oracle."""
    return _paged(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale,
                  window, plain=True)


# ---------------------------------------------------------------------------
# W-query variant: the speculative verify
# ---------------------------------------------------------------------------

def _window_plain(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale):
    """Dense-gather version: materialise each slot's pages (dequantized when
    int8), fold (W, group) into rows w * group + g, causal masked softmax."""
    PAGED_WINDOW.plain_calls += 1
    pin_fp32_matmul()
    S, W, Hq, hd = q.shape
    Hkv = k_pool.shape[1]
    group = Hq // Hkv
    tables = tables.long()
    if k_scale is not None:  # int8 rows times their f32 scales
        k_pool = k_pool.float() * k_scale[..., None]
        v_pool = v_pool.float() * v_scale[..., None]
    k = k_pool[tables].transpose(1, 2).reshape(S, Hkv, -1, hd)  # (S, Hkv, T, hd)
    v = v_pool[tables].transpose(1, 2).reshape(S, Hkv, -1, hd)
    qf = q.reshape(S, W, Hkv, group, hd).permute(0, 2, 1, 3, 4).reshape(S, Hkv, W * group, hd)
    s = torch.matmul(qf.float(), k.float().transpose(-1, -2)) * scale  # (S, Hkv, G, T)
    qpos = lengths.to(q.device).long()[:, None] - W + torch.arange(W, device=q.device)
    qpos = qpos.repeat_interleave(group, dim=1)                         # (S, G)
    kpos = torch.arange(k.shape[2], device=q.device)
    valid = kpos[None, None, None, :] <= qpos[:, None, :, None]
    o = masked_softmax_pv(s, valid, v, q.dtype)                         # (S, Hkv, G, hd)
    o = o.reshape(S, Hkv, W, group, hd).permute(0, 2, 1, 3, 4)
    return o.reshape(S, W, Hq, hd).to(q.dtype)


def _window_cuda(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale, route=None):
    return _launch("ltt_paged_window_attention", WINDOW_ROUTE_KERNELS, q, k_pool, v_pool,
                   tables, lengths, k_scale, v_scale, scale, route, q.shape[1])


def _window(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale, window, plain,
            route=None):
    registry.route_code(ROUTES, route)  # an unknown name raises on any device
    if q.ndim != 4:
        raise ValueError(f"q must be (S, W, Hq, hd), got {tuple(q.shape)}")
    S, W, Hq, hd = q.shape
    k_scale, v_scale = _check_pools(q.shape, k_pool, v_pool, k_scale, v_scale, window)
    if W * (Hq // k_pool.shape[1]) > MAX_WINDOW_ROWS:
        raise NotImplementedError(
            f"paged window attention: W {W} x group {Hq // k_pool.shape[1]} > "
            f"{MAX_WINDOW_ROWS} rows")
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if plain or not registry.on_cuda(q):
        return _window_plain(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale)
    return _window_cuda(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale, route)


def paged_window_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           tables: torch.Tensor, lengths: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None,
                           window: Optional[int] = None,
                           route: Optional[str] = None) -> torch.Tensor:
    """W-query (speculative verify) attention over paged KV: q (S, W, Hq, hd)
    -> (S, W, Hq, hd); see the module docstring. The pages already hold the
    K/V rows of all lengths[s] positions, the W new ones included.
    ``route`` as in ``paged_attention``."""
    return _window(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale,
                   window, plain=False, route=route)


def paged_window_attention_reference(q, k_pool, v_pool, tables, lengths, *,
                                     k_scale: Optional[torch.Tensor] = None,
                                     v_scale: Optional[torch.Tensor] = None,
                                     scale: Optional[float] = None,
                                     window: Optional[int] = None) -> torch.Tensor:
    """``paged_window_attention`` through the kernel's plain version, on any
    device: int8 pools are dequantized first, then the dense-gather oracle."""
    return _window(q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale,
                   window, plain=True)
