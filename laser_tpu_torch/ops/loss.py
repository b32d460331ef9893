"""Fused cross-entropy over logits (port of laser_tpu/ops/loss.py:
``cross_entropy`` and ``lm_cross_entropy``).

Per row, with label smoothing eps and the target distribution
q = (1 - eps) onehot(t) + eps / V:

    lse = log sum_c exp(x_c),   loss = lse - (1 - eps) x_t - (eps / V) sum_c x_c

Three CUDA kernels (csrc/cross_entropy.cu), routed as laser_tpu routes them:

- a value-only call (no gradient needed) runs ``ce_fwd``, replacing
  laser_tpu/ops/loss.py:41 _build_ce_fwd: one online max/sum pass per row,
  the per-row loss and lse out;
- under autograd, when ``fused_grad_bt(T, V)`` is not None, ``ce_fused_grad``
  (replacing laser_tpu/ops/loss.py:180 _build_ce_fused_grad) writes the
  per-row loss and the unit gradient dxu = softmax(x) - q in one kernel; the
  backward scales dxu by each row's cotangent (loss.py:301-307). laser_tpu's
  kernel writes dxu over the dead logits (``input_output_aliases``); the
  port writes a fresh (T, V) buffer, so the training step holds T x V x
  itemsize more bytes at its peak.
- past that threshold (padded V > 131072) laser_tpu runs its two-kernel
  online VJP (loss.py:285-316): the forward runs ``ce_fwd`` and keeps
  (x, targets, lse); the backward runs ``ce_bwd`` (replacing
  laser_tpu/ops/loss.py:130 _build_ce_bwd), dx = g (exp(x - lse) - q) with
  the incoming per-row cotangent g. laser_tpu writes dx over the logits;
  the port writes a fresh buffer, so the backward holds T x V x itemsize
  more bytes at its peak (the logits and dx side by side).

``lm_cross_entropy`` has laser_tpu's two branches. Within its memory budget
the logits are made by ``gemm_ad`` and go through ``cross_entropy``. Past it
(or with ``memory_budget_bytes=None``) the vocabulary streams in ``block_v``
column chunks (loss.py:381-509): the forward is laser_tpu's online-lse loop
in torch, the backward recomputes each chunk's logits from the saved lse,
runs ``ce_bwd`` on the chunk (column offset c0, the full V) and accumulates
dh in fp32 and each chunk's d(embed) slice in an fp32 buffer, cast once.
The chunk logits are fp32 (laser_tpu's ``preferred_element_type=f32``): for
f32 operands ``torch.matmul`` with TF32 off (laser_tpu pins HIGHEST); for
bf16/f16 operands the port's GEMM kernel (csrc/gemm.cu: tensor cores, fp32
accumulator, fp32 output; a column chunk of a (D, V) embedding is copied
to a contiguous (D, block_v) tile first, since the kernel takes no leading
dimension). The backward's two products per chunk take the chunk gradient
rounded to the operands' bf16/f16 (one pass at the tensor cores' rate, as
laser_tpu's default precision runs on the TPU; its CPU interpreter takes
them in full fp32) and accumulate in fp32.

Bound on the H100: bytes for the CE kernels (read the logits once; the
fused kernel also writes dxu, ``ce_bwd`` writes dx). The routing threshold
is laser_tpu's, derived from a TPU's 16 MB VMEM working budget; on Hopper
it is a placeholder to measure again.

``plain=True`` runs the kernels' plain PyTorch versions (differentiable by
autograd in ``cross_entropy``; in the chunked branch ``ce_bwd_plain`` and
the GEMM's plain version inside the same backward); it is also what CPU
tensors run.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import registry
from ..config import pin_fp32_matmul
from ..utils import round_step_up
from .gemm.kernel import gemm_fused, gemm_plain

CE_FWD = registry.kernel("ce_fwd", "laser_tpu_torch/csrc/cross_entropy.cu",
                         "laser_tpu/ops/loss.py:41 _build_ce_fwd")
CE_FUSED_GRAD = registry.kernel("ce_fused_grad", "laser_tpu_torch/csrc/cross_entropy.cu",
                                "laser_tpu/ops/loss.py:180 _build_ce_fused_grad")
CE_BWD = registry.kernel("ce_bwd", "laser_tpu_torch/csrc/cross_entropy.cu",
                         "laser_tpu/ops/loss.py:130 _build_ce_bwd")

REDUCTIONS = ("mean", "sum", "none")


def fused_grad_bt(T: int, V: int) -> Optional[int]:
    """laser_tpu's row-block height for the one-pass value+grad kernel
    (loss.py:266-273), or None when a (bt, V) f32 block would not fit its
    4 MB share of VMEM: the port keeps the rule only to route the same
    shapes to the same kernels."""
    Vp = round_step_up(V, 128)
    bt = min(round_step_up(T, 8), ((4 * 1024 * 1024) // (4 * Vp)) // 8 * 8)
    return bt if bt >= 8 else None


def ce_rows_plain(x: torch.Tensor, targets: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-row loss in fp32 from (T, V) logits: the kernels' function in
    plain PyTorch (no launch counting; differentiable by autograd)."""
    xf = x.float()
    V = xf.shape[-1]
    m = xf.amax(dim=-1, keepdim=True).detach()
    lse = (m + torch.log(torch.exp(xf - m).sum(dim=-1, keepdim=True))).squeeze(-1)
    hit = torch.arange(V, device=x.device)[None, :] == targets.long()[:, None]
    tv = torch.where(hit, xf, 0.0).sum(dim=-1)
    if eps:
        return lse - (1.0 - eps) * tv - (eps / V) * xf.sum(dim=-1)
    return lse - tv


def _checked(x, targets):
    if x.dtype not in registry.DTYPE_CODES:
        raise TypeError(f"cross-entropy kernel: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("cross-entropy kernel: logits must be contiguous")
    if targets.device != x.device:
        raise ValueError(f"cross-entropy kernel: targets on {targets.device}, "
                         f"logits on {x.device}")
    return targets.to(torch.int32).contiguous()


def ce_fwd_plain(x: torch.Tensor, targets: torch.Tensor, eps: float):
    """The ``ce_fwd`` kernel's function in plain PyTorch: (loss, lse)."""
    CE_FWD.plain_calls += 1
    return ce_rows_plain(x, targets, eps), torch.logsumexp(x.float(), dim=-1)


def ce_fwd(x: torch.Tensor, targets: torch.Tensor, eps: float):
    """(loss, lse), both (T,) fp32, from (T, V) logits: the ``ce_fwd``
    kernel for a CUDA tensor, its plain version for a CPU tensor."""
    if not registry.on_cuda(x):
        return ce_fwd_plain(x, targets, eps)
    t32 = _checked(x, targets)
    T, V = x.shape
    loss = torch.empty((T,), dtype=torch.float32, device=x.device)
    lse = torch.empty((T,), dtype=torch.float32, device=x.device)
    if T and V:
        status = registry.load_library().ltt_ce_fwd(
            x.data_ptr(), t32.data_ptr(), loss.data_ptr(), lse.data_ptr(), T, V,
            float(eps), registry.DTYPE_CODES[x.dtype], registry.stream_handle(x))
        registry.check_launch(status, "ce_fwd")
        CE_FWD.launches += 1
    return loss, lse


def ce_fused_grad_plain(x: torch.Tensor, targets: torch.Tensor, eps: float):
    """The ``ce_fused_grad`` kernel's function in plain PyTorch: (loss (T,)
    fp32, dxu = softmax(x) - q in x's dtype)."""
    CE_FUSED_GRAD.plain_calls += 1
    xf = x.float()
    V = x.shape[-1]
    loss = ce_rows_plain(x, targets, eps)
    m = xf.amax(dim=-1, keepdim=True)
    e = torch.exp(xf - m)
    q = (torch.arange(V, device=x.device)[None, :] == targets.long()[:, None]).float()
    if eps:
        q = (1.0 - eps) * q + eps / V
    return loss, (e / e.sum(dim=-1, keepdim=True) - q).to(x.dtype)


def ce_fused_grad(x: torch.Tensor, targets: torch.Tensor, eps: float):
    """(loss, dxu): the ``ce_fused_grad`` kernel for a CUDA tensor, its plain
    version for a CPU tensor. dxu is a new buffer, not the logits."""
    if not registry.on_cuda(x):
        return ce_fused_grad_plain(x, targets, eps)
    t32 = _checked(x, targets)
    T, V = x.shape
    loss = torch.empty((T,), dtype=torch.float32, device=x.device)
    dxu = torch.empty_like(x)
    if T and V:
        status = registry.load_library().ltt_ce_fused_grad(
            x.data_ptr(), t32.data_ptr(), loss.data_ptr(), dxu.data_ptr(), T, V,
            float(eps), registry.DTYPE_CODES[x.dtype], registry.stream_handle(x))
        registry.check_launch(status, "ce_fused_grad")
        CE_FUSED_GRAD.launches += 1
    return loss, dxu


def ce_bwd_plain(x: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                 eps: float, *, c0: int = 0, V: Optional[int] = None) -> torch.Tensor:
    """The ``ce_bwd`` kernel's function in plain PyTorch: dx = g (exp(x -
    lse) - q) in x's dtype, for the columns [c0, c0 + W) of a V-column
    vocabulary (V defaults to c0 + W)."""
    CE_BWD.plain_calls += 1
    W = x.shape[1]
    V = c0 + W if V is None else V
    p = torch.exp(x.float() - lse[:, None])
    q = (torch.arange(c0, c0 + W, device=x.device)[None, :]
         == targets.long()[:, None]).float()
    if eps:
        q = (1.0 - eps) * q + eps / V
    return (g.float()[:, None] * (p - q)).to(x.dtype)


def ce_bwd(x: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
           eps: float, *, c0: int = 0, V: Optional[int] = None) -> torch.Tensor:
    """dx (T, W) in x's dtype from a (T, W) tile of logit columns [c0, c0 +
    W) of a V-column vocabulary, the forward's lse and the per-row
    cotangent g (both (T,) fp32): the ``ce_bwd`` kernel for a CUDA tensor,
    its plain version for a CPU tensor. dx is a new buffer, not x."""
    T, W = x.shape
    V = c0 + W if V is None else V
    if not 0 <= c0 <= V - W:
        raise ValueError(f"ce_bwd: columns [{c0}, {c0 + W}) outside a vocabulary of {V}")
    if not registry.on_cuda(x):
        return ce_bwd_plain(x, targets, lse, g, eps, c0=c0, V=V)
    t32 = _checked(x, targets)
    for name, t in (("lse", lse), ("g", g)):
        if t.dtype != torch.float32 or t.shape != (T,) or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"ce_bwd kernel: {name} must be a contiguous ({T},) float32 "
                             f"tensor on {x.device}")
    dx = torch.empty_like(x)
    if T and W:
        status = registry.load_library().ltt_ce_bwd(
            x.data_ptr(), t32.data_ptr(), lse.data_ptr(), g.data_ptr(), dx.data_ptr(), T, W,
            c0, V, float(eps), registry.DTYPE_CODES[x.dtype], registry.stream_handle(x))
        registry.check_launch(status, "ce_bwd")
        CE_BWD.launches += 1
    return dx


class _CERows(torch.autograd.Function):
    """Per-row loss (laser_tpu/ops/loss.py:285-316, _ce_fwd_vjp/_ce_bwd_vjp):
    the unit gradient kept as the residual, or past ``fused_grad_bt`` the
    logits and lse, with ``ce_bwd`` in the backward."""

    @staticmethod
    def forward(ctx, x, targets, eps):
        T, V = x.shape
        ctx.eps = eps
        if fused_grad_bt(T, V) is None:
            loss, lse = ce_fwd(x, targets, eps)
            ctx.save_for_backward(x, targets, lse)
            return loss
        loss, dxu = ce_fused_grad(x, targets, eps)
        ctx.save_for_backward(dxu)
        return loss

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if len(saved) == 3:
            x, targets, lse = saved
            return ce_bwd(x, targets, lse, g.float().contiguous(), ctx.eps), None, None
        dxu, = saved
        return (g.float()[:, None] * dxu.float()).to(dxu.dtype), None, None


def _ce_rows(x, targets, eps, plain):
    grad = torch.is_grad_enabled() and x.requires_grad
    if plain:  # counted as the kernels this call stands in for
        if not grad:
            CE_FWD.plain_calls += 1
        elif fused_grad_bt(*x.shape) is None:
            CE_FWD.plain_calls += 1
            CE_BWD.plain_calls += 1
        else:
            CE_FUSED_GRAD.plain_calls += 1
        return ce_rows_plain(x, targets, eps)
    if grad:
        return _CERows.apply(x, targets, eps)
    return ce_fwd(x, targets, eps)[0]


def _check_args(reduction, label_smoothing):
    if reduction not in REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r}")
    eps = float(label_smoothing)
    if not 0.0 <= eps < 1.0:
        raise ValueError(f"label_smoothing must be in [0, 1); got {eps}")
    return eps


def _reduce_rows(loss, valid, reduction, lead):
    if valid is not None:
        # zeroing the row also zeroes its cotangent, so its dx row vanishes
        loss = torch.where(valid, loss, 0.0)
    if reduction == "none":
        return loss.reshape(*lead) if lead else loss[0]
    if reduction == "sum":
        return loss.sum()
    if valid is not None:  # mean over the contributing rows only
        return loss.sum() / valid.sum().clamp(min=1)
    return loss.mean()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                  reduction: str = "mean", label_smoothing: float = 0.0,
                  ignore_index: Optional[int] = None,
                  plain: bool = False) -> torch.Tensor:
    """Cross-entropy from raw logits: loss_t = lse(x_t) - x_t[y_t].

    logits (..., V) float, targets (...) int; leading dims flatten into
    rows. ``reduction``: "mean" | "sum" | "none" (per-row fp32 losses in the
    leading shape). Rows whose target equals ``ignore_index`` contribute
    zero loss and zero gradient; "mean" divides by the count of
    contributing rows."""
    eps = _check_args(reduction, label_smoothing)
    *lead, V = logits.shape
    if tuple(targets.shape) != tuple(lead):
        raise ValueError(f"targets shape {tuple(targets.shape)} != logits leading "
                         f"dims {tuple(lead)}")
    T = math.prod(lead)
    targets = targets.reshape(T)
    valid = None
    if ignore_index is not None:
        valid = targets != ignore_index
        targets = torch.where(valid, targets, 0)  # any in-range stand-in
    loss = _ce_rows(logits.reshape(T, V).contiguous(), targets, eps, plain)
    return _reduce_rows(loss, valid, reduction, lead)


def _product(a, b, transpose_a: bool, transpose_b: bool, plain: bool, acc=None):
    """fp32 op(a) @ op(b) (+ acc): f32 operands by ``torch.matmul`` with TF32
    off, bf16/f16 operands by the GEMM kernel with an fp32 output (its plain
    version with ``plain``)."""
    if a.dtype == torch.float32:
        pin_fp32_matmul()
        A, B = (a.t() if transpose_a else a), (b.t() if transpose_b else b)
        return torch.matmul(A, B) if acc is None else torch.addmm(acc, A, B)
    kw = dict(out_dtype=torch.float32, transpose_a=transpose_a, transpose_b=transpose_b)
    if acc is not None:
        kw.update(c=acc, beta=1.0)
    if plain:
        return gemm_plain(a, b, **kw)
    return gemm_fused(a.contiguous(), b.contiguous(), **kw)


def _chunk(emb, c0: int, c1: int, transb: bool):
    """Vocabulary columns [c0, c1) of the unembedding: (W, D) rows of the
    tied (V, D) layout, or (D, W) columns of the (D, V) layout (a view)."""
    return emb[c0:c1] if transb else emb[:, c0:c1]


def _lmce_forward(h, emb, targets, eps, bv, transb, plain):
    """Per-row (loss, lse), both (T,) fp32: laser_tpu's online-lse loop over
    the vocabulary chunks (loss.py:412-445), the last one ragged."""
    T = h.shape[0]
    V = emb.shape[0] if transb else emb.shape[1]
    m = torch.full((T,), -math.inf, dtype=torch.float32, device=h.device)
    s, tv, sv = (torch.zeros((T,), dtype=torch.float32, device=h.device) for _ in range(3))
    for c0 in range(0, V, bv):
        c1 = min(c0 + bv, V)
        lg = _product(h, _chunk(emb, c0, c1, transb), False, transb, plain)
        m_new = torch.maximum(m, lg.amax(dim=-1))
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        neg = lg == -math.inf
        e = torch.exp(lg - m_new[:, None]).masked_fill_(neg, 0.0)
        s = s * corr + e.sum(dim=-1)
        m = m_new
        # the target's logit (laser_tpu sums the masked chunk: the same value)
        hit = (targets >= c0) & (targets < c1)
        col = (targets - c0).clamp(0, c1 - c0 - 1).long()
        tv = tv + torch.where(hit, lg.gather(1, col[:, None])[:, 0], 0.0)
        if eps:
            sv = sv + lg.masked_fill_(neg, 0.0).sum(dim=-1)
    lse = m + torch.log(s)
    if eps:
        return lse - (1.0 - eps) * tv - (eps / V) * sv, lse
    return lse - tv, lse


class _LMChunked(torch.autograd.Function):
    """laser_tpu's ``_lmce_rows`` custom VJP (loss.py:448-509): saves (h,
    emb, targets, lse); the backward recomputes each chunk's logits, runs
    ``ce_bwd`` on them and accumulates dh and d(embed) in fp32."""

    @staticmethod
    def forward(ctx, h, emb, targets, eps, bv, transb, plain):
        loss, lse = _lmce_forward(h, emb, targets, eps, bv, transb, plain)
        ctx.save_for_backward(h, emb, targets, lse)
        ctx.cfg = (eps, bv, transb, plain)
        return loss

    @staticmethod
    def backward(ctx, g):
        h, emb, targets, lse = ctx.saved_tensors
        eps, bv, transb, plain = ctx.cfg
        V = emb.shape[0] if transb else emb.shape[1]
        g = g.float().contiguous()
        bwd = ce_bwd_plain if plain else ce_bwd
        dh = None
        demb = torch.empty(emb.shape, dtype=torch.float32, device=emb.device)
        for c0 in range(0, V, bv):
            c1 = min(c0 + bv, V)
            rows = _chunk(emb, c0, c1, transb)
            lg = _product(h, rows, False, transb, plain)
            dl = bwd(lg, targets, lse, g, eps, c0=c0, V=V).to(h.dtype)
            if transb:  # rows (W, D): dh += dl rows, d(rows) = dl^T h
                dh = _product(dl, rows, False, False, plain, acc=dh)
                demb[c0:c1] = _product(dl, h, True, False, plain)
            else:  # columns (D, W): dh += dl cols^T, d(cols) = h^T dl
                dh = _product(dl, rows, False, True, plain, acc=dh)
                demb[:, c0:c1] = _product(h, dl, True, False, plain)
        return dh.to(h.dtype), demb.to(emb.dtype), None, None, None, None, None


def _lmce_rows(h, emb, targets, eps, bv, transb, plain):
    if torch.is_grad_enabled() and (h.requires_grad or emb.requires_grad):
        return _LMChunked.apply(h, emb, targets, eps, bv, transb, plain)
    return _lmce_forward(h, emb, targets, eps, bv, transb, plain)[0]


def lm_cross_entropy(hidden: torch.Tensor, embed: torch.Tensor,
                     targets: torch.Tensor, *, transb: bool = True,
                     reduction: str = "mean", label_smoothing: float = 0.0,
                     ignore_index: Optional[int] = None, block_v: int = 8192,
                     memory_budget_bytes: Optional[int] = 1024 ** 3,
                     plain: bool = False) -> torch.Tensor:
    """Cross-entropy of the unembedding projection: logits = hidden @
    embed.T (``transb``, the tied (V, D) layout) or hidden @ embed ((D, V)).

    When 2 x T x Vp x itemsize fits ``memory_budget_bytes`` the logits are
    made by ``gemm_ad`` in the hidden dtype (bf16 logits for bf16 hidden
    states, as laser_tpu makes them) and go through :func:`cross_entropy`.
    Past the budget, or with ``memory_budget_bytes=None``, the vocabulary
    streams in chunks of ``block_v`` (rounded up to 128, at most the padded
    V) columns with online-logsumexp carries; the last chunk is ragged (see
    the module docstring for the products' precision)."""
    from .gemm.autodiff import gemm_ad

    eps = _check_args(reduction, label_smoothing)
    *lead, D = hidden.shape
    V, De = embed.shape if transb else embed.shape[::-1]
    if De != D:
        raise ValueError(f"embed shape {tuple(embed.shape)} does not match hidden "
                         f"width {D} (transb={transb})")
    if tuple(targets.shape) != tuple(lead):
        raise ValueError(f"targets shape {tuple(targets.shape)} != hidden leading "
                         f"dims {tuple(lead)}")
    T = math.prod(lead)
    Vp = round_step_up(V, 128)
    if memory_budget_bytes is not None and \
            2 * T * Vp * hidden.element_size() <= memory_budget_bytes:
        logits = gemm_ad(hidden.reshape(T, D), embed, None, False, bool(transb))
        loss = cross_entropy(logits, targets.reshape(T), reduction=reduction,
                             label_smoothing=eps, ignore_index=ignore_index, plain=plain)
        return loss.reshape(*lead) if reduction == "none" else loss
    bv = max(128, min(round_step_up(block_v, 128), Vp))
    dt = torch.promote_types(hidden.dtype, embed.dtype)
    targets = targets.reshape(T)
    valid = None
    if ignore_index is not None:
        valid = targets != ignore_index
        targets = torch.where(valid, targets, 0)
    loss = _lmce_rows(hidden.reshape(T, D).to(dt), embed.to(dt), targets.to(torch.int32),
                      eps, bv, bool(transb), plain)
    return _reduce_rows(loss, valid, reduction, lead)
