"""Llama-family decoder (port of laser_tpu/models/llama.py, the serving
subset): RMSNorm -> RoPE -> grouped-query flash attention -> SwiGLU FFN,
untied embeddings.

Params keep laser_tpu's layout, so both packages compute the same function
on the same numbers: ``embed`` (vocab, D), ``unembed`` (D, vocab); per block
``wq`` (D, Hq*hd), ``wkv`` (D, 2*Hkv*hd) with columns [all K heads | all V
heads], ``wo`` (Hq*hd, D), ``w_gate``, ``w_up`` (D, d_ff), ``w_down``
(d_ff, D), the RMSNorm gains ``rms1``, ``rms2``; ``rms_f``; and the f32
``rope_cos``/``rope_sin`` tables. Matrices are (in, out). Every linear is
the fused kernel with a zero bias, as laser_tpu's ``linear(x, w, None)``;
SwiGLU is ``F.silu(gate) * up`` in plain torch, as ``jax.nn.silu`` is
outside any kernel there.

Forward: ``llama_hidden``, ``llama_forward``, the KV-cached
``llama_prefill`` / ``llama_decode_step`` and ``llama_generate`` (greedy at
temperature 0, else the port's ``sample_logits_batch``). Training, on one
device: ``llama_lm_loss`` (the unembedding fused into
``lm_cross_entropy``'s chunked-vocabulary branch past its memory budget,
``transb=False``), ``llama_train_init`` / ``llama_train_step`` (AdamW on its
default backend, ``clip_norm``, ``accum``, ``remat``: each block under
``torch.utils.checkpoint``, recomputed in the backward) and the
mixed-precision ``llama_cast`` / ``llama_train_init_mp`` /
``llama_train_step_mp`` (a bf16 compute tree, fp32 masters and moments).
Attention under autograd is ``attention_gqa_trainable`` (the GQA flash
forward; the MHA flash backward kernels on K/V expanded across each group).
The steps update in place, as the port's ``transformer_train_step``: the
returned trees are the caller's, changed. The rope tables are not trained
(``_STATIC_KEYS``). ``memory_budget_bytes`` (the port's; laser_tpu's
``llama_lm_loss`` keeps ``lm_cross_entropy``'s 1 GiB) picks the loss's
branch. ``window`` and the parallel steps are not ported. ``plain=True``
routes every kernel op through its plain PyTorch version on any device:
the dense reference the kernels are held against (under autograd its
attention and norm gradients are PyTorch's own). ``init_llama`` and
``init_llama_cache`` allocate on the card unless the caller passes
``device``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import pin_fp32_matmul
from ..ops.attention import attention_gqa_reference, attention_gqa_trainable
from ..ops.gemm import gemm_ad, linear, linear_reference
from ..ops.loss import lm_cross_entropy
from ..ops.norm import rms_norm, rms_norm_reference
from ..ops.optim import (accumulated_value_and_grad, adamw_init, adamw_step,
                         clip_by_global_norm, tree_leaves, tree_map)
from ..ops.rope import apply_rope, rope_tables
from ..ops.sampling import sample_logits_batch
from .transformer import _generator, _normal

Params = Dict


def _ops(plain: bool):
    if plain:
        return linear_reference, rms_norm_reference, attention_gqa_reference
    # the value-only attention_gqa when no gradient is needed
    return linear, rms_norm, attention_gqa_trainable


def _check_window(window=None):
    if window is not None:
        raise NotImplementedError("window (sliding-window attention) is not ported "
                                  "to the llama family")


def init_llama(seed: Union[int, torch.Generator] = 0, *, n_layers: int, d_model: int,
               n_heads: int, n_kv_heads: int, d_ff: int, vocab: int, max_len: int = 2048,
               dtype=torch.float32, device="cuda") -> Params:
    """Random params from one ``torch.Generator`` on ``device``: laser_tpu's
    schema and scales (normal * sqrt(1/d_model), ``w_down`` * sqrt(1/d_ff),
    ``embed`` * 0.02, unit gains), not its PRNG bits. The rope tables cover
    ``max_len`` positions at base 10000."""
    if d_model % n_heads or n_heads % n_kv_heads:
        raise ValueError("d_model % n_heads and n_heads % n_kv_heads must be 0")
    hd = d_model // n_heads
    g = _generator(seed, device)
    s, sf = math.sqrt(1.0 / d_model), math.sqrt(1.0 / d_ff)

    def normal(shape, std):
        return _normal(g, shape, std, dtype, device)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    blocks = [{
        "wq": normal((d_model, n_heads * hd), s),
        "wkv": normal((d_model, 2 * n_kv_heads * hd), s),
        "wo": normal((n_heads * hd, d_model), s),
        "w_gate": normal((d_model, d_ff), s),
        "w_up": normal((d_model, d_ff), s),
        "w_down": normal((d_ff, d_model), sf),
        "rms1": ones(d_model),
        "rms2": ones(d_model),
    } for _ in range(n_layers)]
    cos, sin = rope_tables(max_len, hd, device=device)
    return {
        "embed": normal((vocab, d_model), 0.02),
        "unembed": normal((d_model, vocab), s),
        "blocks": blocks,
        "rms_f": ones(d_model),
        "rope_cos": cos, "rope_sin": sin,
    }


def _qkv(blk, x, B, S, H, Hkv, hd, cos, sin, pos: int = 0, plain: bool = False):
    """x (B, S, D) -> q (B, H, S, hd), k, v (B, Hkv, S, hd); q and k rotated
    at positions [pos, pos + S)."""
    lin = _ops(plain)[0]
    D = x.shape[-1]
    q = lin(x.reshape(B * S, D), blk["wq"]).reshape(B, S, H, hd).transpose(1, 2)
    kv = lin(x.reshape(B * S, D), blk["wkv"]).reshape(B, S, 2, Hkv, hd).permute(2, 0, 3, 1, 4)
    q = apply_rope(q, cos, sin, position_offset=pos)
    k = apply_rope(kv[0], cos, sin, position_offset=pos)
    return q, k, kv[1]


def _ffn(blk, h2, lin):
    """SwiGLU: w_down(silu(w_gate h) * w_up h)."""
    return lin(F.silu(lin(h2, blk["w_gate"])) * lin(h2, blk["w_up"]), blk["w_down"])


def _block(blk, x, H: int, Hkv: int, cos, sin, plain: bool):
    """One decoder block: x + attention(RMSNorm(x)); x + SwiGLU(RMSNorm(x))."""
    lin, rms, att = _ops(plain)
    B, S, D = x.shape
    hd = D // H
    q, k, v = _qkv(blk, rms(x, blk["rms1"]), B, S, H, Hkv, hd, cos, sin, plain=plain)
    o = att(q, k, v, causal=True).transpose(1, 2).reshape(B * S, H * hd)
    x = x + lin(o, blk["wo"]).reshape(B, S, D)
    return x + _ffn(blk, rms(x, blk["rms2"]).reshape(B * S, D), lin).reshape(B, S, D)


def llama_hidden(params: Params, tokens: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                 window=None, remat: bool = False, plain: bool = False) -> torch.Tensor:
    """tokens (B, S) int -> final-RMSNorm hidden states (B, S, D), causal.

    ``remat=True`` runs each block under ``torch.utils.checkpoint``
    (non-reentrant): the backward recomputes the block's activations
    instead of keeping them, one more forward per block (laser_tpu's
    ``jax.checkpoint``)."""
    _check_window(window)
    x = params["embed"][tokens.long()]
    cos, sin = params["rope_cos"], params["rope_sin"]
    remat = remat and torch.is_grad_enabled()
    for blk in params["blocks"]:
        args = (blk, x, n_heads, n_kv_heads, cos, sin, plain)
        x = checkpoint(_block, *args, use_reentrant=False) if remat else _block(*args)
    return _ops(plain)[1](x, params["rms_f"])


@torch.no_grad()
def llama_forward(params: Params, tokens: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                  window=None, plain: bool = False) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab). Causal."""
    x = llama_hidden(params, tokens, n_heads=n_heads, n_kv_heads=n_kv_heads, window=window,
                     plain=plain)
    B, S, D = x.shape
    return gemm_ad(x.reshape(B * S, D), params["unembed"]).reshape(B, S, -1)


# ---------------------------------------------------------------------------
# Training: the chunked-vocabulary LM loss and AdamW
# ---------------------------------------------------------------------------

_STATIC_KEYS = ("rope_cos", "rope_sin")  # precomputed tables, not trained


def llama_lm_loss(params: Params, tokens: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                  window=None, label_smoothing: float = 0.0, ignore_index=None,
                  remat: bool = False, memory_budget_bytes: Optional[int] = 1024 ** 3,
                  plain: bool = False) -> torch.Tensor:
    """Next-token cross entropy through the untied (D, vocab) ``unembed``
    (``lm_cross_entropy(..., transb=False)``); the fp32 mean loss over B x
    (S - 1) targets. ``ignore_index`` targets contribute zero loss and
    gradient, and such tokens are clamped to 0 before the embedding
    lookup."""
    tokens = tokens.long()
    targets = tokens[:, 1:]
    if ignore_index is not None:
        tokens = torch.where(tokens == ignore_index, 0, tokens)
    x = llama_hidden(params, tokens, n_heads=n_heads, n_kv_heads=n_kv_heads, window=window,
                     remat=remat, plain=plain)
    return lm_cross_entropy(x[:, :-1], params["unembed"], targets, transb=False,
                            label_smoothing=label_smoothing, ignore_index=ignore_index,
                            memory_budget_bytes=memory_budget_bytes, plain=plain)


def _trainable(params: Params) -> Params:
    return {k: v for k, v in params.items() if k not in _STATIC_KEYS}


def llama_train_init(params: Params):
    """AdamW state (m, v) for the trainable subset of ``params``."""
    return adamw_init(_trainable(params))


def _llama_loss_grads(params, tokens, *, accum: int, **loss_kw):
    static = {k: params[k] for k in _STATIC_KEYS}

    def loss_fn(tp, toks):
        return llama_lm_loss({**tp, **static}, toks, **loss_kw)

    train = _trainable(params)
    loss, grads = accumulated_value_and_grad(loss_fn, accum)(train, tokens)
    return train, loss, grads


def llama_train_step(params: Params, opt_state, tokens: torch.Tensor, step, *, n_heads: int,
                     n_kv_heads: int, lr=1e-3, weight_decay: float = 0.0, window=None,
                     label_smoothing: float = 0.0, clip_norm=None, accum: int = 1,
                     remat: bool = False, ignore_index=None,
                     memory_budget_bytes: Optional[int] = 1024 ** 3, plain: bool = False):
    """One AdamW step; returns (params, (m, v), loss). ``step`` is the
    1-based count; ``lr`` a float or a schedule's 0-d tensor. clip_norm:
    global-L2 gradient clipping; accum: microbatches run one after another;
    remat: recompute each block's activations in the backward. The update
    is IN PLACE: the returned trees are the caller's, changed; the rope
    tables are untouched."""
    train, loss, grads = _llama_loss_grads(
        params, tokens, accum=accum, n_heads=n_heads, n_kv_heads=n_kv_heads, window=window,
        label_smoothing=label_smoothing, ignore_index=ignore_index, remat=remat,
        memory_budget_bytes=memory_budget_bytes, plain=plain)
    if clip_norm is not None:
        grads, _ = clip_by_global_norm(grads, clip_norm)
    m, v = opt_state
    adamw_step(train, grads, m, v, step, lr=lr, weight_decay=weight_decay)
    return params, (m, v), loss


def llama_cast(params: Params, dtype=torch.bfloat16) -> Params:
    """A new tree with every float leaf, the rope tables included, cast to
    ``dtype`` (the compute tree of mixed-precision training)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def llama_train_init_mp(params: Params, master_dtype=torch.float32):
    """(m, v, master) for mixed-precision AdamW: masters copied from the
    (bf16) compute tree in ``master_dtype``, moments of the masters' dtype."""
    master = tree_map(lambda p: p.to(master_dtype, copy=True), _trainable(params))
    m, v = adamw_init(master)
    return m, v, master


def llama_train_step_mp(params: Params, opt_state, tokens: torch.Tensor, step, *,
                        n_heads: int, n_kv_heads: int, lr=1e-3, weight_decay: float = 0.0,
                        window=None, label_smoothing: float = 0.0, clip_norm=None,
                        accum: int = 1, remat: bool = False, ignore_index=None,
                        memory_budget_bytes: Optional[int] = 1024 ** 3, plain: bool = False):
    """Mixed-precision AdamW step: ``params`` is the compute tree
    (``llama_cast``), ``opt_state`` = (m, v, master). Loss and gradients run
    in the compute dtype, the gradients are cast to fp32, the masters take
    the update and the compute params become the masters rounded to their
    dtype, in place. Returns (params, (m, v, master), loss)."""
    train, loss, grads = _llama_loss_grads(
        params, tokens, accum=accum, n_heads=n_heads, n_kv_heads=n_kv_heads, window=window,
        label_smoothing=label_smoothing, ignore_index=ignore_index, remat=remat,
        memory_budget_bytes=memory_budget_bytes, plain=plain)
    grads = tree_map(lambda g: g.float(), grads)
    if clip_norm is not None:
        grads, _ = clip_by_global_norm(grads, clip_norm)
    m, v, master = opt_state
    adamw_step(master, grads, m, v, step, lr=lr, weight_decay=weight_decay)
    with torch.no_grad():
        for p, mw in zip(tree_leaves(train), tree_leaves(master), strict=True):
            p.copy_(mw)
    return params, (m, v, master), loss


# ---------------------------------------------------------------------------
# Serving: flash prefill + KV-cached decode (GQA caches hold Hkv heads)
# ---------------------------------------------------------------------------

def init_llama_cache(params: Params, B: int, max_len: int, *, n_heads: int, n_kv_heads: int,
                     device="cuda") -> torch.Tensor:
    """Per-layer K/V caches shaped (L, 2, B*Hkv, max_len, hd) in the params'
    dtype."""
    hd = params["embed"].shape[1] // n_heads
    return torch.zeros((len(params["blocks"]), 2, B * n_kv_heads, max_len, hd),
                       dtype=params["embed"].dtype, device=device)


@torch.no_grad()
def llama_prefill(params: Params, prompt: torch.Tensor, cache: torch.Tensor, *, n_heads: int,
                  n_kv_heads: int, window=None, plain: bool = False) -> torch.Tensor:
    """One causal GQA flash forward over the prompt (B, S) that writes every
    position's K/V into ``cache`` in place (laser_tpu returns an updated
    copy). Returns the last position's logits (B, vocab)."""
    _check_window(window)
    lin, rms, att = _ops(plain)
    H, Hkv = n_heads, n_kv_heads
    x = params["embed"][prompt.long()]
    B, S, D = x.shape
    hd = D // H
    cos, sin = params["rope_cos"], params["rope_sin"]
    for li, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(blk, rms(x, blk["rms1"]), B, S, H, Hkv, hd, cos, sin, plain=plain)
        cache[li, 0, :, :S] = k.reshape(B * Hkv, S, hd)
        cache[li, 1, :, :S] = v.reshape(B * Hkv, S, hd)
        o = att(q, k, v, causal=True).transpose(1, 2).reshape(B * S, H * hd)
        x = x + lin(o, blk["wo"]).reshape(B, S, D)
        x = x + _ffn(blk, rms(x, blk["rms2"]).reshape(B * S, D), lin).reshape(B, S, D)
    return gemm_ad(rms(x[:, -1], params["rms_f"]), params["unembed"])


@torch.no_grad()
def llama_decode_step(params: Params, cache: torch.Tensor, token: torch.Tensor, pos: int, *,
                      n_heads: int, n_kv_heads: int, window=None,
                      plain: bool = False) -> torch.Tensor:
    """One incremental step: token (B,) at position ``pos``; writes its K/V
    into ``cache`` in place and attends over cache[.., :pos + 1], each group
    of Hq / Hkv query heads against its kv head, with a masked matvec in
    fp32 (TF32 off). Returns logits (B, vocab)."""
    _check_window(window)
    pin_fp32_matmul()
    lin, rms, _ = _ops(plain)
    H, Hkv = n_heads, n_kv_heads
    B = token.shape[0]
    D = params["embed"].shape[1]
    hd = D // H
    scale = 1.0 / math.sqrt(hd)
    cos, sin = params["rope_cos"], params["rope_sin"]
    x = params["embed"][token.long()][:, None, :]
    for li, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(blk, rms(x, blk["rms1"]), B, 1, H, Hkv, hd, cos, sin, pos=pos,
                       plain=plain)
        cache[li, 0, :, pos:pos + 1] = k.reshape(B * Hkv, 1, hd)
        cache[li, 1, :, pos:pos + 1] = v.reshape(B * Hkv, 1, hd)
        kc = cache[li, 0, :, :pos + 1].reshape(B, Hkv, pos + 1, hd).float()
        vc = cache[li, 1, :, :pos + 1].reshape(B, Hkv, pos + 1, hd).float()
        qf = q.reshape(B, Hkv, H // Hkv, hd).float()
        s = torch.matmul(qf, kc.transpose(-1, -2)) * scale
        o = torch.matmul(torch.softmax(s, dim=-1), vc).to(x.dtype).reshape(B, H * hd)
        x = x + lin(o, blk["wo"]).reshape(B, 1, D)
        x = x + _ffn(blk, rms(x, blk["rms2"]).reshape(B, D), lin).reshape(B, 1, D)
    return gemm_ad(rms(x[:, 0], params["rms_f"]), params["unembed"])


@torch.no_grad()
def llama_generate(params: Params, prompt: torch.Tensor, seed: int = 0, *, n_heads: int,
                   n_kv_heads: int, max_new_tokens: int, temperature: float = 0.0,
                   top_k: int = 0, top_p: float = 1.0, window=None,
                   plain: bool = False) -> torch.Tensor:
    """Flash prefill + KV-cached generation: prompt (B, S0) -> tokens
    (B, S0 + max_new_tokens). Greedy at temperature 0; otherwise the token
    at index i is drawn by ``sample_logits_batch`` from (seed, i), so it does
    not reproduce laser_tpu's PRNG bits."""
    _check_window(window)
    B, S0 = prompt.shape
    total = S0 + max_new_tokens
    cache = init_llama_cache(params, B, total, n_heads=n_heads, n_kv_heads=n_kv_heads,
                             device=prompt.device)
    tokens = torch.zeros((B, total), dtype=torch.long, device=prompt.device)
    tokens[:, :S0] = prompt

    def sample(pos, logits):
        return sample_logits_batch([seed] * B, [pos] * B, logits, [temperature] * B,
                                   [top_k] * B, [top_p] * B)

    logits = llama_prefill(params, prompt, cache, n_heads=n_heads, n_kv_heads=n_kv_heads,
                           plain=plain)
    tokens[:, S0] = sample(S0, logits)
    for i in range(S0, total - 1):
        logits = llama_decode_step(params, cache, tokens[:, i], i, n_heads=n_heads,
                                   n_kv_heads=n_kv_heads, plain=plain)
        tokens[:, i + 1] = sample(i + 1, logits)
    return tokens
