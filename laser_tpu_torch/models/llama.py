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

Forward only: ``llama_hidden``, ``llama_forward``, the KV-cached
``llama_prefill`` / ``llama_decode_step`` and ``llama_generate`` (greedy at
temperature 0, else the port's ``sample_logits_batch``). Training
(``llama_train_step`` and its parallel forms), ``remat`` and ``window``
are not ported: the GQA flash backward does not exist yet. ``plain=True``
routes every kernel op through its plain PyTorch version on any device:
the dense reference the kernels are held against. ``init_llama`` and
``init_llama_cache`` allocate on the card unless the caller passes
``device``.
"""

from __future__ import annotations

import math
from typing import Dict, Union

import torch
import torch.nn.functional as F

from ..config import pin_fp32_matmul
from ..ops.attention import attention_gqa, attention_gqa_reference
from ..ops.gemm import gemm_ad, linear, linear_reference
from ..ops.norm import rms_norm, rms_norm_reference
from ..ops.rope import apply_rope, rope_tables
from ..ops.sampling import sample_logits_batch
from .transformer import _generator, _normal

Params = Dict


def _ops(plain: bool):
    if plain:
        return linear_reference, rms_norm_reference, attention_gqa_reference
    return linear, rms_norm, attention_gqa


def _check_unported(window=None, remat: bool = False):
    if window is not None:
        raise NotImplementedError("window (sliding-window attention) is not ported "
                                  "to the llama family")
    if remat:
        raise NotImplementedError("remat is a training option; llama training is not ported")


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


def llama_hidden(params: Params, tokens: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                 window=None, remat: bool = False, plain: bool = False) -> torch.Tensor:
    """tokens (B, S) int -> final-RMSNorm hidden states (B, S, D), causal."""
    _check_unported(window, remat)
    lin, rms, att = _ops(plain)
    H, Hkv = n_heads, n_kv_heads
    x = params["embed"][tokens.long()]
    B, S, D = x.shape
    hd = D // H
    cos, sin = params["rope_cos"], params["rope_sin"]
    for blk in params["blocks"]:
        q, k, v = _qkv(blk, rms(x, blk["rms1"]), B, S, H, Hkv, hd, cos, sin, plain=plain)
        o = att(q, k, v, causal=True).transpose(1, 2).reshape(B * S, H * hd)
        x = x + lin(o, blk["wo"]).reshape(B, S, D)
        x = x + _ffn(blk, rms(x, blk["rms2"]).reshape(B * S, D), lin).reshape(B, S, D)
    return rms(x, params["rms_f"])


@torch.no_grad()
def llama_forward(params: Params, tokens: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                  window=None, plain: bool = False) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab). Causal."""
    x = llama_hidden(params, tokens, n_heads=n_heads, n_kv_heads=n_kv_heads, window=window,
                     plain=plain)
    B, S, D = x.shape
    return gemm_ad(x.reshape(B * S, D), params["unembed"]).reshape(B, S, -1)


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
    _check_unported(window)
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
    _check_unported(window)
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
    _check_unported(window)
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
