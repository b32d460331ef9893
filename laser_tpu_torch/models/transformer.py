"""Pre-norm transformer (port of laser_tpu/models/transformer.py): params
schema, init, forward, KV-cached prefill/decode, the dense greedy reference,
and training (``transformer_lm_loss``, ``transformer_train_init``,
``transformer_train_step``).

Params keep laser_tpu's layout so both packages compute the same function on
the same numbers: ``embed`` (vocab, D) tied with the unembedding; per block
``wqkv`` (D, 3D) with columns [q | k | v], ``wo`` (D, D), ``w1`` (D, d_ff),
``w2`` (d_ff, D), their biases, and ``ln1``/``ln2`` gains and biases;
``lnf_g``/``lnf_b``. Matrices are (in, out). bf16 rounds where laser_tpu
rounds: every norm and linear returns the input dtype and residual adds run
in the params dtype.

``plain=True`` routes every kernel op through its plain PyTorch version on
any device; that is the dense reference the kernels are held against, and
under autograd its gradients are PyTorch's own, independent of the port's
backward kernels. Entry points that allocate (``init_transformer``,
``init_decode_cache``) put their tensors on the card unless the caller
passes ``device``.
"""

from __future__ import annotations

import math
from typing import Dict, Union

import torch

from ..ops.attention import attention, attention_reference, attention_trainable
from ..ops.gemm import gemm_ad, linear, linear_reference
from ..ops.loss import lm_cross_entropy
from ..ops.norm import layer_norm, layer_norm_reference
from ..ops.optim import accumulated_value_and_grad, adamw_init, adamw_step, clip_by_global_norm

Params = Dict


def _ops(plain: bool):
    if plain:
        return linear_reference, layer_norm_reference, attention_reference
    # laser_tpu's transformer imports attention_trainable as attention
    return linear, layer_norm, attention_trainable


def _generator(seed: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _normal(g, shape, std, dtype, device):
    return (torch.randn(shape, generator=g, device=device, dtype=torch.float32)
            * std).to(dtype)


def init_transformer_block(g: torch.Generator, d_model: int, n_heads: int,
                           d_ff: int, dtype=torch.float32, device="cuda") -> Params:
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by n_heads {n_heads}")
    s = math.sqrt(1.0 / d_model)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    return {
        "wqkv": _normal(g, (d_model, 3 * d_model), s, dtype, device),
        "bqkv": zeros(3 * d_model),
        "wo": _normal(g, (d_model, d_model), s, dtype, device),
        "bo": zeros(d_model),
        "w1": _normal(g, (d_model, d_ff), s, dtype, device),
        "b1": zeros(d_ff),
        "w2": _normal(g, (d_ff, d_model), math.sqrt(1.0 / d_ff), dtype, device),
        "b2": zeros(d_model),
        "ln1_g": ones(d_model), "ln1_b": zeros(d_model),
        "ln2_g": ones(d_model), "ln2_b": zeros(d_model),
    }


def init_transformer(seed: Union[int, torch.Generator] = 0, *, n_layers: int,
                     d_model: int, n_heads: int, d_ff: int, vocab: int,
                     dtype=torch.float32, device="cuda") -> Params:
    """Random params from one ``torch.Generator`` on ``device`` (the same
    distributions as laser_tpu's init; not its PRNG bits)."""
    g = _generator(seed, device)
    return {
        "embed": _normal(g, (vocab, d_model), 0.02, dtype, device),
        "blocks": [init_transformer_block(g, d_model, n_heads, d_ff, dtype, device)
                   for _ in range(n_layers)],
        "lnf_g": torch.ones((d_model,), dtype=dtype, device=device),
        "lnf_b": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def split_heads(t: torch.Tensor, B: int, S: int, n_heads: int) -> torch.Tensor:
    """(B*S, D) -> (B, H, S, hd), contiguous."""
    return t.reshape(B, S, n_heads, -1).transpose(1, 2).contiguous()


def transformer_block(params: Params, x: torch.Tensor, *, n_heads: int,
                      causal: bool = True, plain: bool = False) -> torch.Tensor:
    """x + MHA(LN(x)); x + FFN(LN(x)). x: (B, S, D)."""
    lin, ln, att = _ops(plain)
    B, S, D = x.shape
    h = ln(x, params["ln1_g"], params["ln1_b"])
    qkv = lin(h.reshape(B * S, D), params["wqkv"], params["bqkv"])
    q, k, v = (split_heads(t, B, S, n_heads) for t in qkv.split(D, dim=-1))
    o = att(q, k, v, causal=causal)
    o = o.transpose(1, 2).reshape(B * S, D)
    x = x + lin(o, params["wo"], params["bo"]).reshape(B, S, D)
    h = ln(x, params["ln2_g"], params["ln2_b"])
    f = lin(h.reshape(B * S, D), params["w1"], params["b1"], "gelu")
    return x + lin(f, params["w2"], params["b2"]).reshape(B, S, D)


def transformer_hidden(params: Params, tokens: torch.Tensor, *, n_heads: int,
                       causal: bool = True, plain: bool = False) -> torch.Tensor:
    """tokens (B, S) int -> final-norm hidden states (B, S, D)."""
    _, ln, _ = _ops(plain)
    x = params["embed"][tokens]
    for blk in params["blocks"]:
        x = transformer_block(blk, x, n_heads=n_heads, causal=causal, plain=plain)
    return ln(x, params["lnf_g"], params["lnf_b"])


def transformer_forward(params: Params, tokens: torch.Tensor, *, n_heads: int,
                        causal: bool = True, plain: bool = False) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab)."""
    x = transformer_hidden(params, tokens, n_heads=n_heads, causal=causal, plain=plain)
    B, S, D = x.shape
    return gemm_ad(x.reshape(B * S, D), params["embed"], None, False, True).reshape(B, S, -1)


# ---------------------------------------------------------------------------
# Training: the tied-embedding LM loss and one AdamW step
# ---------------------------------------------------------------------------

def _check_window(window):
    if window is not None:
        raise NotImplementedError("window (sliding-window attention) is not "
                                  "ported to the training path")


def transformer_lm_loss(params: Params, tokens: torch.Tensor, *, n_heads: int,
                        window=None, label_smoothing: float = 0.0,
                        ignore_index=None, plain: bool = False) -> torch.Tensor:
    """Next-token cross entropy through the tied (vocab, D) embedding
    (``lm_cross_entropy``, its materialized branch). tokens (B, S) int; the
    fp32 mean loss over B x (S - 1) targets. ``ignore_index`` targets
    contribute zero loss and gradient, and such tokens are clamped to 0
    before the embedding lookup."""
    _check_window(window)
    tokens = tokens.long()
    targets = tokens[:, 1:]
    if ignore_index is not None:
        tokens = torch.where(tokens == ignore_index, 0, tokens)
    x = transformer_hidden(params, tokens, n_heads=n_heads, causal=True, plain=plain)
    return lm_cross_entropy(x[:, :-1], params["embed"], targets,
                            label_smoothing=label_smoothing,
                            ignore_index=ignore_index, plain=plain)


def transformer_train_init(params: Params):
    """AdamW state (m, v) matching ``params`` (everything trains)."""
    return adamw_init(params)


def transformer_train_step(params: Params, opt_state, tokens: torch.Tensor, step, *,
                           n_heads: int, lr=1e-3, weight_decay: float = 0.0,
                           window=None, label_smoothing: float = 0.0,
                           clip_norm=None, accum: int = 1, ignore_index=None,
                           plain: bool = False):
    """One AdamW step; returns (params, (m, v), loss). ``step`` is the
    1-based count; ``lr`` a float or a schedule's 0-d tensor. clip_norm:
    global-L2 gradient clipping; accum: gradient accumulation over
    microbatches run one after another. The update is IN PLACE: the
    returned trees are the caller's ``params`` and ``opt_state``, changed."""
    _check_window(window)

    def loss_fn(p, toks):
        return transformer_lm_loss(p, toks, n_heads=n_heads,
                                   label_smoothing=label_smoothing,
                                   ignore_index=ignore_index, plain=plain)

    loss, grads = accumulated_value_and_grad(loss_fn, accum)(params, tokens)
    if clip_norm is not None:
        grads, _ = clip_by_global_norm(grads, clip_norm)
    m, v = opt_state
    adamw_step(params, grads, m, v, step, lr=lr, weight_decay=weight_decay)
    return params, (m, v), loss


@torch.no_grad()
def greedy_decode(params: Params, prompt: torch.Tensor, *, n_heads: int,
                  max_new_tokens: int, plain: bool = False) -> torch.Tensor:
    """Dense greedy reference: each step re-runs the full causal forward and
    appends the argmax. prompt (B, S0) -> (B, S0 + max_new_tokens)."""
    tokens = prompt
    for _ in range(max_new_tokens):
        logits = transformer_forward(params, tokens, n_heads=n_heads, plain=plain)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        tokens = torch.cat([tokens, nxt[:, None].to(tokens.dtype)], dim=1)
    return tokens


# ---------------------------------------------------------------------------
# KV-cached incremental decoding
# ---------------------------------------------------------------------------

def init_decode_cache(n_layers: int, B: int, n_heads: int, head_dim: int,
                      max_len: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Per-layer K/V caches shaped (L, 2, B*H, max_len, hd)."""
    return torch.zeros((n_layers, 2, B * n_heads, max_len, head_dim),
                       dtype=dtype, device=device)


@torch.no_grad()
def prefill(params: Params, prompt: torch.Tensor, cache: torch.Tensor, *,
            n_heads: int):
    """One flash forward over the prompt that also writes every prompt
    position's K/V into ``cache`` in place (laser_tpu returns an updated
    copy). Returns the last position's logits (B, vocab)."""
    B, S0 = prompt.shape
    D = params["embed"].shape[1]
    x = params["embed"][prompt]
    for li, blk in enumerate(params["blocks"]):
        h = layer_norm(x, blk["ln1_g"], blk["ln1_b"])
        qkv = linear(h.reshape(B * S0, D), blk["wqkv"], blk["bqkv"])
        qh, kh, vh = (split_heads(t, B, S0, n_heads) for t in qkv.split(D, dim=-1))
        cache[li, 0, :, :S0] = kh.reshape(B * n_heads, S0, -1)
        cache[li, 1, :, :S0] = vh.reshape(B * n_heads, S0, -1)
        o = attention(qh, kh, vh, causal=True).transpose(1, 2).reshape(B * S0, D)
        x = x + linear(o, blk["wo"], blk["bo"]).reshape(B, S0, D)
        h = layer_norm(x, blk["ln2_g"], blk["ln2_b"])
        f = linear(h.reshape(B * S0, D), blk["w1"], blk["b1"], "gelu")
        x = x + linear(f, blk["w2"], blk["b2"]).reshape(B, S0, D)
    x = layer_norm(x[:, -1], params["lnf_g"], params["lnf_b"])
    return gemm_ad(x, params["embed"], None, False, True)


@torch.no_grad()
def decode_step(params: Params, cache: torch.Tensor, token: torch.Tensor,
                pos: int, *, n_heads: int) -> torch.Tensor:
    """One incremental step: token (B,) at position ``pos``; writes its K/V
    into ``cache`` in place and attends over cache[.., :pos + 1] with a
    masked matvec in fp32 (TF32 off). Returns logits (B, vocab)."""
    from ..config import pin_fp32_matmul

    pin_fp32_matmul()
    B = token.shape[0]
    D = params["embed"].shape[1]
    hd = D // n_heads
    scale = 1.0 / math.sqrt(hd)
    x = params["embed"][token][:, None, :]
    for li, blk in enumerate(params["blocks"]):
        h = layer_norm(x, blk["ln1_g"], blk["ln1_b"])
        qkv = linear(h.reshape(B, D), blk["wqkv"], blk["bqkv"])
        q, k, v = (t.reshape(B * n_heads, 1, hd) for t in qkv.split(D, dim=-1))
        cache[li, 0, :, pos:pos + 1] = k
        cache[li, 1, :, pos:pos + 1] = v
        kc, vc = cache[li, 0, :, :pos + 1], cache[li, 1, :, :pos + 1]
        s = torch.matmul(q.float(), kc.float().transpose(1, 2)) * scale
        o = torch.matmul(torch.softmax(s, dim=-1), vc.float()).to(x.dtype)
        x = x + linear(o.reshape(B, D), blk["wo"], blk["bo"]).reshape(B, 1, D)
        h = layer_norm(x, blk["ln2_g"], blk["ln2_b"])
        f = linear(h.reshape(B, D), blk["w1"], blk["b1"], "gelu")
        x = x + linear(f, blk["w2"], blk["b2"]).reshape(B, 1, D)
    x = layer_norm(x, params["lnf_g"], params["lnf_b"])
    return gemm_ad(x.reshape(B, D), params["embed"], None, False, True)
