"""Per-row token sampling for continuous batching, and the speculative
acceptance rule (port of laser_tpu/ops/sampling.py: ``sample_logits_batch``,
``speculative_accept``), in plain PyTorch: neither is a kernel on the JAX
side.

Greedy rows (temperature 0) are an exact argmax, first index on ties, as
``jnp.argmax``. Sampled rows follow laser_tpu's order: temperature, top-k,
nucleus (top-p), then a Gumbel-max draw.

Noise is a pure function of (seed, position, stream), computed on the
device in int64 arithmetic: one splitmix64 round of (seed, position) gives
the row key (``row_seed`` is the same number on the host), a stream tag is
folded in by another round, and a round over (key, vocabulary index) gives
one uniform per entry. Nothing is read back to the host, so a decode burst
samples inside its loop without a sync, a token gets the same noise at any
burst length, and a preempted and requeued request replays the same
continuation. Streams mirror laser_tpu's ``fold_in`` tags: none for the main
sample, 7 for the draft's proposals, 11 for the acceptance draws
(serving/engine.py:1389-1391, 1425-1427). This cannot reproduce JAX's PRNG
bits, so sampled tokens differ from laser_tpu's; the tests compare greedy
tokens and distributions.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_M1, _M2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB
STREAM_DRAFT, STREAM_ACCEPT = 7, 11


def _i64(x: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    x &= _MASK64
    return x - (1 << 64) if x >> 63 else x


def row_seed(seed: int, position: int) -> int:
    """The 63-bit row key of (seed, position): one splitmix64 round."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(position) & 0xFFFFFFFF))
    z = (z + _GOLDEN) & _MASK64
    z = ((z ^ (z >> 30)) * _M1) & _MASK64
    z = ((z ^ (z >> 27)) * _M2) & _MASK64
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def _srl(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int64 tensor (``>>`` is arithmetic)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64, wrapping as uint64 would."""
    z = (z ^ _srl(z, 30)) * _i64(_M1)
    z = (z ^ _srl(z, 27)) * _i64(_M2)
    return z ^ _srl(z, 31)


def fold(keys: torch.Tensor, tag: int) -> torch.Tensor:
    """A new key per row: ``keys`` with ``tag`` folded in."""
    return _mix(keys + _i64(tag * _GOLDEN)) & 0x7FFFFFFFFFFFFFFF


def row_keys(seeds: torch.Tensor, positions: torch.Tensor, stream: int = 0) -> torch.Tensor:
    """(B,) int64 keys of (seed, position[, stream]), on their device;
    ``row_keys(s, p)[b] == row_seed(s[b], p[b])``."""
    z = ((seeds.long() & 0xFFFFFFFF) << 32) | (positions.long() & 0xFFFFFFFF)
    z = _mix(z + _i64(_GOLDEN)) & 0x7FFFFFFFFFFFFFFF
    return fold(z, stream) if stream else z


def uniforms(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) float32 uniforms in (0, 1), entry j a function of (keys[b], j)
    alone: 24 bits each, so 1 - u and u are both exact."""
    idx = torch.arange(1, n + 1, device=keys.device, dtype=torch.int64)
    h = _mix(keys[:, None] + idx[None, :] * _i64(_GOLDEN))
    return (_srl(h, 40).float() + 0.5) * 2.0 ** -24


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    return -torch.log(-torch.log(uniforms(keys, n)))


def _filter(x: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    V = x.shape[-1]
    sx = torch.sort(x, dim=-1, descending=True).values
    kth = sx.gather(-1, (top_k - 1).clamp(0, V - 1)[:, None])
    k_on = ((top_k > 0) & (top_k < V))[:, None]
    x = torch.where(k_on & (x < kth), float("-inf"), x)
    sx = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(sx, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < top_p[:, None]
    cutoff = torch.where(keep, sx, float("inf")).amin(dim=-1, keepdim=True)
    p_on = (top_p < 1.0)[:, None]
    return torch.where(p_on & (x < cutoff), float("-inf"), x)


def sample_tokens(logits: torch.Tensor, seeds: torch.Tensor, positions: torch.Tensor,
                  temps: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor, *,
                  sampled: bool, filtered: bool, stream: int = 0) -> torch.Tensor:
    """(B, vocab) logits -> (B,) int64 tokens, every operand a (B,) tensor on
    the logits' device. ``sampled`` / ``filtered``: whether any row samples /
    filters, decided by the caller from its host copies (a device test would
    sync); with either False the rows' results are the same, only cheaper."""
    greedy = torch.argmax(logits, dim=-1)
    if not sampled:
        return greedy
    x = logits.float() / temps.clamp_min(1e-8)[:, None]
    if filtered:
        x = _filter(x, top_k, top_p)
    g = gumbel(row_keys(seeds, positions, stream), x.shape[-1])
    return torch.where(temps <= 0, greedy, torch.argmax(x + g, dim=-1))


def sample_logits_batch(seeds, positions, logits: torch.Tensor, temperature,
                        top_k, top_p) -> torch.Tensor:
    """(B, vocab) logits -> (B,) int64 tokens on the logits' device. seeds,
    positions, temperature, top_k, top_p: (B,) host array-likes."""
    V = logits.shape[-1]
    temperature = np.asarray(temperature, np.float32)
    if not (temperature > 0).any():
        return torch.argmax(logits, dim=-1)  # all greedy: nothing to upload
    top_k = np.asarray(top_k, np.int64)
    top_p = np.asarray(top_p, np.float32)
    dev = logits.device

    def on(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    return sample_tokens(
        logits, on(seeds, torch.int64), on(positions, torch.int64),
        on(temperature, torch.float32), on(top_k, torch.int64), on(top_p, torch.float32),
        sampled=True, filtered=bool((((top_k > 0) & (top_k < V)) | (top_p < 1.0)).any()))


def speculative_accept(p: torch.Tensor, q: torch.Tensor, proposals: torch.Tensor,
                       keys: torch.Tensor):
    """The rejection rule of arXiv:2211.17192 (laser_tpu's
    ``speculative_accept``), batched over slots. p (S, gamma+1, V) target
    probabilities, q (S, gamma, V) draft probabilities, proposals (S, gamma)
    drawn from q, keys (S,) int64 row keys. Accepts the longest prefix with
    u * q(x) < p(x), u ~ U(0, 1), then draws one token: from the normalised
    residual max(p - q, 0) at the first rejection (p there when the residual
    sums to 0), or from p[gamma] after a full accept. Returns (n_accepted
    (S,) int64 in [0, gamma], next token (S,) int64): the emitted tokens are
    proposals[:n] + [next], each marginally distributed as the target's."""
    S, gamma = proposals.shape
    V = p.shape[-1]
    props = proposals.long()[..., None]
    p_at = p[:, :gamma].gather(-1, props).squeeze(-1)
    q_at = q.gather(-1, props).squeeze(-1)
    acc = uniforms(fold(keys, 1), gamma) * q_at < p_at
    n_acc = torch.argmin(torch.cat([acc, acc.new_zeros((S, 1))], 1).int(), dim=1)
    safe = n_acc.clamp(max=gamma - 1)[:, None, None].expand(S, 1, V)
    p_s = p.gather(1, safe).squeeze(1)
    resid = (p_s - q.gather(1, safe).squeeze(1)).clamp_min(0.0)
    rsum = resid.sum(-1, keepdim=True)
    resid = torch.where(rsum > 0, resid / torch.where(rsum > 0, rsum, 1.0), p_s)
    dist = torch.where((n_acc == gamma)[:, None], p[:, gamma], resid)
    nxt = torch.argmax(torch.log(dist + 1e-38) + gumbel(fold(keys, 2), V), dim=-1)
    return n_acc, nxt
