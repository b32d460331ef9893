"""Per-row token sampling for continuous batching (port of
laser_tpu/ops/sampling.py: ``sample_logits_batch``), in plain PyTorch: it is
not a kernel on the JAX side either.

Greedy rows (temperature 0) are an exact argmax, first index on ties, as
``jnp.argmax``. Sampled rows follow laser_tpu's order: temperature, top-k,
nucleus (top-p), then a Gumbel-max draw. Row b's noise comes from a
``torch.Generator`` seeded from (seeds[b], positions[b]), so a preempted and
requeued request replays the same continuation; it cannot reproduce JAX's
PRNG bits, so sampled tokens differ from laser_tpu's.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def row_seed(seed: int, position: int) -> int:
    """A 63-bit generator seed for (seed, position): one splitmix64 round."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(position) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def gumbel_row(seed: int, position: int, vocab: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(row_seed(seed, position))
    u = torch.rand((vocab,), generator=g, device=device, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


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


def sample_logits_batch(seeds, positions, logits: torch.Tensor, temperature,
                        top_k, top_p) -> torch.Tensor:
    """(B, vocab) logits -> (B,) int64 tokens on the logits' device. seeds,
    positions, temperature, top_k, top_p: (B,) array-likes (host values)."""
    B, V = logits.shape
    dev = logits.device
    greedy = torch.argmax(logits, dim=-1)
    temperature = torch.as_tensor(temperature, dtype=torch.float32)
    if not bool((temperature > 0).any()):
        return greedy
    x = logits.float() / temperature.clamp_min(1e-8).to(dev)[:, None]
    top_k = torch.as_tensor(top_k, dtype=torch.int64).to(dev)
    top_p = torch.as_tensor(top_p, dtype=torch.float32).to(dev)
    if bool(((top_k > 0) & (top_k < V)).any()) or bool((top_p < 1.0).any()):
        x = _filter(x, top_k, top_p)
    seeds = torch.as_tensor(seeds).tolist()
    positions = torch.as_tensor(positions).tolist()
    g = torch.stack([gumbel_row(s, p, V, dev) for s, p in zip(seeds, positions)])
    sampled = torch.argmax(x + g, dim=-1)
    return torch.where(temperature.to(dev) <= 0, greedy, sampled)
