"""Rotary position embeddings (port of laser_tpu/ops/rope.py).

Each (x[..., i], x[..., i + D/2]) pair rotates by an angle proportional to
the token position, with per-pair frequencies base^(-2i/D) (the "rotate
half" convention). Plain PyTorch, as plain jnp in laser_tpu: no kernel.
The tables are f32 and are cast to ``x.dtype`` before the rotation, as
laser_tpu casts them (rope.py:39-40, 52-53), so a bf16 model rotates in
bf16.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rope_tables(max_len: int, head_dim: int, *, base: float = 10000.0,
                device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape (max_len, head_dim / 2), float32, computed
    in float64 on the host as laser_tpu computes them, then put on
    ``device``."""
    if head_dim % 2:
        raise ValueError(f"head_dim must be even, got {head_dim}")
    inv = 1.0 / (base ** (np.arange(0, head_dim, 2) / head_dim))
    ang = np.arange(max_len)[:, None] * inv[None, :]
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def _rotate(x, c, s):
    D = x.shape[-1]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
               position_offset: int = 0) -> torch.Tensor:
    """Rotate x (..., S, D) by the tables at positions [offset, offset + S)."""
    S, D = x.shape[-2], x.shape[-1]
    if position_offset + S > cos.shape[0]:
        raise ValueError(f"positions up to {position_offset + S} past the "
                         f"{cos.shape[0]}-row rope table")
    shape = (1,) * (x.ndim - 2) + (S, D // 2)
    c = cos[position_offset:position_offset + S].reshape(shape).to(x.dtype)
    s = sin[position_offset:position_offset + S].reshape(shape).to(x.dtype)
    return _rotate(x, c, s)


def apply_rope_at(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Rotate x (B, H, D) by per-row positions (B,): the batched decode
    step, where every sequence sits at its own position."""
    positions = positions.long()
    c = cos[positions][:, None, :].to(x.dtype)  # (B, 1, D/2)
    s = sin[positions][:, None, :].to(x.dtype)
    return _rotate(x, c, s)
