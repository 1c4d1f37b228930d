"""Rotary position embeddings, the half-split convention of the JAX
package's ``ops/rope.py``: the head dim splits as ``[x1 | x2]`` and
rotates to ``(x1 cos - x2 sin, x1 sin + x2 cos)`` in f32."""

from __future__ import annotations

import torch

DEFAULT_THETA = 10000.0


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = DEFAULT_THETA):
    """(cos, sin) for ``positions`` (any shape P) -> each
    (*P, head_dim // 2) in f32."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {head_dim}")
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope_rotate(x: torch.Tensor, positions: torch.Tensor,
                theta: float = DEFAULT_THETA) -> torch.Tensor:
    """Rotate q or k ``(..., T, H, D)`` by per-token ``positions``: (T,)
    for one sequence, or (B, T) for per-row positions.  Output dtype
    matches ``x``."""
    cos, sin = rope_angles(positions, x.shape[-1], theta)
    if positions.ndim == 1:
        cos, sin = cos[None], sin[None]                  # (1, T, half)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]    # (B|1, T, 1, half)
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)
