"""Loss functions with masked ``(sum, count)`` reduction, the port of the
JAX package's ``ops/losses.py``.

Every loss returns ``(sum, count)`` under an optional per-example validity
mask so the caller picks the reduction: the local mean ``sum / count``,
or the exact global mean ``all_reduce(sum) / all_reduce(count)``.  Padded
rows (``parallel.sharding.pad_to_multiple``) contribute to neither.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def _masked(per_example: torch.Tensor, mask: Optional[torch.Tensor]) -> Pair:
    per_example = per_example.float()
    if mask is None:
        return per_example.sum(), torch.tensor(
            float(per_example.numel()), device=per_example.device)
    mask = mask.float()
    return (per_example * mask).sum(), mask.sum()


def mse(pred: torch.Tensor, target: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> Pair:
    """Squared error (sum, count) over examples; the per-example error is
    the mean over trailing dims (``nn.MSELoss`` on (B, 1) outputs)."""
    err = (pred.float() - target.float()) ** 2
    per_example = err.reshape(err.shape[0], -1).mean(dim=-1)
    return _masked(per_example, mask)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          label_smoothing: float = 0.0) -> Pair:
    """Cross-entropy (sum, count) with integer labels; logits (B, C) or
    (B, T, C).  Label smoothing s mixes the one-hot target with uniform:
    nll = logz - (1 - s) * gold - s * mean_c(logit_c)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        s = label_smoothing
        nll = logz - (1.0 - s) * gold - s * logits.mean(dim=-1)
    else:
        nll = logz - gold
    return reduce_token_nll(nll, mask)


def reduce_token_nll(nll: torch.Tensor, mask: Optional[torch.Tensor]) -> Pair:
    """Token-level (sum, count) of a per-token loss ((B,) or (B, T, ...))
    with a per-example mask broadcast over the token dims."""
    if nll.ndim > 1:
        flat = nll.reshape(nll.shape[0], -1)
        if mask is None:
            return flat.sum(), torch.tensor(float(flat.numel()),
                                            device=nll.device)
        m = mask.float().reshape(-1, 1).expand_as(flat)
        return (flat * m).sum(), m.sum()
    return _masked(nll, mask)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> Pair:
    """Correct-prediction (sum, count), per example (token hits averaged
    over the token dims first)."""
    hit = (logits.argmax(dim=-1) == labels.long()).float()
    return reduce_example_hits(hit, mask)


def reduce_example_hits(hit: torch.Tensor, mask: Optional[torch.Tensor]
                        ) -> Pair:
    """Example-level (sum, count) of a per-token hit tensor ((B,) or
    (B, T, ...)): the mean over the token dims, then the per-example mask;
    shared with the vocab-parallel accuracy (``parallel.megatron``)."""
    return _masked(hit.reshape(hit.shape[0], -1).mean(dim=-1), mask)


LOSSES = {"mse": mse, "cross_entropy": softmax_cross_entropy}


def get(name: str):
    """Loss by name; ``"cross_entropy@0.1"`` is cross-entropy with label
    smoothing 0.1."""
    if "@" in name:
        base, _, s = name.partition("@")
        if base != "cross_entropy":
            raise ValueError(f"label smoothing only applies to "
                             f"cross_entropy, got {name!r}")
        return functools.partial(LOSSES[base], label_smoothing=float(s))
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; have {sorted(LOSSES)}") from None
