"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py):
``cross_entropy`` with hard labels."""
from __future__ import annotations

import torch


def cross_entropy(input, label, ignore_index=-100, reduction="mean",
                  axis=-1):
    """Softmax cross entropy of logits ``input`` against integer class
    ids ``label`` (its class axis squeezed when it has one). Entries whose
    label is ``ignore_index`` add 0; ``mean`` divides the sum by the
    number of the other entries (at least 1), as the JAX package does."""
    ax = axis % input.ndim
    logp = torch.log_softmax(input, dim=ax)
    hard = label
    if hard.ndim == input.ndim:
        hard = hard.squeeze(ax)
    hard = hard.long()
    valid = hard != ignore_index
    safe = torch.where(valid, hard, 0)
    picked = -logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    picked = torch.where(valid, picked, 0.0)
    if reduction == "mean":
        return picked.sum() / valid.sum().to(logp.dtype).clamp_min(1.0)
    if reduction == "sum":
        return picked.sum()
    return picked
