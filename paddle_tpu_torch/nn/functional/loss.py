"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py):
``cross_entropy`` with hard labels."""
from __future__ import annotations

import torch

from ...framework.op import op_inputs
from ...framework.unported import require_defaults


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy of logits ``input`` against integer class
    ids ``label`` (its class axis squeezed when it has one). Entries whose
    label is ``ignore_index`` add 0; ``mean`` divides the sum by the
    number of the other entries (at least 1), as the JAX package does.
    Class weights, soft labels, inputs that are already probabilities and
    label smoothing are not ported; ``name`` is accepted and unused."""
    require_defaults("nn.functional.cross_entropy", weight=(weight, None),
                     soft_label=(soft_label, False),
                     use_softmax=(use_softmax, True),
                     label_smoothing=(label_smoothing, 0.0))
    input, label = op_inputs("cross_entropy", input, label)
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
