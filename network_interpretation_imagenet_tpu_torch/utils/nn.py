"""Small NN utilities (port of ``utils/nn.py`` of the JAX package, the
reference's ``utils.py`` helpers).

* :func:`ste_round`: straight-through rounding (reference ``Binarized``,
  ``utils.py:12-18``): forward rounds, backward passes the gradient through.
* :func:`entropy_loss`: mean softmax entropy (reference ``Entropy``,
  ``utils.py:20-26``).
* :func:`kaiming_normal_init`: He-normal initialization, torch's
  ``kaiming_normal_`` as the reference's ``weight_init`` uses it
  (``utils.py:32-39``).
"""

from __future__ import annotations

from typing import Optional

import torch


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return torch.round(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """``round(x)`` forward (half to even, as ``jnp.round``), identity gradient."""
    return _SteRound.apply(x)


def entropy_loss(logits: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of the entropy of ``softmax(logits)``: ``-sum p log p``."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.mean(-torch.sum(logp.exp() * logp, dim=-1))


def kaiming_normal_init(tensor: torch.Tensor,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill a conv weight [out, in, kh, kw] or a Linear weight [out, in] in
    place with N(0, 2 / fan_in) (fan_in = in * kh * kw: ``a=0``, gain sqrt(2))."""
    fan_in = tensor[0].numel()
    with torch.no_grad():
        return tensor.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
