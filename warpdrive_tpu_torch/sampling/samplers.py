"""
Categorical action sampling on the device.

The port's counterpart of ``sample_from_logits`` in
``warpdrive_tpu/sampling/samplers.py``.  The draw is Gumbel-max, as
``jax.random.categorical`` draws: ``argmax(logits + g)`` with
``g = -log(-log(u))`` and ``u`` uniform on ``[tiny, 1)``.  torch and JAX
give different random numbers from the same seed, so a test hands both
sides the same noise through ``gumbel``.
"""

from __future__ import annotations

import torch


def sample_from_logits(
    logits: torch.Tensor,
    generator: torch.Generator = None,
    use_argmax: bool = False,
    gumbel: torch.Tensor = None,
) -> torch.Tensor:
    """One categorical draw per leading element of ``logits``
    ``(..., num_actions)``; returns int32 of shape ``logits.shape[:-1]``.

    :param use_argmax: deterministic mode (the most likely action).
    :param gumbel: optional Gumbel noise shaped like ``logits`` that
        replaces the draw (``generator`` is then unused).
    """
    if use_argmax:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if gumbel is None:
        tiny = torch.finfo(logits.dtype).tiny
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=logits.dtype)
        gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
