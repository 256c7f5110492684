"""
Action sampling on the device.

The port's counterpart of ``sample_from_logits`` and ``sample_ou_process``
in ``warpdrive_tpu/sampling/samplers.py``.  The categorical draw is
Gumbel-max, as ``jax.random.categorical`` draws: ``argmax(logits + g)``
with ``g = -log(-log(u))`` and ``u`` uniform on ``[tiny, 1)``.  The
Ornstein-Uhlenbeck step explores around DDPG's deterministic actions.
torch and JAX give different random numbers from the same seed, so a test
hands both sides the same noise (``gumbel``, ``noise``).
"""

from __future__ import annotations

import math

import numpy as np
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


def sample_ou_process(
    mu: torch.Tensor,
    ou_state: torch.Tensor,
    damping: float = 0.15,
    stddev: float = 0.2,
    scale: float = 1.0,
    noise: torch.Tensor = None,
    generator: torch.Generator = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of Ornstein-Uhlenbeck exploration noise around a
    deterministic policy output ``mu``:

        ou'    = (1 - damping) * ou + N(0, stddev)
        action = mu + scale * ou'

    With ``scale < 1e-8`` the action is exactly ``mu`` and the noise state
    is returned as it was (the no-noise evaluation mode).

    :param noise: an optional pre-drawn ``stddev * N(0, 1)`` tensor shaped
        like ``mu`` (a rollout draws an iteration's noise at once); without
        it the draw comes from ``generator``.
    :returns: ``(action, new_ou_state)``, both shaped like ``mu``.
    """
    f32 = np.float32
    if f32(scale) < f32(1e-8):
        return mu, ou_state
    if noise is None:
        noise = torch.randn(mu.shape, generator=generator, device=mu.device,
                            dtype=mu.dtype) * f32(stddev)
    new_ou = ou_state * (f32(1) - f32(damping)) + noise
    return mu + new_ou * f32(scale), new_ou


def ou_stationary_std(damping: float, stddev: float) -> float:
    """The OU recursion's stationary standard deviation,
    ``stddev / sqrt(1 - (1 - damping)^2)``."""
    return stddev / math.sqrt(1.0 - (1.0 - damping) ** 2)
