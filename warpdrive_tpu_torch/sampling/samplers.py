"""
Action sampling on the device.

The port's counterpart of ``sample_categorical``, ``sample_from_logits`` and
``sample_ou_process`` in ``warpdrive_tpu/sampling/samplers.py``.  The
categorical draw is Gumbel-max, as ``jax.random.categorical`` draws:
``argmax(logits + g)`` with ``g = -log(-log(u))`` and ``u`` uniform on
``[tiny, 1)``; from probabilities it draws from ``log(probs + 1e-30)``.  The
Ornstein-Uhlenbeck step explores around DDPG's deterministic actions.
torch and JAX give different random numbers from the same seed, so a test
hands both sides the same noise (``gumbel``, ``noise``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_TINY = 1e-30


def sample_categorical(
    probs: torch.Tensor,
    generator: torch.Generator = None,
    use_argmax: bool = False,
    gumbel: torch.Tensor = None,
) -> torch.Tensor:
    """One action index per leading element of ``probs`` ``(...,
    num_actions)`` (nonnegative rows summing to ~1); returns int32 of shape
    ``probs.shape[:-1]``.  ``use_argmax`` takes the most likely action;
    otherwise the draw of :func:`sample_from_logits` from ``log(probs +
    1e-30)``, ``gumbel`` replacing its noise where given."""
    if use_argmax:
        return torch.argmax(probs, dim=-1).to(torch.int32)
    return sample_from_logits(torch.log(probs + _TINY), generator,
                              gumbel=gumbel)


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
    damping=0.15,
    stddev=0.2,
    scale=1.0,
    noise: torch.Tensor = None,
    generator: torch.Generator = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of Ornstein-Uhlenbeck exploration noise around a
    deterministic policy output ``mu``:

        ou'    = (1 - damping) * ou + N(0, stddev)
        action = mu + scale * ou'

    ``damping``, ``stddev`` and ``scale`` are numbers or 0-dim float32
    device tensors (a captured rollout step reads its schedules there);
    either gives the same bits.  With ``scale < 1e-8`` the action is
    exactly ``mu`` and the noise state stays as it was (the no-noise
    evaluation mode): a device select, as JAX's ``jnp.where``, so that no
    host branch reads a device value; a host ``scale`` that small returns
    at once and draws nothing.

    :param noise: an optional pre-drawn ``stddev * N(0, 1)`` tensor shaped
        like ``mu`` (a rollout draws an iteration's noise at once); without
        it the draw comes from ``generator``.
    :returns: ``(action, new_ou_state)``, both shaped like ``mu``.
    """
    f32 = np.float32
    if not torch.is_tensor(scale) and f32(scale) < f32(1e-8):
        return mu, ou_state

    def scalar(x):
        return x if torch.is_tensor(x) else torch.tensor(f32(x),
                                                         device=mu.device)

    damping, stddev, scale = scalar(damping), scalar(stddev), scalar(scale)
    if noise is None:
        noise = torch.randn(mu.shape, generator=generator, device=mu.device,
                            dtype=mu.dtype) * stddev
    new_ou = ou_state * (1 - damping) + noise
    action = mu + new_ou * scale
    no_noise = scale < f32(1e-8)
    return (torch.where(no_noise, mu, action),
            torch.where(no_noise, ou_state, new_ou))


def ou_stationary_std(damping: float, stddev: float) -> float:
    """The OU recursion's stationary standard deviation,
    ``stddev / sqrt(1 - (1 - damping)^2)``."""
    return stddev / math.sqrt(1.0 - (1.0 - damping) ** 2)
