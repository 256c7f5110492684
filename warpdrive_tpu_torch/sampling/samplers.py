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

:func:`sample_heads` draws every head of a policy at once, as the trainer's
rollout, acting and serving do: on a card one launch of the categorical-draw
kernel (``csrc/gumbel_sample.cu``, ``ops/gumbel_sample.py``) after one
uniform draw a head, and on the CPU :func:`draw_heads_plain`, the same
uniforms through the op-by-op chain of :func:`sample_from_logits`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from warpdrive_tpu_torch.ops import gumbel_sample

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
        gumbel = _gumbel(_uniform(logits, generator))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def _uniform(logits: torch.Tensor, generator: torch.Generator = None):
    return torch.rand(logits.shape, generator=generator,
                      device=logits.device, dtype=logits.dtype)


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    """``-log(-log(u))`` of ``u`` clamped to the dtype's least normal
    number, out of place."""
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))


def sample_heads(
    logits_list,
    generator: torch.Generator = None,
    use_argmax: bool = False,
) -> torch.Tensor:
    """One categorical draw per head and leading element: the draws of
    ``logits_list`` (C tensors ``(..., num_actions_c)`` of one leading
    shape), stacked as int32 ``(..., C)``.

    Stochastic, it draws one uniform tensor a head, in order and shaped
    like the head, from ``generator``, as C calls of
    :func:`sample_from_logits` draw them, so the generator advances as
    theirs does and the draws are theirs.  On CUDA tensors they then go to
    the categorical-draw kernel, one launch a group of
    ``gumbel_sample.HEADS_A_LAUNCH`` heads (float32 logits of one leading
    shape; anything else raises before the launch), on the CPU through
    :func:`draw_heads_plain`.

    :param use_argmax: deterministic mode (each head's most likely action).
    """
    if use_argmax:
        return torch.stack([torch.argmax(logits, dim=-1).to(torch.int32)
                            for logits in logits_list], dim=-1)
    uniforms = [_uniform(logits, generator) for logits in logits_list]
    device = logits_list[0].device
    if device.type == "cpu":
        return draw_heads_plain(logits_list, uniforms)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    gumbel_sample.check_inputs(logits_list, uniforms)
    return gumbel_sample.gumbel_sample(logits_list, uniforms)


def draw_heads_plain(logits_list, uniforms) -> torch.Tensor:
    """The plain version of :func:`sample_heads`'s draw from given
    uniforms, on any device: each head's Gumbel-max draw op by op, as
    :func:`sample_from_logits` makes it, stacked; what the CPU runs, and
    what the kernel is held to on the card.  The uniforms are left as they
    are."""
    return torch.stack(
        [sample_from_logits(logits, gumbel=_gumbel(u))
         for logits, u in zip(logits_list, uniforms)], dim=-1)


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
