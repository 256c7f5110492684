"""
Return computations shared by the policy-gradient algorithms.

The port's counterpart of ``warpdrive_tpu/algos/returns.py`` for A2C and
PPO: the JAX ``lax.scan`` recurrences are reverse loops over time-major
tensors.  DDPG's ``n_step_returns`` comes with ROADMAP queue 1, item 7.
"""

from __future__ import annotations

import torch


def discounted_returns(
    rewards: torch.Tensor,  # (T, E, A) float32
    done_flags: torch.Tensor,  # (T, E) int32 (0 running / >0 done)
    values: torch.Tensor,  # (T, E, A) float32, detached
    gamma: float,
) -> torch.Tensor:
    """
    The reference A2C/PPO recursion, done-masked:

        R[T-1] = done[T-1] * r[T-1] + (1 - done[T-1]) * V[T-1]
        R[t]   = r[t] + (1 - done[t]) * gamma * R[t+1]

    The reference's quirk is kept: when the last step is NOT done, the
    bootstrap value replaces (rather than adds to) the last reward.
    """
    done = (done_flags > 0).to(rewards.dtype)[..., None]  # (T, E, 1)
    out = torch.empty_like(rewards)
    ret = done[-1] * rewards[-1] + (1.0 - done[-1]) * values[-1]
    out[-1] = ret
    for t in range(rewards.shape[0] - 2, -1, -1):
        ret = rewards[t] + (1.0 - done[t]) * gamma * ret
        out[t] = ret
    return out


def normalize_across_env_agents(x: torch.Tensor, enabled: bool,
                                eps: float = 1e-10) -> torch.Tensor:
    """Normalize over the (env, agent) axes per timestep, with the
    population standard deviation as JAX's ``std`` takes it."""
    if not enabled:
        return x
    mean = x.mean(dim=(1, 2), keepdim=True)
    std = x.std(dim=(1, 2), keepdim=True, correction=0)
    return (x - mean) / (std + eps)
