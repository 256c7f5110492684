"""
Return computations shared by the policy-gradient algorithms.

The port's counterpart of ``warpdrive_tpu/algos/returns.py``: the JAX
``lax.scan`` recurrences are reverse loops over time-major tensors, and
DDPG's per-row ``vmap`` of n-step returns is one loop over the n steps,
all rows at once.
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


def n_step_returns(
    rewards: torch.Tensor,  # (T, E, A)
    done_flags: torch.Tensor,  # (T, E)
    next_values: torch.Tensor,  # (>= T-1, E, A) detached Q(s', pi'(s'))
    gamma: float,
    n_step: int,
) -> torch.Tensor:
    """
    n-step bootstrapped returns for DDPG, for the first ``T - n_step + 1``
    rows:

        last = i + n_step - 1
        r = rew[last] + (1 - done[last]) * gamma * V'[last]     (last < T-1)
        r = done[last] * rew[last] + (1 - done[last]) * V'[-1]  (last == T-1)
        for j in 1..n_step-1:
            r = rew[last-j] + (1 - done[last-j]) * gamma * r

    The final row keeps the reference's quirk (no gamma on its bootstrap).
    Only the branch a row takes is evaluated: the JAX version evaluates
    both, and its gather clamps the final row's ``V'[T-1]`` onto the last
    row of a ``T-1``-row ``V'``.  Returns ``(T - n_step + 1, E, A)``.
    """
    T = rewards.shape[0]
    valid = T - n_step + 1
    assert valid >= 1, "the batch must hold at least n_step rows"
    done = (done_flags > 0).to(rewards.dtype)[..., None]  # (T, E, 1)
    lo = n_step - 1  # the first row's ``last``
    # rows whose ``last`` is below T-1, then the final row
    ret = rewards[lo:T - 1] + (1.0 - done[lo:T - 1]) * gamma \
        * next_values[lo:T - 1]
    final = done[-1] * rewards[-1] + (1.0 - done[-1]) * next_values[-1]
    ret = torch.cat([ret, final[None]], dim=0)
    for j in range(1, n_step):
        ret = rewards[lo - j:T - j] + (1.0 - done[lo - j:T - j]) * gamma * ret
    return ret


def normalize_across_env_agents(x: torch.Tensor, enabled: bool,
                                eps: float = 1e-10, group=None
                                ) -> torch.Tensor:
    """Normalize over the (env, agent) axes per timestep, with the
    population standard deviation as JAX's ``std`` takes it: the mean,
    then the mean of the centred squares.  With an env ``group`` (a
    :class:`~warpdrive_tpu_torch.parallel.mesh.Mesh`, summing over its env
    group) both are taken over every rank's envs; a rank may hold none."""
    if not enabled:
        return x
    T = x.shape[0]
    sums = torch.cat([x.sum(dim=(1, 2)),
                      torch.full((1,), float(x.shape[1] * x.shape[2]),
                                 dtype=x.dtype, device=x.device)])
    if group is not None:
        group.all_reduce(sums)
    count = sums[T]
    mean = (sums[:T] / count).reshape(T, 1, 1)
    centred = x - mean
    squares = (centred * centred).sum(dim=(1, 2))
    if group is not None:
        group.all_reduce(squares)
    std = torch.sqrt(squares / count).reshape(T, 1, 1)
    return centred / (std + eps)
