"""
DDPG losses.

The port's counterpart of ``warpdrive_tpu/algos/ddpg.py``: n-step
bootstrapped returns against the target critic, a critic MSE loss and an
actor loss ``-mean(Q(s, pi(s)))``, each over the first ``T - n_step + 1``
batch rows.  The metric names are the JAX package's, which readers of
``results.json`` rely on.

With an env ``group`` (a process mesh, summing over its env group) the
window holds this
rank's env rows: each loss is the rank's sum over the global count, so the
ranks' gradients SUM to the global loss's, normalization is global, and the
metrics that need every rank are
:class:`~warpdrive_tpu_torch.parallel.mesh.Deferred`.
"""

from __future__ import annotations

import torch

from warpdrive_tpu_torch.algos.returns import (
    n_step_returns,
    normalize_across_env_agents,
)
from warpdrive_tpu_torch.parallel.mesh import MetricOps

_EPSILON = 1e-10


def global_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of every entry: the sum over the count, both over every
    rank of ``group``'s envs when one is given (the rank's sum over the
    global count, whose sum over the ranks is the global mean)."""
    count = torch.full((), float(x.numel()), device=x.device)
    if group is not None:
        group.all_reduce(count)
    return x.sum() / count


class DDPG:
    """Deep Deterministic Policy Gradient (losses only; the nets live in
    the trainer)."""

    def __init__(
        self,
        discount_factor_gamma=1.0,
        normalize_advantage=False,
        normalize_return=False,
        n_step=1,
    ):
        assert 0 <= discount_factor_gamma <= 1 and n_step >= 1
        self.discount_factor_gamma = float(discount_factor_gamma)
        self.normalize_advantage = bool(normalize_advantage)
        self.normalize_return = bool(normalize_return)
        self.n_step = int(n_step)

    def critic_loss_and_metrics(
        self,
        actions_batch,  # (T, E, A, C) float32
        rewards_batch,  # (T, E, A)
        done_flags_batch,  # (T, E)
        value_functions_batch,  # (T, E, A) Q(s, a), the critic's graph
        next_value_functions_batch,  # (T-1, E, A) target Q(s', pi'(s'))
        group=None,
        with_metrics: bool = True,
    ):
        """The critic's side alone: ``(critic_loss, metrics)``, the metrics
        without the actor's terms ("Total loss", "Actor loss", "Mean J
        function"), which :meth:`with_actor_terms` adds; without
        ``with_metrics`` (the metrics-free update) ``{}``."""
        valid = rewards_batch.shape[0] - self.n_step + 1
        ops = MetricOps(group)
        returns = n_step_returns(
            rewards_batch, done_flags_batch,
            next_value_functions_batch.detach(),
            self.discount_factor_gamma, self.n_step,
        )
        norm_returns = normalize_across_env_agents(
            returns, self.normalize_return, group=group)

        values = value_functions_batch[:valid]
        critic_loss = global_mean((norm_returns - values) ** 2, group)
        if not with_metrics:
            return critic_loss, {}

        with torch.no_grad():
            advantages = norm_returns - values
            norm_advantages = normalize_across_env_agents(
                advantages, self.normalize_advantage, group=group
            )
            actions_f = actions_batch.to(torch.float32)
            metrics = {
                "Critic loss": ops.value(critic_loss.detach()),
                "Mean rewards": ops.mean(rewards_batch),
                "Max. rewards": ops.max(rewards_batch),
                "Min. rewards": ops.min(rewards_batch),
                "Mean value function": ops.mean(values),
                "Mean advantages": ops.mean(advantages),
                "Mean (norm.) advantages": ops.mean(norm_advantages),
                "Mean (discounted) returns": ops.mean(returns),
                "Mean normalized returns": ops.mean(norm_returns),
                "Variance explained by the value function":
                    ops.variance_explained(norm_advantages, norm_returns,
                                           _EPSILON),
                "Std. of action over agents": ops.std_mean(actions_f, 2),
                "Std. of action over envs": ops.std_mean(actions_f, 1),
                "Std. of action over time": ops.std_mean(actions_f, 0),
                "Max of action": ops.max(actions_f),
                "Min of action": ops.min(actions_f),
            }
        return critic_loss, metrics

    def actor_loss(self, j_functions_batch, group=None):
        """``(actor_loss, j)``: ``-mean`` of the (normalized) Q(s, pi(s))
        over the valid rows, and those rows."""
        j = j_functions_batch[: j_functions_batch.shape[0] - self.n_step + 1]
        norm_j = normalize_across_env_agents(j, self.normalize_return,
                                             group=group)
        return -global_mean(norm_j, group), j

    @staticmethod
    def with_actor_terms(critic_metrics: dict, critic_loss, actor_loss, j,
                         group=None) -> dict:
        """The full metric dict, in the JAX package's order."""
        ops = MetricOps(group)
        actor_loss = actor_loss.detach()
        metrics = {
            "Total loss": ops.value(actor_loss + critic_loss.detach()),
            "Actor loss": ops.value(actor_loss),
        }
        for name, value in critic_metrics.items():
            metrics[name] = value
            if name == "Mean value function":
                metrics["Mean J function"] = ops.mean(j.detach())
        return metrics

    def compute_loss_and_metrics(
        self,
        timestep,
        actions_batch,  # (T, E, A, C) float32
        rewards_batch,  # (T, E, A)
        done_flags_batch,  # (T, E)
        value_functions_batch,  # (T, E, A) Q(s, a), the critic's graph
        next_value_functions_batch,  # (T-1, E, A) target Q(s', pi'(s'))
        j_functions_batch,  # (T, E, A) Q(s, pi(s)), the actor's graph
    ):
        """:returns: ``(actor_loss, critic_loss, metrics)``."""
        critic_loss, critic_metrics = self.critic_loss_and_metrics(
            actions_batch, rewards_batch, done_flags_batch,
            value_functions_batch, next_value_functions_batch,
        )
        actor_loss, j = self.actor_loss(j_functions_batch)
        return actor_loss, critic_loss, self.with_actor_terms(
            critic_metrics, critic_loss, actor_loss, j)
