"""
DDPG losses.

The port's counterpart of ``warpdrive_tpu/algos/ddpg.py``: n-step
bootstrapped returns against the target critic, a critic MSE loss and an
actor loss ``-mean(Q(s, pi(s)))``, each over the first ``T - n_step + 1``
batch rows.  The metric names are the JAX package's, which readers of
``results.json`` rely on.
"""

from __future__ import annotations

import torch

from warpdrive_tpu_torch.algos.returns import (
    n_step_returns,
    normalize_across_env_agents,
)

_EPSILON = 1e-10


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
    ):
        """The critic's side alone: ``(critic_loss, metrics)``, the metrics
        without the actor's terms ("Total loss", "Actor loss", "Mean J
        function"), which :meth:`with_actor_terms` adds."""
        valid = rewards_batch.shape[0] - self.n_step + 1
        returns = n_step_returns(
            rewards_batch, done_flags_batch,
            next_value_functions_batch.detach(),
            self.discount_factor_gamma, self.n_step,
        )
        norm_returns = normalize_across_env_agents(returns,
                                                   self.normalize_return)

        values = value_functions_batch[:valid]
        critic_loss = ((norm_returns - values) ** 2).mean()

        with torch.no_grad():
            advantages = norm_returns - values
            norm_advantages = normalize_across_env_agents(
                advantages, self.normalize_advantage
            )
            variance_explained = torch.clamp(
                1.0 - norm_advantages.var(correction=0)
                / (norm_returns.var(correction=0) + _EPSILON),
                min=-1.0,
            )
            actions_f = actions_batch.to(torch.float32)
            metrics = {
                "Critic loss": critic_loss.detach(),
                "Mean rewards": rewards_batch.mean(),
                "Max. rewards": rewards_batch.max(),
                "Min. rewards": rewards_batch.min(),
                "Mean value function": values.mean(),
                "Mean advantages": advantages.mean(),
                "Mean (norm.) advantages": norm_advantages.mean(),
                "Mean (discounted) returns": returns.mean(),
                "Mean normalized returns": norm_returns.mean(),
                "Variance explained by the value function":
                    variance_explained,
                "Std. of action over agents":
                    actions_f.std(dim=2, correction=0).mean(),
                "Std. of action over envs":
                    actions_f.std(dim=1, correction=0).mean(),
                "Std. of action over time":
                    actions_f.std(dim=0, correction=0).mean(),
                "Max of action": actions_f.max(),
                "Min of action": actions_f.min(),
            }
        return critic_loss, metrics

    def actor_loss(self, j_functions_batch):
        """``(actor_loss, j)``: ``-mean`` of the (normalized) Q(s, pi(s))
        over the valid rows, and those rows."""
        j = j_functions_batch[: j_functions_batch.shape[0] - self.n_step + 1]
        norm_j = normalize_across_env_agents(j, self.normalize_return)
        return -norm_j.mean(), j

    @staticmethod
    def with_actor_terms(critic_metrics: dict, actor_loss, j) -> dict:
        """The full metric dict, in the JAX package's order."""
        actor_loss = actor_loss.detach()
        metrics = {
            "Total loss": actor_loss + critic_metrics["Critic loss"],
            "Actor loss": actor_loss,
        }
        for name, value in critic_metrics.items():
            metrics[name] = value
            if name == "Mean value function":
                metrics["Mean J function"] = j.detach().mean()
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
            critic_metrics, actor_loss, j)
