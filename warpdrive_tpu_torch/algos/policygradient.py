"""
A2C and PPO losses.

The port's counterpart of ``warpdrive_tpu/algos/policygradient.py``:

* discounted returns with done masking, optional return/advantage
  normalization over (env, agent), entropy and value-loss coefficient
  schedules;
* PPO's clipped surrogate against the behaviour log-probs a caller passes
  (``old_log_prob``, fixed before a multi-pass update), or against the
  detached current ones (single-epoch PPO);
* negative/positive env downsampling on done==2 success markers as per-env
  Bernoulli keep-weights (:func:`env_selection_weights`), whose uniform
  draws a caller may pass in so a test can feed both sides the same draws.

Batches are time-major: actions (T, E, A, C), rewards (T, E, A), dones
(T, E), logits a list of C tensors (T, E, A, n_c), values (T, E, A).

With an env ``group`` (a process mesh, :class:`~warpdrive_tpu_torch.
parallel.mesh.Mesh`, whose ``all_reduce`` sums over its env group) the
batch holds this
rank's env rows (none, on a rank that holds no row of a minibatch) and
every reduction over the env axis is global: the loss is the rank's
numerator over the global denominator (the weight sum is all-reduced
before the backward pass), so the ranks' gradients SUM to the global
loss's; normalization and the downsampling's positive count are global;
the metrics are :class:`~warpdrive_tpu_torch.parallel.mesh.Deferred`,
combined at log points.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from warpdrive_tpu_torch.algos.returns import (
    discounted_returns,
    normalize_across_env_agents,
)
from warpdrive_tpu_torch.parallel.mesh import MetricOps
from warpdrive_tpu_torch.training.param_scheduler import ParamScheduler

_EPSILON = 1e-10


def env_selection_weights(
    done_flags_batch: torch.Tensor,  # (T, E)
    negative_positive_ratio: float,
    generator: torch.Generator = None,
    uniform: torch.Tensor = None,
    group=None,
) -> torch.Tensor:
    """
    Per-env keep weights for success-based downsampling: keep every env
    that hit done==2 ("positive"), keep each other env with probability
    ``pos_count * ratio / neg_count`` (everything when there is no
    positive), the counts over every rank of ``group``.  ``uniform`` (E,)
    in [0, 1) replaces the draw from ``generator``.  Returns (E,) float32
    weights in {0, 1}.
    """
    E = done_flags_batch.shape[1]
    positives = (done_flags_batch == 2).any(dim=0)
    counts = torch.stack([positives.sum().to(torch.float32),
                          torch.full((), float(E),
                                     device=done_flags_batch.device)])
    if group is not None:
        group.all_reduce(counts)
    pos_count, num_envs = counts[0], counts[1]
    neg_count = torch.clamp(num_envs - pos_count, min=1.0)
    keep_prob = torch.clamp(
        pos_count * negative_positive_ratio / neg_count, max=1.0
    )
    keep_prob = torch.where(pos_count > 0, keep_prob, 1.0)
    if uniform is None:
        uniform = torch.rand((E,), generator=generator,
                             device=done_flags_batch.device)
    return (positives | (uniform < keep_prob)).to(torch.float32)


def _weight_total(env_weights: torch.Tensor, group=None) -> torch.Tensor:
    """The env weights' sum over every rank."""
    total = env_weights.sum()
    if group is not None:
        group.all_reduce(total)
    return total


def _wmean(x: torch.Tensor, env_weights: torch.Tensor,
           weight_total: torch.Tensor) -> torch.Tensor:
    """Mean over all elements, with per-env weights broadcast on axis 1:
    the weighted sum over ``weight_total`` (every rank's weight sum) times
    the entries of one env row."""
    w = env_weights.reshape((1, -1) + (1,) * (x.ndim - 2))
    per_env = x.shape[0] * math.prod(x.shape[2:])
    denom = torch.clamp(weight_total * per_env, min=_EPSILON)
    return (x * w).sum() / denom


def _logp_and_entropy(logits_list, actions):
    """Sum of per-component log-probs (T, E, A) and the per-component
    entropies stacked (C, T, E, A)."""
    log_prob = 0.0
    entropies = []
    for idx, logits in enumerate(logits_list):
        logp = F.log_softmax(logits, dim=-1)
        probs = torch.exp(logp)
        entropies.append(-(probs * logp).sum(dim=-1))
        log_prob = log_prob + logp.gather(
            -1, actions[..., idx : idx + 1].long()
        )[..., 0]
    return log_prob, torch.stack(entropies, dim=0)


class A2C:
    """Advantage Actor-Critic."""

    def __init__(
        self,
        discount_factor_gamma=1.0,
        normalize_advantage=False,
        normalize_return=False,
        vf_loss_coeff=0.01,
        entropy_coeff=0.01,
    ):
        assert 0 <= discount_factor_gamma <= 1
        self.discount_factor_gamma = float(discount_factor_gamma)
        self.normalize_advantage = bool(normalize_advantage)
        self.normalize_return = bool(normalize_return)
        self.vf_loss_coeff_schedule = ParamScheduler(vf_loss_coeff)
        self.entropy_coeff_schedule = ParamScheduler(entropy_coeff)

    # PPO overrides this hook; A2C ignores ``old_log_prob``
    def _policy_loss(self, log_prob, advantages, env_weights, weight_total,
                     old_log_prob=None):
        return _wmean(-log_prob * advantages, env_weights, weight_total)

    def compute_loss_and_metrics(
        self,
        timestep,
        actions_batch,  # (T, E, A, C) int32
        rewards_batch,  # (T, E, A) float32
        done_flags_batch,  # (T, E) int32
        logits_batch,  # list of C tensors (T, E, A, n_c)
        value_functions_batch,  # (T, E, A) float32, in the graph
        negative_positive_ratio: float = -1.0,
        generator: torch.Generator = None,
        downsample_uniform: torch.Tensor = None,
        old_log_prob: torch.Tensor = None,  # (T, E, A), detached
        group=None,
        coeffs=None,
        with_metrics: bool = True,
    ):
        """:returns: ``(loss, metrics)``, both tensors (with ``group``,
        the metrics that need every rank :class:`Deferred`); reading a
        metric value waits for the device, so callers read them at log
        points only.  ``old_log_prob`` reaches PPO's ratio.  ``coeffs``,
        ``(vf_loss_coeff, entropy_coeff)`` as 0-dim float32 device tensors
        (a captured update's, filled from the schedules before each
        iteration), replaces the schedules' values at ``timestep``.
        Without ``with_metrics`` (the metrics-free update of a hot
        iteration) ``metrics`` is empty and the loss the same."""
        values_detached = value_functions_batch.detach()
        ops = MetricOps(group)

        if negative_positive_ratio > 0:
            env_w = env_selection_weights(
                done_flags_batch, negative_positive_ratio, generator,
                uniform=downsample_uniform, group=group,
            )
        else:
            env_w = torch.ones((rewards_batch.shape[1],), dtype=torch.float32,
                               device=rewards_batch.device)
        w_total = _weight_total(env_w, group)

        returns = discounted_returns(
            rewards_batch, done_flags_batch, values_detached,
            self.discount_factor_gamma,
        )
        norm_returns = normalize_across_env_agents(
            returns, self.normalize_return, group=group)

        vf_loss = _wmean((norm_returns - value_functions_batch) ** 2, env_w,
                         w_total)

        advantages = norm_returns - values_detached
        norm_advantages = normalize_across_env_agents(
            advantages, self.normalize_advantage, group=group
        )

        log_prob, entropy = _logp_and_entropy(logits_batch, actions_batch)
        mean_entropy = sum(
            _wmean(entropy[c], env_w, w_total)
            for c in range(entropy.shape[0])
        )

        policy_loss = self._policy_loss(log_prob, norm_advantages, env_w,
                                        w_total, old_log_prob=old_log_prob)

        if coeffs is None:
            coeffs = (
                float(self.vf_loss_coeff_schedule.value_at(timestep)),
                float(self.entropy_coeff_schedule.value_at(timestep)))
        vf_coeff_t, ent_coeff_t = coeffs
        loss = policy_loss + vf_coeff_t * vf_loss - ent_coeff_t * mean_entropy
        if not with_metrics:
            return loss, {}

        with torch.no_grad():
            actions_f = actions_batch.to(torch.float32)
            metrics = {
                "VF loss coefficient": vf_coeff_t,
                "Entropy coefficient": ent_coeff_t,
                "Total loss": ops.value(loss.detach()),
                "Policy loss": ops.value(policy_loss.detach()),
                "Value function loss": ops.value(vf_loss.detach()),
                "Mean rewards": ops.mean(rewards_batch),
                "Max. rewards": ops.max(rewards_batch),
                "Min. rewards": ops.min(rewards_batch),
                "Mean value function": ops.mean(values_detached),
                "Mean advantages": ops.mean(advantages),
                "Mean (norm.) advantages": ops.mean(norm_advantages),
                "Mean (discounted) returns": ops.mean(returns),
                "Mean normalized returns": ops.mean(norm_returns),
                "Mean entropy": ops.value(mean_entropy.detach()),
                "Variance explained by the value function":
                    ops.variance_explained(norm_advantages, norm_returns,
                                           _EPSILON),
                "Std. of action over agents": ops.std_mean(actions_f, 2),
                "Std. of action over envs": ops.std_mean(actions_f, 1),
                "Std. of action over time": ops.std_mean(actions_f, 0),
            }
            if negative_positive_ratio > 0:
                metrics["Num of Sampled Envs"] = ops.value(env_w.sum())
        return loss, metrics


class PPO(A2C):
    """PPO with the clipped surrogate.  Without ``old_log_prob`` the old
    log-probs are the detached current ones (single-epoch PPO: the ratio is
    1 in value and gradients flow through the unclipped branch); a
    multi-pass update passes the behaviour policy's, fixed before its
    first pass."""

    def __init__(
        self,
        discount_factor_gamma=1.0,
        clip_param=0.1,
        normalize_advantage=False,
        normalize_return=False,
        vf_loss_coeff=0.01,
        entropy_coeff=0.01,
    ):
        super().__init__(
            discount_factor_gamma=discount_factor_gamma,
            normalize_advantage=normalize_advantage,
            normalize_return=normalize_return,
            vf_loss_coeff=vf_loss_coeff,
            entropy_coeff=entropy_coeff,
        )
        assert 0 <= clip_param <= 1
        self.clip_param = float(clip_param)

    def _policy_loss(self, log_prob, advantages, env_weights, weight_total,
                     old_log_prob=None):
        if old_log_prob is None:
            old_log_prob = log_prob.detach()
        ratio = torch.exp(log_prob - old_log_prob)
        surr1 = ratio * advantages
        surr2 = (
            torch.clamp(ratio, 1.0 - self.clip_param, 1.0 + self.clip_param)
            * advantages
        )
        return _wmean(-torch.minimum(surr1, surr2), env_weights,
                      weight_total)
