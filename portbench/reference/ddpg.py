"""
DDPG in plain PyTorch: the actor, the action-value critic, the
Ornstein-Uhlenbeck exploration, n-step returns, both losses, the optimizer
and the Polyak updates.

The benchmark's yardstick for the training layers of the DDPG cell,
written from the published rules (Lillicrap et al., "Continuous control
with deep reinforcement learning", 2015, as WarpDrive's ``single_pendulum``
example trains it) and the configuration file alone; it reads nothing of
the program:

* the actor: an MLP trunk of ReLU dense layers and a dense head, ``a =
  output_w * tanh(head)``; parameters ``Dense_i`` and ``policy_head``
  (``weight`` ``(out, in)``, ``bias``);
* the critic: the same trunk over ``cat(observation, action)`` and a dense
  ``q_head`` of one output, ``Q(s, a)``;
* exploration: ``ou' = (1 - damping) ou + stddev N(0, 1)`` and ``action =
  mu + scale ou'`` (the noise is given);
* the critic's target: n-step returns bootstrapped from the target nets,
  ``R = r + (1 - d) gamma R'``, over the first ``W - n + 1`` rows of a
  ``W``-row window; the critic's loss ``mean((R - Q(s, a))^2)``;
* the actor's loss ``-mean Q(s, pi(s))`` over the same rows;
* each net's optimizer: clip by the global norm, then Adam (b1 = 0.9, b2 =
  0.999, eps = 1e-8, bias corrections), then its learning rate
  (:class:`~portbench.reference.a2c.ClippedAdam`, the same rule);
* the targets: ``target <- (1 - tau) target + tau net``, after both nets
  have stepped.

Departures from upstream, each kept as the port keeps it:

* the actor's loss goes through the critic as it was BEFORE this update
  (upstream steps the critic first and takes the actor's loss through the
  updated one): the follow (``ddpg_training.follow``) takes both
  gradients before either net steps;
* the final row's n-step return bootstraps from the target critic's value
  of the window's last state itself, without gamma, and keeps its reward
  only where that row is done (:func:`n_step_returns`);
* the window is the last ``T + n - 1`` rows of the rollouts, in time order,
  not a sampled replay buffer, and nothing moves until it is full.

Products run in float32 with TF32 off (:func:`float32_products`); the
controls round every product's operands to TF32 (``matmul="tf32"``) or to
bfloat16 (``"bfloat16"``), in the forward and backward passes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from portbench.reference import a2c


def float32_products():
    """Every product in float32 on the card: TF32 off for matmuls and
    cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (nearest, ties to even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


class _Bf16Linear(torch.autograd.Function):
    """``x @ W.T + b`` with every product's operands rounded to bfloat16,
    in the forward and in both products of the backward pass."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xr, wr = round_bf16(x), round_bf16(weight)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.t() + bias

    @staticmethod
    def backward(ctx, grad):
        xr, wr = ctx.saved_tensors
        g = round_bf16(grad)
        gx = g @ wr
        gw = (g.reshape(-1, g.shape[-1]).t()
              @ xr.reshape(-1, xr.shape[-1]))
        gb = grad.reshape(-1, grad.shape[-1]).sum(dim=0)
        return gx, gw, gb


def linear(x, weight, bias, matmul: str = "float32"):
    if matmul == "bfloat16":
        return _Bf16Linear.apply(x, weight, bias)
    return a2c.linear(x, weight, bias, matmul)


def mlp_shapes(in_features: int, fc_dims, head: str, outputs: int) -> dict:
    """``{name: shape}`` of a trunk and its head ``head``."""
    shapes, width = {}, int(in_features)
    for i, out in enumerate(fc_dims):
        shapes[f"Dense_{i}.weight"] = (int(out), width)
        shapes[f"Dense_{i}.bias"] = (int(out),)
        width = int(out)
    shapes[f"{head}.weight"] = (int(outputs), width)
    shapes[f"{head}.bias"] = (int(outputs),)
    return shapes


def _trunk(params: dict, x, matmul):
    i = 0
    while f"Dense_{i}.weight" in params:
        x = F.relu(linear(x, params[f"Dense_{i}.weight"],
                          params[f"Dense_{i}.bias"], matmul))
        i += 1
    return x


def actor(params: dict, obs: torch.Tensor, output_w: float,
          matmul: str = "float32") -> torch.Tensor:
    """``(..., C)`` actions of ``(..., F)`` observations."""
    x = _trunk(params, obs.to(torch.float32), matmul)
    return output_w * torch.tanh(linear(x, params["policy_head.weight"],
                                        params["policy_head.bias"], matmul))


def critic(params: dict, obs: torch.Tensor, action: torch.Tensor,
           matmul: str = "float32", magnitude: bool = False):
    """``Q(s, a)`` of shape ``obs.shape[:-1]``; with ``magnitude``,
    ``(Q, M)``, where ``M = |bias| + sum_k |weight_k x_k|`` of the head is
    the size of the sum that makes each Q value: float32 rounds a Q value
    by a small multiple of ``eps * M``, however near zero the sum
    cancels."""
    x = _trunk(params, torch.cat([obs.to(torch.float32), action], dim=-1),
               matmul)
    weight, bias = params["q_head.weight"], params["q_head.bias"]
    q = linear(x, weight, bias, matmul)[..., 0]
    if not magnitude:
        return q
    with torch.no_grad():
        m = (x * weight[0]).abs().sum(-1) + bias.abs()[0]
    return q, m


def ou_step(mu: torch.Tensor, ou: torch.Tensor, noise: torch.Tensor,
            damping: torch.Tensor, scale: torch.Tensor):
    """``(action, ou')``: one Ornstein-Uhlenbeck step around ``mu`` with the
    drawn ``noise`` (``stddev`` already in it); ``damping`` and ``scale``
    0-dim float32 tensors."""
    new = ou * (1 - damping) + noise
    return mu + new * scale, new


def n_step_returns(rewards, done, next_q, gamma: float, n: int):
    """The critic's targets for rows ``0 .. W - n`` of a ``W``-row window:
    ``rewards`` and ``next_q`` (the target critic at the next state, ``W -
    1`` rows) ``(W, E, A)``, ``done`` ``(W, E)``.  Row ``i`` looks ahead to
    ``last = i + n - 1``: ``R = r[last] + (1 - d[last]) gamma next_q[last]``,
    or at the window's last row ``d r + (1 - d) next_q[-1]`` (the port's
    quirk: the last state's own value, no gamma), then back down to ``i``,
    ``R = r[k] + (1 - d[k]) gamma R``."""
    W = rewards.shape[0]
    d = (done > 0).to(torch.float32)[..., None]
    out = []
    for i in range(W - n + 1):
        last = i + n - 1
        if last < W - 1:
            ret = rewards[last] + (1.0 - d[last]) * gamma * next_q[last]
        else:
            ret = d[last] * rewards[last] + (1.0 - d[last]) * next_q[-1]
        for k in range(last - 1, i - 1, -1):
            ret = rewards[k] + (1.0 - d[k]) * gamma * ret
        out.append(ret)
    return torch.stack(out)


def _rows(window: dict, keep) -> tuple:
    return tuple(window[k][:, keep] for k in ("obs", "actions", "rewards",
                                                "done"))


def critic_loss(nets: dict, targets: dict, window: dict, gamma: float,
                n: int, output_w: float, matmul: str = "float32",
                keep=slice(None)):
    """``(loss, grads)`` of the critic on the ``window`` (``obs`` ``(W, E,
    A, F)``, ``actions`` ``(W, E, A, C)``, ``rewards`` ``(W, E, A)``,
    ``done`` ``(W, E)``), the targets' returns held fixed; ``keep`` takes
    the loss over those envs alone (a control)."""
    obs, act, rew, done = _rows(window, keep)
    valid = obs.shape[0] - n + 1
    with torch.no_grad():
        t_mu = actor(targets["actor"], obs, output_w, matmul)
        next_q = critic(targets["critic"], obs[1:], t_mu[1:], matmul)
        returns = n_step_returns(rew, done, next_q, gamma, n)
    leaves = {k: p.detach().clone().requires_grad_(True)
              for k, p in nets["critic"].items()}
    loss = ((returns - critic(leaves, obs, act, matmul)[:valid]) ** 2).mean()
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    return float(loss.detach()), grads


def actor_loss(actor_params: dict, critic_params: dict, window: dict,
               n: int, output_w: float, matmul: str = "float32",
               keep=slice(None)):
    """``(loss, scale, grads)`` of the actor on the ``window`` through the
    critic ``critic_params`` (held fixed); ``scale`` is the mean size of
    the sums that make its Q values (:func:`critic`'s ``M``), which Q
    values near zero do not shrink."""
    obs = window["obs"][:, keep]
    valid = obs.shape[0] - n + 1
    leaves = {k: p.detach().clone().requires_grad_(True)
              for k, p in actor_params.items()}
    j, m = critic({k: v.detach() for k, v in critic_params.items()}, obs,
                  actor(leaves, obs, output_w, matmul), matmul,
                  magnitude=True)
    loss = -j[:valid].mean()
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    return float(loss.detach()), float(m[:valid].mean()), grads


@torch.no_grad()
def polyak(target: dict, net: dict, tau: torch.Tensor) -> dict:
    """``target * (1 - tau) + net * tau``, leaf by leaf."""
    keep = 1 - tau
    return {n: target[n] * keep + net[n] * tau for n in target}


def schedule(spec, timestep) -> np.float32:
    """A schedule's value at ``timestep``: a constant, or ``[[t, v],
    ...]`` interpolated linearly and held past its ends; float32."""
    if isinstance(spec, (int, float)):
        return np.float32(spec)
    times = np.asarray([t for t, _ in spec], np.float32)
    values = np.asarray([v for _, v in spec], np.float32)
    return np.float32(np.interp(np.float32(timestep), times, values))
