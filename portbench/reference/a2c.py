"""
The policy, the A2C loss and the clipped Adam step in plain PyTorch.

The benchmark's yardstick for the training layers, written from the
published rules and the configuration file alone (it reads nothing of the
program):

* the policy: an MLP trunk of ReLU dense layers, then one dense head per
  action component (its logits) and a dense value head, parameters named
  ``Dense_i``, ``policy_head_c`` and ``vf_head`` (``weight`` ``(out, in)``,
  ``bias``);
* A2C: done-masked discounted returns bootstrapped from the last value
  (``R[T-1] = d r + (1 - d) V``, ``R[t] = r[t] + (1 - d[t]) gamma R[t+1]``),
  the value loss ``mean((R - V)^2)``, the policy loss ``mean(-log pi(a) (R -
  V))``, the entropy summed over the components, and ``loss = policy +
  vf_coeff value - entropy_coeff entropy``;
* the optimizer: clip by the global norm (only when the norm reaches the
  limit), Adam with b1 = 0.9, b2 = 0.999, eps = 1e-8 and bias corrections,
  then the learning rate.

``matmul="tf32"`` runs every product of the forward and backward passes on
operands rounded to TF32's 10-bit mantissa (the control); ``"float32"`` is
the configuration's own precision, with TF32 off.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value: 10 mantissa bits,
    ties away from zero, as the tensor cores take float32 operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Linear(torch.autograd.Function):
    """``x @ W.T + b`` with every product's operands rounded to TF32, in
    the forward and in both products of the backward pass."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xr, wr = round_tf32(x), round_tf32(weight)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.t() + bias

    @staticmethod
    def backward(ctx, grad):
        xr, wr = ctx.saved_tensors
        g = round_tf32(grad)
        gx = g @ wr
        gw = (g.reshape(-1, g.shape[-1]).t()
              @ xr.reshape(-1, xr.shape[-1]))
        gb = grad.reshape(-1, grad.shape[-1]).sum(dim=0)
        return gx, gw, gb


def linear(x, weight, bias, matmul: str = "float32"):
    if matmul == "tf32":
        return _Tf32Linear.apply(x, weight, bias)
    return F.linear(x, weight, bias)


def param_shapes(in_features: int, fc_dims, heads) -> dict:
    """``{name: shape}`` of the policy's parameters."""
    shapes, width = {}, int(in_features)
    for i, out in enumerate(fc_dims):
        shapes[f"Dense_{i}.weight"] = (int(out), width)
        shapes[f"Dense_{i}.bias"] = (int(out),)
        width = int(out)
    for c, n in enumerate(heads):
        shapes[f"policy_head_{c}.weight"] = (int(n), width)
        shapes[f"policy_head_{c}.bias"] = (int(n),)
    shapes["vf_head.weight"] = (1, width)
    shapes["vf_head.bias"] = (1,)
    return shapes


def make_params(shapes: dict, generator: torch.Generator, device) -> dict:
    """Parameters from ``generator`` in one draw: every weight a normal
    draw cut at two standard deviations and scaled to variance 1/fan_in
    (LeCun), every bias 0; float32 on ``device``."""
    weights = [n for n in shapes if n.endswith(".weight")]
    sizes = [shapes[n][0] * shapes[n][1] for n in weights]
    flat = torch.randn(sum(sizes), generator=generator, device=device,
                       dtype=torch.float32).clamp_(-2.0, 2.0)
    params, start = {}, 0
    for name, size in zip(weights, sizes):
        out, fan_in = shapes[name]
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        params[name] = (flat[start:start + size] * std).reshape(out, fan_in)
        start += size
    for name, shape in shapes.items():
        if name.endswith(".bias"):
            params[name] = torch.zeros(shape, dtype=torch.float32,
                                       device=device)
    return {n: params[n] for n in shapes}


def forward(params: dict, obs: torch.Tensor, depth: int, heads: int,
            matmul: str = "float32"):
    """``(logits per component, value)`` of ``obs`` ``(..., F)``."""
    x = obs.to(torch.float32)
    for i in range(depth):
        x = F.relu(linear(x, params[f"Dense_{i}.weight"],
                          params[f"Dense_{i}.bias"], matmul))
    logits = [linear(x, params[f"policy_head_{c}.weight"],
                     params[f"policy_head_{c}.bias"], matmul)
              for c in range(heads)]
    value = linear(x, params["vf_head.weight"], params["vf_head.bias"],
                   matmul)[..., 0]
    return logits, value


def a2c_loss(logits, values, actions, rewards, done, gamma: float,
             vf_coeff: float, ent_coeff: float):
    """The A2C loss of a time-major batch: ``actions`` ``(T, E, A, C)``,
    ``rewards`` and ``values`` ``(T, E, A)``, ``done`` ``(T, E)``.  Returns
    the loss and its three terms (policy, value, entropy)."""
    v = values.detach()
    d = (done > 0).to(torch.float32)[..., None]
    returns = torch.empty_like(rewards)
    ret = d[-1] * rewards[-1] + (1.0 - d[-1]) * v[-1]
    returns[-1] = ret
    for t in range(rewards.shape[0] - 2, -1, -1):
        ret = rewards[t] + (1.0 - d[t]) * gamma * ret
        returns[t] = ret
    vf_loss = ((returns - values) ** 2).mean()
    log_prob, entropy = 0.0, 0.0
    for c, lg in enumerate(logits):
        logp = F.log_softmax(lg, dim=-1)
        entropy = entropy + (-(logp.exp() * logp).sum(dim=-1)).mean()
        log_prob = log_prob + logp.gather(
            -1, actions[..., c:c + 1].long())[..., 0]
    policy_loss = (-log_prob * (returns - v)).mean()
    loss = policy_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return loss, (policy_loss, vf_loss, entropy)


class ClippedAdam:
    """Clip by global norm, then Adam, then the learning rate; float32."""

    def __init__(self, params: dict, max_norm):
        self.max_norm = max_norm
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    def clip(self, grads: dict) -> dict:
        if self.max_norm is None:
            return grads
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if float(norm) < self.max_norm:
            return grads
        return {n: g * (self.max_norm / norm) for n, g in grads.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> dict:
        """New parameters; ``grads`` as computed (clipped here)."""
        grads = self.clip(grads)
        self.count += 1
        bc1 = 1.0 - B1 ** self.count
        bc2 = 1.0 - B2 ** self.count
        out = {}
        for n, p in params.items():
            g = grads[n]
            self.mu[n] = (1 - B1) * g + B1 * self.mu[n]
            self.nu[n] = (1 - B2) * g * g + B2 * self.nu[n]
            update = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2)
                                           + ADAM_EPS)
            out[n] = p - lr * update
        return out
