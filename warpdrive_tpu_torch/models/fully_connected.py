"""
Policy/value networks: the port's counterparts of
``warpdrive_tpu/models/fully_connected.py``'s ``FullyConnected`` and of
DDPG's ``FullyConnectedActor`` and ``FullyConnectedActionValueCritic``.

``FullyConnected`` is an MLP trunk followed by one logit head per action
component and a value head.  The heads run as ONE fused matmul: their
weights are concatenated at call time, so the hidden activations are read
once, while each head keeps its own parameters.  Box action spaces use a
deterministic ``tanh * scale + bias`` head instead.  Models return LOGITS;
``apply_logit_mask`` gives masked actions a huge negative logit.

The DDPG actor is an MLP with a ``tanh * scale + bias`` head; the critic
an MLP over ``cat(obs, action)`` with a scalar ``q_head``.

Submodule names follow flax's (``Dense_0``, ``Dense_1``, ...,
``policy_head_{i}``, ``vf_head``, ``policy_head`` in deterministic mode and
in the actor, ``q_head`` in the critic),
so :func:`params_from_flax` maps a JAX parameter tree onto the
``state_dict`` one name at a time.

Parameters are float32.  ``FullyConnected(dtype=torch.bfloat16)`` runs as
flax's ``dtype`` option does: the observation, each dense layer's weight
and bias, the ReLUs and the fused head's product and bias add in bf16 (the
product and the bias add each rounded, as ``dot`` and ``+`` are in flax),
and the logits and the value come back as float32.  Without ``dtype`` an
input of another dtype (a bf16 training batch) is promoted against the
float32 parameters, as flax promotes it.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

_LARGE_NEG_NUM = -1e20


def apply_logit_mask(logits: torch.Tensor, mask: torch.Tensor = None):
    """Mask==1 keeps a logit; mask==0 drives it to -1e20."""
    if mask is None:
        return logits
    return logits + (1.0 - mask) * _LARGE_NEG_NUM


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator = None):
    """flax's default kernel init: truncated normal (at 2 std) with variance
    1/fan_in, corrected for the truncation."""
    fan_in = weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


def _add_dense(module: nn.Module, name: str, fan_in: int, fan_out: int,
               generator: torch.Generator = None, device=None):
    """A flax-initialized ``nn.Linear`` (LeCun-normal weight, zero bias)
    registered on ``module`` as ``name``."""
    layer = nn.Linear(fan_in, fan_out, device=device)
    _lecun_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    module.add_module(name, layer)


def _promote(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """The input in the compute dtype: ``dtype`` when set, else promoted
    against the float32 parameters."""
    return x.to(dtype if dtype is not None
                else torch.promote_types(x.dtype, torch.float32))


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           dtype=None) -> torch.Tensor:
    """``x @ W.T + b``; with ``dtype`` the parameters are cast to it and the
    product and the bias add are rounded one after the other."""
    if dtype is None:
        return F.linear(x, weight, bias)
    return x @ weight.to(dtype).t() + bias.to(dtype)


def _relu_trunk(module: nn.Module, x: torch.Tensor, depth: int, dtype=None):
    x = _promote(x, dtype)
    for idx in range(depth):
        layer = getattr(module, f"Dense_{idx}")
        x = F.relu(_dense(x, layer.weight, layer.bias, dtype))
    return x


class FullyConnected(nn.Module):
    """MLP trunk + per-action-component policy heads + value head."""

    def __init__(
        self,
        in_features: int,
        fc_dims: Sequence[int],
        output_dims: Sequence[int],
        is_deterministic: bool = False,
        action_scale: float = 1.0,
        action_bias: float = 0.0,
        include_value_head: bool = True,
        generator: torch.Generator = None,
        device=None,
        dtype: torch.dtype = None,
    ):
        super().__init__()
        self.fc_dims = tuple(int(d) for d in fc_dims)
        self.output_dims = tuple(int(d) for d in output_dims)
        self.dtype = dtype  # the compute dtype; the parameters stay float32
        self.is_deterministic = bool(is_deterministic)
        self.action_scale = float(action_scale)
        self.action_bias = float(action_bias)
        self.include_value_head = bool(include_value_head)

        def dense(name, fan_in, fan_out):
            _add_dense(self, name, fan_in, fan_out, generator, device)

        width = int(in_features)
        for idx, out in enumerate(self.fc_dims):
            dense(f"Dense_{idx}", width, out)
            width = out
        if self.is_deterministic:
            dense("policy_head", width, len(self.output_dims))
        else:
            for idx, dim in enumerate(self.output_dims):
                dense(f"policy_head_{idx}", width, dim)
        if self.include_value_head:
            dense("vf_head", width, 1)

    def forward(self, obs: torch.Tensor, action_mask: torch.Tensor = None):
        """:returns: ``(heads, value)``: a list of per-component logits (or,
        deterministic, of ``(..., 1)`` actions) and the value ``(...)`` or
        None."""
        dtype = self.dtype
        x = _relu_trunk(self, obs, len(self.fc_dims), dtype)

        if self.is_deterministic:
            raw = _dense(x, self.policy_head.weight, self.policy_head.bias,
                         dtype)
            combined = (self.action_scale * torch.tanh(raw)
                        + self.action_bias).to(torch.float32)
            heads = [combined[..., i : i + 1]
                     for i in range(len(self.output_dims))]
            value = None
            if self.include_value_head:
                value = _dense(x, self.vf_head.weight, self.vf_head.bias,
                               dtype)[..., 0].to(torch.float32)
            return heads, value

        layers = [getattr(self, f"policy_head_{i}")
                  for i in range(len(self.output_dims))]
        if self.include_value_head:
            layers.append(self.vf_head)
        weight = torch.cat([layer.weight for layer in layers], dim=0)
        bias = torch.cat([layer.bias for layer in layers], dim=0)
        fused = _dense(x, weight, bias, dtype).to(torch.float32)
        heads = []
        start = 0
        for dim in self.output_dims:
            mask = None
            if action_mask is not None:
                mask = action_mask[..., start : start + dim]
            heads.append(apply_logit_mask(fused[..., start : start + dim], mask))
            start += dim
        value = fused[..., start] if self.include_value_head else None
        return heads, value


class FullyConnectedActor(nn.Module):
    """DDPG actor: a deterministic action vector bounded by
    ``action_scale * tanh(.) + action_bias``, no value head."""

    def __init__(
        self,
        in_features: int,
        fc_dims: Sequence[int],
        num_action_types: int,
        action_scale: float = 1.0,
        action_bias: float = 0.0,
        generator: torch.Generator = None,
        device=None,
    ):
        super().__init__()
        self.fc_dims = tuple(int(d) for d in fc_dims)
        self.action_scale = float(action_scale)
        self.action_bias = float(action_bias)
        width = int(in_features)
        for idx, out in enumerate(self.fc_dims):
            _add_dense(self, f"Dense_{idx}", width, out, generator, device)
            width = out
        _add_dense(self, "policy_head", width, int(num_action_types),
                   generator, device)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """:returns: actions ``(..., num_action_types)``."""
        raw = self.policy_head(_relu_trunk(self, obs, len(self.fc_dims)))
        return self.action_scale * torch.tanh(raw) + self.action_bias


class FullyConnectedActionValueCritic(nn.Module):
    """DDPG critic: ``Q(s, a)`` over the concatenated observation and
    action; ``in_features`` is their summed width."""

    def __init__(
        self,
        in_features: int,
        fc_dims: Sequence[int],
        generator: torch.Generator = None,
        device=None,
    ):
        super().__init__()
        self.fc_dims = tuple(int(d) for d in fc_dims)
        width = int(in_features)
        for idx, out in enumerate(self.fc_dims):
            _add_dense(self, f"Dense_{idx}", width, out, generator, device)
            width = out
        _add_dense(self, "q_head", width, 1, generator, device)

    def forward(self, obs: torch.Tensor, action: torch.Tensor):
        """:returns: ``Q(s, a)`` of shape ``obs.shape[:-1]``."""
        # a bf16 observation rounds the action to bf16 too, as in JAX
        x = torch.cat([obs, action.to(obs.dtype)], dim=-1)
        return self.q_head(_relu_trunk(self, x, len(self.fc_dims)))[..., 0]


def params_from_flax(tree: dict) -> dict:
    """A ``FullyConnected`` (or DDPG actor or critic) ``state_dict`` from the JAX model's parameter
    tree (``{"params": {name: {"kernel", "bias"}}}`` or the inner dict),
    given as numpy arrays.  A flax ``Dense`` stores ``kernel (in, out)``;
    ``nn.Linear`` stores ``weight (out, in)``."""
    params = tree.get("params", tree)
    state = {}
    for name, leaf in params.items():
        state[f"{name}.weight"] = torch.from_numpy(
            np.asarray(leaf["kernel"], np.float32).T.copy()
        )
        state[f"{name}.bias"] = torch.from_numpy(
            np.array(leaf["bias"], np.float32)
        )
    return state


def params_to_flax(state_dict: dict) -> dict:
    """The inverse of :func:`params_from_flax`: ``{"params": {name:
    {"kernel" (in, out), "bias"}}}`` as float32 numpy arrays, layers in the
    modules' order and ``kernel`` before ``bias``, the order flax's
    ``init`` gives."""
    params = {}
    for key, tensor in state_dict.items():
        name, kind = key.rsplit(".", 1)
        leaf = params.setdefault(name, {"kernel": None, "bias": None})
        array = tensor.detach().to("cpu", torch.float32).numpy()
        if kind == "weight":
            leaf["kernel"] = np.ascontiguousarray(array.T)
        else:
            leaf["bias"] = array.copy()
    return {"params": params}


def adam_state_from_optax(opt_state) -> dict:
    """The port's optimizer state (``training/trainer_a2c.py:ClippedAdam``)
    from the JAX trainer's per-policy optax state, given as numpy arrays:
    the ``scale_by_adam`` entry of the chain (the one with ``count``,
    ``mu`` and ``nu``) becomes ``{"count": int, "mu": state_dict, "nu":
    state_dict}``, each moment laid out as :func:`params_from_flax` lays out
    the parameters."""
    for entry in opt_state:
        if all(hasattr(entry, name) for name in ("count", "mu", "nu")):
            return {
                "count": int(np.asarray(entry.count)),
                "mu": params_from_flax(entry.mu),
                "nu": params_from_flax(entry.nu),
            }
    raise ValueError("the optimizer state holds no scale_by_adam entry")
