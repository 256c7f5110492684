"""
Standalone policy export and loading: the serving path.

The port's counterpart of ``warpdrive_tpu/serving.py``.  ``export_policy``
writes a self-contained bundle -- the parameters in flax's layout
(``params.msgpack``, written by :mod:`utils.flax_msgpack`, which needs
neither flax nor msgpack) and a JSON manifest of the architecture and the
flat observation width -- and ``load_policy`` rebuilds an engine-free
``act(obs, ...)`` from it on a device.  A bundle exported by the JAX
package loads here and one exported here loads there: the files are the
same format and the manifests have the same keys.

The one departure from the JAX package: ``act`` returns a tensor on the
bundle's device instead of a numpy array, so a server on the card pays no
host copy per request.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from warpdrive_tpu_torch.models.factory import ModelFactory
from warpdrive_tpu_torch.models.fully_connected import (
    params_from_flax,
    params_to_flax,
)
from warpdrive_tpu_torch.sampling.samplers import sample_heads
from warpdrive_tpu_torch.utils import flax_msgpack
from warpdrive_tpu_torch.utils.device import resolve_device
from warpdrive_tpu_torch.utils.spaces import get_flattened_obs_size

MANIFEST = "manifest.json"
PARAMS = "params.msgpack"


def export_policy(trainer, policy: str, out_dir: str) -> str:
    """Write one trained policy of ``trainer`` to ``out_dir``: its current
    parameters and what rebuilds the network (model type and widths, head
    sizes, the flattened observation width; for a DDPG actor, the action
    count, scale and bias).  Returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    assert policy in trainer.policies, (
        f"unknown policy {policy!r}; have {trainer.policies}"
    )
    model_cfg = trainer.config["policy"][policy]["model"]
    heads, _, is_det = trainer._action_heads(policy)
    obs_size = int(get_flattened_obs_size(trainer.obs_space[policy]))
    if is_det:
        # the bundle holds the actor only: serving needs no critic
        actor = trainer.nets["actor"][policy]
        manifest = {
            "kind": "ddpg_actor",
            "policy": policy,
            "model_type": model_cfg["actor"]["type"],
            "fc_dims": list(model_cfg["actor"]["fc_dims"]),
            "num_action_types": int(actor.policy_head.out_features),
            "action_scale": float(actor.action_scale),
            "action_bias": float(actor.action_bias),
            "obs_size": obs_size,
        }
        module = actor
    else:
        manifest = {
            "kind": "categorical",
            "policy": policy,
            "model_type": model_cfg["type"],
            "fc_dims": list(model_cfg["fc_dims"]),
            "output_dims": [int(h) for h in heads],
            "dtype": model_cfg.get("dtype") or "float32",
            "obs_size": obs_size,
        }
        module = trainer.models[policy]
    with open(os.path.join(out_dir, MANIFEST), "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2)
    flax_msgpack.write_file(os.path.join(out_dir, PARAMS),
                            params_to_flax(module.state_dict()))
    return out_dir


def _as_obs(obs, manifest: dict, device: torch.device) -> torch.Tensor:
    if not isinstance(obs, torch.Tensor):
        obs = torch.tensor(np.asarray(obs, dtype=np.float32))
    obs = obs.to(device, torch.float32)
    assert obs.shape[-1] == manifest["obs_size"], (
        f"expected trailing obs dim {manifest['obs_size']}, got "
        f"{tuple(obs.shape)}"
    )
    return obs


def load_policy(bundle_dir: str, device="cuda"):
    """Load a bundle onto ``device`` and return ``(act, manifest)``.

    ``act(obs, generator=None, argmax=True, action_mask=None)`` takes
    observations ``(..., obs_size)`` (any leading batch axes; a numpy array
    or a tensor, moved to the device) and returns int32 actions ``(...,
    num_components)`` as a tensor on the device: the most likely ones, or
    with ``argmax=False`` one draw per component from ``generator``
    (:func:`sample_heads`).  A DDPG actor bundle returns its
    deterministic ``tanh * scale + bias`` actions ``(...,
    num_action_types)`` and ignores ``generator``, ``argmax`` and
    ``action_mask``."""
    device = resolve_device(device)
    with open(os.path.join(bundle_dir, MANIFEST), encoding="utf-8") as f:
        manifest = json.load(f)
    state = params_from_flax(flax_msgpack.read_file(
        os.path.join(bundle_dir, PARAMS)))
    model_cls = ModelFactory.create(manifest["model_type"])
    is_actor = manifest.get("kind", "categorical") == "ddpg_actor"
    if is_actor:
        model = model_cls(
            manifest["obs_size"], tuple(manifest["fc_dims"]),
            int(manifest["num_action_types"]),
            action_scale=float(manifest["action_scale"]),
            action_bias=float(manifest["action_bias"]), device=device,
        )
    else:
        kwargs = {}
        if manifest.get("dtype") and manifest["dtype"] != "float32":
            kwargs["dtype"] = getattr(torch, manifest["dtype"])
        model = model_cls(
            manifest["obs_size"], tuple(manifest["fc_dims"]),
            tuple(manifest["output_dims"]), device=device, **kwargs,
        )
    model.load_state_dict(state)
    model.eval()

    if is_actor:
        @torch.no_grad()
        def act(obs, generator=None, argmax: bool = True, action_mask=None):
            return model(_as_obs(obs, manifest, device))

        return act, manifest

    @torch.no_grad()
    def act(obs, generator: torch.Generator = None, argmax: bool = True,
            action_mask=None):
        obs = _as_obs(obs, manifest, device)
        if action_mask is not None:
            action_mask = torch.as_tensor(action_mask).to(device,
                                                          torch.float32)
        logits_list, _ = model(obs, action_mask)
        if not argmax:
            assert generator is not None, \
                "stochastic acting needs a torch.Generator"
        return sample_heads(logits_list, generator, use_argmax=argmax)

    return act, manifest
