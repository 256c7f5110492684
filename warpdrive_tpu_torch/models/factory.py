"""
Model factory: name -> model class registry with dynamic import.

The port's counterpart of ``warpdrive_tpu/models/factory.py``: the three
built-ins and ``"module:ClassName"`` resolution of user models.  An A2C
model class is built as ``cls(in_features, fc_dims, output_dims,
generator=..., device=...)``, the signature of
:class:`~warpdrive_tpu_torch.models.fully_connected.FullyConnected`, with
``dtype=...`` added only when the config's ``model.dtype`` names one; a DDPG
actor as ``cls(in_features, fc_dims, num_action_types, action_scale=...,
generator=..., device=...)`` and a critic as ``cls(obs_features +
action_features, fc_dims, generator=..., device=...)``.
"""

from __future__ import annotations

import importlib

from warpdrive_tpu_torch.models.fully_connected import (
    FullyConnected,
    FullyConnectedActionValueCritic,
    FullyConnectedActor,
)

default_models = {
    "fully_connected": FullyConnected,
    "fully_connected_actor": FullyConnectedActor,
    "fully_connected_action_value_critic": FullyConnectedActionValueCritic,
}


def dynamic_import(path: str):
    """Resolve ``"package.module:ClassName"`` to the class object."""
    assert ":" in path, f"expected 'module:ClassName', got {path!r}"
    module_name, class_name = path.split(":", 1)
    module = importlib.import_module(module_name)
    return getattr(module, class_name)


class ModelFactory:
    """Registry mapping model-type names to ``nn.Module`` classes."""

    @staticmethod
    def create(model_type: str):
        if model_type in default_models:
            return default_models[model_type]
        return dynamic_import(model_type)

    @staticmethod
    def add(name: str, model_class):
        assert name not in default_models, f"{name!r} already registered"
        default_models[name] = model_class
        return model_class
