"""
Model factory: name -> model class registry with dynamic import.

The port's counterpart of ``warpdrive_tpu/models/factory.py``.  The built-in
``"fully_connected"`` and ``"module:ClassName"`` resolution of user models
are ported; the DDPG actor and critic come with ROADMAP queue 1, item 7.
A model class is built as ``cls(in_features, fc_dims, output_dims,
generator=..., device=...)``, the signature of
:class:`~warpdrive_tpu_torch.models.fully_connected.FullyConnected`.
"""

from __future__ import annotations

import importlib

from warpdrive_tpu_torch.models.fully_connected import FullyConnected

default_models = {
    "fully_connected": FullyConnected,
}

_NOT_PORTED = {
    "fully_connected_actor": "ROADMAP queue 1, item 7 (DDPG)",
    "fully_connected_action_value_critic": "ROADMAP queue 1, item 7 (DDPG)",
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
        if model_type in _NOT_PORTED:
            raise NotImplementedError(
                f"model type {model_type!r} is not ported yet: "
                f"{_NOT_PORTED[model_type]}"
            )
        return dynamic_import(model_type)

    @staticmethod
    def add(name: str, model_class):
        assert name not in default_models, f"{name!r} already registered"
        default_models[name] = model_class
        return model_class
