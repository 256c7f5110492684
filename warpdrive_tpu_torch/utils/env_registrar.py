"""
Environment registry.

The port's copy of ``warpdrive_tpu/utils/env_registrar.py``: a name ->
env-class registry with a module-level singleton.  Backends here are
``"torch"`` (batched PyTorch step functions on a device) and ``"cpu"`` (the
numpy reference implementation).
"""

from __future__ import annotations

SUPPORTED_BACKENDS = ("torch", "cpu")


class EnvironmentRegistrar:
    """Per-backend registry of environment classes."""

    def __init__(self):
        self._registry = {backend: {} for backend in SUPPORTED_BACKENDS}

    def add(self, env_class, backend: str = "torch", name: str = None):
        assert backend in SUPPORTED_BACKENDS, f"unknown backend {backend!r}"
        env_name = (name or getattr(env_class, "name", None) or env_class.__name__)
        env_name = env_name.lower()
        registry = self._registry[backend]
        if env_name in registry and registry[env_name] is not env_class:
            raise ValueError(
                f"environment {env_name!r} already registered for {backend!r}"
            )
        registry[env_name] = env_class
        return env_class

    def get(self, env_name: str, backend: str = "torch"):
        assert backend in SUPPORTED_BACKENDS, f"unknown backend {backend!r}"
        env_name = env_name.lower()
        registry = self._registry[backend]
        if env_name not in registry:
            raise KeyError(
                f"environment {env_name!r} is not registered for backend "
                f"{backend!r}; known: {sorted(registry)}"
            )
        return registry[env_name]

    def has(self, env_name: str, backend: str = "torch") -> bool:
        return env_name.lower() in self._registry[backend]

    def list(self, backend: str = "torch"):
        return sorted(self._registry[backend])


# Module-level singleton.
env_registrar = EnvironmentRegistrar()
