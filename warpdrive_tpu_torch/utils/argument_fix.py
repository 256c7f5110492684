"""
Back-compat argument renaming: the port's copy of
``warpdrive_tpu/utils/argument_fix.py`` (``Argfix``).  A decorated function
accepts a deprecated keyword name, warns, and forwards it to the new name,
as the engine takes ``use_cuda`` for ``env_backend``.
"""

from __future__ import annotations

import functools
import warnings


class Argfix:
    """Decorator mapping a deprecated kwarg name to its replacement.

    >>> @Argfix(old_name="use_cuda", new_name="env_backend")
    ... def f(env_backend="cpu"): return env_backend
    >>> f(use_cuda="torch")  # warns, forwards
    'torch'
    """

    def __init__(self, old_name: str, new_name: str):
        self.old_name = old_name
        self.new_name = new_name

    def __call__(self, func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            if self.old_name in kwargs:
                warnings.warn(
                    f"argument {self.old_name!r} is deprecated; "
                    f"use {self.new_name!r}",
                    DeprecationWarning,
                    stacklevel=2,
                )
                if self.new_name not in kwargs:
                    kwargs[self.new_name] = kwargs.pop(self.old_name)
                else:
                    kwargs.pop(self.old_name)
            return func(*args, **kwargs)

        return wrapper
