"""
Lightweight observation/action space types.

The port's copy of the ``Discrete``, ``MultiDiscrete`` and ``Box`` classes of
``warpdrive_tpu/utils/spaces.py``: numpy-typed, with the same semantics.
Dict spaces and gym interop come with the slices that need them.
"""

from __future__ import annotations

import numpy as np


class Space:
    """Base class for all spaces."""

    def contains(self, x) -> bool:  # pragma: no cover - overridden
        raise NotImplementedError

    def sample(self, rng: np.random.RandomState):  # pragma: no cover
        raise NotImplementedError


class Discrete(Space):
    """A single integer action in ``{0, ..., n - 1}``."""

    def __init__(self, n: int):
        assert n > 0
        self.n = int(n)
        self.shape = ()
        self.dtype = np.int32

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def sample(self, rng):
        return int(rng.randint(self.n))

    def __eq__(self, other):
        return isinstance(other, Discrete) and other.n == self.n

    def __repr__(self):
        return f"Discrete({self.n})"


class MultiDiscrete(Space):
    """A vector of integer actions; component ``i`` lies in ``{0..nvec[i]-1}``."""

    def __init__(self, nvec):
        self.nvec = np.asarray(nvec, dtype=np.int64)
        assert self.nvec.ndim == 1 and (self.nvec > 0).all()
        self.shape = (len(self.nvec),)
        self.dtype = np.int32

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and (0 <= x).all() and (x < self.nvec).all()

    def sample(self, rng):
        return np.array([rng.randint(n) for n in self.nvec], dtype=np.int32)

    def __eq__(self, other):
        return isinstance(other, MultiDiscrete) and np.array_equal(
            other.nvec, self.nvec
        )

    def __repr__(self):
        return f"MultiDiscrete({list(self.nvec)})"


class Box(Space):
    """A box in R^n: element-wise bounded continuous values."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.broadcast_to(np.asarray(low, dtype=self.dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, dtype=self.dtype), self.shape)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (
            x.shape == self.shape
            and bool((x >= self.low - 1e-6).all())
            and bool((x <= self.high + 1e-6).all())
        )

    def sample(self, rng):
        low = np.where(np.isfinite(self.low), self.low, -1.0)
        high = np.where(np.isfinite(self.high), self.high, 1.0)
        return (low + rng.rand(*self.shape) * (high - low)).astype(self.dtype)

    def __eq__(self, other):
        return (
            isinstance(other, Box)
            and other.shape == self.shape
            and np.allclose(other.low, self.low)
            and np.allclose(other.high, self.high)
        )

    def __repr__(self):
        return f"Box({self.shape}, low={self.low.min()}, high={self.high.max()})"
