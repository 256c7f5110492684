"""
Ring buffer on device tensors.

The port's counterpart of ``warpdrive_tpu/training/ring_buffer.py``
(``RingBuffer``/``RingBufferManager``): a fixed-capacity circular queue
over a ``(capacity, *item_shape)`` tensor.  The queue is a value, as in the
JAX package: ``RingBufferState`` holds the storage, the write cursor and
the fill count, and ``enqueue`` returns a new state.  ``enqueue`` drops the
oldest entry once the queue is full; ``unroll`` returns the entries oldest
first.  ``TrainerDDPG`` keeps the specialised sliding-window form of the
same idea.  The storage lives on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from warpdrive_tpu_torch.utils.device import resolve_device


class RingBufferState(NamedTuple):
    """The queue value: storage, the next slot to write, the fill count."""

    storage: torch.Tensor  # (capacity, *item_shape)
    cursor: int
    size: int


class RingBuffer:
    """Fixed-capacity circular queue over ``(capacity, *item_shape)``."""

    def __init__(self, capacity: int, item_shape: tuple,
                 dtype=torch.float32, device="cuda"):
        assert capacity > 0
        self.capacity = int(capacity)
        self.item_shape = tuple(item_shape)
        self.dtype = dtype
        self.device = resolve_device(device)

    def init(self) -> RingBufferState:
        return RingBufferState(
            storage=torch.zeros((self.capacity,) + self.item_shape,
                                dtype=self.dtype, device=self.device),
            cursor=0,
            size=0,
        )

    def enqueue(self, state: RingBufferState, item) -> RingBufferState:
        """Append ``item``, overwriting the oldest entry when full."""
        storage = state.storage.clone()
        storage[state.cursor] = torch.as_tensor(item, dtype=self.dtype,
                                                device=self.device)
        return RingBufferState(
            storage=storage,
            cursor=(state.cursor + 1) % self.capacity,
            size=min(state.size + 1, self.capacity),
        )

    def unroll(self, state: RingBufferState) -> torch.Tensor:
        """The entries oldest first.  Always ``capacity`` rows; until the
        queue is full only the first ``size`` are valid."""
        front = state.cursor if state.size >= self.capacity else 0
        return torch.roll(state.storage, -front, dims=0)

    @staticmethod
    def isfull(state: RingBufferState) -> bool:
        return state.size >= state.storage.shape[0]


class RingBufferManager(dict):
    """Name -> ``(RingBuffer, RingBufferState)`` registry."""

    def add(self, name: str, capacity: int, item_shape: tuple,
            dtype=torch.float32, device="cuda"):
        buf = RingBuffer(capacity, item_shape, dtype, device)
        self[name] = (buf, buf.init())
        return buf

    def get(self, name: str):
        assert name in self, f"{name} not in the RingBufferManager"
        return self[name]

    def enqueue(self, name: str, item):
        buf, state = self.get(name)
        self[name] = (buf, buf.enqueue(state, item))

    def unroll(self, name: str) -> torch.Tensor:
        buf, state = self.get(name)
        return buf.unroll(state)

    def has(self, name: str) -> bool:
        return name in self
