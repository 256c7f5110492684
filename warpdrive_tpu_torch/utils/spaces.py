"""
Lightweight observation/action space types.

The port's copy of ``warpdrive_tpu/utils/spaces.py``: numpy-typed
``Discrete``, ``MultiDiscrete``, ``Box`` and ``DictSpace`` with the same
semantics, and the gym/gymnasium bridge :func:`normalize_space`, which is
duck-typed and imports neither package.
"""

from __future__ import annotations

import numpy as np

from warpdrive_tpu_torch.utils.constants import Constants


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


class DictSpace(Space):
    """A dictionary of named sub-spaces (cf. ``gym.spaces.Dict``)."""

    def __init__(self, spaces: dict):
        assert isinstance(spaces, dict) and len(spaces) > 0
        self.spaces = dict(spaces)

    def __iter__(self):
        return iter(self.spaces)

    def keys(self):
        return self.spaces.keys()

    def items(self):
        return self.spaces.items()

    def values(self):
        return self.spaces.values()

    def __getitem__(self, key):
        return self.spaces[key]

    def contains(self, x) -> bool:
        return isinstance(x, dict) and all(
            k in x and s.contains(x[k]) for k, s in self.spaces.items()
        )

    def sample(self, rng):
        return {k: s.sample(rng) for k, s in self.spaces.items()}

    def __eq__(self, other):
        return isinstance(other, DictSpace) and other.spaces == self.spaces

    def __repr__(self):
        return f"DictSpace({self.spaces})"


def normalize_space(space):
    """
    Accept a space in EITHER this module's types or ``gym``/``gymnasium``
    types and return the native equivalent (gym interop, reference
    ``warp_drive/env_wrapper.py:107-112`` — the reference consumes real
    ``gym.spaces`` objects; here they are converted once at the boundary).

    Duck-typed (no gym import, works for gym AND gymnasium, any version):
    ``.nvec`` -> MultiDiscrete, ``.n`` -> Discrete, ``.low``/``.high`` ->
    Box, ``.spaces`` mapping -> DictSpace.  Native types pass through
    unchanged; a plain dict of spaces normalizes element-wise.
    """
    if isinstance(space, (Discrete, MultiDiscrete, Box, DictSpace)):
        return space
    if isinstance(space, dict):
        return {k: normalize_space(v) for k, v in space.items()}
    if hasattr(space, "spaces") and isinstance(getattr(space, "spaces"), dict):
        return DictSpace(
            {k: normalize_space(v) for k, v in space.spaces.items()}
        )
    if hasattr(space, "nvec"):
        return MultiDiscrete(np.asarray(space.nvec))
    if hasattr(space, "n"):
        # gym/gymnasium MultiBinary ALSO exposes .n but means "n binary
        # components", not "one integer in [0, n)" — converting it to
        # Discrete(n) would silently produce wrong action shapes; model
        # it faithfully as MultiDiscrete([2] * n)
        if type(space).__name__ == "MultiBinary":
            return MultiDiscrete(np.full(int(np.prod(space.n)), 2))
        # gymnasium Discrete supports a nonzero `start`; the native space
        # (and the samplers/env contract) assume actions in [0, n) — a
        # silent shift would off-by-one every action
        start = int(getattr(space, "start", 0))
        if start != 0:
            raise TypeError(
                f"gym Discrete(start={start}) is not supported: "
                "the port's actions are 0-based — shift the env's "
                "action semantics or wrap the space"
            )
        return Discrete(int(space.n))
    if hasattr(space, "low") and hasattr(space, "high"):
        return Box(
            low=np.asarray(space.low),
            high=np.asarray(space.high),
            shape=tuple(space.shape),
            dtype=getattr(space, "dtype", np.float32),
        )
    raise TypeError(
        f"unsupported space type {type(space).__name__}: expected a "
        "warpdrive_tpu_torch space, a gym/gymnasium Discrete/MultiDiscrete/Box/"
        "Dict, or a dict of those"
    )


def normalize_space_map(space_map):
    """Normalize a per-agent ``{agent_id: space}`` mapping (or None)."""
    if space_map is None:
        return None
    if not isinstance(space_map, dict):
        return normalize_space(space_map)
    return {k: normalize_space(v) for k, v in space_map.items()}


def recursive_obs_dict_to_spaces_dict(obs) -> DictSpace:
    """
    Infer a space from an example observation dictionary.

    Mirrors the behavior of reference
    ``warp_drive/utils/recursive_obs_dict_to_spaces_dict.py:13-53``: arrays map
    to ``Box``, integers to ``Discrete``, and nested dicts recurse.
    """
    assert isinstance(obs, dict)
    dict_of_spaces = {}
    for key, val in obs.items():
        if isinstance(val, dict):
            dict_of_spaces[key] = recursive_obs_dict_to_spaces_dict(val)
        elif isinstance(val, (int, np.integer)):
            dict_of_spaces[key] = Discrete(int(val) + 1)
        else:
            arr = np.asarray(val)
            if np.issubdtype(arr.dtype, np.integer):
                box = Box(low=-np.inf, high=np.inf, shape=arr.shape, dtype=np.int32)
            else:
                box = Box(low=-np.inf, high=np.inf, shape=arr.shape, dtype=np.float32)
            dict_of_spaces[key] = box
    return DictSpace(dict_of_spaces)


def get_flattened_obs_size(observation_space) -> int:
    """
    Total size of an observation after flattening, excluding any action mask.

    Mirrors reference ``training/utils/data_loader.py:693-709``.
    """
    if isinstance(observation_space, Box):
        return int(np.prod(observation_space.shape))
    if isinstance(observation_space, DictSpace):
        size = 0
        for key, space in observation_space.items():
            if key == Constants.ACTION_MASK:
                continue
            size += int(np.prod(space.shape))
        return size
    raise NotImplementedError("Observation space must be Box or DictSpace")
