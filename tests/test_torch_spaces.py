"""The port's spaces (``warpdrive_tpu_torch/utils/spaces.py``) against the
JAX package's: ``normalize_space`` over gymnasium's Box, Discrete (with
``start``), MultiDiscrete, MultiBinary and Dict, ``normalize_space_map``,
``recursive_obs_dict_to_spaces_dict`` and ``get_flattened_obs_size``.
Every comparison is exact: the spaces hold shapes, bounds and integers."""

import numpy as np
import pytest

from warpdrive_tpu.utils import spaces as jax_spaces
from warpdrive_tpu_torch.utils import spaces as port_spaces



@pytest.fixture
def gs():
    """gymnasium's spaces (the port itself imports neither gym package)."""
    return pytest.importorskip("gymnasium").spaces


def _describe(space):
    """A space as nested plain data, for either package's types."""
    name = type(space).__name__
    if name == "DictSpace":
        return (name, [(k, _describe(v)) for k, v in space.items()])
    if name == "Discrete":
        return (name, space.n)
    if name == "MultiDiscrete":
        return (name, space.nvec.tolist())
    if name == "Box":
        return (name, space.shape, str(space.dtype), space.low.tolist(),
                space.high.tolist())
    if isinstance(space, dict):
        return ("dict", [(k, _describe(v)) for k, v in space.items()])
    raise TypeError(name)


GYM_SPACES = {
    "box": lambda gs: gs.Box(low=-1.0, high=2.0, shape=(3,)),
    "box_2d_float64": lambda gs: gs.Box(
        low=np.zeros((2, 2)), high=np.ones((2, 2)), dtype=np.float64),
    "discrete": lambda gs: gs.Discrete(5),
    "discrete_start_0": lambda gs: gs.Discrete(4, start=0),
    "multidiscrete": lambda gs: gs.MultiDiscrete([3, 4]),
    "multibinary": lambda gs: gs.MultiBinary(3),
    "dict": lambda gs: gs.Dict({"x": gs.Box(-1, 1, shape=(2,)),
                                "a": gs.Discrete(2),
                                "m": gs.MultiBinary(2)}),
    "nested_dict": lambda gs: gs.Dict({"inner": gs.Dict(
        {"b": gs.Box(0, 1, shape=(4,))}), "d": gs.Discrete(3)}),
}


@pytest.mark.parametrize("name", sorted(GYM_SPACES))
def test_normalize_space_matches_jax(name, gs):
    space = GYM_SPACES[name](gs)
    port = port_spaces.normalize_space(space)
    assert _describe(port) == _describe(jax_spaces.normalize_space(space))
    assert type(port).__module__ == port_spaces.__name__


def test_multibinary_is_multidiscrete_and_start_is_refused(gs):
    mb = port_spaces.normalize_space(gs.MultiBinary(3))
    assert isinstance(mb, port_spaces.MultiDiscrete)
    assert mb.nvec.tolist() == [2, 2, 2]
    for module in (port_spaces, jax_spaces):
        with pytest.raises(TypeError, match="start"):
            module.normalize_space(gs.Discrete(4, start=1))
        with pytest.raises(TypeError):
            module.normalize_space(object())


def test_native_spaces_pass_through_and_maps_normalize(gs):
    native = port_spaces.Discrete(7)
    assert port_spaces.normalize_space(native) is native
    space_map = {0: gs.Discrete(2), 1: gs.Box(-1, 1, shape=(2,)),
                 2: {"k": gs.MultiDiscrete([2, 3])}}
    port = port_spaces.normalize_space_map(space_map)
    want = jax_spaces.normalize_space_map(space_map)
    assert {k: _describe(v) for k, v in port.items()} == \
        {k: _describe(v) for k, v in want.items()}
    assert port_spaces.normalize_space_map(None) is None


def _example_obs(seed):
    rng = np.random.RandomState(seed)
    return {
        "pos": rng.randn(3).astype(np.float32),
        "grid": rng.uniform(0, 5, size=(2, 4)),
        "count": int(rng.randint(10)),
        "nested": {"speed": rng.randn(2), "id": np.int64(rng.randint(7))},
        port_spaces.Constants.ACTION_MASK: np.ones(5, np.float32),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_recursive_obs_dict_to_spaces_dict_matches_jax(seed):
    obs = _example_obs(seed)
    port = port_spaces.recursive_obs_dict_to_spaces_dict(obs)
    assert _describe(port) == _describe(
        jax_spaces.recursive_obs_dict_to_spaces_dict(obs))
    # the env's key order, never sorted
    assert list(port.keys()) == list(obs.keys())


@pytest.mark.parametrize("space", [
    lambda m: m.Box(-1.0, 1.0, shape=(5,)),
    lambda m: m.Box(-1.0, 1.0, shape=(3, 4)),
    lambda m: m.DictSpace({"self": m.Box(0, 1, shape=(2,)),
                           "nearest": m.Box(-1, 1, shape=(2, 3)),
                           "action_mask": m.Box(0, 1, shape=(5,))}),
    lambda m: m.DictSpace({"a": m.Box(0, 1, shape=(7,))}),
])
def test_get_flattened_obs_size_matches_jax(space):
    port = port_spaces.get_flattened_obs_size(space(port_spaces))
    assert port == jax_spaces.get_flattened_obs_size(space(jax_spaces))
    with pytest.raises(NotImplementedError):
        port_spaces.get_flattened_obs_size(port_spaces.Discrete(3))
