"""The port's flax-format codec (``warpdrive_tpu_torch/utils/flax_msgpack.py``)
against flax itself: every checkpoint under ``artifacts/`` decodes to
``flax.serialization.msgpack_restore``'s tree, a params tree encodes byte
for byte as ``flax.serialization.to_bytes`` writes it, every dtype the port
writes round-trips (and reads back in flax), and a chunked array, written by
flax at a lowered chunk size, decodes."""

import pathlib

import flax.serialization as serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpdrive_tpu.models.fully_connected import FullyConnected as JaxFC
from warpdrive_tpu_torch.models.fully_connected import (
    FullyConnected,
    FullyConnectedActionValueCritic,
    FullyConnectedActor,
    params_from_flax,
    params_to_flax,
)
from warpdrive_tpu_torch.utils import flax_msgpack

_REPO = pathlib.Path(__file__).resolve().parent.parent
_CHECKPOINTS = sorted((_REPO / "artifacts").rglob("*.state_dict"))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_artifacts_exist():
    assert len(_CHECKPOINTS) >= 10


@pytest.mark.parametrize("path", _CHECKPOINTS,
                         ids=lambda p: str(p.relative_to(_REPO)))
def test_every_artifact_decodes_to_flax_tree(path):
    data = path.read_bytes()
    assert flax_msgpack.is_msgpack_map(data[:2])
    want = serialization.msgpack_restore(data)
    got = flax_msgpack.decode(data)
    assert [k for k, _ in _leaves(got)] == [k for k, _ in _leaves(want)]
    for (key, a), (_, b) in zip(_leaves(want), _leaves(got)):
        assert isinstance(b, np.ndarray), key
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=str(key))
    # and back, byte for byte
    assert flax_msgpack.encode(got) == data


@pytest.mark.parametrize("fc_dims,heads", [((8, 8), (3, 2)), ((64,), (5,)),
                                           ((32, 16, 8), (21, 21))])
def test_params_tree_encodes_byte_for_byte_as_flax(fc_dims, heads):
    """A port model's parameters through ``params_to_flax`` come in the key
    order of flax's own ``init`` tree and encode to the very bytes
    ``flax.serialization.to_bytes`` writes for them."""
    gen = torch.Generator().manual_seed(7)
    model = FullyConnected(6, fc_dims, heads, generator=gen)
    tree = params_to_flax(model.state_dict())
    jax_params = JaxFC(fc_dims=fc_dims, output_dims=heads).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 6)))
    assert list(tree["params"]) == list(jax_params["params"])
    for name, leaf in jax_params["params"].items():
        assert list(tree["params"][name]) == list(leaf)
    # flax's init order, so the same numbers in flax's own tree write the
    # same bytes
    assert flax_msgpack.encode(tree) == serialization.to_bytes(tree)
    # and the port reads it back exactly
    back = params_from_flax(flax_msgpack.decode(flax_msgpack.encode(tree)))
    for key, value in model.state_dict().items():
        assert torch.equal(back[key], value), key


def test_ddpg_nets_encode_byte_for_byte():
    gen = torch.Generator().manual_seed(3)
    for module in (FullyConnectedActor(3, (16, 16), 1, action_scale=2.0,
                                       generator=gen),
                   FullyConnectedActionValueCritic(4, (16,), generator=gen)):
        tree = params_to_flax(module.state_dict())
        assert flax_msgpack.encode(tree) == serialization.to_bytes(tree)


_DTYPE_CASES = [np.float32, np.float64, np.float16, np.int32, np.int64,
                np.int8, np.uint8, np.uint32, np.bool_]


@pytest.mark.parametrize("dtype", _DTYPE_CASES, ids=lambda d: d.__name__)
def test_every_numpy_dtype_round_trips_and_matches_flax(dtype):
    rng = np.random.default_rng(0)
    arrays = {
        "matrix": (rng.standard_normal((3, 5)) * 50).astype(dtype),
        "scalar_array": np.asarray(rng.standard_normal() * 9).astype(dtype),
        "empty": np.zeros((0, 4), dtype),
        "numpy_scalar": dtype(1),
    }
    data = flax_msgpack.encode(arrays)
    # in place: flax's copy would sort the keys, which to_bytes keeps
    assert data == serialization.msgpack_serialize(dict(arrays),
                                                   in_place=True)
    back = flax_msgpack.decode(data)
    want = serialization.msgpack_restore(data)
    for key, value in arrays.items():
        assert np.asarray(back[key]).dtype == np.asarray(value).dtype
        np.testing.assert_array_equal(back[key], value)
        np.testing.assert_array_equal(back[key], want[key])


def test_bfloat16_round_trips_through_torch_and_flax():
    """numpy has no bfloat16: the codec writes a torch bf16 tensor under
    the name ``bfloat16`` and reads it back as one; flax reads the same
    bytes as its bf16 array, and writes the bytes the codec reads."""
    t = torch.randn(4, 3, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    data = flax_msgpack.encode({"w": t})
    back = flax_msgpack.decode(data)["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
    flax_side = serialization.msgpack_restore(data)["w"]
    assert flax_side.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(flax_side, np.float32),
                                  t.float().numpy())
    assert serialization.to_bytes({"w": flax_side}) == data


def test_python_scalars_and_containers_match_flax():
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32,
                 -33, -128, -129, -32768, -32769, -2**31 - 1],
        "floats": [0.0, -1.5, 1e300],
        "flags": [True, False, None],
        "text": ["", "x" * 31, "y" * 32, "z" * 300],
        "blob": b"\x00" * 300,
        "nested": {str(i): i for i in range(20)},
        "complex": 1 + 2j,
    }
    data = flax_msgpack.encode(tree)
    assert data == serialization.msgpack_serialize(dict(tree), in_place=True)
    assert flax_msgpack.decode(data) == serialization.msgpack_restore(data)


def test_chunked_array_decodes(monkeypatch):
    """flax splits arrays over MAX_CHUNK_SIZE bytes into a chunked map;
    here flax writes one at a chunk size of 64 bytes, and the codec reads
    it whole -- and writes the same bytes at the same chunk size."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = np.arange(100, dtype=np.float32).reshape(4, 25)
    tree = {"params": {"big": big, "small": np.ones(3, np.float32)}}
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    back = flax_msgpack.decode(data)
    np.testing.assert_array_equal(back["params"]["big"], big)
    np.testing.assert_array_equal(back["params"]["small"], np.ones(3))
    assert flax_msgpack.encode(tree, max_chunk_size=64) == data


def test_rejects_a_truncated_file():
    data = flax_msgpack.encode({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError):
        flax_msgpack.decode(data[:-3])
    assert not flax_msgpack.is_msgpack_map(b"PK")
