"""The port's v7 multi-tile variants (kernel K5: ``tiled``, ``tiled_exact``,
``tiled_mxudist``, ``tiled_mxudist_exact``), through their plain versions
on the CPU, against the JAX package's ``_v7_body`` in interpret mode; the
k <= 16 limit; the route of ``pallas_mxu[_exact]`` to the tiled kernel
above 128 agents; and the six names of kernels K6-K9, once unported.  Inputs
are drawn with numpy and handed to both sides.

Tolerances as in ``tests/test_torch_knn_obs_flat.py``: exact and packed
names select as JAX does (features within 8e-6 of its bf16 hi/lo pairs);
the MXU-distance names hold the swap class (under 2e-3 of the entries off
by more than 8e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_knn_obs_flat import (
    _jax,
    _knn_inputs,
    _port,
    assert_same_selection,
    assert_swap_class,
)
from warpdrive_tpu.envs.tag_continuous import TpuTagContinuous
from warpdrive_tpu_torch.envs.tag_continuous import (
    _KNN_VARIANTS,
    TorchTagContinuous,
)
from warpdrive_tpu_torch.ops import knn_obs
from warpdrive_tpu_torch.utils.constants import Constants

TILED = ["tiled", "tiled_exact", "tiled_mxudist", "tiled_mxudist_exact"]


@pytest.mark.parametrize("N,k,E", [(105, 10, 3), (200, 6, 3), (300, 10, 2)])
@pytest.mark.parametrize("variant", TILED)
def test_tiled_variants_match_jax_v7_kernel(variant, N, k, E):
    inputs = _knn_inputs(E, N, seed=2 * N + k)
    out = _port(inputs, k, variant)
    ref = _jax(inputs, k, variant)
    if "mxudist" in variant:
        assert_swap_class(out, ref)
    else:
        assert_same_selection(out, ref, k)


@pytest.mark.parametrize("variant", TILED)
def test_tiled_variants_take_k_up_to_16(variant):
    inputs = [torch.from_numpy(a) for a in _knn_inputs(2, 40, seed=1)]
    with pytest.raises(ValueError, match="k <= 16"):
        knn_obs.knn_observation(*inputs, n_agents=40, k=17, variant=variant)
    out = knn_obs.knn_observation(*inputs, n_agents=40, k=16, variant=variant)
    assert out.shape == (2, 40, 129)


def test_kernel_limits_refuse_what_the_card_cannot_stage():
    """36 B of shared memory per agent, 84 B with the MXU distance, against
    the card's 232,448 B a block; the flat kernels' sorted list holds 32."""
    assert knn_obs.staged_bytes("flat_exact", 1024) == 36 * 1024
    assert knn_obs.staged_bytes("tiled_mxudist", 1024) == 84 * 1024
    knn_obs.check_kernel_limits("flat_mxudist", 4960, 10)
    knn_obs.check_kernel_limits("tiled_exact", 6456, 16)
    with pytest.raises(ValueError, match="shared memory"):
        knn_obs.check_kernel_limits("flat_mxudist_exact", 4961, 10)
    with pytest.raises(ValueError, match="shared memory"):
        knn_obs.check_kernel_limits("tiled", 6457, 10)
    with pytest.raises(ValueError, match="k <= 32"):
        knn_obs.check_kernel_limits("flat", 100, 33)
    with pytest.raises(ValueError, match="k <= 16"):
        knn_obs.check_kernel_limits("tiled_mxudist", 100, 17)


def _many_agent_state(N, E, seed, box):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return {
        "loc_x": rng.uniform(0, box, (E, N)).astype(f32),
        "loc_y": rng.uniform(0, box, (E, N)).astype(f32),
        "speed": rng.uniform(0, 1, (E, N)).astype(f32),
        "acceleration": rng.uniform(-0.1, 0.1, (E, N)).astype(f32),
        "direction": rng.uniform(0, 2 * np.pi, (E, N)).astype(f32),
        "still_in_the_game": (rng.uniform(size=(E, N)) > 0.2).astype(np.int32),
        Constants.TIMESTEP: rng.randint(0, 100, (E,)).astype(np.int32),
    }


@pytest.mark.parametrize("algo,routed", [("pallas_mxu", "pallas_tiled"),
                                         ("pallas_mxu_exact",
                                          "pallas_tiled_exact")])
def test_mxu_names_route_to_the_tiled_kernel_above_128_agents(algo, routed):
    kwargs = dict(num_taggers=10, num_runners=140, grid_length=15.0,
                  episode_length=100, use_full_observation=False,
                  num_other_agents_observed=8, seed=11)
    penv = TorchTagContinuous(**kwargs, knn_algorithm=algo)
    jenv = TpuTagContinuous(**kwargs, knn_algorithm=algo)
    assert penv.knn_algorithm == jenv.knn_algorithm == routed
    state = _many_agent_state(150, 2, seed=3, box=15.0)
    out = penv.observe_batch_fn(
        {name: torch.from_numpy(v.copy()) for name, v in state.items()}
    ).numpy()
    ref = np.asarray(jenv.observe_batch_fn(
        {name: jnp.asarray(v) for name, v in state.items()}))
    assert out.shape == (2, 150, 65)
    assert_same_selection(out, ref, 8)


_KERNEL_OF_ROW = {"K6": "knn_obs_packed", "K7": "knn_obs_onehot",
                  "K8": "knn_obs_twolevel", "K9": "knn_obs_envlanes"}


@pytest.mark.parametrize("algo,row", [
    ("pallas", "K6"), ("pallas_onehot", "K7"), ("pallas_twolevel", "K8"),
    ("pallas_twolevel_exact", "K8"), ("pallas_envlanes", "K9"),
    ("pallas_envlanes_exact", "K9"),
])
def test_unported_kernels_raise_naming_their_row(algo, row):
    """The six names that raised ``NotImplementedError`` naming their
    ROADMAP queue 2 row until kernels K6-K9 were ported: each now builds,
    goes to its row's kernel, and its ``observe_batch_fn`` matches the JAX
    env's on one state."""
    kwargs = dict(num_taggers=2, num_runners=13, grid_length=20.0,
                  use_full_observation=False, num_other_agents_observed=4,
                  seed=3)  # one tagger set on both sides
    penv = TorchTagContinuous(**kwargs, knn_algorithm=algo)
    jenv = TpuTagContinuous(**kwargs, knn_algorithm=algo)
    assert knn_obs._PORTED[_KNN_VARIANTS[algo]] == _KERNEL_OF_ROW[row]
    state = _many_agent_state(15, 3, seed=5, box=20.0)
    out = penv.observe_batch_fn(
        {name: torch.from_numpy(v.copy()) for name, v in state.items()}
    ).numpy()
    ref = np.asarray(jenv.observe_batch_fn(
        {name: jnp.asarray(v) for name, v in state.items()}))
    assert out.shape == (3, 15, 33)
    assert_same_selection(out, ref, 4)
