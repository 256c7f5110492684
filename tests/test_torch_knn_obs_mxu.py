"""The port's single-tile kNN variants ``mxu_exact`` and ``mxu`` (kernel K2's
plain versions, ``warpdrive_tpu_torch/ops/knn_obs.py``) against the JAX
package's ``_knn_obs_kernel_v3`` in interpret mode, through each side's
``observe_batch_fn`` with ``knn_algorithm="pallas_mxu[_exact]"``.  Inputs are
drawn with numpy and handed to both sides.

Tolerances: the JAX kernel selects features through bf16 hi/lo pairs
(``tests/test_knn_obs_kernel.py``'s 8e-6), the port gathers exact float32;
the selection (type, still and valid columns) and the time column must be
equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.envs.tag_continuous import TpuTagContinuous
from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
from warpdrive_tpu_torch.ops import knn_obs
from warpdrive_tpu_torch.utils.constants import Constants

FEATURE_ATOL = 8e-6


def _env_kwargs(num_agents, k, **extra):
    n_taggers = max(2, num_agents // 10)
    return dict(
        num_taggers=n_taggers,
        num_runners=num_agents - n_taggers,
        grid_length=20.0,
        episode_length=100,
        use_full_observation=False,
        num_other_agents_observed=k,
        seed=11,
        **extra,
    )


def _state(num_agents, num_envs, seed, lattice=False):
    """A mid-episode state with about 20% of agents out; ``lattice`` puts
    the agents on an integer grid, so exact distance ties are everywhere."""
    rng = np.random.RandomState(seed)
    E, N = num_envs, num_agents
    state = {
        "loc_x": rng.uniform(0, 20, (E, N)).astype(np.float32),
        "loc_y": rng.uniform(0, 20, (E, N)).astype(np.float32),
        "speed": rng.uniform(0, 1, (E, N)).astype(np.float32),
        "acceleration": rng.uniform(-0.1, 0.1, (E, N)).astype(np.float32),
        "direction": rng.uniform(0, 2 * np.pi, (E, N)).astype(np.float32),
        "still_in_the_game": (rng.uniform(size=(E, N)) > 0.2).astype(np.int32),
        Constants.TIMESTEP: rng.randint(0, 100, (E,)).astype(np.int32),
    }
    if lattice:
        side = int(np.ceil(np.sqrt(N)))
        grid = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                        -1).reshape(-1, 2)
        for e in range(E):
            cells = grid[rng.permutation(len(grid))[:N]]
            state["loc_x"][e] = cells[:, 0].astype(np.float32) * 1.5
            state["loc_y"][e] = cells[:, 1].astype(np.float32) * 1.5
    return state


def _both(algo, kwargs, state):
    """(port obs, JAX obs) of one state, as numpy."""
    penv = TorchTagContinuous(**kwargs, knn_algorithm=algo)
    jenv = TpuTagContinuous(**kwargs, knn_algorithm=algo)
    out = penv.observe_batch_fn(
        {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    ).numpy()
    ref = np.asarray(jenv.observe_batch_fn(
        {k: jnp.asarray(v) for k, v in state.items()}
    ))
    return out, ref, jenv


def _assert_same_selection(out, ref, k):
    E, N = out.shape[:2]
    slots = out[..., :-1].reshape(E, N, k, 8)
    ref_slots = ref[..., :-1].reshape(E, N, k, 8)
    np.testing.assert_array_equal(slots[..., 5:], ref_slots[..., 5:])
    np.testing.assert_array_equal(out[..., -1], ref[..., -1])
    np.testing.assert_allclose(out, ref, rtol=0, atol=FEATURE_ATOL)


@pytest.mark.parametrize("lattice", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("num_agents,k", [(15, 4), (105, 10), (110, 10),
                                          (128, 16)])
@pytest.mark.parametrize("algo", ["pallas_mxu_exact", "pallas_mxu"])
def test_mxu_variants_match_jax_v3_kernel(algo, num_agents, k, lattice):
    kwargs = _env_kwargs(num_agents, k)
    state = _state(num_agents, 4, seed=num_agents + k, lattice=lattice)
    before = dict(knn_obs.LAUNCH_COUNTS)
    out, ref, jenv = _both(algo, kwargs, state)
    assert knn_obs.LAUNCH_COUNTS == before  # CPU tensors take the plain path
    assert out.shape == (4, num_agents, 8 * k + 1) and out.dtype == np.float32
    _assert_same_selection(out, ref, k)
    if algo == "pallas_mxu_exact":
        # the exact order is the JAX env's exact reference algorithm's
        passes = np.asarray(jax.vmap(jenv.observe_fn)(
            {name: jnp.asarray(v) for name, v in state.items()}
        ))
        np.testing.assert_allclose(out, passes, rtol=1e-5, atol=1e-6)


def _near_tie_offsets():
    """Two offsets b < a from one observer whose float32 squared distances
    differ, b's being smaller, but agree once the low 7 mantissa bits are
    cleared: the packed order puts the lower index first, the exact order
    the nearer candidate."""
    f32 = np.float32
    x0 = f32(10.0)
    for a in np.arange(1.30, 1.40, 0.001, dtype=np.float32):
        xa = f32(x0 + a)
        xb = np.nextafter(xa, f32(0))
        da = (xa - x0) * (xa - x0)
        db = (xb - x0) * (xb - x0)
        ka, kb = (np.array([da, db], np.float32).view(np.int32)
                  & np.int32(~127))
        if db < da and ka == kb:
            return xa, xb
    raise AssertionError("no near-tie found")


def test_packed_order_follows_jax_on_a_near_tie():
    """Agent 1 lies a few ulps farther from observer 0 than agent 2: the
    exact variants pick 2 first, the packed ones 1 (the lower index), and
    the port follows the JAX kernel in both."""
    xa, xb = _near_tie_offsets()
    N, k = 6, 2
    kwargs = _env_kwargs(N, k)
    state = _state(N, 1, seed=1)
    state["loc_x"][0] = np.array([10.0, xa, xb, 2.0, 18.0, 2.0], np.float32)
    state["loc_y"][0] = np.array([10.0, 10.0, 10.0, 2.0, 2.0, 18.0],
                                 np.float32)
    state["still_in_the_game"][:] = 1
    nearest = {}
    for algo in ("pallas_mxu_exact", "pallas_mxu"):
        out, ref, _ = _both(algo, kwargs, state)
        _assert_same_selection(out, ref, k)
        # slot 0 of observer 0: the neighbour's x relative to the observer
        nearest[algo] = out[0, 0, 0]
    diag = np.float32(20.0 * np.sqrt(2))
    rel = lambda x: np.float32(x / diag) - np.float32(np.float32(10.0) / diag)
    assert nearest["pallas_mxu_exact"] == rel(xb)
    assert nearest["pallas_mxu"] == rel(xa)


def test_observe_fn_runs_each_variants_plain_order():
    """The per-state ``observe_fn`` runs the exact ``passes`` for every
    ``pallas_*`` name, as the JAX package's does: on the near-tie state, the
    packed names' per-state observation is the exact one, equal to JAX's."""
    xa, xb = _near_tie_offsets()
    N, k = 6, 2
    kwargs = _env_kwargs(N, k)
    state = _state(N, 1, seed=1)
    state["loc_x"][0] = np.array([10.0, xa, xb, 2.0, 18.0, 2.0], np.float32)
    state["loc_y"][0] = np.array([10.0, 10.0, 10.0, 2.0, 2.0, 18.0],
                                 np.float32)
    state["still_in_the_game"][:] = 1
    jstate = {name: jnp.asarray(v) for name, v in state.items()}
    exact = None
    for algo in ("pallas_mxu", "pallas_flat", "pallas_tiled",
                 "pallas_mxudist", "pallas_flat_mxudist", "pallas_mxu_exact"):
        env = TorchTagContinuous(**kwargs, knn_algorithm=algo)
        out = env.observe_fn(
            {name: torch.from_numpy(v.copy()) for name, v in state.items()}
        ).numpy()
        jenv = TpuTagContinuous(**kwargs, knn_algorithm=algo)
        ref = np.asarray(jax.vmap(jenv.observe_fn)(jstate))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
        exact = out if exact is None else exact
        np.testing.assert_array_equal(out, exact)
    # the batched kernel path keeps the packed order, which differs here
    batched = TorchTagContinuous(**kwargs, knn_algorithm="pallas_mxu")
    assert not np.array_equal(batched.observe_batch_fn(
        {name: torch.from_numpy(v.copy()) for name, v in state.items()}
    ).numpy(), exact)


def test_single_tile_limits_and_the_many_agent_route():
    f = torch.zeros
    for variant in ("mxu", "mxu_exact"):
        N = 129
        args = [f(2, N), f(2, N), f(2, 5, N), f(N), torch.ones(2, N), f(2)]
        with pytest.raises(ValueError, match="at most 128 agents"):
            knn_obs.knn_observation(*args, n_agents=N, k=4, variant=variant)
        N = 40
        args = [f(2, N), f(2, N), f(2, 5, N), f(N), torch.ones(2, N), f(2)]
        with pytest.raises(ValueError, match="k <= 16"):
            knn_obs.knn_observation(*args, n_agents=N, k=17, variant=variant)
        assert knn_obs.knn_observation(
            *args, n_agents=N, k=16, variant=variant).shape == (2, N, 129)
    # above 128 agents the names route to the multi-tile kernel, K5, as in
    # the JAX package (tests/test_torch_knn_obs_tiled.py holds it to JAX)
    for algo in ("pallas_mxu", "pallas_mxu_exact"):
        env = TorchTagContinuous(**_env_kwargs(200, 10), knn_algorithm=algo)
        assert env.knn_algorithm == algo.replace("mxu", "tiled")
