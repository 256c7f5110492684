"""The port's kNN observation (``warpdrive_tpu_torch/ops/knn_obs.py``) against
the JAX package: the v9 ``flat_exact`` Pallas kernel in interpret mode and
the exact ``passes`` algorithm of ``TpuTagContinuous.observe_fn``.  Inputs
are drawn with numpy and handed to both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.envs.tag_continuous import TpuTagContinuous
from warpdrive_tpu.ops.knn_obs import knn_observation as jax_knn_observation
from warpdrive_tpu.utils.constants import Constants as JaxConstants
from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
from warpdrive_tpu_torch.ops import knn_obs
from warpdrive_tpu_torch.utils.constants import Constants

_EPS = np.float32(1e-10)


def _env_kwargs(num_agents, k, **extra):
    n_taggers = max(2, num_agents // 5)
    return dict(
        num_taggers=n_taggers,
        num_runners=num_agents - n_taggers,
        grid_length=20.0,
        episode_length=100,
        use_full_observation=False,
        num_other_agents_observed=k,
        seed=7,
        **extra,
    )


def _build_state(num_agents, num_envs, seed, grid_length=20.0):
    """Random mid-episode batched state, about 20% of agents out."""
    rng = np.random.RandomState(seed)
    E, N = num_envs, num_agents
    return {
        "loc_x": rng.uniform(0, grid_length, (E, N)).astype(np.float32),
        "loc_y": rng.uniform(0, grid_length, (E, N)).astype(np.float32),
        "speed": rng.uniform(0, 1, (E, N)).astype(np.float32),
        "acceleration": rng.uniform(-0.1, 0.1, (E, N)).astype(np.float32),
        "direction": rng.uniform(0, 2 * np.pi, (E, N)).astype(np.float32),
        "still_in_the_game": (rng.uniform(size=(E, N)) > 0.2).astype(np.int32),
        Constants.TIMESTEP: rng.randint(0, 100, (E,)).astype(np.int32),
    }


def _jax_state(state):
    return {k: jnp.asarray(v) for k, v in state.items()}


def _torch_state(state):
    return {k: torch.from_numpy(v.copy()) for k, v in state.items()}


def _jax_flat_exact(env, state):
    s = _jax_state(state)
    feats = jnp.stack(
        [
            s["loc_x"] / env.grid_diagonal,
            s["loc_y"] / env.grid_diagonal,
            s["speed"] / (env.max_speed + _EPS),
            s["acceleration"] / (env.max_speed + _EPS),
            s["direction"] / np.float32(2 * np.pi),
        ],
        axis=1,
    )
    return np.asarray(jax_knn_observation(
        s["loc_x"], s["loc_y"], feats,
        jnp.asarray(env.agent_types, dtype=jnp.float32),
        s["still_in_the_game"].astype(jnp.float32),
        (s[JaxConstants.TIMESTEP] / env.episode_length).astype(jnp.float32),
        n_agents=env.num_agents, k=env.num_other_agents_observed,
        interpret=True, variant="flat_exact",
    ))


def _port_knn(env, state):
    s = _torch_state(state)
    feats, still_f, t_norm = env._knn_inputs(s)
    return knn_obs.knn_observation(
        s["loc_x"], s["loc_y"], feats,
        torch.as_tensor(env.agent_types, dtype=torch.float32),
        still_f, t_norm, n_agents=env.num_agents,
        k=env.num_other_agents_observed,
    ).numpy()


@pytest.mark.parametrize("num_agents,k", [(15, 4), (105, 10), (200, 10)])
def test_knn_matches_jax_flat_exact_and_passes(num_agents, k):
    kwargs = _env_kwargs(num_agents, k)
    jenv = TpuTagContinuous(**kwargs, knn_algorithm="pallas_flat_exact")
    penv = TorchTagContinuous(**kwargs, knn_algorithm="pallas_flat_exact")
    state = _build_state(num_agents, 6, seed=3)

    before = dict(knn_obs.LAUNCH_COUNTS)
    out = _port_knn(penv, state)
    assert knn_obs.LAUNCH_COUNTS == before  # CPU tensors take the plain path
    assert out.shape == (6, num_agents, 8 * k + 1)
    assert out.dtype == np.float32

    # vs the Pallas kernel: JAX picks features through bf16 hi/lo pairs
    # (~4e-6 absolute); selection, type, valid and time are exact
    ref = _jax_flat_exact(jenv, state)
    np.testing.assert_allclose(out, ref, atol=8e-6)
    slots, ref_slots = out[..., :-1].reshape(6, num_agents, k, 8), \
        ref[..., :-1].reshape(6, num_agents, k, 8)
    np.testing.assert_array_equal(slots[..., 5:], ref_slots[..., 5:])
    np.testing.assert_array_equal(out[..., -1], ref[..., -1])

    # vs the exact reference algorithm of the JAX env
    passes = np.asarray(jax.vmap(jenv.observe_fn)(_jax_state(state)))
    np.testing.assert_allclose(out, passes, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("algo", ["passes", "ladder"])
def test_plain_algorithms_equal_kernel_plain_version(algo):
    """The env's plain ``passes`` / ``ladder`` observe and the kernel's plain
    version make the same selection and the same float32 values."""
    kwargs = _env_kwargs(40, 6)
    env = TorchTagContinuous(**kwargs, knn_algorithm=algo)
    state = _build_state(40, 5, seed=11)
    obs = env.observe_batch_fn(_torch_state(state)).numpy()
    np.testing.assert_array_equal(obs, _port_knn(env, state))


@pytest.mark.parametrize("lattice", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("num_agents,k", [(15, 4), (105, 10)])
@pytest.mark.parametrize("algo", ["topk", "packed", "approx"])
def test_xla_algorithms_match_jax_observe_fn(algo, num_agents, k, lattice):
    """``topk``, ``approx`` and the b-bit ``packed`` ladder of the port's
    ``observe_fn`` against the JAX env's per-state ``observe_fn`` (exact
    float32 features on both sides), on random states and on an integer
    lattice where exact distance ties are everywhere.  On the lattice,
    ``approx`` is held to JAX's ``topk``: XLA's CPU ``approx_min_k``
    returns tied candidates in no fixed order, while the TPU's, and the
    order the JAX env documents and the port keeps, is lowest index
    first."""
    kwargs = _env_kwargs(num_agents, k)
    penv = TorchTagContinuous(**kwargs, knn_algorithm=algo)
    jenv = TpuTagContinuous(
        **kwargs, knn_algorithm="topk" if algo == "approx" and lattice
        else algo)
    state = _build_state(num_agents, 4, seed=num_agents + k)
    if lattice:
        rng = np.random.RandomState(k)
        side = int(np.ceil(np.sqrt(num_agents)))
        grid = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                        -1).reshape(-1, 2)
        for e in range(4):
            cells = grid[rng.permutation(len(grid))[:num_agents]]
            state["loc_x"][e] = cells[:, 0].astype(np.float32) * 1.5
            state["loc_y"][e] = cells[:, 1].astype(np.float32) * 1.5
    out = penv.observe_fn(_torch_state(state)).numpy()
    ref = np.asarray(jax.vmap(jenv.observe_fn)(_jax_state(state)))
    slots = out[..., :-1].reshape(4, num_agents, k, 8)
    ref_slots = ref[..., :-1].reshape(4, num_agents, k, 8)
    np.testing.assert_array_equal(slots[..., 5:], ref_slots[..., 5:])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_equidistant_candidates_take_lowest_index():
    """Four agents at exactly squared distance 1 from agent 0 and one at 4:
    k=3 must pick the three lowest indices among the ties."""
    kwargs = _env_kwargs(6, 3)
    env = TorchTagContinuous(**kwargs, knn_algorithm="pallas_flat_exact")
    jenv = TpuTagContinuous(**kwargs, knn_algorithm="pallas_flat_exact")
    x = np.array([[5, 7, 6, 4, 5, 5]], dtype=np.float32)
    y = np.array([[5, 5, 5, 5, 6, 4]], dtype=np.float32)
    state = {
        "loc_x": x, "loc_y": y,
        "speed": np.zeros_like(x), "acceleration": np.zeros_like(x),
        "direction": np.zeros_like(x),
        "still_in_the_game": np.ones_like(x, dtype=np.int32),
        Constants.TIMESTEP: np.array([3], dtype=np.int32),
    }
    out = _port_knn(env, state)
    slots = out[0, 0, :-1].reshape(3, 8)
    diag = np.float32(20.0 * np.sqrt(2))
    # agent 1 is at d2 = 4; agents 2..5 tie at d2 = 1 -> slots hold 2, 3, 4
    np.testing.assert_array_equal(
        slots[:, 0], (x[0, [2, 3, 4]] / diag) - (x[0, 0] / diag)
    )
    np.testing.assert_array_equal(
        slots[:, 1], (y[0, [2, 3, 4]] / diag) - (y[0, 0] / diag)
    )
    np.testing.assert_allclose(out, _jax_flat_exact(jenv, state), atol=8e-6)
    passes = np.asarray(jax.vmap(jenv.observe_fn)(_jax_state(state)))
    np.testing.assert_array_equal(out, passes)


def test_lattice_ties_match_jax_passes():
    """Agents on an integer lattice: many exact distance ties everywhere."""
    kwargs = _env_kwargs(36, 8)
    env = TorchTagContinuous(**kwargs, knn_algorithm="pallas_flat_exact")
    jenv = TpuTagContinuous(**kwargs, knn_algorithm="passes")
    rng = np.random.RandomState(5)
    grid = np.stack(np.meshgrid(np.arange(6), np.arange(6)), -1).reshape(-1, 2)
    state = _build_state(36, 3, seed=5)
    for e in range(3):
        perm = rng.permutation(36)
        state["loc_x"][e] = grid[perm, 0].astype(np.float32) * 2
        state["loc_y"][e] = grid[perm, 1].astype(np.float32) * 2
    out = _port_knn(env, state)
    passes = np.asarray(jax.vmap(jenv.observe_fn)(_jax_state(state)))
    np.testing.assert_allclose(out, passes, rtol=1e-5, atol=1e-6)
    slots = out[..., :-1].reshape(3, 36, 8, 8)
    ref_slots = passes[..., :-1].reshape(3, 36, 8, 8)
    np.testing.assert_array_equal(slots[..., 5:], ref_slots[..., 5:])


def test_wrapper_rejects_bad_inputs_and_unported_variants():
    E, N, k = 2, 9, 3
    f = torch.zeros
    args = [f(E, N), f(E, N), f(E, 5, N), f(N), torch.ones(E, N), f(E)]
    assert knn_obs.knn_observation(*args, n_agents=N, k=k).shape == (E, N, 25)
    with pytest.raises(ValueError, match="dtype"):
        bad = list(args)
        bad[0] = bad[0].double()
        knn_obs.knn_observation(*bad, n_agents=N, k=k)
    with pytest.raises(ValueError, match="shape"):
        bad = list(args)
        bad[2] = f(E, 4, N)
        knn_obs.knn_observation(*bad, n_agents=N, k=k)
    with pytest.raises(ValueError, match="contiguous"):
        bad = list(args)
        bad[1] = f(N, E).t()
        knn_obs.knn_observation(*bad, n_agents=N, k=k)
    # every JAX variant is ported now: an unknown name is the one refused
    assert knn_obs.knn_observation(*args, n_agents=N, k=k,
                                   variant="packed").shape == (E, N, 25)
    TorchTagContinuous(**_env_kwargs(15, 4),
                       knn_algorithm="pallas_twolevel_exact")
    with pytest.raises(ValueError, match="unknown kNN variant"):
        knn_obs.knn_observation(*args, n_agents=N, k=k, variant="flat_fast")
