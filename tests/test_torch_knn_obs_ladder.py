"""The port's single-tile ladder variants -- ``pallas`` (kernel K6, v2 packed),
``pallas_onehot`` (K7, v1) and ``pallas_twolevel[_exact]`` (K8, v6) --
through ``TorchTagContinuous.observe_batch_fn`` on the CPU (their plain
versions) against ``TpuTagContinuous.observe_batch_fn`` (the Pallas kernels
in interpret mode), from the same numpy-seeded states; the 7 packed index
bits of v2/v6 against v8's ``bit_length(SUBn - 1)`` on a constructed
near-tie; the TPU kernels' limits; and three flagship engine steps in
lockstep with the JAX engine.

Tolerances: selection is identical (type, valid flags and time equal);
features within 8e-6, the bar of ``tests/test_knn_obs_kernel.py``.  v1 and
v2 select features as exact float32 one-hot sums, and so equal the port's
gather bit for bit; v6 selects them through bf16 hi/lo pairs (~4e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_knn_obs import _build_state
from test_torch_knn_obs_flat import (
    _env_kwargs,
    assert_same_selection,
    near_tie_rel_x,
    near_tie_state,
)
from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu.envs.tag_continuous import TpuTagContinuous
from warpdrive_tpu.presets import FLAGSHIP_ENV_KWARGS as JAX_FLAGSHIP_KWARGS
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.envs.tag_continuous import (
    _KNN_VARIANTS,
    TorchTagContinuous,
)
from warpdrive_tpu_torch.ops import knn_obs
from warpdrive_tpu_torch.presets import FLAGSHIP_ENV_KWARGS
from warpdrive_tpu_torch.utils.constants import Constants

LADDER = ["pallas", "pallas_onehot", "pallas_twolevel",
          "pallas_twolevel_exact"]
# the names whose TPU kernel selects features as exact float32 sums
F32_SELECT = ("pallas", "pallas_onehot", "pallas_envlanes",
              "pallas_envlanes_exact")


def lattice_xy(E, N, seed):
    """``(E, N)`` float32 x and y of each env's agents on an integer
    lattice (spacing 1.5), so exact distance ties are everywhere."""
    rng = np.random.RandomState(seed)
    side = int(np.ceil(np.sqrt(N)))
    grid = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                    -1).reshape(-1, 2)
    cells = np.stack([grid[rng.permutation(len(grid))[:N]]
                      for _ in range(E)])
    return (cells[..., 0].astype(np.float32) * 1.5,
            cells[..., 1].astype(np.float32) * 1.5)


def observe_both(algo, state, k):
    """The port's and the JAX env's ``observe_batch_fn`` on ``state``."""
    N = state["loc_x"].shape[1]
    penv = TorchTagContinuous(**_env_kwargs(N, k), knn_algorithm=algo)
    jenv = TpuTagContinuous(**_env_kwargs(N, k), knn_algorithm=algo)
    before = dict(knn_obs.LAUNCH_COUNTS)
    out = penv.observe_batch_fn(
        {name: torch.from_numpy(v.copy()) for name, v in state.items()}
    ).numpy()
    assert knn_obs.LAUNCH_COUNTS == before  # CPU tensors take the plain path
    ref = np.asarray(jenv.observe_batch_fn(
        {name: jnp.asarray(v) for name, v in state.items()}))
    assert out.shape == ref.shape == (state["loc_x"].shape[0], N, 8 * k + 1)
    return out, ref


def assert_matches_jax(algo, out, ref, k):
    assert_same_selection(out, ref, k)
    if algo in F32_SELECT:
        # the max diff is 0: v1, v2 and v8 subtract the same float32 values
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "lattice"])
@pytest.mark.parametrize("N,k", [(15, 4), (105, 10), (110, 10), (128, 16)])
@pytest.mark.parametrize("algo", LADDER)
def test_ladder_names_match_jax_kernels(algo, N, k, ties):
    state = _build_state(N, 3, seed=N + k)
    if ties:
        state["loc_x"], state["loc_y"] = lattice_xy(3, N, seed=k)
    out, ref = observe_both(algo, state, k)
    assert_matches_jax(algo, out, ref, k)


@pytest.mark.parametrize("algo,bits", [
    ("pallas", 7), ("pallas_twolevel", 7), ("pallas_envlanes", 4),
    ("pallas_onehot", 0), ("pallas_twolevel_exact", 0),
    ("pallas_envlanes_exact", 0),
])
def test_packed_bits_on_a_near_tie(algo, bits):
    """At N = 15, v2 and v6 pack 7 index bits (their fixed ``_CLEAR_MASK``)
    and v8 packs ``bit_length(SUBn - 1)`` = 4.  Agent 1 lies a few ulps
    farther from observer 0 than agent 2, inside the 7-bit tie window and
    outside the 4-bit one: a 7-bit order takes agent 1 first (the lower
    index), the 4-bit and exact orders agent 2 (the nearer), and the port
    follows the JAX kernel in each."""
    state, xa, xb = near_tie_state()
    assert knn_obs.packed_bits(_KNN_VARIANTS[algo], 15) == bits
    out, ref = observe_both(algo, state, 2)
    assert_matches_jax(algo, out, ref, 2)
    assert out[0, 0, 0] == near_tie_rel_x(xa if bits == 7 else xb)


@pytest.mark.parametrize("algo", LADDER)
def test_single_tile_names_take_at_most_128_agents(algo):
    """As in the JAX package, above one 128-agent tile these names raise
    ``ValueError`` (they are not routed), from the env and from the
    wrapper on every device."""
    kwargs = _env_kwargs(129, 10)
    with pytest.raises(ValueError, match="at most 128 agents"):
        TpuTagContinuous(**kwargs, knn_algorithm=algo)
    with pytest.raises(ValueError, match="at most 128 agents"):
        TorchTagContinuous(**kwargs, knn_algorithm=algo)
    args = [torch.from_numpy(np.zeros(s, np.float32))
            for s in ((2, 129), (2, 129), (2, 5, 129), (129,), (2, 129), (2,))]
    with pytest.raises(ValueError, match="at most 128 agents"):
        knn_obs.knn_observation(*args, n_agents=129, k=10,
                                variant=_KNN_VARIANTS[algo])


@pytest.mark.parametrize("algo", ["pallas_twolevel", "pallas_twolevel_exact"])
def test_twolevel_takes_k_up_to_16(algo):
    """v6 keeps 16 slot rows (its ``k <= _VALID_ROWS`` assert); the port
    raises ``ValueError`` at k = 17, and v1/v2 have no such cap."""
    state = _build_state(40, 2, seed=1)
    torch_state = {name: torch.from_numpy(v.copy())
                   for name, v in state.items()}
    env = TorchTagContinuous(**_env_kwargs(40, 17), knn_algorithm=algo)
    with pytest.raises(ValueError, match="k <= 16"):
        env.observe_batch_fn(torch_state)
    for uncapped in ("pallas", "pallas_onehot"):
        env = TorchTagContinuous(**_env_kwargs(40, 17),
                                 knn_algorithm=uncapped)
        assert env.observe_batch_fn(torch_state).shape == (2, 40, 137)


E = 2
STEPS = 3


@pytest.fixture(scope="module")
def jax_flagship_run():
    """The JAX flagship engine's three steps with the exact ``ladder``: the
    actions and the states after each."""
    jeng = JaxEnvEngine(
        env_obj=TpuTagContinuous(**dict(JAX_FLAGSHIP_KWARGS, seed=0),
                                 knn_algorithm="ladder"),
        num_envs=E, seed=0,
    )
    jeng.reset_all_envs()
    rng = np.random.RandomState(23)
    nvec = jeng.action_space[0].nvec
    actions, states = [], []
    for _ in range(STEPS):
        act = np.stack([rng.randint(0, n, (E, jeng.n_agents)) for n in nvec],
                       -1).astype(np.int32)
        jeng.step_all_envs(act)
        actions.append(act)
        states.append({name: np.asarray(v) for name, v in jeng.state.items()
                       if name != Constants.RNG})
    return actions, states


@pytest.mark.parametrize("algo", ["pallas_onehot", "pallas_twolevel_exact",
                                  "pallas_envlanes_exact"])
def test_three_flagship_steps_in_lockstep_with_the_jax_engine(
        jax_flagship_run, algo):
    """The port's engine with an exact K7, K8 or K9 name against the JAX
    engine with ``ladder`` from the same actions: observations within
    8e-6 (each side's physics moves positions by ulps), physics within
    1e-5, integer fields equal -- well inside the oracle's 1%."""
    actions, states = jax_flagship_run
    peng = EnvEngine(
        env_obj=TorchTagContinuous(**dict(FLAGSHIP_ENV_KWARGS, seed=0),
                                   knn_algorithm=algo),
        num_envs=E, seed=0, device="cpu",
    )
    peng.reset_all_envs()
    before = dict(knn_obs.LAUNCH_COUNTS)
    for t, (act, ref) in enumerate(zip(actions, states)):
        out = peng.step_all_envs(torch.from_numpy(act))
        obs = out[Constants.OBSERVATIONS].numpy()
        assert obs.shape == (E, 105, 81)
        np.testing.assert_allclose(obs, ref[Constants.OBSERVATIONS], rtol=0,
                                   atol=8e-6, err_msg=f"obs at t={t}")
        for name in ("loc_x", "loc_y", "speed", "direction", "acceleration",
                     Constants.REWARDS):
            np.testing.assert_allclose(peng.state[name].numpy(), ref[name],
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{name} at t={t}")
        for name in ("still_in_the_game", Constants.DONE, Constants.TIMESTEP):
            np.testing.assert_array_equal(peng.state[name].numpy(), ref[name],
                                          err_msg=f"{name} at t={t}")
    assert knn_obs.LAUNCH_COUNTS == before
