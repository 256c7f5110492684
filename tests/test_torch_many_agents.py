"""The port's 1024-agent TagContinuous configuration (``presets.
build_many_agents``, the JAX bench's 1024-agent stage, ``bench.py:576-598``)
against the JAX package: the same configuration from seed 0, and three
engine steps in lockstep with the JAX engine from the same actions.

The JAX engine observes with ``knn_algorithm="ladder"`` (exact selection,
exact float32 features); the port with the plain versions of its kernels'
variants on the CPU.  Observations are held to 8e-6 for the exact names
(each side's physics moves positions by ulps: CUDA, torch's and XLA's
cos/sin differ) and to the swap class for ``pallas_flat_mxudist``; physics
to 1e-5."""

import numpy as np
import pytest
import torch

from test_torch_knn_obs_flat import assert_swap_class
from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu.envs.tag_continuous import TpuTagContinuous
from warpdrive_tpu.presets import FLAGSHIP_ENV_KWARGS as JAX_FLAGSHIP_KWARGS
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
from warpdrive_tpu_torch.ops import knn_obs
from warpdrive_tpu_torch.presets import (
    MANY_AGENT_ENV_KWARGS,
    build_many_agents,
)
from warpdrive_tpu_torch.utils.constants import Constants

E = 2
STEPS = 3
_JAX_KWARGS = dict(JAX_FLAGSHIP_KWARGS, num_taggers=20, num_runners=1004,
                   grid_length=60.0, seed=0)
_FLOAT_FIELDS = ("loc_x", "loc_y", "speed", "direction", "acceleration",
                 Constants.REWARDS)
_INT_FIELDS = ("still_in_the_game", Constants.DONE, Constants.TIMESTEP)


def test_configuration_matches_the_jax_bench_stage():
    penv = TorchTagContinuous(**MANY_AGENT_ENV_KWARGS, seed=0,
                              knn_algorithm="pallas_flat_exact")
    jenv = TpuTagContinuous(**_JAX_KWARGS, knn_algorithm="pallas_flat_exact")
    assert penv.num_agents == jenv.num_agents == 1024
    assert penv.num_other_agents_observed == 10
    assert penv.episode_length == 500
    np.testing.assert_array_equal(np.where(penv.is_tagger)[0],
                                  np.where(jenv.is_tagger)[0])
    np.testing.assert_array_equal(penv.starting_location_x,
                                  jenv.starting_location_x)
    np.testing.assert_array_equal(penv.starting_directions,
                                  jenv.starting_directions)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine's three steps: the actions and the states after each."""
    jeng = JaxEnvEngine(
        env_obj=TpuTagContinuous(**_JAX_KWARGS, knn_algorithm="ladder",
                                 knn_select="fused"),
        num_envs=E, seed=0,
    )
    jeng.reset_all_envs()
    rng = np.random.RandomState(17)
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


@pytest.mark.parametrize("algo", ["pallas_flat_exact", "pallas_tiled_exact",
                                  "pallas_flat_mxudist"])
def test_three_steps_in_lockstep_with_the_jax_engine(jax_run, algo):
    actions, states = jax_run
    system = build_many_agents(num_envs=E, seed=0, knn_algorithm=algo,
                               device="cpu")
    peng = system["engine"]
    assert isinstance(peng, EnvEngine)
    peng.reset_all_envs()
    obs_name = Constants.OBSERVATIONS
    before = dict(knn_obs.LAUNCH_COUNTS)
    for t, (act, ref) in enumerate(zip(actions, states)):
        out = peng.step_all_envs(torch.from_numpy(act))
        obs, ref_obs = out[obs_name].numpy(), ref[obs_name]
        assert obs.shape == (E, 1024, 81)
        if algo == "pallas_flat_mxudist":
            assert_swap_class(obs, ref_obs)
        else:
            np.testing.assert_allclose(obs, ref_obs, rtol=0, atol=8e-6,
                                       err_msg=f"obs at t={t}")
        for name in _FLOAT_FIELDS:
            np.testing.assert_allclose(peng.state[name].numpy(), ref[name],
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{name} at t={t}")
        for name in _INT_FIELDS:
            np.testing.assert_array_equal(peng.state[name].numpy(), ref[name],
                                          err_msg=f"{name} at t={t}")
    assert knn_obs.LAUNCH_COUNTS == before  # CPU tensors take the plain path


def test_build_many_agents_runs_env_only_steps_on_cpu():
    system = build_many_agents(num_envs=2, knn_algorithm="pallas_tiled_exact",
                               device="cpu")
    assert system["num_agents"] == 1024
    gen = torch.Generator().manual_seed(0)
    state, checksum = system["state"], torch.zeros(())
    for _ in range(2):
        state, checksum = system["env_only_step"]((state, checksum), gen)
    assert torch.isfinite(checksum)
    assert (state[Constants.TIMESTEP] == 2).all()
    assert state["loc_x"].shape == (2, 1024)
