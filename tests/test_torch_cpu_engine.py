"""The eager host-env facade (``warpdrive_tpu_torch/envs/cpu_engine.py``),
after ``tests/test_cpu_engine.py``: reset, step and the soft reset over the
numpy reference envs, with the outputs as tensors on the trainer's device
and the same values as the JAX package's ``CpuEnvEngine``; and the device
engine's ``env_backend``, with the deprecated ``use_cuda`` forwarded by
``utils/argument_fix.py:Argfix``, as ``tests/test_autoscaler.py`` checks
the JAX one."""

import numpy as np
import pytest
import torch

from warpdrive_tpu.envs import register_all_envs as jax_register
from warpdrive_tpu.envs.cpu_engine import CpuEnvEngine as JaxCpuEnvEngine
from warpdrive_tpu_torch.envs import register_all_envs
from warpdrive_tpu_torch.envs.cpu_engine import CpuEnvEngine
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.utils.argument_fix import Argfix
from warpdrive_tpu_torch.utils.constants import Constants

_TG = {"num_taggers": 3, "grid_length": 6, "episode_length": 4, "seed": 2}


@pytest.fixture(scope="module", autouse=True)
def _register():
    register_all_envs()
    jax_register()


@pytest.mark.parametrize("native", [False, True])
def test_cpu_engine_reset_step_softreset(native):
    eng = CpuEnvEngine(env_name="TagGridWorld", env_config=_TG, num_envs=3,
                       native=native, device="cpu")
    assert eng.is_eager and not eng.has_split_step
    obs = eng.reset_all_envs()
    assert isinstance(obs, torch.Tensor) and obs.device.type == "cpu"
    assert obs.shape[:2] == (3, eng.n_agents) and obs.dtype == torch.float32
    for _ in range(4):
        out = eng.step_all_envs(
            np.random.RandomState(0).randint(0, 5, (3, eng.n_agents, 1)))
    assert (out[Constants.DONE] > 0).all()
    assert torch.isfinite(out[Constants.REWARDS]).all()
    eng.reset_only_done_envs()
    assert (eng._done == 0).all()
    assert (eng.state[Constants.DONE] == 0).all()
    assert (eng.state[Constants.TIMESTEP] == 0).all()


def test_cpu_engine_steps_as_the_jax_one():
    """Tensor actions in, the same observations, rewards and done flags
    as the JAX package's facade over its own numpy envs."""
    config = dict(_TG, episode_length=7)
    jeng = JaxCpuEnvEngine(env_name="TagGridWorld", env_config=config,
                           num_envs=4, native=False)
    peng = CpuEnvEngine(env_name="TagGridWorld", env_config=config,
                        num_envs=4, native=False, device="cpu")
    np.testing.assert_array_equal(jeng.reset_all_envs(),
                                  peng.reset_all_envs().numpy())
    rng = np.random.default_rng(1)
    for t in range(20):
        actions = rng.integers(0, 5, (4, peng.n_agents)).astype(np.int32)
        want = jeng.step_all_envs(actions)
        got = peng.step_all_envs(torch.from_numpy(actions))
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), want[key],
                                          err_msg=f"{key} at t={t}")
        jeng.reset_only_done_envs()
        peng.reset_only_done_envs()
        for key in (Constants.OBSERVATIONS, Constants.DONE,
                    Constants.TIMESTEP):
            np.testing.assert_array_equal(peng.state[key].numpy(),
                                          jeng.state[key])


def test_cpu_engine_spaces_and_group_metadata():
    eng = CpuEnvEngine(env_name="ClassicControlPendulumEnv",
                       env_config={"episode_length": 5, "seed": 1},
                       num_envs=2, device="cpu")
    assert eng.group_info() == {"mode": "box", "keys": [],
                                "action": (1, np.float32)}
    assert eng.obs_entry_names() == [Constants.OBSERVATIONS]
    assert eng.num_action_types == 1
    assert tuple(eng.observation_space[0].shape) == (3,)
    assert eng.rewards_of(eng.state) is eng.state[Constants.REWARDS]


def test_cpu_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        CpuEnvEngine(env_name="TagGridWorld", env_config=_TG, num_envs=2)


def test_argfix_forwards_deprecated_kwarg():
    @Argfix(old_name="use_cuda", new_name="env_backend")
    def f(env_backend="cpu"):
        return env_backend

    with pytest.warns(DeprecationWarning):
        assert f(use_cuda="torch") == "torch"
    assert f(env_backend="x") == "x"
    with pytest.warns(DeprecationWarning):  # the new name wins
        assert f(use_cuda="a", env_backend="b") == "b"


def test_engine_env_backend_and_use_cuda():
    kwargs = dict(env_name="TagGridWorld", env_config=_TG, num_envs=2,
                  device="cpu")
    assert EnvEngine(**kwargs).env_backend == "torch"
    assert EnvEngine(env_backend="torch", **kwargs).env_backend == "torch"
    with pytest.warns(DeprecationWarning):
        assert EnvEngine(use_cuda=True, **kwargs).env_backend == "torch"
    for backend in ("cpu", "tpu"):
        with pytest.raises(ValueError, match="CpuEnvEngine"):
            EnvEngine(env_backend=backend, **kwargs)
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match="CpuEnvEngine"):
        EnvEngine(use_cuda=False, **kwargs)
