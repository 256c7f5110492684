"""The port's C++ batched steppers (``warpdrive_tpu_torch/native``), after
``tests/test_native_backend.py``: in lockstep with the port's per-env
Python loop over the numpy reference envs, across episodes and their
done-driven resets (TagGridWorld bit for bit; the float envs, whose sin/cos
differ from numpy's float32 loops by an ulp, within 2e-4 relative and 1e-5
absolute), and bit for bit with the JAX package's native library on the same
inputs (both built with the same flags on this host); with a reset pool
too, where the C++ path draws the loop's rows.  Also the snapshot's
isolation, ``native="auto"``'s fallback, ``native=True``'s refusal and the
build location."""

import numpy as np
import pytest
import torch

from warpdrive_tpu.envs.cpu_engine import CpuEnvEngine as JaxCpuEnvEngine
from warpdrive_tpu_torch import native
from warpdrive_tpu_torch.envs.classic_control.acrobot import (
    ClassicControlAcrobotEnv,
)
from warpdrive_tpu_torch.envs.classic_control.cartpole import (
    ClassicControlCartPoleEnv,
)
from warpdrive_tpu_torch.envs.classic_control.continuous_mountain_car import (
    ClassicControlContinuousMountainCarEnv,
)
from warpdrive_tpu_torch.envs.classic_control.mountain_car import (
    ClassicControlMountainCarEnv,
)
from warpdrive_tpu_torch.envs.classic_control.pendulum import (
    ClassicControlPendulumEnv,
)
from warpdrive_tpu_torch.envs.cpu_engine import CpuEnvEngine
from warpdrive_tpu_torch.envs.dummy_env import DummyEnv
from warpdrive_tpu_torch.envs.tag_continuous import TagContinuous
from warpdrive_tpu_torch.envs.tag_gridworld import TagGridWorld
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.spaces import Discrete, MultiDiscrete

_OBS = Constants.OBSERVATIONS
_REWARDS = Constants.REWARDS
_DONE = Constants.DONE

# (label, env class, kwargs, num_envs, steps, bit for bit)
CASES = [
    ("tag_gridworld", TagGridWorld,
     dict(num_taggers=4, grid_length=6, episode_length=40, seed=11), 8, 100,
     True),
    ("tag_gridworld_partial", TagGridWorld,
     dict(num_taggers=3, grid_length=5, episode_length=30, seed=5,
          use_full_observation=False), 6, 80, True),
    ("cartpole", ClassicControlCartPoleEnv,
     dict(episode_length=60, seed=3), 8, 150, False),
    ("pendulum", ClassicControlPendulumEnv,
     dict(episode_length=50, seed=7), 8, 120, False),
    ("mountain_car", ClassicControlMountainCarEnv,
     dict(episode_length=60, seed=9), 8, 150, False),
    ("continuous_mountain_car", ClassicControlContinuousMountainCarEnv,
     dict(episode_length=60, seed=13), 8, 150, False),
    # chaotic two links: short episodes reset ulp differences
    ("acrobot", ClassicControlAcrobotEnv,
     dict(episode_length=40, seed=17), 6, 100, False),
    ("tag_continuous_full_obs", TagContinuous,
     dict(num_taggers=3, num_runners=7, grid_length=8.0, episode_length=40,
          seed=21, tagging_distance=0.05), 6, 100, False),
    ("tag_continuous_knn_obs", TagContinuous,
     dict(num_taggers=3, num_runners=7, grid_length=8.0, episode_length=40,
          seed=23, tagging_distance=0.05, use_full_observation=False,
          num_other_agents_observed=4), 6, 100, False),
]


def _draw_fn(engine, rng):
    E, N, C = engine.n_envs, engine.n_agents, engine.num_action_types
    space = engine.action_space[engine._agent_ids[0]]
    if isinstance(space, Discrete):
        return lambda: rng.integers(0, space.n, (E, N, C)).astype(np.int32)
    if isinstance(space, MultiDiscrete):
        return lambda: np.stack([rng.integers(0, int(n), (E, N))
                                 for n in space.nvec], -1).astype(np.int32)
    lo = float(np.asarray(space.low).reshape(-1)[0])
    hi = float(np.asarray(space.high).reshape(-1)[0])
    # beyond the bounds on purpose: the steppers clip
    return lambda: rng.uniform(lo * 1.2, hi * 1.2, (E, N, C)).astype(
        np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_alike(a, b, exact, what):
    if exact:
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=what)
    else:
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=1e-5,
                                   err_msg=what)


# with a reset pool every reset draws a row: the C++ path starts from the
# envs' first reset, as the loop does, and stays on the loop's draws
POOL_CASES = [
    ("cartpole_pool", ClassicControlCartPoleEnv,
     dict(episode_length=60, reset_pool_size=50, seed=3), 8, 150, False),
    ("mountain_car_pool", ClassicControlMountainCarEnv,
     dict(episode_length=40, reset_pool_size=30, seed=9), 6, 100, False),
]


@pytest.mark.parametrize("label,env_cls,kwargs,num_envs,steps,exact",
                         CASES + POOL_CASES,
                         ids=[c[0] for c in CASES + POOL_CASES])
def test_native_steps_as_the_python_loop(label, env_cls, kwargs, num_envs,
                                         steps, exact):
    loop = CpuEnvEngine(env_obj=env_cls(**kwargs), num_envs=num_envs,
                        native=False, device="cpu")
    fast = CpuEnvEngine(env_obj=env_cls(**kwargs), num_envs=num_envs,
                        native=True, device="cpu")
    assert loop._native is None and fast._native is not None
    _assert_alike(loop.reset_all_envs(), fast.reset_all_envs(), True, "reset")
    draw = _draw_fn(loop, np.random.default_rng(len(label)))
    resets = 0
    for t in range(steps):
        actions = draw()
        a, b = loop.step_all_envs(actions), fast.step_all_envs(actions)
        _assert_alike(a[_OBS], b[_OBS], exact, f"obs at t={t}")
        _assert_alike(a[_REWARDS], b[_REWARDS], exact, f"rewards at t={t}")
        np.testing.assert_array_equal(_np(a[_DONE]), _np(b[_DONE]))
        resets += int(_np(a[_DONE]).sum())
        loop.reset_only_done_envs()
        fast.reset_only_done_envs()
        np.testing.assert_array_equal(_np(loop.state[_DONE]),
                                      _np(fast.state[_DONE]))
        _assert_alike(loop.state[_OBS], fast.state[_OBS], exact,
                      f"obs after the reset at t={t}")
    assert resets > 0, "never crossed an episode boundary"


@pytest.mark.parametrize("label,env_cls,kwargs,num_envs,steps,exact", CASES,
                         ids=[c[0] for c in CASES])
def test_native_steps_as_the_jax_native_library(label, env_cls, kwargs,
                                                num_envs, steps, exact):
    """The same C++ source and flags on one host: bit for bit with the
    JAX package's library, which steps the JAX package's numpy envs."""
    import importlib

    jax_module = importlib.import_module(env_cls.__module__.replace(
        "warpdrive_tpu_torch", "warpdrive_tpu"))
    jax_cls = getattr(jax_module, env_cls.__name__)
    jeng = JaxCpuEnvEngine(env_obj=jax_cls(**kwargs), num_envs=num_envs,
                           native=True)
    peng = CpuEnvEngine(env_obj=env_cls(**kwargs), num_envs=num_envs,
                        native=True, device="cpu")
    assert jeng._native is not None and peng._native is not None
    np.testing.assert_array_equal(jeng.reset_all_envs(),
                                  _np(peng.reset_all_envs()))
    draw = _draw_fn(peng, np.random.default_rng(7))
    for t in range(steps):
        actions = draw()
        a, b = jeng.step_all_envs(actions), peng.step_all_envs(actions)
        for key in (_OBS, _REWARDS, _DONE):
            np.testing.assert_array_equal(a[key], _np(b[key]),
                                          err_msg=f"{key} at t={t}")
        jeng.reset_only_done_envs()
        peng.reset_only_done_envs()
        np.testing.assert_array_equal(jeng.state[_OBS],
                                      _np(peng.state[_OBS]))


def test_native_snapshot_restore_isolation():
    eng = CpuEnvEngine(env_obj=TagGridWorld(num_taggers=4, grid_length=6,
                                            episode_length=40, seed=11),
                       num_envs=4, native=True, device="cpu")
    eng.reset_all_envs()
    rng = np.random.default_rng(3)
    E, N, C = eng.n_envs, eng.n_agents, eng.num_action_types
    for _ in range(5):
        eng.step_all_envs(rng.integers(0, 5, (E, N, C)).astype(np.int32))
        eng.reset_only_done_envs()
    snap = eng.snapshot_runtime_state()
    obs_before = eng.state[_OBS].clone()
    acts = rng.integers(0, 5, (E, N, C)).astype(np.int32)
    first = eng.step_all_envs(acts)[_OBS].clone()
    for _ in range(7):
        eng.step_all_envs(rng.integers(0, 5, (E, N, C)).astype(np.int32))
        eng.reset_only_done_envs()
    eng.restore_runtime_state(snap)
    assert torch.equal(eng.state[_OBS], obs_before)
    # the restored engine steps on as it did from the snapshot
    assert torch.equal(eng.step_all_envs(acts)[_OBS], first)


def test_native_auto_falls_back_and_true_refuses():
    """An env without a stepper runs the Python loop under ``"auto"``;
    ``native=True`` refuses it."""
    eng = CpuEnvEngine(env_obj=DummyEnv(num_agents=3, episode_length=4,
                                        seed=0),
                       num_envs=2, device="cpu")
    assert eng._native is None
    eng.reset_all_envs()
    out = eng.step_all_envs(np.zeros((2, 3, 1), np.int32))
    assert out[_OBS].shape[0] == 2
    with pytest.raises(ValueError, match="no native stepper"):
        CpuEnvEngine(env_obj=DummyEnv(num_agents=3, episode_length=4, seed=0),
                     num_envs=2, native=True, device="cpu")


def test_native_library_builds_into_the_build_dir_with_the_jax_flags():
    from warpdrive_tpu import native as jax_native

    path = native.library_path()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "warpdrive_tpu_torch"
    native.get_lib()
    assert path.exists()
    assert native.CXX_FLAGS == ("-O3", "-march=native", "-fopenmp",
                                "-shared", "-fPIC")
    # the same steppers: the port's source is the JAX package's, with its
    # comments pointing at the port's files
    strip = [line.split("//")[0].rstrip()
             for line in native.SRC.read_text().splitlines()]
    want = [line.split("//")[0].rstrip() for line in open(
        jax_native._SRC, encoding="utf-8").read().splitlines()]
    assert strip == want
    # the adapters match the torch env classes through their numpy bases
    from warpdrive_tpu_torch.envs.classic_control.cartpole import (
        TorchClassicControlCartPoleEnv,
    )
    assert native.adapter_for(TorchClassicControlCartPoleEnv()) is \
        native.CartPoleAdapter
