"""The port's classic-control envs (``warpdrive_tpu_torch/envs/
classic_control``) against the JAX package's: each batched ``step_fn`` from
the same states and actions against JAX's vmapped per-replica ``step_fn``
and its lane-packed ``step_batch_fn``, a pool reset with the JAX draw's rows
injected, the floor modulo of the angle wraps, MountainCar's success
marker, and the port's consistency checker against the numpy reference at
the JAX tests' configs and seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.envs import register_all_envs as jax_register_all_envs
from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu.utils.env_registrar import env_registrar as jax_registrar
from warpdrive_tpu_torch.envs import register_all_envs
from warpdrive_tpu_torch.envs.classic_control import acrobot as acro
from warpdrive_tpu_torch.envs.classic_control import cartpole as cp
from warpdrive_tpu_torch.envs.classic_control import (
    continuous_mountain_car as cmc,
)
from warpdrive_tpu_torch.envs.classic_control import mountain_car as mc
from warpdrive_tpu_torch.envs.classic_control import pendulum as pend
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.tools.consistency import EnvironmentCPUvsDevice
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.env_registrar import env_registrar

_OBS = Constants.OBSERVATIONS

# Float outputs agree within 1e-6 + 1e-6 x |value| (at most 9.5e-7 measured
# over these runs, Pendulum's velocity and reward): CPU sin/cos of XLA and
# of PyTorch differ by an ulp, and compiled XLA multiplies by a constant's
# reciprocal where PyTorch divides (CartPole's ``/ TOTAL_MASS``).  Acrobot's
# RK4 carries those ulps through four ODE evaluations whose terms grow with
# the squared velocities (up to 28 rad/s here): within 1e-5 absolute (at
# most 6.7e-6 measured).  Integer outputs (done flags, timesteps) are equal.
TOLERANCE = {"ClassicControlAcrobotEnv": dict(rtol=0.0, atol=1e-5)}
DEFAULT_TOLERANCE = dict(rtol=1e-6, atol=1e-6)

# env name, number of discrete actions (None: a Box torque in [-2.5, 2.5],
# beyond the clip), the initial state's scale per component
ENVS = [
    ("ClassicControlCartPoleEnv", 2, [2.5, 3.0, 0.3, 3.0]),
    ("ClassicControlMountainCarEnv", 3, [1.2, 0.07]),
    ("ClassicControlAcrobotEnv", 3, [3.5, 3.5, 12.0, 28.0]),
    ("ClassicControlPendulumEnv", None, [4.0, 8.0]),
    ("ClassicControlContinuousMountainCarEnv", None, [1.2, 0.07]),
]


@pytest.fixture(scope="module", autouse=True)
def _register():
    jax_register_all_envs()
    register_all_envs()


def _actions(rng, n, E):
    if n is None:
        return rng.uniform(-2.5, 2.5, (E, 1, 1)).astype(np.float32)
    return rng.randint(0, n, (E, 1, 1)).astype(np.int32)


@pytest.mark.parametrize("form", ["step_fn", "step_batch_fn"])
@pytest.mark.parametrize("name,n_actions,scale", ENVS,
                         ids=[e[0] for e in ENVS])
def test_step_matches_jax(name, n_actions, scale, form):
    """100 steps at E = 64 from random states (wide enough to hit the
    clips, the goal and the angle wraps), with done-driven resets: each
    step of the port from the JAX state, against JAX's compiled step."""
    E = 64
    config = {"episode_length": 30, "seed": 3}
    jeng = JaxEnvEngine(env_obj=jax_registrar.get(name, "tpu")(**config),
                        num_envs=E, seed=1)
    peng = EnvEngine(env_obj=env_registrar.get(name, "torch")(**config),
                     num_envs=E, seed=1, device="cpu")
    env = jeng.env
    if form == "step_fn":
        jstep = jax.jit(lambda s: jax.vmap(env.step_fn)(dict(s)))
    else:
        jstep = jax.jit(lambda s: env.step_batch_fn(dict(s)))
    rng = np.random.RandomState(0)
    state = dict(jeng.state)
    D = state["state"].shape[-1]
    state["state"] = jnp.asarray(
        (rng.uniform(-1, 1, (E, 1, D)) * np.float32(scale)).astype(np.float32))
    state[Constants.TIMESTEP] = jnp.asarray(rng.randint(0, 30, (E,)),
                                            jnp.int32)
    done_seen = set()
    for t in range(100):
        actions = _actions(rng, n_actions, E)
        state = jeng.write_actions(state, jnp.asarray(actions))
        jout = jstep(state)
        pout = peng.step({k: torch.from_numpy(np.array(state[k]))
                          for k in peng.state})
        for key, value in pout.items():
            want = np.asarray(jout[key])
            if value.dtype == torch.float32:
                np.testing.assert_allclose(
                    value.numpy(), want, err_msg=f"{key} t={t}",
                    **TOLERANCE.get(name, DEFAULT_TOLERANCE))
            else:
                np.testing.assert_array_equal(value.numpy(), want,
                                              err_msg=f"{key} t={t}")
        done_seen.update(np.unique(np.asarray(jout[Constants.DONE])).tolist())
        state = jeng.auto_reset(jout, jax.random.PRNGKey(t))
    assert 1 in done_seen


@pytest.mark.parametrize("angle_fn", [acro._wrap, pend._angle_normalize])
def test_angle_wraps_are_floor_modulo(angle_fn):
    """``%`` on a tensor is the floor modulo of Python and numpy
    (``torch.remainder``), not ``torch.fmod``: negative angles wrap up."""
    x = np.linspace(-40.0, 40.0, 4001).astype(np.float32)
    got = angle_fn(torch.from_numpy(x), torch).numpy()
    np.testing.assert_array_equal(got, angle_fn(x, np))
    assert got.min() >= -np.pi - 1e-6 and got.max() <= np.pi + 1e-6


def test_mountain_car_marks_success_with_done_2():
    """done = 2 on reaching the goal before the episode ends, 1 at the
    episode's end even on the goal (``env_selection_weights`` reads 2)."""
    env = mc.TorchClassicControlMountainCarEnv(episode_length=10, seed=0)
    engine = EnvEngine(env_obj=env, num_envs=3, device="cpu")
    state = dict(engine.state)
    state["state"] = torch.tensor([[[0.55, 0.05]], [[0.55, 0.05]],
                                   [[-0.5, 0.0]]])
    state[Constants.TIMESTEP] = torch.tensor([3, 9, 3], dtype=torch.int32)
    out = engine.step(state, torch.full((3, 1, 1), 2, dtype=torch.int32))
    assert out[Constants.DONE].tolist() == [2, 1, 0]
    assert out[Constants.DONE].dtype == torch.int32


def test_cartpole_pool_reset_rows_and_observations_match_jax():
    """A pool reset with the JAX draw's rows injected through
    ``pool_idx``: the state rows are pool rows, the observations of the
    reset envs are ``observe_fn`` of them, and every array equals the JAX
    engine's."""
    config = {"episode_length": 10, "seed": 3, "reset_pool_size": 9}
    jeng = JaxEnvEngine(
        env_obj=jax_registrar.get("ClassicControlCartPoleEnv", "tpu")(
            **config), num_envs=6, seed=0)
    peng = EnvEngine(env_obj=cp.TorchClassicControlCartPoleEnv(**config),
                     num_envs=6, seed=0, device="cpu")
    pool = peng.store.pools["state"]
    np.testing.assert_array_equal(pool.numpy(),
                                  np.asarray(jeng.store.pools["state"]))
    assert "state" not in peng.store.snapshot

    actions = jnp.asarray(np.ones((6, 1, 1), np.int32))
    jout = jeng.step(dict(jeng.state), actions)
    done = np.array([0, 1, 1, 0, 1, 0], np.int32)
    jout[Constants.DONE] = jnp.asarray(done)
    key = jax.random.PRNGKey(4)
    jreset = jeng.auto_reset(jout, key)
    idx = jax.random.randint(jax.random.split(key, 1)[0], (6,), 0, 9,
                             dtype=jnp.int32)
    pout = {k: torch.from_numpy(np.array(jout[k])) for k in peng.state}
    preset = peng.auto_reset(pout, pool_idx={
        "state": torch.from_numpy(np.array(idx))})
    for name, value in preset.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jreset[name]),
                                      err_msg=name)
    fresh = peng.env.observe_fn(preset)
    for e in np.nonzero(done)[0]:
        np.testing.assert_array_equal(preset["state"][e].numpy(),
                                      pool[int(idx[e])].numpy())
        np.testing.assert_array_equal(preset[_OBS][e].numpy(),
                                      fresh[e].numpy())
    # without the refresh the snapshot's observation would be served
    assert not torch.equal(preset[_OBS][1], peng.store.snapshot[_OBS])


CASES = [
    ("mountain_car", mc.ClassicControlMountainCarEnv,
     mc.TorchClassicControlMountainCarEnv),
    ("continuous_mountain_car", cmc.ClassicControlContinuousMountainCarEnv,
     cmc.TorchClassicControlContinuousMountainCarEnv),
    ("pendulum", pend.ClassicControlPendulumEnv,
     pend.TorchClassicControlPendulumEnv),
    ("acrobot", acro.ClassicControlAcrobotEnv,
     acro.TorchClassicControlAcrobotEnv),
]


@pytest.mark.parametrize("name,cpu_cls,dev_cls", CASES,
                         ids=[c[0] for c in CASES])
def test_classic_control_consistency(name, cpu_cls, dev_cls):
    EnvironmentCPUvsDevice(
        cpu_cls, dev_cls, {name: {"episode_length": 100, "seed": 9}},
        num_envs=3, num_episodes=2, device="cpu",
    ).test_env_reset_and_step(threshold_pct=1.0, seed=23)


def test_cartpole_consistency():
    EnvironmentCPUvsDevice(
        cp.ClassicControlCartPoleEnv, cp.TorchClassicControlCartPoleEnv,
        {"fixed_reset": {"episode_length": 100, "seed": 5}},
        num_envs=3, num_episodes=2, device="cpu",
    ).test_env_reset_and_step(threshold_pct=1.0, seed=17)


POOL_CASES = [
    ("cartpole", cp.ClassicControlCartPoleEnv,
     cp.TorchClassicControlCartPoleEnv,
     {"episode_length": 15, "reset_pool_size": 6, "seed": 3}),
    ("pendulum", pend.ClassicControlPendulumEnv,
     pend.TorchClassicControlPendulumEnv,
     {"episode_length": 12, "reset_pool_size": 5, "seed": 4}),
    ("acrobot", acro.ClassicControlAcrobotEnv,
     acro.TorchClassicControlAcrobotEnv,
     {"episode_length": 12, "reset_pool_size": 5, "seed": 6}),
]


@pytest.mark.parametrize("name,cpu_cls,dev_cls,config", POOL_CASES,
                         ids=[c[0] for c in POOL_CASES])
def test_pool_lockstep(name, cpu_cls, dev_cls, config):
    """Across pool resets at 0.1%: every drawn row is a row of its pool,
    and the numpy env, synced to it, stays in lockstep."""
    EnvironmentCPUvsDevice(
        cpu_cls, dev_cls, {"pool": config}, num_envs=4, num_episodes=3,
        device="cpu",
    ).test_env_reset_and_step(threshold_pct=0.1, seed=11)


def test_registrar_names_match_jax():
    for name, _, _ in ENVS:
        port_cls = env_registrar.get(name, backend="torch")
        assert port_cls.name == jax_registrar.get(name, "tpu").name == name
        assert env_registrar.get(name, backend="cpu").name == name
        assert not port_cls(episode_length=5).has_split_step
