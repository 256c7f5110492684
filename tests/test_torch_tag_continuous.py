"""The port's TagContinuous physics and auto-reset against the JAX package:
``TorchTagContinuous.physics_fn`` vs ``jax.vmap(TpuTagContinuous.physics_fn)``
and ``warpdrive_tpu_torch.core.reset`` vs ``warpdrive_tpu.core.reset`` on the
same numpy-drawn states, actions and pool rows; ``physics_fn``'s dispatch on
the CPU (the plain version, no kernel library) and the physics kernel's
input checks, which raise before any launch on any device."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.core.reset import make_auto_reset_fn as jax_make_auto_reset
from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu.envs.tag_continuous import TpuTagContinuous
from warpdrive_tpu_torch.core.reset import make_auto_reset_fn
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
from warpdrive_tpu_torch.ops import cuda_build, tag_physics
from warpdrive_tpu_torch.presets import FLAGSHIP_ENV_KWARGS
from warpdrive_tpu_torch.utils.constants import Constants

_INT_FIELDS = ("still_in_the_game", Constants.DONE, Constants.TIMESTEP)
_FLOAT_FIELDS = ("loc_x", "loc_y", "speed", "direction", "acceleration",
                 Constants.REWARDS)


def _random_state(env, E, seed, box, t_max):
    """Agents inside ``[0, box]^2`` (a small box makes runners get tagged),
    some already out, timesteps up to ``t_max``."""
    rng = np.random.RandomState(seed)
    N = env.num_agents
    f32 = np.float32
    return {
        "loc_x": rng.uniform(0, box, (E, N)).astype(f32),
        "loc_y": rng.uniform(0, box, (E, N)).astype(f32),
        "speed": rng.uniform(0, 1, (E, N)).astype(f32),
        "acceleration": rng.uniform(-0.1, 0.1, (E, N)).astype(f32),
        "direction": rng.uniform(0, 2 * np.pi, (E, N)).astype(f32),
        "still_in_the_game": (rng.uniform(size=(E, N)) > 0.15).astype(np.int32),
        Constants.REWARDS: np.zeros((E, N), f32),
        Constants.DONE: np.zeros((E,), np.int32),
        Constants.TIMESTEP: rng.randint(t_max - 3, t_max, (E,)).astype(np.int32),
    }


@pytest.mark.parametrize(
    "box,t_max,seed",
    [(20.0, 100, 0), (0.6, 60, 1), (1.5, 500, 2), (20.0, 500, 3)],
)
def test_physics_matches_jax(box, t_max, seed):
    kwargs = dict(FLAGSHIP_ENV_KWARGS, episode_length=60, seed=seed,
                  edge_hit_penalty=-0.5, step_penalty_for_tagger=-0.01,
                  step_reward_for_runner=0.02)
    jenv = TpuTagContinuous(**kwargs, knn_algorithm="ladder")
    penv = TorchTagContinuous(**kwargs, knn_algorithm="ladder")
    E, N = 5, jenv.num_agents
    state = _random_state(jenv, E, seed, box, min(t_max, 61))
    rng = np.random.RandomState(100 + seed)
    actions = np.stack(
        [rng.randint(0, n, (E, N)) for n in jenv.action_space[0].nvec], -1
    ).astype(np.int32)

    ref = jax.vmap(jenv.physics_fn)(
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(actions)
    )
    out = penv.physics_fn(
        {k: torch.from_numpy(v.copy()) for k, v in state.items()},
        torch.from_numpy(actions),
    )
    for name in _INT_FIELDS:
        assert out[name].dtype == torch.int32, name
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]),
                                      err_msg=name)
    for name in _FLOAT_FIELDS:
        assert out[name].dtype == torch.float32, name
        # torch's and XLA's CPU cos/sin/sqrt may differ by ulps
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]),
                                   rtol=0, atol=1e-6, err_msg=name)
    if box < 1.0:  # the crowded case really tags runners
        assert (out["still_in_the_game"].numpy() < state["still_in_the_game"]).any()


def _physics_inputs(seed=0, E=3):
    kwargs = dict(FLAGSHIP_ENV_KWARGS, num_runners=12, episode_length=60,
                  seed=seed)
    env = TorchTagContinuous(**kwargs, knn_algorithm="ladder")
    state = {k: torch.from_numpy(v) for k, v in _random_state(
        env, E, seed, box=1.5, t_max=61).items()}
    rng = np.random.RandomState(seed)
    actions = torch.from_numpy(np.stack(
        [rng.randint(0, n, (E, env.num_agents))
         for n in env.action_space[0].nvec], -1).astype(np.int32))
    return env, state, actions


def test_physics_on_cpu_runs_the_plain_version_without_the_library(
        monkeypatch):
    """CPU tensors take ``physics_plain``: no kernel library is loaded and
    no launch is counted; the input is left as it was and every entry the
    step writes is a new tensor."""
    def no_library(name):
        raise AssertionError(f"loaded {name} for CPU tensors")

    monkeypatch.setattr(cuda_build, "load", no_library)
    env, state, actions = _physics_inputs()
    before = {k: v.clone() for k, v in state.items()}
    launches = dict(tag_physics.LAUNCH_COUNTS)
    out = env.physics_fn(state, actions)
    plain = env.physics_plain(state, actions)
    assert tag_physics.LAUNCH_COUNTS == launches
    assert "tag_physics" not in cuda_build._LOADED
    assert out.keys() == plain.keys() == state.keys()
    for name, value in out.items():
        assert torch.equal(value, plain[name]), name
        assert torch.equal(state[name], before[name]), name
    for name in ("loc_x", "speed", Constants.REWARDS, Constants.DONE,
                 Constants.TIMESTEP, "still_in_the_game"):
        assert out[name] is not state[name], name


@pytest.mark.parametrize("col", [0, 1])
def test_physics_on_cpu_takes_actions_as_a_torch_index(col):
    """An action indexes its table as a PyTorch index: -size is the first
    entry, size is refused (the kernel on a card does the same, its card
    tests check)."""
    env, state, actions = _physics_inputs()
    size = len((env.acceleration_actions, env.turn_actions)[col])
    wrapped = actions.clone()
    wrapped[..., col] = actions[..., col] - size
    out = env.physics_fn(state, wrapped)
    plain = env.physics_fn(state, actions)
    for name, value in out.items():
        assert torch.equal(value, plain[name]), name
    actions[0, 1, col] = size
    with pytest.raises(IndexError):
        env.physics_fn(state, actions)


def test_physics_refuses_a_device_without_a_kernel():
    env, state, actions = _physics_inputs()
    meta = {k: v.to("meta") for k, v in state.items()}
    with pytest.raises(ValueError, match="unsupported device meta"):
        env.physics_fn(meta, actions.to("meta"))


def test_tagger_slots_follow_the_tagger_ids():
    env, _, _ = _physics_inputs(seed=3)
    consts = env._consts(torch.device("cpu"))
    slot = consts["tagger_slot"]
    assert slot.dtype == torch.int32
    assert slot[consts["tagger_ids"]].tolist() == list(
        range(env.num_taggers))
    assert (slot[torch.from_numpy(env.is_runner)] == -1).all()


_BAD_PHYSICS_INPUTS = {
    "int64 actions": (lambda s, a: (s, a.long()), "actions: dtype"),
    "one action component": (lambda s, a: (s, a[..., :1].contiguous()),
                             "actions: shape"),
    "strided actions": (lambda s, a: (s, a.transpose(0, 1).contiguous()
                                      .transpose(0, 1)),
                        "actions is not contiguous"),
    "float64 loc_x": (lambda s, a: (dict(s, loc_x=s["loc_x"].double()), a),
                      "loc_x: dtype"),
    "strided speed": (lambda s, a: (dict(s, speed=s["speed"].t()
                                         .contiguous().t()), a),
                      "speed is not contiguous"),
    "float still": (lambda s, a: (dict(s, still_in_the_game=s[
        "still_in_the_game"].float()), a), "still_in_the_game: dtype"),
    "int64 timestep": (lambda s, a: (dict(s, **{
        Constants.TIMESTEP: s[Constants.TIMESTEP].long()}), a),
        f"{Constants.TIMESTEP}: dtype"),
    "a missing env": (lambda s, a: (dict(s, direction=s["direction"][1:]),
                                    a), "direction: shape"),
    "another agent count": (lambda s, a: ({k: v[:, :-1] if v.dim() == 2
                                           else v for k, v in s.items()},
                                          a), "loc_x: shape"),
}


@pytest.mark.parametrize("case", sorted(_BAD_PHYSICS_INPUTS))
def test_physics_kernel_checks_refuse_what_it_does_not_take(case):
    """The checks the card's ``physics_fn`` makes before a launch, run on
    CPU tensors: a wrong dtype, shape or a non-contiguous input raises."""
    env, state, actions = _physics_inputs()
    consts = env._consts(torch.device("cpu"))
    tag_physics.check_inputs(state, actions, consts, env.num_agents)
    make, match = _BAD_PHYSICS_INPUTS[case]
    bad_state, bad_actions = make(state, actions)
    with pytest.raises(ValueError, match=match):
        tag_physics.check_inputs(bad_state, bad_actions, consts,
                                 env.num_agents)


def _store_pair(num_envs=4):
    kwargs = dict(FLAGSHIP_ENV_KWARGS, num_runners=20, episode_length=60,
                  seed=9)
    jeng = JaxEnvEngine(env_obj=TpuTagContinuous(**kwargs, knn_algorithm="ladder"),
                        num_envs=num_envs, seed=9)
    peng = EnvEngine(env_obj=TorchTagContinuous(**kwargs, knn_algorithm="ladder"),
                     num_envs=num_envs, seed=9, device="cpu")
    return jeng, peng


def test_engine_initial_state_matches_jax():
    jeng, peng = _store_pair()
    assert set(peng.state) == set(jeng.state) - {Constants.RNG}
    for name, value in peng.state.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jeng.state[name]),
                                      err_msg=name)
    assert set(peng.store.snapshot) == set(jeng.store.snapshot)


@pytest.mark.parametrize("force", [False, True])
def test_auto_reset_matches_jax(force):
    jeng, peng = _store_pair()
    rng = np.random.RandomState(4)
    state = {}
    for name, value in peng.state.items():
        arr = value.numpy()
        if arr.dtype == np.float32:
            arr = rng.uniform(-3, 3, arr.shape).astype(np.float32)
        else:
            arr = rng.randint(0, 3, arr.shape).astype(np.int32)
        state[name] = arr
    state[Constants.DONE] = np.array([0, 1, 2, 0], np.int32)

    key = jax.random.PRNGKey(0)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    jstate[Constants.RNG] = jeng.state[Constants.RNG]
    ref = jax_make_auto_reset(jeng.store.snapshot, {})(jstate, key, force=force)
    out = peng.auto_reset(
        {k: torch.from_numpy(v.copy()) for k, v in state.items()},
        peng.store.generator, force=force,
    )
    assert set(out) == set(state)
    for name in out:
        assert out[name].dtype == peng.state[name].dtype, name
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]),
                                      err_msg=name)


@pytest.mark.parametrize("force", [False, True])
def test_pool_reset_with_injected_rows_matches_jax(force):
    """Two reset pools; the port takes the rows the JAX side drew."""
    rng = np.random.RandomState(8)
    E, N = 5, 7
    snapshot = {"speed": rng.uniform(size=(N,)).astype(np.float32)}
    pools = {
        "loc_x": rng.uniform(size=(11, N)).astype(np.float32),
        "still_in_the_game": rng.randint(0, 2, (6, N)).astype(np.int32),
    }
    state = {
        "loc_x": rng.uniform(size=(E, N)).astype(np.float32),
        "speed": rng.uniform(size=(E, N)).astype(np.float32),
        "still_in_the_game": rng.randint(0, 2, (E, N)).astype(np.int32),
        Constants.DONE: np.array([1, 0, 0, 1, 1], np.int32),
        Constants.TIMESTEP: np.arange(E, dtype=np.int32),
    }
    key = jax.random.PRNGKey(3)
    ref = jax_make_auto_reset(
        {k: jnp.asarray(v) for k, v in snapshot.items()},
        {k: jnp.asarray(v) for k, v in pools.items()},
    )({k: jnp.asarray(v) for k, v in state.items()}, key, force=force)
    # the JAX function's draws: one key per pool target, in sorted order
    keys = jax.random.split(key, len(pools))
    pool_idx = {
        target: torch.from_numpy(np.array(jax.random.randint(
            k, (E,), 0, pools[target].shape[0], dtype=jnp.int32)))
        for k, target in zip(keys, sorted(pools))
    }
    out = make_auto_reset_fn(
        {k: torch.from_numpy(v) for k, v in snapshot.items()},
        {k: torch.from_numpy(v) for k, v in pools.items()},
    )({k: torch.from_numpy(v.copy()) for k, v in state.items()},
      force=force, pool_idx=pool_idx)
    for name in out:
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]),
                                      err_msg=name)

    # without injected rows the draw comes from the generator, inside the pool
    gen = torch.Generator().manual_seed(0)
    drawn = make_auto_reset_fn({}, {k: torch.from_numpy(v)
                                    for k, v in pools.items()})(
        {k: torch.from_numpy(v.copy()) for k, v in state.items()}, gen,
        force=True,
    )
    for row in drawn["loc_x"].numpy():
        assert (pools["loc_x"] == row).all(axis=1).any()


def test_engine_rejects_unported_modes():
    """The split path keeps the shared Box placeholder, as in the JAX
    package: separate per-policy placeholders are refused for it.  The
    full-observation mode is ported and builds."""
    kwargs = dict(FLAGSHIP_ENV_KWARGS, num_runners=10, seed=1)
    env = TorchTagContinuous(**kwargs, knn_algorithm="ladder")
    policy_map = {"tagger": sorted(env.taggers), "runner": sorted(env.runners)}
    with pytest.raises(AssertionError, match="split path"):
        EnvEngine(env_obj=env, num_envs=2, device="cpu",
                  policy_tag_to_agent_id_map=policy_map,
                  create_separate_placeholders_for_each_policy=True)
    full = TorchTagContinuous(**dict(kwargs, use_full_observation=True))
    engine = EnvEngine(env_obj=full, num_envs=2, device="cpu")
    assert engine.state[Constants.OBSERVATIONS].shape == (
        2, full.num_agents, 7 * (full.num_agents - 1) + 1)
