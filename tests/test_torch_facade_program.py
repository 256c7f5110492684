"""The engine facade's programs (``warpdrive_tpu_torch/envs/engine.py``:
``step_all_envs``, ``reset_all_envs``, ``reset_only_done_envs``) on the
CPU, where each program calls its body directly over the whole state
pinned in place, as a card captures it:

- the flagship (the kNN path, plain on the CPU) against the JAX engine's
  facade with ``ladder`` (same selection), the same actions across two
  episodes and their resets, then a forced reset: observations and
  rewards within the oracle's 1%, done flags and the reset entries equal;
- the facade against the engine's functional step and reset over a dict
  (the eager facade it replaces) bit for bit (outputs, state and the
  store's generator; also with ``plain_calls``) on TagGridWorld with a
  reset pool (every reset row a row of its pool), CartPole with a pool,
  and AsymmetricPursuit's separate placeholders with per-policy action
  dicts;
- the facade writes the pinned state in place, returns copies, and takes
  up a state that a caller set anew.
"""

import numpy as np
import pytest
import torch

from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu.envs.tag_continuous import TpuTagContinuous
from warpdrive_tpu_torch.core.program import plain_calls, storages
from warpdrive_tpu_torch.envs import register_all_envs
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
from warpdrive_tpu_torch.presets import FLAGSHIP_ENV_KWARGS
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.env_registrar import env_registrar

_OBS, _REW, _DONE = (Constants.OBSERVATIONS, Constants.REWARDS,
                     Constants.DONE)


@pytest.fixture(scope="module", autouse=True)
def _register():
    register_all_envs()


def _assert_close_1pct(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2, err_msg=what)


def test_programmed_flagship_facade_matches_jax():
    cfg = dict(FLAGSHIP_ENV_KWARGS, episode_length=15, seed=274880)
    E = 2
    jeng = JaxEnvEngine(env_obj=TpuTagContinuous(**cfg,
                                                 knn_algorithm="ladder"),
                        num_envs=E, seed=41)
    peng = EnvEngine(env_obj=TorchTagContinuous(
        **cfg, knn_algorithm="pallas_flat_exact"), num_envs=E, seed=41,
        device="cpu")
    jeng.reset_all_envs()
    peng.reset_all_envs()
    nvec = jeng.action_space[0].nvec
    rng = np.random.RandomState(7)
    resets = 0
    for t in range(2 * 15):
        actions = np.stack([rng.randint(0, n, (E, jeng.n_agents))
                            for n in nvec], -1).astype(np.int32)
        jeng.step_all_envs(actions)
        out = peng.step_all_envs(torch.from_numpy(actions))
        for name in (_OBS, _REW):
            _assert_close_1pct(out[name].numpy(), np.asarray(jeng.state[name]),
                               f"{name} at t={t}")
        np.testing.assert_array_equal(out[_DONE].numpy(),
                                      np.asarray(jeng.state[_DONE]))
        if np.asarray(jeng.state[_DONE]).any():
            resets += 1
            jeng.reset_only_done_envs()
            peng.reset_only_done_envs()
            for name in ("loc_x", "still_in_the_game", _OBS,
                         Constants.TIMESTEP):
                np.testing.assert_array_equal(peng.state[name].numpy(),
                                              np.asarray(jeng.state[name]))
    assert resets >= 1
    obs = peng.reset_all_envs()
    jobs = jeng.reset_all_envs()
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    assert set(peng._facade_programs) == {"step", "done", "force"}


def _engine(name, env_config, num_envs, separate=False):
    env = env_registrar.get(name, backend="torch")(**env_config)
    return EnvEngine(
        env_obj=env, num_envs=num_envs, seed=0, device="cpu",
        policy_tag_to_agent_id_map=env.policy_map() if separate else None,
        create_separate_placeholders_for_each_policy=separate)


_CASES = {
    "tag_gridworld_pool": ("TagGridWorldWithResetPool",
                           {"episode_length": 6, "seed": 1,
                            "reset_pool_size": 5}, 6, False),
    "cartpole_pool": ("ClassicControlCartPoleEnv",
                      {"episode_length": 5, "seed": 1,
                       "reset_pool_size": 4}, 6, False),
    "asymmetric_pursuit": ("AsymmetricPursuit",
                           {"num_pursuers": 2, "num_evaders": 3,
                            "grid_length": 8.0, "episode_length": 5}, 4,
                           True),
}


def _actions(engine, generator):
    if engine.separate_placeholders:
        return {tag: torch.randint(0, 3, (engine.n_envs, len(ids)),
                                   generator=generator)
                for tag, ids in engine._policy_ids.items()}
    high = int(engine.action_space[0].n) if hasattr(
        engine.action_space[0], "n") else 2
    return torch.randint(0, high, (engine.n_envs, engine.n_agents),
                         generator=generator)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_facade_programs_equal_the_functional_steps(case):
    """The facade's programs against the engine's functional ``step`` and
    ``auto_reset`` over a dict (the eager facade they replace) from the
    same state and store generator: every step's outputs, the final state
    and the generator bit for bit, every reset row a row of its pool."""
    name, env_config, num_envs, separate = _CASES[case]
    engine = _engine(name, env_config, num_envs, separate)
    ref = _engine(name, env_config, num_envs, separate)
    engine.reset_all_envs()
    state = dict(ref.state)
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    for _ in range(12):
        out = engine.step_all_envs(_actions(engine, gens[0]))
        state = ref.step(state, _actions(ref, gens[1]))
        for key, value in out.items():
            assert torch.equal(value, state[key]), key
        engine.reset_only_done_envs()
        state = ref.auto_reset(state, ref.store.generator)
    engine.reset_all_envs()
    state = ref.auto_reset(state, ref.store.generator, force=True)
    assert engine.state.keys() == state.keys()
    for key, value in state.items():
        assert torch.equal(value, engine.state[key]), key
    assert torch.equal(engine.store.generator.get_state(),
                       ref.store.generator.get_state())
    for target, pool in engine.store.pools.items():
        rows = engine.state[target].reshape(num_envs, 1, -1)
        assert (rows == pool.reshape(1, pool.shape[0], -1)).all(-1).any(-1) \
            .all(), target
    with plain_calls():  # the bodies called as they are: the same again
        engine.step_all_envs(_actions(engine, gens[0]))
    state = ref.step(state, _actions(ref, gens[1]))
    for key, value in state.items():
        assert torch.equal(value, engine.state[key]), key


def test_facade_writes_the_pinned_state_and_returns_copies():
    engine = _engine("ClassicControlCartPoleEnv",
                     {"episode_length": 4, "seed": 2, "reset_pool_size": 3},
                     5)
    engine.reset_all_envs()
    out = engine.step_all_envs(torch.ones((5, 1), dtype=torch.int32))
    ptrs = storages(engine._facade_programs["step"].buffers)
    held = out[_OBS].clone()
    engine.step_all_envs(torch.zeros((5, 1), dtype=torch.int32))
    assert torch.equal(out[_OBS], held)  # a copy: the next step left it
    assert out[_OBS].data_ptr() != engine.state[_OBS].data_ptr()
    # a state set anew (as a trainer or a restore sets it) is taken up
    fresh = {k: v.clone() for k, v in engine.state.items()}
    fresh["state"] = torch.zeros_like(fresh["state"])
    engine.state = fresh
    engine.step_all_envs(torch.zeros((5, 1), dtype=torch.int32))
    assert storages(engine._facade_programs["step"].buffers) == ptrs
    for name, buf in engine._facade_programs["step"].buffers["state"].items():
        assert engine.state[name] is buf
    other = _engine("ClassicControlCartPoleEnv",
                    {"episode_length": 4, "seed": 2, "reset_pool_size": 3}, 5)
    other.reset_all_envs()
    other.state = {k: v.clone() for k, v in fresh.items()}
    other.step_all_envs(torch.zeros((5, 1), dtype=torch.int32))
    for name, value in other.state.items():
        assert torch.equal(value, engine.state[name]), name
