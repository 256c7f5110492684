"""
Numpy-reference vs device-engine consistency checker.

The port's counterpart of ``warpdrive_tpu/tools/consistency.py``: run N
independent numpy reference envs against one vectorized :class:`EnvEngine`
for several episodes, push IDENTICAL random actions into both, and assert
that per-step observations, rewards and done flags agree within a threshold
(relative-or-absolute, 1% by default), across done-driven auto-resets too.

Reset pools draw random rows, which the numpy side cannot predict: after a
pool reset the checker asserts that every reset replica's target array is a
row of its pool, hands the drawn rows to the numpy env's ``sync_state`` and
carries on in lockstep.

The engine runs on ``device`` (``"cuda"`` unless the caller asks for
``"cpu"``) in any placeholder mode of the JAX package's checker: shared Box
or Dict observations, separate per-policy placeholders (with the env's
``policy_map()`` when no map is given), agent-dim-first or -last.

Two checks hold one engine against another or against itself:
:func:`step_against_cpu` runs a card engine's step beside the same env's
CPU engine from the same states, and :func:`check_pool_reset` holds a
reset that drew pool rows to its pools and to the env's ``observe_fn``.
"""

from __future__ import annotations

import numpy as np
import torch

from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.spaces import Box, Discrete, MultiDiscrete

_OBS = Constants.OBSERVATIONS


def _assert_all_close(a, b, threshold_pct: float, label: str):
    """abs-or-relative closeness within ``threshold_pct`` percent."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, f"{label}: shape {a.shape} != {b.shape}"
    tol = threshold_pct / 100.0
    abs_diff = np.abs(a - b)
    ok = (abs_diff <= tol) | (abs_diff <= tol * np.abs(b))
    if not ok.all():
        idx = np.unravel_index(np.argmax(abs_diff * ~ok), a.shape)
        raise AssertionError(
            f"{label}: mismatch at {idx}: cpu={b[idx]!r} device={a[idx]!r} "
            f"(max abs diff {abs_diff.max():.6g})"
        )


def _host(tensor) -> np.ndarray:
    return tensor.detach().cpu().numpy()


def draw_actions(rng: np.random.RandomState, engine) -> dict:
    """Random actions ``{agent_id: (envs, components)}`` for every replica
    of ``engine``, each agent drawing from its own action space, in agent
    order."""
    num_envs = engine.n_envs
    out = {}
    for aid in engine._agent_ids:
        space = engine.action_space[aid]
        if isinstance(space, Discrete):
            out[aid] = rng.randint(space.n, size=(num_envs, 1)).astype(np.int32)
        elif isinstance(space, MultiDiscrete):
            cols = [rng.randint(n, size=(num_envs, 1)) for n in space.nvec]
            out[aid] = np.concatenate(cols, axis=-1).astype(np.int32)
        elif isinstance(space, Box):
            low = np.where(np.isfinite(space.low), space.low, -1.0)
            high = np.where(np.isfinite(space.high), space.high, 1.0)
            out[aid] = (
                low + rng.rand(num_envs, *space.shape) * (high - low)
            ).astype(np.float32)
        else:
            raise NotImplementedError(repr(space))
    return out


def pack_actions(draws: dict, engine):
    """Per-agent draws as the engine's step takes them: one ``(envs,
    agents, components)`` tensor, or in the separate mode ``{tag: (envs,
    A_p, components)}``."""
    if engine.separate_placeholders:
        return {tag: torch.from_numpy(np.stack(
                    [draws[int(aid)] for aid in ids], axis=1))
                for tag, ids in engine._policy_ids.items()}
    return torch.from_numpy(
        np.stack([draws[aid] for aid in engine._agent_ids], axis=1))


def _to(actions, device):
    if isinstance(actions, dict):
        return {tag: a.to(device) for tag, a in actions.items()}
    return actions.to(device)


def step_against_cpu(engine, cpu_engine, steps: int = 60,
                     seed: int = 5) -> dict:
    """``engine.step`` on its device against ``cpu_engine.step`` (the same
    env on the CPU) from the same states, along ``engine``'s own rollout of
    ``steps`` steps with numpy-drawn actions and done-driven resets.
    Integer arrays must be equal; returns the largest absolute difference
    of each float array over the steps."""
    rng = np.random.RandomState(seed)
    state = dict(engine.state)
    worst = {}
    for t in range(steps):
        actions = pack_actions(draw_actions(rng, engine), engine)
        host = {name: value.cpu() for name, value in state.items()}
        out = engine.step(state, _to(actions, engine.device))
        ref = cpu_engine.step(host, _to(actions, "cpu"))
        for name, value in ref.items():
            got = out[name].cpu()
            assert got.dtype == value.dtype, f"{name} dtype at t={t}"
            if value.is_floating_point():
                worst[name] = max(worst.get(name, 0.0),
                                  float((got - value).abs().max()))
            else:
                assert torch.equal(got, value), f"{name} differs at t={t}"
        state = engine.auto_reset(out, engine.store.generator)
    return worst


def check_pool_reset(engine, state: dict, done=None) -> int:
    """Reset the envs of ``state`` flagged in ``done`` ((envs,) bool; all
    of them, a forced reset, when None) through ``engine.auto_reset`` on
    its device, and assert that each reset env's pool targets are rows of
    their pools and its observations are ``observe_fn`` of the reset
    state, bit for bit, while the other envs keep theirs.  Returns the
    number of envs reset."""
    assert engine.store.pools, "the engine has no reset pool"
    state = dict(state)
    if done is None:
        new_state = engine.auto_reset(state, engine.store.generator,
                                      force=True)
        done = torch.ones_like(state[Constants.DONE], dtype=torch.bool)
    else:
        state[Constants.DONE] = done.to(torch.int32)
        new_state = engine.auto_reset(state, engine.store.generator)
    fresh = engine.env.observe_fn(dict(new_state))
    obs, old = new_state[_OBS], state[_OBS]
    assert torch.equal(obs[done], fresh[done]), \
        "reset envs' observations are not observe_fn of their reset state"
    assert torch.equal(obs[~done], old[~done]), \
        "observations of envs that were not reset changed"
    for target, pool in engine.store.pools.items():
        rows = new_state[target][done].reshape(int(done.sum()), -1)
        member = (rows[:, None, :] == pool.reshape(pool.shape[0], -1)[None])
        assert bool(member.all(dim=2).any(dim=1).all()), \
            f"a reset env's {target!r} is not a row of its pool"
        assert torch.equal(new_state[target][~done], state[target][~done])
    assert int(new_state[Constants.TIMESTEP][done].abs().sum()) == 0
    return int(done.sum())


class EnvironmentCPUvsDevice:
    """
    Lockstep numpy-reference vs device-engine runner.

    :param cpu_env_class: numpy reference env class (gym-style dict API).
    :param device_env_class: the port's env class (batched step functions).
    :param env_configs: dict scenario-name -> env kwargs.
    :param num_envs: replicas to run (each numpy env is its own object).
    :param num_episodes: episodes to run; >= 2 exercises auto-reset.
    :param device: where the engine runs.
    :param policy_tag_to_agent_id_map,
        create_separate_placeholders_for_each_policy,
        obs_dim_corresponding_to_num_agents: the engine's placeholder
        modes; the separate mode takes the env's ``policy_map()`` when no
        map is given.
    """

    def __init__(
        self,
        cpu_env_class,
        device_env_class,
        env_configs: dict,
        num_envs: int = 3,
        num_episodes: int = 2,
        device="cuda",
        policy_tag_to_agent_id_map: dict = None,
        create_separate_placeholders_for_each_policy: bool = False,
        obs_dim_corresponding_to_num_agents: str = "first",
    ):
        self.cpu_env_class = cpu_env_class
        self.device_env_class = device_env_class
        self.env_configs = env_configs
        self.num_envs = num_envs
        self.num_episodes = num_episodes
        self.device = device
        self.policy_tag_to_agent_id_map = policy_tag_to_agent_id_map
        self.separate = bool(create_separate_placeholders_for_each_policy)
        self.obs_dim_corresponding_to_num_agents = (
            obs_dim_corresponding_to_num_agents)

    # ------------------------------------------------------------------ run
    def test_env_reset_and_step(self, threshold_pct: float = 1.0, seed: int = 17):
        for scenario, config in self.env_configs.items():
            self._run_scenario(scenario, config, threshold_pct, seed)

    def _run_scenario(self, scenario, config, threshold_pct, seed):
        rng = np.random.RandomState(seed)
        cpu_envs = [self.cpu_env_class(**config) for _ in range(self.num_envs)]
        device_env = self.device_env_class(**config)
        policy_map = self.policy_tag_to_agent_id_map
        if policy_map is None and self.separate:
            policy_map = device_env.policy_map()
        engine = EnvEngine(
            env_obj=device_env,
            num_envs=self.num_envs,
            seed=seed,
            device=self.device,
            policy_tag_to_agent_id_map=policy_map,
            create_separate_placeholders_for_each_policy=self.separate,
            obs_dim_corresponding_to_num_agents=(
                self.obs_dim_corresponding_to_num_agents),
        )
        agent_ids = engine._agent_ids

        engine.reset_all_envs()
        obs_cpu = [e.reset() for e in cpu_envs]
        self._compare_all_obs(engine, obs_cpu, threshold_pct,
                              f"{scenario}: obs at reset")

        for t in range(self.num_episodes * engine.episode_length):
            draws = draw_actions(rng, engine)

            cpu_obs_list, cpu_rew_list, cpu_done_list = [], [], []
            for env_id, env in enumerate(cpu_envs):
                act_dict = {}
                for aid in agent_ids:
                    a = draws[aid][env_id]
                    space = engine.action_space[aid]
                    act_dict[aid] = a[0] if isinstance(space, Discrete) else a
                obs, rew, done, _ = env.step(act_dict)
                cpu_obs_list.append(obs)
                cpu_rew_list.append(rew)
                cpu_done_list.append(bool(done["__all__"]))

            engine.step_all_envs(pack_actions(draws, engine))
            done_dev = _host(engine.state[Constants.DONE]) > 0

            self._compare_all_obs(engine, cpu_obs_list, threshold_pct,
                                  f"{scenario}: obs at t={t}")
            rew_cpu = np.stack([
                np.array([r[aid] for aid in agent_ids], dtype=np.float32)
                for r in cpu_rew_list
            ])
            _assert_all_close(_host(engine.rewards_of(engine.state)), rew_cpu,
                              threshold_pct, f"{scenario}: rewards at t={t}")
            assert (np.asarray(cpu_done_list) == done_dev).all(), (
                f"{scenario}: done flags diverge at t={t}: "
                f"cpu={cpu_done_list} device={done_dev.tolist()}"
            )

            if not done_dev.any():
                continue
            engine.reset_only_done_envs()
            reset_ids = np.nonzero(done_dev)[0].tolist()
            if engine.store.pools:
                for env_id in reset_ids:
                    cpu_envs[env_id].reset()
                    cpu_obs_list[env_id] = cpu_envs[env_id].sync_state(
                        self._pool_rows(engine, env_id, scenario))
                label = f"{scenario}: obs after pool reset at t={t}"
            else:
                # the engine restored the at-reset snapshot
                for env_id in reset_ids:
                    cpu_obs_list[env_id] = cpu_envs[env_id].reset()
                label = f"{scenario}: obs after reset at t={t}"
            self._compare_all_obs(engine, cpu_obs_list, threshold_pct, label,
                                  only_envs=reset_ids)

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _pool_rows(engine, env_id: int, scenario: str) -> dict:
        """The reset replica's pool-drawn arrays, each asserted to be a row
        of its pool."""
        arrays = {}
        for target, pool in engine.store.pools.items():
            val = _host(engine.state[target][env_id])
            pool_np = _host(pool)
            member = (
                np.isclose(pool_np, val[None], atol=1e-5)
                .reshape(pool_np.shape[0], -1)
                .all(axis=1)
            )
            assert member.any(), (
                f"{scenario}: env {env_id} post-reset {target!r} is not a "
                "row of its reset pool"
            )
            arrays[target] = val
        return arrays

    def _engine_obs_per_agent(self, engine) -> dict:
        """Host views of the engine's observation placeholders per agent:
        ``{agent_id: (envs, *feat) array | {key: (envs, *feat) array}}``."""
        last = self.obs_dim_corresponding_to_num_agents == "last"

        def agent_first(arr):  # (envs, feat, agents) -> (envs, agents, feat)
            return np.moveaxis(arr, -1, 1) if last and arr.ndim > 2 else arr

        if engine.separate_placeholders:
            groups = list(engine._policy_ids.items())
        else:
            groups = [(None, np.asarray(engine._agent_ids))]
        out = {}
        for tag, ids in groups:
            names = engine.obs_entry_names(tag)
            keys = engine.group_info(tag)["keys"]
            arrs = [agent_first(_host(engine.state[name])) for name in names]
            for k, aid in enumerate(ids):
                out[int(aid)] = (arrs[0][:, k] if not keys else
                                 {key: a[:, k] for key, a in zip(keys, arrs)})
        return out

    def _compare_all_obs(self, engine, cpu_obs_list, threshold_pct, label,
                         only_envs=None):
        per_agent = self._engine_obs_per_agent(engine)
        env_ids = (list(range(self.num_envs)) if only_envs is None
                   else only_envs)
        for aid in engine._agent_ids:
            got = per_agent[aid]
            if not isinstance(got, dict):
                cpu = np.stack([np.asarray(cpu_obs_list[e][aid])
                                for e in env_ids])
                _assert_all_close(got[env_ids], cpu, threshold_pct,
                                  f"{label} (agent {aid})")
                continue
            for key, arr in got.items():
                cpu = np.stack([np.asarray(cpu_obs_list[e][aid][key])
                                for e in env_ids])
                _assert_all_close(arr[env_ids], cpu, threshold_pct,
                                  f"{label} (agent {aid}, key {key!r})")
