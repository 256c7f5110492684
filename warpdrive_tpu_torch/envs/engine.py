"""
EnvEngine: the vectorized environment runtime on one device.

The port's counterpart of ``warpdrive_tpu/envs/engine.py``.  It

* builds the batched device state from the env's host-side reset and its
  DataFeeds (single-env arrays replicated across replicas) and registers
  the env's reset pools,
* creates the observation/action/reward placeholders: shared (one
  ``observations`` array, or one ``observations_<key>`` per key of a Dict
  observation) or separate per policy (``observations_<tag>[_<key>]``,
  ``sampled_actions_<tag>``, ``rewards_<tag>``), agent-dim-first or
  agent-dim-last, and names them (``group_info``, ``obs_entry_names``,
  ``reward_entry_names``),
* exposes the functions a rollout composes, each taking and returning a
  dict of batched tensors without touching its input: ``step`` (write the
  actions, then the env's whole ``step_fn``, or on the split path
  ``step_physics`` then ``observe``), ``auto_reset`` (which, given the
  static state as its ``out``, writes the new state into it instead), and
  on the split path ``step_physics`` and ``observe`` (``None`` on the
  full-step path),
* refreshes, after a reset that drew reset-pool rows, the observations of
  the reset replicas from the env's ``observe_fn`` (restoring the
  at-reset snapshot would leave them one step stale),
* offers the gym-like conveniences ``reset_all_envs``,
  ``reset_only_done_envs`` and ``step_all_envs``, which keep the engine's
  own ``state``, with the aliases ``reset`` and ``obs_at_reset``: each is
  a program over the whole state pinned in place, replayed on a card (the
  JAX engine's ``_jit_step``, ``_jit_force_reset`` and
  ``_jit_done_reset``) and called as it is on the CPU, the caller's
  actions first written into the action placeholders; each returns
  copies,
* and ``rewards_of``, the all-agent rewards a trainer records (per-policy
  rewards merged on the agent axis in the separate mode).

Under a process mesh (``parallel.mesh.apply_env_sharding``) the state holds
the rank's env rows ``env_rows`` only: ``n_envs`` stays global, the steps
run on the rank's rows, and the facade's views (``reset_all_envs``,
``step_all_envs``) gather every rank's rows, so every rank must call them.

The split path and reset pools need the shared Box placeholder, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from warpdrive_tpu_torch.core.program import Program, assign_state
from warpdrive_tpu_torch.core.reset import make_auto_reset_fn
from warpdrive_tpu_torch.core.state import StateStore
from warpdrive_tpu_torch.training.data_loader import (
    create_and_push_data_placeholders,
)
from warpdrive_tpu_torch.utils.argument_fix import Argfix
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.device import resolve_device
from warpdrive_tpu_torch.utils.env_registrar import (
    env_registrar as default_registrar,
)
from warpdrive_tpu_torch.utils.spaces import (
    Box,
    normalize_space_map,
    recursive_obs_dict_to_spaces_dict,
)

_OBS = Constants.OBSERVATIONS
_ACTIONS = Constants.ACTIONS
_REWARDS = Constants.REWARDS


def _infer_agent_space(example_obs):
    """Box for an array observation, a DictSpace for a dict one."""
    if isinstance(example_obs, dict):
        return recursive_obs_dict_to_spaces_dict(example_obs)
    return Box(-np.inf, np.inf, shape=np.asarray(example_obs).shape)


class EnvEngine:
    """Vectorized environment engine over ``num_envs`` replicas on
    ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``).

    ``env_backend`` is ``"torch"``, the port's name for the device backend
    (the JAX engine's ``"tpu"``); the deprecated boolean ``use_cuda`` is
    read as ``env_backend`` (True: this backend).  The numpy reference envs
    on the host are :class:`~warpdrive_tpu_torch.envs.cpu_engine.
    CpuEnvEngine`'s."""

    @Argfix(old_name="use_cuda", new_name="env_backend")
    def __init__(
        self,
        env_obj=None,
        env_name: str = None,
        env_config: dict = None,
        num_envs: int = 2,
        env_backend: str = "torch",
        env_registrar=None,
        seed: int = 0,
        policy_tag_to_agent_id_map: dict = None,
        create_separate_placeholders_for_each_policy: bool = False,
        obs_dim_corresponding_to_num_agents: str = "first",
        device="cuda",
    ):
        if isinstance(env_backend, bool):
            env_backend = "torch" if env_backend else "cpu"
        if env_backend != "torch":
            raise ValueError(
                f"EnvEngine runs the device backend 'torch', got "
                f"{env_backend!r}; the numpy reference envs run on the host "
                "through envs.cpu_engine.CpuEnvEngine"
            )
        self.env_backend = env_backend
        self.device = resolve_device(device)
        registrar = env_registrar or default_registrar
        if env_obj is None:
            assert env_name is not None, "pass env_obj or env_name"
            env_cls = registrar.get(env_name, backend="torch")
            env_obj = env_cls(**(env_config or {}))
        self.env = env_obj
        self.has_split_step = bool(getattr(self.env, "has_split_step", False))
        if not self.has_split_step:
            # the full-step path: the env's whole step_fn writes its own
            # observations, so there is no split pair to compose
            self.step_physics = None
            self.observe = None
        self.n_envs = int(num_envs)
        # the global env rows this process holds: all of them until
        # parallel.mesh.apply_env_sharding cuts the state
        self.mesh = None
        self.env_rows = slice(0, self.n_envs)
        self.n_agents = int(self.env.num_agents)
        self.episode_length = int(self.env.episode_length)

        # --- host-side first reset: infer spaces & initial obs -------------
        obs = self.env.reset()
        self._agent_ids = sorted(obs.keys())
        assert len(self._agent_ids) == self.n_agents
        if not isinstance(getattr(self.env, "observation_space", None), dict):
            self.env.observation_space = {
                aid: _infer_agent_space(obs[aid]) for aid in self._agent_ids
            }
        # an env may declare gym/gymnasium spaces: converted once, here
        self.action_space = normalize_space_map(self.env.action_space)
        self.observation_space = normalize_space_map(
            self.env.observation_space)

        # --- placeholder modes ----------------------------------------------
        self.separate_placeholders = bool(
            create_separate_placeholders_for_each_policy)
        self.obs_dim_corresponding_to_num_agents = (
            obs_dim_corresponding_to_num_agents)
        self._policy_ids = None
        if policy_tag_to_agent_id_map is not None:
            self._policy_ids = {
                tag: np.asarray(sorted(int(i) for i in ids), dtype=np.int32)
                for tag, ids in policy_tag_to_agent_id_map.items()
            }
            # disjoint groups, and in the separate mode every agent covered
            # (an unmapped agent would read zero rewards from rewards_of)
            all_ids = np.concatenate(list(self._policy_ids.values())).tolist()
            assert len(all_ids) == len(set(all_ids)), (
                "policy_tag_to_agent_id_map groups overlap")
            if self.separate_placeholders:
                assert set(all_ids) == set(range(self.n_agents)), (
                    "separate-placeholder mode requires the policy map to "
                    f"cover all {self.n_agents} agents; got {sorted(all_ids)}"
                )
        if self.separate_placeholders:
            assert self._policy_ids is not None, (
                "create_separate_placeholders_for_each_policy requires "
                "policy_tag_to_agent_id_map at engine construction"
            )
            self._policy_index = {
                tag: torch.as_tensor(ids, dtype=torch.long,
                                     device=self.device)
                for tag, ids in self._policy_ids.items()
            }

        # --- batched device state -------------------------------------------
        self.store = StateStore(
            num_envs=self.n_envs,
            num_agents=self.n_agents,
            episode_length=self.episode_length,
            device=self.device,
            seed=seed,
        )
        self.store.push(self.env.get_data_dictionary())
        self.store.push(self.env.get_tensor_dictionary())
        pool_feed = self.env.get_reset_pool_dictionary()
        if pool_feed:
            self.store.push(pool_feed)

        placeholder_meta = create_and_push_data_placeholders(
            self.store,
            obs,
            self.observation_space,
            self.action_space,
            policy_tag_to_agent_id_map=(
                None if self._policy_ids is None
                else {t: ids.tolist() for t, ids in self._policy_ids.items()}
            ),
            create_separate_placeholders_for_each_policy=(
                self.separate_placeholders),
            obs_dim_corresponding_to_num_agents=(
                obs_dim_corresponding_to_num_agents),
        )
        self.placeholder_groups = placeholder_meta["groups"]
        self._shared_box = (not self.separate_placeholders
                            and self.placeholder_groups[None]["mode"] == "box")
        if self.has_split_step:
            assert self._shared_box, (
                "the split path requires the shared Box observations "
                "placeholder")

        if not self.separate_placeholders:
            self._act_dtype = self.store.state[_ACTIONS].dtype
        self.auto_reset = self._make_auto_reset()
        self.state = self.store.state
        # the entries a captured program holds (pin_state): written into,
        # never rebound
        self._pinned = {}
        self._first_reset_done = False
        # the facade's programs (_facade_program) and their memory pool
        self._facade_programs = {}
        self._facade_pool = None

    # ------------------------------------------------- placeholder name maps
    def group_info(self, tag: str = None) -> dict:
        """Placeholder-group metadata ``{"mode", "keys", "action"}`` of a
        policy (separate mode) or of the shared group."""
        if self.separate_placeholders:
            assert tag is not None, "separate mode needs a policy tag"
            return self.placeholder_groups[tag]
        return self.placeholder_groups[None]

    def obs_entry_names(self, tag: str = None) -> list:
        """State names of the observation arrays: ``observations`` or
        ``observations_<key>`` (shared), ``observations_<tag>[_<key>]``
        (separate mode, ``tag`` required); Dict keys in the env's order."""
        group = self.group_info(tag)
        suffix = f"_{tag}" if self.separate_placeholders else ""
        if group["mode"] == "box":
            return [_OBS + suffix]
        return [f"{_OBS}{suffix}_{key}" for key in group["keys"]]

    def reward_entry_names(self) -> list:
        """State names of the reward arrays, policies in sorted order."""
        if self.separate_placeholders:
            return [f"{_REWARDS}_{tag}" for tag in sorted(self._policy_ids)]
        return [_REWARDS]

    def _obs_names(self) -> list:
        """Every observation array's state name, across groups."""
        if self.separate_placeholders:
            return [name for tag in sorted(self._policy_ids)
                    for name in self.obs_entry_names(tag)]
        return self.obs_entry_names()

    @property
    def local_envs(self) -> int:
        """The env rows this process holds."""
        return self.env_rows.stop - self.env_rows.start

    def rewards_of(self, state: dict) -> torch.Tensor:
        """All-agent rewards ``(envs, agents)`` of a state; the separate
        mode's per-policy arrays are scattered onto the agent axis."""
        if not self.separate_placeholders:
            return state[_REWARDS]
        out = torch.zeros((self.local_envs, self.n_agents),
                          dtype=torch.float32, device=self.device)
        for tag in sorted(self._policy_ids):
            out[:, self._policy_index[tag]] = state[f"{_REWARDS}_{tag}"]
        return out

    def _make_auto_reset(self):
        """The done-driven reset, which restores every snapshot-flagged
        array (every observation placeholder among them); with reset pools,
        followed by the observation refresh of the replicas it reset.  Its
        ``out``, the static state, takes the new state in place
        (``core/reset.py``)."""
        base_auto_reset = make_auto_reset_fn(
            self.store.snapshot, self.store.pools
        )
        if not self.store.pools:
            return base_auto_reset
        observe_fn = getattr(self.env, "observe_fn", None)
        if observe_fn is None or not self._shared_box:
            # without the refresh every pool reset would serve one step of
            # observations of the fixed snapshot beside a pool row's state
            raise NotImplementedError(
                "reset pools need the shared Box observations placeholder "
                "and the env's observe_fn, which refreshes the observations "
                "of the replicas a pool reset has reset"
            )

        def auto_reset(state: dict, generator: torch.Generator = None,
                       force: bool = False, pool_idx: dict = None,
                       out: dict = None) -> dict:
            done = state[Constants.DONE] > 0
            if force:
                done = torch.ones_like(done)
            new_state = base_auto_reset(state, generator, force=force,
                                        pool_idx=pool_idx, out=out)
            if _OBS in new_state:
                fresh = observe_fn(dict(new_state))
                mask = done.reshape(done.shape + (1,) * (fresh.ndim - 1))
                obs = new_state[_OBS]
                # into the destination's own buffer, where there is one
                new_state[_OBS] = torch.where(
                    mask, fresh.to(obs.dtype), obs,
                    **({} if out is None else {"out": obs}))
            return new_state

        return auto_reset

    # ------------------------------------------------------------ the steps
    def _with_components(self, actions) -> torch.Tensor:
        """``actions`` on the device with their component axis."""
        a = torch.as_tensor(actions, device=self.device)
        return a[..., None] if a.ndim == 2 else a

    def _as_actions(self, actions) -> torch.Tensor:
        """``(envs, agents[, components])`` all-agent actions in the shared
        placeholder's dtype."""
        a = self._with_components(actions)
        return a.to(self._act_dtype)

    def step_physics(self, state: dict, actions) -> dict:
        """Split path: dynamics, rewards and done flags of every replica
        for ``actions`` of shape ``(envs, agents[, components])``
        (``None`` on the full-step path)."""
        return self.env.physics_fn(dict(state), self._as_actions(actions))

    def observe(self, state: dict) -> torch.Tensor:
        """Split path: observations ``(envs, agents, obs_dim)`` of the
        current state (``None`` on the full-step path)."""
        return self.env.observe_batch_fn(dict(state))

    def write_actions(self, state: dict, actions) -> dict:
        """Write ``actions`` into the action placeholder(s): ``(envs,
        agents[, components])`` over all agents, or in the separate mode
        also ``{tag: (envs, A_p[, components])}``."""
        state = dict(state)
        if not self.separate_placeholders:
            state[_ACTIONS] = self._as_actions(actions)
            return state
        if not isinstance(actions, dict):
            a = self._with_components(actions)
            actions = {tag: a.index_select(1, idx)
                       for tag, idx in self._policy_index.items()}
        for tag, a in actions.items():
            name = f"{_ACTIONS}_{tag}"
            a = self._with_components(a)
            state[name] = a[..., : state[name].shape[-1]].to(
                state[name].dtype)
        return state

    def step(self, state: dict, actions=None) -> dict:
        """Write ``actions`` (when given), then the env's whole
        ``step_fn``, or on the split path physics and then observations."""
        if actions is not None:
            state = self.write_actions(state, actions)
        if not self.has_split_step:
            return self.env.step_fn(dict(state))
        out = self.step_physics(state, state[_ACTIONS])
        out[_OBS] = self.observe(out)
        return out

    # ------------------------------------------------------- stateful facade
    def _global(self, x: torch.Tensor) -> torch.Tensor:
        """Every env row of a state tensor: under a mesh, the env group's
        rows gathered."""
        return x if self.mesh is None else self.mesh.all_gather(x)

    def _view(self, x: torch.Tensor) -> torch.Tensor:
        """What the facade returns of a state tensor: every env row
        (:meth:`_global`, under a mesh a gathered copy), else a copy, since
        the next call writes into the state in place."""
        return x.clone() if self.mesh is None else self._global(x)

    def _obs_view(self):
        """The observation placeholders of the engine's state: one tensor
        in the shared Box mode, else ``{state name: tensor}``."""
        if self._shared_box:
            return self._view(self.state[_OBS])
        return {name: self._view(self.state[name])
                for name in self._obs_names()}

    def _sync_pinned(self):
        """Write into each pinned entry whatever ``state`` holds in its
        place (a trainer or a restore may have set ``state`` anew), so the
        pinned buffers hold the live state."""
        for name, buf in self._pinned.items():
            if self.state[name] is not buf:
                buf.copy_(self.state[name])
        self.state = {**self.state, **self._pinned}

    def _facade_program(self, kind: str) -> Program:
        """The facade's program of ``kind``: ``"step"`` (the step of
        :meth:`step`, reading the action placeholders), ``"force"``
        (:meth:`reset_all_envs`) or ``"done"`` (:meth:`reset_only_done_envs`)
        over the whole state pinned (:meth:`pin_state`), drawing from
        ``store.generator``: the counterparts of the JAX engine's
        ``_jit_step``, ``_jit_force_reset`` and ``_jit_done_reset``."""
        program = self._facade_programs.get(kind)
        if program is None:
            # the facade's own storage for every entry not pinned yet: a
            # tensor a caller set into ``state`` (a trainer's rollout
            # state) is copied in at each call (_sync_pinned), never
            # written into
            for name, value in self.state.items():
                self._pinned.setdefault(name, value.clone())
            state = {name: self._pinned[name] for name in self.state}
            generator = self.store.generator
            if kind == "step":
                def body():
                    assign_state(state, self.step(state))
            else:
                def body():
                    self.auto_reset(state, generator, force=kind == "force",
                                    out=state)
            if self._facade_pool is None and self.device.type == "cuda":
                self._facade_pool = torch.cuda.graph_pool_handle()
            program = Program(body, {"state": state}, self.device,
                              generators=[generator], pool=self._facade_pool,
                              name=f"facade {kind}")
            self._facade_programs[kind] = program
        self._sync_pinned()
        return program

    def _write_action_placeholders(self, actions):
        """The caller's actions, with :meth:`write_actions`' casts, into
        the pinned action placeholder(s): the static action buffers of the
        step program, whatever structure the actions have."""
        written = self.write_actions(self.state, actions)
        for name in self._action_names():
            self.state[name].copy_(written[name])

    def _action_names(self) -> list:
        if self.separate_placeholders:
            return [f"{_ACTIONS}_{tag}" for tag in sorted(self._policy_ids)]
        return [_ACTIONS]

    def pin_state(self, names) -> dict:
        """The engine's state entries ``names`` as static buffers, the
        tensors ``state`` holds now: the facade's programs (``reset_all_envs``,
        ``reset_only_done_envs``, ``step_all_envs``) write these entries in
        place, so a captured program that holds them
        (``presets.captured_loop``) and the facade stay on one state.
        Returns ``{name: tensor}``."""
        for name in names:
            if name not in self._pinned:
                self._pinned[name] = self.state[name]
        return {name: self._pinned[name] for name in names}

    def reset_all_envs(self):
        """Force-reset every replica and return the batched observations
        (a dict of them by state name unless shared Box; copies).  The
        very first call returns the initial state as built."""
        if self._first_reset_done:
            self._facade_program("force")()
        self._first_reset_done = True
        return self._obs_view()

    def reset_only_done_envs(self):
        """Reset the finished replicas only."""
        self._first_reset_done = True
        self._facade_program("done")()

    def step_all_envs(self, actions) -> dict:
        """Step every replica with ``actions`` (see :meth:`write_actions`)
        and return the device tensors of the done flags, every observation
        array and every reward array, by state name (copies).  Under a mesh
        the actions may be given for every env (only the rank's rows are
        taken) or for the rank's rows."""
        self._first_reset_done = True
        if self.mesh is not None:
            actions = self._local_actions(actions)
        program = self._facade_program("step")
        self._write_action_placeholders(actions)
        program()
        out = {Constants.DONE: self._view(self.state[Constants.DONE])}
        for name in self._obs_names() + self.reward_entry_names():
            out[name] = self._view(self.state[name])
        return out

    def _local_actions(self, actions):
        """The rank's rows of actions given for every env."""
        if isinstance(actions, dict):
            return {k: self._local_actions(v) for k, v in actions.items()}
        a = torch.as_tensor(actions, device=self.device)
        return a[self.env_rows] if a.shape[0] == self.n_envs else a

    # gym-style aliases
    def reset(self):
        return self.reset_all_envs()

    def obs_at_reset(self):
        """The single-env at-reset observation(s) as numpy: one array in
        the shared Box mode, else ``{state name: array}``."""
        if self._shared_box:
            return self.store.snapshot[_OBS].cpu().numpy()
        return {name: self.store.snapshot[name].cpu().numpy()
                for name in self._obs_names()}
