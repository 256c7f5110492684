"""
TagContinuous: taggers chase runners on a continuous 2D square.

The port's counterpart of ``warpdrive_tpu/envs/tag_continuous.py``:

* ``TagContinuous`` is the port's own copy of the numpy reference
  implementation (the engine's host-side ``reset()`` and the data feed need
  it, and the port imports nothing of the JAX package);
* ``TorchTagContinuous`` adds the batched device step: ``physics_fn`` over
  ``(envs, agents)`` tensors, ``observe_fn`` (the full observation, or the
  ``passes``, ``ladder``, ``topk``, ``approx`` and ``packed`` kNN
  algorithms in plain PyTorch) and ``observe_batch_fn``, which sends every
  ``pallas*`` name of the kNN mode to the port's kNN kernels
  (``ops/knn_obs.py``).

Game rules:

* MultiDiscrete actions: (acceleration level, turn level), each with a no-op
  inserted at index 0;
* physics: ``dir' = (dir + turn) mod 2pi``, ``speed' = clip(speed + acc', 0,
  max_speed * skill)``, acceleration zeroed at the speed bounds, positions
  clipped to the square with an optional edge-hit penalty;
* a runner whose nearest tagger is closer than ``tagging_distance *
  grid_length`` is tagged: it pays ``tag_penalty_for_runner``, the nearest
  tagger earns ``tag_reward_for_tagger``, and (optionally) the runner exits
  the game (``still_in_the_game`` -> 0);
* observations are either full (relative normalized state of every other
  agent) or the k-nearest-neighbor subset (``num_other_agents_observed``);
* episode ends at ``episode_length`` or when no runners remain.
"""

from __future__ import annotations

import numpy as np
import torch

from warpdrive_tpu_torch.envs.base import TorchEnvironmentContext
from warpdrive_tpu_torch.ops.knn_obs import (
    _VALID_MAX_PACKED,
    knn_observation,
    packed_keys,
)
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.data_feed import DataFeed
from warpdrive_tpu_torch.utils.env_registrar import env_registrar
from warpdrive_tpu_torch.utils.spaces import MultiDiscrete

_OBS = Constants.OBSERVATIONS
_ACTIONS = Constants.ACTIONS
_REWARDS = Constants.REWARDS

_EPS = np.float32(1e-10)
_BIG = np.float32(1e20)


class TagContinuous:
    """Numpy reference implementation (vectorized, float32)."""

    name = "TagContinuous"

    def __init__(
        self,
        num_taggers=1,
        num_runners=10,
        grid_length=10.0,
        episode_length=100,
        starting_location_x=None,
        starting_location_y=None,
        starting_directions=None,
        seed=None,
        max_speed=1.0,
        skill_level_runner=1.0,
        skill_level_tagger=1.0,
        max_acceleration=1.0,
        min_acceleration=-1.0,
        max_turn=np.pi / 2,
        min_turn=-np.pi / 2,
        num_acceleration_levels=10,
        num_turn_levels=10,
        edge_hit_penalty=-0.0,
        use_full_observation=True,
        num_other_agents_observed=2,
        tagging_distance=0.01,
        tag_reward_for_tagger=1.0,
        step_penalty_for_tagger=-0.0,
        tag_penalty_for_runner=-1.0,
        step_reward_for_runner=0.0,
        end_of_game_reward_for_runner=1.0,
        runner_exits_game_after_tagged=True,
        env_backend="cpu",
        knn_algorithm="passes",
        knn_select="fused",
        knn_block_envs=2,
    ):
        # kNN algorithm and selection names are the JAX package's, so its
        # configs carry over; TorchTagContinuous says which of them the
        # port runs.  The numpy reference below ignores both: its kNN
        # observation is always the exact sort.
        assert knn_algorithm in (
            "passes", "topk", "ladder", "packed", "approx",
            "pallas", "pallas_mxu", "pallas_mxu_exact", "pallas_onehot",
            "pallas_twolevel", "pallas_twolevel_exact",
            "pallas_tiled", "pallas_tiled_exact",
            "pallas_mxudist", "pallas_mxudist_exact",
            "pallas_flat", "pallas_flat_exact",
            "pallas_flat_mxudist", "pallas_flat_mxudist_exact",
            "pallas_envlanes", "pallas_envlanes_exact",
        )
        assert knn_select in ("fused", "gather", "bf16pair")
        self.knn_select = knn_select
        self.knn_algorithm = knn_algorithm
        self.knn_block_envs = int(knn_block_envs)
        assert num_taggers > 0 and num_runners > 0 and episode_length > 0
        self.num_taggers = int(num_taggers)
        self.num_runners_initial = int(num_runners)
        self.num_agents = self.num_taggers + self.num_runners_initial
        if knn_algorithm.startswith("pallas") and self.num_agents > 128:
            if knn_algorithm in ("pallas_mxu", "pallas_mxu_exact"):
                # the JAX package runs these above one 128-agent tile as
                # its multi-tile kernel, which has the same semantics
                knn_algorithm = {
                    "pallas_mxu": "pallas_tiled",
                    "pallas_mxu_exact": "pallas_tiled_exact",
                }[knn_algorithm]
                self.knn_algorithm = knn_algorithm
            elif not knn_algorithm.startswith(
                ("pallas_tiled", "pallas_mxudist", "pallas_flat",
                 "pallas_envlanes")
            ):
                raise ValueError(
                    f"knn_algorithm={knn_algorithm!r} supports at most 128 "
                    f"agents; this env has {self.num_agents}. Use "
                    "'pallas_flat_exact' or 'ladder'."
                )
        self.episode_length = int(episode_length)
        self.grid_length = np.float32(grid_length)
        self.grid_diagonal = np.float32(self.grid_length * np.sqrt(2))
        assert edge_hit_penalty <= 0
        self.edge_hit_penalty = np.float32(edge_hit_penalty)

        self.np_random = np.random.RandomState(seed)

        # tagger ids drawn first (RNG order matches reference :158-160)
        taggers = self.np_random.choice(
            np.arange(self.num_agents), self.num_taggers, replace=False
        )
        tagger_set = set(int(t) for t in taggers)
        # agent types: 1 = tagger, 0 = runner (note: OPPOSITE of gridworld)
        self.agent_type = {
            aid: (1 if aid in tagger_set else 0) for aid in range(self.num_agents)
        }
        self.agent_types = np.array(
            [self.agent_type[a] for a in range(self.num_agents)], dtype=np.int32
        )
        self.is_tagger = self.agent_types == 1
        self.is_runner = ~self.is_tagger
        # static (T, N) 0/1 tagger-selection matrix (ascending tagger
        # ids): gather-free tagger-coordinate extraction and local->
        # global credit scatter in the jitted physics (see physics_fn)
        _tids = np.where(self.is_tagger)[0]
        self._tagger_select = np.zeros(
            (len(_tids), self.num_agents), dtype=np.float32
        )
        self._tagger_select[np.arange(len(_tids)), _tids] = 1.0
        # reference-API aliases (tag_continuous.py:163-171): dicts keyed by
        # agent id so ``list(env.taggers)`` yields the tagger ids for a
        # policy_tag_to_agent_id_map; these are the at-reset memberships
        # (the device-side state tracks in-game runners dynamically)
        self.taggers = {int(a): True for a in np.where(self.is_tagger)[0]}
        self.runners = {int(a): True for a in np.where(self.is_runner)[0]}

        if starting_location_x is None:
            assert starting_location_y is None
            starting_location_x = self.grid_length * self.np_random.rand(
                self.num_agents
            )
            starting_location_y = self.grid_length * self.np_random.rand(
                self.num_agents
            )
        self.starting_location_x = np.asarray(
            starting_location_x, dtype=np.float32
        )
        self.starting_location_y = np.asarray(
            starting_location_y, dtype=np.float32
        )

        if starting_directions is None:
            starting_directions = self.np_random.choice(
                [0, np.pi / 2, np.pi, np.pi * 3 / 2], self.num_agents, replace=True
            )
        self.starting_directions = np.asarray(starting_directions, dtype=np.float32)

        self.max_speed = np.float32(max_speed)
        assert num_acceleration_levels >= 0 and num_turn_levels >= 0
        self.num_acceleration_levels = int(num_acceleration_levels)
        self.num_turn_levels = int(num_turn_levels)
        # level 0 is the no-op (reference :219-232)
        self.acceleration_actions = np.insert(
            np.linspace(
                np.float32(min_acceleration),
                np.float32(max_acceleration),
                self.num_acceleration_levels,
            ),
            0,
            0,
        ).astype(np.float32)
        self.turn_actions = np.insert(
            np.linspace(
                np.float32(min_turn), np.float32(max_turn), self.num_turn_levels
            ),
            0,
            0,
        ).astype(np.float32)

        self.skill_levels = np.where(
            self.is_tagger,
            np.float32(skill_level_tagger),
            np.float32(skill_level_runner),
        ).astype(np.float32)

        self.runner_exits_game_after_tagged = bool(runner_exits_game_after_tagged)
        self.use_full_observation = bool(use_full_observation)
        assert num_other_agents_observed <= self.num_agents
        self.num_other_agents_observed = int(num_other_agents_observed)

        assert 0 <= tagging_distance <= 1
        self.distance_margin_for_reward = np.float32(
            tagging_distance * self.grid_length
        )
        assert tag_reward_for_tagger >= 0 and step_penalty_for_tagger <= 0
        assert tag_penalty_for_runner <= 0 and step_reward_for_runner >= 0
        assert end_of_game_reward_for_runner >= 0
        self.tag_reward_for_tagger = np.float32(tag_reward_for_tagger)
        self.tag_penalty_for_runner = np.float32(tag_penalty_for_runner)
        self.end_of_game_reward_for_runner = np.float32(
            end_of_game_reward_for_runner
        )
        self.step_rewards = np.where(
            self.is_tagger,
            np.float32(step_penalty_for_tagger),
            np.float32(step_reward_for_runner),
        ).astype(np.float32)

        self.action_space = {
            aid: MultiDiscrete(
                (len(self.acceleration_actions), len(self.turn_actions))
            )
            for aid in range(self.num_agents)
        }
        self.observation_space = None  # inferred by the engine

        self.timestep = None
        self.loc_x = None
        self.loc_y = None
        self.speed = None
        self.direction = None
        self.acceleration = None
        self.still_in_the_game = None
        self.env_backend = env_backend

    # ------------------------------------------------------------ numpy path
    @property
    def obs_size(self) -> int:
        """Full-obs mode: channel-major (7 features x N-1 others) + time.
        kNN mode: slot-major (8 features per neighbor slot: 5 relative +
        type + still + valid) + time."""
        if self.use_full_observation:
            return 7 * (self.num_agents - 1) + 1
        return 8 * self.num_other_agents_observed + 1

    def _normalized_features(self) -> np.ndarray:
        """(5, N) normalized global state (reference :452-470)."""
        return np.stack(
            [
                self.loc_x / self.grid_diagonal,
                self.loc_y / self.grid_diagonal,
                self.speed / (self.max_speed + _EPS),
                self.acceleration / (self.max_speed + _EPS),
                self.direction / np.float32(2 * np.pi),
            ]
        ).astype(np.float32)

    def _generate_observation(self) -> dict:
        N = self.num_agents
        feats = self._normalized_features()  # (5, N)
        types = self.agent_types.astype(np.float32)
        still = self.still_in_the_game.astype(np.float32)
        t_norm = np.float32(self.timestep / self.episode_length)
        obs = {}
        if self.use_full_observation:
            drop = [
                [j for j in range(N) if j != i] for i in range(N)
            ]  # self-column removal
            for i in range(N):
                if self.still_in_the_game[i]:
                    rel = feats - feats[:, i : i + 1]
                    rows = np.vstack([rel, types, still])[:, drop[i]]
                    obs[i] = np.concatenate(
                        [rows.reshape(-1), [t_norm]]
                    ).astype(np.float32)
                else:
                    rows = np.vstack([np.zeros_like(feats), types, still])[
                        :, drop[i]
                    ]
                    obs[i] = np.concatenate(
                        [rows.reshape(-1), [np.float32(0.0)]]
                    ).astype(np.float32)
        else:
            # slot-major kNN layout: for each of the k nearest alive others,
            # [rel_x, rel_y, rel_speed, rel_acc, rel_dir, type, still, valid]
            # (real kNN features at EVERY timestep, t == 0 included)
            k = self.num_other_agents_observed
            dx = self.loc_x[:, None] - self.loc_x[None, :]
            dy = self.loc_y[:, None] - self.loc_y[None, :]
            dist = np.sqrt(dx**2 + dy**2).astype(np.float32)
            np.fill_diagonal(dist, _BIG)
            dist[:, self.still_in_the_game == 0] = _BIG
            for i in range(N):
                if not self.still_in_the_game[i]:
                    obs[i] = np.zeros(8 * k + 1, dtype=np.float32)
                    continue
                order = np.argsort(dist[i], kind="stable")[:k]
                valid = dist[i][order] < _BIG
                slots = np.zeros((k, 8), dtype=np.float32)
                for s in range(k):
                    if valid[s]:
                        j = order[s]
                        slots[s, :5] = feats[:, j] - feats[:, i]
                        slots[s, 5] = types[j]
                        slots[s, 6] = still[j]
                        slots[s, 7] = 1.0
                obs[i] = np.concatenate([slots.reshape(-1), [t_norm]]).astype(
                    np.float32
                )
        return obs

    def reset(self):
        self.timestep = 0
        self.loc_x = self.starting_location_x.copy()
        self.loc_y = self.starting_location_y.copy()
        self.speed = np.zeros(self.num_agents, dtype=np.float32)
        self.direction = self.starting_directions.copy()
        self.acceleration = np.zeros(self.num_agents, dtype=np.float32)
        self.still_in_the_game = np.ones(self.num_agents, dtype=np.int32)
        return self._generate_observation()

    def step(self, actions=None):
        self.timestep += 1
        assert isinstance(actions, dict) and len(actions) == self.num_agents
        acts = np.stack(
            [np.asarray(actions[a]).reshape(-1) for a in range(self.num_agents)]
        ).astype(np.int32)
        delta_acc = self.acceleration_actions[acts[:, 0]]
        delta_turn = self.turn_actions[acts[:, 1]]
        still = self.still_in_the_game.astype(np.float32)

        # physics update (reference update_state :339-401)
        self.direction = (
            ((self.direction + delta_turn) % np.float32(2 * np.pi)) * still
        ).astype(np.float32)
        acc = self.acceleration + delta_acc
        max_speed = self.max_speed * self.skill_levels
        self.speed = (
            np.clip(self.speed + acc, 0.0, max_speed) * still
        ).astype(np.float32)
        self.acceleration = (
            acc * (self.speed > 0) * (self.speed < max_speed)
        ).astype(np.float32)

        new_x = (self.loc_x + self.speed * np.cos(self.direction)).astype(
            np.float32
        )
        new_y = (self.loc_y + self.speed * np.sin(self.direction)).astype(
            np.float32
        )
        crossed = ~(
            (new_x >= 0)
            & (new_x <= self.grid_length)
            & (new_y >= 0)
            & (new_y <= self.grid_length)
        )
        self.loc_x = np.clip(new_x, 0.0, self.grid_length).astype(np.float32)
        self.loc_y = np.clip(new_y, 0.0, self.grid_length).astype(np.float32)
        edge_penalty = self.edge_hit_penalty * crossed.astype(np.float32)

        # rewards (reference compute_reward :612-678)
        rew = np.zeros(self.num_agents, dtype=np.float32)
        alive = self.still_in_the_game > 0
        rew[alive] += edge_penalty[alive] + self.step_rewards[alive]

        dx = self.loc_x[:, None] - self.loc_x[None, :]
        dy = self.loc_y[:, None] - self.loc_y[None, :]
        dist = np.sqrt(dx**2 + dy**2).astype(np.float32)
        d_rt = dist.copy()
        d_rt[:, ~self.is_tagger] = _BIG  # columns: taggers only
        min_d = d_rt.min(axis=1)
        nearest_tagger = d_rt.argmin(axis=1)
        tagged = alive & self.is_runner & (min_d < self.distance_margin_for_reward)

        rew[tagged] += self.tag_penalty_for_runner
        np.add.at(rew, nearest_tagger[tagged], self.tag_reward_for_tagger)
        if self.runner_exits_game_after_tagged:
            self.still_in_the_game[tagged] = 0

        num_runners_alive = int(
            (self.is_runner & (self.still_in_the_game > 0)).sum()
        )
        if self.timestep == self.episode_length:
            survivors = self.is_runner & (self.still_in_the_game > 0)
            rew[survivors] += self.end_of_game_reward_for_runner

        obs = self._generate_observation()
        rew_dict = {a: float(rew[a]) for a in range(self.num_agents)}
        done = {
            "__all__": self.timestep >= self.episode_length
            or num_runners_alive == 0
        }
        return obs, rew_dict, done, {}


# JAX knn_algorithm name -> the knn_observation variant it selects
_KNN_VARIANTS = {
    "pallas": "packed",
    "pallas_mxu": "mxu",
    "pallas_mxu_exact": "mxu_exact",
    "pallas_twolevel": "twolevel",
    "pallas_twolevel_exact": "twolevel_exact",
    "pallas_onehot": "onehot",
    "pallas_tiled": "tiled",
    "pallas_tiled_exact": "tiled_exact",
    "pallas_mxudist": "tiled_mxudist",
    "pallas_mxudist_exact": "tiled_mxudist_exact",
    "pallas_flat": "flat",
    "pallas_flat_exact": "flat_exact",
    "pallas_flat_mxudist": "flat_mxudist",
    "pallas_flat_mxudist_exact": "flat_mxudist_exact",
    "pallas_envlanes": "envlanes",
    "pallas_envlanes_exact": "envlanes_exact",
}


class TorchTagContinuous(TagContinuous, TorchEnvironmentContext):
    """Batched PyTorch version: every step function acts on all replicas,
    with state tensors of shape ``(envs, agents)``.

    ``knn_algorithm`` (kNN observation mode only):

    * ``"pallas_flat_exact"``, ``"pallas_flat"``,
      ``"pallas_flat_mxudist[_exact]"``, ``"pallas_tiled[_exact]"``,
      ``"pallas_mxudist[_exact]"`` and ``"pallas_envlanes[_exact]"`` at any
      agent count, and up to 128 agents ``"pallas_mxu[_exact]"``,
      ``"pallas"``, ``"pallas_onehot"`` and ``"pallas_twolevel[_exact]"``
      -- :meth:`observe_batch_fn` calls the port's kNN kernels
      (``ops/knn_obs.py``: K1, K3, K4, K5, K9, K2, K6, K7 and K8).  Above
      128 agents the ``mxu`` names route to ``pallas_tiled[_exact]``, as in
      the JAX package, and the other single-tile names raise
      ``ValueError``.  :meth:`observe_fn`, the per-state observation, runs
      ``passes`` for every ``pallas*`` name, as the JAX package's does;
    * ``"passes"``, ``"ladder"``, ``"topk"``, ``"approx"`` and ``"packed"``
      -- plain PyTorch.

    ``knn_select`` is accepted and ignored: the port always picks neighbour
    features as exact float32.  In the full-observation mode (the
    constructor's default) neither applies: every observation is
    :meth:`full_observation`, plain PyTorch, and no kNN kernel runs.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._consts_by_device = {}

    def _consts(self, device: torch.device) -> dict:
        """The env's constant tables as tensors on ``device``.  Divisors are
        0-dim device tensors, not python scalars: CUDA divides by a host
        scalar through its reciprocal, which can move a result by an ulp."""
        consts = self._consts_by_device.get(device)
        if consts is None:
            def t(x, dtype=None):
                return torch.as_tensor(np.asarray(x), dtype=dtype,
                                       device=device)

            consts = {
                "is_tagger": t(self.is_tagger),
                "is_runner": t(self.is_runner),
                "tagger_ids": t(np.where(self.is_tagger)[0], torch.long),
                "max_speed": t(self.max_speed * self.skill_levels),
                "acc_table": t(self.acceleration_actions),
                "turn_table": t(self.turn_actions),
                "step_rewards": t(self.step_rewards),
                "types_f": t(self.agent_types.astype(np.float32)),
                "grid_diagonal": t(self.grid_diagonal),
                "speed_norm": t(self.max_speed + _EPS),
                "two_pi": t(np.float32(2 * np.pi)),
                "episode_length": t(np.float32(self.episode_length)),
            }
            if self.use_full_observation:
                # others_of[i, k]: observer i's k-th other agent, j < i -> j,
                # j >= i -> j + 1 (the self column dropped)
                n = self.num_agents
                k = np.arange(n - 1)[None, :]
                consts["others_of"] = t(
                    k + (k >= np.arange(n)[:, None]), torch.long)
            self._consts_by_device[device] = consts
        return consts

    def get_data_dictionary(self) -> DataFeed:
        data = DataFeed()
        assert self.loc_x is not None, "call reset() before building the feed"
        logged = ("loc_x", "loc_y")
        for name in ("loc_x", "loc_y", "speed", "direction", "acceleration"):
            data.add_data(
                name,
                getattr(self, name),
                save_copy_and_apply_at_reset=True,
                log_data_across_episode=name in logged,
            )
        data.add_data(
            "still_in_the_game",
            self.still_in_the_game,
            save_copy_and_apply_at_reset=True,
            log_data_across_episode=True,
        )
        return data

    def physics_fn(self, state: dict, actions: torch.Tensor) -> dict:
        """Dynamics + tagging + rewards + done for all replicas, WITHOUT the
        observation build.  ``actions``: ``(envs, agents, 2)`` integers."""
        c = self._consts(state["loc_x"].device)
        t = state[Constants.TIMESTEP] + 1  # (E,)
        still_i = state["still_in_the_game"]  # (E, N) int32
        still = still_i.to(torch.float32)
        actions = actions.long()
        delta_acc = c["acc_table"][actions[..., 0]]
        delta_turn = c["turn_table"][actions[..., 1]]

        # ---- physics (mirrors numpy step) -----------------------------------
        direction = (
            torch.remainder(state["direction"] + delta_turn, 2 * np.pi) * still
        )
        acc = state["acceleration"] + delta_acc
        max_speed = c["max_speed"]
        speed = torch.minimum(
            torch.clamp(state["speed"] + acc, min=0.0), max_speed
        ) * still
        acc = acc * (speed > 0) * (speed < max_speed)

        new_x = state["loc_x"] + speed * torch.cos(direction)
        new_y = state["loc_y"] + speed * torch.sin(direction)
        grid = float(self.grid_length)
        crossed = ~(
            (new_x >= 0) & (new_x <= grid) & (new_y >= 0) & (new_y <= grid)
        )
        loc_x = torch.clamp(new_x, 0.0, grid)
        loc_y = torch.clamp(new_y, 0.0, grid)
        edge_penalty = crossed.to(torch.float32) * float(self.edge_hit_penalty)

        # ---- rewards ---------------------------------------------------------
        alive = still_i > 0
        rew = torch.where(alive, edge_penalty + c["step_rewards"], 0.0)

        # distances to the tagger set only: (E, N, T)
        tagger_ids = c["tagger_ids"]
        dxt = loc_x[:, :, None] - loc_x[:, None, tagger_ids]
        dyt = loc_y[:, :, None] - loc_y[:, None, tagger_ids]
        dist_t = torch.sqrt(dxt * dxt + dyt * dyt)
        min_d = dist_t.amin(dim=2)
        nearest_local = dist_t.argmin(dim=2)  # lowest index among ties
        tagged = (
            alive & c["is_runner"]
            & (min_d < float(self.distance_margin_for_reward))
        )
        tagged_f = tagged.to(torch.float32)

        rew = rew + tagged_f * float(self.tag_penalty_for_runner)
        credit_local = torch.zeros(
            tagged_f.shape[0], tagger_ids.shape[0], dtype=torch.float32,
            device=tagged_f.device,
        ).scatter_add_(1, nearest_local, tagged_f)  # (E, T)
        tag_credit = torch.zeros_like(rew)
        tag_credit[:, tagger_ids] = credit_local
        rew = rew + tag_credit * float(self.tag_reward_for_tagger)
        if self.runner_exits_game_after_tagged:
            still_i = torch.where(tagged, 0, still_i).to(torch.int32)

        survivors = c["is_runner"] & (still_i > 0)
        num_runners_alive = survivors.sum(dim=1)
        rew = rew + torch.where(
            (t == self.episode_length)[:, None] & survivors,
            float(self.end_of_game_reward_for_runner),
            0.0,
        )
        done = (
            (t >= self.episode_length) | (num_runners_alive == 0)
        ).to(torch.int32)

        out = dict(state)
        out["loc_x"] = loc_x
        out["loc_y"] = loc_y
        out["speed"] = speed
        out["direction"] = direction
        out["acceleration"] = acc
        out["still_in_the_game"] = still_i
        out[_REWARDS] = rew
        out[Constants.TIMESTEP] = t
        out[Constants.DONE] = done
        return out

    def _knn_inputs(self, state: dict):
        """``feats (E, 5, N)``, ``still_f (E, N)`` and ``t_norm (E,)`` as the
        JAX ``observe_batch_fn`` builds them."""
        c = self._consts(state["loc_x"].device)
        feats = torch.stack(
            [
                state["loc_x"] / c["grid_diagonal"],
                state["loc_y"] / c["grid_diagonal"],
                state["speed"] / c["speed_norm"],
                state["acceleration"] / c["speed_norm"],
                state["direction"] / c["two_pi"],
            ],
            dim=1,
        )
        still_f = state["still_in_the_game"].to(torch.float32)
        t_norm = (
            state[Constants.TIMESTEP].to(torch.float32) / c["episode_length"]
        )
        return feats, still_f, t_norm

    def full_observation(self, state: dict) -> torch.Tensor:
        """The full observation ``(envs, agents, 7 (N - 1) + 1)``: for
        observer i, channel-major, the 5 features of every other agent j
        relative to its own (``feats[j] - feats[i]``, zero for an observer
        out of the game), j's type and j's in-game flag, then the time (0
        for an observer out of the game).  The self column is dropped by a
        gather with a constant index table: exact, as the JAX package's
        one-hot contraction at ``Precision.HIGHEST`` is."""
        c = self._consts(state["loc_x"].device)
        feats, still_f, t_norm = self._knn_inputs(state)  # (E, 5, N) ...
        E, _, N = feats.shape
        alive = state["still_in_the_game"] > 0  # (E, N)
        rel = feats[:, :, None, :] - feats[:, :, :, None]  # [e, c, i, j]
        rel = torch.where(alive[:, None, :, None], rel, 0.0)
        rows = torch.cat(
            [rel,
             c["types_f"].expand(E, 1, N, N),
             still_f[:, None, None, :].expand(E, 1, N, N)],
            dim=1,
        )  # (E, 7, N_self, N_other)
        others = torch.gather(
            rows, 3, c["others_of"].expand(E, 7, N, N - 1))
        time_col = torch.where(alive, t_norm[:, None], 0.0)[..., None]
        return torch.cat(
            [others.permute(0, 2, 1, 3).reshape(E, N, 7 * (N - 1)),
             time_col],
            dim=2,
        )

    def observe_batch_fn(self, state: dict) -> torch.Tensor:
        """Batched observation ``(envs, agents, obs_size)``: the kNN kernel
        of a ``pallas*`` name in the kNN mode, else :meth:`observe_fn`."""
        if self.use_full_observation or \
                self.knn_algorithm not in _KNN_VARIANTS:
            return self.observe_fn(state)
        feats, still_f, t_norm = self._knn_inputs(state)
        return knn_observation(
            state["loc_x"].contiguous(),
            state["loc_y"].contiguous(),
            feats,
            self._consts(feats.device)["types_f"],
            still_f,
            t_norm,
            n_agents=self.num_agents,
            k=self.num_other_agents_observed,
            variant=_KNN_VARIANTS[self.knn_algorithm],
        )

    def observe_fn(self, state: dict) -> torch.Tensor:
        """Observation of the current batched state in plain PyTorch: the
        :meth:`full_observation`, or in the kNN mode by the env's
        algorithm: the exact ``passes`` (k rounds of min,
        lowest-index argmin, select, mask), run for every ``pallas_*`` name
        as in the JAX package; the ``ladder`` (slot s takes the least entry
        lexicographically after slot s-1's (min, argmin)); ``topk`` and
        ``approx`` (a stable sort of the distances cut to k: JAX's
        ``approx_min_k`` at ``recall_target=1.0`` is exact off the TPU).
        All of them give the same selection and tie-breaks.  ``packed``
        sorts the keys ``(bits(d2) & ~(2^b - 1)) | j`` with b =
        bit_length(N - 1), so distances within its tie window order by
        index."""
        if self.use_full_observation:
            return self.full_observation(state)
        c = self._consts(state["loc_x"].device)
        k = self.num_other_agents_observed
        loc_x = state["loc_x"]
        loc_y = state["loc_y"]
        E, N = loc_x.shape
        feats, still_f, t_norm = self._knn_inputs(state)
        alive = state["still_in_the_game"] > 0  # (E, N)
        own = feats.transpose(1, 2)  # (E, N, 5)
        src7 = torch.cat(
            [feats, c["types_f"].expand(E, 1, N), still_f[:, None, :]], dim=1
        )  # (E, 7, N)

        dx = loc_x[:, :, None] - loc_x[:, None, :]  # [e, i, j] = x_i - x_j
        dy = loc_y[:, :, None] - loc_y[:, None, :]
        dist2 = dx * dx + dy * dy
        eye = torch.eye(N, dtype=torch.bool, device=loc_x.device)
        big = float(_BIG)
        d2 = torch.where(eye | ~alive[:, None, :], big, dist2)

        def pick(am):  # (E, N) neighbour index -> (E, N, 7) its channels
            return src7.gather(2, am[:, None, :].expand(E, 7, N)).transpose(1, 2)

        algo = self.knn_algorithm
        if algo.startswith("pallas"):
            algo = "passes"
        slots = []
        if algo in ("topk", "approx", "packed"):
            if algo == "packed":
                key = packed_keys(d2, max(1, (N - 1).bit_length()))
                vals, order = torch.sort(key, dim=2)  # the keys are unique
                valid = vals[..., :k] < _VALID_MAX_PACKED
            else:
                vals, order = torch.sort(d2, dim=2, stable=True)
                valid = vals[..., :k] < big
            for s in range(k):
                v = valid[..., s].to(torch.float32)[..., None]
                nbr = pick(order[..., s])
                slots.append(torch.cat(
                    [(nbr[..., :5] - own) * v, nbr[..., 5:6] * v, v, v], dim=2
                ))
        elif algo == "ladder":
            col_j = torch.arange(N, device=loc_x.device)
            prev_m = torch.full((E, N, 1), -1.0, device=loc_x.device)
            prev_am = torch.full((E, N, 1), -1, device=loc_x.device)
            for _slot in range(k):
                later = (d2 > prev_m) | ((d2 == prev_m) & (col_j > prev_am))
                cand = torch.where(later, d2, big)
                m = cand.amin(dim=2)
                am = cand.argmin(dim=2)
                v = (m < big).to(torch.float32)[..., None]
                nbr = pick(am)
                slots.append(torch.cat(
                    [(nbr[..., :5] - own) * v, nbr[..., 5:6] * v, v, v], dim=2
                ))
                prev_m = m[..., None]
                prev_am = am[..., None]
        else:
            for _slot in range(k):
                m = d2.amin(dim=2)
                am = d2.argmin(dim=2)  # first index at the min
                v = (m < big).to(torch.float32)[..., None]
                nbr = pick(am)
                slots.append(torch.cat(
                    [(nbr[..., :5] - own) * v, nbr[..., 5:6] * v,
                     nbr[..., 6:7] * v, v],
                    dim=2,
                ))
                d2 = d2.scatter(2, am[..., None], big)

        slot_block = torch.stack(slots, dim=2)  # (E, N, k, 8)
        obs = torch.cat(
            [slot_block.reshape(E, N, 8 * k),
             t_norm[:, None, None].expand(E, N, 1)],
            dim=2,
        )
        return torch.where(alive[..., None], obs, 0.0)


env_registrar.add(TagContinuous, backend="cpu")
env_registrar.add(TorchTagContinuous, backend="torch", name="TagContinuous")
