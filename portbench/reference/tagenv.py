"""
TagContinuous in plain PyTorch: the starting layout, the step, the exact
k-nearest-neighbour observation and the done-driven reset, over batched
``(envs, agents)`` tensors.

This is the benchmark's yardstick for the env layers.  It reads nothing of
the program: the env's settings come from the configuration file, the
layout from the seed.  The step and the observation are frozen copies of
the plain versions the port's kernels are held to (the env's
``physics_fn`` and ``knn_observation_plain`` with the exact order: ascending
squared distance, the lowest index first among equal ones), written out
again so that a later change to the program cannot move the yardstick.

``dtype`` runs the floating-point work in another precision (the control
runs it in bfloat16); the integer logic (tags, flags, counters) is the
same in every precision.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = np.float32(1e-10)
_BIG = np.float32(1e20)
_VALID_MAX = 1e18

FLOAT_FIELDS = ("loc_x", "loc_y", "speed", "direction", "acceleration")
# the program's names of the per-env counters and flags
TIMESTEP = "_timestep_"
DONE = "_done_"
STILL = "still_in_the_game"
REWARDS = "rewards"


class TagEnv:
    """One TagContinuous configuration: its constant tables, its starting
    layout for ``seed``, and the batched step over ``num_envs`` replicas."""

    def __init__(self, env: dict, seed: int, num_envs: int, device,
                 dtype=torch.float32):
        self.env = env
        self.num_envs = int(num_envs)
        self.device = torch.device(device)
        self.dtype = dtype
        self.num_taggers = int(env["num_taggers"])
        self.num_agents = self.num_taggers + int(env["num_runners"])
        self.k = int(env["num_other_agents_observed"])
        self.episode_length = int(env["episode_length"])
        N = self.num_agents
        grid = np.float32(env["grid_length"])
        self.grid_length = grid

        # the layout, drawn as the env's constructor draws it from its seed:
        # the tagger ids, then x, y and the headings
        rs = np.random.RandomState(seed)
        taggers = rs.choice(np.arange(N), self.num_taggers, replace=False)
        self.is_tagger = np.zeros(N, dtype=bool)
        self.is_tagger[taggers] = True
        self.agent_types = self.is_tagger.astype(np.int32)
        x0 = np.asarray(grid * rs.rand(N), dtype=np.float32)
        y0 = np.asarray(grid * rs.rand(N), dtype=np.float32)
        dir0 = np.asarray(rs.choice([0, np.pi / 2, np.pi, np.pi * 3 / 2], N,
                                    replace=True), dtype=np.float32)

        levels_acc = int(env["num_acceleration_levels"])
        levels_turn = int(env["num_turn_levels"])
        acc_table = np.insert(np.linspace(
            np.float32(env["min_acceleration"]),
            np.float32(env["max_acceleration"]), levels_acc), 0, 0
        ).astype(np.float32)
        turn_table = np.insert(np.linspace(
            np.float32(env["min_turn"]), np.float32(env["max_turn"]),
            levels_turn), 0, 0).astype(np.float32)
        self.action_levels = (len(acc_table), len(turn_table))
        skill = np.where(self.is_tagger,
                         np.float32(env.get("skill_level_tagger", 1.0)),
                         np.float32(env.get("skill_level_runner", 1.0))
                         ).astype(np.float32)
        max_speed = np.float32(env.get("max_speed", 1.0))
        step_rewards = np.where(
            self.is_tagger, np.float32(env.get("step_penalty_for_tagger", 0)),
            np.float32(env.get("step_reward_for_runner", 0))
        ).astype(np.float32)

        self.margin = float(np.float32(env["tagging_distance"] * grid))
        self.edge_penalty = float(np.float32(env.get("edge_hit_penalty", 0)))
        self.tag_reward = float(np.float32(env["tag_reward_for_tagger"]))
        self.tag_penalty = float(np.float32(env["tag_penalty_for_runner"]))
        self.end_reward = float(np.float32(
            env["end_of_game_reward_for_runner"]))
        self.runner_exits = bool(env.get("runner_exits_game_after_tagged",
                                         True))

        def t(x, dt=None):
            return torch.as_tensor(np.asarray(x), dtype=dt,
                                   device=self.device)

        fd = dtype
        self.c = {
            "is_tagger": t(self.is_tagger),
            "is_runner": t(~self.is_tagger),
            "tagger_ids": t(np.where(self.is_tagger)[0], torch.long),
            "max_speed": t(max_speed * skill, fd),
            "acc_table": t(acc_table, fd),
            "turn_table": t(turn_table, fd),
            "step_rewards": t(step_rewards, fd),
            "types_f": t(self.agent_types.astype(np.float32), fd),
            "grid_diagonal": t(np.float32(grid * np.sqrt(2)), fd),
            "speed_norm": t(max_speed + _EPS, fd),
            "two_pi": t(np.float32(2 * np.pi), fd),
            "episode_length": t(np.float32(self.episode_length), fd),
        }
        E = self.num_envs
        self.start = {
            "loc_x": t(x0, fd).expand(E, N).clone(),
            "loc_y": t(y0, fd).expand(E, N).clone(),
            "speed": torch.zeros((E, N), dtype=fd, device=self.device),
            "direction": t(dir0, fd).expand(E, N).clone(),
            "acceleration": torch.zeros((E, N), dtype=fd,
                                        device=self.device),
            STILL: torch.ones((E, N), dtype=torch.int32, device=self.device),
            REWARDS: torch.zeros((E, N), dtype=fd, device=self.device),
            TIMESTEP: torch.zeros((E,), dtype=torch.int32, device=self.device),
            DONE: torch.zeros((E,), dtype=torch.int32, device=self.device),
        }

    def ids_of(self, agent_type: int) -> torch.Tensor:
        """The agent ids of one type (0 runner, 1 tagger), ascending."""
        return torch.as_tensor(np.where(self.agent_types == agent_type)[0],
                               dtype=torch.long, device=self.device)

    def cast(self, state: dict) -> dict:
        """``state`` with its floating-point entries in this env's dtype."""
        return {k: (v.to(self.dtype) if v.is_floating_point() else v)
                for k, v in state.items()}

    # ---------------------------------------------------------------- step
    def step(self, state: dict, actions: torch.Tensor) -> dict:
        """Physics, tags, rewards and done flags of every replica for
        ``actions`` ``(envs, agents, 2)``: (acceleration level, turn
        level)."""
        c = self.c
        t = state[TIMESTEP] + 1
        still_i = state[STILL]
        still = still_i.to(self.dtype)
        actions = actions.long()
        delta_acc = c["acc_table"][actions[..., 0]]
        delta_turn = c["turn_table"][actions[..., 1]]

        direction = torch.remainder(state["direction"] + delta_turn,
                                    2 * np.pi) * still
        acc = state["acceleration"] + delta_acc
        max_speed = c["max_speed"]
        speed = torch.minimum(torch.clamp(state["speed"] + acc, min=0.0),
                              max_speed) * still
        acc = acc * (speed > 0) * (speed < max_speed)

        new_x = state["loc_x"] + speed * torch.cos(direction)
        new_y = state["loc_y"] + speed * torch.sin(direction)
        grid = float(self.grid_length)
        crossed = ~((new_x >= 0) & (new_x <= grid) & (new_y >= 0)
                    & (new_y <= grid))
        loc_x = torch.clamp(new_x, 0.0, grid)
        loc_y = torch.clamp(new_y, 0.0, grid)
        edge = crossed.to(self.dtype) * self.edge_penalty

        alive = still_i > 0
        rew = torch.where(alive, edge + c["step_rewards"], 0.0)
        tagger_ids = c["tagger_ids"]
        dxt = loc_x[:, :, None] - loc_x[:, None, tagger_ids]
        dyt = loc_y[:, :, None] - loc_y[:, None, tagger_ids]
        dist_t = torch.sqrt(dxt * dxt + dyt * dyt)
        min_d = dist_t.amin(dim=2)
        nearest = dist_t.argmin(dim=2)
        tagged = alive & c["is_runner"] & (min_d < self.margin)
        tagged_f = tagged.to(self.dtype)
        rew = rew + tagged_f * self.tag_penalty
        credit = torch.zeros(tagged_f.shape[0], tagger_ids.shape[0],
                             dtype=self.dtype, device=self.device
                             ).scatter_add_(1, nearest, tagged_f)
        tag_credit = torch.zeros_like(rew)
        tag_credit[:, tagger_ids] = credit
        rew = rew + tag_credit * self.tag_reward
        if self.runner_exits:
            still_i = torch.where(tagged, 0, still_i).to(torch.int32)
        survivors = c["is_runner"] & (still_i > 0)
        rew = rew + torch.where(
            (t == self.episode_length)[:, None] & survivors,
            self.end_reward, 0.0)
        done = ((t >= self.episode_length)
                | (survivors.sum(dim=1) == 0)).to(torch.int32)
        return {"loc_x": loc_x, "loc_y": loc_y, "speed": speed,
                "direction": direction, "acceleration": acc, STILL: still_i,
                REWARDS: rew, TIMESTEP: t, DONE: done}

    def reset_done(self, state: dict) -> dict:
        """Every replica whose done flag is set back to the starting layout,
        its counter and flag to 0; rewards stay."""
        done = state[DONE] > 0
        out = dict(state)
        for name in FLOAT_FIELDS + (STILL,):
            out[name] = torch.where(done[:, None], self.start[name],
                                    state[name])
        out[TIMESTEP] = torch.where(done, 0, state[TIMESTEP]).to(torch.int32)
        out[DONE] = torch.where(done, 0, state[DONE]).to(torch.int32)
        return out

    # --------------------------------------------------------- observation
    def observe(self, state: dict) -> torch.Tensor:
        """The kNN observation ``(envs, agents, 8 k + 1)`` in float32: for
        each of the k nearest live others, ascending squared distance and
        the lowest index first among equal ones, its five features relative
        to the observer's, its type, 1 (in the game), 1 (valid); then the
        time.  An observer out of the game sees zeros."""
        c = self.c
        loc_x, loc_y = state["loc_x"], state["loc_y"]
        E, N = loc_x.shape
        k = self.k
        feats = torch.stack([
            loc_x / c["grid_diagonal"],
            loc_y / c["grid_diagonal"],
            state["speed"] / c["speed_norm"],
            state["acceleration"] / c["speed_norm"],
            state["direction"] / c["two_pi"],
        ], dim=1)  # (E, 5, N)
        still_f = state[STILL].to(self.dtype)
        t_norm = state[TIMESTEP].to(self.dtype) / c["episode_length"]

        dx = loc_x[:, None, :] - loc_x[:, :, None]  # [e, i, j] = x_j - x_i
        dy = loc_y[:, None, :] - loc_y[:, :, None]
        d2 = dx * dx + dy * dy
        alive = still_f >= 0.5
        not_self = ~torch.eye(N, dtype=torch.bool, device=self.device)
        valid = alive[:, None, :] & not_self & (d2 < _VALID_MAX)
        key = torch.where(valid, d2, torch.inf)
        order = torch.sort(key, dim=2, stable=True).indices[:, :, :k]
        n_valid = valid.sum(dim=2)
        slot = torch.arange(k, device=self.device)
        gate = ((n_valid[:, :, None] > slot) & alive[:, :, None])[..., None]
        src6 = torch.cat([feats, c["types_f"].expand(E, 1, N)], dim=1)
        nbr = src6.gather(2, order.reshape(E, 1, N * k).expand(E, 6, N * k))
        nbr = nbr.reshape(E, 6, N, k).permute(0, 2, 3, 1)  # (E, N, k, 6)
        rel = nbr[..., :5] - feats.transpose(1, 2)[:, :, None, :]
        gate_f = gate.to(self.dtype)
        slots = torch.cat([torch.where(gate, rel, 0.0),
                           torch.where(gate, nbr[..., 5:6], 0.0),
                           gate_f, gate_f], dim=3)
        t_col = torch.where(alive, t_norm[:, None], 0.0)[..., None]
        obs = torch.cat([slots.reshape(E, N, 8 * k), t_col], dim=2)
        return obs.to(torch.float32)

    # ----------------------------------------------------- judging a step
    def candidates(self, pre: dict) -> dict:
        """The heading, speed and acceleration every one of the action
        pairs would give each agent: ``(levels_acc, levels_turn, E, N)``
        tensors, for telling which legal action a recorded transition
        took."""
        c = self.c
        still = pre[STILL].to(self.dtype)
        direction = torch.remainder(
            pre["direction"][None] + c["turn_table"][:, None, None],
            2 * np.pi) * still  # (Lt, E, N)
        acc = pre["acceleration"][None] + c["acc_table"][:, None, None]
        speed = torch.minimum(torch.clamp(pre["speed"][None] + acc, min=0.0),
                              c["max_speed"]) * still  # (La, E, N)
        acc = acc * (speed > 0) * (speed < c["max_speed"])
        La, Lt = self.action_levels
        return {"direction": direction[None].expand(La, Lt, *still.shape),
                "speed": speed[:, None].expand(La, Lt, *still.shape),
                "acceleration": acc[:, None].expand(La, Lt, *still.shape)}

    def infer_actions(self, pre: dict, post: dict) -> torch.Tensor:
        """For a recorded step ``pre`` -> ``post`` (taken before its reset),
        the action pair of each agent whose heading, speed and acceleration
        lie nearest the recorded ones: ``(E, N, 2)`` int32.  A transition
        that no legal action explains still gets the nearest, and the
        gap it leaves shows in the step's comparison."""
        cand = self.candidates(pre)
        miss = sum((cand[f].float() - post[f].float()[None, None]).abs()
                   for f in ("direction", "speed", "acceleration"))
        La, Lt = self.action_levels
        best = miss.reshape(La * Lt, *miss.shape[2:]).argmin(dim=0)
        return torch.stack([best // Lt, best % Lt], dim=-1).to(torch.int32)
