"""
TagGridWorld: N taggers chase 1 runner on a discrete grid.

The port's counterpart of ``warpdrive_tpu/envs/tag_gridworld.py``:

* ``TagGridWorld`` is the port's own copy of the numpy reference
  implementation (with ``sync_state``, which lets the consistency checker
  carry on past a pool reset);
* ``TorchTagGridWorld`` adds the batched device step ``step_fn`` over
  ``(envs, agents)`` int32 positions and ``observe_fn``;
* ``TorchTagGridWorldWithResetPool`` draws the start locations from a pool
  of candidates at every done-driven reset.

Game rules:

* agents move one cell (5 discrete actions), positions clipped to
  ``[0, grid_length]``; a wall hit costs ``wall_hit_penalty``;
* the game ends when ANY tagger lands on the runner's cell: every tagger
  earns ``tag_reward_for_tagger``, the runner pays
  ``tag_penalty_for_runner``; otherwise taggers pay ``step_cost_for_tagger``
  per step and the runner earns it;
* full observation: ``[x_all, y_all, agent_types, onehot(self), t/T]``
  (4N + 1 features); partial: ``[own_x, own_y, target_x, target_y,
  is_runner, t/T]`` where the target is the runner (for taggers) or the
  nearest tagger (for the runner), the lowest agent id on ties.

The JAX package forms the moves as a one-hot product and the nearest tagger
as a cumulative-sum argmin, to stay clear of TPU gathers; here they are a
table lookup and ``torch.argmin`` (the first index of the minimum).  Every
division is by a device tensor: a CUDA division by a host scalar multiplies
by its reciprocal, which may differ from the quotient in the last bit.
"""

from __future__ import annotations

import numpy as np
import torch

from warpdrive_tpu_torch.envs.base import TorchEnvironmentContext
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.data_feed import DataFeed
from warpdrive_tpu_torch.utils.env_registrar import env_registrar
from warpdrive_tpu_torch.utils.spaces import Discrete

_OBS = Constants.OBSERVATIONS
_ACTIONS = Constants.ACTIONS
_REWARDS = Constants.REWARDS

# (dx, dy) per discrete action: no-op, +x, -x, +y, -y
STEP_ACTIONS = np.array(
    [[0, 0], [1, 0], [-1, 0], [0, 1], [0, -1]], dtype=np.int32
)


class TagGridWorld:
    """Numpy reference implementation (gym-style per-agent dict API)."""

    name = "TagGridWorld"

    def __init__(
        self,
        num_taggers=10,
        grid_length=10,
        episode_length=100,
        starting_location_x=None,
        starting_location_y=None,
        seed=None,
        wall_hit_penalty=0.1,
        tag_reward_for_tagger=10.0,
        tag_penalty_for_runner=2.0,
        step_cost_for_tagger=0.01,
        use_full_observation=True,
        env_backend="cpu",
    ):
        assert num_taggers > 0 and episode_length > 0
        self.num_taggers = int(num_taggers)
        self.num_agents = self.num_taggers + 1  # one runner, last agent
        self.episode_length = int(episode_length)
        self.grid_length = int(grid_length)
        self.np_random = np.random.RandomState(seed)
        self.seed_value = seed

        # agent types: 0 = tagger, 1 = runner (last agent)
        self.agent_type = {
            aid: (1 if aid == self.num_agents - 1 else 0)
            for aid in range(self.num_agents)
        }

        if starting_location_x is None:
            assert starting_location_y is None
            # taggers start at the grid center, the runner at the corner
            starting_location_x = np.full(
                self.num_agents, int(0.5 * self.grid_length), dtype=np.int32
            )
            starting_location_x[-1] = 0
            starting_location_y = starting_location_x.copy()
        self.starting_location_x = np.asarray(starting_location_x, dtype=np.int32)
        self.starting_location_y = np.asarray(starting_location_y, dtype=np.int32)
        assert len(self.starting_location_x) == self.num_agents

        self.wall_hit_penalty = float(wall_hit_penalty)
        self.tag_reward_for_tagger = float(tag_reward_for_tagger)
        self.tag_penalty_for_runner = float(tag_penalty_for_runner)
        self.step_cost_for_tagger = float(step_cost_for_tagger)
        self.use_full_observation = bool(use_full_observation)

        self.action_space = {
            aid: Discrete(len(STEP_ACTIONS)) for aid in range(self.num_agents)
        }
        self.observation_space = None  # inferred by the engine
        self.timestep = None
        self.loc_x = None
        self.loc_y = None
        self.env_backend = env_backend

    # ----------------------------------------------------------- numpy path
    def _generate_observation(self) -> dict:
        N = self.num_agents
        L = float(self.grid_length)
        x = self.loc_x.astype(np.float32) / L
        y = self.loc_y.astype(np.float32) / L
        types = np.array(
            [self.agent_type[a] for a in range(N)], dtype=np.float32
        )
        t_norm = np.float32(self.timestep / self.episode_length)
        obs = {}
        if self.use_full_observation:
            base = np.concatenate([x, y, types])
            for aid in range(N):
                onehot = np.zeros(N, dtype=np.float32)
                onehot[aid] = 1.0
                obs[aid] = np.concatenate(
                    [base, onehot, np.array([t_norm], dtype=np.float32)]
                ).astype(np.float32)
        else:
            # nearest tagger to the runner (squared int distance, ties ->
            # lowest agent id, matching argmin)
            d2 = (
                (self.loc_x[:-1].astype(np.int64) - int(self.loc_x[-1])) ** 2
                + (self.loc_y[:-1].astype(np.int64) - int(self.loc_y[-1])) ** 2
            )
            nearest = int(np.argmin(d2))
            for aid in range(N):
                if aid < N - 1:  # tagger sees the runner
                    tx, ty = x[-1], y[-1]
                else:  # runner sees the nearest tagger
                    tx, ty = x[nearest], y[nearest]
                obs[aid] = np.array(
                    [x[aid], y[aid], tx, ty, types[aid], t_norm],
                    dtype=np.float32,
                )
        return obs

    def reset(self):
        self.timestep = 0
        self.loc_x = self.starting_location_x.copy()
        self.loc_y = self.starting_location_y.copy()
        return self._generate_observation()

    def sync_state(self, arrays: dict):
        """Consistency-checker hook: adopt the engine's post-reset state
        (the pool rows a done-driven reset drew) so lockstep comparison
        continues across randomized pool resets."""
        self.timestep = 0
        for name, value in arrays.items():
            setattr(self, name, np.asarray(value).astype(np.int32).copy())
        return self._generate_observation()

    def step(self, actions=None):
        self.timestep += 1
        assert isinstance(actions, dict) and len(actions) == self.num_agents
        act = np.array(
            [int(np.asarray(actions[a]).reshape(-1)[0]) for a in range(self.num_agents)],
            dtype=np.int32,
        )
        deltas = STEP_ACTIONS[act]
        new_x = self.loc_x + deltas[:, 0]
        new_y = self.loc_y + deltas[:, 1]
        clipped_x = np.clip(new_x, 0, self.grid_length)
        clipped_y = np.clip(new_y, 0, self.grid_length)
        # single wall penalty if either axis clipped
        wall_hit = (new_x != clipped_x) | (new_y != clipped_y)
        penalty = -self.wall_hit_penalty * wall_hit.astype(np.float32)
        self.loc_x, self.loc_y = clipped_x, clipped_y

        tag = bool(
            (
                (self.loc_x[:-1] == self.loc_x[-1])
                & (self.loc_y[:-1] == self.loc_y[-1])
            ).any()
        )
        reward_tag = np.zeros(self.num_agents, dtype=np.float32)
        if tag:
            reward_tag[:-1] = self.tag_reward_for_tagger
            reward_tag[-1] = -self.tag_penalty_for_runner
        else:
            reward_tag[:-1] = -self.step_cost_for_tagger
            reward_tag[-1] = self.step_cost_for_tagger
        reward = reward_tag + penalty

        obs = self._generate_observation()
        rew = {aid: float(reward[aid]) for aid in range(self.num_agents)}
        done = {"__all__": self.timestep >= self.episode_length or tag}
        return obs, rew, done, {}


class TorchTagGridWorld(TagGridWorld, TorchEnvironmentContext):
    """The batched device step over ``(envs, agents)`` int32 positions."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._consts_cache = {}

    def _consts(self, device: torch.device) -> dict:
        """Device constants: the move table, the runner mask and the
        divisors (device tensors, so that a CUDA division divides)."""
        device = torch.device(device)
        if device not in self._consts_cache:
            self._consts_cache[device] = {
                "moves": torch.as_tensor(STEP_ACTIONS, device=device),
                "is_runner": torch.arange(self.num_agents, device=device)
                == self.num_agents - 1,
                "eye": torch.eye(self.num_agents, dtype=torch.float32,
                                 device=device),
                "grid_length": torch.tensor(float(self.grid_length),
                                            dtype=torch.float32, device=device),
                "episode_length": torch.tensor(float(self.episode_length),
                                               dtype=torch.float32,
                                               device=device),
            }
        return self._consts_cache[device]

    def get_data_dictionary(self) -> DataFeed:
        data = DataFeed()
        assert self.loc_x is not None, "call reset() before building the feed"
        # with a reset pool the pool alone resets the positions
        save = not self._uses_reset_pool()
        data.add_data(
            "loc_x", self.loc_x, save_copy_and_apply_at_reset=save,
            log_data_across_episode=save,
        )
        data.add_data(
            "loc_y", self.loc_y, save_copy_and_apply_at_reset=save,
            log_data_across_episode=save,
        )
        return data

    def _uses_reset_pool(self) -> bool:
        return False

    def observe_fn(self, state: dict) -> torch.Tensor:
        """Observations ``(envs, agents, 4N + 1)`` (full) or ``(envs,
        agents, 6)`` (partial) of a batched state; the engine also refreshes
        the observations with it after a pool reset."""
        N = self.num_agents
        cx = state["loc_x"]
        cy = state["loc_y"]
        E = cx.shape[0]
        c = self._consts(cx.device)
        xf = cx.to(torch.float32) / c["grid_length"]
        yf = cy.to(torch.float32) / c["grid_length"]
        types = c["is_runner"].to(torch.float32).expand(E, N)
        t_norm = state[Constants.TIMESTEP].to(torch.float32) / c["episode_length"]
        if self.use_full_observation:
            base = torch.cat([xf, yf, types], dim=1)  # (E, 3N)
            return torch.cat(
                [
                    base[:, None, :].expand(E, N, 3 * N),
                    c["eye"].expand(E, N, N),
                    t_norm[:, None, None].expand(E, N, 1),
                ],
                dim=2,
            )
        d2 = (cx[:, :-1] - cx[:, -1:]) ** 2 + (cy[:, :-1] - cy[:, -1:]) ** 2
        nearest = torch.argmin(d2, dim=1, keepdim=True)  # lowest id on ties
        target_x = torch.where(c["is_runner"], xf.gather(1, nearest),
                               xf[:, -1:])
        target_y = torch.where(c["is_runner"], yf.gather(1, nearest),
                               yf[:, -1:])
        return torch.stack(
            [xf, yf, target_x, target_y, types, t_norm[:, None].expand(E, N)],
            dim=2,
        )

    def step_fn(self, state: dict) -> dict:
        c = self._consts(state["loc_x"].device)
        t = state[Constants.TIMESTEP] + 1
        x = state["loc_x"]
        y = state["loc_y"]
        deltas = c["moves"][state[_ACTIONS][..., 0]]  # (E, N, 2)
        new_x = x + deltas[..., 0]
        new_y = y + deltas[..., 1]
        cx = torch.clamp(new_x, 0, self.grid_length)
        cy = torch.clamp(new_y, 0, self.grid_length)
        wall_hit = (new_x != cx) | (new_y != cy)
        penalty = -self.wall_hit_penalty * wall_hit.to(torch.float32)

        tag = ((cx[:, :-1] == cx[:, -1:]) & (cy[:, :-1] == cy[:, -1:])).any(1)
        runner_reward = torch.where(
            tag, -self.tag_penalty_for_runner, self.step_cost_for_tagger
        )
        tagger_reward = torch.where(
            tag, self.tag_reward_for_tagger, -self.step_cost_for_tagger
        )
        reward_tag = torch.where(
            c["is_runner"], runner_reward[:, None], tagger_reward[:, None]
        ).to(torch.float32)

        out = dict(state)
        out["loc_x"] = cx.to(torch.int32)
        out["loc_y"] = cy.to(torch.int32)
        out[Constants.TIMESTEP] = t
        out[Constants.DONE] = (
            (t >= self.episode_length) | tag
        ).to(torch.int32)
        out[_OBS] = self.observe_fn(out)
        out[_REWARDS] = reward_tag + penalty
        return out


class TorchTagGridWorldWithResetPool(TorchTagGridWorld):
    """
    TagGridWorld variant whose start locations are drawn from a pool of
    candidates at every done-driven reset.
    """

    name = "TagGridWorldWithResetPool"

    POOL_SIZE = 5

    def __init__(self, *args, reset_pool_size: int = None, **kwargs):
        super().__init__(*args, **kwargs)
        if reset_pool_size is not None:
            assert reset_pool_size >= 2
            self.POOL_SIZE = int(reset_pool_size)

    def _uses_reset_pool(self) -> bool:
        return True

    def get_reset_pool_dictionary(self) -> DataFeed:
        def _random_locations():
            loc = self.np_random.choice(
                np.arange(1, self.grid_length), self.num_agents
            ).astype(np.int32)
            loc[-1] = 0
            return loc

        x_pool = np.stack([_random_locations() for _ in range(self.POOL_SIZE)])
        y_pool = np.stack([_random_locations() for _ in range(self.POOL_SIZE)])
        pool = DataFeed()
        pool.add_pool_for_reset("loc_x_reset_pool", x_pool, reset_target="loc_x")
        pool.add_pool_for_reset("loc_y_reset_pool", y_pool, reset_target="loc_y")
        return pool


env_registrar.add(TagGridWorld, backend="cpu")
env_registrar.add(TorchTagGridWorld, backend="torch", name="TagGridWorld")
env_registrar.add(TorchTagGridWorldWithResetPool, backend="torch")
