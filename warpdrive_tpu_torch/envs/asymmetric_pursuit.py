"""
AsymmetricPursuit: a two-policy pursuit env with heterogeneous observation
spaces, the port's example of separate per-policy placeholders and Dict
observations with an ``action_mask`` key.

The port's counterpart of ``warpdrive_tpu/envs/asymmetric_pursuit.py``:

* ``AsymmetricPursuit`` is the port's own copy of the numpy reference
  implementation (the engine's host-side ``reset()`` needs it);
* ``TorchAsymmetricPursuit`` adds ``policy_map``, the data feed and the
  batched ``step_fn``, which writes the separate placeholders
  ``observations_pursuer`` (Box), ``observations_evader_<key>`` (Dict),
  ``rewards_{pursuer,evader}`` and reads ``sampled_actions_{pursuer,
  evader}``.

Game rules (deterministic given the actions):

* ``num_pursuers`` pursuers (policy "pursuer", agent ids first) and
  ``num_evaders`` evaders (policy "evader") move on the square
  ``[0, grid_length]^2`` with 5 discrete actions (stay/+x/-x/+y/-y),
  positions clipped to the square;
* pursuer reward: ``catch_reward`` per evader within ``catch_radius`` this
  step, minus ``step_cost``; evader reward: ``-catch_reward`` when any
  pursuer is within ``catch_radius``, else ``survive_bonus``;
* the episode ends at ``episode_length``.

Observations: pursuer Box(5) ``[x/L, y/L, (mean_evader_x - x)/L,
(mean_evader_y - y)/L, t/T]``; evader Dict ``self`` Box(2),
``nearest_pursuer`` Box(2) (relative, normalized) and ``action_mask``
Box(5), 1 for the moves that stay on the grid (bounds inclusive; stay is
always legal).
"""

from __future__ import annotations

import numpy as np
import torch

from warpdrive_tpu_torch.envs.base import TorchEnvironmentContext
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.data_feed import DataFeed
from warpdrive_tpu_torch.utils.env_registrar import env_registrar
from warpdrive_tpu_torch.utils.spaces import Box, DictSpace, Discrete

_OBS = Constants.OBSERVATIONS
_ACTIONS = Constants.ACTIONS
_REWARDS = Constants.REWARDS
_MASK = Constants.ACTION_MASK

# (dx, dy) per discrete action: stay, +x, -x, +y, -y
MOVES = np.array(
    [[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]],
    dtype=np.float32,
)


class AsymmetricPursuit:
    """Numpy reference implementation (gym-style per-agent dict API)."""

    name = "AsymmetricPursuit"

    def __init__(
        self,
        num_pursuers=2,
        num_evaders=3,
        grid_length=10.0,
        catch_radius=1.0,
        episode_length=50,
        pursuer_step=1.0,
        evader_step=1.0,
        catch_reward=1.0,
        step_cost=0.01,
        survive_bonus=0.01,
        seed=None,
        env_backend="cpu",
    ):
        assert num_pursuers > 0 and num_evaders > 0 and episode_length > 0
        self.num_pursuers = int(num_pursuers)
        self.num_evaders = int(num_evaders)
        self.num_agents = self.num_pursuers + self.num_evaders
        self.grid_length = float(grid_length)
        self.catch_radius = float(catch_radius)
        self.episode_length = int(episode_length)
        self.pursuer_step = float(pursuer_step)
        self.evader_step = float(evader_step)
        self.catch_reward = float(catch_reward)
        self.step_cost = float(step_cost)
        self.survive_bonus = float(survive_bonus)
        self.np_random = np.random.RandomState(seed)
        self.env_backend = env_backend

        # pursuers first, evaders after (agent_type 0 = pursuer, 1 = evader)
        self.agent_type = {
            aid: (0 if aid < self.num_pursuers else 1)
            for aid in range(self.num_agents)
        }

        self.action_space = {
            aid: Discrete(len(MOVES)) for aid in range(self.num_agents)
        }
        self.observation_space = {}
        for aid in range(self.num_agents):
            if self.agent_type[aid] == 0:
                self.observation_space[aid] = Box(-1.0, 1.0, shape=(5,))
            else:
                self.observation_space[aid] = DictSpace(
                    {
                        "self": Box(0.0, 1.0, shape=(2,)),
                        "nearest_pursuer": Box(-1.0, 1.0, shape=(2,)),
                        _MASK: Box(0.0, 1.0, shape=(5,)),
                    }
                )

        # deterministic starting layout: pursuers on one diagonal band,
        # evaders spread on the opposite side
        P, E, L = self.num_pursuers, self.num_evaders, self.grid_length
        start = np.zeros((self.num_agents, 2), dtype=np.float32)
        for i in range(P):
            frac = (i + 1) / (P + 1)
            start[i] = (frac * L, 0.25 * L)
        for j in range(E):
            frac = (j + 1) / (E + 1)
            start[P + j] = (frac * L, 0.75 * L)
        self.starting_loc = start
        self.loc = None
        self.timestep = None

    # ----------------------------------------------------------- numpy path
    def _step_sizes(self) -> np.ndarray:
        sizes = np.full(self.num_agents, self.evader_step, dtype=np.float32)
        sizes[: self.num_pursuers] = self.pursuer_step
        return sizes

    def _action_mask_for(self, loc_xy: np.ndarray, step: float) -> np.ndarray:
        """Legal-move mask: 1 when the move keeps the agent inside the grid."""
        mask = np.ones(len(MOVES), dtype=np.float32)
        for a, (dx, dy) in enumerate(MOVES):
            nx = loc_xy[0] + dx * step
            ny = loc_xy[1] + dy * step
            if not (0.0 <= nx <= self.grid_length and 0.0 <= ny <= self.grid_length):
                mask[a] = 0.0
        return mask

    def _generate_observation(self) -> dict:
        P, L = self.num_pursuers, self.grid_length
        t_norm = np.float32(self.timestep / self.episode_length)
        loc = self.loc
        mean_evader = loc[P:].mean(axis=0)
        obs = {}
        for i in range(P):
            obs[i] = np.array(
                [
                    loc[i, 0] / L,
                    loc[i, 1] / L,
                    (mean_evader[0] - loc[i, 0]) / L,
                    (mean_evader[1] - loc[i, 1]) / L,
                    t_norm,
                ],
                dtype=np.float32,
            )
        for j in range(P, self.num_agents):
            d2 = ((loc[:P] - loc[j]) ** 2).sum(axis=1)
            nearest = int(np.argmin(d2))
            obs[j] = {
                "self": (loc[j] / L).astype(np.float32),
                "nearest_pursuer": ((loc[nearest] - loc[j]) / L).astype(
                    np.float32
                ),
                _MASK: self._action_mask_for(
                    loc[j], self.evader_step
                ),
            }
        return obs

    def reset(self):
        self.timestep = 0
        self.loc = self.starting_loc.copy()
        return self._generate_observation()

    def step(self, actions=None):
        assert isinstance(actions, dict) and len(actions) == self.num_agents
        self.timestep += 1
        act = np.array(
            [
                int(np.asarray(actions[a]).reshape(-1)[0])
                for a in range(self.num_agents)
            ],
            dtype=np.int32,
        )
        deltas = MOVES[act] * self._step_sizes()[:, None]
        self.loc = np.clip(self.loc + deltas, 0.0, self.grid_length)

        P = self.num_pursuers
        # pairwise pursuer-evader distances (P, E)
        diff = self.loc[:P, None, :] - self.loc[None, P:, :]
        dist = np.sqrt((diff**2).sum(axis=-1))
        within = dist <= self.catch_radius

        reward = np.zeros(self.num_agents, dtype=np.float32)
        reward[:P] = self.catch_reward * within.sum(axis=1) - self.step_cost
        caught = within.any(axis=0)
        reward[P:] = np.where(
            caught, -self.catch_reward, self.survive_bonus
        ).astype(np.float32)

        obs = self._generate_observation()
        rew = {aid: float(reward[aid]) for aid in range(self.num_agents)}
        done = {"__all__": self.timestep >= self.episode_length}
        return obs, rew, done, {}



class TorchAsymmetricPursuit(AsymmetricPursuit, TorchEnvironmentContext):
    """Batched PyTorch step writing SEPARATE per-policy placeholders.  Use
    with ``EnvEngine(..., policy_tag_to_agent_id_map=env.policy_map(),
    create_separate_placeholders_for_each_policy=True)``."""

    def policy_map(self) -> dict:
        P = self.num_pursuers
        return {
            "pursuer": list(range(P)),
            "evader": list(range(P, self.num_agents)),
        }

    def get_data_dictionary(self) -> DataFeed:
        data = DataFeed()
        assert self.loc is not None, "call reset() before building the feed"
        data.add_data(
            "loc", self.loc, save_copy_and_apply_at_reset=True,
            log_data_across_episode=True,
        )
        return data

    def _consts(self, device: torch.device) -> dict:
        """The move table and the divisors as tensors on ``device``, made
        once a device (CUDA divides by a host scalar through its
        reciprocal)."""
        cache = self.__dict__.setdefault("_consts_by_device", {})
        if device not in cache:
            def t(x):
                return torch.as_tensor(np.asarray(x, np.float32),
                                       device=device)

            cache[device] = {"moves": t(MOVES), "L": t(self.grid_length),
                             "T": t(self.episode_length)}
        return cache[device]

    def step_fn(self, state: dict) -> dict:
        P = self.num_pursuers
        L = float(self.grid_length)
        c = self._consts(state["loc"].device)
        t = state[Constants.TIMESTEP] + 1  # (E,)
        moves = c["moves"]  # (5, 2)
        # a move is picked by its index: the JAX step's one-hot contraction
        # gives the same values exactly
        d_p = moves[state[f"{_ACTIONS}_pursuer"][..., 0].long()] \
            * np.float32(self.pursuer_step)
        d_e = moves[state[f"{_ACTIONS}_evader"][..., 0].long()] \
            * np.float32(self.evader_step)
        loc = torch.clamp(state["loc"] + torch.cat([d_p, d_e], dim=1),
                          0.0, L)  # (E, N, 2)

        loc_p, loc_e = loc[:, :P], loc[:, P:]
        diff = loc_p[:, :, None, :] - loc_e[:, None, :, :]  # (E, P, Ev, 2)
        dist2 = (diff * diff).sum(dim=-1)
        within = dist2 <= np.float32(self.catch_radius ** 2)

        rew_p = (within.sum(dim=2).to(torch.float32)
                 * np.float32(self.catch_reward) - np.float32(self.step_cost))
        caught = within.any(dim=1)
        rew_e = torch.where(
            caught, -np.float32(self.catch_reward),
            np.float32(self.survive_bonus)).to(torch.float32)

        t_norm = t.to(torch.float32) / c["T"]
        mean_e = loc_e.mean(dim=1, keepdim=True)  # (E, 1, 2)
        obs_p = torch.cat(
            [loc_p / c["L"], (mean_e - loc_p) / c["L"],
             t_norm[:, None, None].expand(-1, P, 1)],
            dim=2,
        )  # (E, P, 5)

        nearest = torch.argmin(dist2, dim=1)  # (E, Ev): lowest index
        nearest_loc = torch.gather(
            loc_p, 1, nearest[..., None].expand(-1, -1, 2))
        cand = loc_e[:, :, None, :] + moves * np.float32(self.evader_step)
        ok = ((cand >= 0.0) & (cand <= L)).all(dim=-1)  # (E, Ev, 5)

        out = dict(state)
        out["loc"] = loc
        out[f"{_OBS}_pursuer"] = obs_p
        out[f"{_OBS}_evader_self"] = loc_e / c["L"]
        out[f"{_OBS}_evader_nearest_pursuer"] = (nearest_loc - loc_e) / c["L"]
        out[f"{_OBS}_evader_{_MASK}"] = ok.to(torch.float32)
        out[f"{_REWARDS}_pursuer"] = rew_p
        out[f"{_REWARDS}_evader"] = rew_e
        out[Constants.TIMESTEP] = t
        out[Constants.DONE] = (t >= self.episode_length).to(torch.int32)
        return out


env_registrar.add(AsymmetricPursuit, backend="cpu")
env_registrar.add(TorchAsymmetricPursuit, backend="torch",
                  name="AsymmetricPursuit")
