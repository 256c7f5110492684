"""
SingleAgentOneAtomChemSearch and SingleAgentTwoAtomChemSearch: RL for
atom-level chemistry search (the rlchemists community example).

The port's counterpart of ``warpdrive_tpu/envs/chem_search.py``.  One atom
(or two) walks a 3-D energy-landscape grid ``(nx, ny, nz)`` toward a target
site.  Six discrete moves go +-1 along x/y/z with periodic wrapping; the
reward is the normalized energy drop ``(ienergy - en_array[...]) /
max_denergy`` clipped to ``[min_reward, 0]``, plus ``terminate_reward`` on
reaching ``final_state``.

* One atom, 2-D mode (``initial_state[2] == final_state[2]``): a move that
  leaves the z-slab KEEPS the bad position and pays ``-max_denergy``;
* one atom, 3-D mode: a z-move that would leave the slab is CANCELLED (the
  position stays, plain lookup reward);
* two atoms: the action is (which atom, which move); a z-move that leaves
  the slab is reverted AND pays ``-max_denergy``.

The numpy classes are the port's own copies of the references; the
``Torch`` classes add the batched ``step_fn`` over ``(envs, ...)`` integer
positions: the move is picked by its index, the wrap is a floor modulo
(``%`` on integer tensors, as ``jnp.mod``), and the energy lookup reads
one element per env.  :func:`make_synthetic_landscape` makes the smooth
synthetic meshes the tests use in place of DFT data.
"""

from __future__ import annotations

import numpy as np
import torch

from warpdrive_tpu_torch.envs.base import TorchEnvironmentContext
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.data_feed import DataFeed
from warpdrive_tpu_torch.utils.env_registrar import env_registrar
from warpdrive_tpu_torch.utils.spaces import Discrete, MultiDiscrete

_OBS = Constants.OBSERVATIONS
_ACTIONS = Constants.ACTIONS
_REWARDS = Constants.REWARDS

# ±1 moves along x, y, z (reference action ids 0..5)
ATOM_MOVES = np.array(
    [
        [1, 0, 0], [-1, 0, 0],
        [0, 1, 0], [0, -1, 0],
        [0, 0, 1], [0, 0, -1],
    ],
    dtype=np.int32,
)


class SingleAgentOneAtomChemSearch:
    """Numpy reference implementation (gym-style dict API)."""

    name = "SingleAgentOneAtomChemSearch"

    def __init__(
        self,
        ienergy=0.0,
        max_denergy=1.0,
        nx=0,
        ny=0,
        nz=0,
        z_slab_lower=0,
        z_slab_upper=0,
        initial_state=None,
        final_state=None,
        terminate_reward=10.0,
        min_reward=-1.0,
        episode_length=50,
        en_array=None,
        seed=None,
        env_backend="cpu",
    ):
        self.num_agents = 1
        self.agents = {0: True}
        assert initial_state is not None and final_state is not None
        self.initial_state = np.asarray(initial_state, dtype=np.int32)
        self.final_state = np.asarray(final_state, dtype=np.int32)
        self.is_3d = bool(self.initial_state[2] != self.final_state[2])
        self.norm_distance = np.float32(
            np.linalg.norm((self.final_state - self.initial_state).astype(np.float64))
        )
        self.ienergy = float(ienergy)
        self.max_denergy = float(max_denergy)
        assert self.max_denergy > 0
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)
        self.z_slab_lower = int(z_slab_lower)
        self.z_slab_upper = int(z_slab_upper)
        effective_z = self.z_slab_upper - self.z_slab_lower
        self.en_array = np.asarray(en_array, dtype=np.float32)
        assert self.en_array.shape == (self.nx, self.ny, effective_z)
        self.terminate_reward = float(terminate_reward)
        self.min_reward = float(min_reward)
        assert episode_length > 0
        self.episode_length = int(episode_length)
        self.world_dim = np.array([self.nx, self.ny, self.nz], dtype=np.float32)
        assert self.z_slab_lower <= self.initial_state[2] < self.z_slab_upper

        self.action_space = {0: Discrete(len(ATOM_MOVES))}
        self.observation_space = None
        self.np_random = np.random.RandomState(seed)
        self.timestep = None
        self.global_state = None
        self.env_backend = env_backend

    # ----------------------------------------------------------- numpy path
    def _is_bad(self, state) -> bool:
        return bool(state[2] < self.z_slab_lower or state[2] >= self.z_slab_upper)

    def _lookup(self, state) -> float:
        return float(
            self.en_array[state[0], state[1], state[2] - self.z_slab_lower]
        )

    def generate_observation(self) -> dict:
        x = self.global_state.astype(np.float32) / self.world_dim
        d = np.float32(
            np.linalg.norm(
                (self.global_state - self.final_state).astype(np.float64)
            )
        ) / self.norm_distance
        return {0: np.append(x, d).astype(np.float32)}

    def reset(self):
        self.timestep = 0
        self.global_state = self.initial_state.copy()
        return self.generate_observation()

    def step(self, actions=None):
        self.timestep += 1
        assert isinstance(actions, dict) and len(actions) == 1
        action = int(np.asarray(actions[0]).reshape(-1)[0])
        state = self.global_state.copy()
        move = ATOM_MOVES[action]
        new = state + move
        # periodic wrap on every axis (reference actions wrap x/y/z)
        new[0] %= self.nx
        new[1] %= self.ny
        new[2] %= self.nz

        if self.is_3d and move[2] != 0 and self._is_bad(new):
            # 3-D: cancel z-moves that exit the slab (reference _3d.py:121-151)
            new[2] = state[2]
            denergy = self.ienergy - self._lookup(new)
        elif self._is_bad(new):
            # 2-D: keep the bad position, flat penalty (reference _2d.py:44-48)
            denergy = -self.max_denergy
        else:
            denergy = self.ienergy - self._lookup(new)

        self.global_state = new
        reward = float(np.clip(denergy / self.max_denergy, self.min_reward, 0.0))
        terminated = bool(np.all(new == self.final_state))
        if terminated:
            reward += self.terminate_reward

        obs = self.generate_observation()
        done = {"__all__": self.timestep >= self.episode_length or terminated}
        return obs, {0: reward}, done, {}


class SingleAgentTwoAtomChemSearch:
    """
    Two-atom variant (reference ``rlchemists/single_agent_two_atom/``):
    state is 6 ints (atom A xyz, atom B xyz), the action is MultiDiscrete
    ``(2, 6)`` — which atom x which ±1 move; xy moves wrap periodically
    with a 6-D energy lookup ``en_array[xa, ya, za', xb, yb, zb']``;
    z-moves that leave the slab are REVERTED and pay ``-max_denergy``
    (reference ``twoatom_actions_3d.py:120-164`` — note this differs from
    the one-atom 3-D env, which cancels without penalty).
    """

    name = "SingleAgentTwoAtomChemSearch"

    def __init__(
        self,
        ienergy=0.0,
        max_denergy=1.0,
        nx=0,
        ny=0,
        nz=0,
        z_slab_lower=0,
        z_slab_upper=0,
        initial_state=None,
        final_state=None,
        terminate_reward=10.0,
        min_reward=-1.0,
        episode_length=50,
        en_array=None,
        seed=None,
        env_backend="cpu",
    ):
        self.num_agents = 1
        self.agents = {0: True}
        assert initial_state is not None and final_state is not None
        self.initial_state = np.asarray(initial_state, dtype=np.int32)
        self.final_state = np.asarray(final_state, dtype=np.int32)
        assert self.initial_state.shape == (6,)
        self.norm_distance_a = np.float32(
            np.linalg.norm(
                (self.final_state[:3] - self.initial_state[:3]).astype(np.float64)
            )
        )
        self.norm_distance_b = np.float32(
            np.linalg.norm(
                (self.final_state[3:] - self.initial_state[3:]).astype(np.float64)
            )
        )
        self.ienergy = float(ienergy)
        self.max_denergy = float(max_denergy)
        assert self.max_denergy > 0
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)
        self.z_slab_lower = int(z_slab_lower)
        self.z_slab_upper = int(z_slab_upper)
        eff_z = self.z_slab_upper - self.z_slab_lower
        self.en_array = np.asarray(en_array, dtype=np.float32)
        assert self.en_array.shape == (
            self.nx, self.ny, eff_z, self.nx, self.ny, eff_z
        )
        self.terminate_reward = float(terminate_reward)
        self.min_reward = float(min_reward)
        self.episode_length = int(episode_length)
        self.world_dim = np.array(
            [self.nx, self.ny, self.nz] * 2, dtype=np.float32
        )
        assert self.z_slab_lower <= self.initial_state[2] < self.z_slab_upper
        assert self.z_slab_lower <= self.initial_state[5] < self.z_slab_upper

        self.action_space = {0: MultiDiscrete((2, len(ATOM_MOVES)))}
        self.observation_space = None
        self.np_random = np.random.RandomState(seed)
        self.timestep = None
        self.global_state = None
        self.env_backend = env_backend

    # ----------------------------------------------------------- numpy path
    def _lookup(self, s) -> float:
        zl = self.z_slab_lower
        return float(
            self.en_array[s[0], s[1], s[2] - zl, s[3], s[4], s[5] - zl]
        )

    def generate_observation(self) -> dict:
        x = self.global_state.astype(np.float32) / self.world_dim
        d1 = np.float32(
            np.linalg.norm(
                (self.global_state[:3] - self.final_state[:3]).astype(np.float64)
            )
        ) / self.norm_distance_a
        d2 = np.float32(
            np.linalg.norm(
                (self.global_state[3:] - self.final_state[3:]).astype(np.float64)
            )
        ) / self.norm_distance_b
        return {0: np.concatenate([x, [d1, d2]]).astype(np.float32)}

    def reset(self):
        self.timestep = 0
        self.global_state = self.initial_state.copy()
        return self.generate_observation()

    def step(self, actions=None):
        self.timestep += 1
        assert isinstance(actions, dict) and len(actions) == 1
        a = np.asarray(actions[0]).reshape(-1)
        atom_sel, move_id = int(a[0]), int(a[1])
        base = 3 * atom_sel
        s = self.global_state.copy()
        move = ATOM_MOVES[move_id]
        dims = [self.nx, self.ny, self.nz]
        for axis in range(3):
            s[base + axis] = (s[base + axis] + move[axis]) % dims[axis]

        z = s[base + 2]
        if move[2] != 0 and not (self.z_slab_lower <= z < self.z_slab_upper):
            # revert the z move AND pay the penalty (two-atom semantics)
            s[base + 2] = self.global_state[base + 2]
            denergy = -self.max_denergy
        else:
            denergy = self.ienergy - self._lookup(s)

        self.global_state = s
        reward = float(np.clip(denergy / self.max_denergy, self.min_reward, 0.0))
        terminated = bool(np.all(s == self.final_state))
        if terminated:
            reward += self.terminate_reward

        obs = self.generate_observation()
        done = {"__all__": self.timestep >= self.episode_length or terminated}
        return obs, {0: reward}, done, {}


class _TorchChemSearch(TorchEnvironmentContext):
    """The data feed and the device tables both chem envs step with."""

    def get_data_dictionary(self) -> DataFeed:
        data = DataFeed()
        assert self.global_state is not None, "call reset() first"
        data.add_data(
            "position",
            np.atleast_2d(self.global_state),
            save_copy_and_apply_at_reset=True,
            log_data_across_episode=True,
        )
        return data

    def _consts(self, device: torch.device) -> dict:
        """Tables and divisors on ``device`` (a host-scalar divisor would
        divide through its reciprocal on CUDA), made once a device."""
        cache = self.__dict__.setdefault("_consts_by_device", {})
        consts = cache.get(device)
        if consts is None:
            def t(x, dtype=None):
                return torch.as_tensor(np.asarray(x), dtype=dtype,
                                       device=device)

            consts = {
                "moves": t(ATOM_MOVES, torch.int32),
                "en_flat": t(self.en_array.reshape(-1), torch.float32),
                "final": t(self.final_state, torch.int32),
                "world_dim": t(self.world_dim, torch.float32),
                "dims": t(np.asarray(self.world_dim, np.int32), torch.int32),
                "max_denergy": t(np.float32(self.max_denergy)),
                "norms": t(np.asarray(self._norms, np.float32)),
            }
            cache[device] = consts
        return consts

    def _reward(self, c: dict, denergy: torch.Tensor,
                terminated: torch.Tensor) -> torch.Tensor:
        reward = torch.clamp(denergy / c["max_denergy"], self.min_reward, 0.0)
        return reward + torch.where(terminated,
                                    np.float32(self.terminate_reward),
                                    np.float32(0.0))

    def _finish(self, state: dict, new: torch.Tensor, obs: torch.Tensor,
                reward: torch.Tensor, terminated: torch.Tensor) -> dict:
        t = state[Constants.TIMESTEP] + 1
        out = dict(state)
        out["position"] = new[:, None, :]
        out[_OBS] = obs[:, None, :]
        out[_REWARDS] = reward[:, None].to(torch.float32)
        out[Constants.TIMESTEP] = t
        out[Constants.DONE] = ((t >= self.episode_length) | terminated).to(
            torch.int32)
        return out

    @staticmethod
    def _distance(delta: torch.Tensor, norm) -> torch.Tensor:
        return torch.sqrt((delta.to(torch.float32) ** 2).sum(dim=1)) / norm


class TorchSingleAgentOneAtomChemSearch(SingleAgentOneAtomChemSearch,
                                        _TorchChemSearch):
    """The six action branches as one batched function."""

    @property
    def _norms(self):
        return [self.norm_distance]

    def step_fn(self, state: dict) -> dict:
        pos = state["position"][:, 0]  # (E, 3) int32
        c = self._consts(pos.device)
        move = c["moves"][state[_ACTIONS][:, 0, 0].long()]
        new = (pos + move) % c["dims"]

        bad = (new[:, 2] < self.z_slab_lower) | \
            (new[:, 2] >= self.z_slab_upper)
        if self.is_3d:
            # cancel the z-moves that leave the slab
            new = torch.cat(
                [new[:, :2], torch.where(bad, pos[:, 2], new[:, 2])[:, None]],
                dim=1)
            bad = torch.zeros_like(bad)

        eff_z = self.z_slab_upper - self.z_slab_lower
        zc = torch.clamp(new[:, 2] - self.z_slab_lower, 0, eff_z - 1)
        flat_idx = (new[:, 0] * self.ny + new[:, 1]) * eff_z + zc
        denergy = torch.where(
            bad, -np.float32(self.max_denergy),
            np.float32(self.ienergy) - c["en_flat"][flat_idx.long()])
        terminated = (new == c["final"]).all(dim=1)
        reward = self._reward(c, denergy, terminated)

        d = self._distance(new - c["final"], c["norms"][0])
        obs = torch.cat([new.to(torch.float32) / c["world_dim"], d[:, None]],
                        dim=1)
        return self._finish(state, new, obs, reward, terminated)


class TorchSingleAgentTwoAtomChemSearch(SingleAgentTwoAtomChemSearch,
                                        _TorchChemSearch):
    """The 12 (atom, move) action branches as one batched function."""

    @property
    def _norms(self):
        return [self.norm_distance_a, self.norm_distance_b]

    def step_fn(self, state: dict) -> dict:
        pos = state["position"][:, 0]  # (E, 6) int32
        c = self._consts(pos.device)
        acts = state[_ACTIONS][:, 0].long()  # (E, 2): (atom, move)
        move3 = c["moves"][acts[:, 1]]
        atom_b = (acts[:, 0] == 1)[:, None]  # the move's atom
        zero = torch.zeros_like(move3)
        move6 = torch.cat([torch.where(atom_b, zero, move3),
                           torch.where(atom_b, move3, zero)], dim=1)
        new = (pos + move6) % c["dims"]

        zl, zu = self.z_slab_lower, self.z_slab_upper
        z_moved = move3[:, 2] != 0
        za_bad = (new[:, 2] < zl) | (new[:, 2] >= zu)
        zb_bad = (new[:, 5] < zl) | (new[:, 5] >= zu)
        bad = z_moved & (za_bad | zb_bad)
        # revert only the moved atom's z
        moved_z = torch.where(atom_b, 5, 2)  # (E, 1)
        reverted = new.scatter(1, moved_z, pos.gather(1, moved_z))
        new = torch.where(bad[:, None], reverted, new)

        eff_z = zu - zl
        za = torch.clamp(new[:, 2] - zl, 0, eff_z - 1)
        zb = torch.clamp(new[:, 5] - zl, 0, eff_z - 1)
        flat_idx = (
            (((new[:, 0] * self.ny + new[:, 1]) * eff_z + za) * self.nx
             + new[:, 3]) * self.ny + new[:, 4]
        ) * eff_z + zb
        denergy = torch.where(
            bad, -np.float32(self.max_denergy),
            np.float32(self.ienergy) - c["en_flat"][flat_idx.long()])
        terminated = (new == c["final"]).all(dim=1)
        reward = self._reward(c, denergy, terminated)

        d1 = self._distance(new[:, :3] - c["final"][:3], c["norms"][0])
        d2 = self._distance(new[:, 3:] - c["final"][3:], c["norms"][1])
        obs = torch.cat([new.to(torch.float32) / c["world_dim"],
                         d1[:, None], d2[:, None]], dim=1)
        return self._finish(state, new, obs, reward, terminated)


def make_synthetic_landscape(nx, ny, eff_z, seed=0, amplitude=1.0):
    """A smooth synthetic energy mesh (tests/demos; the reference ships DFT
    meshes as .npy data files)."""
    rng = np.random.RandomState(seed)
    x = np.linspace(0, 2 * np.pi, nx)[:, None, None]
    y = np.linspace(0, 2 * np.pi, ny)[None, :, None]
    z = np.linspace(0, 2 * np.pi, eff_z)[None, None, :]
    phase = rng.uniform(0, 2 * np.pi, size=3)
    return (
        amplitude
        * (
            np.sin(x + phase[0])
            + np.cos(2 * y + phase[1])
            + 0.5 * np.sin(z + phase[2])
        )
    ).astype(np.float32)



env_registrar.add(SingleAgentOneAtomChemSearch, backend="cpu")
env_registrar.add(TorchSingleAgentOneAtomChemSearch, backend="torch",
                  name="SingleAgentOneAtomChemSearch")
env_registrar.add(SingleAgentTwoAtomChemSearch, backend="cpu")
env_registrar.add(TorchSingleAgentTwoAtomChemSearch, backend="torch",
                  name="SingleAgentTwoAtomChemSearch")
