"""
Single-agent environment base.

The port's copy of ``warpdrive_tpu/envs/classic_control/base.py``:
single-agent envs expose the same gym-style per-agent-dict API as the
multi-agent ones, with agent id 0, and support a reset pool of initial
states (``reset_pool_size >= 2`` samples a pool entry on every done-driven
reset; smaller values pin a fixed initial state).
"""

from __future__ import annotations

import numpy as np

from warpdrive_tpu_torch.utils.data_feed import DataFeed


class SingleAgentEnv:
    """Base class for single-agent environments."""

    def __init__(
        self,
        episode_length: int = 500,
        env_backend: str = "cpu",
        reset_pool_size: int = 0,
        seed: int = None,
    ):
        self.num_agents = 1
        self.agents = {0: True}
        assert episode_length > 0
        self.episode_length = int(episode_length)
        self.action_space = None
        self.observation_space = None
        self.timestep = None
        self.env_backend = env_backend
        self.reset_pool_size = int(reset_pool_size)
        self.seed = seed
        self.np_random = np.random.RandomState(seed)

    # ------------------------------------------------------------------
    def sync_state(self, arrays: dict):
        """Consistency-checker hook: adopt the engine's post-reset state
        (e.g. the pool row a done-driven reset drew) and return the
        regenerated observation, so the lockstep comparison can continue
        across randomized pool resets."""
        self.timestep = 0
        self.state = (
            np.asarray(arrays["state"]).reshape(-1).astype(np.float32).copy()
        )
        return self._sync_obs()

    def _sync_obs(self):
        return map_to_single_agent(self.state.copy())


def map_to_single_agent(val):
    return {0: val}


def get_action_for_single_agent(action):
    assert isinstance(action, dict) and len(action) == 1
    return action[0]


class SingleStateFeed:
    """The device-side feed of every classic-control env: the ``(1, D)``
    float32 ``state`` array, restored from its snapshot at a done-driven
    reset, or with ``reset_pool_size >= 2`` drawn from a pool of that many
    initial states instead.  Listed before ``TorchEnvironmentContext``
    among an env's bases, so that its methods win."""

    def get_data_dictionary(self) -> DataFeed:
        data = DataFeed()
        assert self.state is not None, "call reset() before building the feed"
        data.add_data(
            name="state",
            data=np.atleast_2d(self.state),
            save_copy_and_apply_at_reset=self.reset_pool_size < 2,
        )
        return data

    def get_reset_pool_dictionary(self) -> DataFeed:
        pool = DataFeed()
        if self.reset_pool_size >= 2:
            states = np.stack(
                [
                    np.atleast_2d(self._sample_initial_state())
                    for _ in range(self.reset_pool_size)
                ],
                axis=0,
            )
            pool.add_pool_for_reset("state_reset_pool", states,
                                    reset_target="state")
        return pool
