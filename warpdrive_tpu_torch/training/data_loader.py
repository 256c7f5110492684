"""
Observation / action / reward placeholder creation.

The port's counterpart of ``create_and_push_data_placeholders`` in
``warpdrive_tpu/training/data_loader.py``, for the one mode the engine and
trainer of the port need: shared placeholders with Box observations stored
agent-dim-first.  The helpers stack the env's first-reset per-agent
observations into named arrays on the engine's :class:`StateStore`;
:func:`policy_agent_groups` splits the shared placeholders' agents among
the policies that a trainer drives.

Separate per-policy placeholders, Dict observations and the agent-dim-last
layout raise ``NotImplementedError``; they arrive with ROADMAP queue 1,
item 8 (heterogeneous spaces).
"""

from __future__ import annotations

import numpy as np

from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.data_feed import DataFeed
from warpdrive_tpu_torch.utils.spaces import Box, Discrete, MultiDiscrete

_OBS = Constants.OBSERVATIONS
_ACTIONS = Constants.ACTIONS
_REWARDS = Constants.REWARDS

_LATER = "ROADMAP queue 1, item 8 (heterogeneous spaces)"


def all_equal(iterable) -> bool:
    items = list(iterable)
    return all(x == items[0] for x in items[1:])


def validate_obs_action_spaces(agent_ids, observation_space, action_space):
    """Assert all agents of the shared group have Box obs spaces of one shape
    and action spaces of one type and size."""
    obs_spaces = [observation_space[aid] for aid in agent_ids]
    if not all(isinstance(s, Box) for s in obs_spaces):
        raise NotImplementedError(
            f"only Box observation spaces are ported; see {_LATER}"
        )
    assert all_equal(s.shape for s in obs_spaces)

    act_spaces = [action_space[aid] for aid in agent_ids]
    first_a = act_spaces[0]
    assert all_equal(type(s) for s in act_spaces)
    if isinstance(first_a, MultiDiscrete):
        assert all_equal(tuple(s.nvec) for s in act_spaces)
    elif isinstance(first_a, Discrete):
        assert all_equal(s.n for s in act_spaces)
    elif isinstance(first_a, Box):
        assert all_equal(s.shape for s in act_spaces)
    else:
        raise NotImplementedError(repr(first_a))


def get_obs_group(obs: dict, agent_ids) -> np.ndarray:
    """Stack one group's per-agent observations as (agents, *feat)."""
    return np.asarray([np.asarray(obs[aid]) for aid in agent_ids])


def _action_spec(space):
    """(num_action_types, dtype) of an action space."""
    if isinstance(space, Discrete):
        return 1, np.int32
    if isinstance(space, MultiDiscrete):
        return len(space.nvec), np.int32
    if isinstance(space, Box):
        assert len(space.shape) == 1, (
            f"continuous action spaces must be 1-D, got shape {space.shape} "
            "(flatten multi-dimensional actions in the env)"
        )
        return int(space.shape[0]), np.float32
    raise NotImplementedError(repr(space))


def policy_agent_groups(policy_tag_to_agent_id_map: dict, num_agents: int,
                        observation_space: dict, action_space: dict) -> dict:
    """The shared-placeholder policy grouping: each policy's agent ids as a
    sorted int32 array.

    :raises ValueError: unless every agent maps to exactly one policy.
    Agents of one policy must share their observation and action spaces,
    since one model reads them all.
    """
    groups = {
        tag: np.asarray(sorted(int(i) for i in ids), dtype=np.int32)
        for tag, ids in policy_tag_to_agent_id_map.items()
    }
    covered = np.concatenate(list(groups.values())).tolist()
    if sorted(covered) != list(range(num_agents)):
        raise ValueError(
            f"every one of the {num_agents} agents must map to exactly one "
            f"policy; the map covers {sorted(covered)}"
        )
    for ids in groups.values():
        if len(ids) > 1:
            validate_obs_action_spaces(ids, observation_space, action_space)
    return groups


def create_and_push_data_placeholders(
    store,
    obs: dict,
    observation_space: dict,
    action_space: dict,
    create_separate_placeholders_for_each_policy: bool = False,
    obs_dim_corresponding_to_num_agents: str = "first",
) -> dict:
    """
    Create and push the shared observation/action/reward placeholders into
    ``store``.

    :param store: the engine's StateStore.
    :param obs: first-reset per-agent observation dict ``{agent_id: array}``.
    :returns: metadata ``{"separate": False, "obs_dim": "first", "groups":
        {None: {"mode": "box", "keys": [], "action": (num_components,
        dtype)}}}``, the same structure the JAX package returns.
    """
    if create_separate_placeholders_for_each_policy:
        raise NotImplementedError(
            f"separate per-policy placeholders are not ported yet; see {_LATER}"
        )
    if obs_dim_corresponding_to_num_agents != "first":
        raise NotImplementedError(
            "obs_dim_corresponding_to_num_agents='last' is not ported yet; "
            f"see {_LATER}"
        )
    agent_ids = sorted(obs.keys())
    if isinstance(obs[agent_ids[0]], dict):
        raise NotImplementedError(
            f"Dict observations are not ported yet; see {_LATER}"
        )
    if len(agent_ids) > 1:
        validate_obs_action_spaces(agent_ids, observation_space, action_space)

    feed = DataFeed()
    feed.add_data(
        name=_OBS,
        data=get_obs_group(obs, agent_ids).astype(np.float32),
        save_copy_and_apply_at_reset=True,
    )
    feed.add_data(
        name=_REWARDS, data=np.zeros((len(agent_ids),), dtype=np.float32)
    )
    num_c, act_dtype = _action_spec(action_space[agent_ids[0]])
    feed.add_data(
        name=_ACTIONS,
        data=np.zeros((len(agent_ids), num_c), dtype=act_dtype),
    )
    store.push(feed)
    return {
        "separate": False,
        "obs_dim": "first",
        "groups": {
            None: {"mode": "box", "keys": [], "action": (num_c, act_dtype)}
        },
    }
