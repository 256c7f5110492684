"""
Observation / action / reward placeholder creation.

The port's counterpart of ``create_and_push_data_placeholders`` in
``warpdrive_tpu/training/data_loader.py``: the helpers stack the env's
first-reset per-agent observations into named arrays on the engine's
:class:`StateStore`, in the JAX package's modes and names:

* shared placeholders (the default): one ``observations`` array (Box
  observations) or one ``observations_<key>`` array per key of a Dict
  observation, in the env's key order, plus ``sampled_actions`` and
  ``rewards`` over all agents, whose spaces must agree;
* separate per-policy placeholders
  (``create_separate_placeholders_for_each_policy=True``): per policy
  ``p``, ``observations_<p>`` or ``observations_<p>_<key>``,
  ``sampled_actions_<p>`` and ``rewards_<p>``, so that policies may differ
  in their spaces;
* ``obs_dim_corresponding_to_num_agents``: ``"first"`` stores
  ``(envs, agents, *feat)``, ``"last"`` ``(envs, feat, agents)`` for envs
  that write agent-dim-last (1-D features only).

:func:`policy_agent_groups` splits the agents among the policies that a
trainer drives.
"""

from __future__ import annotations

import numpy as np

from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.data_feed import DataFeed
from warpdrive_tpu_torch.utils.spaces import (
    Box,
    DictSpace,
    Discrete,
    MultiDiscrete,
)

_OBS = Constants.OBSERVATIONS
_ACTIONS = Constants.ACTIONS
_REWARDS = Constants.REWARDS


def all_equal(iterable) -> bool:
    items = list(iterable)
    return all(x == items[0] for x in items[1:])


def _shape_of(v):
    """Shape of a space-like or array-like dict value."""
    shp = getattr(v, "shape", None)
    return tuple(shp) if shp is not None else np.asarray(v).shape


def validate_obs_action_spaces(agent_ids, observation_space, action_space):
    """Assert all agents of one placeholder group share their observation
    space's type, keys and shapes, and their action space's type and
    size."""
    obs_spaces = [observation_space[aid] for aid in agent_ids]
    first = obs_spaces[0]
    assert all_equal(type(s) for s in obs_spaces)
    if isinstance(first, (dict, DictSpace)):
        assert all_equal(tuple(s.keys()) for s in obs_spaces)
        assert all_equal(
            tuple(_shape_of(v) for v in s.values()) for s in obs_spaces
        )
    else:
        assert isinstance(first, Box), (
            "observation spaces must be Box or DictSpace, got "
            f"{type(first).__name__}"
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


def get_obs_group(obs: dict, agent_ids,
                  obs_dim_corresponding_to_num_agents: str = "first",
                  obs_key=None) -> np.ndarray:
    """Stack one group's per-agent observations (of Dict key ``obs_key``
    when given): ``"first"`` -> ``(agents, *feat)``, ``"last"`` -> ``(feat,
    agents)``, a swap of the first and last axes, single-agent groups
    included.  ``"last"`` takes 1-D features only, as in the JAX
    package."""
    if obs_key is not None:
        stacked = np.asarray(
            [np.asarray(obs[aid][obs_key]) for aid in agent_ids])
    else:
        stacked = np.asarray([np.asarray(obs[aid]) for aid in agent_ids])
    if obs_dim_corresponding_to_num_agents == "last":
        assert stacked.ndim <= 2, (
            "obs_dim_corresponding_to_num_agents='last' supports 1-D "
            f"per-agent features only (got feature shape "
            f"{stacked.shape[1:]}); store multi-dim features agent-dim-"
            "first, or flatten them in the env"
        )
        return np.swapaxes(stacked, 0, -1)
    return stacked


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
    policy_tag_to_agent_id_map: dict = None,
    create_separate_placeholders_for_each_policy: bool = False,
    obs_dim_corresponding_to_num_agents: str = "first",
) -> dict:
    """
    Create and push the observation/action/reward placeholders into
    ``store``.

    :param store: the engine's StateStore.
    :param obs: first-reset per-agent observation dict ``{agent_id: array |
        {key: array}}``.
    :returns: metadata ``{"separate": bool, "obs_dim": str, "groups":
        {tag_or_None: {"mode": "box" | "dict", "keys": [...], "action":
        (num_components, dtype)}}}``, the same structure the JAX package
        returns: per group, since separate policies may differ in their
        observation structure.
    """
    assert obs_dim_corresponding_to_num_agents in ("first", "last")
    meta = {
        "separate": bool(create_separate_placeholders_for_each_policy),
        "obs_dim": obs_dim_corresponding_to_num_agents,
        "groups": {},
    }

    def push_group(agent_ids, suffix: str) -> dict:
        first_obs = obs[agent_ids[0]]
        mode = "dict" if isinstance(first_obs, dict) else "box"
        # the env's key order: the features are concatenated in it
        keys = list(first_obs.keys()) if mode == "dict" else []
        feed = DataFeed()
        for key in keys or [None]:
            name = _OBS + suffix + ("" if key is None else f"_{key}")
            feed.add_data(
                name=name,
                data=get_obs_group(obs, agent_ids,
                                   obs_dim_corresponding_to_num_agents,
                                   obs_key=key).astype(np.float32),
                save_copy_and_apply_at_reset=True,
            )
        feed.add_data(
            name=_REWARDS + suffix,
            data=np.zeros((len(agent_ids),), dtype=np.float32),
        )
        num_c, act_dtype = _action_spec(action_space[agent_ids[0]])
        feed.add_data(
            name=_ACTIONS + suffix,
            data=np.zeros((len(agent_ids), num_c), dtype=act_dtype),
        )
        store.push(feed)
        return {"mode": mode, "keys": keys, "action": (num_c, act_dtype)}

    if create_separate_placeholders_for_each_policy:
        assert policy_tag_to_agent_id_map is not None and (
            len(policy_tag_to_agent_id_map) > 1
        ), "separate placeholders require multiple policies"
        for tag, agent_ids in policy_tag_to_agent_id_map.items():
            agent_ids = sorted(int(i) for i in agent_ids)
            if len(agent_ids) > 1:
                validate_obs_action_spaces(agent_ids, observation_space,
                                           action_space)
            meta["groups"][tag] = push_group(agent_ids, f"_{tag}")
    else:
        agent_ids = sorted(obs.keys())
        if len(agent_ids) > 1:
            validate_obs_action_spaces(agent_ids, observation_space,
                                       action_space)
        meta["groups"][None] = push_group(agent_ids, "")
    return meta
