"""
The flagship system: the port's counterpart of ``warpdrive_tpu/presets.py``.

TagContinuous with 5 taggers and 100 runners, k = 10 neighbour observations
and two ``FullyConnected`` policies (runner and tagger), built as functions
over batched tensors:

* ``env_only_step((state, checksum), generator, out=None)`` -- random
  actions, then observe, physics and auto-reset (the env simulation rate);
* ``full_loop_step(models, state, generator, out=None)`` -- observe, the
  two policy forward passes, categorical sampling, physics and auto-reset;

each resetting into ``out``, the static state, where it is given
(``core/reset.py``; on a card one launch of the reset kernel).

Each step runs the kNN observation once, so on a CUDA device each launches
the kNN kernel once.

:func:`captured_loop` gives each of these steps its captured form, the
counterpart of ``jax.jit`` over the JAX package's pure step functions
(``warpdrive_tpu/presets.py:6``): a :class:`~warpdrive_tpu_torch.core.
program.Program` over a static ``(state, checksum)`` carry (and, for
``full_loop_step``, the models) whose every call is one replay of one CUDA
graph on a card, the kNN kernel inside it.  The eager step functions stay
as they are: they are the captured forms' plain versions.

``build_many_agents`` is the 1024-agent configuration of the JAX package's
bench (``bench.py:576-598``): the flagship's settings with 20 taggers and
1004 runners on a 60-unit square, no policies, and the same
``env_only_step``.

``build_env_only_loop`` builds the same random-action loop for an env of
the full-step path (TagGridWorld, the classic-control envs): the env's
whole step, which writes the observations, then the auto-reset; the JAX
bench's ``tag_gridworld_env_steps_per_sec`` and
``cartpole_100k_env_steps_per_sec`` stages (``bench.py:430-551``) time it.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from warpdrive_tpu_torch.core.program import Program, assign_state
from warpdrive_tpu_torch.models.fully_connected import FullyConnected
from warpdrive_tpu_torch.sampling.samplers import sample_heads
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.device import resolve_device
from warpdrive_tpu_torch.utils.spaces import Box, Discrete, MultiDiscrete

_OBS = Constants.OBSERVATIONS

FLAGSHIP_ENV_KWARGS = dict(
    num_taggers=5,
    num_runners=100,
    grid_length=20.0,
    episode_length=500,
    max_acceleration=0.1,
    min_acceleration=-0.1,
    max_turn=2.35619449,
    min_turn=-2.35619449,
    num_acceleration_levels=10,
    num_turn_levels=10,
    skill_level_runner=1.0,
    skill_level_tagger=1.0,
    max_speed=1.0,
    use_full_observation=False,
    num_other_agents_observed=10,
    runner_exits_game_after_tagged=True,
    tag_reward_for_tagger=10.0,
    tag_penalty_for_runner=-10.0,
    end_of_game_reward_for_runner=1.0,
    tagging_distance=0.02,
)

# the JAX bench's 1024-agent stage (bench.py:578-582)
MANY_AGENT_ENV_KWARGS = dict(
    FLAGSHIP_ENV_KWARGS, num_taggers=20, num_runners=1004, grid_length=60.0
)


def _rollout_state(engine):
    """The rollout carries only the physical state: observations are
    computed from it each step, and actions are passed to the physics
    directly."""
    assert engine.env.has_split_step
    return {
        k: v
        for k, v in engine.state.items()
        if k not in (_OBS, Constants.ACTIONS)
    }


def random_actions_fn(engine, device):
    """``actions(generator)``: uniform random actions ``(envs, agents,
    components)`` for every agent of ``engine``, drawn on ``device``."""
    space = engine.action_space[engine._agent_ids[0]]
    shape = (engine.n_envs, engine.n_agents)
    if isinstance(space, Box):
        low = torch.tensor(np.array(space.low, np.float32), device=device)
        span = torch.tensor(np.array(space.high - space.low, np.float32),
                            device=device)

        def actions(generator):
            u = torch.rand(shape + tuple(space.shape), generator=generator,
                           device=device)
            return low + u * span

        return actions
    if isinstance(space, Discrete):
        heads = [space.n]
    elif isinstance(space, MultiDiscrete):
        heads = [int(n) for n in space.nvec]
    else:
        raise NotImplementedError(repr(space))

    def actions(generator):
        return torch.stack(
            [torch.randint(0, n, shape, generator=generator, device=device,
                           dtype=torch.int32) for n in heads], dim=-1)

    return actions


def _env_only_step_fn(engine, device):
    """``env_only_step((state, checksum), generator)`` over every replica
    of ``engine``."""
    random_actions = random_actions_fn(engine, device)

    @torch.no_grad()
    def env_only_step(carry, generator, out=None):
        """Random-action env step + observation + auto-reset (into ``out``,
        the static state, where given).  The obs checksum keeps the
        observation an output of the step."""
        state, checksum = carry
        actions = random_actions(generator)
        checksum = checksum + engine.observe(state).sum()
        state = engine.step_physics(state, actions)
        return engine.auto_reset(state, generator, out=out), checksum

    return env_only_step


def build_flagship(num_envs: int = 64, fc_dims=(256, 256), seed: int = 0,
                   knn_algorithm: str | None = None, device="cuda"):
    """
    Build the flagship TagContinuous system on ``device``.

    :returns: dict with ``engine``, ``env``, ``models`` (per-policy
        ``FullyConnected``), ``params`` (their ``state_dict``s), ``state``
        (the batched rollout state), ``policy_ids``, the step functions
        ``full_loop_step(models, state, generator)`` and
        ``env_only_step((state, checksum), generator)``, ``num_envs`` and
        ``num_agents``.
    """
    from warpdrive_tpu_torch.envs import register_all_envs
    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous

    device = resolve_device(device)
    register_all_envs()
    kwargs = dict(FLAGSHIP_ENV_KWARGS)
    # seed the env too: the tagger set and the starting layout are drawn at
    # construction, so two builds with one seed observe alike
    kwargs["seed"] = seed
    kwargs["knn_algorithm"] = knn_algorithm or "pallas_flat_exact"
    env = TorchTagContinuous(**kwargs)
    engine = EnvEngine(env_obj=env, num_envs=num_envs, seed=seed,
                       device=device)

    policy_ids = {
        "runner": np.where(env.agent_types == 0)[0].astype(np.int32),
        "tagger": np.where(env.agent_types == 1)[0].astype(np.int32),
    }
    heads = [int(n) for n in env.action_space[0].nvec]  # (accel, turn)
    obs_dim = engine.state[_OBS].shape[-1]

    init_gen = torch.Generator(device=device)
    init_gen.manual_seed(seed)
    models = {
        tag: FullyConnected(obs_dim, fc_dims, heads, generator=init_gen,
                            device=device)
        for tag in sorted(policy_ids)
    }
    n_agents = engine.n_agents
    ids_t = {t: torch.as_tensor(v, dtype=torch.long, device=device)
             for t, v in policy_ids.items()}

    rollout_state = _rollout_state(engine)

    def _policy_actions(models, obs_all, generator):
        actions = torch.zeros((num_envs, n_agents, len(heads)),
                              dtype=torch.int32, device=device)
        for tag in sorted(ids_t):
            ids = ids_t[tag]
            logits_list, _ = models[tag](obs_all[:, ids])
            actions[:, ids, :] = sample_heads(logits_list, generator)
        return actions

    @torch.no_grad()
    def full_loop_step(models, state, generator, out=None):
        """One full loop step: obs + policy + sample + step + reset (into
        ``out``, the static state, where given)."""
        obs_all = engine.observe(state)
        actions = _policy_actions(models, obs_all, generator)
        state = engine.step_physics(state, actions)
        return engine.auto_reset(state, generator, out=out)

    env_only_step = _env_only_step_fn(engine, device)

    return {
        "engine": engine,
        "env": env,
        "models": models,
        "params": {t: m.state_dict() for t, m in models.items()},
        "state": rollout_state,
        "policy_ids": policy_ids,
        "full_loop_step": full_loop_step,
        "env_only_step": env_only_step,
        "num_envs": num_envs,
        "num_agents": n_agents,
    }


def build_many_agents(num_envs: int = 256, seed: int = 0,
                      knn_algorithm: str = "pallas_flat_exact",
                      device="cuda"):
    """
    Build the 1024-agent TagContinuous configuration on ``device``
    (:data:`MANY_AGENT_ENV_KWARGS`, env and engine seeded with ``seed``).

    :returns: dict with ``engine``, ``env``, ``state`` (the batched rollout
        state), ``env_only_step((state, checksum), generator)``,
        ``num_envs`` and ``num_agents``.
    """
    from warpdrive_tpu_torch.envs import register_all_envs
    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous

    device = resolve_device(device)
    register_all_envs()
    env = TorchTagContinuous(**MANY_AGENT_ENV_KWARGS, seed=seed,
                             knn_algorithm=knn_algorithm)
    engine = EnvEngine(env_obj=env, num_envs=num_envs, seed=seed,
                       device=device)
    return {
        "engine": engine,
        "env": env,
        "state": _rollout_state(engine),
        "env_only_step": _env_only_step_fn(engine, device),
        "num_envs": num_envs,
        "num_agents": engine.n_agents,
    }


def build_env_only_loop(env_name: str, num_envs: int, seed: int = 0,
                        device="cuda", **env_kwargs):
    """
    Build the env-only loop of a registered full-step env (its ``step_fn``
    writes the observations) on ``device``: ``env_kwargs`` configure the
    env, which is seeded with ``seed`` as the engine is.

    :returns: dict with ``engine``, ``env``, ``state`` (the engine's batched
        state), ``env_only_step((state, checksum), generator)`` -- random
        device actions, the whole step, the observations' sum added to the
        checksum, then the auto-reset (with reset pools, the refresh of the
        reset envs' observations) --, ``num_envs`` and ``num_agents``.
    """
    from warpdrive_tpu_torch.envs import register_all_envs
    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.utils.env_registrar import env_registrar

    device = resolve_device(device)
    register_all_envs()
    env = env_registrar.get(env_name, backend="torch")(seed=seed,
                                                       **env_kwargs)
    engine = EnvEngine(env_obj=env, num_envs=num_envs, seed=seed,
                       device=device)
    assert not engine.has_split_step, f"{env_name} takes the split path"
    random_actions = random_actions_fn(engine, device)

    @torch.no_grad()
    def env_only_step(carry, generator, out=None):
        """Random-action step + auto-reset (into ``out``, the static state,
        where given); the obs checksum keeps the observation write an
        output of the step."""
        state, checksum = carry
        state = engine.step(state, random_actions(generator))
        checksum = checksum + state[_OBS].sum()
        return engine.auto_reset(state, generator, out=out), checksum

    return {
        "engine": engine,
        "env": env,
        "state": dict(engine.state),
        "env_only_step": env_only_step,
        "num_envs": num_envs,
        "num_agents": engine.n_agents,
    }


def captured_loop(system: dict, loop: str, generator: torch.Generator,
                  state: dict = None, pool=None) -> Program:
    """The captured form of ``system[loop]`` (``"env_only_step"`` of any
    of this module's systems, or ``"full_loop_step"`` of
    :func:`build_flagship`'s): a :class:`Program` over the carry
    ``{"state": ..., "checksum": ...}`` (its ``buffers``) that advances it
    one step a call, drawing from ``generator``; ``program.buffers
    ["state"]`` and ``["checksum"]`` are the carry.

    The carry's state is the engine's own, pinned
    (``EnvEngine.pin_state``): the program and the engine's facade share
    it.  ``state``, when given, is written into it first; the checksum
    starts at 0 (``full_loop_step`` leaves it there).

    A step that takes ``out`` (every step of this module) resets straight
    into the carry's state, which the write-back then finds in place.  A
    step without it is written back entry by entry: the only such step is
    the one ``portbench/tests/test_portbench_faults.py`` plants in place of
    ``env_only_step``, and once it takes ``out`` this fork goes."""
    engine = system["engine"]
    step = system[loop]
    carry = {"state": engine.pin_state(list(system["state"])),
             "checksum": torch.zeros((), dtype=torch.float32,
                                     device=engine.device)}
    if state is not None:
        assign_state(carry["state"], state)
    buffers = dict(carry)
    into = ({"out": carry["state"]}
            if "out" in inspect.signature(step).parameters else {})
    if loop == "full_loop_step":
        models = system["models"]
        buffers["models"] = {tag: list(m.parameters())
                             for tag, m in models.items()}

        def body():
            assign_state(carry["state"],
                         step(models, carry["state"], generator, **into))
    elif loop == "env_only_step":
        def body():
            new, checksum = step((carry["state"], carry["checksum"]),
                                 generator, **into)
            assign_state(carry["state"], new)
            carry["checksum"].copy_(checksum)
    else:
        raise ValueError(f"no captured form of {loop!r}")
    return Program(body, buffers, engine.device, generators=[generator],
                   pool=pool, name=f"captured {loop}")
