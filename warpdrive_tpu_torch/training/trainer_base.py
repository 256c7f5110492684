"""
TrainerBase: shared training infrastructure.

The port's counterpart of ``warpdrive_tpu/training/trainer_base.py``:

* config unpack and batch algebra: ``training_batch_size_per_env =
  train_batch_size // num_envs`` and ``num_iters = num_episodes *
  episode_length // train_batch_size``;
* the policy -> agent-id map, ``policies_to_train`` and seeding (one
  ``torch.Generator`` on the engine's device in place of the PRNG key, and
  a second one for evaluation and episode fetching, so that neither moves
  the training draws);
* the results directory with ``run_config.json`` and ``results.json``,
  :class:`Metrics`, :class:`PerfStats` and the ``train()`` loop, with the
  ``trainer.evaluator`` flag's "(test)" metrics at log points;
* per-policy checkpoints as torch ``state_dict`` files whose names carry
  the timestep, and full-state checkpoints (everything the next iteration
  reads) for a resume that is bit for bit on one device;
* ``evaluate_episodes``, ``fetch_episode_states`` and
  ``fetch_logged_episode``: one episode of the current policy from a
  forced reset of the engine's own state, which the trainer's rollout
  state (``_env_state``) does not share;
* ``profile_phases``: the iteration, the rollout and the update timed
  apart, and ``profile_trace``: a ``torch.profiler`` trace of iterations
  with the tracer's spans in it, each with the training state restored
  afterwards; ``graceful_close``.

With the tracer on (``core/trace.py``), ``train()`` records the spans
``train.iteration``, ``train.sync``, ``train.log_point`` and
``train.checkpoint``, and every iteration ``rollout`` and ``update``, whose
device extents are the iteration's three phase marks.

An iteration runs the programs (``_iteration_programmed``): the
counterpart of the JAX trainer's jitted iteration -- the metrics-free (hot)
programs on every iteration but the first and the log points, which run
the full ones, as the JAX ``train()`` chooses between
``_iteration_fn_fast`` and ``_iteration_fn``
(``warpdrive_tpu/training/trainer_base.py:505-519``); on the eager
host-env backend the rollout steps the host and the update is programmed.
On a card the programs are captured CUDA graphs (``_programmed``), but
under a gloo process mesh, whose collectives run on the host; there, and
on the CPU, every program calls its body (``core.program.plain_calls``).
The loop reads the metric tensors (which waits for the device) at log
points only, and waits for the device every ``trainer.dispatch_sync_freq``
iterations (default 50, as in JAX), so that the host runs at most that far
ahead of it.  Evaluation and episode fetching step static buffers with a
program a step (the JAX package's jitted episode scans, cached by mode and
by what is recorded), and ``train()`` builds the evaluator's before the
first iteration when ``trainer.evaluator`` is on.

Every placeholder mode of the engine is read through
``_policy_obs_and_mask``: a policy's observations flattened to ``(E, A_p,
F)`` (shared Box or Dict, separate Box or Dict, agent-dim-first or -last),
with its action mask ``(E, A_p, M)`` from a Dict's ``action_mask`` key or a
shared ``action_mask`` state array.

On the eager host-env backend (an engine with ``is_eager``,
:class:`~warpdrive_tpu_torch.envs.cpu_engine.CpuEnvEngine`) the rollout
steps the engine itself, one host step a rollout step; evaluation and
episode fetching run on the live engine between a snapshot of it and its
restore; the episode logger and full-state checkpoints need the device
engine and raise there, as the JAX package asserts.

Under a process mesh (an engine sharded by
``parallel.mesh.apply_env_sharding``; the JAX trainer's ``engine.mesh``)
every rank trains on its env rows: ``num_envs``, ``train_batch_size`` and
``num_episodes`` stay global.  The model init draws from the shared config
seed (a lazily drawn seed is rank 0's) and the parameters are then
broadcast from rank 0; the rollout, reset, evaluation and downsampling
draws come from a per-rank stream (``seed + 1000 * env rank``), so that no
two ranks draw the same noise.  Metrics, episodic sums and counts, and the
evaluation's and fetching's arrays are global; only the lead rank writes
files, and every rank joins what they gather.  Full-state checkpoints are
written and read in the single-process format, the env rows gathered, so a
file of W ranks resumes on any number of ranks that divides the envs.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time

import numpy as np
import torch

from warpdrive_tpu_torch.core import trace
from warpdrive_tpu_torch.core.episode_log import EpisodeLogger
from warpdrive_tpu_torch.core.program import (
    Program,
    assign_state,
    plain_calls,
)
from warpdrive_tpu_torch.core.trace import DeviceClock
from warpdrive_tpu_torch.models.fully_connected import params_from_flax
from warpdrive_tpu_torch.parallel.mesh import (
    Deferred,
    MetricOps,
    gather_carry,
    reduce_metrics,
    shard_carry,
    to_host,
)
from warpdrive_tpu_torch.training.data_loader import policy_agent_groups
from warpdrive_tpu_torch.utils import flax_msgpack
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.spaces import (
    Box,
    DictSpace,
    Discrete,
    MultiDiscrete,
    get_flattened_obs_size,
)

_OBS = Constants.OBSERVATIONS
_ACTIONS = Constants.ACTIONS
_DONE = Constants.DONE
_REWARDS = Constants.REWARDS


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` a config names, e.g. ``"bfloat16"``."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a dtype: {name!r}")
    return dtype


class Metrics:
    """Pretty-printing of metric dicts."""

    @staticmethod
    def pretty_print(metrics: dict):
        for policy, metric_dict in metrics.items():
            print("=" * 60)
            print(f"Metrics for policy '{policy}'")
            print("=" * 60)
            for key, value in metric_dict.items():
                print(f"{key:50}: {value:10.5f}")
        print("=" * 60, flush=True)


class PerfStats:
    """
    Iteration timing and throughput, window-based as in the JAX package:
    the trainer adds a window at each log point, after waiting for the
    device, so every second counted is device-complete.  Per-phase times
    (rollout, update) come from marks on the device's own clock;
    ``phase_breakdown`` holds what ``TrainerBase.profile_phases`` last
    measured.
    """

    def __init__(self):
        self.iters = 0
        self.steps = 0
        self.total_time = 0.0
        self.phase_ms = {"rollout": 0.0, "update": 0.0}
        self.phase_breakdown = {}

    def add_window(self, iters: int, steps: int, elapsed: float,
                   phase_ms: dict):
        self.iters += iters
        self.steps += steps
        self.total_time += elapsed
        for phase, ms in phase_ms.items():
            self.phase_ms[phase] += ms

    def get_perf_stats(self) -> dict:
        if self.iters == 0:
            return {}
        return {
            "Mean total time per iter (ms)": 1000.0 * self.total_time / self.iters,
            "Mean steps per sec (total)": self.steps / max(self.total_time, 1e-9),
            "Rollout time per iter (ms)": self.phase_ms["rollout"] / self.iters,
            "Update time per iter (ms)": self.phase_ms["update"] / self.iters,
            **self.phase_breakdown,
        }

    def pretty_print(self):
        print("=" * 60)
        print("Speed performance stats")
        print("=" * 60)
        for k, v in self.get_perf_stats().items():
            print(f"{k:50}: {v:10.2f}")
        print("=" * 60, flush=True)


class TrainerBase:
    """Common trainer machinery; an algorithm subclass provides its
    rollout step's head (``_rollout_step``), ``_build_programs``,
    ``_rollout_programmed(timestep)`` and ``_update_programmed(timestep,
    full)``."""

    def __init__(
        self,
        env_wrapper=None,
        config=None,
        policy_tag_to_agent_id_map=None,
        create_separate_placeholders_for_each_policy=False,
        obs_dim_corresponding_to_num_agents="first",
        num_devices=1,
        device_id=0,
        results_dir=None,
        verbose=True,
    ):
        assert env_wrapper is not None and config is not None
        self.engine = env_wrapper
        self.device = self.engine.device
        # the process mesh the engine's env rows are cut over, if any
        self.mesh = getattr(self.engine, "mesh", None)
        if int(num_devices) > 1 and self.mesh is None:
            raise ValueError(
                f"num_devices={num_devices} needs an engine sharded with "
                "parallel.mesh.apply_env_sharding inside a process group of "
                "that many ranks (parallel.launch.launch, or the CLI's -n)")
        self.env_rows = getattr(self.engine, "env_rows",
                                slice(0, self.engine.n_envs))
        self.local_envs = self.env_rows.stop - self.env_rows.start
        # the placeholder layout is the engine's; the flags must agree
        if bool(create_separate_placeholders_for_each_policy) != \
                self.engine.separate_placeholders:
            raise ValueError(
                "create_separate_placeholders_for_each_policy="
                f"{create_separate_placeholders_for_each_policy} but the "
                f"engine was built with {self.engine.separate_placeholders}; "
                "pass the same flag (and the policy_tag_to_agent_id_map) to "
                "EnvEngine"
            )
        assert obs_dim_corresponding_to_num_agents == \
            self.engine.obs_dim_corresponding_to_num_agents, (
                "engine stores obs with agent dim "
                f"{self.engine.obs_dim_corresponding_to_num_agents!r} but the "
                f"trainer was asked for {obs_dim_corresponding_to_num_agents!r}"
            )
        self.obs_dim_corresponding_to_num_agents = (
            obs_dim_corresponding_to_num_agents)
        self.config = config
        self.verbose = verbose
        self.device_id = int(device_id)

        # ---------------- config unpack and batch algebra -------------------
        trainer_cfg = config["trainer"]
        # the eager host-env backend: numpy envs stepped on the host, one
        # step a rollout step
        self._is_eager = bool(getattr(self.engine, "is_eager", False))
        self.num_envs = int(trainer_cfg["num_envs"])
        assert self.num_envs == self.engine.n_envs
        self.num_episodes = int(trainer_cfg["num_episodes"])
        self.train_batch_size = int(trainer_cfg["train_batch_size"])
        # the dtype the training batch stores observations in
        self.batch_dtype = torch_dtype(trainer_cfg.get("batch_dtype",
                                                       "float32"))
        self.n_step = int(trainer_cfg.get("n_step", 1))
        self.use_evaluator = bool(trainer_cfg.get("evaluator", False))
        self.neg_pos_env_ratio = float(trainer_cfg.get("neg_pos_env_ratio", -1))
        # train() waits for the device every this many iterations (0:
        # never between log points), as the JAX trainer does
        self.dispatch_sync_freq = int(trainer_cfg.get("dispatch_sync_freq",
                                                      50))
        # on a card the programs (core/program.py) are captured: the update
        # on every engine, the rollout too on the device engine; under a
        # gloo process mesh alone they call their bodies, since gloo's
        # collectives run on the host and no graph can hold them
        cuda = self.device.type == "cuda"
        gloo = self.mesh is not None and self.mesh.backend != "nccl"
        self._programmed = cuda and not gloo
        if cuda and gloo:
            logging.info("program: eager (gloo process mesh)")

        self.episode_length = self.engine.episode_length
        self.training_batch_size_per_env = self.train_batch_size // self.num_envs
        assert self.training_batch_size_per_env > 0, (
            "train_batch_size must be >= num_envs"
        )
        total_timesteps = self.num_episodes * self.episode_length
        self.num_iters = int(total_timesteps // self.train_batch_size)
        if self.num_iters == 0:
            raise ValueError(
                "Not enough episodes to even perform a single training "
                "iteration; increase num_episodes."
            )

        # ---------------- policies ------------------------------------------
        self.policies = sorted(config["policy"].keys())
        self.policies_to_train = [
            p for p in self.policies if config["policy"][p].get("to_train", False)
        ]
        if policy_tag_to_agent_id_map is None:
            assert len(self.policies) == 1, (
                "multiple policies need an explicit policy_tag_to_agent_id_map"
            )
            policy_tag_to_agent_id_map = {
                self.policies[0]: list(range(self.engine.n_agents))
            }
        self.policy_tag_to_agent_id_map = policy_agent_groups(
            policy_tag_to_agent_id_map, self.engine.n_agents,
            self.engine.observation_space, self.engine.action_space,
        )
        self._agent_ids = {
            tag: torch.as_tensor(ids, dtype=torch.long, device=self.device)
            for tag, ids in self.policy_tag_to_agent_id_map.items()
        }
        self.obs_space = {}
        self.act_space = {}
        for tag, ids in self.policy_tag_to_agent_id_map.items():
            first = int(ids[0])
            self.obs_space[tag] = self.engine.observation_space[first]
            self.act_space[tag] = self.engine.action_space[first]

        # ---------------- seeding --------------------------------------------
        seed = trainer_cfg.get("seed")
        if seed is None:
            seed = np.random.randint(10_000_000)
            if self.mesh is not None:  # every rank's own draw: rank 0's
                seed = int(self.mesh.broadcast(torch.tensor(
                    [seed], dtype=torch.int64, device=self.device))[0])
        self.seed = int(seed) + self.device_id
        # the rollout's draws: a stream of each env rank's own
        env_rank = 0 if self.mesh is None else self.mesh.env_rank
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed + 1000 * env_rank)
        # evaluation and episode fetching draw from their own generator
        self.eval_generator = torch.Generator(device=self.device)
        self.eval_generator.manual_seed(self.seed + 1000 * env_rank + 1)

        # ---------------- saving / metrics ----------------------------------
        saving_cfg = config["saving"]
        self.metrics_log_freq = int(saving_cfg.get("metrics_log_freq", 100))
        self.model_params_save_freq = int(
            saving_cfg.get("model_params_save_freq", 1000)
        )
        if results_dir is None:
            results_dir = os.path.join(
                saving_cfg.get("basedir", "/tmp"),
                saving_cfg.get("name", "default"),
                saving_cfg.get("tag", "experiment"),
                str(int(time.time())),
            )
        self.save_dir = results_dir
        # only the lead rank writes files
        self.is_lead = self.mesh is None or self.mesh.is_lead
        if self.is_lead:
            os.makedirs(self.save_dir, exist_ok=True)
            with open(os.path.join(self.save_dir, "run_config.json"), "w",
                      encoding="utf-8") as f:
                json.dump(config, f, indent=2, default=str)

        self.perf_stats = PerfStats()
        self.metrics = Metrics()
        self.clock = DeviceClock(self.device)
        # (rollout start, rollout end, update end) marks of the iterations
        # since the last log point, and every iteration's resolved
        # (rollout ms, update ms)
        self._pending_marks = []
        self.phase_ms = []
        self.current_timestep = 0
        self.iters_completed = 0
        self.models = {}
        # the rollout's step counter (the batch row a step writes) and the
        # episodic accounting: the running sums of each env and agent, and
        # every finished episode's reward and count
        self._row = torch.zeros((1,), dtype=torch.long, device=self.device)
        self._ep_acc = torch.zeros((self.local_envs, self.engine.n_agents),
                                   dtype=torch.float32, device=self.device)
        self._ep_sum = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
        self._ep_count = torch.zeros((), dtype=torch.float32,
                                     device=self.device)
        # the iteration's programs (built at the first iteration), the
        # episode programs (evaluation, fetching, logging) and their static
        # episode state, made at first use, and each kind's graph pool
        self._programs = self._episode_programs = None
        self._episode_bufs = None
        self._pools = {}

        logging.info(
            "TrainerBase: %d envs x %d agents, batch/env=%d, iters=%d, seed=%d",
            self.num_envs, self.engine.n_agents,
            self.training_batch_size_per_env, self.num_iters, self.seed,
        )

    # ------------------------------------------------------------ utilities
    def _rollout_env_state(self) -> dict:
        """The env state carried through the rollout: copies of the
        engine's entries, the trainer's own.  On the split path
        observations are recomputed from it each step and actions are
        handed to the physics, so neither placeholder is carried; a full
        step writes both, so there they are."""
        split = self.engine.has_split_step
        return {
            k: v.clone() for k, v in self.engine.state.items()
            if not (split and k in (_OBS, _ACTIONS))
        }

    def _reshape_flatten(self, arr: torch.Tensor, num_agents: int
                         ) -> torch.Tensor:
        """``(E, A, *feat)``, or agent-dim-last ``(E, feat, A)``, to ``(E,
        A, flat)``; a last-layout array of scalar features ``(E, A)`` only
        takes its feature axis."""
        E = arr.shape[0]
        if self.obs_dim_corresponding_to_num_agents == "last":
            if arr.ndim <= 2:
                arr = arr.reshape(E, num_agents, -1)
            else:
                arr = torch.movedim(arr, -1, 1)
        return arr.reshape(E, num_agents, -1)

    def _gather_policy_mask(self, env_state: dict, tag: str):
        """The policy's rows of a shared ``action_mask`` state array (1
        keep, 0 forbid, concatenated over the action components) as
        float32, or None when the env has none."""
        mask = env_state.get(Constants.ACTION_MASK)
        if mask is None:
            return None
        return torch.index_select(mask, 1, self._agent_ids[tag]).to(
            torch.float32)

    def _policy_obs_and_mask(self, env_state: dict, obs_all, tag: str):
        """One policy's flattened observations ``(E, A_p, F)`` and action
        mask ``(E, A_p, M)`` or None, in every placeholder mode:

        * shared Box: the policy's agents of ``observations``, or of
          ``obs_all`` where given (the split path's ``observe``);
        * shared Dict: every ``observations_<key>`` flattened and
          concatenated on the feature axis in key order, then the policy's
          agents; the ``action_mask`` key is the mask, not a feature;
        * separate mode: the same from ``observations_<tag>[_<key>]``,
          which hold the policy's agents only.

        Without a Dict mask a shared ``action_mask`` state array gives it."""
        eng = self.engine
        ids = self._agent_ids[tag]
        group = eng.group_info(tag)
        num_agents = len(ids) if eng.separate_placeholders else eng.n_agents
        take = ((lambda x: x) if eng.separate_placeholders
                else (lambda x: torch.index_select(x, 1, ids)))
        mask = None
        if group["mode"] == "box":
            source = env_state[eng.obs_entry_names(tag)[0]] \
                if obs_all is None else obs_all
            obs = take(self._reshape_flatten(source, num_agents))
        else:
            parts = []
            for key, name in zip(group["keys"], eng.obs_entry_names(tag)):
                flat = self._reshape_flatten(env_state[name], num_agents)
                if key == Constants.ACTION_MASK:
                    mask = take(flat)
                else:
                    parts.append(flat)
            obs = take(parts[0] if len(parts) == 1
                       else torch.cat(parts, dim=-1))
        if mask is None:
            mask = self._gather_policy_mask(env_state, tag)
        return obs, mask

    def _policy_obs_sizes(self, tag: str):
        """``(F, M or None)``: the width of a policy's flattened
        observations (without the mask) and of its action mask."""
        space = self.obs_space[tag]
        mask = None
        if isinstance(space, DictSpace) and \
                Constants.ACTION_MASK in space.keys():
            mask = int(np.prod(space[Constants.ACTION_MASK].shape))
        elif Constants.ACTION_MASK in self.engine.state:
            mask = int(np.prod(
                self.engine.state[Constants.ACTION_MASK].shape[2:]))
        return get_flattened_obs_size(space), mask

    def _merge_actions(self, per_policy_actions: dict):
        """What the engine's step takes: the per-policy blocks themselves in
        the separate mode, else the all-agent tensor."""
        if self.engine.separate_placeholders:
            return per_policy_actions
        return self._scatter_actions(per_policy_actions)

    def _action_heads(self, tag: str):
        """Per-component head sizes, dtype and whether the space is Box."""
        space = self.act_space[tag]
        if isinstance(space, Discrete):
            return [space.n], torch.int32, False
        if isinstance(space, MultiDiscrete):
            return [int(n) for n in space.nvec], torch.int32, False
        if isinstance(space, Box):
            return [1] * int(space.shape[0]), torch.float32, True
        raise NotImplementedError(repr(space))

    def _scatter_actions(self, per_policy_actions: dict) -> torch.Tensor:
        """Merge per-policy ``(E, A_p, C)`` action blocks into the
        ``(E, N, C)`` all-agent tensor."""
        num_c = max(a.shape[-1] for a in per_policy_actions.values())
        first = next(iter(per_policy_actions.values()))
        actions = torch.zeros((self.local_envs, self.engine.n_agents, num_c),
                              dtype=first.dtype, device=self.device)
        for tag, acts in per_policy_actions.items():
            actions[:, self._agent_ids[tag], : acts.shape[-1]] = acts
        return actions

    def _sync(self):
        if trace.ON:
            trace.count_sync(self.device)
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- training
    def _program_calls(self):
        """The context the programs run in: captured and replayed where
        the trainer captures graphs (``_programmed``), else their bodies
        called (``plain_calls``) -- on the CPU, where a program calls its
        body anyway, and under a gloo mesh."""
        return contextlib.nullcontext() if self._programmed else plain_calls()

    def _iteration(self, timestep, full: bool = True) -> dict:
        """One training iteration through the programs, as they run here
        (``full``: the full variant, with metrics; else the hot one, which
        returns ``{}``)."""
        with self._program_calls():
            return self._iteration_programmed(timestep, full)

    def _iteration_programmed(self, timestep, full: bool = True) -> dict:
        """One iteration through the programs: the counterpart of the JAX
        trainer's jitted ``_iteration_fn`` (``full``) and its metrics-free
        twin ``_iteration_fn_fast``.  The rollout and the update run
        between the iteration's three clock marks (start, the rollout's
        end, the update's end), which are also the device extents of the
        tracer's spans ``rollout`` and ``update``; returns the update's
        metrics with the episodic reward."""
        start = self.clock.mark()
        span = (trace.begin("rollout", unit=self.iters_completed,
                            event=start) if trace.ON else 0)
        self._rollout_programmed(timestep)
        mid = self.clock.mark()
        if span:
            trace.end(span, event=mid)
            span = trace.begin("update", event=mid)
        metrics = self._update_programmed(timestep, full)
        stop = self.clock.mark()
        if span:
            trace.end(span, event=stop)
        self._pending_marks.append((start, mid, stop))
        return self._with_episodic_reward(metrics)

    def _with_episodic_reward(self, metrics: dict) -> dict:
        """Each policy's metrics with the mean episodic reward over every
        rank's episodes (none to add to a hot iteration's ``{}``)."""
        if not metrics:
            return metrics
        mean_ep_reward = MetricOps(self.mesh).out(Deferred(
            sums=[self._ep_sum, self._ep_count],
            finish=lambda s, m: s[0] / torch.clamp(s[1], min=1.0)))
        for tag in metrics:
            metrics[tag]["Mean episodic reward"] = mean_ep_reward
        return metrics

    # ------------------------------------------------------------- rollout
    def _rollout_steps(self, step):
        """The rollout: ``step(t)`` for each of its
        ``training_batch_size_per_env`` steps from batch row 0 (the device
        counter ``_row``, which each step advances), then
        :meth:`_rollout_done`."""
        self._row.zero_()
        for t in range(self.training_batch_size_per_env):
            step(t)
        self._rollout_done()

    def _rollout_done(self):
        """Keep the engine facade on the live state; on the split path
        observations and actions are not carried and keep their
        placeholders.  (The eager backend's engine holds the state.)"""
        if not self._is_eager:
            self.engine.state = {**self.engine.state, **self._env_state}

    def _step_and_record(self, state: dict, per_policy: dict,
                         records: dict):
        """The tail of a rollout step, after the policies have acted on
        ``state``: their actions ``per_policy`` merged into one env step
        (on the eager backend a host step of the engine's own state, else
        the split path's physics or the full step), each policy's rewards
        and the done flags into row ``_row`` of ``records``
        (``rewards_<tag>`` and ``done``), the episodic accounting, the
        done-driven auto-reset into the trainer's env state, and the row
        counter advanced; all in place."""
        engine = self.engine
        row = self._row
        actions = self._merge_actions(per_policy)
        if self._is_eager:  # the actions to the host, one host step
            state = engine.step_all_envs(actions)
        else:
            state = (engine.step_physics(state, actions)
                     if engine.has_split_step else engine.step(state, actions))

        rewards = engine.rewards_of(state)
        done = state[_DONE]
        for tag in self.policies:
            record = records[f"rewards_{tag}"]
            record.index_copy_(0, row, (
                state[f"{_REWARDS}_{tag}"] if engine.separate_placeholders
                else torch.index_select(rewards, 1, self._agent_ids[tag])
            )[None].to(record.dtype))
        records["done"].index_copy_(0, row, done[None].to(torch.int32))

        # episodic reward bookkeeping, in place
        acc = self._ep_acc + rewards
        done_mask = (done > 0).to(torch.float32)
        self._ep_sum.copy_(self._ep_sum + (acc.mean(dim=1)
                                           * done_mask).sum())
        self._ep_count.copy_(self._ep_count + done_mask.sum())
        self._ep_acc.copy_(acc * (1.0 - done_mask)[:, None])

        if self._is_eager:
            engine.reset_only_done_envs()
        else:
            engine.auto_reset(state, self.generator, out=self._env_state)
        row.add_(1)

    def train(self):
        """``num_iters`` iterations, metrics every ``metrics_log_freq``,
        checkpoints every ``model_params_save_freq`` and at the end: the
        full programs on the first iteration and at log points, the hot
        ones elsewhere."""
        steps_per_iter = self.training_batch_size_per_env * self.num_envs
        if self.use_evaluator and not self._is_eager:
            # the evaluator's program is built (and on a card captured)
            # before any training work, as JAX compiles its evaluator here
            # (warpdrive_tpu/training/trainer_base.py:484-490); it draws
            # from the evaluation and store generators, never the
            # training's, and its results are discarded
            self.evaluate_episodes(use_argmax=True)
        window_start = time.perf_counter()
        window_iters = 0
        first_iteration = self.iters_completed
        for iteration in range(self.iters_completed, self.num_iters):
            span = (trace.begin("train.iteration", unit=iteration)
                    if trace.ON else 0)
            log_now = (
                (iteration + 1) % self.metrics_log_freq == 0
                or iteration == self.num_iters - 1
            )
            metrics = self._iteration(
                self.current_timestep,
                full=log_now or iteration == first_iteration)
            self.current_timestep += steps_per_iter
            self.iters_completed += 1
            window_iters += 1
            if (not log_now and self.dispatch_sync_freq > 0
                    and (iteration + 1) % self.dispatch_sync_freq == 0):
                # keep the host at most this far ahead
                sub = trace.begin("train.sync") if span else 0
                self._sync()
                if sub:
                    trace.end(sub)

            if log_now:
                sub = trace.begin("train.log_point") if span else 0
                metrics_host = reduce_metrics(metrics, self.mesh)
                self._sync()
                self.perf_stats.add_window(
                    window_iters, window_iters * steps_per_iter,
                    time.perf_counter() - window_start,
                    self._resolve_phase_marks(),
                )
                if self.use_evaluator:
                    # the test-time evaluator: no action randomness
                    eval_rew, eval_steps = self.evaluate_episodes(
                        use_argmax=True)
                    for tag in metrics_host:
                        metrics_host[tag]["Mean episodic reward (test)"] = (
                            float(eval_rew[tag].mean()))
                        metrics_host[tag]["Mean episodic steps (test)"] = (
                            float(eval_steps[tag].mean()))
                self._log_metrics(metrics_host)
                if self.verbose and self.is_lead:
                    print(f"Iteration {iteration + 1}/{self.num_iters} | "
                          f"timestep {self.current_timestep:,}")
                    self.metrics.pretty_print(metrics_host)
                    self.perf_stats.pretty_print()
                if sub:
                    trace.end(sub)

            saved = (iteration + 1) % self.model_params_save_freq == 0
            if saved:
                sub = trace.begin("train.checkpoint") if span else 0
                self.save_model_checkpoint(self.current_timestep)
                if sub:
                    trace.end(sub)
            if log_now or saved:
                # logging and checkpoints stay out of the next window; a
                # checkpoint without a log discards its window
                if not log_now:
                    self._resolve_phase_marks()
                window_start = time.perf_counter()
                window_iters = 0
            if span:
                trace.end(span)

        self._sync()
        self.save_model_checkpoint(self.current_timestep)
        logging.info("Trainer exits gracefully")

    def _resolve_phase_marks(self) -> dict:
        """Per-phase ms summed over the iterations marked since the last
        call (the device has caught up with them by now)."""
        self._sync()
        total = {"rollout": 0.0, "update": 0.0}
        for start, mid, stop in self._pending_marks:
            rollout, update = self.clock.ms(start, mid), self.clock.ms(mid, stop)
            self.phase_ms.append((rollout, update))
            total["rollout"] += rollout
            total["update"] += update
        self._pending_marks = []
        return total

    def _log_metrics(self, metrics: dict):
        """Append one record to ``results.json`` (the lead rank)."""
        if not self.is_lead:
            return
        record = {
            "iterations completed": self.iters_completed,
            "num timesteps": self.current_timestep,
            "metrics": metrics,
            "speed performance stats": self.perf_stats.get_perf_stats(),
        }
        with open(os.path.join(self.save_dir, "results.json"), "a",
                  encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")

    # --------------------------------------------------------- checkpoints
    def _ckpt_path(self, policy: str, timestep: int, net: str = "") -> str:
        suffix = f"_{net}" if net else ""
        return os.path.join(self.save_dir,
                            f"{policy}{suffix}_{timestep}.state_dict")

    def save_model_checkpoint(self, timestep: int = None):
        """One ``state_dict`` file per trained policy, written by the lead
        rank (the parameters are whole on every rank: nothing to gather)."""
        timestep = self.current_timestep if timestep is None else timestep
        if not self.is_lead:
            return
        for policy in self.policies_to_train:
            torch.save(_host_state(self.models[policy]),
                       self._ckpt_path(policy, timestep))

    def load_model_checkpoint(self, ckpt_filepaths: dict):
        """Restore per-policy parameters from files whose names encode the
        saved timestep, and resume the schedules from it."""
        timesteps = set()
        for policy, path in ckpt_filepaths.items():
            if not path:
                continue
            self.models[policy].load_state_dict(self._load(path))
            timesteps.add(_timestep_of(path))
        self._resume_timestep(timesteps)

    def _load(self, path: str) -> dict:
        """A net's ``state_dict`` from ``path``: a torch file (a zip,
        ``PK``), as this package saves, or a flax msgpack file (its first
        byte opens a msgpack map), as the JAX package saves, read through
        :mod:`utils.flax_msgpack` and ``params_from_flax``."""
        with open(path, "rb") as f:
            head = f.read(2)
        if flax_msgpack.is_msgpack_map(head):
            state = params_from_flax(flax_msgpack.read_file(path))
            return {k: v.to(self.device) for k, v in state.items()}
        if head != b"PK":
            raise ValueError(f"{path}: neither a torch file nor a flax "
                             "msgpack file")
        return torch.load(path, map_location=self.device, weights_only=True)

    def _resume_timestep(self, timesteps: set):
        if timesteps:
            assert len(timesteps) == 1, "checkpoints disagree on the timestep"
            self.current_timestep = timesteps.pop()

    # ---- full-state checkpoints: everything the next iteration reads ----
    def _training_state(self) -> dict:  # pragma: no cover - subclass detail
        """The algorithm's share of a full-state checkpoint: nets,
        optimizer states, the rollout's env state and accounting."""
        raise NotImplementedError

    def _load_training_state(self, state: dict):  # pragma: no cover
        raise NotImplementedError

    def _training_state_dims(self) -> dict:
        """Under a mesh, the env-axis dim of each env-cut tensor of
        :meth:`_training_state` (the tree ``shard_carry`` and
        ``gather_carry`` cut and gather by): the rollout's env state as the
        engine cut it, and the episodic accumulator's env rows."""
        return {"env_state": {k: self.engine.env_dims[k]
                              for k in self._env_state},
                "episodes": {"acc": 0}}

    def save_full_state(self, path: str = None) -> str:
        """Write the whole training state -- parameters, optimizer moments
        and counts, the rollout's env state, episodic accounting, the
        iteration count, every generator's state, and the store's at-reset
        snapshot and reset pools (an env built without a seed draws its own)
        -- so that a fresh trainer built from the same config resumes
        exactly where this one stands.  Returns the path.  Not on the eager
        backend, whose env state is Python objects.

        Under a mesh every rank must call this: the file is the
        single-process format, with every rank's env rows gathered and the
        episodic sums and counts summed (the lead rank writes it); the
        generators are the lead's, and ``rank_generators`` holds each env
        rank's, which a run on as many env ranks takes back."""
        self._assert_device_engine("full-state checkpointing")
        path = path or os.path.join(
            self.save_dir, f"full_state_{self.current_timestep}.ckpt")
        store = self.engine.store
        training = self._training_state()
        generators = self._generator_states()
        rank_generators = [generators]
        if self.mesh is not None:
            training = gather_carry(training, self.mesh,
                                    self._training_state_dims())
            training["episodes"] = {
                **training["episodes"],
                **{k: self.mesh.all_reduce(training["episodes"][k].clone())
                   for k in ("sum", "count")}}
            rank_generators = self._gather_generator_states(generators)
        payload = {
            "training": training,
            "resets": {"snapshot": store.snapshot, "pools": store.pools},
            "current_timestep": self.current_timestep,
            "iters_completed": self.iters_completed,
            "generators": generators,
            "rank_generators": rank_generators,
        }
        if self.is_lead:
            torch.save(_to_host(payload), path)
        return path

    def _generators(self) -> dict:
        return {"trainer": self.generator, "eval": self.eval_generator,
                "store": self.engine.store.generator}

    def _generator_states(self) -> dict:
        return {k: g.get_state() for k, g in self._generators().items()}

    def _gather_generator_states(self, states: dict) -> list:
        """Every env rank's generator states, in env-rank order."""
        names = list(states)
        sizes = [states[k].numel() for k in names]
        flat = torch.cat([states[k] for k in names])
        every = self.mesh.all_gather(flat).reshape(self.mesh.dp, -1)
        out = []
        for row in every:
            parts = torch.split(row, sizes)
            out.append({k: p.clone() for k, p in zip(names, parts)})
        return out

    def load_full_state(self, path: str):
        """Restore a :meth:`save_full_state` checkpoint, written on any
        number of ranks.  Under a mesh each rank keeps its env rows, the
        lead env rank the episodic sums and counts, and each env rank takes
        its own generators when the file holds as many; otherwise env rank
        0 takes the file's and every other env rank a stream of its own
        derived from the seed and the iteration."""
        self._assert_device_engine("full-state checkpointing")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        training = payload["training"]
        env_rank, dp = 0, 1
        if self.mesh is not None:
            env_rank, dp = self.mesh.env_rank, self.mesh.dp
            training = shard_carry(training, self.mesh, self.num_envs,
                                   self._training_state_dims())
            if env_rank:
                training["episodes"] = {
                    **training["episodes"],
                    **{k: torch.zeros_like(training["episodes"][k])
                       for k in ("sum", "count")}}
        self._load_training_state(_to_device(training, self.device))
        # in place: the engine's reset function holds these tensors
        store = self.engine.store
        for kind, saved in payload["resets"].items():
            live = getattr(store, kind)
            assert live.keys() == saved.keys(), f"{kind}: {sorted(saved)}"
            for name, tensor in saved.items():
                live[name].copy_(tensor)
        self.current_timestep = int(payload["current_timestep"])
        self.iters_completed = int(payload["iters_completed"])
        per_rank = payload.get("rank_generators") or []
        gens = per_rank[env_rank] if len(per_rank) == dp else \
            payload["generators"]
        for name, generator in self._generators().items():
            generator.set_state(gens[name])
            if len(per_rank) != dp and env_rank:
                generator.manual_seed(self.seed + 1000 * env_rank
                                      + 7919 * self.iters_completed
                                      + len(name))
        self.engine.state = {**self.engine.state, **self._env_state}

    # --------------------------------------------------- evaluation, fetching
    def _act_fn(self, state: dict, use_argmax: bool = True,
                generator: torch.Generator = None,
                return_logits: bool = False):  # pragma: no cover
        """All agents' actions for ``state``, ``(E, N, C)`` or in the
        separate mode ``{tag: (E, A_p, C)}`` (subclass detail): the most likely (or noise-free) action with
        ``use_argmax``, else one drawn from ``generator``.  With
        ``return_logits``, ``(actions, {tag: [(E, A_p, n_i) logits per
        action component]})`` from the same forward (categorical policies
        only)."""
        raise NotImplementedError

    def _assert_device_engine(self, what: str):
        if self._is_eager:
            raise NotImplementedError(
                f"{what} needs the device engine (EnvEngine); the eager "
                "host-env backend does not support it")

    @contextlib.contextmanager
    def _episode(self):
        """The static episode state (:meth:`_episode_state`) written from a
        forced reset of the engine's own state (not the trainer's rollout
        state), to step an episode in.  The eager backend's engine is the
        rollout's too: it is snapshot before and restored after, and its
        episode programs, which step the host, run as called
        (``plain_calls``)."""
        if not self._is_eager:
            self.engine.reset_all_envs()
            state = self._episode_state()
            assign_state(state, dict(self.engine.state))
            yield state
            return
        snap = self.engine.snapshot_runtime_state()
        try:
            with plain_calls():
                self.engine.reset_all_envs()
                state = self._episode_state()
                assign_state(state, dict(self.engine.state))
                yield state
        finally:
            self.engine.restore_runtime_state(snap)

    def _program(self, body, buffers, name: str,
                 episode: bool = False) -> Program:
        """A program of this trainer's over ``buffers``: one of the
        iteration's, drawing from ``generator``, or with ``episode`` an
        evaluation or fetching step, drawing from ``eval_generator``.  Each
        kind's programs share a graph memory pool of its own, made with its
        first program; before the iteration's first, a mesh on a card makes
        its communicators, which no capture can."""
        if episode not in self._pools:
            cuda = self.device.type == "cuda"
            self._pools[episode] = (torch.cuda.graph_pool_handle() if cuda
                                    else None)
            if cuda and self.mesh is not None and not episode:
                self.mesh.warm_up()
        return Program(body, buffers, self.device,
                       generators=[self.eval_generator if episode
                                   else self.generator],
                       pool=self._pools[episode], name=name)

    def release_programs(self):
        """Drop the captured programs (the iteration's and the episode
        programs), their memory pools and the static episode state; each is
        built and captured again at need."""
        self._programs = self._episode_programs = None
        self._episode_bufs = None
        self._pools = {}

    def _episode_state(self) -> dict:
        """The static state every episode program steps: copies of the
        engine's entries, made at the first episode."""
        if self._episode_bufs is None:
            self._episode_bufs = {k: v.clone()
                                  for k, v in self.engine.state.items()}
        return self._episode_bufs

    def _episode_program(self, key, make) -> Program:
        """The episode program of ``key`` (the counterpart of JAX's
        ``_eval_fns``/``_fetch_fns`` caches), built by ``make() -> (body,
        buffers)`` at its first use (:meth:`_program`)."""
        if self._episode_programs is None:
            self._episode_programs = {}
        program = self._episode_programs.get(key)
        if program is None:
            body, buffers = make()
            program = self._program(
                body, {"state": self._episode_state(), **buffers},
                f"episode {key}", episode=True)
            self._episode_programs[key] = program
        return program

    def _episode_step(self, state: dict, actions):
        """One step of an evaluation or fetched episode, written into the
        static ``state``: the engine's pure ``step``, or on the eager
        backend a step of the live engine."""
        if self._is_eager:
            self.engine.step_all_envs(actions)
            new = dict(self.engine.state)
        else:
            new = self.engine.step(state, actions)
        assign_state(state, new)

    def _scalar_index(self) -> torch.Tensor:
        return torch.zeros((1,), dtype=torch.long, device=self.device)

    @torch.no_grad()
    def evaluate_episodes(self, use_argmax: bool = True):
        """One episode of every env replica from a forced reset, with the
        most likely (DDPG: noise-free) actions, or with actions drawn from
        the evaluation generator.  An env's rewards and steps are summed
        while its done flag is 0: the mask is sticky, and finished envs are
        stepped on without a reset.  Each step is a call of the evaluation
        step program of the mode (``use_argmax``), over the static episode
        state and sums.

        Returns ``(episodic_reward_sum, episodic_step_sum)``: per policy,
        numpy arrays of shape ``(num_envs, num_agents_of_policy)`` and
        ``(num_envs,)``.
        """
        engine = self.engine
        E, N = self.local_envs, engine.n_agents
        use_argmax = bool(use_argmax)

        def make():
            sums = {"alive": torch.ones((E,), dtype=torch.bool,
                                        device=self.device),
                    "rew_sum": torch.zeros((E, N), dtype=torch.float32,
                                           device=self.device),
                    "step_sum": torch.zeros((E,), dtype=torch.int32,
                                            device=self.device)}
            state = self._episode_state()

            def body():
                actions = self._act_fn(state, use_argmax=use_argmax,
                                       generator=self.eval_generator)
                self._episode_step(state, actions)
                alive = sums["alive"]
                alive.copy_(alive & (state[Constants.DONE] == 0))
                sums["rew_sum"].copy_(
                    sums["rew_sum"] + engine.rewards_of(state)
                    * alive.to(torch.float32)[:, None])
                sums["step_sum"].copy_(sums["step_sum"]
                                       + alive.to(torch.int32))

            return body, {"sums": sums}

        program = self._episode_program(("evaluate", use_argmax), make)
        sums = program.buffers["sums"]
        with self._episode():
            sums["alive"].fill_(True)
            sums["rew_sum"].zero_()
            sums["step_sum"].zero_()
            for _ in range(engine.episode_length):
                program()
        # every rank's envs under a mesh
        rew_sum = to_host(sums["rew_sum"], self.mesh, 0)
        step_sum = to_host(sums["step_sum"], self.mesh, 0)
        episodic_reward_sum, episodic_step_sum = {}, {}
        for tag, ids in self.policy_tag_to_agent_id_map.items():
            episodic_reward_sum[tag] = rew_sum[:, ids]
            episodic_step_sum[tag] = step_sum.copy()
        return episodic_reward_sum, episodic_step_sum

    @torch.no_grad()
    def fetch_episode_states(
        self,
        list_of_states: list,
        env_id: int = 0,
        include_rewards_actions: bool = False,
        include_probabilities: bool = False,
    ):
        """Step one episode with the current policy (actions drawn from
        the evaluation generator; DDPG's are noise-free) from a forced
        reset, recording the named state arrays of env ``env_id``.
        Returns ``{name: (steps + 1, ...)}`` numpy arrays, the reset state
        first, up to and including the env's first done step, with
        ``"rewards"`` and ``"actions"`` (``(steps, ...)``) and, for
        categorical policies, ``"probabilities"`` ``{tag: [(steps, A_p,
        n_i) per action component]}`` (float32) of the states acted on.
        Each step is a call of the recording step program keyed by the
        names and the two flags, which writes row ``t`` (a device counter)
        of static records from the env row of a device index: another
        ``env_id`` takes the same program."""
        assert isinstance(list_of_states, list) and len(list_of_states) > 0
        engine = self.engine
        for name in list_of_states:
            assert name in engine.state, f"{name!r} is not a state array"
        owner, env_id = self._owner_of(env_id)
        L = engine.episode_length
        key = ("fetch", tuple(list_of_states), bool(include_rewards_actions),
               bool(include_probabilities))

        def make():
            state = self._episode_state()
            t, env = self._scalar_index(), self._scalar_index()

            def record(shape, dtype, rows=L):
                return torch.zeros((rows,) + tuple(shape), dtype=dtype,
                                   device=self.device)

            recs = {name: record(state[name].shape[1:], state[name].dtype,
                                 L + 1) for name in list_of_states}
            extra = {"_done": record((), torch.int32)}
            if include_rewards_actions:
                extra["_rewards"] = record((engine.n_agents,), torch.float32)
                num_c = max(len(self._action_heads(tag)[0])
                            for tag in self.policies)
                extra["_actions"] = record(
                    (engine.n_agents, num_c),
                    self._action_heads(self.policies[0])[1])
            if include_probabilities:
                for tag, ids in self.policy_tag_to_agent_id_map.items():
                    for i, n in enumerate(self._action_heads(tag)[0]):
                        extra[f"_probs_{tag}_{i}"] = record(
                            (len(ids), n), torch.float32)

            def body():
                if include_probabilities:
                    actions, logits_of = self._act_fn(
                        state, use_argmax=False,
                        generator=self.eval_generator, return_logits=True)
                    for tag, logits_list in logits_of.items():
                        for i, logits in enumerate(logits_list):
                            extra[f"_probs_{tag}_{i}"].index_copy_(
                                0, t, torch.softmax(
                                    logits.index_select(0, env), dim=-1)
                                .to(torch.float32))
                else:
                    actions = self._act_fn(state, use_argmax=False,
                                           generator=self.eval_generator)
                self._episode_step(state, actions)
                for name in list_of_states:
                    recs[name].index_copy_(
                        0, t + 1, state[name].index_select(0, env))
                if include_rewards_actions:
                    extra["_rewards"].index_copy_(
                        0, t, engine.rewards_of(state).index_select(0, env))
                    if isinstance(actions, dict):  # the separate mode
                        actions = self._scatter_actions(actions)
                    extra["_actions"].index_copy_(
                        0, t, actions.index_select(0, env).to(
                            extra["_actions"].dtype))
                extra["_done"].index_copy_(
                    0, t, state[Constants.DONE].index_select(0, env))
                t.add_(1)

            return body, {"recs": recs, "extra": extra, "t": t, "env": env}

        program = self._episode_program(key, make)
        bufs = program.buffers
        with self._episode() as state:
            bufs["t"].zero_()
            bufs["env"].fill_(env_id)
            for name, rec in bufs["recs"].items():
                rec[0] = state[name][env_id]
            for _ in range(L):
                program()

        host = {key: self._from_owner(v.clone(), owner).cpu().numpy()
                for key, v in {**bufs["recs"], **bufs["extra"]}.items()}
        done_t = host["_done"] > 0
        end = int(np.argmax(done_t)) + 1 if done_t.any() else L
        out = {name: host[name][: end + 1] for name in list_of_states}
        if include_rewards_actions:
            out["rewards"] = host["_rewards"][:end]
            out["actions"] = host["_actions"][:end]
        if include_probabilities:
            out["probabilities"] = {
                tag: [host[f"_probs_{tag}_{i}"][:end]
                      for i in range(len(self._action_heads(tag)[0]))]
                for tag in self.policies
            }
        return out

    @torch.no_grad()
    def fetch_logged_episode(self, env_id: int = 0):
        """Dense per-timestep trajectories of every state array the env
        flagged ``log_data_across_episode``, for env ``env_id``, recorded on
        the device by :class:`EpisodeLogger` over one episode of the most
        likely (DDPG: noise-free) actions from a forced reset.  Each step is
        logged up to and including the env's first done step, then no
        more, so the log mask stays contiguous.  Each step is a call of the
        logging step program (``EpisodeLogger.log_step_into`` at a device
        counter, the env row from a device index).  Returns ``{name:
        (last_step + 1, ...)}`` numpy arrays.  On the eager backend use
        :meth:`fetch_episode_states`."""
        self._assert_device_engine("fetch_logged_episode")
        engine = self.engine
        logger = EpisodeLogger(engine.store)
        assert logger.log_names, (
            "no state array was pushed with log_data_across_episode=True"
        )
        owner, env_id = self._owner_of(env_id)

        def make():
            state = self._episode_state()
            t, env = self._scalar_index(), self._scalar_index()
            logs = logger.init_buffers(state, 0)
            done_t = torch.zeros((engine.episode_length,), dtype=torch.int32,
                                 device=self.device)
            done_seen = torch.zeros((1,), dtype=torch.bool,
                                    device=self.device)

            def body():
                actions = self._act_fn(state, use_argmax=True,
                                       generator=self.eval_generator)
                self._episode_step(state, actions)
                logger.log_step_into(logs, state, t, env, frozen=done_seen)
                done = state[Constants.DONE].index_select(0, env)
                done_t.index_copy_(0, t - 1, done)
                done_seen.copy_(done_seen | (done > 0))
                t.add_(1)

            return body, {"logs": logs, "done_t": done_t,
                          "done_seen": done_seen, "t": t, "env": env}

        program = self._episode_program("log", make)
        bufs = program.buffers
        with self._episode() as state:
            logger.reset_buffers(bufs["logs"], state, env_id)
            bufs["t"].fill_(1)
            bufs["env"].fill_(env_id)
            bufs["done_seen"].zero_()
            for _ in range(engine.episode_length):
                program()
        logs = {k: self._from_owner(v.clone(), owner)
                for k, v in bufs["logs"].items()}
        done_t = self._from_owner(bufs["done_t"].clone(),
                                  owner).cpu().numpy() > 0
        last_step = int(np.argmax(done_t)) + 1 if done_t.any() else \
            engine.episode_length
        return logger.fetch(logs, last_step)

    def _owner_of(self, env_id: int):
        """``(env rank holding global env row env_id, its local row)``;
        every other rank records its row 0 and takes the owner's record
        (:meth:`_from_owner`)."""
        if self.mesh is None:
            return 0, env_id
        owner = self.mesh.env_rank_of_row(env_id, self.num_envs)
        local = env_id - self.env_rows.start
        return owner, (local if owner == self.mesh.env_rank else 0)

    def _from_owner(self, x: torch.Tensor, owner: int) -> torch.Tensor:
        if self.mesh is None:
            return x
        return self.mesh.broadcast(x.contiguous(), src=owner, axis="env")

    # ------------------------------------------------------------ profiling
    def _phase_fns(self, timestep):
        """``(iteration, rollout, update)`` as the profilers run them,
        without phase marks: the hot programs, run as :meth:`_iteration`
        runs them."""
        def rollout():
            with self._program_calls():
                self._rollout_programmed(timestep)

        def update():
            with self._program_calls():
                self._update_programmed(timestep, full=False)

        def iteration():
            rollout()
            update()

        return iteration, rollout, update

    @contextlib.contextmanager
    def _state_restored(self):
        """Run the body, then restore the models, optimizer states,
        rollout env state (on the eager backend, the engine's envs),
        episodic accounting and generators, in place: training goes on as
        if the body had not run."""
        saved = _clone_tree(self._training_state())
        engine = self.engine
        engine_state = (engine.snapshot_runtime_state() if self._is_eager
                        else _clone_tree(dict(engine.state)))
        store = getattr(engine, "store", None)  # none on the eager backend
        generators = (self.generator.get_state(),
                      None if store is None else store.generator.get_state())
        try:
            yield
        finally:
            self._load_training_state(saved)
            if self._is_eager:
                engine.restore_runtime_state(engine_state)
            else:
                engine.state = engine_state
            self.generator.set_state(generators[0])
            if store is not None:
                store.generator.set_state(generators[1])

    def profile_phases(self, repeats: int = 3) -> dict:
        """Time an iteration, a rollout and an update apart, each after one
        warm-up call and then ``repeats`` times: iterations chained as
        ``train()`` runs them, rollouts chained from the state the last one
        left, and updates chained through their parameters on one real
        rollout batch.  It times the hot programs, which every non-log
        iteration runs, as the JAX trainer times its hot program.  Each
        repeat is timed on the device's clock (CUDA events on a card) and
        ends with a one-element host fetch.  The best repeat is reported
        beside every repeat's time, as the JAX trainer's
        ``profile_phases`` reports them:
        ``{"iteration_ms", "rollout_ms", "update_ms",
        "update_ms_residual" (max(iteration - rollout, 0)),
        "update_ms_direct", "steps_per_sec", "rollout_steps_per_sec"}``
        and the ``..._repeats`` lists.  The breakdown goes onto
        ``perf_stats``, so later logs carry it.

        The training state is restored afterwards (``_state_restored``):
        training goes on as if the call had not been made."""
        t = self.current_timestep
        steps = self.training_batch_size_per_env * self.num_envs
        iteration, rollout, update = self._phase_fns(t)

        # a parameter: updated in place, so it stays the live one
        probe = _first_tensor(self._training_state()).reshape(-1)[:1]

        def fetch():
            probe.cpu()

        def timeit(fn):
            fn()
            fetch()
            times = []
            for _ in range(repeats):
                start = self.clock.mark()
                fn()
                stop = self.clock.mark()
                fetch()
                times.append(self.clock.ms(start, stop))
            return min(times), times

        with self._state_restored():
            iter_ms, iter_reps = timeit(iteration)
            rollout_ms, rollout_reps = timeit(rollout)
            rollout()
            update_ms, update_reps = timeit(update)

        result = {
            "iteration_ms": iter_ms,
            "rollout_ms": rollout_ms,
            "update_ms": update_ms,
            "update_ms_residual": max(iter_ms - rollout_ms, 0.0),
            "update_ms_direct": True,
            "steps_per_sec": steps / (iter_ms / 1000.0),
            "rollout_steps_per_sec": steps / (rollout_ms / 1000.0),
            "iteration_ms_repeats": iter_reps,
            "rollout_ms_repeats": rollout_reps,
            "update_ms_repeats": update_reps,
            "steps_per_sec_repeats": [steps / (ms / 1000.0)
                                      for ms in iter_reps],
        }
        self.perf_stats.phase_breakdown = {
            "Profiled rollout time per iter (ms)": rollout_ms,
            "Profiled update time per iter (ms)": update_ms,
            "Profiled rollout steps per sec": result["rollout_steps_per_sec"],
        }
        return result

    def profile_trace(self, logdir: str, iterations: int = 3) -> str:
        """Write a ``torch.profiler`` trace of ``iterations`` training
        iterations -- the hot ones, which every non-log iteration runs --
        to ``logdir/trace_<timestep>.json``, a Chrome trace that
        TensorBoard and Perfetto read; the counterpart of the JAX trainer's
        ``profile_trace`` (``jax.profiler``).  One iteration runs before
        the trace (building and capturing the programs there, as JAX
        compiles outside its trace), and the training state is restored
        afterwards.  The tracer (``core/trace.py``) is on for the
        profiled iterations, so the trace carries its spans (``program.
        call``, ``update.begin``, ...) beside the kernels.  Returns the
        trace's path."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        iteration = self._phase_fns(self.current_timestep)[0]
        was_on = trace.ON
        with self._state_restored():
            iteration()
            self._sync()
            if not was_on:
                trace.enable(self.device)
            try:
                with profile(activities=activities) as prof:
                    for _ in range(iterations):
                        iteration()
                    self._sync()
            finally:
                if not was_on:
                    trace.disable()
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"trace_{self.current_timestep}.json")
        prof.export_chrome_trace(path)
        return path

    def graceful_close(self):
        """Wait for the device and log, as the JAX trainer's
        ``graceful_close`` does (there is no curand heap to free)."""
        self._sync()
        logging.info("Trainer exits gracefully")


def _host_state(module: torch.nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def _timestep_of(path: str) -> int:
    """The timestep a checkpoint's file name ends with."""
    stem = os.path.basename(path).split(".")[0]
    return int(stem.split("_")[-1])


def _clone_tree(tree):
    """Nested dicts with every tensor cloned where it lies."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def _first_tensor(tree) -> torch.Tensor:
    """The first tensor of nested dicts, depth first."""
    if isinstance(tree, torch.Tensor):
        return tree
    for value in tree.values() if isinstance(tree, dict) else ():
        found = _first_tensor(value)
        if found is not None:
            return found
    return None


def _to_host(tree):
    """Every tensor of nested dicts on the CPU, cloned."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
