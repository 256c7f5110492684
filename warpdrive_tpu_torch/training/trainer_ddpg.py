"""
TrainerDDPG: off-policy trainer for continuous (Box) action spaces.

The port's counterpart of ``warpdrive_tpu/training/trainer_ddpg.py``.  One
iteration runs on the engine's device:

  the iteration's OU noise, ``stddev * N(0, 1)`` of shape ``(T, E, A_p,
  C)`` for each policy in one draw, then a rollout of
  ``training_batch_size_per_env`` steps (:meth:`TrainerDDPG._rollout_step`,
  each writing row t of the static rows) of
      observations (split path: ``observe``; full-step path: the ones the
      last step wrote; per policy through ``_policy_obs_and_mask``, in
      every placeholder mode), the actor's action, Ornstein-Uhlenbeck
      exploration around it, the env step, rewards and done flags,
      episodic-reward bookkeeping and the done-driven auto-reset;
  the replay window: ``T + n_step - 1`` rows, each iteration
      ``cat(window[T:], rows)`` written into it, so the window's order is
      time order;
  then, per trained policy, once the window is full:
      the critic's MSE against n-step returns bootstrapped from the target
      nets, the actor's loss ``-mean Q(s, pi(s))`` through the critic's
      parameters from BEFORE this update (the critic is frozen in the actor
      update: the JAX trainer's deliberate departure from the reference,
      whose actor loss also stepped the critic), a :class:`ClippedAdam` for
      each net with its own learning-rate schedule, and Polyak updates of
      both targets toward the updated online nets.

Until the window is full neither net, neither target and neither optimizer
moves, and Adam's step count stays: the window fills by T rows an
iteration, a count the host knows, so the gate is a Python branch.

An iteration runs these as programs (``core/program.py``), the JAX
trainer's jitted iteration and its metrics-free twin: the noise draw, the
rollout step T times, the replay append and per policy the update in its
full, hot (metrics-free) or warm (metrics alone, while the window fills)
variant (``TrainerBase._iteration_programmed``).  Everything they read and
write is a static buffer written in place -- env state, OU state, rows,
window, episodic sums, nets, targets, Adam moments and counts, the step
counter and the OU schedules, learning rates and tau as 0-dim device
scalars, which the host fills before the rollout (the tracer's span
``ddpg.schedules``, one an iteration; each fill counts as a
``scalar_writes``).  On the eager host-env backend the rollout steps the
host and the append and update run as programs.

``trainer.batch_dtype`` (e.g. ``bfloat16``) is the replay window's
observation dtype; the nets promote such observations against their
float32 parameters.  A policy's ``remat`` recomputes the online actor's and
critic's activations in the update's backward pass.

Checkpoints are per net, ``{policy}_{actor|critic}_{timestep}.state_dict``;
loading takes ``{policy: {"actor": path, "critic": path}}`` and resets the
targets of the nets it loads to them.

Under a process mesh (``parallel/mesh.py``) the replay window holds the
rank's env rows (its env axis, dim 1, cut), the OU noise is drawn from the
rank's own stream, the losses take global denominators, both gradients are
summed over the env group before the optimizers step (with ``tp > 1`` on
the rank's shards, :class:`ClippedAdam`), and the Polyak updates run on the
replicated nets; the warm-up gate is the host's count, the same on every
rank.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from warpdrive_tpu_torch.algos.ddpg import DDPG
from warpdrive_tpu_torch.core import trace
from warpdrive_tpu_torch.core.program import assign_state
from warpdrive_tpu_torch.models.factory import ModelFactory
from warpdrive_tpu_torch.sampling.samplers import sample_ou_process
from warpdrive_tpu_torch.training.param_scheduler import ParamScheduler
from warpdrive_tpu_torch.training.trainer_a2c import ClippedAdam, remat_apply
from warpdrive_tpu_torch.training.trainer_base import (
    TrainerBase,
    _host_state,
    _timestep_of,
)

_NETS = ("actor", "critic")


@torch.no_grad()
def soft_update(target: torch.nn.Module, source: torch.nn.Module, tau):
    """Polyak averaging in place: ``t <- t * (1 - tau) + s * tau``, with
    ``tau`` a number or a 0-dim float32 device tensor (the same bits)."""
    if not torch.is_tensor(tau):
        tau = np.float32(tau)
    keep = 1 - tau if torch.is_tensor(tau) else np.float32(1) - tau
    for t, s in zip(target.parameters(), source.parameters()):
        t.copy_(t * keep + s * tau)


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def ddpg_update_step(nets: dict, targets: dict, optimizers: dict, algo,
                     batch: dict, lrs: dict, tau, step: bool = True,
                     remat: bool = False, mesh=None,
                     with_metrics: bool = True) -> dict:
    """The device side of one policy's DDPG update on its replay window
    ``{"obs" (W, E, A, F), "actions" (W, E, A, C), "rewards" (W, E, A),
    "done" (W, E)}``: the body of the captured update programs.  ``nets``,
    ``targets``, ``optimizers`` and ``lrs`` are keyed ``"actor"``/
    ``"critic"``; the learning rates and ``tau`` are numbers or 0-dim
    float32 device tensors.  Both gradients are taken before either
    optimizer steps, so the actor's goes through the critic as it was;
    with ``step`` the optimizers step and the targets move toward the
    updated nets, without it nothing moves.  ``remat`` recomputes the
    online nets' activations in the backward pass.  Under a ``mesh`` the
    window holds the rank's env rows, the losses and metrics are global
    and each net's gradients are summed over the env group.  Returns the
    metric tensors with both gradient norms, or ``{}`` without
    ``with_metrics`` (the hot update, JAX's ``with_metrics=False``)."""
    actor = remat_apply(nets["actor"], remat)
    critic = remat_apply(nets["critic"], remat)
    obs_b, act_b = batch["obs"], batch["actions"]

    # the targets' Q(s_{t+1}, pi'(s_{t+1})), W - 1 rows
    with torch.no_grad():
        t_mu = targets["actor"](obs_b)
        next_q = targets["critic"](obs_b[1:], t_mu[1:])

    q = critic(obs_b, act_b)
    critic_loss, critic_metrics = algo.critic_loss_and_metrics(
        act_b, batch["rewards"], batch["done"], q, next_q, group=mesh,
        with_metrics=with_metrics)
    grads = {"critic": torch.autograd.grad(
        critic_loss, list(nets["critic"].parameters()))}

    actor_loss, j = algo.actor_loss(critic(obs_b, actor(obs_b)), group=mesh)
    grads["actor"] = torch.autograd.grad(actor_loss,
                                         list(nets["actor"].parameters()))
    if mesh is not None:
        grads = {net: mesh.reduce_grads(g) for net, g in grads.items()}

    norms = {}
    if step:
        # the optimizer returns the global norm it clipped by
        for net in ("critic", "actor"):
            names = [n for n, _ in nets[net].named_parameters()]
            norms[net] = optimizers[net].step(dict(zip(names, grads[net])),
                                              lrs[net])
        for net in _NETS:
            soft_update(targets[net], nets[net], tau)
    elif with_metrics:
        norms = {net: global_norm(grads[net]) for net in _NETS}
    if not with_metrics:
        return {}
    metrics = algo.with_actor_terms(critic_metrics, critic_loss, actor_loss,
                                   j, mesh)
    metrics["Actor gradient norm"] = norms["actor"]
    metrics["Critic gradient norm"] = norms["critic"]
    return metrics


def finish_metrics(metrics: dict, timestep, lrs: dict, full: bool) -> dict:
    """A full update's metrics with the host's entries, in the JAX
    package's order: the timestep, both learning rates (host numbers) and
    whether the window was full."""
    metrics = dict(metrics)
    norms = {name: metrics.pop(name)
             for name in ("Actor gradient norm", "Critic gradient norm")}
    return {**metrics,
            "Current timestep": float(timestep),
            "Actor learning rate": float(lrs["actor"]),
            "Critic learning rate": float(lrs["critic"]),
            **norms,
            "Buffer full": float(full)}


class TrainerDDPG(TrainerBase):
    """DDPG trainer over one or more continuous-action policies."""

    def __init__(self, env_wrapper=None, config=None, **kwargs):
        super().__init__(env_wrapper=env_wrapper, config=config, **kwargs)

        T = self.training_batch_size_per_env
        self.buffer_capacity = T + self.n_step - 1
        sampler = (config.get("sampler") or {}).get("params") or {}
        self.ou_damping = ParamScheduler(sampler.get("damping", 0.15))
        self.ou_stddev = ParamScheduler(sampler.get("stddev", 0.2))
        self.ou_scale = ParamScheduler(sampler.get("scale", 1.0))

        self.engine.reset_all_envs()  # the initial state as built
        init_gen = torch.Generator(device=self.device)
        init_gen.manual_seed(self.seed)

        self.algorithms = {}
        self.nets = {net: {} for net in _NETS}
        self.targets = {net: {} for net in _NETS}
        self.optimizers = {net: {} for net in _NETS}
        self.lr_schedules = {net: {} for net in _NETS}
        self.tau = {}
        self.remat = {}
        self._num_action_dims = {}
        for tag in self.policies:
            policy_cfg = config["policy"][tag]
            self.remat[tag] = bool(policy_cfg.get("remat", False))
            heads, _, is_det = self._action_heads(tag)
            assert is_det, (
                "TrainerDDPG needs Box action spaces; TrainerA2C trains "
                "categorical actions"
            )
            num_c = len(heads)
            self._num_action_dims[tag] = num_c
            obs_dim = self._policy_obs_sizes(tag)[0]
            # the Box space's symmetric bound; the config's output_w wins
            high = float(np.max(np.abs(self.act_space[tag].high)))
            model_cfg = policy_cfg["model"]
            actor_cfg, critic_cfg = model_cfg["actor"], model_cfg["critic"]
            output_w = float(actor_cfg.get(
                "output_w", high if np.isfinite(high) else 1.0))
            self.nets["actor"][tag] = ModelFactory.create(actor_cfg["type"])(
                obs_dim, tuple(actor_cfg["fc_dims"]), num_c,
                action_scale=output_w, generator=init_gen, device=self.device,
            )
            self.nets["critic"][tag] = ModelFactory.create(
                critic_cfg["type"])(
                obs_dim + num_c, tuple(critic_cfg["fc_dims"]),
                generator=init_gen, device=self.device,
            )
            if self.mesh is not None:  # every rank starts from rank 0's
                for net in _NETS:
                    self.mesh.broadcast_module(self.nets[net][tag])

            assert policy_cfg.get("algorithm", "DDPG").upper() == "DDPG"
            self.algorithms[tag] = DDPG(
                discount_factor_gamma=policy_cfg.get("gamma", 0.99),
                normalize_advantage=policy_cfg.get("normalize_advantage",
                                                   False),
                normalize_return=policy_cfg.get("normalize_return", False),
                n_step=self.n_step,
            )
            self.tau[tag] = float(policy_cfg.get("tau", 0.05))
            lr_cfg = policy_cfg.get("lr", 1e-3)
            if isinstance(lr_cfg, dict):
                lrs = {"actor": lr_cfg["actor"], "critic": lr_cfg["critic"]}
            else:
                lrs = {"actor": lr_cfg, "critic": lr_cfg}
            max_norm = (policy_cfg.get("max_grad_norm", 3.0)
                        if policy_cfg.get("clip_grad_norm", True) else None)
            for net in _NETS:
                model = self.nets[net][tag]
                # the targets start as copies of the online nets
                self.targets[net][tag] = copy.deepcopy(model)
                self.lr_schedules[net][tag] = ParamScheduler(lrs[net])
                self.optimizers[net][tag] = ClippedAdam(
                    dict(model.named_parameters()), max_norm=max_norm,
                    mesh=self.mesh)

        self._env_state = self._rollout_env_state()
        T, E = self.training_batch_size_per_env, self.local_envs
        W = self.buffer_capacity

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        def scalar():
            return zeros(())

        # the static carry, written in place and never rebound (a captured
        # program holds these storages): the OU state, the replay window,
        # the rollout's rows (time-major, the window's dtypes) and the
        # iteration's OU noise
        self._ou, self._window, self._rows, self._noise = {}, {}, {}, {}
        for tag, ids in self.policy_tag_to_agent_id_map.items():
            A, C = len(ids), self._num_action_dims[tag]
            obs_dim = self._policy_obs_sizes(tag)[0]
            self._ou[tag] = zeros((E, A, C))
            self._noise[tag] = zeros((T, E, A, C))
            for key, shape, dtype in (
                    ("obs", (E, A, obs_dim), self.batch_dtype),
                    ("actions", (E, A, C), torch.float32),
                    ("rewards", (E, A), torch.float32)):
                self._window[f"{key}_{tag}"] = zeros((W,) + shape, dtype)
                self._rows[f"{key}_{tag}"] = zeros((T,) + shape, dtype)
        self._window["done"] = zeros((W, E), torch.int32)
        self._rows["done"] = zeros((T, E), torch.int32)
        self.filled = 0  # rows of the window written so far, at most full
        # the OU schedules' values, each net's learning rate and each
        # policy's tau as device scalars, filled on the host before the
        # programs run
        self._sched = {name: scalar() for name in ("damping", "stddev",
                                                   "scale")}
        self._lr = {net: {tag: scalar() for tag in self.policies}
                    for net in _NETS}
        self._tau_t = {tag: torch.tensor(np.float32(tau), device=self.device)
                       for tag, tau in self.tau.items()}

        for tag in self.policies:
            ckpts = config["policy"][tag]["model"].get("model_ckpt_filepath",
                                                       {})
            if isinstance(ckpts, dict) and any(ckpts.values()):
                self.load_model_checkpoint({tag: ckpts})

    # ------------------------------------------------------------- acting
    def _act_fn(self, state: dict, use_argmax: bool = True,
                generator: torch.Generator = None,
                return_logits: bool = False) -> torch.Tensor:
        """The actors' noise-free actions (``use_argmax`` and
        ``generator`` do not apply; there are no logits)."""
        if return_logits:
            raise AssertionError(
                "include_probabilities is only available on trainers with "
                "categorical policies (TrainerA2C)"
            )
        per_policy = {
            tag: self.nets["actor"][tag](
                self._policy_obs_and_mask(state, None, tag)[0])
            for tag in self.policies
        }
        return self._merge_actions(per_policy)

    # ------------------------------------------------------------ rollout
    def _write_schedules(self, timestep):
        """The iteration's host writes, before its rollout on every path:
        the OU schedules' values at ``timestep`` and both learning rates of
        every trained policy into their scalars; the tracer's span
        ``ddpg.schedules``."""
        span = trace.begin("ddpg.schedules") if trace.ON else 0
        for name, schedule in (("damping", self.ou_damping),
                               ("stddev", self.ou_stddev),
                               ("scale", self.ou_scale)):
            schedule.write_to(self._sched[name], timestep)
        for tag in self.policies_to_train:
            self._write_lrs(tag, timestep)
        if span:
            trace.end(span)

    def _presample_ou_noise(self, stddev) -> dict:
        """One ``stddev * N(0, 1)`` draw of shape ``(T, E, A_p, C)`` per
        policy, in policy order (``stddev`` a number or a device
        scalar)."""
        T = self.training_batch_size_per_env
        return {
            tag: torch.randn((T,) + tuple(self._ou[tag].shape),
                             generator=self.generator, device=self.device)
            * (stddev if torch.is_tensor(stddev) else np.float32(stddev))
            for tag in self.policies
        }

    def _draw_noise(self):
        """The iteration's OU noise into its static buffers: the body of
        the noise-draw program (the JAX iteration's one ``normal`` draw,
        kept apart so that the stream's order is the eager one's)."""
        for tag, noise in self._presample_ou_noise(
                self._sched["stddev"]).items():
            self._noise[tag].copy_(noise)

    @torch.no_grad()
    def _rollout(self, noise: dict = None, damping=None, stddev=None,
                 scale=None) -> dict:
        """``training_batch_size_per_env`` calls of :meth:`_rollout_step`
        from the trainer's env state, eagerly; returns the static rows,
        time-major.  ``noise`` ``{tag: (T, E, A_p, C)}`` and the OU
        schedule values, where given (a test may pass them), are written
        into their buffers first."""
        for name, value in (("damping", damping), ("stddev", stddev),
                            ("scale", scale)):
            if value is not None:
                self._sched[name].fill_(float(np.float32(value)))
        for tag, value in (noise or {}).items():
            self._noise[tag].copy_(value)
        self._rollout_steps(lambda t: self._rollout_step())
        return self._rows

    @torch.no_grad()
    def _rollout_step(self):
        """One rollout step: the body of the JAX rollout scan and of the
        captured rollout-step program.  Observations, the actors' actions
        with OU exploration (row ``self._row`` of the iteration's noise,
        the schedules read from their device scalars), the env step,
        rewards and done flags, episodic bookkeeping and the done-driven
        auto-reset; row ``self._row`` (a device step counter) of every
        static row buffer is written with ``index_copy_``, and the OU
        state, env state and episodic accounting in place.  On the eager
        backend the engine steps its own state on the host; the rest of the
        step is :meth:`_step_and_record`'s."""
        engine = self.engine
        row = self._row
        state = dict(engine.state) if self._is_eager else self._env_state
        sched = self._sched
        obs_all = engine.observe(state) if engine.has_split_step else None
        per_policy = {}
        for tag in self.policies:
            obs_p = self._policy_obs_and_mask(state, obs_all, tag)[0]
            mu = self.nets["actor"][tag](obs_p)
            acts, new_ou = sample_ou_process(
                mu, self._ou[tag], damping=sched["damping"],
                stddev=sched["stddev"], scale=sched["scale"],
                noise=self._noise[tag].index_select(0, row)[0])
            self._ou[tag].copy_(new_ou)
            per_policy[tag] = acts
            for key, value in (("obs", obs_p), ("actions", acts)):
                record = self._rows[f"{key}_{tag}"]
                record.index_copy_(0, row, value[None].to(record.dtype))
        self._step_and_record(state, per_policy, self._rows)

    # ------------------------------------------------------------- update
    def _append(self):
        """The rollout's rows onto the replay window, in time order: the
        body of the append program.  Each window tensor is written with
        ``cat(window[T:], rows)`` formed apart first (an overlapping
        in-place shift is undefined)."""
        T = self.training_batch_size_per_env
        for key, window in self._window.items():
            window.copy_(torch.cat([window[T:], self._rows[key]]))

    def _fill_after_append(self) -> bool:
        """The host's count of the window's rows after an append; whether
        the window is full (the warm-up gate)."""
        self.filled = min(self.filled + self.training_batch_size_per_env,
                          self.buffer_capacity)
        return self.filled >= self.buffer_capacity

    def _policy_window(self, tag: str) -> dict:
        return {"obs": self._window[f"obs_{tag}"],
                "actions": self._window[f"actions_{tag}"],
                "rewards": self._window[f"rewards_{tag}"],
                "done": self._window["done"]}

    def _update_body(self, tag: str, variant: str) -> dict:
        """Policy ``tag``'s update on the window: ``"full"`` (the step and
        its metrics), ``"hot"`` (the step alone) or ``"warm"`` (the metrics
        alone: the window is not full, nothing moves)."""
        return ddpg_update_step(
            {net: self.nets[net][tag] for net in _NETS},
            {net: self.targets[net][tag] for net in _NETS},
            {net: self.optimizers[net][tag] for net in _NETS},
            self.algorithms[tag], self._policy_window(tag),
            {net: self._lr[net][tag] for net in _NETS}, self._tau_t[tag],
            step=variant != "warm", remat=self.remat[tag], mesh=self.mesh,
            with_metrics=variant != "hot")

    def _write_lrs(self, tag: str, timestep):
        """Both nets' learning rates at ``timestep`` into their scalars."""
        for net in _NETS:
            self.lr_schedules[net][tag].write_to(self._lr[net][tag],
                                                 timestep)

    def _lrs_at(self, tag: str, timestep) -> dict:
        """Both nets' learning rates at ``timestep``, host values."""
        return {net: self.lr_schedules[net][tag].value_at(timestep)
                for net in _NETS}

    def _replay_update(self, rows: dict, timestep) -> dict:
        """Append ``rows`` (what the rollout records, in the static rows'
        dtypes and shapes), copied into the static rows, to the replay
        window and update every trained policy through the programs, as
        :meth:`_iteration` runs them: the step once the window is full, the
        metrics always; returns the metric tensors per policy.  The
        learning rates, which the rollout's :meth:`_write_schedules` writes,
        are written here."""
        assign_state(self._rows, rows)
        for tag in self.policies_to_train:
            self._write_lrs(tag, timestep)
        with self._program_calls():
            return self._update_programmed(timestep)

    # ------------------------------------------------------- the programs
    def _build_programs(self):
        """The captured programs over the static carry, in one graph
        memory pool: on the device engine the OU noise draw and the
        rollout step; the replay append; per trained policy the update in
        its full, hot (metrics-free) and warm (metrics alone, while the
        window fills) variants.  A program is captured at its first
        call (:meth:`TrainerBase._program`)."""
        programs = {}
        if not self._is_eager:  # the device engine
            programs["noise"] = self._program(
                self._draw_noise, {"noise": self._noise,
                                   "sched": self._sched}, "OU noise draw")
            # the step looked up at each call, as a wrapper may replace it
            programs["rollout"] = self._program(
                lambda: self._rollout_step(),
                {"env_state": self._env_state, "rows": self._rows,
                 "row": self._row, "ou": self._ou, "noise": self._noise,
                 "sched": self._sched,
                 "episodes": [self._ep_acc, self._ep_sum, self._ep_count],
                 "actors": {tag: list(m.parameters())
                            for tag, m in self.nets["actor"].items()}},
                "rollout step")
        programs["append"] = self._program(
            self._append, {"window": self._window, "rows": self._rows},
            "replay append")
        for tag in self.policies_to_train:
            buffers = {
                "nets": {net: list(self.nets[net][tag].parameters())
                         for net in _NETS},
                "targets": {net: list(self.targets[net][tag].parameters())
                            for net in _NETS},
                "optimizers": {net: self.optimizers[net][tag].buffers()
                               for net in _NETS},
                "window": self._window,
                "lrs": [self._lr[net][tag] for net in _NETS],
                "tau": self._tau_t[tag]}
            for variant in ("full", "hot", "warm"):
                programs[tag, variant] = self._program(
                    lambda tag=tag, variant=variant:
                        self._update_body(tag, variant),
                    buffers, f"{tag} update ({variant})")
            # once an iteration when the window is full
            trace.record_update_passes(programs[tag, "hot"].name, 1)
        self._programs = programs

    def _rollout_programmed(self, timestep):
        """The schedules into their scalars, then on the device engine the
        noise-draw program and ``training_batch_size_per_env`` calls of the
        rollout-step program into the static rows (on the eager backend the
        noise drawn and the eager rollout)."""
        if self._programs is None:
            self._build_programs()
        self._write_schedules(timestep)
        if self._is_eager:
            self._draw_noise()
            self._rollout()
            return
        self._programs["noise"]()
        step = self._programs["rollout"]
        self._rollout_steps(lambda t: step())

    def _update_programmed(self, timestep, full: bool = True) -> dict:
        """The append program, then per trained policy (its learning
        rates written with the OU schedules, :meth:`_write_schedules`),
        once the window is full, the full or the hot update program;
        while it fills, the warm program where metrics are asked for and
        nothing otherwise (the host's fill count is the gate: nothing
        moves and Adam's count stays, as JAX's
        ``jnp.where``-selected state).  The full variant returns the metric
        tensors per policy, the hot one ``{}``."""
        if self._programs is None:
            self._build_programs()
        self._programs["append"]()
        is_full = self._fill_after_append()
        metrics = {}
        for tag in self.policies_to_train:
            if is_full:
                out = self._programs[tag, "full" if full else "hot"]()
            elif full:
                out = self._programs[tag, "warm"]()
            if full:
                metrics[tag] = finish_metrics(
                    out, timestep, self._lrs_at(tag, timestep), is_full)
        return metrics

    # ------------------------------------------------------- checkpoints
    def save_model_checkpoint(self, timestep: int = None):
        """The actor and the critic of every trained policy, a file each."""
        timestep = self.current_timestep if timestep is None else timestep
        for policy in self.policies_to_train:
            for net in _NETS:
                torch.save(_host_state(self.nets[net][policy]),
                           self._ckpt_path(policy, timestep, net))

    @torch.no_grad()
    def load_model_checkpoint(self, ckpt_filepaths: dict):
        """Restore the nets named in ``{policy: {"actor": path, "critic":
        path}}`` (either may be left out or empty), reset their targets to
        them, and resume the schedules from the files' common timestep."""
        timesteps = set()
        for policy, paths in ckpt_filepaths.items():
            if not isinstance(paths, dict):
                raise TypeError(
                    f"DDPG checkpoints are per net: expected "
                    f"{{'actor': path, 'critic': path}} for {policy!r}, "
                    f"got {type(paths).__name__}"
                )
            for net in _NETS:
                path = paths.get(net, "")
                if not path:
                    continue
                state = self._load(path)
                self.nets[net][policy].load_state_dict(state)
                self.targets[net][policy].load_state_dict(state)
                timesteps.add(_timestep_of(path))
        self._resume_timestep(timesteps)

    def _training_state(self) -> dict:
        return {
            "nets": {net: {tag: m.state_dict() for tag, m in by_tag.items()}
                     for net, by_tag in self.nets.items()},
            "targets": {net: {tag: m.state_dict()
                              for tag, m in by_tag.items()}
                        for net, by_tag in self.targets.items()},
            "optimizers": {net: {tag: opt.state_dict()
                                 for tag, opt in by_tag.items()}
                           for net, by_tag in self.optimizers.items()},
            "window": self._window,
            "filled": self.filled,
            "ou": self._ou,
            "env_state": self._env_state,
            "episodes": {"acc": self._ep_acc, "sum": self._ep_sum,
                         "count": self._ep_count},
        }

    def _training_state_dims(self) -> dict:
        return {**super()._training_state_dims(),
                "window": {k: 1 for k in self._window},
                "ou": {tag: 0 for tag in self._ou}}

    def _load_training_state(self, state: dict):
        """Into the live buffers: a built program keeps its storages."""
        for net in _NETS:
            for tag in self.policies:
                self.nets[net][tag].load_state_dict(state["nets"][net][tag])
                self.targets[net][tag].load_state_dict(
                    state["targets"][net][tag])
                self.optimizers[net][tag].load_state_dict(
                    state["optimizers"][net][tag])
        for key, window in self._window.items():
            window.copy_(state["window"][key])
        self.filled = int(state["filled"])
        for tag, ou in self._ou.items():
            ou.copy_(state["ou"][tag])
        assign_state(self._env_state, {
            k: v.to(self.device) for k, v in state["env_state"].items()})
        episodes = state["episodes"]
        self._ep_acc.copy_(episodes["acc"])
        self._ep_sum.copy_(episodes["sum"])
        self._ep_count.copy_(episodes["count"])
