"""
TrainerA2C: on-policy trainer for A2C and PPO policies.

The port's counterpart of ``warpdrive_tpu/training/trainer_a2c.py``.  One
iteration runs on the engine's device:

  rollout, ``training_batch_size_per_env`` steps (:meth:`TrainerA2C.
  _rollout_step`, each writing row t of the batch) of
      the observation of every agent: on the split path (TagContinuous)
      ``observe``, the kNN observation (on a card, one kernel launch; none
      in the full-observation mode), on the full-step path the
      observations the last step wrote
      per policy its flattened observations and action mask
      (``_policy_obs_and_mask``), the model forward with the mask on the
      logits, and categorical sampling; the observations are recorded in
      ``trainer.batch_dtype`` (e.g. ``bfloat16``) and the mask in float32,
      or, under ``trainer.update_recompute_obs`` on the split path, not at
      all: the pre-step state is recorded instead
      ``step_physics`` (split) or the env's whole ``step`` (full),
      per-policy rewards and done flags
      episodic-reward bookkeeping and done-driven auto-reset (with a reset
      pool, the refresh of the reset envs' observations)
  then, per trained policy, the passes of :class:`UpdatePass`:
      one pass over the whole batch, or ``num_epochs`` x
      ``num_minibatches`` passes over env-axis slices (shuffled or
      contiguous, each forwarded env-major, PPO against fixed behaviour
      log-probs), each a forward (under ``remat``, recomputed in the
      backward pass; under ``update_recompute_obs``, of observations
      derived from the slice's recorded state, one kNN launch), the A2C or
      PPO loss, and :class:`ClippedAdam`: clip-by-global-norm, Adam and the
      scheduled learning rate, the rule of the JAX trainer's
      ``optax.chain(clip_by_global_norm(max_norm), scale_by_adam(),
      scale(-1))`` times ``lr_t``, read once an update.

An iteration runs the rollout step and the update pass as programs
(``core/program.py``), the JAX trainer's jitted iteration: the rollout-step
program T times, then per policy the host's :meth:`UpdatePass.begin`, the
PPO prologue program and the pass program once a pass, in its hot
(metrics-free) or full variant (``TrainerBase._iteration_programmed``).
Everything they read and write is a static buffer written in place: the
env state, episodic sums, batch, parameters, Adam moments and count, the
schedules' 0-dim scalars and the step and pass counters.  The eager
host-env backend steps its rollout on the host into the same static batch
and runs the update programs, as JAX jits this backend's update
(``_eager_update_fn``); under an NCCL process mesh the programs capture the
collectives they run (a multi-pass sweep's passes, whose rows each rank
picks on the host, run as called).

Evaluation and episode fetching act through ``_act_fn`` (the most likely
action, or one drawn from the evaluation generator), and
``fetch_episode_states(include_probabilities=True)`` adds each policy's
action probabilities, the softmax of the logits that chose the actions;
full-state checkpoints hold the models, the
optimizer states, the rollout's env state and the episodic accounting.

The policy matrix products and their backward pass are ``torch.matmul`` and
autograd, which the JAX package leaves to XLA; they run in float32, or in
the model's ``dtype``.

Under a process mesh (``parallel/mesh.py``) each rank rolls out its env
rows; an update's loss is its rows' numerator over the global denominator,
the gradients are all-reduced (SUM) over the env group, clipped by the
global norm and stepped identically on every rank, so the parameters stay
replicated without a broadcast.  A shuffled sweep uses one permutation of
the GLOBAL env axis an epoch, rank 0's (or the injected table), and each
rank trains on the rows of each minibatch that it holds -- no data moves
between ranks, and a rank that holds none of a minibatch still joins its
all-reduces.  With ``tp > 1`` :class:`ClippedAdam` steps the rank's shard
of each cut parameter and gathers the cut parameters across the model
group for the next forward.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from warpdrive_tpu_torch.algos.policygradient import A2C, PPO, _logp_and_entropy
from warpdrive_tpu_torch.core import trace
from warpdrive_tpu_torch.core.program import assign_state
from warpdrive_tpu_torch.models.factory import ModelFactory
from warpdrive_tpu_torch.parallel.mesh import MODEL_AXIS, tp_axis, tp_shard
from warpdrive_tpu_torch.sampling.samplers import sample_heads
from warpdrive_tpu_torch.training.param_scheduler import ParamScheduler
from warpdrive_tpu_torch.training.trainer_base import TrainerBase, torch_dtype
from warpdrive_tpu_torch.utils.constants import Constants

_DONE = Constants.DONE
_REWARDS = Constants.REWARDS


class ClippedAdam:
    """One policy's optimizer: optax's ``clip_by_global_norm(max_norm)``
    (when ``max_norm`` is set), ``scale_by_adam()`` with its defaults and
    ``scale(-1)``, then the learning-rate multiply, applied in place.

    Unlike ``torch.nn.utils.clip_grad_norm_``, which scales by
    ``max_norm / (norm + 1e-6)`` always, optax scales by ``max_norm / norm``
    and only when ``norm >= max_norm``; this class follows optax.

    With a ``mesh`` of ``tp > 1`` (tensor parallelism, the JAX package's
    ``shard_params_tp`` placement) each parameter cut on
    :func:`~warpdrive_tpu_torch.parallel.mesh.tp_axis` is stepped on this
    rank's shard only (a view of the whole parameter), with moments of the
    shard's shape; the squared norms of the shards are summed over the
    model group for the global-norm clip, and after the step the cut
    parameters are gathered across the model group, whole on every rank
    for the next forward.  ``state_dict`` gives the whole moments (the
    single-process format) and ``load_state_dict`` cuts them.
    """

    def __init__(self, params: dict, max_norm: float = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, mesh=None):
        self.params = params  # name -> Parameter
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        device = next(iter(params.values())).device
        # the step count and the decay rates on the device: a captured
        # update step reads them there (a host value would be baked in)
        self._count = torch.zeros((), dtype=torch.int32, device=device)
        self._b1 = torch.tensor(np.float32(b1), device=device)
        self._b2 = torch.tensor(np.float32(b2), device=device)
        self.mesh = mesh if mesh is not None and mesh.tp > 1 else None
        self._axes = {n: (tp_axis(p.shape, self.mesh.tp)
                          if self.mesh is not None else None)
                      for n, p in params.items()}
        self.mu = {n: torch.zeros_like(self._shard(p))
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(self._shard(p))
                   for n, p in params.items()}

    @property
    def count(self) -> int:
        """The number of steps taken (read from the device)."""
        return int(self._count)

    def buffers(self) -> dict:
        """Every tensor a step reads and writes in place."""
        return {"count": self._count, "mu": self.mu, "nu": self.nu,
                "params": self.params}

    def _shard(self, whole: torch.Tensor) -> torch.Tensor:
        return whole if self.mesh is None else tp_shard(whole, self.mesh)

    def _whole(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        ax = self._axes[name]
        if ax is None:
            return shard
        return self.mesh.all_gather(shard, ax, MODEL_AXIS)

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": {n: self._whole(n, t).clone()
                       for n, t in self.mu.items()},
                "nu": {n: self._whole(n, t).clone()
                       for n, t in self.nu.items()}}

    def load_state_dict(self, state: dict):
        """Take ``{"count", "mu", "nu"}`` (e.g. from
        ``models.fully_connected.adam_state_from_optax``), whole, into the
        live buffers."""
        self._count.fill_(int(state["count"]))
        for name, p in self.params.items():
            for moments in ("mu", "nu"):
                whole = state[moments][name].to(p.device, p.dtype)
                getattr(self, moments)[name].copy_(self._shard(whole))

    def _global_norm(self, grads: dict) -> torch.Tensor:
        if self.mesh is None:
            return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        # the cut shards' squares summed over the model group, the whole
        # parameters' once
        cut = [n for n in grads if self._axes[n] is not None]
        squares = torch.zeros((1,), device=next(iter(grads.values())).device)
        for n in cut:
            squares += torch.sum(grads[n] * grads[n])
        squares = self.mesh.all_reduce(squares, MODEL_AXIS)[0]
        return torch.sqrt(squares + sum(
            torch.sum(g * g) for n, g in grads.items() if n not in cut))

    @torch.no_grad()
    def step(self, grads: dict, lr) -> torch.Tensor:
        """Apply one update for ``grads`` (name -> gradient of the whole
        parameter) at learning rate ``lr`` (a 0-dim float32 device tensor,
        or a number), writing the moments and parameters in place; returns
        the gradients' global norm before clipping.

        The bias corrections ``1 - b1**count`` and ``1 - b2**count`` and
        the learning rate are 0-dim float32 device tensors (CUDA divides by
        a host scalar through its reciprocal), and each moment is one
        expression copied into its buffer: ``addcmul_`` or ``add_(...,
        alpha=)`` would contract to an FMA and change the bits."""
        device = self._count.device
        grads = {n: self._shard(g) for n, g in grads.items()}
        g_norm = self._global_norm(grads)
        if self.max_norm is not None:
            keep = g_norm < self.max_norm
            grads = {n: torch.where(keep, g, (g / g_norm) * self.max_norm)
                     for n, g in grads.items()}
        self._count.add_(1)
        bc1 = 1 - torch.pow(self._b1, self._count)
        bc2 = 1 - torch.pow(self._b2, self._count)
        lr_t = lr if torch.is_tensor(lr) else torch.tensor(np.float32(lr),
                                                           device=device)
        for name, p in self.params.items():
            g, mu, nu = grads[name], self.mu[name], self.nu[name]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            self._shard(p).add_((-update) * lr_t)
        if self.mesh is not None:  # whole for the next forward
            for name, p in self.params.items():
                if self._axes[name] is not None:
                    p.copy_(self._whole(name, self._shard(p)))
        return g_norm


@dataclass(frozen=True)
class UpdateOptions:
    """One policy's update sweep (the JAX trainer's per-policy
    ``num_epochs``, ``num_minibatches``, ``shuffle_minibatches`` and
    ``remat``): ``num_epochs`` x ``num_minibatches`` passes, each over a
    slice of the env axis, shuffled (one permutation of the envs an epoch)
    or contiguous blocks.  ``remat`` recomputes the model's activations in
    the backward pass."""

    num_epochs: int = 1
    num_minibatches: int = 1
    shuffle: bool = False
    remat: bool = False

    def __post_init__(self):
        assert self.num_epochs >= 1 and self.num_minibatches >= 1

    @property
    def passes(self) -> int:
        return self.num_epochs * self.num_minibatches


def remat_apply(module, remat: bool):
    """``module``'s forward; with ``remat`` under
    ``torch.utils.checkpoint`` (non-reentrant), which stores none of its
    activations and recomputes them in the backward pass: the same values
    and gradients.  The models draw nothing, so the RNG state is not saved
    (saving the CUDA one raises during a graph capture)."""
    if not remat:
        return module

    def apply(*args):
        return checkpoint(module, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return apply


def _forward(model, obs, mask):
    """``model``'s forward with the action mask where there is one."""
    return model(obs) if mask is None else model(obs, mask)


def _to_time_major(logits_list, values):
    return [lg.transpose(0, 1) for lg in logits_list], values.transpose(0, 1)


class UpdatePass:
    """One policy's update on a fixed batch, pass by pass: the body of the
    JAX trainer's minibatch scan (``warpdrive_tpu/training/
    trainer_a2c.py:685``) and of the captured update-pass program.

    The batch is ``{"actions" (T, E, A, C), "rewards" (T, E, A), "done"
    (T, E)}`` with the observations either stored, ``"obs"`` (T, E, A, F),
    or derived: ``"phys"``, the pre-step state entries ``(T, E, ...)``,
    which ``observe`` maps, given as ``(R, ...)`` env rows, to the policy's
    ``(R, A, F)`` observations (or to ``(observations, mask)``).  A stored
    ``"mask"`` (T, E, A, M), 1 keep and 0 forbid, goes onto the logits of
    every forward, as the JAX trainer's ``mask_b``.

    One pass (the default ``options``) forwards the whole batch.  More
    passes sweep env-axis slices, each with its own returns, gradients and
    optimizer step: pass p takes row p of a ``(passes, E // num_minibatches)``
    table of env indices, read through a device pass counter -- contiguous
    blocks, or one permutation of the envs an epoch drawn by :meth:`begin`
    -- so that one captured pass serves every pass.  A slice's rows go
    through the model env-major, ``(E_mb, T, A, F)``, copied into one
    contiguous block, and its logits and values back to time-major for the
    loss; this is the layout the JAX trainer's ``env_major`` relayout gives
    its slices, so every value of that option runs this one path.  PPO over
    more than one pass holds its ratio to the behaviour log-probs of the
    parameters before the first pass (:meth:`prologue`): from one forward
    of the stored batch into a static buffer, or of each derived slice
    from a static copy of the parameters.  The learning rate and the loss
    coefficients are 0-dim device scalars that :meth:`begin` fills from
    the schedules.

    Under a ``mesh`` the batch holds the rank's env rows: the loss and
    metrics are global over the env group (``group`` of the algorithms),
    the gradients are summed over it before the optimizer's step, and a
    sweep's slices are of the global env axis (a shuffled one from rank
    0's permutation), each rank taking its rows of each on the host (so
    that pass is never captured)."""

    def __init__(self, model, optimizer: ClippedAdam, algo, batch: dict,
                 options: UpdateOptions = None, observe=None, mesh=None,
                 negative_positive_ratio: float = -1.0,
                 generator: torch.Generator = None):
        self.opts = opts = options or UpdateOptions()
        self.model, self.optimizer, self.algo = model, optimizer, algo
        self.batch = batch
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [optimizer.params[n] for n in self.names]
        self.forward = remat_apply(model, opts.remat)
        self.observe, self.mesh, self.generator = observe, mesh, generator
        self.negative_positive_ratio = negative_positive_ratio
        self.stored = "obs" in batch
        done = batch["done"]
        device = done.device

        def scalar():
            return torch.zeros((), dtype=torch.float32, device=device)

        self.lr, self.vf_coeff, self.ent_coeff = scalar(), scalar(), scalar()
        self.pass_index = torch.zeros((1,), dtype=torch.long, device=device)
        self.table = self.old_lp = self.behaviour = None
        self._blocks, self._host_pass = None, 0  # under a mesh
        if opts.passes > 1:
            # the slices are of the global env axis
            E = done.shape[1] * (1 if mesh is None else mesh.dp)
            assert E % opts.num_minibatches == 0, (
                "num_minibatches must divide num_envs (env-axis slicing)")
            self.mb = E // opts.num_minibatches
            if mesh is None:
                self.table = torch.arange(E, device=device).reshape(
                    opts.num_minibatches, self.mb).repeat(opts.num_epochs, 1)
            if isinstance(algo, PPO):
                if self.stored:
                    self.old_lp = torch.empty(batch["actions"].shape[:3],
                                              dtype=torch.float32,
                                              device=device)
                else:
                    # derived observations: the behaviour log-probs of each
                    # slice, from these parameters, so the batch is never
                    # whole
                    self.behaviour = {n: p.detach().clone()
                                      for n, p in model.named_parameters()}

    @property
    def needs_prologue(self) -> bool:
        return self.old_lp is not None or self.behaviour is not None

    def buffers(self) -> dict:
        """Every tensor a pass reads and writes in place."""
        return {"optimizer": self.optimizer.buffers(), "batch": self.batch,
                "scalars": [self.lr, self.vf_coeff, self.ent_coeff],
                "pass": self.pass_index, "table": self.table,
                "old_lp": self.old_lp, "behaviour": self.behaviour}

    def begin(self, timestep, lr, index_table: torch.Tensor = None):
        """The host's work before the passes: the learning rate ``lr`` and
        the schedules' values at ``timestep`` into their scalars, the pass
        counter to 0 and, for a shuffled sweep, the table: one permutation
        of the envs an epoch drawn from the generator, or ``index_table``
        ``(passes, E // num_minibatches)``.  The tracer's span
        ``update.begin``."""
        span = trace.begin("update.begin") if trace.ON else 0
        self._begin(timestep, lr, index_table)
        if span:
            trace.end(span)

    def _begin(self, timestep, lr, index_table):
        opts, mesh = self.opts, self.mesh
        if trace.ON:
            trace.count_scalar_write()
        self.lr.fill_(float(lr))
        self.algo.vf_loss_coeff_schedule.write_to(self.vf_coeff, timestep)
        self.algo.entropy_coeff_schedule.write_to(self.ent_coeff, timestep)
        self.pass_index.zero_()
        self._host_pass = 0
        if opts.passes == 1:
            return
        device = self.batch["done"].device
        E = self.mb * opts.num_minibatches
        if opts.shuffle:
            if index_table is None:
                # every rank draws (its stream stays where the plain
                # trainer's would be) and takes rank 0's permutation
                index_table = torch.stack([
                    torch.randperm(E, generator=self.generator, device=device)
                    for _ in range(opts.num_epochs)
                ]).reshape(opts.passes, self.mb)
                if mesh is not None:
                    mesh.broadcast(index_table)
            assert tuple(index_table.shape) == (opts.passes, self.mb)
            if mesh is None:
                self.table.copy_(index_table)
                return
            # this rank's rows of each, in table order
            lo = mesh.env_rank * self.batch["done"].shape[1]
            hi = lo + self.batch["done"].shape[1]
            self._blocks = [b[(b >= lo) & (b < hi)] - lo
                            for b in index_table.to(device, torch.long)]
            return
        assert index_table is None, "contiguous slices draw no table"
        if mesh is not None:
            lo = mesh.env_rank * self.batch["done"].shape[1]
            hi = lo + self.batch["done"].shape[1]
            mb = self.mb
            self._blocks = [slice(min(max(m * mb, lo), hi) - lo,
                                  min(max((m + 1) * mb, lo), hi) - lo)
                            for m in range(opts.num_minibatches)
                            ] * opts.num_epochs

    @torch.no_grad()
    def prologue(self):
        """PPO over more than one pass: the behaviour log-probs of the
        stored batch, or the behaviour parameters, into their buffers."""
        if self.old_lp is not None:
            batch = self.batch
            self.old_lp.copy_(_logp_and_entropy(
                _forward(self.model, batch["obs"], batch.get("mask"))[0],
                batch["actions"])[0])
        if self.behaviour is not None:
            for name, p in self.model.named_parameters():
                self.behaviour[name].copy_(p)

    def _derive(self, rows_of):
        """The policy's observations and mask of the env rows ``rows_of``
        picks from each ``(T, E, ...)`` state entry: ``(B1, B2, A, F)``."""
        picked = {k: rows_of(v) for k, v in self.batch["phys"].items()}
        lead = next(iter(picked.values())).shape[:2]
        derived = self.observe({k: v.reshape((-1,) + v.shape[2:])
                                for k, v in picked.items()})
        obs, mask = derived if isinstance(derived, tuple) else (derived,
                                                                None)
        return tuple(None if x is None else x.reshape(lead + x.shape[1:])
                     for x in (obs, mask))

    def _slicers(self):
        """``(take, rows)`` of this pass's env block: time-major ``(T,
        E_mb, ...)`` and env-major ``(E_mb, T, ...)`` selections."""
        if self.mesh is None:
            block = self.table.index_select(0, self.pass_index).reshape(-1)
        else:
            block = self._blocks[self._host_pass]
        if isinstance(block, slice):
            return (lambda x: x[:, block],
                    lambda x: x.transpose(0, 1)[block])
        return (lambda x: x.index_select(1, block),
                lambda x: x.transpose(0, 1).index_select(0, block))

    def run_pass(self, full: bool = True) -> dict:
        """One pass: forward, loss, gradients and the optimizer's step, in
        place; the pass counter advances.  ``full`` returns the pass's
        metric tensors with its gradient norm; otherwise (the hot, metrics-
        free pass) none are computed and ``{}`` is returned, with the same
        parameters."""
        batch, opts = self.batch, self.opts
        actions, rewards, done = (batch["actions"], batch["rewards"],
                                  batch["done"])
        old_lp = None
        if opts.passes == 1:
            obs, mask = ((batch["obs"], batch.get("mask")) if self.stored
                         else self._derive(lambda x: x))
            logits_list, values = _forward(self.forward, obs, mask)
        else:
            take, rows = self._slicers()
            if self.stored:
                mask = batch.get("mask")
                obs = rows(batch["obs"]).contiguous()
                mask = None if mask is None else rows(mask).contiguous()
            else:
                obs, mask = self._derive(rows)
            actions, rewards, done = take(actions), take(rewards), take(done)
            if self.old_lp is not None:
                old_lp = take(self.old_lp)
            if self.behaviour is not None:
                with torch.no_grad():
                    logits0, _ = _to_time_major(*functional_call(
                        self.model, self.behaviour,
                        (obs,) if mask is None else (obs, mask)))
                    old_lp = _logp_and_entropy(logits0, actions)[0]
            logits_list, values = _to_time_major(
                *_forward(self.forward, obs, mask))
        loss, metrics = self.algo.compute_loss_and_metrics(
            None, actions, rewards, done, logits_list, values,
            negative_positive_ratio=self.negative_positive_ratio,
            generator=self.generator, old_log_prob=old_lp, group=self.mesh,
            coeffs=(self.vf_coeff, self.ent_coeff), with_metrics=full)
        grads = torch.autograd.grad(loss, self.params)
        if self.mesh is not None:
            grads = self.mesh.reduce_grads(grads)
        g_norm = self.optimizer.step(dict(zip(self.names, grads)), self.lr)
        self.pass_index.add_(1)
        self._host_pass += 1
        if full:
            metrics["Gradient norm"] = g_norm
        return metrics

    @staticmethod
    def finish(metrics: dict, timestep, lr) -> dict:
        """A full update's metrics with the host's timestep and learning
        rate."""
        return {**metrics, "Current timestep": float(timestep),
                "Learning rate": float(lr)}


class TrainerA2C(TrainerBase):
    """A2C/PPO trainer over one or more policies."""

    def __init__(self, env_wrapper=None, config=None, **kwargs):
        super().__init__(env_wrapper=env_wrapper, config=config, **kwargs)
        # update_recompute_obs: on split-step envs the rollout records each
        # step's pre-step state instead of observations, and the update
        # derives each slice's observations from it (engine.observe)
        self._recompute_obs = (
            bool(config["trainer"].get("update_recompute_obs", False))
            and self.engine.has_split_step
        )

        self.algorithms = {}
        self.lr_schedules = {}
        self.optimizers = {}
        self.update_options = {}
        self._head_dims = {}
        self.engine.reset_all_envs()  # the initial state as built
        init_gen = torch.Generator(device=self.device)
        init_gen.manual_seed(self.seed)

        for tag in self.policies:
            policy_cfg = config["policy"][tag]
            heads, _, is_det = self._action_heads(tag)
            assert not is_det, (
                "A2C/PPO need categorical action spaces; TrainerDDPG trains "
                "Box actions"
            )
            self._head_dims[tag] = heads
            model_cfg = policy_cfg["model"]
            model_cls = ModelFactory.create(model_cfg["type"])
            model_kwargs = {}
            if model_cfg.get("dtype"):  # e.g. "bfloat16"
                model_kwargs["dtype"] = torch_dtype(model_cfg["dtype"])
            self.models[tag] = model_cls(
                self._policy_obs_sizes(tag)[0], tuple(model_cfg["fc_dims"]),
                tuple(heads),
                generator=init_gen, device=self.device, **model_kwargs,
            )
            if self.mesh is not None:  # every rank starts from rank 0's
                self.mesh.broadcast_module(self.models[tag])

            algo_name = policy_cfg.get("algorithm", "A2C").upper()
            common = dict(
                discount_factor_gamma=policy_cfg.get("gamma", 0.98),
                normalize_advantage=policy_cfg.get("normalize_advantage", False),
                normalize_return=policy_cfg.get("normalize_return", False),
                vf_loss_coeff=policy_cfg.get("vf_loss_coeff", 0.01),
                entropy_coeff=policy_cfg.get("entropy_coeff", 0.01),
            )
            if algo_name == "A2C":
                self.algorithms[tag] = A2C(**common)
            elif algo_name == "PPO":
                self.algorithms[tag] = PPO(
                    clip_param=policy_cfg.get("clip_param", 0.1), **common
                )
            else:
                raise NotImplementedError(
                    f"TrainerA2C supports A2C/PPO, got {algo_name!r}"
                )
            num_epochs = int(policy_cfg.get("num_epochs", 1))
            self.update_options[tag] = UpdateOptions(
                num_epochs=num_epochs,
                num_minibatches=int(policy_cfg.get("num_minibatches", 1)),
                # a multi-epoch sweep reshuffles unless told otherwise
                shuffle=bool(policy_cfg.get("shuffle_minibatches",
                                            num_epochs > 1)),
                remat=bool(policy_cfg.get("remat", False)),
            )
            # accepted as the JAX trainer accepts it; every value runs the
            # one env-major slice layout of UpdatePass
            env_major = policy_cfg.get("env_major", "auto")
            assert env_major in (True, False, "auto"), env_major
            assert self.num_envs % self.update_options[tag].num_minibatches \
                == 0, "num_minibatches must divide num_envs (env-axis slicing)"
            self.lr_schedules[tag] = ParamScheduler(policy_cfg.get("lr", 1e-3))
            max_norm = (policy_cfg.get("max_grad_norm", 0.5)
                        if policy_cfg.get("clip_grad_norm", True) else None)
            self.optimizers[tag] = ClippedAdam(
                dict(self.models[tag].named_parameters()), max_norm=max_norm,
                mesh=self.mesh,
            )
            ckpt = model_cfg.get("model_ckpt_filepath", "")
            if ckpt:
                self.load_model_checkpoint({tag: ckpt})

        self._env_state = self._rollout_env_state()
        self._batch = None  # the rollout's buffers, made at first use
        self._update_passes = None  # each policy's, with the programs

    # ------------------------------------------------------------ rollout
    def _make_batch(self) -> dict:
        """The rollout's buffers: per policy its flattened observations in
        ``trainer.batch_dtype`` and its float32 action mask where it has
        one -- or, under ``update_recompute_obs``, one ``(T, E, ...)`` copy
        of every state entry but the done flags and rewards --, actions and
        rewards, and the done flags."""
        T, E = self.training_batch_size_per_env, self.local_envs
        batch = {"done": torch.zeros((T, E), dtype=torch.int32,
                                     device=self.device)}
        if self._recompute_obs:
            batch["phys"] = {
                k: torch.empty((T,) + tuple(v.shape), dtype=v.dtype,
                               device=self.device)
                for k, v in self._env_state.items()
                if k != _DONE and not k.startswith(_REWARDS)
            }
        for tag, ids in self.policy_tag_to_agent_id_map.items():
            A, C = len(ids), len(self._head_dims[tag])
            if not self._recompute_obs:
                features, mask = self._policy_obs_sizes(tag)
                batch[f"obs_{tag}"] = torch.empty(
                    (T, E, A, features), dtype=self.batch_dtype,
                    device=self.device)
                if mask is not None:
                    batch[f"mask_{tag}"] = torch.empty(
                        (T, E, A, mask), dtype=torch.float32,
                        device=self.device)
            batch[f"actions_{tag}"] = torch.empty(
                (T, E, A, C), dtype=torch.int32, device=self.device)
            batch[f"rewards_{tag}"] = torch.empty(
                (T, E, A), dtype=torch.float32, device=self.device)
        return batch

    @torch.no_grad()
    def _rollout(self, actions: torch.Tensor = None) -> dict:
        """``training_batch_size_per_env`` steps from the trainer's env
        state, each a call of :meth:`_rollout_step`; returns the batch,
        time-major.  ``actions`` (T, E, N, C), when given, replaces the
        policies' draws (for tests that replay recorded actions); under a
        mesh, of the global envs or of the rank's rows."""
        if self._batch is None:
            self._batch = self._make_batch()
        if actions is not None and actions.shape[1] != self.local_envs:
            actions = actions[:, self.env_rows]
        self._rollout_steps(lambda t: self._rollout_step(
            self._batch, None if actions is None else actions[t]))
        return self._batch

    @torch.no_grad()
    def _rollout_step(self, batch: dict, actions: torch.Tensor = None):
        """One rollout step: the body of the JAX trainer's rollout scan
        (``warpdrive_tpu/training/trainer_a2c.py:372``) and of the captured
        rollout-step program.  It writes row ``self._row`` (a device step
        counter) of every batch buffer with ``index_copy_``, as
        ``lax.scan`` stacks its outputs, so the program does not depend on
        T; advances the static env state and the episodic accounting in
        place; and advances the counter.  ``actions`` ``(E, N, C)`` replace
        the draws (eager only).  On the eager backend the engine steps its
        own state on the host; the rest of the step is
        :meth:`_step_and_record`'s."""
        engine = self.engine
        row = self._row
        state = dict(engine.state) if self._is_eager else self._env_state
        if self._recompute_obs:
            # copies: later steps must not write into the record
            for name, buf in batch["phys"].items():
                buf.index_copy_(0, row, state[name][None])
        obs_all = engine.observe(state) if engine.has_split_step else None
        per_policy = {}
        for tag in self.policies:
            obs_p, mask_p = self._policy_obs_and_mask(state, obs_all, tag)
            store = batch.get(f"obs_{tag}")
            if store is not None:
                store.index_copy_(0, row, obs_p[None].to(store.dtype))
                if mask_p is not None:
                    record = batch[f"mask_{tag}"]
                    record.index_copy_(0, row, mask_p[None].to(record.dtype))
            if actions is None:
                logits_list, _ = _forward(self.models[tag], obs_p, mask_p)
                acts = sample_heads(logits_list, self.generator)
            else:
                acts = actions[:, self._agent_ids[tag]]
            record = batch[f"actions_{tag}"]
            record.index_copy_(0, row, acts[None].to(record.dtype))
            per_policy[tag] = acts
        self._step_and_record(state, per_policy, batch)

    # ------------------------------------------------------- the programs
    def _build_programs(self):
        """The captured programs over the static carry (env state,
        episodic accounting, batch, parameters, optimizer states): the
        rollout step, and per trained policy the update pass in its hot
        (metrics-free) and full variants and, for PPO over more than one
        pass, the prologue (:meth:`TrainerBase._program`).  The rollout
        step computes no metric, so its two variants are one program."""
        if self._batch is None:
            self._batch = self._make_batch()
        batch = self._batch
        models = {tag: list(m.parameters()) for tag, m in self.models.items()}
        programs = {}
        if not self._is_eager:  # the device engine
            programs["rollout"] = self._program(
                lambda: self._rollout_step(batch),
                {"env_state": self._env_state, "batch": batch,
                 "row": self._row,
                 "episodes": [self._ep_acc, self._ep_sum, self._ep_count],
                 "models": models},
                "rollout step")
        self._update_passes = {}
        for tag in self.policies_to_train:
            update = self._update_pass(tag, batch)
            self._update_passes[tag] = update
            buffers = update.buffers()
            for variant in ("hot", "full"):
                programs[tag, variant] = self._program(
                    lambda u=update, full=variant == "full":
                        u.run_pass(full=full),
                    buffers, f"{tag} update pass ({variant})")
            trace.record_update_passes(programs[tag, "hot"].name,
                                       update.opts.passes)
            if update.needs_prologue:
                programs[tag, "prologue"] = self._program(
                    update.prologue, buffers, f"{tag} update prologue")
        self._programs = programs

    def release_programs(self):
        """Drop the captured programs, and with them their graphs' memory
        pool and the update passes' hold on the batch; the next iteration
        builds and captures them again."""
        self._update_passes = None
        super().release_programs()

    def _rollout_programmed(self, timestep):
        """The rollout as ``training_batch_size_per_env`` calls of the
        rollout-step program into the static batch (on the eager backend,
        which steps the host, the eager rollout).  No schedule of the
        rollout reads ``timestep``."""
        if self._programs is None:
            self._build_programs()
        if self._is_eager:
            self._rollout()
            return
        step = self._programs["rollout"]
        self._rollout_steps(lambda t: step())

    def _update_programmed(self, timestep, full: bool = True,
                           index_tables: dict = None) -> dict:
        """Every trained policy's update on the static batch: the host's
        :meth:`UpdatePass.begin` (``index_tables`` ``{tag: (passes,
        E_mb)}``, where given, replace a shuffled sweep's draws), the
        prologue program where PPO needs one, then ``passes`` calls of the
        hot or the full pass program.  The full variant returns the metric
        tensors per policy, the hot one ``{}``."""
        if self._programs is None:
            self._build_programs()
        metrics = {}
        for tag in self.policies_to_train:
            update = self._update_passes[tag]
            lr = self.lr_schedules[tag].value_at(timestep)
            update.begin(timestep, lr, (index_tables or {}).get(tag))
            if update.needs_prologue:
                self._programs[tag, "prologue"]()
            one_pass = self._programs[tag, "full" if full else "hot"]
            if self.mesh is not None and update.opts.passes > 1:
                # each rank's rows of a slice are chosen on the host
                # (UpdatePass.begin): these passes run as called
                one_pass = one_pass.body
            for _ in range(update.opts.passes):
                out = one_pass()
            if full:
                metrics[tag] = update.finish(out, timestep, lr)
        return metrics

    # ------------------------------------------------- acting outside training
    def _act_fn(self, state: dict, use_argmax: bool = True,
                generator: torch.Generator = None,
                return_logits: bool = False):
        per_policy, logits_of = {}, {}
        for tag in self.policies:
            obs_p, mask_p = self._policy_obs_and_mask(state, None, tag)
            logits_list, _ = _forward(self.models[tag], obs_p, mask_p)
            logits_of[tag] = logits_list
            per_policy[tag] = sample_heads(logits_list, generator,
                                           use_argmax=use_argmax)
        actions = self._merge_actions(per_policy)
        return (actions, logits_of) if return_logits else actions

    # ------------------------------------------------- full-state checkpoints
    def _training_state(self) -> dict:
        return {
            "models": {tag: m.state_dict() for tag, m in self.models.items()},
            "optimizers": {tag: opt.state_dict()
                           for tag, opt in self.optimizers.items()},
            "env_state": self._env_state,
            "episodes": {"acc": self._ep_acc, "sum": self._ep_sum,
                         "count": self._ep_count},
        }

    def _load_training_state(self, state: dict):
        """Into the live buffers: a built program keeps its storages."""
        for tag, model in self.models.items():
            model.load_state_dict(state["models"][tag])
            self.optimizers[tag].load_state_dict(state["optimizers"][tag])
        assign_state(self._env_state, {
            k: v.to(self.device) for k, v in state["env_state"].items()})
        episodes = state["episodes"]
        self._ep_acc.copy_(episodes["acc"])
        self._ep_sum.copy_(episodes["sum"])
        self._ep_count.copy_(episodes["count"])

    # ------------------------------------------------------------- update
    def _policy_batch(self, batch: dict, tag: str) -> dict:
        if self._recompute_obs:
            obs = {"phys": batch["phys"]}
        else:
            obs = {"obs": batch[f"obs_{tag}"]}
            if f"mask_{tag}" in batch:
                obs["mask"] = batch[f"mask_{tag}"]
        return {**obs,
                "actions": batch[f"actions_{tag}"],
                "rewards": batch[f"rewards_{tag}"],
                "done": batch["done"]}

    def _observe_policy(self, tag: str):
        """``update_recompute_obs``: env rows ``(R, ...)`` of the recorded
        state -> the policy's ``(R, A, F)`` observations, one kNN launch
        (and its mask, where the env keeps an ``action_mask`` array)."""
        def observe(rows):
            obs, mask = self._policy_obs_and_mask(
                rows, self.engine.observe(rows), tag)
            return obs if mask is None else (obs, mask)

        return observe

    def _update_pass(self, tag: str, batch: dict) -> UpdatePass:
        return UpdatePass(
            self.models[tag], self.optimizers[tag], self.algorithms[tag],
            self._policy_batch(batch, tag), self.update_options[tag],
            observe=(self._observe_policy(tag) if self._recompute_obs
                     else None),
            mesh=self.mesh, negative_positive_ratio=self.neg_pos_env_ratio,
            generator=self.generator)

    def _update(self, batch: dict, timestep, index_tables: dict = None
                ) -> dict:
        """Every trained policy's full update on ``batch`` (what the
        rollout records, in the static batch's dtypes and shapes), copied
        into the static batch and run through the programs as
        :meth:`_iteration` runs them; metric tensors per policy.
        ``index_tables`` ``{tag: (passes, E_mb)}`` replace a shuffled
        sweep's draws."""
        if self._programs is None:
            self._build_programs()
        assign_state(self._batch, batch)
        with self._program_calls():
            return self._update_programmed(timestep, True, index_tables)
