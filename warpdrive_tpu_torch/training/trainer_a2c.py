"""
TrainerA2C: on-policy trainer for A2C and PPO policies.

The port's counterpart of ``warpdrive_tpu/training/trainer_a2c.py``.  One
iteration runs, eagerly on the engine's device:

  rollout, ``training_batch_size_per_env`` steps of
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
  then, per trained policy, :func:`policy_update`:
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
from warpdrive_tpu_torch.models.factory import ModelFactory
from warpdrive_tpu_torch.parallel.mesh import MODEL_AXIS, tp_axis, tp_shard
from warpdrive_tpu_torch.sampling.samplers import sample_from_logits
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
        self.count = 0
        self.mesh = mesh if mesh is not None and mesh.tp > 1 else None
        self._axes = {n: (tp_axis(p.shape, self.mesh.tp)
                          if self.mesh is not None else None)
                      for n, p in params.items()}
        self.mu = {n: torch.zeros_like(self._shard(p))
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(self._shard(p))
                   for n, p in params.items()}

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
        ``models.fully_connected.adam_state_from_optax``), whole."""
        self.count = int(state["count"])
        for name, p in self.params.items():
            for moments in ("mu", "nu"):
                whole = state[moments][name].to(p.device, p.dtype)
                getattr(self, moments)[name] = self._shard(whole).clone()

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
        parameter) at learning rate ``lr``; returns the gradients' global
        norm before clipping."""
        device = next(iter(self.params.values())).device
        grads = {n: self._shard(g) for n, g in grads.items()}
        g_norm = self._global_norm(grads)
        if self.max_norm is not None:
            keep = g_norm < self.max_norm
            grads = {n: torch.where(keep, g, (g / g_norm) * self.max_norm)
                     for n, g in grads.items()}
        self.count += 1
        # bias corrections and the learning rate as 0-dim device tensors:
        # CUDA divides by a host scalar through its reciprocal
        f32 = np.float32
        bc1 = torch.tensor(f32(1) - f32(self.b1) ** f32(self.count),
                           device=device)
        bc2 = torch.tensor(f32(1) - f32(self.b2) ** f32(self.count),
                           device=device)
        lr_t = torch.tensor(f32(lr), device=device)
        for name, p in self.params.items():
            g = grads[name]
            mu = (1 - self.b1) * g + self.b1 * self.mu[name]
            nu = (1 - self.b2) * (g * g) + self.b2 * self.nu[name]
            self.mu[name], self.nu[name] = mu, nu
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
    and gradients."""
    if not remat:
        return module

    def apply(*args):
        return checkpoint(module, *args, use_reentrant=False)

    return apply


def _forward(model, obs, mask):
    """``model``'s forward with the action mask where there is one."""
    return model(obs) if mask is None else model(obs, mask)


def _to_time_major(logits_list, values):
    return [lg.transpose(0, 1) for lg in logits_list], values.transpose(0, 1)


def policy_update(model, optimizer: ClippedAdam, algo, batch: dict,
                  timestep, lr, negative_positive_ratio: float = -1.0,
                  generator: torch.Generator = None,
                  options: UpdateOptions = None,
                  index_table: torch.Tensor = None,
                  observe=None, mesh=None) -> dict:
    """One policy's update on its batch ``{"actions" (T, E, A, C),
    "rewards" (T, E, A), "done" (T, E)}`` with the observations either
    stored, ``"obs"`` (T, E, A, F), or derived: ``"phys"``, the pre-step
    state entries ``(T, E, ...)``, which ``observe`` maps, given as ``(R,
    ...)`` env rows, to the policy's ``(R, A, F)`` observations (or to
    ``(observations, mask)``).  A stored ``"mask"`` (T, E, A, M), 1 keep
    and 0 forbid, goes onto the logits of every forward, as the JAX
    trainer's ``mask_b``.

    One pass (the default ``options``) forwards the whole batch.  More
    passes sweep env-axis slices, each with its own returns, gradients and
    optimizer step; a shuffled sweep draws one permutation of the envs an
    epoch from ``generator`` unless ``index_table`` ``(passes, E //
    num_minibatches)`` gives them.  A slice's rows go through the model
    env-major, ``(E_mb, T, A, F)``, copied into one contiguous block, and
    its logits and values back to time-major for the loss; this is the
    layout the JAX trainer's ``env_major`` relayout gives its slices, so
    every value of that option runs this one path.  PPO over more than one
    pass holds its ratio to the
    behaviour log-probs of the parameters before the first pass: from one
    forward of the stored batch, or of each derived slice.  Returns the
    metric tensors of the last pass, with its own gradient norm.

    Under a ``mesh`` the batch holds the rank's env rows: the loss and
    metrics are global over the env group (``group`` of the algorithms),
    the gradients are summed over it before the optimizer's step, and a
    sweep's slices are of the global env axis (a shuffled one from rank
    0's permutation), each rank taking its rows of each."""
    opts = options or UpdateOptions()
    names = [n for n, _ in model.named_parameters()]
    params = [optimizer.params[n] for n in names]
    forward = remat_apply(model, opts.remat)
    actions, rewards, done = batch["actions"], batch["rewards"], batch["done"]
    loss_kw = dict(negative_positive_ratio=negative_positive_ratio,
                   generator=generator,
                   group=mesh)
    stored = "obs" in batch

    def derive(rows_of):
        """The policy's observations and mask of the env rows ``rows_of``
        picks from each ``(T, E, ...)`` state entry: ``(B1, B2, A, F)``."""
        picked = {k: rows_of(v) for k, v in batch["phys"].items()}
        lead = next(iter(picked.values())).shape[:2]
        derived = observe({k: v.reshape((-1,) + v.shape[2:])
                           for k, v in picked.items()})
        obs, mask = derived if isinstance(derived, tuple) else (derived,
                                                                None)
        return tuple(None if x is None else x.reshape(lead + x.shape[1:])
                     for x in (obs, mask))

    def step(loss):
        grads = torch.autograd.grad(loss, params)
        if mesh is not None:
            grads = mesh.reduce_grads(grads)
        return optimizer.step(dict(zip(names, grads)), lr)

    if opts.passes == 1:
        obs, mask = ((batch["obs"], batch.get("mask")) if stored
                     else derive(lambda x: x))
        logits_list, values = _forward(forward, obs, mask)
        loss, metrics = algo.compute_loss_and_metrics(
            timestep, actions, rewards, done, logits_list, values, **loss_kw)
        metrics["Gradient norm"] = step(loss)
    else:
        metrics = _sweep(model, forward, algo, batch, timestep, step, derive,
                         opts, index_table, generator, loss_kw, mesh)
    metrics["Current timestep"] = float(timestep)
    metrics["Learning rate"] = float(lr)
    return metrics


def _sweep(model, forward, algo, batch, timestep, step, derive, opts,
           index_table, generator, loss_kw, mesh=None) -> dict:
    """The epoch x minibatch passes of :func:`policy_update`."""
    actions, rewards, done = batch["actions"], batch["rewards"], batch["done"]
    # the slices are of the global env axis; this rank holds rows lo..hi
    E = done.shape[1] * (1 if mesh is None else mesh.dp)
    lo = 0 if mesh is None else mesh.env_rank * done.shape[1]
    hi = lo + done.shape[1]
    assert E % opts.num_minibatches == 0, (
        "num_minibatches must divide num_envs (env-axis slicing)")
    mb = E // opts.num_minibatches
    stored = "obs" in batch
    old_lp, behaviour = None, None
    if isinstance(algo, PPO):
        if stored:
            with torch.no_grad():
                old_lp = _logp_and_entropy(
                    _forward(model, batch["obs"], batch.get("mask"))[0],
                    actions)[0]
        else:
            # derived observations: the behaviour log-probs of each slice,
            # from these parameters, so the batch is never whole
            behaviour = {n: p.detach().clone()
                         for n, p in model.named_parameters()}

    if opts.shuffle:
        if index_table is None:
            # every rank draws (its stream stays where the plain trainer's
            # would be) and takes rank 0's permutation
            index_table = torch.stack([
                torch.randperm(E, generator=generator, device=done.device)
                for _ in range(opts.num_epochs)
            ]).reshape(opts.passes, mb)
            if mesh is not None:
                mesh.broadcast(index_table)
        assert tuple(index_table.shape) == (opts.passes, mb)
        blocks = list(index_table.to(done.device, torch.long))
        if mesh is not None:  # this rank's rows of each, in table order
            blocks = [b[(b >= lo) & (b < hi)] - lo for b in blocks]
    else:
        assert index_table is None, "contiguous slices draw no table"
        blocks = [slice(min(max(m * mb, lo), hi) - lo,
                        min(max((m + 1) * mb, lo), hi) - lo)
                  for m in range(opts.num_minibatches)] * opts.num_epochs

    for block in blocks:
        if opts.shuffle:
            def take(x, block=block):  # time-major (T, E_mb, ...)
                return x.index_select(1, block)

            def rows(x, block=block):  # env-major (E_mb, T, ...)
                return x.transpose(0, 1).index_select(0, block)
        else:
            def take(x, block=block):
                return x[:, block]

            def rows(x, block=block):
                return x.transpose(0, 1)[block]

        if stored:
            mask = batch.get("mask")
            obs = rows(batch["obs"]).contiguous()
            mask = None if mask is None else rows(mask).contiguous()
        else:
            obs, mask = derive(rows)
        act = take(actions)
        mb_old_lp = None if old_lp is None else take(old_lp)
        if behaviour is not None:
            with torch.no_grad():
                logits0, _ = _to_time_major(*functional_call(
                    model, behaviour,
                    (obs,) if mask is None else (obs, mask)))
                mb_old_lp = _logp_and_entropy(logits0, act)[0]
        logits_list, values = _to_time_major(*_forward(forward, obs, mask))
        loss, metrics = algo.compute_loss_and_metrics(
            timestep, act, take(rewards), take(done), logits_list, values,
            old_log_prob=mb_old_lp, **loss_kw)
        metrics["Gradient norm"] = step(loss)
    return metrics


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
                "A2C/PPO need categorical action spaces; DDPG (ROADMAP "
                "queue 1, item 7) trains Box actions"
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
            # one env-major slice layout of policy_update
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
        self._ep_acc = torch.zeros((self.local_envs, self.engine.n_agents),
                                   dtype=torch.float32, device=self.device)
        self._ep_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        self._ep_count = torch.zeros((), dtype=torch.float32,
                                     device=self.device)
        self._batch = None  # the rollout's buffers, made at first use

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
        state; returns the batch, time-major.  ``actions`` (T, E, N, C),
        when given, replaces the policies' draws (for tests that replay
        recorded actions); under a mesh, of the global envs or of the
        rank's rows."""
        if self._batch is None:
            self._batch = self._make_batch()
        batch = self._batch
        engine = self.engine
        # the eager backend's engine holds the rollout's state itself
        state = dict(engine.state) if self._is_eager else self._env_state
        split = engine.has_split_step
        if actions is not None and actions.shape[1] != self.local_envs:
            actions = actions[:, self.env_rows]
        for t in range(self.training_batch_size_per_env):
            if self._recompute_obs:
                # copies: later steps must not write into the record
                for name, buf in batch["phys"].items():
                    buf[t].copy_(state[name])
            obs_all = engine.observe(state) if split else None
            per_policy = {}
            for tag in self.policies:
                store = batch.get(f"obs_{tag}")
                obs_p, mask_p = self._policy_obs_and_mask(
                    state, obs_all, tag,
                    out=None if store is None else store[t])
                if mask_p is not None and store is not None:
                    batch[f"mask_{tag}"][t] = mask_p
                if actions is None:
                    logits_list, _ = _forward(self.models[tag], obs_p,
                                              mask_p)
                    acts = torch.stack(
                        [sample_from_logits(logits, self.generator)
                         for logits in logits_list], dim=-1)
                else:
                    acts = actions[t][:, self._agent_ids[tag]]
                batch[f"actions_{tag}"][t] = acts
                per_policy[tag] = acts
            actions_all = self._merge_actions(per_policy)
            if self._is_eager:  # the actions to the host, one host step
                state = engine.step_all_envs(actions_all)
            else:
                state = (engine.step_physics(state, actions_all) if split
                         else engine.step(state, actions_all))

            rewards = engine.rewards_of(state)
            done = state[_DONE]
            for tag in self.policies:
                if engine.separate_placeholders:
                    batch[f"rewards_{tag}"][t] = state[f"{_REWARDS}_{tag}"]
                else:
                    torch.index_select(rewards, 1, self._agent_ids[tag],
                                       out=batch[f"rewards_{tag}"][t])
            batch["done"][t] = done

            # episodic reward bookkeeping
            self._ep_acc = self._ep_acc + rewards
            done_mask = (done > 0).to(torch.float32)
            self._ep_sum = self._ep_sum + (self._ep_acc.mean(dim=1)
                                           * done_mask).sum()
            self._ep_count = self._ep_count + done_mask.sum()
            self._ep_acc = self._ep_acc * (1.0 - done_mask)[:, None]

            if self._is_eager:
                engine.reset_only_done_envs()
                state = dict(engine.state)
            else:
                state = engine.auto_reset(state, self.generator)
        self._env_state = state
        # keep the engine facade on the live state; on the split path
        # observations and actions are not carried and keep their
        # placeholders
        engine.state = {**engine.state, **state}
        return batch

    # ------------------------------------------------- acting outside training
    def _act_fn(self, state: dict, use_argmax: bool = True,
                generator: torch.Generator = None,
                return_logits: bool = False):
        per_policy, logits_of = {}, {}
        for tag in self.policies:
            obs_p, mask_p = self._policy_obs_and_mask(state, None, tag)
            logits_list, _ = _forward(self.models[tag], obs_p, mask_p)
            logits_of[tag] = logits_list
            per_policy[tag] = torch.stack(
                [sample_from_logits(logits, generator, use_argmax=use_argmax)
                 for logits in logits_list], dim=-1)
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
        for tag, model in self.models.items():
            model.load_state_dict(state["models"][tag])
            self.optimizers[tag].load_state_dict(state["optimizers"][tag])
        self._env_state = dict(state["env_state"])
        episodes = state["episodes"]
        self._ep_acc = episodes["acc"]
        self._ep_sum = episodes["sum"]
        self._ep_count = episodes["count"]

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

    def _update(self, batch: dict, timestep, index_tables: dict = None
                ) -> dict:
        """Every trained policy's update on ``batch``; metric tensors per
        policy.  ``index_tables`` ``{tag: (passes, E_mb)}`` replaces a
        shuffled sweep's draws."""
        metrics = {}
        for tag in self.policies_to_train:
            metrics[tag] = policy_update(
                self.models[tag], self.optimizers[tag], self.algorithms[tag],
                self._policy_batch(batch, tag), timestep,
                self.lr_schedules[tag].value_at(timestep),
                negative_positive_ratio=self.neg_pos_env_ratio,
                generator=self.generator,
                options=self.update_options[tag],
                index_table=(index_tables or {}).get(tag),
                observe=(self._observe_policy(tag) if self._recompute_obs
                         else None),
                mesh=self.mesh,
            )
        return metrics

    _update_phase = _update
