"""
TrainerA2C: on-policy trainer for A2C and PPO policies.

The port's counterpart of ``warpdrive_tpu/training/trainer_a2c.py``.  One
iteration runs, eagerly on the engine's device:

  rollout, ``training_batch_size_per_env`` steps of
      the observation of every agent: on the split path (TagContinuous)
      ``observe``, the kNN observation (on a card, one kernel launch), on
      the full-step path the observations the last step wrote
      per-policy model forward and categorical sampling
      ``step_physics`` (split) or the env's whole ``step`` (full),
      per-policy rewards and done flags
      episodic-reward bookkeeping and done-driven auto-reset (with a reset
      pool, the refresh of the reset envs' observations)
  then, per trained policy:
      whole-batch forward, the A2C or PPO loss, and :class:`ClippedAdam`:
      clip-by-global-norm, Adam and the scheduled learning rate, the rule
      of the JAX trainer's ``optax.chain(clip_by_global_norm(max_norm),
      scale_by_adam(), scale(-1))`` times ``lr_t``.

Evaluation and episode fetching act through ``_act_fn`` (the most likely
action, or one drawn from the evaluation generator), and
``fetch_episode_states(include_probabilities=True)`` adds each policy's
action probabilities, the softmax of the logits that chose the actions;
full-state checkpoints hold the models, the
optimizer states, the rollout's env state and the episodic accounting.

The policy matrix products and their backward pass are ``torch.matmul`` and
autograd, which the JAX package leaves to XLA; they run in float32.

Left out, each raising ``NotImplementedError`` that names its ROADMAP item
(queue 1, item 4 unless stated): multi-epoch and minibatched PPO, the
env-major relayout, ``remat``, ``batch_dtype``, ``update_recompute_obs``
and the model ``dtype`` option (item 3).
"""

from __future__ import annotations

import numpy as np
import torch

from warpdrive_tpu_torch.algos.policygradient import A2C, PPO
from warpdrive_tpu_torch.models.factory import ModelFactory
from warpdrive_tpu_torch.sampling.samplers import sample_from_logits
from warpdrive_tpu_torch.training.param_scheduler import ParamScheduler
from warpdrive_tpu_torch.training.trainer_base import TrainerBase, not_ported
from warpdrive_tpu_torch.utils.constants import Constants

_DONE = Constants.DONE
_OBS = Constants.OBSERVATIONS


class ClippedAdam:
    """One policy's optimizer: optax's ``clip_by_global_norm(max_norm)``
    (when ``max_norm`` is set), ``scale_by_adam()`` with its defaults and
    ``scale(-1)``, then the learning-rate multiply, applied in place.

    Unlike ``torch.nn.utils.clip_grad_norm_``, which scales by
    ``max_norm / (norm + 1e-6)`` always, optax scales by ``max_norm / norm``
    and only when ``norm >= max_norm``; this class follows optax.
    """

    def __init__(self, params: dict, max_norm: float = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = params  # name -> Parameter
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": {n: t.clone() for n, t in self.mu.items()},
                "nu": {n: t.clone() for n, t in self.nu.items()}}

    def load_state_dict(self, state: dict):
        """Take ``{"count", "mu", "nu"}`` (e.g. from
        ``models.fully_connected.adam_state_from_optax``)."""
        self.count = int(state["count"])
        for name, p in self.params.items():
            self.mu[name] = state["mu"][name].to(p.device, p.dtype).clone()
            self.nu[name] = state["nu"][name].to(p.device, p.dtype).clone()

    @torch.no_grad()
    def step(self, grads: dict, lr) -> torch.Tensor:
        """Apply one update for ``grads`` (name -> gradient) at learning
        rate ``lr``; returns the gradients' global norm before clipping."""
        device = next(iter(self.params.values())).device
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
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
            p.add_((-update) * lr_t)
        return g_norm


def policy_update(model, optimizer: ClippedAdam, algo, batch: dict,
                  timestep, lr, negative_positive_ratio: float = -1.0,
                  generator: torch.Generator = None) -> dict:
    """One policy's update on its batch ``{"obs" (T, E, A, F), "actions"
    (T, E, A, C), "rewards" (T, E, A), "done" (T, E)}``: whole-batch
    forward, the algorithm's loss, gradients and one optimizer step.
    Returns the metric tensors."""
    logits_list, values = model(batch["obs"])
    loss, metrics = algo.compute_loss_and_metrics(
        timestep, batch["actions"], batch["rewards"], batch["done"],
        logits_list, values,
        negative_positive_ratio=negative_positive_ratio, generator=generator,
    )
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [optimizer.params[n] for n in names])
    metrics["Gradient norm"] = optimizer.step(dict(zip(names, grads)), lr)
    metrics["Current timestep"] = float(timestep)
    metrics["Learning rate"] = float(lr)
    return metrics


class TrainerA2C(TrainerBase):
    """A2C/PPO trainer over one or more policies."""

    def __init__(self, env_wrapper=None, config=None, **kwargs):
        super().__init__(env_wrapper=env_wrapper, config=config, **kwargs)
        trainer_cfg = config["trainer"]
        if trainer_cfg.get("update_recompute_obs", False):
            raise not_ported("trainer.update_recompute_obs", "4")
        if trainer_cfg.get("batch_dtype", "float32") != "float32":
            raise not_ported("trainer.batch_dtype other than float32", "4")

        self.algorithms = {}
        self.lr_schedules = {}
        self.optimizers = {}
        self._head_dims = {}
        self.engine.reset_all_envs()  # the initial state as built
        obs_dim = self.engine.state[_OBS].shape[-1]
        init_gen = torch.Generator(device=self.device)
        init_gen.manual_seed(self.seed)

        for tag in self.policies:
            policy_cfg = config["policy"][tag]
            self._check_policy_config(tag, policy_cfg)
            heads, _, is_det = self._action_heads(tag)
            assert not is_det, (
                "A2C/PPO need categorical action spaces; DDPG (ROADMAP "
                "queue 1, item 7) trains Box actions"
            )
            self._head_dims[tag] = heads
            model_cfg = policy_cfg["model"]
            model_cls = ModelFactory.create(model_cfg["type"])
            self.models[tag] = model_cls(
                obs_dim, tuple(model_cfg["fc_dims"]), tuple(heads),
                generator=init_gen, device=self.device,
            )

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
            self.lr_schedules[tag] = ParamScheduler(policy_cfg.get("lr", 1e-3))
            max_norm = (policy_cfg.get("max_grad_norm", 0.5)
                        if policy_cfg.get("clip_grad_norm", True) else None)
            self.optimizers[tag] = ClippedAdam(
                dict(self.models[tag].named_parameters()), max_norm=max_norm
            )
            ckpt = model_cfg.get("model_ckpt_filepath", "")
            if ckpt:
                self.load_model_checkpoint({tag: ckpt})

        self._env_state = self._rollout_env_state()
        self._ep_acc = torch.zeros((self.num_envs, self.engine.n_agents),
                                   dtype=torch.float32, device=self.device)
        self._ep_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        self._ep_count = torch.zeros((), dtype=torch.float32,
                                     device=self.device)
        self._batch = None  # the rollout's buffers, made at first use

    @staticmethod
    def _check_policy_config(tag: str, policy_cfg: dict):
        if (int(policy_cfg.get("num_epochs", 1)) > 1
                or int(policy_cfg.get("num_minibatches", 1)) > 1):
            raise not_ported(
                f"policy {tag!r}: multi-epoch or minibatched PPO", "4"
            )
        if policy_cfg.get("env_major") is True:
            raise not_ported(f"policy {tag!r}: the env-major relayout", "4")
        if policy_cfg.get("remat", False):
            raise not_ported(f"policy {tag!r}: remat", "4")
        if policy_cfg["model"].get("dtype"):
            raise not_ported(f"policy {tag!r}: the model dtype option", "3")

    # ------------------------------------------------------------ rollout
    def _make_batch(self) -> dict:
        T, E = self.training_batch_size_per_env, self.num_envs
        obs_dim = self.engine.state[_OBS].shape[-1]
        batch = {"done": torch.zeros((T, E), dtype=torch.int32,
                                     device=self.device)}
        for tag, ids in self.policy_tag_to_agent_id_map.items():
            A, C = len(ids), len(self._head_dims[tag])
            batch[f"obs_{tag}"] = torch.empty(
                (T, E, A, obs_dim), dtype=torch.float32, device=self.device)
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
        recorded actions)."""
        if self._batch is None:
            self._batch = self._make_batch()
        batch = self._batch
        engine = self.engine
        state = self._env_state
        split = engine.has_split_step
        for t in range(self.training_batch_size_per_env):
            obs_all = engine.observe(state) if split else state[_OBS]
            per_policy = {}
            for tag in self.policies:
                ids = self._agent_ids[tag]
                obs_p = torch.index_select(obs_all, 1, ids,
                                           out=batch[f"obs_{tag}"][t])
                if actions is None:
                    logits_list, _ = self.models[tag](obs_p)
                    acts = torch.stack(
                        [sample_from_logits(logits, self.generator)
                         for logits in logits_list], dim=-1)
                else:
                    acts = actions[t][:, ids]
                batch[f"actions_{tag}"][t] = acts
                per_policy[tag] = acts
            actions_all = self._scatter_actions(per_policy)
            state = (engine.step_physics(state, actions_all) if split
                     else engine.step(state, actions_all))

            rewards = engine.rewards_of(state)
            done = state[_DONE]
            for tag in self.policies:
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
            obs_p = torch.index_select(state[_OBS], 1, self._agent_ids[tag])
            logits_list, _ = self.models[tag](obs_p)
            logits_of[tag] = logits_list
            per_policy[tag] = torch.stack(
                [sample_from_logits(logits, generator, use_argmax=use_argmax)
                 for logits in logits_list], dim=-1)
        actions = self._scatter_actions(per_policy)
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
        return {"obs": batch[f"obs_{tag}"],
                "actions": batch[f"actions_{tag}"],
                "rewards": batch[f"rewards_{tag}"],
                "done": batch["done"]}

    def _update(self, batch: dict, timestep) -> dict:
        """Every trained policy's update on ``batch``; metric tensors per
        policy."""
        metrics = {}
        for tag in self.policies_to_train:
            metrics[tag] = policy_update(
                self.models[tag], self.optimizers[tag], self.algorithms[tag],
                self._policy_batch(batch, tag), timestep,
                self.lr_schedules[tag].value_at(timestep),
                negative_positive_ratio=self.neg_pos_env_ratio,
                generator=self.generator,
            )
        return metrics

    def _iteration(self, timestep) -> dict:
        start = self.clock.mark()
        batch = self._rollout()
        mid = self.clock.mark()
        metrics = self._update(batch, timestep)
        self._pending_marks.append((start, mid, self.clock.mark()))
        mean_ep_reward = self._ep_sum / torch.clamp(self._ep_count, min=1.0)
        for tag in metrics:
            metrics[tag]["Mean episodic reward"] = mean_ep_reward
        return metrics
