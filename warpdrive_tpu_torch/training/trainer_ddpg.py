"""
TrainerDDPG: off-policy trainer for continuous (Box) action spaces.

The port's counterpart of ``warpdrive_tpu/training/trainer_ddpg.py``.  One
iteration runs, eagerly on the engine's device:

  the iteration's OU noise, ``stddev * N(0, 1)`` of shape ``(T, E, A_p,
  C)`` for each policy in one draw, then a rollout of
  ``training_batch_size_per_env`` steps of
      observations (split path: ``observe``; full-step path: the ones the
      last step wrote; per policy through ``_policy_obs_and_mask``, in
      every placeholder mode), the actor's action, Ornstein-Uhlenbeck exploration
      around it, the env step, rewards and done flags, episodic-reward
      bookkeeping and the done-driven auto-reset;
  the replay window: ``T + n_step - 1`` rows, each iteration
      ``cat(window[T:], new rows)``, so the window's order is time order;
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
from warpdrive_tpu_torch.models.factory import ModelFactory
from warpdrive_tpu_torch.sampling.samplers import sample_ou_process
from warpdrive_tpu_torch.training.param_scheduler import ParamScheduler
from warpdrive_tpu_torch.training.trainer_a2c import ClippedAdam, remat_apply
from warpdrive_tpu_torch.training.trainer_base import (
    TrainerBase,
    _host_state,
    _timestep_of,
)
from warpdrive_tpu_torch.utils.constants import Constants

_DONE = Constants.DONE
_REWARDS = Constants.REWARDS
_NETS = ("actor", "critic")


@torch.no_grad()
def soft_update(target: torch.nn.Module, source: torch.nn.Module, tau):
    """Polyak averaging in place: ``t <- t * (1 - tau) + s * tau``."""
    tau = np.float32(tau)
    for t, s in zip(target.parameters(), source.parameters()):
        t.copy_(t * (np.float32(1) - tau) + s * tau)


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def ddpg_policy_update(nets: dict, targets: dict, optimizers: dict, algo,
                       batch: dict, timestep, lrs: dict, tau: float,
                       step: bool = True, remat: bool = False,
                       mesh=None) -> dict:
    """One policy's DDPG update on its replay window ``{"obs" (W, E, A, F),
    "actions" (W, E, A, C), "rewards" (W, E, A), "done" (W, E)}``.
    ``nets``, ``targets``, ``optimizers`` and ``lrs`` are keyed
    ``"actor"``/``"critic"``.  Both gradients are taken before either
    optimizer steps, so the actor's goes through the critic as it was;
    with ``step`` the optimizers step and the targets move toward the
    updated nets, without it nothing moves.  ``remat`` recomputes the
    online nets' activations in the backward pass.  Under a ``mesh`` the
    window holds the rank's env rows, the losses and metrics are global
    and each net's gradients are summed over the env group.  Returns the
    metric tensors."""
    actor = remat_apply(nets["actor"], remat)
    critic = remat_apply(nets["critic"], remat)
    obs_b, act_b = batch["obs"], batch["actions"]

    # the targets' Q(s_{t+1}, pi'(s_{t+1})), W - 1 rows
    with torch.no_grad():
        t_mu = targets["actor"](obs_b)
        next_q = targets["critic"](obs_b[1:], t_mu[1:])

    q = critic(obs_b, act_b)
    critic_loss, critic_metrics = algo.critic_loss_and_metrics(
        act_b, batch["rewards"], batch["done"], q, next_q, group=mesh)
    grads = {"critic": torch.autograd.grad(
        critic_loss, list(nets["critic"].parameters()))}

    actor_loss, j = algo.actor_loss(critic(obs_b, actor(obs_b)), group=mesh)
    grads["actor"] = torch.autograd.grad(actor_loss,
                                         list(nets["actor"].parameters()))
    if mesh is not None:
        grads = {net: mesh.reduce_grads(g) for net, g in grads.items()}

    metrics = algo.with_actor_terms(critic_metrics, critic_loss, actor_loss,
                                   j, mesh)
    if step:
        # the optimizer returns the global norm it clipped by
        norms = {}
        for net in ("critic", "actor"):
            names = [n for n, _ in nets[net].named_parameters()]
            norms[net] = optimizers[net].step(dict(zip(names, grads[net])),
                                              lrs[net])
        for net in _NETS:
            soft_update(targets[net], nets[net], tau)
    else:
        norms = {net: global_norm(grads[net]) for net in _NETS}

    metrics["Current timestep"] = float(timestep)
    metrics["Actor learning rate"] = float(lrs["actor"])
    metrics["Critic learning rate"] = float(lrs["critic"])
    metrics["Actor gradient norm"] = norms["actor"]
    metrics["Critic gradient norm"] = norms["critic"]
    metrics["Buffer full"] = float(step)
    return metrics


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
        E = self.local_envs
        self._ou = {}
        self._window = {}
        for tag, ids in self.policy_tag_to_agent_id_map.items():
            A, C = len(ids), self._num_action_dims[tag]
            obs_dim = self._policy_obs_sizes(tag)[0]
            self._ou[tag] = torch.zeros((E, A, C), dtype=torch.float32,
                                        device=self.device)
            self._window[f"obs_{tag}"] = torch.zeros(
                (self.buffer_capacity, E, A, obs_dim), dtype=self.batch_dtype,
                device=self.device)
            self._window[f"actions_{tag}"] = torch.zeros(
                (self.buffer_capacity, E, A, C), dtype=torch.float32,
                device=self.device)
            self._window[f"rewards_{tag}"] = torch.zeros(
                (self.buffer_capacity, E, A), dtype=torch.float32,
                device=self.device)
        self._window["done"] = torch.zeros((self.buffer_capacity, E),
                                           dtype=torch.int32,
                                           device=self.device)
        self.filled = 0  # rows of the window written so far, at most full
        self._ep_acc = torch.zeros((E, self.engine.n_agents),
                                   dtype=torch.float32, device=self.device)
        self._ep_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        self._ep_count = torch.zeros((), dtype=torch.float32,
                                     device=self.device)

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
    def _presample_ou_noise(self, stddev) -> dict:
        """One ``stddev * N(0, 1)`` draw of shape ``(T, E, A_p, C)`` per
        policy, in policy order."""
        T = self.training_batch_size_per_env
        return {
            tag: torch.randn((T,) + tuple(self._ou[tag].shape),
                             generator=self.generator, device=self.device)
            * np.float32(stddev)
            for tag in self.policies
        }

    @torch.no_grad()
    def _rollout(self, noise: dict, damping, stddev, scale) -> dict:
        """``training_batch_size_per_env`` steps from the trainer's env
        state with the iteration's OU ``noise`` (``{tag: (T, E, A_p, C)}``,
        which a test may pass in); returns the new rows, time-major."""
        engine = self.engine
        split = engine.has_split_step
        # the eager backend's engine holds the rollout's state itself
        state = dict(engine.state) if self._is_eager else self._env_state
        T = self.training_batch_size_per_env
        rows = {"done": []}
        for tag in self.policies:
            for key in ("obs", "actions", "rewards"):
                rows[f"{key}_{tag}"] = []
        for t in range(T):
            obs_all = engine.observe(state) if split else None
            per_policy = {}
            for tag in self.policies:
                obs_p = self._policy_obs_and_mask(state, obs_all, tag)[0]
                mu = self.nets["actor"][tag](obs_p)
                acts, self._ou[tag] = sample_ou_process(
                    mu, self._ou[tag], damping=damping, stddev=stddev,
                    scale=scale, noise=noise[tag][t])
                per_policy[tag] = acts
                rows[f"obs_{tag}"].append(obs_p)
                rows[f"actions_{tag}"].append(acts)
            actions = self._merge_actions(per_policy)
            if self._is_eager:  # the actions to the host, one host step
                state = engine.step_all_envs(actions)
            else:
                state = (engine.step_physics(state, actions) if split
                         else engine.step(state, actions))

            rewards = engine.rewards_of(state)
            done = state[_DONE]
            for tag in self.policies:
                rows[f"rewards_{tag}"].append(
                    state[f"{_REWARDS}_{tag}"]
                    if engine.separate_placeholders
                    else torch.index_select(rewards, 1, self._agent_ids[tag]))
            rows["done"].append(done)

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
        engine.state = {**engine.state, **state}
        return {k: torch.stack(v) for k, v in rows.items()}

    # ------------------------------------------------------------- update
    def _replay_update(self, rows: dict, timestep) -> dict:
        """Append ``rows`` to the replay window and, once it is full,
        update every trained policy; returns the metric tensors per
        policy."""
        T = self.training_batch_size_per_env
        for key, new in rows.items():
            self._window[key] = torch.cat([self._window[key][T:],
                                           new.to(self._window[key].dtype)])
        self.filled = min(self.filled + T, self.buffer_capacity)
        is_full = self.filled >= self.buffer_capacity

        metrics = {}
        for tag in self.policies_to_train:
            metrics[tag] = ddpg_policy_update(
                {net: self.nets[net][tag] for net in _NETS},
                {net: self.targets[net][tag] for net in _NETS},
                {net: self.optimizers[net][tag] for net in _NETS},
                self.algorithms[tag],
                {"obs": self._window[f"obs_{tag}"],
                 "actions": self._window[f"actions_{tag}"],
                 "rewards": self._window[f"rewards_{tag}"],
                 "done": self._window["done"]},
                timestep,
                {net: self.lr_schedules[net][tag].value_at(timestep)
                 for net in _NETS},
                self.tau[tag], step=is_full, remat=self.remat[tag],
                mesh=self.mesh,
            )
        return metrics

    def _rollout_phase(self, timestep) -> dict:
        stddev = self.ou_stddev.value_at(timestep)
        noise = self._presample_ou_noise(stddev)
        return self._rollout(noise, self.ou_damping.value_at(timestep),
                             stddev, self.ou_scale.value_at(timestep))

    _update_phase = _replay_update

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
        for net in _NETS:
            for tag in self.policies:
                self.nets[net][tag].load_state_dict(state["nets"][net][tag])
                self.targets[net][tag].load_state_dict(
                    state["targets"][net][tag])
                self.optimizers[net][tag].load_state_dict(
                    state["optimizers"][net][tag])
        self._window = dict(state["window"])
        self.filled = int(state["filled"])
        self._ou = dict(state["ou"])
        self._env_state = dict(state["env_state"])
        episodes = state["episodes"]
        self._ep_acc = episodes["acc"]
        self._ep_sum = episodes["sum"]
        self._ep_count = episodes["count"]
