"""The port's ``TrainerDDPG`` judged by the benchmark's plain reference
(``portbench/reference/``) on the CPU, through the cell
``single_pendulum.train`` at a small size (16 envs x 5 steps, a reset pool
of 32, episodes of 10, so that the compared iteration 6 ends every episode
and resets every env from the pool):

- the sound run is correct, on the eager path and through the programs;
- each planted fault comes out not correct: the targets left where they
  are, the actor's loss through the updated critic (upstream's order), half
  of the window left out, the OU state not carried between steps, a reward
  altered where it is produced; and so does the reference in bfloat16 put
  in the program's place.
"""

import pytest
import torch

from portbench import harness

CELL = "single_pendulum.train"
SMALL = {
    "config": {"run_config.trainer.num_envs": 16,
               "run_config.trainer.train_batch_size": 80,
               "run_config.env.episode_length": 10,
               "run_config.env.reset_pool_size": 32},
    "traffic": {"units": 2, "settle_chunk_units": 1, "reset_iteration": 6},
}
SEED = 2**31 + 7654321  # past 32 signed bits, as the driver's are


def _run(control=False):
    return harness.execute(CELL, SEED, 1.0, False, device="cpu",
                           overrides=SMALL, control=control, settle=False)


def _failed(line) -> list:
    return [n for n, c in line["checks"].items()
            if not c["value"] <= c["limit"]]


def _programmed_on_the_cpu(monkeypatch):
    """The card's path on the CPU: every iteration through the trainer's
    programs (their bodies run in place)."""
    from warpdrive_tpu_torch.training.trainer_base import TrainerBase

    monkeypatch.setattr(TrainerBase, "_iteration",
                        lambda self, timestep, full=True:
                        self._iteration_programmed(timestep, full))


@pytest.mark.parametrize("programmed", [False, True])
def test_a_sound_run_is_correct(programmed, monkeypatch):
    if programmed:
        _programmed_on_the_cpu(monkeypatch)
    line = _run()
    assert line["correct"], line["checks"]
    checks = line["checks"]
    for name in ("mismatches", "reward_gap", "reset_gap"):
        assert checks[name]["value"] == 0, name
    assert line["attempted"] == 2


def _targets_unmoved(monkeypatch):
    from warpdrive_tpu_torch.training import trainer_ddpg

    monkeypatch.setattr(trainer_ddpg, "soft_update",
                        lambda target, source, tau: None)


def _upstream_order(monkeypatch):
    """The critic steps first and the actor's loss goes through the
    updated critic, as upstream orders them."""
    from warpdrive_tpu_torch.training import trainer_ddpg

    def update(nets, targets, optimizers, algo, batch, lrs, tau, step=True,
               remat=False, mesh=None, with_metrics=True):
        obs, act = batch["obs"], batch["actions"]
        with torch.no_grad():
            t_mu = targets["actor"](obs)
            next_q = targets["critic"](obs[1:], t_mu[1:])
        critic_loss, critic_metrics = algo.critic_loss_and_metrics(
            act, batch["rewards"], batch["done"], nets["critic"](obs, act),
            next_q, with_metrics=with_metrics)
        norms = {}
        for net in ("critic", "actor"):
            if net == "actor":
                actor_loss, j = algo.actor_loss(
                    nets["critic"](obs, nets["actor"](obs)))
            params = dict(nets[net].named_parameters())
            loss = critic_loss if net == "critic" else actor_loss
            grads = torch.autograd.grad(loss, list(params.values()))
            norms[net] = trainer_ddpg.global_norm(grads)
            if step:
                optimizers[net].step(dict(zip(params, grads)), lrs[net])
        if step:
            for net in ("actor", "critic"):
                trainer_ddpg.soft_update(targets[net], nets[net], tau)
        if not with_metrics:
            return {}
        metrics = algo.with_actor_terms(critic_metrics, critic_loss,
                                        actor_loss, j)
        metrics["Actor gradient norm"] = norms["actor"]
        metrics["Critic gradient norm"] = norms["critic"]
        return metrics

    monkeypatch.setattr(trainer_ddpg, "ddpg_update_step", update)


def _half_window(monkeypatch):
    from warpdrive_tpu_torch.training.trainer_ddpg import TrainerDDPG

    inner = TrainerDDPG._policy_window

    def half(self, tag):
        window = inner(self, tag)
        h = window["done"].shape[1] // 2
        return {k: v[:, :h] for k, v in window.items()}

    monkeypatch.setattr(TrainerDDPG, "_policy_window", half)


def _ou_not_carried(monkeypatch):
    from warpdrive_tpu_torch.training import trainer_ddpg

    inner = trainer_ddpg.sample_ou_process
    monkeypatch.setattr(trainer_ddpg, "sample_ou_process",
                        lambda mu, ou_state, **kw:
                        inner(mu, torch.zeros_like(ou_state), **kw))


def _reward_altered(monkeypatch):
    from warpdrive_tpu_torch.envs.classic_control.pendulum import (
        TorchClassicControlPendulumEnv,
    )
    from warpdrive_tpu_torch.utils.constants import Constants

    inner = TorchClassicControlPendulumEnv.step_fn

    def step_fn(self, state):
        out = inner(self, state)
        rewards = out[Constants.REWARDS].clone()
        rewards[0, 0] += 1.0
        out[Constants.REWARDS] = rewards
        return out

    monkeypatch.setattr(TorchClassicControlPendulumEnv, "step_fn", step_fn)


@pytest.mark.parametrize("fault, fails", [
    (_targets_unmoved, {"target_gap"}),
    (_upstream_order, {"actor_loss_gap"}),
    (_half_window, {"critic_loss_gap", "actor_loss_gap"}),
    (_ou_not_carried, {"action_gap"}),
    (_reward_altered, {"reward_gap"}),
], ids=["targets_unmoved", "upstream_order", "half_window",
        "ou_not_carried", "reward_altered"])
def test_a_planted_fault_is_not_correct(fault, fails, monkeypatch):
    fault(monkeypatch)
    line = _run()
    assert not line["correct"]
    assert fails <= set(_failed(line)), line["checks"]


def test_the_bfloat16_control_is_not_correct():
    line = _run(control=True)
    assert line["correct"], line["checks"]
    limits = {n: c["limit"] for n, c in line["checks"].items()}
    numbers = line["control"]["bfloat16"]
    assert [n for n, v in numbers.items() if v > limits[n]], numbers
    for kind, numbers in line["control"].items():
        assert [n for n, v in numbers.items() if v > limits[n]], \
            (kind, numbers)
