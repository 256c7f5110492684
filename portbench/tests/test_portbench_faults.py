"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have (a step that leaves its state unchanged, half
of the batch left out, an answer altered where it is produced; one card,
so no exchange between chips), and for each cell's control (the reference
in the next lower precision put in the program's place)."""

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import SEED, SMALL


def _run(cell, control=False):
    return harness.execute(cell, SEED, 1.0, False, device="cpu",
                           overrides=SMALL[cell], control=control,
                           settle=False)


def _failed(line) -> list:
    return [n for n, c in line["checks"].items()
            if not c["value"] <= c["limit"]]


def _altered_observation(monkeypatch):
    """The kNN observation with one entry moved where it is produced."""
    from warpdrive_tpu_torch.envs import tag_continuous

    inner = tag_continuous.knn_observation

    def altered(*args, **kwargs):
        out = inner(*args, **kwargs).clone()
        out[0, 0, 0] += 0.25
        return out

    monkeypatch.setattr(tag_continuous, "knn_observation", altered)


def _physics(monkeypatch, make):
    from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous

    inner = TorchTagContinuous.physics_fn
    monkeypatch.setattr(TorchTagContinuous, "physics_fn",
                        lambda self, state, actions:
                        make(inner(self, state, actions), state))


# ------------------------------------------------------------ training
def test_train_with_an_update_that_leaves_the_state_unchanged(monkeypatch):
    from warpdrive_tpu_torch.training import trainer_a2c

    monkeypatch.setattr(trainer_a2c.ClippedAdam, "step",
                        lambda self, grads, lr: self._global_norm(grads))
    line = _run("tag_continuous.train")
    assert not line["correct"]
    assert {"grad_gap", "change_gap"} <= set(_failed(line))


def test_train_with_half_of_the_batch_left_out(monkeypatch):
    from warpdrive_tpu_torch.algos.policygradient import A2C

    inner = A2C.compute_loss_and_metrics

    def half(self, timestep, actions, rewards, done, logits, values,
             **kwargs):
        h = rewards.shape[1] // 2
        return inner(self, timestep, actions[:, :h], rewards[:, :h],
                     done[:, :h], [lg[:, :h] for lg in logits],
                     values[:, :h], **kwargs)

    monkeypatch.setattr(A2C, "compute_loss_and_metrics", half)
    line = _run("tag_continuous.train")
    assert not line["correct"]
    assert "loss_gap" in _failed(line)


def test_train_with_an_observation_altered(monkeypatch):
    _altered_observation(monkeypatch)
    line = _run("tag_continuous.train")
    assert not line["correct"]
    assert {"obs_gap", "obs_sum_gap"} <= set(_failed(line))


def test_train_with_a_reward_altered(monkeypatch):
    _physics(monkeypatch, _one_reward_more)
    line = _run("tag_continuous.train")
    assert not line["correct"]
    assert "mismatches" in _failed(line)


def _programmed_on_the_cpu(monkeypatch):
    """The card's path on the CPU: every iteration through the trainer's
    programs (their bodies run in place), hot update passes between the
    full ones, as ``train()`` picks them on a card."""
    from warpdrive_tpu_torch.training.trainer_base import TrainerBase

    monkeypatch.setattr(TrainerBase, "_iteration",
                        lambda self, timestep, full=True:
                        self._iteration_programmed(timestep, full))


def _hot_pass_unchanged(monkeypatch):
    """Hot update passes that leave the parameters as they were (as a
    replay on stale buffers would), full ones sound."""
    from warpdrive_tpu_torch.training.trainer_a2c import UpdatePass

    inner = UpdatePass.run_pass

    def run_pass(self, full=True):
        if full:
            return inner(self, full)
        self.pass_index.add_(1)
        self._host_pass += 1
        return {}

    monkeypatch.setattr(UpdatePass, "run_pass", run_pass)


def _hot_pass_doubled(monkeypatch):
    """Hot update passes that step with twice the learning rate."""
    from warpdrive_tpu_torch.training.trainer_a2c import ClippedAdam, \
        UpdatePass

    inner, step = UpdatePass.run_pass, ClippedAdam.step

    def run_pass(self, full=True):
        if full:
            return inner(self, full)
        self.optimizer.step = lambda grads, lr: step(self.optimizer, grads,
                                                     2.0 * lr)
        try:
            return inner(self, full)
        finally:
            del self.optimizer.step

    monkeypatch.setattr(UpdatePass, "run_pass", run_pass)


@pytest.mark.parametrize("fault", [None, _hot_pass_unchanged,
                                   _hot_pass_doubled],
                         ids=["sound", "unchanged", "doubled"])
def test_train_compares_the_hot_update_pass(monkeypatch, fault):
    """The compared steps include hot passes (on a card, the third step
    replays the hot pass's graph): a hot pass that departs from the full
    one comes out not correct, and the sound programmed path correct."""
    _programmed_on_the_cpu(monkeypatch)
    if fault is not None:
        fault(monkeypatch)
    line = _run("tag_continuous.train")
    if fault is None:
        assert line["correct"], line["checks"]
    else:
        assert not line["correct"]
        assert "change_gap" in _failed(line)


def test_train_controls_fail_the_limits():
    line = _run("tag_continuous.train", control=True)
    assert line["correct"]
    limits = {n: c["limit"] for n, c in line["checks"].items()}
    for kind, numbers in line["control"].items():
        over = [n for n, v in numbers.items() if v > limits[n]]
        assert over, (kind, numbers)


def _one_reward_more(new, old):
    """The step's rewards with 1 added to env 0's first agent's."""
    out = dict(new)
    out["rewards"] = new["rewards"].clone()
    out["rewards"][0, 0] += 1.0
    return out


def test_sim_with_a_reward_altered(monkeypatch):
    _physics(monkeypatch, _one_reward_more)
    line = _run("flagship.sim")
    assert not line["correct"]
    assert "mismatches" in _failed(line)


def test_sim_with_a_step_that_leaves_the_state_unchanged(monkeypatch):
    _physics(monkeypatch, lambda new, old: dict(old))
    line = _run("flagship.sim")
    assert not line["correct"]
    assert "mismatches" in _failed(line)


def test_sim_with_half_of_the_envs_left_out(monkeypatch):
    def half(new, old):
        h = next(iter(old.values())).shape[0] // 2
        return {k: torch.cat([v[:h], old[k][h:]]) for k, v in new.items()}

    _physics(monkeypatch, half)
    line = _run("flagship.sim")
    assert not line["correct"]
    assert "mismatches" in _failed(line)


def test_sim_with_an_observation_altered(monkeypatch):
    _altered_observation(monkeypatch)
    line = _run("flagship.sim")
    assert not line["correct"]
    assert "obs_gap" in _failed(line)


def test_sim_with_the_loop_observing_the_wrong_state(monkeypatch):
    """The captured step's own observation (its checksum) made of the state
    after the physics: only the timed path is wrong, and the second
    observation of the recorded states, made outside the loop, is right."""
    from warpdrive_tpu_torch import presets

    def late_observation(engine, device):
        random_actions = presets.random_actions_fn(engine, device)

        @torch.no_grad()
        def env_only_step(carry, generator):
            state, checksum = carry
            state = engine.step_physics(state, random_actions(generator))
            checksum = checksum + engine.observe(state).sum()
            return engine.auto_reset(state, generator), checksum

        return env_only_step

    monkeypatch.setattr(presets, "_env_only_step_fn", late_observation)
    line = _run("flagship.sim")
    assert not line["correct"]
    assert _failed(line) == ["obs_sum_gap"]


def test_sim_control_fails_the_limits():
    line = _run("flagship.sim", control=True)
    assert line["correct"]
    limits = {n: c["limit"] for n, c in line["checks"].items()}
    numbers = line["control"]["bfloat16"]
    assert [n for n, v in numbers.items() if v > limits[n]], numbers
