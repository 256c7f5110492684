"""The port's vertical auto-scaler (``warpdrive_tpu_torch/tools/
autoscaler.py``), after ``tests/test_autoscaler.py``: the search, the
memory-knob ladder's monotone rung, the throughput choice, each with an
injected probe and each against the JAX package's scaler on the same
probe; one real subprocess probe of a tiny config on the CPU, which fits
and measures a rate, and one that fails and names its exception's type;
and the CLI's ``-a``."""

import copy

import pytest

from warpdrive_tpu.tools import autoscaler as jax_autoscaler
from warpdrive_tpu_torch.tools import autoscaler
from warpdrive_tpu_torch.tools.autoscaler import best_param_search
from warpdrive_tpu_torch.training.scripts import train as port_train


def test_best_param_search_finds_threshold():
    calls = []

    def is_valid(n):
        calls.append(n)
        return n <= 100

    assert best_param_search(is_valid, low=10) == 100
    # doubling 10 -> 160, then bisection between 80 and 160
    assert calls[:5] == [10, 20, 40, 80, 160]


def test_best_param_search_exact_power_of_two():
    assert best_param_search(lambda n: n <= 64, low=1) == 64


def test_best_param_search_lower_bound_infeasible():
    with pytest.raises(ValueError):
        best_param_search(lambda n: False, low=4)


def _both(cfg, probe, **kwargs):
    """The port's and the JAX package's scaler on the same probe."""
    ours = autoscaler.perform_auto_vertical_scaling(
        copy.deepcopy(cfg), ("Env", "single"), probe_fn=probe, **kwargs)
    theirs = jax_autoscaler.perform_auto_vertical_scaling(
        copy.deepcopy(cfg), ("Env", "single", "a2c"), probe_fn=probe,
        **kwargs)
    assert ours == theirs
    return ours


def test_perform_auto_vertical_scaling_with_a_fake_probe():
    """Capacity 64 envs x 10 steps, batches up to 3x at the env cap."""
    def fake_probe(trial, env_setup):
        envs = trial["trainer"]["num_envs"]
        batch = trial["trainer"]["train_batch_size"]
        return envs <= 64 and batch <= 64 * 10 * 3

    cfg = {"trainer": {"num_envs": 4, "train_batch_size": 40},
           "env": {}, "saving": {}}
    out = _both(cfg, fake_probe, use_memory_knobs=False)
    assert out["trainer"]["num_envs"] == 64
    assert out["trainer"]["train_batch_size"] == 64 * 10 * 3
    assert cfg["trainer"]["num_envs"] == 4  # input untouched


def test_effective_minibatches_divides_envs():
    assert autoscaler._effective_minibatches(100, 8) == 5
    assert autoscaler._effective_minibatches(64, 8) == 8
    assert autoscaler._effective_minibatches(7, 4) == 1
    assert autoscaler._effective_minibatches(2, 8) == 2


def test_memory_knob_ladder_matches_jax():
    """Every knob of the JAX ladder is ported (PR 11's update options)."""
    assert autoscaler.MEMORY_KNOB_LADDER == jax_autoscaler.MEMORY_KNOB_LADDER
    assert autoscaler._TRAINER_KNOBS == jax_autoscaler._TRAINER_KNOBS


def test_memory_knob_ladder_escalation_is_monotone():
    """A size that does not fit as given climbs remat, then minibatching;
    a knob needed at N envs stays on above N, and the chosen knobs land in
    the result (divisor-adjusted)."""
    rungs_seen = []

    def fake_probe(trial, env_setup):
        envs = trial["trainer"]["num_envs"]
        pol = trial["policy"]["shared"]
        rungs_seen.append((envs, bool(pol.get("remat")),
                           pol.get("num_minibatches", 1)))
        cap = 16 * (2 if pol.get("remat") else 1) \
            * pol.get("num_minibatches", 1)
        return envs <= cap and trial["trainer"]["train_batch_size"] <= (
            envs * 10 * 2)

    cfg = {"trainer": {"num_envs": 4, "train_batch_size": 40},
           "env": {}, "policy": {"shared": {"to_train": True}},
           "saving": {}}
    out = _both(cfg, fake_probe)
    assert out["trainer"]["num_envs"] == 256
    assert out["policy"]["shared"]["remat"] is True
    assert out["policy"]["shared"]["num_minibatches"] == 8
    assert out["trainer"]["train_batch_size"] == 256 * 10 * 2
    assert "remat" not in cfg["policy"]["shared"]
    # monotone: once remat was on, no later probe of a larger size drops it
    first_remat = min(e for e, remat, _ in rungs_seen if remat)
    assert all(remat for e, remat, _ in rungs_seen if e > first_remat)


def test_memory_knobs_disabled_matches_plain_search():
    def fake_probe(trial, env_setup):
        assert "remat" not in trial["policy"]["shared"]
        return trial["trainer"]["num_envs"] <= 16 and (
            trial["trainer"]["train_batch_size"]
            <= trial["trainer"]["num_envs"] * 10)

    cfg = {"trainer": {"num_envs": 4, "train_batch_size": 40},
           "env": {}, "policy": {"shared": {"to_train": True}},
           "saving": {}}
    out = _both(cfg, fake_probe, use_memory_knobs=False)
    assert out["trainer"]["num_envs"] == 16


def test_throughput_aware_selection():
    """The result is the fastest fitting probe, not the largest: the deep
    rung fits 800 envs at a tenth of the rate."""
    def probe(trial, env_setup):
        envs = trial["trainer"]["num_envs"]
        pol = trial["policy"]["p"]
        deep = trial["trainer"].get("update_recompute_obs", False)
        ok = envs <= (800 if pol.get("remat") and deep else 200)
        rate = envs * (1.0 if deep else 10.0)
        return ok, (rate if ok else None)

    cfg = {"trainer": {"num_envs": 100, "train_batch_size": 1000,
                       "num_episodes": 500},
           "policy": {"p": {"to_train": True}}}
    out = _both(cfg, probe)
    assert out["trainer"]["num_envs"] == 200
    assert not out["trainer"].get("update_recompute_obs", False)
    # the episodes scale with the envs: the same iteration count
    assert out["trainer"]["num_episodes"] == 500 * 2


def _tiny_cartpole(**trainer):
    return {
        "name": "single_cartpole",
        "env": {"episode_length": 20, "reset_pool_size": 0, "seed": 1},
        "trainer": {"num_envs": 4, "train_batch_size": 8, "num_episodes": 40,
                    "seed": 0, **trainer},
        "policy": {"shared": {
            "to_train": True, "algorithm": "A2C", "gamma": 0.98, "lr": 1e-3,
            "model": {"type": "fully_connected", "fc_dims": [8]}}},
        "saving": {"metrics_log_freq": 10**9,
                   "model_params_save_freq": 10**9},
    }


def test_autoscaler_real_subprocess_probe():
    """One real probe: a fresh process builds the trainer, trains one
    iteration on the CPU and measures its rate; a failing one prints its
    exception's type."""
    result = autoscaler.run_probe(
        _tiny_cartpole(), ("ClassicControlCartPoleEnv", "shared"),
        device="cpu", timeout_s=600)
    assert result["fits"], result["output"][-2000:]
    assert result["steps_per_sec"] is not None and result["steps_per_sec"] > 0
    assert "PROBE_OK" in result["output"]
    # train_batch_size below num_envs: the trainer refuses it
    bad = autoscaler.run_probe(_tiny_cartpole(train_batch_size=2),
                               device="cpu", timeout_s=600)
    assert not bad["fits"]
    assert "PROBE_FAIL: AssertionError" in bad["output"]


def test_cli_auto_scale_runs_the_scaler(monkeypatch, tmp_path):
    """``-a`` scales the config on ``--device`` before training."""
    seen = []

    def probe(trial, env_setup=None, device="cuda", timeout_s=None):
        envs = trial["trainer"]["num_envs"]
        seen.append((envs, device))
        fits = envs <= 8 and trial["trainer"]["train_batch_size"] <= 2 * envs
        return {"fits": fits, "steps_per_sec": 100.0 if fits else None,
                "output": "", "seconds": 0.0}

    monkeypatch.setattr(autoscaler, "run_probe", probe)
    cfg_path = tmp_path / "tiny.yaml"
    import yaml

    cfg_path.write_text(yaml.safe_dump(_tiny_cartpole()))
    trainer = port_train.main(["-e", str(cfg_path), "-a", "--device", "cpu",
                               "--results_dir", str(tmp_path / "r")])
    assert seen and all(device == "cpu" for _, device in seen)
    assert trainer.num_envs == 8
    assert trainer.train_batch_size == 16  # batch per env kept
