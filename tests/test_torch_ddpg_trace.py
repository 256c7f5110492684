"""The tracer's view of the trainers' host-side writes on the CPU, and the
benchmark's readers of the DDPG cell (``portbench/metrics/``):

- one DDPG iteration with the tracer on, programmed or eager, records one
  ``ddpg.schedules`` span, and ``scalar_writes`` counts its host fills of
  0-dim device scalars: three OU schedules and two learning rates a
  trained policy;
- an A2C iteration counts its own: a learning rate and two loss
  coefficients a trained policy (``UpdatePass.begin``);
- with the tracer off nothing is recorded and the counter is not touched;
- each reader of the DDPG cell, its own and those it shares with
  ``tag_continuous.train``, gives nothing on an empty run and its value on
  a hand-made one.

The file imports no JAX.
"""

import copy
import importlib.util
from pathlib import Path

import pytest

from warpdrive_tpu_torch.core import trace
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.utils import config as port_config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def tracer_reset():
    trace.reset()
    yield
    trace.reset()


def _pendulum():
    cfg = port_config.load_run_config("single_pendulum")
    cfg["env"].update({"episode_length": 10, "reset_pool_size": 8,
                       "seed": 3})
    cfg["trainer"].update({"num_envs": 4, "train_batch_size": 20,
                           "num_episodes": 40, "seed": 7})
    return cfg


def _cartpole():
    cfg = port_config.load_run_config("single_cartpole")
    cfg["env"].update({"episode_length": 10, "reset_pool_size": 8,
                       "seed": 3})
    cfg["trainer"].update({"num_envs": 4, "train_batch_size": 20,
                           "num_episodes": 40, "seed": 7})
    return cfg


def _trainer(cfg, tmp_path, name):
    trainer = port_train.setup_trainer(
        copy.deepcopy(cfg), verbose=False, results_dir=str(tmp_path / name),
        device="cpu")
    trainer._programmed = True  # the card's path; the CPU calls bodies
    return trainer


def _by_name(records) -> dict:
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


@pytest.mark.parametrize("programmed, full", [
    (True, True), (True, False), (False, True)])
def test_a_ddpg_iteration_records_its_schedule_writes(programmed, full,
                                                      tmp_path):
    trainer = _trainer(_pendulum(), tmp_path, "ddpg")
    trainer._programmed = programmed
    trace.enable("cpu")
    trainer._iteration(0, full=full)
    trace.disable()
    named = _by_name(trace.spans())
    (span,) = named["ddpg.schedules"]
    (rollout,) = named["rollout"]
    assert span["parent"] == rollout["id"]
    if programmed:
        # before the rollout's first program call
        first_call = min(r["t0"] for r in named["program.call"]
                         if r["parent"] == rollout["id"])
        assert span["t1"] <= first_call
    policies = len(trainer.policies_to_train)
    assert trace.counters()["scalar_writes"] == 3 + 2 * policies
    # the learning rates are in their scalars for the update
    for net in ("actor", "critic"):
        lr = trainer._lr[net]["shared"]
        assert float(lr) == pytest.approx(
            float(trainer.lr_schedules[net]["shared"].value_at(0)))


def test_an_a2c_iteration_counts_its_own_schedule_writes(tmp_path):
    trainer = _trainer(_cartpole(), tmp_path, "a2c")
    trace.enable("cpu")
    trainer._iteration(0, full=False)
    trainer._iteration(20, full=True)
    trace.disable()
    policies = len(trainer.policies_to_train)
    assert trace.counters()["scalar_writes"] == 2 * 3 * policies
    assert "ddpg.schedules" not in _by_name(trace.spans())


def test_tracing_off_counts_no_scalar_write(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("counted or begun with tracing off")

    trainer = _trainer(_pendulum(), tmp_path, "off")
    monkeypatch.setattr(trace, "count_scalar_write", refuse)
    monkeypatch.setattr(trace, "begin", refuse)
    trainer.num_iters = 3
    trainer.train()
    assert trainer.iters_completed == 3
    assert trace.spans() == []
    assert trace.counters()["scalar_writes"] == 0


def test_enable_starts_the_scalar_writes_again():
    trace.enable("cpu")
    trace.count_scalar_write()
    trace.count_scalar_write()
    assert trace.counters()["scalar_writes"] == 2
    trace.enable("cpu")
    assert trace.counters()["scalar_writes"] == 0
    trace.count_scalar_write()
    trace.reset()
    assert trace.counters()["scalar_writes"] == 0


# ----------------------------------------------- the benchmark's readers
def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _info():
    """A hand-made traced run: 2 window iterations of 4 ms, a 10-iteration
    tracer slice."""
    return {
        "platform": "gpu", "precision": "float32",
        "iter_ms": [4.0, 4.0], "phase_ms": [(1.0, 2.0), (1.5, 2.5)],
        "iteration_ops": 8_168_960_000,
        "profile": {"device_ops": 900, "idle_share": 32.5},
        "tracer": {
            "iterations": 10, "host_ms": 30.0,
            "spans": {"program.replay": {"host_ms": 12.0, "gap_ms": 4.0,
                                         "device_span_ms": 32.0},
                      "program.check_buffers": {"host_ms": 3.0},
                      "ddpg.schedules": {"host_ms": 1.0}},
            "replays": {"OU noise draw": 10, "rollout step": 50,
                        "replay append": 10, "shared update (hot)": 10,
                        "shared update (full)": 0},
            "kernel_nodes": {"OU noise draw": 3, "rollout step": 20,
                             "replay append": 4,
                             "shared update (hot)": 150,
                             "shared update (full)": 300,
                             "shared update (warm)": 120},
            "scalar_writes": 50}}


@pytest.mark.parametrize("name, want", [
    ("rollout_ms.train", 1.25),
    ("update_ms.train", 2.25),
    ("idle_share.train", 32.5),
    ("host_ms.ddpg", (30.0 - 12.0) / 10),
    ("gap_share.ddpg", 100.0 * 4.0 / 32.0),
    ("iter_launches.ddpg", (3 * 10 + 20 * 50 + 4 * 10 + 150 * 10 + 50) / 10),
    ("mfu.ddpg", 100.0 * 8_168_960_000 / (4e-3 * 67e12)),
])
def test_ddpg_readers_on_a_hand_made_run(name, want):
    reader = _reader(name)
    assert reader.NAME == name
    assert reader.read({}) is None
    info = _info()
    assert reader.read(info) == pytest.approx(want)
    info["platform"] = "cpu"  # no device number from a CPU run
    info["profile"]["device_ops"] = 0
    assert reader.read(info) is None


def test_readers_of_the_new_counter_are_empty_without_it():
    """A program that counts no scalar fills (and a tracer slice without
    replays) gives nothing to the readers that need them."""
    info = _info()
    info["tracer"]["scalar_writes"] = None
    assert _reader("iter_launches.ddpg").read(info) is None
    del info["tracer"]["spans"]["program.replay"]
    assert _reader("host_ms.ddpg").read(info) is None
    assert _reader("gap_share.ddpg").read(info) is None
