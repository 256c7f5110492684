"""The DDPG cell ``single_pendulum.train`` at a small size of its own (the
shared settings of ``conftest.py`` cover the other cells): it loads from
its files alone, its run loads no JAX, and the operations ``mfu.ddpg``
counts match a hand count.  On the card (skipped elsewhere) the cell at
its own size is correct and every control of it fails a limit:

    python -m pytest -m cuda portbench/tests/test_portbench_ddpg.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.ddpg_ops import iteration_ops
from portbench.tests.conftest import SEED

ROOT = Path(__file__).resolve().parents[2]
CELL = "single_pendulum.train"
SMALL = {
    "config": {"run_config.trainer.num_envs": 16,
               "run_config.trainer.train_batch_size": 80,
               "run_config.env.episode_length": 10,
               "run_config.env.reset_pool_size": 32},
    "traffic": {"units": 2, "settle_chunk_units": 1, "reset_iteration": 6,
                "trace_units": 2},
}


def test_the_cell_loads_from_its_files_alone():
    bench, spec, config, traffic, limits = harness.cell_parts(CELL)
    entry = {c["name"]: c for c in bench["configs"]}[spec["config"]]
    assert (spec["config"], spec["traffic"], spec["chips"]) == (
        "single_pendulum", "ddpg", 1)
    assert config["name"] == "single_pendulum" and entry["reduced"] == []
    assert config["source"] == entry["source"]
    run_config = config["run_config"]
    # the published sizes, nothing cut
    assert run_config["trainer"]["num_envs"] == 10_000
    assert run_config["trainer"]["train_batch_size"] == 50_000
    assert run_config["trainer"]["n_step"] == 5
    assert run_config["env"] == {"episode_length": 500,
                                 "reset_pool_size": 10_000}
    assert traffic["driver"] == "ddpg"
    T = run_config["trainer"]["train_batch_size"] // \
        run_config["trainer"]["num_envs"]
    # the compared iteration ends every episode
    assert traffic["reset_iteration"] * T % \
        run_config["env"]["episode_length"] == 0
    assert set(limits) == {"obs_gap", "action_gap", "reward_gap",
                           "mismatches", "reset_gap", "critic_loss_gap",
                           "actor_loss_gap", "change_gap", "target_gap"}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert CELL in e2e["train_env_steps_per_s"]["workloads"]
    assert CELL not in e2e["train_iter_ms_p90"]["workloads"]
    own = sorted(m["name"] for m in bench["per_layer"]
                 if CELL in m["workloads"])
    # the trainer's phase marks and the profiler's idle share are read as
    # in tag_continuous.train; the tracer slice and the operations are the
    # cell's own
    assert own == sorted(
        ["rollout_ms.train", "update_ms.train", "idle_share.train"]
        + [f"{n}.ddpg" for n in ("host_ms", "gap_share", "iter_launches",
                                  "mfu")])


def test_a_run_of_the_cell_loads_no_jax(tmp_path):
    code = (
        "import json\n"
        "from portbench import harness\n"
        f"overrides = json.loads({json.dumps(json.dumps(SMALL))})\n"
        f"line = harness.execute({CELL!r}, 2**31 + 99, 1.0, True,\n"
        "                       device='cpu', overrides=overrides,\n"
        "                       settle=False)\n"
        "assert line['correct'], line['checks']\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
                              "PYTHONPATH": str(ROOT),
                              "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_operations_match_a_hand_count():
    # 3 observations, trunks (64, 64), one action
    actor = 2 * (3 * 64 + 64 * 64 + 64 * 1)
    critic = 2 * (4 * 64 + 64 * 64 + 64 * 1)
    assert (actor, critic) == (8_704, 8_832)
    T, W = 5, 9
    per_env = (T * actor                        # the rollout
               + W * actor + (W - 1) * critic   # the targets
               + W * (critic + critic + critic - 2 * 4 * 64)
               + W * (actor + critic + critic + actor
                      + actor - 2 * 3 * 64))
    assert per_env == 816_896
    assert iteration_ops(3, (64, 64), (64, 64), 1, T, W, 1) == per_env
    assert iteration_ops(3, (64, 64), (64, 64), 1, T, W, 10_000) == \
        pytest.approx(8.16896e9)


@pytest.mark.cuda
def test_the_cell_on_the_card_is_correct_and_its_controls_are_not(card):
    line = harness.execute(CELL, SEED, 1.0, False, device=str(card),
                           overrides={"traffic": {"units": 20}},
                           control=True, settle=False)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    limits = {n: c["limit"] for n, c in line["checks"].items()}
    for kind, numbers in line["control"].items():
        assert [n for n, v in numbers.items() if v > limits[n]], \
            (kind, numbers)
