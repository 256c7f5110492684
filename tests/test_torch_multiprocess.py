"""Multi-process training of the port on the CPU (the counterpart of
``tests/test_multiprocess_distributed.py``): two gloo ranks brought up
through ``initialize_multihost`` on a TCP coordinator
(``parallel/launch.py``) train the CartPole run of
``tests/multiproc_worker.py`` to its end; results and checkpoints are the
lead's alone and the parameters equal on both ranks; a full-state file
resumes across 2 -> 1, 1 -> 2 and 2 -> 2 ranks bit for bit (loaded and
written again, the same file); the CLI's ``-n 2 --device cpu`` trains and
``-n 2`` on ``cuda`` raises here; evaluation and episode fetching give
every rank the global arrays; ``dryrun_multichip(4)`` runs its (2 x 2)
mesh; and the scaling rehearsal's ``_measure_scale`` at a small size."""

import json
import os

import pytest
import torch
import yaml

import numpy as np

from torch_dist_workers import (
    cartpole_config,
    evaluation_rank,
    resume_rank,
    tag_continuous_config,
    train_rank,
)
from warpdrive_tpu_torch.parallel.launch import launch
from warpdrive_tpu_torch.training.scripts import train as port_train


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            _assert_same(a[key], b[key], f"{path}/{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def _payload(path):
    payload = torch.load(path, weights_only=True)
    payload.pop("rank_generators")  # each run's own number of env ranks
    return payload


def test_two_ranks_train_resume_and_write_once(tmp_path):
    cfg = cartpole_config(str(tmp_path))
    results = tmp_path / "results"
    two = str(tmp_path / "two.ckpt")
    got = launch(train_rank, 2, args=(cfg, str(results), two), device="cpu",
                 threads=1, timeout_s=300)
    assert [r["iters"] for r in got] == [4, 4]  # train() ran to its end
    assert [r["lead"] for r in got] == [True, False]
    for name, value in got[0]["params"].items():
        assert torch.equal(value, got[1]["params"][name]), name
    # lead-only outputs: one record a log point, one checkpoint
    with open(results / "results.json", encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    assert [r["iterations completed"] for r in records] == [2, 4]
    assert sorted(os.listdir(results)) == [
        "results.json", "run_config.json", "shared_1280.state_dict"]
    saved = torch.load(results / "shared_1280.state_dict", weights_only=True)
    for name, value in saved.items():
        assert torch.equal(value, got[0]["params"][name])
    payload = torch.load(two, weights_only=True)
    assert payload["training"]["env_state"]["state"].shape[0] == 16
    assert len(payload["rank_generators"]) == 2

    # 2 -> 1: one process loads the two ranks' file and writes it again
    one = port_train.setup_trainer(cfg, verbose=False, device="cpu",
                                   results_dir=str(tmp_path / "one"))
    one.load_full_state(two)
    assert one.iters_completed == 4
    again = str(tmp_path / "two_to_one.ckpt")
    one.save_full_state(again)
    _assert_same(_payload(again), _payload(two))

    # 1 -> 2 (a file of one process) and 2 -> 2 (each env rank its own
    # generators back)
    single = str(tmp_path / "one.ckpt")
    fresh = port_train.setup_trainer(cfg, verbose=False, device="cpu",
                                     results_dir=str(tmp_path / "fresh"))
    fresh._iteration(0)
    fresh.iters_completed = 1
    fresh.save_full_state(single)
    for path_in, label in ((single, "1_to_2"), (two, "2_to_2")):
        out = str(tmp_path / f"{label}.ckpt")
        assert launch(resume_rank, 2,
                      args=(cfg, str(tmp_path / label), path_in, out),
                      device="cpu", threads=1,
                      timeout_s=300) in ([1, 1], [4, 4])
        _assert_same(_payload(out), _payload(path_in))
    _assert_same(torch.load(str(tmp_path / "2_to_2.ckpt"),
                            weights_only=True)["rank_generators"],
                 payload["rank_generators"])


def test_cli_trains_two_ranks_on_the_cpu(tmp_path):
    path = tmp_path / "cartpole.yaml"
    path.write_text(yaml.safe_dump(cartpole_config(str(tmp_path))))
    got = port_train.main(["-e", str(path), "-n", "2", "--device", "cpu",
                           "--results_dir", str(tmp_path / "cli")])
    assert [r["iters_completed"] for r in got] == [4, 4]
    for name, value in got[0]["params"]["shared"].items():
        assert torch.equal(value, got[1]["params"]["shared"][name])
    assert "shared_1280.state_dict" in os.listdir(tmp_path / "cli")
    # one rank a card: two NCCL ranks need two GPUs, none here
    with pytest.raises(ValueError, match="need 2 GPUs"):
        port_train.main(["-e", str(path), "-n", "2", "--device", "cuda"])


def test_evaluation_and_fetching_are_global(tmp_path):
    """Over two ranks every rank gets the global arrays: the argmax
    evaluation and the logged episode of env 3 (rank 1's) equal one
    process's bit for bit; the fetched episode (actions drawn from each
    rank's own stream) is env 3's on every rank, from its reset state."""
    cfg = tag_continuous_config(str(tmp_path))
    one = evaluation_rank("cpu", cfg, 1, str(tmp_path / "one"), 3)
    two = launch(evaluation_rank, 2, args=(cfg, 2, str(tmp_path / "two"), 3),
                 device="cpu", threads=1, timeout_s=300)
    for got in two:
        for tag, value in one["rewards"].items():
            assert got["rewards"][tag].shape == (4, len(value[0]))
            np.testing.assert_array_equal(got["rewards"][tag], value)
            np.testing.assert_array_equal(got["steps"][tag],
                                          one["steps"][tag])
        assert got["logged"].keys() == one["logged"].keys()
        for name, value in one["logged"].items():
            np.testing.assert_array_equal(got["logged"][name], value)
        for name in ("loc_x", "loc_y"):
            np.testing.assert_array_equal(got["states"][name][0],
                                          one["states"][name][0])
            np.testing.assert_array_equal(got["states"][name],
                                          two[0]["states"][name])


def test_dryrun_multichip_on_a_2x2_mesh():
    from warpdrive_tpu_torch.entry import dryrun_multichip

    got = dryrun_multichip(4, device="cpu")
    assert [r["mesh"] for r in got] == [(2, 2)] * 4
    for r in got[1:]:  # every rank reports the global losses
        assert r["losses"] == got[0]["losses"]
    assert set(got[0]["losses"]) == {"full_obs_a2c_ppo", "knn_a2c", "ddpg"}


def test_scaling_rehearsal_measures_a_small_scale(tmp_path):
    from warpdrive_tpu_torch.tools import scaling_rehearsal

    res = scaling_rehearsal._measure_scale(str(tmp_path), 16, timeout_s=300)
    assert res["single_process_8dev_steps_per_sec"] > 0
    assert res["two_process_4dev_steps_per_sec"] > 0
    # a ratio of two timings on a shared host: a sanity bound only
    assert 0 < res["process_scaling_efficiency"] < 10
    assert os.path.exists(tmp_path / "single.json")
    assert os.path.exists(tmp_path / "multi.json")
