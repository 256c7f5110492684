"""The port's CUDA kernels on the card: each kernel against its plain PyTorch
version (bit for bit, or for K4 by its swap class), the flagship loops
launching K1 (K3 with ``pallas_flat``, K6-K9 with their names) once per
step, the 1024-agent loops launching K1, K4, K5 or K9 once per step, and
the training rollout and the evaluation and episode fetching of
``tag_continuous`` launching K2 once per step; on the full-step path (no
kernel), TagGridWorld's and CartPole's steps on the card against the CPU's
and the observation refresh after a pool reset, and DDPG's warm-up gate,
its update against the CPU's and a full-state resume, and the ring
buffer's storage on the card; a served bundle, the repo's JAX checkpoints
(K2) and the eager host-env backend with the policy on the card; the
TagContinuous physics kernel against ``physics_plain`` on rolled states,
and the flagship step and the training rollout launching it once a step;
the categorical-draw kernel (``sample_heads``) against the stacked
``sample_from_logits`` at the rollout's shapes, on masked heads, planted
ties and NaN logits, and the captured rollout step against its eager body
with two draw launches a replay; the done-driven reset kernel against the
plain reset written back, at the three benchmark cells' shapes and on
mixed dtypes, misaligned and aliased buffers, and one launch a step of the
captured flagship step and of the A2C and DDPG rollouts.

These tests need an NVIDIA GPU and skip elsewhere.  The file imports no JAX,
so on a machine with a card and no JAX it runs without the repo's
``conftest.py``::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import contextlib
import copy
import gc
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_knn_warp_order import near_tie_coords
from test_torch_reset_into import mixed_case, stepped
from warpdrive_tpu_torch.envs.classic_control.cartpole import (
    TorchClassicControlCartPoleEnv,
)
from warpdrive_tpu_torch.core.program import (
    Program,
    _leaves,
    assign_state,
    plain_calls,
)
from warpdrive_tpu_torch.core.reset import make_auto_reset_fn, reset_plain
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
from warpdrive_tpu_torch.envs.tag_gridworld import (
    TorchTagGridWorld,
    TorchTagGridWorldWithResetPool,
)
from warpdrive_tpu_torch.models.fully_connected import apply_logit_mask
from warpdrive_tpu_torch.ops import gumbel_sample, knn_obs, tag_physics
from warpdrive_tpu_torch.ops import reset as reset_ops
from warpdrive_tpu_torch.presets import (
    build_flagship,
    build_many_agents,
    captured_loop,
    random_actions_fn,
)
from warpdrive_tpu_torch.sampling.samplers import (
    draw_heads_plain,
    sample_from_logits,
    sample_heads,
)
from warpdrive_tpu_torch.tools.consistency import (
    check_pool_reset,
    step_against_cpu,
)
from warpdrive_tpu_torch.training.scripts.train import (
    setup_trainer,
    setup_trainer_and_train,
)
from warpdrive_tpu_torch.training.ring_buffer import (
    RingBuffer,
    RingBufferManager,
)
from warpdrive_tpu_torch.utils.config import load_run_config


_NO_LAUNCHES = {name: 0 for name in knn_obs.LAUNCH_COUNTS}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _knn_args(N, k, E, seed, device):
    n_taggers = max(2, N // 5)
    env = TorchTagContinuous(
        num_taggers=n_taggers, num_runners=N - n_taggers, grid_length=20.0,
        episode_length=100, use_full_observation=False,
        num_other_agents_observed=k, knn_algorithm="pallas_flat_exact",
        seed=seed,
    )
    rng = np.random.RandomState(seed)
    f32 = np.float32
    state = {
        "loc_x": rng.uniform(0, 20, (E, N)).astype(f32),
        "loc_y": rng.uniform(0, 20, (E, N)).astype(f32),
        "speed": rng.uniform(0, 1, (E, N)).astype(f32),
        "acceleration": rng.uniform(-0.1, 0.1, (E, N)).astype(f32),
        "direction": rng.uniform(0, 2 * np.pi, (E, N)).astype(f32),
        "still_in_the_game": (rng.uniform(size=(E, N)) > 0.2).astype(np.int32),
        "_timestep_": rng.randint(0, 100, (E,)).astype(np.int32),
    }
    state = {name: torch.from_numpy(v).to(device) for name, v in state.items()}
    feats, still_f, t_norm = env._knn_inputs(state)
    return (state["loc_x"], state["loc_y"], feats,
            env._consts(device)["types_f"], still_f, t_norm)


def _assert_matches_plain(out, plain, args, k, variant, bound_share=True):
    """Bit for bit, or for K4 (``flat_mxudist[_exact]``) the swap class,
    its share bounded where ``bound_share``."""
    if variant.startswith("flat_mxudist"):
        knn_obs.check_swap_class(out, plain, args, k, variant,
                                 bound_share=bound_share)
    else:
        assert torch.equal(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("E,N,k", [(1024, 105, 10), (8, 1024, 10), (6, 15, 4),
                                   (3, 40, 20), (2, 2000, 32), (4, 33, 32),
                                   (4, 64, 32), (4, 33, 1), (4, 64, 1),
                                   (2, 1024, 32)])
def test_knn_kernel_matches_plain_on_card(card, E, N, k):
    """Bit for bit, including a full warp of list (k = 32), k = 1, a
    partial and a full last round of 32 candidates (N = 33, 64) and an N
    whose staged inputs need more than 48 KB of shared memory."""
    args = _knn_args(N, k, E, seed=N, device=card)
    before = knn_obs.LAUNCH_COUNTS["knn_obs_flat_exact"]
    out = knn_obs.knn_observation(*args, n_agents=N, k=k)
    assert knn_obs.LAUNCH_COUNTS["knn_obs_flat_exact"] == before + 1
    plain = knn_obs.knn_observation_plain(*args, n_agents=N, k=k)
    torch.cuda.synchronize()
    assert out.shape == (E, N, 8 * k + 1)
    assert torch.equal(out, plain)


@pytest.mark.cuda
def test_knn_kernel_rejects_k_above_its_limit(card):
    args = _knn_args(40, 33, 2, seed=1, device=card)
    with pytest.raises(ValueError, match="k <= 32"):
        knn_obs.knn_observation(*args, n_agents=40, k=33)


@pytest.mark.cuda
def test_flagship_loops_launch_the_kernel_once_per_step(card):
    system = build_flagship(num_envs=16, fc_dims=(32, 32), seed=2)
    gen = torch.Generator(device=card).manual_seed(0)
    state = system["state"]
    checksum = torch.zeros((), device=card)
    knn_obs.reset_launch_counts()
    for _ in range(3):
        state, checksum = system["env_only_step"]((state, checksum), gen)
        state = system["full_loop_step"](system["models"], state, gen)
    torch.cuda.synchronize()
    assert knn_obs.LAUNCH_COUNTS == dict(_NO_LAUNCHES, knn_obs_flat_exact=6)
    assert torch.isfinite(checksum)
    assert state["loc_x"].device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mxu_exact", "mxu"])
@pytest.mark.parametrize("E,N,k", [(100, 110, 10), (1024, 105, 10),
                                   (8, 128, 16), (6, 15, 4), (3, 33, 16)])
def test_single_tile_kernel_matches_plain_on_card(card, variant, E, N, k):
    """Bit for bit in both tie-break modes, including N=128, k=16, whose
    staged rows need more than 48 KB of shared memory."""
    args = _knn_args(N, k, E, seed=N + k, device=card)
    before = knn_obs.LAUNCH_COUNTS["knn_obs_mxu"]
    out = knn_obs.knn_observation(*args, n_agents=N, k=k, variant=variant)
    assert knn_obs.LAUNCH_COUNTS["knn_obs_mxu"] == before + 1
    plain = knn_obs.knn_observation_plain(*args, n_agents=N, k=k,
                                          variant=variant)
    torch.cuda.synchronize()
    assert out.shape == (E, N, 8 * k + 1)
    assert torch.equal(out, plain)


@pytest.mark.cuda
def test_single_tile_kernel_refuses_its_limits(card):
    before = dict(knn_obs.LAUNCH_COUNTS)
    for N, k, match in ((129, 10, "at most 128 agents"), (40, 17, "k <= 16")):
        args = _knn_args(N, k, 2, seed=1, device=card)
        for variant in ("mxu", "mxu_exact"):
            with pytest.raises(ValueError, match=match):
                knn_obs.knn_observation(*args, n_agents=N, k=k,
                                        variant=variant)
    assert knn_obs.LAUNCH_COUNTS == before


@pytest.mark.cuda
def test_training_rollout_launches_k2_once_per_step(card, tmp_path):
    cfg = load_run_config("tag_continuous")
    cfg["trainer"].update({"num_envs": 8, "train_batch_size": 400,
                           "num_episodes": 1, "seed": 1})
    for policy in ("runner", "tagger"):
        cfg["policy"][policy]["model"]["fc_dims"] = [32, 32]
    knn_obs.reset_launch_counts()
    trainer = setup_trainer_and_train(cfg, verbose=False,
                                      results_dir=str(tmp_path))
    torch.cuda.synchronize()
    assert trainer.iters_completed == 1
    assert knn_obs.LAUNCH_COUNTS == dict(_NO_LAUNCHES, knn_obs_mxu=50)


def _ddpg_trainer(name, tmp_path, seed=0, device="cuda"):
    """A DDPG run config at 64 envs x 10 steps, n_step 5 (a 14-row
    window), episodes of 20, a pool of 50."""
    cfg = load_run_config(name)
    cfg["env"].update({"episode_length": 20, "reset_pool_size": 50,
                       "seed": seed})
    cfg["trainer"].update({"num_envs": 64, "train_batch_size": 640,
                           "num_episodes": 128, "seed": seed})
    cfg["saving"]["model_params_save_freq"] = 10_000
    return setup_trainer(cfg, verbose=False, device=device,
                         results_dir=str(tmp_path / f"{name}_{seed}"))


def _ddpg_params(trainer) -> dict:
    return {f"{kind}.{net}.{k}": v.detach().cpu().clone()
            for kind in ("nets", "targets") for net in ("actor", "critic")
            for k, v in getattr(trainer, kind)[net]["shared"]
            .state_dict().items()}


def _max_diff(a: dict, b: dict) -> float:
    return max(float((v - b[k]).abs().max()) for k, v in a.items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["single_pendulum",
                                  "single_continuous_mountain_car"])
def test_ddpg_iterations_on_card_gate_warm_up_and_launch_no_knn(card, name,
                                                                tmp_path):
    """Iteration 1 fills 10 of the 14 rows and moves no net, target or Adam
    count; iteration 2 moves them; no kNN kernel is launched; one more
    update on the card equals the same update on the CPU within 1e-5."""
    trainer = _ddpg_trainer(name, tmp_path)
    built = _ddpg_params(trainer)
    knn_obs.reset_launch_counts()
    metrics = trainer._iteration(0)["shared"]
    assert float(metrics["Buffer full"]) == 0.0
    assert _max_diff(_ddpg_params(trainer), built) == 0.0
    assert trainer.optimizers["actor"]["shared"].count == 0
    metrics = trainer._iteration(640)["shared"]
    torch.cuda.synchronize()
    assert float(metrics["Buffer full"]) == 1.0
    assert np.isfinite(float(metrics["Critic loss"]))
    assert _max_diff(_ddpg_params(trainer), built) > 0.0
    assert trainer.optimizers["critic"]["shared"].count == 1
    assert knn_obs.LAUNCH_COUNTS == _NO_LAUNCHES

    # one more update on the same rows: the card's trainer against a CPU
    # trainer holding its training state
    cpu = _ddpg_trainer(name, tmp_path / "cpu", device="cpu")
    cpu._load_training_state(trainer._training_state())
    rows = {k: v.cpu() for k, v in trainer._rows.items()}
    updated = []
    for each in (trainer, cpu):
        each._replay_update({k: v.to(each.device) for k, v in rows.items()},
                            1280)
        updated.append(_ddpg_params(each))
    assert _max_diff(*updated) <= 1e-5


@pytest.mark.cuda
def test_ddpg_full_state_resume_on_card(card, tmp_path):
    """2 iterations, ``save_full_state``, a fresh trainer of other seeds
    ``load_full_state`` and 2 more: the nets and targets of 4 straight
    iterations within 1e-6."""
    def run(trainer, n):
        for _ in range(n):
            trainer._iteration(trainer.current_timestep)
            trainer.current_timestep += trainer.train_batch_size
            trainer.iters_completed += 1

    straight = _ddpg_trainer("single_pendulum", tmp_path)
    run(straight, 4)
    first = _ddpg_trainer("single_pendulum", tmp_path / "first")
    run(first, 2)
    resumed = _ddpg_trainer("single_pendulum", tmp_path, seed=1)
    resumed.load_full_state(first.save_full_state())
    run(resumed, 2)
    torch.cuda.synchronize()
    assert _max_diff(_ddpg_params(resumed), _ddpg_params(straight)) <= 1e-6


@pytest.mark.cuda
def test_ring_buffer_on_card_matches_cpu_through_wraps(card):
    """A ring buffer's storage defaults to the card; 11 enqueues into a
    capacity of 4 unroll, oldest first, as the same buffer on the CPU."""
    on_card = RingBufferManager()
    on_cpu = RingBufferManager()
    buf = on_card.add("X", capacity=4, item_shape=(2, 3))
    on_cpu.add("X", capacity=4, item_shape=(2, 3), device="cpu")
    assert buf.device.type == "cuda"
    rows = np.random.default_rng(0).normal(size=(11, 2, 3)).astype(np.float32)
    for row in rows:
        on_card.enqueue("X", torch.from_numpy(row).to(card))
        on_cpu.enqueue("X", torch.from_numpy(row))
        assert torch.equal(on_card.unroll("X").cpu(), on_cpu.unroll("X"))
        assert on_card.get("X")[1].size == on_cpu.get("X")[1].size
    assert RingBuffer.isfull(on_card.get("X")[1])
    assert torch.equal(on_card.unroll("X").cpu(), torch.from_numpy(rows[-4:]))


@pytest.mark.cuda
def test_tag_continuous_episodes_launch_k2_once_per_step(card, tmp_path):
    """``evaluate_episodes``, ``fetch_episode_states`` (with probabilities)
    and ``fetch_logged_episode`` of ``loc_x``, ``loc_y`` and
    ``still_in_the_game`` each step their episode of 40 with one K2 launch
    a step."""
    cfg = load_run_config("tag_continuous")
    cfg["env"]["episode_length"] = 40
    cfg["trainer"].update({"num_envs": 8, "train_batch_size": 400,
                           "num_episodes": 10, "seed": 1})
    for policy in ("runner", "tagger"):
        cfg["policy"][policy]["model"]["fc_dims"] = [32, 32]
    trainer = setup_trainer(cfg, verbose=False, results_dir=str(tmp_path))
    names = ["loc_x", "loc_y", "still_in_the_game"]
    runs = [trainer.evaluate_episodes,
            lambda: trainer.fetch_episode_states(
                names, env_id=3, include_probabilities=True),
            lambda: trainer.fetch_logged_episode(env_id=3)]
    for run in runs:
        knn_obs.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        assert knn_obs.LAUNCH_COUNTS == dict(_NO_LAUNCHES, knn_obs_mxu=40)
        if isinstance(out, dict):
            assert all(out[n].shape[0] == out["loc_x"].shape[0] >= 2
                       for n in names)


_KERNEL_OF = {"flat": "knn_obs_flat", "flat_mxudist": "knn_obs_flat_mxudist",
              "flat_mxudist_exact": "knn_obs_flat_mxudist",
              "tiled": "knn_obs_tiled", "tiled_exact": "knn_obs_tiled",
              "tiled_mxudist": "knn_obs_tiled",
              "tiled_mxudist_exact": "knn_obs_tiled"}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["flat", "flat_mxudist",
                                     "flat_mxudist_exact"])
@pytest.mark.parametrize("E,N,k", [(1024, 105, 10), (8, 1024, 10),
                                   (6, 15, 4), (2, 2000, 32), (4, 33, 32),
                                   (4, 64, 32), (4, 33, 1), (4, 64, 1),
                                   (4, 1023, 10), (4, 1057, 32),
                                   (4, 1300, 1)])
def test_v9_packed_and_mxu_distance_kernels_match_plain_on_card(card, variant,
                                                                E, N, k):
    """K3 bit for bit and K4 by its swap class (from 1024 agents on its
    tensor cores sum the MXU distance in their own order:
    ``knn_obs.check_swap_class``), including a full warp of list (k = 32),
    k = 1, partial and full last rounds (N = 33, 64), K4's scalar form at
    its largest N (1023), its tile with a third chunk of 33 (N = 1057) and
    of 276 candidates (N = 1300), and N whose staging needs more than 48
    KB of shared memory."""
    args = _knn_args(N, k, E, seed=N + 1, device=card)
    name = _KERNEL_OF[variant]
    before = knn_obs.LAUNCH_COUNTS[name]
    out = knn_obs.knn_observation(*args, n_agents=N, k=k, variant=variant)
    assert knn_obs.LAUNCH_COUNTS[name] == before + 1
    plain = knn_obs.knn_observation_plain(*args, n_agents=N, k=k,
                                          variant=variant)
    torch.cuda.synchronize()
    _assert_matches_plain(out, plain, args, k, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tiled", "tiled_exact", "tiled_mxudist",
                                     "tiled_mxudist_exact"])
@pytest.mark.parametrize("E,N,k", [(8, 1024, 10), (3, 300, 10), (3, 200, 6),
                                   (8, 128, 16), (4, 33, 16), (4, 64, 1)])
def test_tiled_kernel_matches_plain_on_card(card, variant, E, N, k):
    args = _knn_args(N, k, E, seed=N + 2, device=card)
    before = knn_obs.LAUNCH_COUNTS["knn_obs_tiled"]
    out = knn_obs.knn_observation(*args, n_agents=N, k=k, variant=variant)
    assert knn_obs.LAUNCH_COUNTS["knn_obs_tiled"] == before + 1
    plain = knn_obs.knn_observation_plain(*args, n_agents=N, k=k,
                                          variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,name", [
    ("pallas_flat_exact", "knn_obs_flat_exact"),
    ("pallas_flat_mxudist", "knn_obs_flat_mxudist"),
    ("pallas_tiled_exact", "knn_obs_tiled"),
    ("pallas_mxu_exact", "knn_obs_tiled"),
])
def test_many_agent_loop_launches_one_kernel_per_step(card, algo, name):
    system = build_many_agents(num_envs=4, knn_algorithm=algo)
    gen = torch.Generator(device=card).manual_seed(0)
    state, checksum = system["state"], torch.zeros((), device=card)
    knn_obs.reset_launch_counts()
    for _ in range(3):
        state, checksum = system["env_only_step"]((state, checksum), gen)
    torch.cuda.synchronize()
    assert knn_obs.LAUNCH_COUNTS == dict(_NO_LAUNCHES, **{name: 3})
    assert torch.isfinite(checksum)


@pytest.mark.cuda
def test_flagship_packed_loop_launches_k3_once_per_step(card):
    system = build_flagship(num_envs=16, fc_dims=(32, 32), seed=2,
                            knn_algorithm="pallas_flat")
    gen = torch.Generator(device=card).manual_seed(0)
    state, checksum = system["state"], torch.zeros((), device=card)
    knn_obs.reset_launch_counts()
    for _ in range(3):
        state, checksum = system["env_only_step"]((state, checksum), gen)
    torch.cuda.synchronize()
    assert knn_obs.LAUNCH_COUNTS == dict(_NO_LAUNCHES, knn_obs_flat=3)


_WARP_SCAN_KERNEL_OF = dict(_KERNEL_OF, flat_exact="knn_obs_flat_exact",
                            envlanes="knn_obs_envlanes",
                            envlanes_exact="knn_obs_envlanes",
                            mxu="knn_obs_mxu", mxu_exact="knn_obs_mxu")


def _lattice_args(N, k, E, seed, device):
    """Random inputs with the agents on an integer lattice: exact distance
    ties everywhere."""
    args = _knn_args(N, k, E, seed, device)
    rng = np.random.RandomState(seed)
    side = int(np.ceil(np.sqrt(N)))
    cells = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                     -1).reshape(-1, 2)
    xy = np.stack([cells[rng.permutation(len(cells))[:N]] for _ in range(E)])
    xy = torch.from_numpy(xy.astype(np.float32) * 1.5).to(device)
    return (xy[..., 0].contiguous(), xy[..., 1].contiguous()) + args[2:]


def _near_tie_args(device):
    """One env of 15 live agents where agent 1 lies a few ulps farther from
    observer 0 than agent 2: a tie under 7 packed index bits, not under the
    4 that the v9 order packs at N = 15."""
    x0, xa, xb = near_tie_coords()
    args = _knn_args(15, 2, 1, seed=4, device=device)
    loc_x, loc_y = args[0].clone(), args[1].clone()
    loc_x[0, :3] = torch.tensor([x0, xa, xb])
    loc_y[0, :3] = 10.0
    loc_x[0, 3:] = torch.linspace(1.0, 19.0, 12)
    loc_y[0, 3:] = 2.0
    return (loc_x, loc_y, args[2], args[3], torch.ones_like(args[4]),
            args[5])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(_WARP_SCAN_KERNEL_OF))
@pytest.mark.parametrize("state", ["lattice", "near-tie"])
def test_warp_scan_kernels_match_plain_on_ties_on_card(card, variant, state):
    """K1, K2, K3, K5 and K9 bit for bit, and K4 by its swap class (its
    share reported, not bounded: these are ties by construction), where
    the warp's k-list decides ties: an exact-tie lattice at (8, 1024, 10)
    -- (8, 128, 10) for K2, a single 128-agent tile -- where an equal key
    must enter behind the ones held, and the N = 15 near-tie, where the
    packed orders of 4 bits take agent 2 first and K2's of 7 agent 1."""
    if state == "lattice":
        E, N, k = (8, 128, 10) if variant.startswith("mxu") else (8, 1024,
                                                                  10)
        args = _lattice_args(N, k, E, seed=6, device=card)
    else:
        E, N, k = 1, 15, 2
        args = _near_tie_args(card)
    name = _WARP_SCAN_KERNEL_OF[variant]
    before = knn_obs.LAUNCH_COUNTS[name]
    out = knn_obs.knn_observation(*args, n_agents=N, k=k, variant=variant)
    assert knn_obs.LAUNCH_COUNTS[name] == before + 1
    plain = knn_obs.knn_observation_plain(*args, n_agents=N, k=k,
                                          variant=variant)
    torch.cuda.synchronize()
    _assert_matches_plain(out, plain, args, k, variant, bound_share=False)
    if state == "near-tie" and "mxudist" not in variant:
        first = 1 if knn_obs.packed_bits(variant, N) == 7 else 2
        assert float(out[0, 0, 0]) == float(args[2][0, 0, first]
                                            - args[2][0, 0, 0])


_LADDER_KERNEL_OF = {"packed": "knn_obs_packed", "onehot": "knn_obs_onehot",
                     "twolevel": "knn_obs_twolevel",
                     "twolevel_exact": "knn_obs_twolevel"}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["packed", "onehot", "twolevel",
                                     "twolevel_exact"])
@pytest.mark.parametrize("E,N,k", [(1024, 105, 10), (100, 110, 10),
                                   (8, 128, 16), (6, 15, 4), (3, 33, 1)])
def test_ladder_kernels_match_plain_on_card(card, variant, E, N, k):
    """K6, K7 and K8 bit for bit, one warp per observer, at N up to the
    128-agent tile."""
    args = _knn_args(N, k, E, seed=N + 3, device=card)
    name = _LADDER_KERNEL_OF[variant]
    before = knn_obs.LAUNCH_COUNTS[name]
    out = knn_obs.knn_observation(*args, n_agents=N, k=k, variant=variant)
    assert knn_obs.LAUNCH_COUNTS[name] == before + 1
    plain = knn_obs.knn_observation_plain(*args, n_agents=N, k=k,
                                          variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["packed", "onehot"])
def test_per_slot_ladder_kernels_take_k_past_16_on_card(card, variant):
    args = _knn_args(40, 40, 2, seed=4, device=card)
    out = knn_obs.knn_observation(*args, n_agents=40, k=40, variant=variant)
    plain = knn_obs.knn_observation_plain(*args, n_agents=40, k=40,
                                          variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["random", "lattice"])
@pytest.mark.parametrize("variant", ["packed", "onehot"])
def test_per_slot_ladder_kernels_fill_the_winner_table_on_card(card, variant,
                                                               state):
    """K6 and K7 at k = n = 128: each warp's winner table at its largest,
    with k past the warp's 32 lanes and slot 127 past every observer's
    127 candidates."""
    make = _lattice_args if state == "lattice" else _knn_args
    args = make(128, 128, 8, seed=5, device=card)
    out = knn_obs.knn_observation(*args, n_agents=128, k=128, variant=variant)
    plain = knn_obs.knn_observation_plain(*args, n_agents=128, k=128,
                                          variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)


def _dead_third_args(N, k, E, seed, device):
    """Random inputs with a third of the agents dead, drawn anew."""
    args = _knn_args(N, k, E, seed, device)
    rng = np.random.RandomState(seed + 1)
    still = torch.from_numpy(
        (rng.uniform(size=(E, N)) >= 1 / 3).astype(np.float32)).to(device)
    return args[:4] + (still,) + args[5:]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(_LADDER_KERNEL_OF))
@pytest.mark.parametrize("E,N,k", [(1024, 105, 10), (8, 128, 16),
                                   (6, 20, 16)])
def test_ladder_kernels_match_plain_with_a_third_dead_on_card(card, variant,
                                                              E, N, k):
    """K6, K7 and K8 bit for bit where a third of the agents are dead: dead
    observers' zero rows, dead candidates skipped, and at (6, 20, 16)
    observers with fewer valid candidates than k, whose passes stop early."""
    args = _dead_third_args(N, k, E, seed=N + 11, device=card)
    name = _LADDER_KERNEL_OF[variant]
    before = knn_obs.LAUNCH_COUNTS[name]
    out = knn_obs.knn_observation(*args, n_agents=N, k=k, variant=variant)
    assert knn_obs.LAUNCH_COUNTS[name] == before + 1
    plain = knn_obs.knn_observation_plain(*args, n_agents=N, k=k,
                                          variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    assert bool((plain[..., -1] == 0).any())  # some observer is dead


@pytest.mark.cuda
def test_ladder_kernels_refuse_their_limits_on_card(card):
    before = dict(knn_obs.LAUNCH_COUNTS)
    args = _knn_args(129, 10, 2, seed=1, device=card)
    for variant in _LADDER_KERNEL_OF:
        with pytest.raises(ValueError, match="at most 128 agents"):
            knn_obs.knn_observation(*args, n_agents=129, k=10,
                                    variant=variant)
    args = _knn_args(40, 17, 2, seed=1, device=card)
    for variant in ("twolevel", "twolevel_exact"):
        with pytest.raises(ValueError, match="k <= 16"):
            knn_obs.knn_observation(*args, n_agents=40, k=17,
                                    variant=variant)
    assert knn_obs.LAUNCH_COUNTS == before


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["envlanes", "envlanes_exact"])
@pytest.mark.parametrize("E,N,k", [(1024, 105, 10), (130, 15, 4),
                                   (3, 200, 6), (8, 1024, 10), (2, 70, 32),
                                   (33, 9, 9), (4, 33, 32), (4, 64, 32),
                                   (4, 33, 1), (4, 64, 1), (2, 8192, 10)])
def test_envlanes_kernel_matches_plain_on_card(card, variant, E, N, k):
    """K9 bit for bit: odd env counts (E = 130, 33), a full warp of list
    (k = 32), k = 1, partial and full last rounds (N = 33, 64), and N =
    8192, whose candidates take eight staged chunks of 1024."""
    args = _knn_args(N, k, E, seed=N + 4, device=card)
    before = knn_obs.LAUNCH_COUNTS["knn_obs_envlanes"]
    out = knn_obs.knn_observation(*args, n_agents=N, k=k, variant=variant)
    assert knn_obs.LAUNCH_COUNTS["knn_obs_envlanes"] == before + 1
    plain = knn_obs.knn_observation_plain(*args, n_agents=N, k=k,
                                          variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,name", [
    ("pallas", "knn_obs_packed"), ("pallas_onehot", "knn_obs_onehot"),
    ("pallas_twolevel", "knn_obs_twolevel"),
    ("pallas_twolevel_exact", "knn_obs_twolevel"),
    ("pallas_envlanes", "knn_obs_envlanes"),
    ("pallas_envlanes_exact", "knn_obs_envlanes"),
])
def test_flagship_loops_launch_each_names_kernel_once_per_step(card, algo,
                                                               name):
    system = build_flagship(num_envs=16, fc_dims=(32, 32), seed=2,
                            knn_algorithm=algo)
    gen = torch.Generator(device=card).manual_seed(0)
    state, checksum = system["state"], torch.zeros((), device=card)
    knn_obs.reset_launch_counts()
    for _ in range(3):
        state, checksum = system["env_only_step"]((state, checksum), gen)
        state = system["full_loop_step"](system["models"], state, gen)
    torch.cuda.synchronize()
    assert knn_obs.LAUNCH_COUNTS == dict(_NO_LAUNCHES, **{name: 6})
    assert torch.isfinite(checksum)


@pytest.mark.cuda
def test_many_agent_envlanes_loop_launches_k9_once_per_step(card):
    system = build_many_agents(num_envs=4,
                               knn_algorithm="pallas_envlanes_exact")
    gen = torch.Generator(device=card).manual_seed(0)
    state, checksum = system["state"], torch.zeros((), device=card)
    knn_obs.reset_launch_counts()
    for _ in range(3):
        state, checksum = system["env_only_step"]((state, checksum), gen)
    torch.cuda.synchronize()
    assert knn_obs.LAUNCH_COUNTS == dict(_NO_LAUNCHES, knn_obs_envlanes=3)
    assert torch.isfinite(checksum)


# the full-step path: TagGridWorld and the classic-control envs (no kNN
# kernel; PyTorch ops on the card against the same ops on the CPU)
@pytest.mark.cuda
@pytest.mark.parametrize("full", [True, False], ids=["full_obs", "partial_obs"])
def test_gridworld_step_on_card_equals_cpu(card, full):
    """60 steps of TagGridWorld from the same states on the card and on the
    CPU: positions, rewards, done flags and observations bit for bit (every
    division is by a device tensor, so CUDA divides as the CPU does), and
    no kNN kernel launched."""
    config = dict(num_taggers=4, grid_length=20, episode_length=30, seed=7,
                  use_full_observation=full)
    engines = [EnvEngine(env_obj=TorchTagGridWorld(**config), num_envs=256,
                         seed=7, device=device) for device in (card, "cpu")]
    knn_obs.reset_launch_counts()
    worst = step_against_cpu(*engines, steps=60)
    assert worst == dict.fromkeys(worst, 0.0), worst
    assert knn_obs.LAUNCH_COUNTS == _NO_LAUNCHES


@pytest.mark.cuda
def test_cartpole_pool_step_on_card_matches_cpu(card):
    """CartPole with a reset pool, 60 steps from the same states: state
    and observations within 1e-5 (CUDA's sin/cos and its division by a host
    scalar through the reciprocal move last bits), rewards and done flags
    equal."""
    config = dict(episode_length=40, reset_pool_size=1000, seed=5)
    engines = [EnvEngine(env_obj=TorchClassicControlCartPoleEnv(**config),
                         num_envs=512, seed=5, device=device)
               for device in (card, "cpu")]
    worst = step_against_cpu(*engines, steps=60)
    assert worst["rewards"] == 0.0
    assert max(worst.values()) <= 1e-5, worst


@pytest.mark.cuda
@pytest.mark.parametrize("env", ["gridworld", "cartpole"])
def test_pool_reset_refreshes_observations_on_card(card, env):
    """A forced and a done-driven pool reset on the card: every reset row
    is a row of its pool and the reset envs' observations are observe_fn
    of the reset state, the other envs' unchanged."""
    env_obj = (TorchTagGridWorldWithResetPool(
        num_taggers=4, grid_length=20, episode_length=30, seed=3,
        reset_pool_size=64) if env == "gridworld"
        else TorchClassicControlCartPoleEnv(episode_length=40, seed=3,
                                            reset_pool_size=64))
    engine = EnvEngine(env_obj=env_obj, num_envs=1024, seed=3, device=card)
    gen = torch.Generator(device=card).manual_seed(3)
    actions = random_actions_fn(engine, card)
    state = engine.state
    for _ in range(10):
        state = engine.step(state, actions(gen))
    assert check_pool_reset(engine, state) == 1024
    done = torch.rand((1024,), generator=gen, device=card) < 0.3
    assert check_pool_reset(engine, state, done=done) == int(done.sum())


# serving, the JAX package's checkpoints and the eager host-env backend on
# the card (PR 13; no new kernel)
@pytest.mark.cuda
def test_serving_bundle_on_card_matches_cpu(card, tmp_path):
    """A CartPole policy exported by ``export_policy`` and loaded on the
    card and on the CPU: the card answers with int32 tensors on the card,
    the same argmax actions as the CPU and as the trainer's own."""
    from warpdrive_tpu_torch.serving import export_policy, load_policy

    cfg = load_run_config("single_cartpole")
    cfg["trainer"].update({"num_envs": 256, "train_batch_size": 2560,
                           "num_episodes": 100})
    cfg["env"].update({"episode_length": 50, "seed": 5})
    trainer = setup_trainer(cfg, verbose=False, device=card,
                            results_dir=str(tmp_path / "r"))
    bundle = export_policy(trainer, "shared", str(tmp_path / "bundle"))
    act, _ = load_policy(bundle, device=card)
    act_cpu, _ = load_policy(bundle, device="cpu")
    obs, _ = trainer._policy_obs_and_mask(trainer.engine.state, None,
                                          "shared")
    served = act(obs)
    assert served.device.type == "cuda" and served.dtype == torch.int32
    assert torch.equal(served, trainer._act_fn(trainer.engine.state))
    assert torch.equal(served.cpu(), act_cpu(obs.cpu()))


@pytest.mark.cuda
def test_jax_checkpoint_evaluates_on_card_through_k2(card, tmp_path):
    """The repo's JAX-trained ``tag_continuous`` policies (flax files) load
    on the card from the artifact's run config and evaluate with one K2
    launch a step (``pallas_mxu_exact``)."""
    import json
    from pathlib import Path

    from warpdrive_tpu_torch.models.fully_connected import params_from_flax
    from warpdrive_tpu_torch.utils import flax_msgpack

    folder = Path(__file__).resolve().parent.parent / "artifacts" / \
        "tag_continuous_cpu"
    cfg = json.loads((folder / "run_config.json").read_text())
    cfg["env"]["knn_algorithm"] = "pallas_mxu_exact"
    for tag, policy in cfg["policy"].items():
        policy["model"]["model_ckpt_filepath"] = str(
            next(folder.glob(f"{tag}_[0-9]*.state_dict")))
    trainer = setup_trainer(cfg, verbose=False, device=card,
                            results_dir=str(tmp_path / "r"))
    for tag, model in trainer.models.items():
        want = params_from_flax(flax_msgpack.read_file(
            cfg["policy"][tag]["model"]["model_ckpt_filepath"]))
        for key, value in model.state_dict().items():
            assert torch.equal(value.cpu(), want[key]), (tag, key)
    knn_obs.reset_launch_counts()
    rew, _ = trainer.evaluate_episodes()
    assert knn_obs.LAUNCH_COUNTS == dict(
        _NO_LAUNCHES, knn_obs_mxu=trainer.engine.episode_length)
    assert all(np.isfinite(r).all() for r in rew.values())


@pytest.mark.cuda
def test_eager_backend_trains_with_the_policy_on_card(card, tmp_path):
    """``single_cartpole`` with ``env_backend: cpp``: the C++ stepper on the
    host, the engine's outputs and the model on the card, 2 iterations,
    finite losses, no kNN launch."""
    from warpdrive_tpu_torch.envs.cpu_engine import CpuEnvEngine

    cfg = load_run_config("single_cartpole")
    cfg["trainer"].update({"num_envs": 64, "train_batch_size": 640,
                           "num_episodes": 26, "env_backend": "cpp"})
    cfg["env"].update({"episode_length": 50})
    knn_obs.reset_launch_counts()
    trainer = setup_trainer_and_train(cfg, verbose=False, device=card,
                                      results_dir=str(tmp_path / "r"))
    assert isinstance(trainer.engine, CpuEnvEngine)
    assert trainer.engine._native is not None
    assert trainer.iters_completed == 2
    assert all(v.device.type == "cuda"
               for v in trainer.engine.state.values())
    assert knn_obs.LAUNCH_COUNTS == _NO_LAUNCHES


@pytest.mark.cuda
def test_ddpg_programs_equal_the_eager_iteration_on_card(card, tmp_path):
    """Captured DDPG programs against their bodies called op by op
    (``plain_calls``) on the card, 3 iterations across the warm-up gate
    (the captured side full, then hot, then full; the plain side full):
    nets, targets, Adam states, window and OU state bit for bit."""
    eager = _ddpg_trainer("single_pendulum", tmp_path / "eager")
    programmed = _ddpg_trainer("single_pendulum", tmp_path / "programmed")
    assert programmed._programmed
    for i, full in enumerate((True, False, True)):
        programmed._iteration(i * 640, full=full)
        with plain_calls():
            eager._iteration(i * 640)
    assert _max_diff(_ddpg_params(programmed), _ddpg_params(eager)) == 0.0
    for net in ("actor", "critic"):
        a = programmed.optimizers[net]["shared"].state_dict()
        b = eager.optimizers[net]["shared"].state_dict()
        assert a["count"] == b["count"] == 2
        for moment in ("mu", "nu"):
            for k, v in a[moment].items():
                assert torch.equal(v, b[moment][k]), (net, moment, k)
    for key, v in programmed._window.items():
        assert torch.equal(v, eager._window[key]), key
    assert torch.equal(programmed._ou["shared"], eager._ou["shared"])
    assert programmed._programs["rollout"].graph is not None


@pytest.mark.cuda
def test_facade_programs_equal_the_eager_facade_on_card(card):
    """The flagship (8 envs, K1) through the engine facade: 20 steps and
    soft resets, then a forced reset, replayed programs against their
    bodies called op by op (``plain_calls``) bit for bit; one K1 launch a
    step either way."""
    engines = [build_flagship(num_envs=8, fc_dims=(8, 8), seed=2,
                              device=card)["engine"] for _ in range(2)]
    gen = torch.Generator(device=card).manual_seed(4)
    nvec = [int(n) for n in engines[0].action_space[0].nvec]
    actions = [torch.stack([torch.randint(0, n, (8, engines[0].n_agents),
                                          generator=gen, device=card)
                            for n in nvec], -1) for _ in range(20)]
    for engine, plain in zip(engines, (True, False)):
        with plain_calls() if plain else contextlib.nullcontext():
            engine.reset_all_envs()
            knn_obs.reset_launch_counts()
            for a in actions:
                engine.step_all_envs(a)
                engine.reset_only_done_envs()
            engine.reset_all_envs()
        torch.cuda.synchronize()
        assert knn_obs.LAUNCH_COUNTS["knn_obs_flat_exact"] == 20
    for name, value in engines[0].state.items():
        assert torch.equal(value, engines[1].state[name]), name
    assert engines[1]._facade_programs["step"].graph is not None


# ------------------------------------------------ the TagContinuous physics
_PHYSICS_FIELDS = ("loc_x", "loc_y", "speed", "direction", "acceleration",
                   "still_in_the_game", "rewards", "_timestep_", "_done_")


def _physics_case(E, N, T, exits, seed, device):
    """An env of N agents (T taggers) on a square that holds ~0.1 agents a
    unit of area, so runners get tagged and agents cross the edges; a
    state with a fifth of the agents out of the game, timesteps 1-4 steps
    short of the episode's end, and taggers 0 and 1 twins (the same state,
    and the same actions in :func:`_physics_actions`) in even envs, so
    their distances to every runner tie."""
    grid = float(np.sqrt(N / 0.1) / 3)
    env = TorchTagContinuous(
        num_taggers=T, num_runners=N - T, grid_length=grid,
        episode_length=20, use_full_observation=False,
        num_other_agents_observed=2, seed=seed, tagging_distance=0.1,
        edge_hit_penalty=-0.5, step_penalty_for_tagger=-0.01,
        step_reward_for_runner=0.02, runner_exits_game_after_tagged=exits,
    )
    rng = np.random.RandomState(seed)
    f32 = np.float32
    state = {
        "loc_x": rng.uniform(0, grid, (E, N)).astype(f32),
        "loc_y": rng.uniform(0, grid, (E, N)).astype(f32),
        "speed": rng.uniform(0, 1, (E, N)).astype(f32),
        "acceleration": rng.uniform(-0.5, 0.5, (E, N)).astype(f32),
        "direction": rng.uniform(0, 2 * np.pi, (E, N)).astype(f32),
        "still_in_the_game": (rng.uniform(size=(E, N)) > 0.2).astype(
            np.int32),
        "rewards": np.zeros((E, N), f32),
        "_timestep_": rng.randint(16, 20, (E,)).astype(np.int32),
        "_done_": np.zeros((E,), np.int32),
    }
    twin, first = np.where(env.is_tagger)[0][:2]
    for name in ("loc_x", "loc_y", "speed", "acceleration", "direction",
                 "still_in_the_game"):
        state[name][::2, twin] = state[name][::2, first]
    return env, {name: torch.from_numpy(v).to(device)
                 for name, v in state.items()}


def _physics_actions(env, E, seed, device):
    """int32 ``(E, N, 2)`` random actions, taggers 0 and 1 alike in even
    envs."""
    rng = np.random.RandomState(seed)
    nvec = env.action_space[0].nvec
    actions = np.stack([rng.randint(0, n, (E, env.num_agents))
                        for n in nvec], -1).astype(np.int32)
    twin, first = np.where(env.is_tagger)[0][:2]
    actions[::2, twin] = actions[::2, first]
    return torch.from_numpy(actions).to(device)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("exits", [True, False])
@pytest.mark.parametrize("E,N,T", [(1024, 105, 5), (100, 110, 10),
                                   (256, 1024, 20), (4, 10, 2),
                                   (3, 2100, 25)])
def test_physics_kernel_matches_plain_on_card(card, E, N, T, exits):
    """Bit for bit (the sign of a zero included) with ``physics_plain`` on
    the card, over 6 rolled steps: tags, ties between twin taggers, edge
    crossings, agents already out, ``t == episode_length`` and after it;
    one launch a call, the input left as it was.  N = 2100 takes more
    agents than a block has threads."""
    env, state = _physics_case(E, N, T, exits, seed=N + T, device=card)
    tagged = ties = crossed = last_steps = 0
    tagger_ids = env._consts(card)["tagger_ids"]
    grid = float(env.grid_length)
    for step in range(6):
        actions = _physics_actions(env, E, seed=step, device=card)
        before = {name: t.clone() for name, t in state.items()}
        launches = tag_physics.LAUNCH_COUNTS["tag_physics"]
        out = env.physics_fn(state, actions)
        assert tag_physics.LAUNCH_COUNTS["tag_physics"] == launches + 1
        plain = env.physics_plain(state, actions)
        torch.cuda.synchronize()
        for name, value in before.items():
            assert torch.equal(_bits(state[name]), _bits(value)), name
        assert out.keys() == plain.keys()
        for name in _PHYSICS_FIELDS:
            assert out[name].dtype == plain[name].dtype, name
            assert torch.equal(_bits(out[name]), _bits(plain[name])), name
        # what the step covered
        alive = state["still_in_the_game"] > 0
        runner = torch.from_numpy(env.is_runner).to(card)
        dist = torch.sqrt((plain["loc_x"][:, :, None]
                           - plain["loc_x"][:, None, tagger_ids]) ** 2
                          + (plain["loc_y"][:, :, None]
                             - plain["loc_y"][:, None, tagger_ids]) ** 2)
        hit = alive & runner & (dist.amin(dim=2) < env.
                                distance_margin_for_reward)
        tie = (dist == dist.amin(dim=2, keepdim=True)).sum(dim=2) > 1
        tagged += int(hit.sum())
        ties += int((hit & tie).sum())
        crossed += int(sum(((plain[name] == 0) | (plain[name] == grid))
                           .sum() for name in ("loc_x", "loc_y")))
        last_steps += int((plain["_timestep_"] == 20).sum())
        state = plain
    assert tagged and ties and crossed and last_steps, (tagged, ties,
                                                         crossed, last_steps)


@pytest.mark.cuda
def test_physics_kernel_refuses_what_it_does_not_take_on_card(card):
    """int64 actions, a non-contiguous field and a wrong shape raise
    before any launch."""
    env, state = _physics_case(4, 10, 2, True, seed=1, device=card)
    actions = _physics_actions(env, 4, seed=1, device=card)
    launches = tag_physics.LAUNCH_COUNTS["tag_physics"]
    with pytest.raises(ValueError, match="actions: dtype"):
        env.physics_fn(state, actions.long())
    with pytest.raises(ValueError, match="speed is not contiguous"):
        env.physics_fn(dict(state, speed=state["speed"].t().contiguous()
                            .t()), actions)
    with pytest.raises(ValueError, match="actions: shape"):
        env.physics_fn(state, actions[..., :1])
    assert tag_physics.LAUNCH_COUNTS["tag_physics"] == launches


@pytest.mark.cuda
def test_physics_kernel_takes_negative_actions_as_plain_does_on_card(card):
    """A negative action counts from the end of its table, as the plain
    version's indexing counts it: -1 and -size, bit for bit."""
    env, state = _physics_case(4, 10, 2, True, seed=3, device=card)
    actions = _physics_actions(env, 4, seed=3, device=card)
    consts = env._consts(card)
    sizes = [consts["acc_table"].numel(), consts["turn_table"].numel()]
    for col, size in enumerate(sizes):
        actions[0::2, :, col] -= size  # [0, size) -> [-size, 0)
    actions[1, 0] = -1
    out = env.physics_fn(state, actions)
    plain = env.physics_plain(state, actions)
    torch.cuda.synchronize()
    for name in _PHYSICS_FIELDS:
        assert torch.equal(_bits(out[name]), _bits(plain[name])), name


_OUT_OF_RANGE = """
import sys
import torch
sys.path.insert(0, {tests!r})
from test_torch_cuda_kernels import _physics_actions, _physics_case
env, state = _physics_case(4, 10, 2, True, seed=1, device="cuda")
actions = _physics_actions(env, 4, seed=1, device="cuda")
size = env._consts("cuda")[{table!r}].numel()
actions[1, 3, {col}] = {value}
try:
    env.{fn}(state, actions)
    torch.cuda.synchronize()
except RuntimeError as error:
    print("refused:", error)
    sys.exit(0)
print("accepted")
sys.exit(1)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("fn,col,value", [
    ("physics_fn", 0, "size"), ("physics_fn", 1, "-size - 1"),
    ("physics_plain", 0, "size")])
def test_physics_kernel_refuses_an_out_of_range_action_on_card(
        card, fn, col, value):
    """An action outside ``[-size, size)`` of its table is a device-side
    assert in the kernel, as in the plain version's indexing on the card.
    Each case runs in a process of its own: the assert leaves its CUDA
    context unusable."""
    tests = Path(__file__).resolve().parent
    script = _OUT_OF_RANGE.format(
        tests=str(tests), table=("acc_table", "turn_table")[col], col=col,
        value=value, fn=fn)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tests.parent), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", script], cwd=tests.parent,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "device-side assert triggered" in run.stdout, run.stdout


@pytest.mark.cuda
def test_flagship_step_launches_the_physics_kernel_once_per_step(card):
    """The flagship's env-only step, called op by op and as its captured
    program: one physics launch and one K1 launch a step, the replays
    credited."""
    system = build_flagship(num_envs=16, fc_dims=(32, 32), seed=2,
                            device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    knn_obs.reset_launch_counts()
    tag_physics.reset_launch_counts()
    state, checksum = system["state"], torch.zeros((), device=card)
    for _ in range(3):
        state, checksum = system["env_only_step"]((state, checksum), gen)
    loop = captured_loop(system, "env_only_step", gen, state=state)
    for _ in range(4):
        loop()
    torch.cuda.synchronize()
    assert loop.graph is not None and loop.replays == 3
    assert tag_physics.LAUNCH_COUNTS == {"tag_physics": 7}
    assert knn_obs.LAUNCH_COUNTS == dict(_NO_LAUNCHES, knn_obs_flat_exact=7)


@pytest.mark.cuda
def test_training_rollout_launches_the_physics_kernel_once_per_step(
        card, tmp_path):
    """One iteration of the ``tag_continuous`` run config at 8 envs: 50
    rollout steps, one replay of the rollout-step program each after the
    first, one physics launch a step."""
    cfg = load_run_config("tag_continuous")
    cfg["trainer"].update({"num_envs": 8, "train_batch_size": 400,
                           "num_episodes": 1, "seed": 1})
    for policy in ("runner", "tagger"):
        cfg["policy"][policy]["model"]["fc_dims"] = [32, 32]
    tag_physics.reset_launch_counts()
    trainer = setup_trainer_and_train(cfg, verbose=False,
                                      results_dir=str(tmp_path))
    torch.cuda.synchronize()
    assert trainer.iters_completed == 1
    assert tag_physics.LAUNCH_COUNTS == {"tag_physics": 50}


@pytest.mark.cuda
def test_program_captures_with_automatic_collection_off_on_card(card):
    """A capture runs with Python's automatic garbage collection off, and
    it is on again after: a dead program's graph, freed when its reference
    cycle is collected mid-capture, would invalidate the capture.  The
    warm-up runs with collection as it was."""
    x = torch.zeros(4, device=card)
    seen = []

    def body():
        seen.append(gc.isenabled())
        x.add_(1.0)

    program = Program(body, {"x": x}, card, name="collection probe")
    assert gc.isenabled()
    program()  # warm-up and capture
    program()  # a replay
    torch.cuda.synchronize()
    assert seen == [True, False] and gc.isenabled()
    assert float(x[0]) == 2.0


# ------------------------------------------------ the categorical draw
# the rollout's policies in the tag_continuous run config: runners (100
# envs x 100) and taggers (100 envs x 10), and the flagship's (1024 envs x
# 100 and x 5), two heads of 21 logits each, slices of one fused (..., 43)
# head output with the value
_POLICY_SHAPES = {"runner": (100, 100), "tagger": (100, 10),
                  "flagship runner": (1024, 100),
                  "flagship tagger": (1024, 5)}
_HEAD_WIDTHS = (21, 21)


def _fused_heads(lead, widths, seed, device, scale=3.0):
    """Head slices of one fused ``lead + (sum(widths) + 1,)`` output, as
    ``FullyConnected`` returns them: a row stride wider than a head."""
    gen = torch.Generator(device=device).manual_seed(seed)
    fused = scale * torch.randn(lead + (sum(widths) + 1,), generator=gen,
                                device=device)
    starts = np.cumsum((0,) + tuple(widths))
    return [fused[..., a:b] for a, b in zip(starts[:-1], starts[1:])]


def _stacked_draws(heads, generator):
    """The draw as the rollout made it before the kernel: one
    ``sample_from_logits`` a head, stacked."""
    return torch.stack([sample_from_logits(h, generator) for h in heads],
                       dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", sorted(_POLICY_SHAPES))
def test_sample_heads_matches_the_stacked_draws_on_card(card, policy):
    """At the training rollout's and the flagship's shapes (both team
    sizes), over 20 seeds: ``sample_heads`` on the card equals the stacked
    ``sample_from_logits`` from a generator seeded alike, bit for bit, in
    one launch a call, and leaves the generator where they leave theirs;
    the kernel equals ``draw_heads_plain`` on further uniforms."""
    lead = _POLICY_SHAPES[policy]
    for seed in range(20):
        heads = _fused_heads(lead, _HEAD_WIDTHS, seed, card)
        ours = torch.Generator(device=card).manual_seed(1000 + seed)
        theirs = torch.Generator(device=card).manual_seed(1000 + seed)
        launches = gumbel_sample.LAUNCH_COUNTS["gumbel_sample"]
        got = sample_heads(heads, ours)
        assert gumbel_sample.LAUNCH_COUNTS["gumbel_sample"] == launches + 1
        want = _stacked_draws(heads, theirs)
        assert got.dtype == torch.int32 and got.shape == lead + (2,)
        assert torch.equal(got, want), seed
        assert torch.equal(torch.rand(8, generator=ours, device=card),
                           torch.rand(8, generator=theirs, device=card))
        uniforms = [torch.rand(h.shape, generator=ours, device=card)
                    for h in heads]
        assert torch.equal(gumbel_sample.gumbel_sample(heads, uniforms),
                           draw_heads_plain(heads, uniforms)), seed


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(5,), (5, 3, 21, 1), (40, 70)])
def test_sample_heads_takes_any_head_widths_on_card(card, widths):
    """A Discrete head of width 5, mixed widths (one of 1) and heads wider
    than a warp: bit for bit with the stacked draws."""
    for seed in range(5):
        heads = _fused_heads((1000,), widths, seed, card)
        got = sample_heads(
            heads, torch.Generator(device=card).manual_seed(seed))
        want = _stacked_draws(
            heads, torch.Generator(device=card).manual_seed(seed))
        assert torch.equal(got, want), seed


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [(1000,), (100, 100)])
@pytest.mark.parametrize("count", [9, 16])
def test_sample_heads_takes_more_heads_than_a_launch_on_card(card, count,
                                                             lead):
    """9 and 16 heads of mixed widths, at both team sizes: one launch a
    group of ``HEADS_A_LAUNCH`` heads, each writing its columns of one
    output, bit for bit with ``draw_heads_plain`` and with the stacked
    draws."""
    widths = tuple(1 + (7 * c) % 30 for c in range(count))
    for seed in range(3):
        heads = _fused_heads(lead, widths, 100 + seed, card)
        launches = gumbel_sample.LAUNCH_COUNTS["gumbel_sample"]
        got = sample_heads(
            heads, torch.Generator(device=card).manual_seed(seed))
        assert gumbel_sample.LAUNCH_COUNTS["gumbel_sample"] == launches + 2
        want = _stacked_draws(
            heads, torch.Generator(device=card).manual_seed(seed))
        assert got.shape == lead + (count,)
        assert torch.equal(got, want), seed
        gen = torch.Generator(device=card).manual_seed(50 + seed)
        uniforms = [torch.rand(h.shape, generator=gen, device=card)
                    for h in heads]
        assert torch.equal(gumbel_sample.gumbel_sample(heads, uniforms),
                           draw_heads_plain(heads, uniforms)), seed


@pytest.mark.cuda
def test_sample_heads_never_draws_a_masked_action_on_card(card):
    """Heads masked by ``apply_logit_mask`` (contiguous: the mask makes a
    new tensor): bit for bit with the stacked draws, and no masked action
    drawn."""
    heads = _fused_heads((100, 100), _HEAD_WIDTHS, 7, card)
    gen = torch.Generator(device=card).manual_seed(8)
    masks = [(torch.rand(h.shape, generator=gen, device=card) > 0.5)
             .float() for h in heads]
    for m in masks:
        m[..., 3] = 1.0  # every row keeps an action
    masked = [apply_logit_mask(h, m) for h, m in zip(heads, masks)]
    got = sample_heads(masked, torch.Generator(device=card).manual_seed(9))
    want = _stacked_draws(masked,
                          torch.Generator(device=card).manual_seed(9))
    assert torch.equal(got, want)
    for c, m in enumerate(masks):
        kept = torch.gather(m, -1, got[..., c:c + 1].long())
        assert (kept == 1.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4096, 16384])
def test_sample_heads_breaks_ties_to_the_lowest_index_on_card(card, rows):
    """Planted ties: equal logits and equal uniforms at two to four
    indices of a row, the rest below; the lowest index of the tie wins,
    as ``torch.argmax`` picks it, at both team sizes (a warp a row at 4,096
    rows, 8 lanes at 16,384)."""
    width = 21
    rng = np.random.RandomState(12)
    logits = rng.uniform(-5.0, -4.0, (rows, width)).astype(np.float32)
    u = np.full((rows, width), 0.25, np.float32)
    lowest = np.empty(rows, np.int32)
    for r in range(rows):
        at = np.sort(rng.choice(width, rng.randint(2, 5), replace=False))
        logits[r, at] = 1.0
        u[r, at] = 0.75
        lowest[r] = at[0]
    logits, u = (torch.from_numpy(x).to(card) for x in (logits, u))
    plain = draw_heads_plain([logits], [u])
    assert plain[:, 0].tolist() == lowest.tolist()
    gumbel_sample.check_inputs([logits], [u])
    assert torch.equal(gumbel_sample.gumbel_sample([logits], [u]), plain)
    # a whole row alike: index 0
    flat = gumbel_sample.gumbel_sample(
        [torch.zeros((rows, width), device=card)],
        [torch.full((rows, width), 0.5, device=card)])
    assert (flat == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [(64, 32), (64, 256)])
def test_sample_heads_takes_a_nan_logit_as_the_largest_on_card(card, lead):
    """A NaN logit is the largest, as ``torch.argmax`` counts it on the
    card, and of two NaNs the lower index wins: bit for bit with the plain
    chain, at both team sizes (2,048 and 16,384 rows)."""
    heads = _fused_heads(lead, _HEAD_WIDTHS, 13, card)
    heads = [h.clone() for h in heads]
    heads[0][0, :, 17] = float("nan")
    heads[0][1, :, 4] = float("nan")
    heads[0][1, :, 9] = float("nan")
    heads[1][2, 5, 20] = float("nan")
    gen = torch.Generator(device=card).manual_seed(14)
    uniforms = [torch.rand(h.shape, generator=gen, device=card)
                for h in heads]
    plain = draw_heads_plain(heads, uniforms)
    assert (plain[0, :, 0] == 17).all() and (plain[1, :, 0] == 4).all()
    assert int(plain[2, 5, 1]) == 20
    assert torch.equal(gumbel_sample.gumbel_sample(heads, uniforms), plain)


@pytest.mark.cuda
def test_sample_heads_refuses_what_the_kernel_does_not_take_on_card(card):
    """float64 logits, a head on the CPU, a head with a column stride and
    heads of two row counts raise before any launch."""
    heads = _fused_heads((10, 4), _HEAD_WIDTHS, 15, card)
    launches = gumbel_sample.LAUNCH_COUNTS["gumbel_sample"]
    with pytest.raises(ValueError, match="dtype torch.float64"):
        sample_heads([h.double() for h in heads])
    with pytest.raises(ValueError, match="logits 1 lies on cpu"):
        sample_heads([heads[0], heads[1].cpu()])
    with pytest.raises(ValueError, match="column stride"):
        sample_heads([torch.zeros((40, 21, 2), device=card)[..., 0]])
    with pytest.raises(ValueError, match="logits 1: shape"):
        sample_heads([heads[0], heads[1][:5]])
    assert gumbel_sample.LAUNCH_COUNTS["gumbel_sample"] == launches


def _leaf_dict(tree) -> dict:
    return dict(_leaves(tree))


@pytest.mark.cuda
def test_captured_rollout_step_equals_its_eager_body_on_card(card, tmp_path):
    """The ``tag_continuous`` rollout at 8 envs (50 steps), replayed as
    the captured rollout-step program against its body called op by op
    (``plain_calls``) from the same seed: actions, records, env state and
    episode sums bit for bit, and the generator left alike; the capture
    counts 2 sampler launches (one a policy), credited on each replay."""
    cfg = load_run_config("tag_continuous")
    cfg["trainer"].update({"num_envs": 8, "train_batch_size": 400,
                           "num_episodes": 1, "seed": 1})
    for policy in ("runner", "tagger"):
        cfg["policy"][policy]["model"]["fc_dims"] = [32, 32]
    trainers = [setup_trainer(copy.deepcopy(cfg), verbose=False,
                              device=card, results_dir=str(tmp_path / n))
                for n in ("eager", "captured")]
    steps = trainers[0].training_batch_size_per_env
    for trainer, plain in zip(trainers, (True, False)):
        gumbel_sample.reset_launch_counts()
        with plain_calls() if plain else contextlib.nullcontext():
            trainer._rollout_programmed(0)
            trainer._rollout_programmed(0)
        torch.cuda.synchronize()
        assert gumbel_sample.LAUNCH_COUNTS == {"gumbel_sample": 4 * steps}
    eager, captured = trainers
    program = captured._programs["rollout"]
    assert program.graph is not None and program.replays == 2 * steps - 1
    assert program.launches["gumbel_sample"] == 2
    for name, tree in (("batch", lambda t: t._batch),
                       ("env", lambda t: t._env_state),
                       ("episodes", lambda t: (t._ep_acc, t._ep_sum,
                                               t._ep_count))):
        a, b = _leaf_dict(tree(eager)), _leaf_dict(tree(captured))
        assert a.keys() == b.keys(), name
        for path, value in a.items():
            assert torch.equal(value, b[path]), (name, path)
    assert torch.equal(
        torch.rand(8, generator=eager.generator, device=card),
        torch.rand(8, generator=captured.generator, device=card))


# ------------------------------------------------- the done-driven reset
_RESET_CELLS = {  # the three cells' steps: env, replicas
    "flagship": ("flagship", 1024),
    "training": ("tag_continuous", 100),
    "pendulum": ("pendulum", 10_000),
}


def _as_bytes(t):
    return t.reshape(-1).view(torch.uint8)


def _plain_reset(snapshot, pools, state, generator, force=False,
                 pool_idx=None):
    """The plain ``where`` chain on the card (``core/reset.reset_plain``),
    the pool rows given or drawn as ``auto_reset`` draws them."""
    envs = state["_done_"].shape[0]
    rows = {t: (pool_idx[t].long() if pool_idx and t in pool_idx
                else torch.randint(0, pool.shape[0], (envs,),
                                   generator=generator, device=pool.device))
            for t, pool in sorted(pools.items())}
    return reset_plain(state, snapshot, pools, rows, force)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["done", "force", "pool_idx", "none_done"])
@pytest.mark.parametrize("cell", sorted(_RESET_CELLS))
def test_reset_kernel_matches_plain_on_card(card, cell, mode):
    """At the three cells' shapes (1024 x 105, 100 x 110, 10,000 Pendulum
    envs with a pool of 10,000): the reset into the static state, one
    launch, equals the plain ``where`` chain written back by
    ``assign_state`` bit for bit (every byte of every entry), with done
    flags on every third env, ``force``, given pool rows and no env done;
    the generator's next draw is the plain path's.  The engine's reset
    (with Pendulum's observation refresh) into the static state equals
    its functional reset, one launch each."""
    env, envs = _RESET_CELLS[cell]
    engine, carried, state = stepped(env, envs, card)
    store = engine.store
    kwargs = {"force": mode == "force"}
    if mode == "none_done":
        state["_done_"] = torch.zeros_like(state["_done_"])
    if mode == "pool_idx":
        kwargs["pool_idx"] = {
            target: torch.randperm(envs, device=card) % pool.shape[0]
            for target, pool in store.pools.items()}
    ours, theirs = (torch.Generator(device=card).manual_seed(21)
                    for _ in range(2))
    static = {k: v.clone() for k, v in carried.items()}
    want = {k: v.clone() for k, v in carried.items()}
    base = make_auto_reset_fn(store.snapshot, store.pools)
    before = reset_ops.LAUNCH_COUNTS["reset_when_done"]
    got = base(state, ours, out=static, **kwargs)
    assert reset_ops.LAUNCH_COUNTS["reset_when_done"] == before + 1
    assign_state(want, _plain_reset(store.snapshot, store.pools, state,
                                    theirs, **kwargs))
    torch.cuda.synchronize()
    for name in static:
        assert got[name] is static[name]
        assert torch.equal(_as_bytes(static[name]), _as_bytes(want[name])), \
            name
    assert torch.equal(torch.rand(8, generator=ours, device=card),
                       torch.rand(8, generator=theirs, device=card))
    into, functional = ({k: v.clone() for k, v in carried.items()}
                        for _ in range(2))
    before = reset_ops.LAUNCH_COUNTS["reset_when_done"]
    engine.auto_reset(state, ours, out=into, **kwargs)
    assign_state(functional, engine.auto_reset(state, theirs, **kwargs))
    torch.cuda.synchronize()
    assert reset_ops.LAUNCH_COUNTS["reset_when_done"] == before + 2
    for name in into:
        assert torch.equal(_as_bytes(into[name]),
                           _as_bytes(functional[name])), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["aligned", "misaligned", "aliased",
                                  "pool_idx"])
@pytest.mark.parametrize("force", [False, True], ids=["done", "force"])
def test_reset_kernel_takes_any_dtype_alignment_and_alias_on_card(
        card, case, force):
    """int32, float32, bool and bfloat16 entries of odd row widths and two
    pools, in static buffers on 16-byte boundaries or one element past
    them, or a destination that is its own source (the done flags among
    them, read from a copy); given pool rows, one negative: one launch
    equals the plain reset written back, bit for bit."""
    snapshot, pools, state, out = mixed_case(
        misaligned=case == "misaligned", device=card)
    if case == "aliased":
        for name, value in state.items():
            out[name].copy_(value)
        state = dict(out)
    if case == "misaligned":
        assert out["c_bool"].data_ptr() % 2 == 1
    pool_idx = ({"p_float": torch.tensor([0, -1, 2, 3, 4, 5, 0, 1, 2, 3],
                                         device=card),
                 "q_bf16": torch.arange(10, device=card) % 6}
                if case == "pool_idx" else None)
    auto_reset = make_auto_reset_fn(snapshot, pools)
    want = {k: torch.zeros_like(v) for k, v in out.items()}
    assign_state(want, _plain_reset(
        snapshot, pools, {k: v.clone() for k, v in state.items()},
        torch.Generator(device=card).manual_seed(2), force=force,
        pool_idx=pool_idx))
    before = reset_ops.LAUNCH_COUNTS["reset_when_done"]
    got = auto_reset(state, torch.Generator(device=card).manual_seed(2),
                     force=force, pool_idx=pool_idx, out=out)
    torch.cuda.synchronize()
    assert reset_ops.LAUNCH_COUNTS["reset_when_done"] == before + 1
    for name in out:
        assert got[name] is out[name]
        assert torch.equal(_as_bytes(out[name]), _as_bytes(want[name])), name


@pytest.mark.cuda
def test_reset_kernel_refuses_what_it_does_not_take_on_card(card):
    """A non-contiguous value, with a destination or without, and a value
    on the CPU raise before any launch, and nothing falls back to the
    plain path."""
    snapshot, pools, state, out = mixed_case(device=card)
    auto_reset = make_auto_reset_fn(snapshot, pools)
    before = reset_ops.LAUNCH_COUNTS["reset_when_done"]
    wide = torch.zeros((10, 6), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="a_int is not contiguous"):
        auto_reset(dict(state, a_int=wide[:, ::2]), out=out)
    with pytest.raises(ValueError, match="a_int is not contiguous"):
        auto_reset(dict(state, a_int=wide[:, ::2]))  # no destination
    with pytest.raises(ValueError, match="b_float lies on cpu"):
        auto_reset(dict(state, b_float=state["b_float"].cpu()), out=out)
    with pytest.raises(ValueError, match="e_kept .static. lies on cpu"):
        auto_reset(state, out=dict(out, e_kept=out["e_kept"].cpu()))
    assert reset_ops.LAUNCH_COUNTS["reset_when_done"] == before


@pytest.mark.cuda
def test_flagship_step_launches_the_reset_kernel_once_per_step(card):
    """The flagship's captured env-only step resets into its carry in one
    reset launch a step, the replays credited, and its states equal the
    eager functional steps' from the same seed, bit for bit; the eager
    steps, which take no destination, launch one a step too, into fresh
    tensors."""
    system = build_flagship(num_envs=64, fc_dims=(32, 32), seed=2,
                            device=card)
    start = {k: v.clone() for k, v in system["state"].items()}
    # every episode ends (at 500 steps) within the first 30 steps
    start["_timestep_"] = 470 + torch.arange(
        64, dtype=torch.int32, device=card) % 30
    gen = torch.Generator(device=card).manual_seed(0)
    reset_ops.reset_launch_counts()
    state, checksum = dict(start), torch.zeros((), device=card)
    for _ in range(40):
        state, checksum = system["env_only_step"]((state, checksum), gen)
    torch.cuda.synchronize()
    assert reset_ops.LAUNCH_COUNTS == {"reset_when_done": 40}
    assert int(state["_timestep_"].max()) <= 40  # every env was reset
    reset_ops.reset_launch_counts()
    loop = captured_loop(system, "env_only_step",
                         torch.Generator(device=card).manual_seed(0),
                         state=start)
    for _ in range(40):
        loop()
    torch.cuda.synchronize()
    assert loop.graph is not None and loop.replays == 39
    assert loop.launches["reset_when_done"] == 1
    assert reset_ops.LAUNCH_COUNTS == {"reset_when_done": 40}
    for name, value in state.items():
        assert torch.equal(loop.buffers["state"][name], value), name
    assert torch.equal(loop.buffers["checksum"], checksum)


@pytest.mark.cuda
def test_training_rollouts_launch_the_reset_kernel_once_per_step(
        card, tmp_path):
    """One iteration of the ``tag_continuous`` run config at 8 envs (50
    rollout steps) and two of ``single_pendulum`` at 64 envs (10 steps
    each): one reset launch a rollout step, the rollout program's capture
    counting one."""
    cfg = load_run_config("tag_continuous")
    cfg["trainer"].update({"num_envs": 8, "train_batch_size": 400,
                           "num_episodes": 1, "seed": 1})
    for policy in ("runner", "tagger"):
        cfg["policy"][policy]["model"]["fc_dims"] = [32, 32]
    reset_ops.reset_launch_counts()
    trainer = setup_trainer_and_train(cfg, verbose=False,
                                      results_dir=str(tmp_path / "a2c"))
    torch.cuda.synchronize()
    assert trainer.iters_completed == 1
    assert reset_ops.LAUNCH_COUNTS == {"reset_when_done": 50}
    assert trainer._programs["rollout"].launches["reset_when_done"] == 1
    ddpg = _ddpg_trainer("single_pendulum", tmp_path)
    reset_ops.reset_launch_counts()
    ddpg._iteration(0)
    ddpg._iteration(640)
    torch.cuda.synchronize()
    assert reset_ops.LAUNCH_COUNTS == {"reset_when_done": 20}
