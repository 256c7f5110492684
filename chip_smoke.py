"""Drive the PyTorch port (``warpdrive_tpu_torch``) on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failure:

1. the card: name and power limit from ``nvidia-smi``, torch and CUDA
   versions, compute capability (must be 9.0, the kernels' ``sm_90a``);
2. build every kernel in ``warpdrive_tpu_torch/csrc/`` with ``nvcc``, one
   process per source, all started together, and find with ``cuobjdump
   -sass`` HMMA (tensor-core) instructions in both of K4's ``tile_kernel``
   functions and REDUX (the warp's min-reduction) in both functions of the
   ladders K6-K8, ``ladder_kernel``;
3. hold each kernel against its plain PyTorch version on the card: K1
   (``knn_obs_flat_exact``) on random states and on a state rolled 100
   flagship steps (0 slot mismatches and a max abs diff <= 1e-6 required);
   K2 (``knn_obs_mxu``) in both tie-break modes on random states at four
   shapes, an exact-tie lattice and a state rolled 100 steps by the training
   env; K3 (``knn_obs_flat``) on random states, a packed-bits near-tie and
   the ``pallas_flat`` flagship rolled 100 steps; K4
   (``knn_obs_flat_mxudist``) in both modes and K5 (``knn_obs_tiled``) in
   its four on random states and on the 1024-agent configuration rolled
   100 steps; K6 (``knn_obs_packed``), K7 (``knn_obs_onehot``), K8
   (``knn_obs_twolevel``, both modes) and K9 (``knn_obs_envlanes``, both
   modes) on random states, an exact-tie lattice, the packed-bits near-tie
   (7 bits for K6 and K8, 4 for K9 at N = 15) and the flagship rolled 100
   steps with each of their names, K6-K8 also with a third of the agents
   dead and K6 and K7 at k = n = 128 (K2, K3 and K5-K9: 0 mismatches and
   max abs diff 0 required); the warp scan's ordering cases for K1-K5 and K9
   in every mode (an exact-tie lattice at (8, 1024, 10) -- (8, 128, 10)
   for K2 --, k = 32 and k = 1, partial and full last rounds at N = 33 and
   64, k = 32 at N = 1024, the N = 15 packed near-tie, and K9 at (2, 8192,
   10), eight staged chunks of candidates).  From 1024 agents on K4 forms
   its distance on the tensor cores, which sum in their own order, so it
   is held to the swap class (``knn_obs.check_swap_class``: valid slots
   and dead rows equal bit for bit, a slot that picks the plain version's
   candidate equal bit for bit, one that picks another within the
   near-tie window W and no candidate twice, and under 2e-3 of the
   entries off by more than 8e-6 on the random and rolled states; each
   case prints its swaps, share and max abs diff).  Then the CUDA step
   against the same step on the CPU from the same states, for the flagship
   with ``pallas_flat_exact``, ``pallas_onehot``, ``pallas_twolevel_exact``
   and ``pallas_envlanes_exact`` and for the 1024-agent configuration with
   ``pallas_flat_exact``, ``pallas_tiled_exact``, ``pallas_envlanes_exact``
   (obs <= 1e-6) and ``pallas_flat_mxudist`` (under 2e-3 of the entries
   off by more than 8e-6: the CPU and the card centre on means summed in
   other orders); then the full-step path (no kernel): the CUDA step
   against the CPU step from the same states over 60 rolled states at 1024
   envs, TagGridWorld with full and partial observations bit for bit, and
   CartPole (with its run config's pool), MountainCar,
   ContinuousMountainCar, Acrobot and Pendulum with state and observations
   within 1e-5 and rewards and done flags equal; and a forced and a
   done-driven pool reset on the card of TagGridWorldWithResetPool and
   CartPole with a pool: every reset row a row of its pool, the reset
   envs' observations ``observe_fn`` of the reset state;
4. drive the main paths, each with the kernels' launch counts set to 0 just
   before and read just after:
   a. the flagship rollout at 1024 envs x 105 agents with ``fc_dims=(256,
      256)``: ``env_only_step`` then ``full_loop_step``; each step must
      launch K1 and the physics kernel exactly once;
   b. A2C training of the shipped ``tag_continuous`` run config at full
      width (100 envs x 110 agents, 250 steps per iteration, ``fc_dims=(256,
      256)``) for its 10 iterations, through ``setup_trainer`` and
      ``train()`` (on the card the captured programs of
      ``core/program.py``: the full ones on the first iteration and at log
      points, the hot ones elsewhere; so every training run of phase 4
      but 4r's gloo ranks; 4p's eager backend its update alone): each
      rollout step must launch K2 exactly
      once (a replay credited with its capture's launches), losses must
      be finite, parameters must move and each policy must leave a
      checkpoint; then one update on the card against the same update on
      the CPU;
   c. the 1024-agent configuration (``build_many_agents``: 256 envs x 1024
      agents) with ``pallas_flat_exact``, ``pallas_flat_mxudist``,
      ``pallas_tiled_exact`` and ``pallas_envlanes_exact``: 100
      ``env_only_step`` steps each, launching K1, K4, K5 or K9 exactly once
      per step and no other kernel; then the four loops again in the
      reverse order, so that each loop's wall is read early and late;
   d. the ``pallas_flat`` flagship ``env_only_step`` at 1024 envs x 105
      agents, 200 steps: exactly one K3 launch per step;
   e. the flagship at 1024 envs x 105 agents with ``pallas`` (K6),
      ``pallas_onehot`` (K7), ``pallas_twolevel_exact`` (K8) and
      ``pallas_envlanes_exact`` (K9): ``env_only_step`` then
      ``full_loop_step``, 200 steps each; with ``pallas_twolevel`` and
      ``pallas_envlanes``: ``env_only_step``, 200 steps; each step must
      launch its name's kernel exactly once and no other;
   f. the full-step path's env-only loops, 200 steps each after 5 warm-up
      steps (random device actions, the step, an observation checksum,
      the auto-reset): TagGridWorld at the JAX bench's 32,768 envs (4
      taggers, grid 20, episode 100, partial observations, seed 7),
      CartPole at 131,072 envs (episode 200, seed 5), and MountainCar,
      ContinuousMountainCar, Acrobot and Pendulum at 131,072 envs with
      their run configs' episodes and reset pools; none may launch a kNN
      kernel;
   g. A2C training at full width, through ``setup_trainer`` and
      ``train()``, of ``tag_gridworld`` (2000 envs x 100 steps),
      ``tag_gridworld_with_reset_pool`` (the same, pools registered),
      ``single_cartpole`` (100 x 500, a pool of 1000), ``single_acrobot``
      (1000 x 50) and ``single_mountain_car`` (1000 x 100), 3 iterations
      each, no kNN kernel launched: finite losses, moved parameters and a
      checkpoint each; then one ``tag_gridworld`` update on the card
      against the same update on the CPU;
   h. DDPG training at full width, through ``setup_trainer`` and
      ``train()``, of ``single_pendulum`` (10,000 envs x 5 steps, n_step 5:
      a 9-row replay window, a pool of 10,000) and
      ``single_continuous_mountain_car`` (1000 envs x 10 steps, a 14-row
      window), 4 iterations each, no kNN kernel launched: iteration 1 moves
      no net, target or Adam count (the window is not full), iterations 2-4
      report "Buffer full" 1.0, every metric finite, the online actor apart
      from its target, an actor and a critic checkpoint; then one update of
      each on the card against the same update on the CPU from the same
      nets and window (nets and targets within 1e-5), and the ring buffer
      on its default device, the card, against the same buffer on the CPU
      through its wraps (bit for bit);
   i. ``evaluate_episodes`` of the Pendulum trainer (no kNN launch) and of
      the ``tag_continuous`` trainer of 4b at full width (100 envs x 110
      agents, episode 500), that trainer's ``fetch_episode_states`` and
      ``fetch_logged_episode`` of ``loc_x``, ``loc_y`` and
      ``still_in_the_game`` (a contiguous log mask), each exactly one K2
      launch a step; and ``save_full_state`` after 2 Pendulum iterations, a
      fresh trainer of other seeds ``load_full_state`` and 2 more through
      ``train()``, against the 4 straight iterations of 4h (nets and
      targets within 1e-6; whether bit for bit is printed);
   j. the JAX bench's tuned flagship training stage (``bench.py:744-813``)
      at full width through ``setup_trainer`` and ``train()``: the
      flagship env with K1, 2000 envs x 100 steps, two A2C policies with a
      bf16 model and batch and 400 contiguous minibatches, 3
      iterations with exactly 100 K1 launches each and no other kernel,
      rollout and update ms and env-steps/s printed; ``profile_phases``
      (2 repeats; its updates launch no kernel); one iteration under
      ``update_recompute_obs`` with exactly 100 + 2 x 400 K1 launches; then
      at a small size on the card: minibatched updates (contiguous, and
      PPO over 2 epochs x 2 shuffled minibatches with an injected table)
      against the CPU within 1e-5, remat against none and recompute
      against store (float32 batch) bit for bit, and the bf16 model's
      outputs against the CPU's, bit for bit at the small size and each
      head within 2^-7 of its largest output at the tuned width;
   k. the shipped ``asymmetric_pursuit`` run config (2 pursuers + 3
      evaders, 100 envs x 100 steps, two A2C policies with fc (64, 64):
      separate per-policy placeholders, the evaders' Dict observations
      with an ``action_mask`` key): the CUDA step against the CPU step
      over 60 rolled states (``loc``, every observation key and the
      rewards within 1e-6, done flags equal), 3 iterations through
      ``setup_trainer`` and ``train()`` (no kNN launch, finite losses,
      moved parameters, checkpoints), the masked-action gate (over every
      rollout step, no evader action on a 0 of its mask; the count and the
      draws printed), one update of both policies on the card against the
      CPU (1e-5), ``evaluate_episodes``' per-policy sums (100, 2) and (100,
      3), and env-steps/s, rollout and update ms;
   l. the shipped ``tag_continuous`` run config with
      ``use_full_observation`` (100 envs x 250 steps, 110 agents, 764
      features, no kNN kernel): the CUDA step against the CPU step over 60
      rolled states (observations 1e-6, physics 1e-5), 3 iterations
      through ``train()`` with no kNN launch and the device's peak memory,
      one update on the card and on the CPU on the first 5 envs, each held
      to the CPU's float64 update within a hundredth of the learning rate
      (at 764 features Adam turns the card's float32 rounding into
      parameter changes above 1e-5);
   m. the chem-search envs (one atom in 2-D and 3-D modes on an 8 x 8
      synthetic landscape with the z-slab 2-6, two atoms) and DummyEnv:
      the CUDA step against the CPU step over 60 rolled states at 10,000
      envs (positions exact, observations and rewards within 1e-6);
   n. serving: the flagship (1024 envs x 105 agents, fc (256, 256), K1)
      exports its runner and tagger policies to bundles through a
      ``TrainerA2C`` holding the preset's parameters, ``load_policy`` reads
      each back on the card, and for 20 rolled states both bundles'
      ``act(argmax=True)`` answer the K1 observation batch (102,400 runner
      and 5,120 tagger requests a step) with the preset's own argmax bit for
      bit, one K1 launch a step to serve and one to roll; stochastic
      ``act`` draws in range and, on one state repeated 20,000 times, each
      head's frequencies within 5 sigma of its softmax; the DDPG actor of
      ``single_pendulum`` (4h) serves the trainer's noise-free actions bit
      for bit; ms per request batch by CUDA events;
   o. the repo's JAX checkpoints (flax msgpack, read by the port's codec)
      of ``artifacts/cartpole_a2c_cpu``, ``pendulum_ddpg_cpu`` and
      ``tag_continuous_cpu`` (TagContinuous through K2,
      ``pallas_mxu_exact``), each trainer built from the artifact's
      ``run_config.json`` on the card and on the CPU: loaded tensors equal,
      ``evaluate_episodes`` on both (mean returns and steps printed), and on
      the CPU episode's states (observed on the card through K2) the card's
      argmax equal to the CPU's except at near-ties (the CPU's top two
      logits within 1e-5, counted), DDPG's actions within 1e-5; K2 launches
      one a step and one for the states;
   p. the eager host-env backend: ``single_cartpole`` (100 envs x 500
      steps) with ``trainer.env_backend: cpp``, the C++ stepper on the host
      and the policy on the card, 2 iterations through ``train()`` (finite
      losses, moved parameters, a checkpoint, no kNN launch); the C++ step
      against the Python loop over 50 rolled states (1e-5, done flags
      equal); env-steps/s and the device's idle share;
   q. the auto-scaler's probe, after ``torch.cuda.empty_cache()``: the
      full-observation ``tag_continuous`` config of 4l in a fresh
      subprocess fits at 100 envs and fails with ``OutOfMemoryError`` at
      2,000 (168 GB of observations); then the parent allocates 1 GiB and
      launches K1;
   r. multi-device training of the shipped ``tag_continuous`` run config
      at full width (100 envs x 110 agents, K2), 2 iterations each: a
      one-rank NCCL group through the distributed path, its parameters
      equal to the plain trainer's bit for bit (its NCCL version and
      all-reduces an iteration printed); two gloo ranks sharing the card,
      50 envs each, whose rollouts replaying the one-process actions are
      exactly their rows of it, whose update from the same start is
      within 1e-5 of the one-process update, and whose ``train()`` leaves
      the parameters equal on both and the files written once by the
      lead; a dp1 x tp2 pair within 1e-5 of the unsharded iteration; and
      ``dryrun_multichip(4)`` on the card (a 2 x 2 mesh of gloo ranks,
      K1); ms per iteration of one process, the one-rank group and the
      two ranks (gloo's share of the update), beside the card;
   s. the compiled iteration: captured programs (``core/program.py``)
      against the eager steps and iterations they replace, from identical
      carries and generator states, bit for bit (states, parameters, Adam
      moments and counts, episodic sums, batches, generators): the
      flagship ``env_only_step`` and ``full_loop_step`` (1024 envs, K1)
      and the 1024-agent ``env_only_step`` (256 envs, K1), 100 steps, then
      3 turns of 100 (eager, captured), compared again; the shipped
      ``tag_continuous`` run config uncut (K2), 5 iterations (the first
      programmed one full, the rest hot, the full metrics equal to the
      eager ones), the last 3 in turns; the tuned flagship stage (2000 x
      100, mb400, bf16, K1), 2 iterations in turns, and 1 under
      ``update_recompute_obs``; ``profile_trace`` and ``graceful_close``;
      the five configurations of ``tests/test_torch_program.py`` at its
      small sizes (PPO over shuffled minibatches with remat and bf16, a
      reset pool, Dict observations and masks), 3 iterations each.  Each
      step or iteration launches its kernel exactly as the eager one does
      (a replay's launches credited from its capture), and the profiler's
      count of kNN kernels equals the credited count over 10 replays of
      each loop step and of each rollout step and 5 update passes under
      recompute.  Prints ms per step or iteration in turns, rollout and update
      ms, the device's idle share of each side, the kernel nodes of each
      captured graph and each side's peak memory growth;
   t. the rest of the compiled execution model, each program against its
      eager counterpart from identical carries and generator states, bit
      for bit: (a) DDPG training of ``single_pendulum`` (10,000 x 5) and
      ``single_continuous_mountain_car`` (1000 x 10) at full width, 4
      iterations across the warm-up gate (the noise-draw, rollout-step,
      replay-append and update programs; nets, targets, Adam moments and
      counts, window, OU state, env state, generator), ms an iteration and
      the idle share of each side; (b) ``evaluate_episodes``,
      ``fetch_episode_states`` and ``fetch_logged_episode`` of 4b's
      ``tag_continuous`` trainer (K2, uncut) and the first two of the
      Pendulum trainer, each programmed call against the same call with
      every program's body called op by op (``plain_calls``), outputs and
      generators bit for bit, ms a step, and the K2 launches credited to
      10 replays of the evaluation step equal to the profiler's count; (c)
      the flagship (1024 envs, K1) through the engine facade, 2 x 100
      ``step_all_envs`` with ``reset_only_done_envs`` then
      ``reset_all_envs``, replayed programs against their bodies called op
      by op, ms a step and the credited K1 launches against the
      profiler's; (d) 4p's
      ``single_cartpole`` on the eager backend (C++ stepper): the update
      programs against the eager update, 2 iterations, and the update's
      idle share; (e) a one-rank NCCL group on ``tag_continuous`` (K2): its
      programs (collectives captured) and its eager iteration against the
      plain programmed trainer, 2 iterations; 4r's gloo ranks log that
      they run eagerly; (f, right after 4l) 4l's full-observation update
      with float64 parameters on the card against the same on the CPU,
      bisected (heads, loss, gradients, parameters; ``ClippedAdam`` alone on
      the CPU's gradients within 1e-9);
5. at the main paths' shapes -- (1024, 105, 10) for K1, K3, K6, K7, K8 in
   both modes, K9 in both, K2 and K4, (100, 110, 10) for K2, (256, 1024,
   10) for K1, K4 in both modes, K5 in its four and K9 exact, and the
   tuned stage's (2000, 105, 10) and (500, 105, 10) for K1 -- hold each
   kernel against its plain version once more (0 mismatches and max abs
   diff 0, or K4's swap class), and time both beside the kernel's bound:
   the kernel back to back (21 x 50 calls) and by its own device time (the
   profiler over 50 calls), and the launch floor (a one-element add);
   and the TagContinuous physics kernel (``csrc/tag_physics.cu``) at the
   flagship's (1024, 105, T = 5) and the training config's (100, 110,
   T = 10) rolled states: against ``physics_plain`` bit for bit (every
   field, the sign of a zero included), and timed the same way beside
   its byte bound and the plain version.

The last three lines are the card (``nvidia-smi``'s name and power limit),
one JSON object with a record per kernel, and the result line
``{"ok": true, "device": {...}}``.  ``--profile`` adds a ``torch.profiler``
table of device time by kernel for 10 steps of every loop of phase 4 and
for one iteration of each training run (DDPG's too; the tuned stage's
rollout and update apart), each with its device ms per step
beside its wall ms per step and the device's idle share.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM data-sheet peaks (dense): HBM bytes/s, float32 FLOP/s outside
# the tensor cores and bf16 FLOP/s on the tensor cores
_PEAK_BYTES_PER_S = 3.35e12
_PEAK_F32_FLOPS = 67e12
_PEAK_BF16_FLOPS = 989e12
# the device functions of the port's kNN kernels (csrc/*.cu), by which the
# profiler's events are told from PyTorch's own
_KERNEL_SYMBOLS = ("scan_kernel", "tile_kernel", "ladder_kernel",
                   "envlanes_kernel")
# the device function of the TagContinuous physics kernel
_PHYSICS_SYMBOL = "tag_physics_kernel"
# the physics kernel's launches on each main path of phases 4a-4l, each
# path's own count checked against its steps (``_physics_path``); the
# kernel's record in the kernels line sums them
_PHYSICS_PATHS: dict = {}

DEVICE = "cuda"
NUM_ENVS = 1024
FC_DIMS = (256, 256)
MAIN_PATH_STEPS = 200
ROLLED_STEPS = 100
MAX_ABS_TOL = 1e-6
# K2 and its plain version make the same float32 operations: bit for bit
K2_MAX_ABS_TOL = 0.0
K2_SHAPES = ((100, 110, 10), (1024, 105, 10), (8, 128, 16), (6, 15, 4))
# K3 and K5 make the same float32 operations as their plain versions; K4
# sums its MXU distance on the tensor cores from 1024 agents on and is held
# to the swap class (warpdrive_tpu_torch/ops/knn_obs.py:check_swap_class);
# (4, 1057, 32) and (4, 1300, 1) give its tile a third chunk of 33 and of
# 276 candidates, and (4, 1023, 10) is the largest N of its scalar form
EXACT_TOL = 0.0
K4_SHAPES = ((8, 1024, 10), (1024, 105, 10), (6, 15, 4), (4, 1057, 32),
             (4, 1300, 1), (4, 1023, 10))
K5_SHAPES = ((8, 1024, 10), (3, 300, 10), (3, 200, 6), (8, 128, 16))
MANY_AGENT_ENVS = 256
MANY_AGENT_STEPS = 100
# the 1024-agent loops, each with the kernel its steps launch
MANY_AGENT_LOOPS = (("pallas_flat_exact", "knn_obs_flat_exact"),
                    ("pallas_flat_mxudist", "knn_obs_flat_mxudist"),
                    ("pallas_tiled_exact", "knn_obs_tiled"),
                    ("pallas_envlanes_exact", "knn_obs_envlanes"))
# the flagship loops of K6-K9: the name, the kernel its steps launch, and
# whether full_loop_step is driven beside env_only_step
FLAGSHIP_KNN_LOOPS = (("pallas", "knn_obs_packed", True),
                      ("pallas_onehot", "knn_obs_onehot", True),
                      ("pallas_twolevel_exact", "knn_obs_twolevel", True),
                      ("pallas_envlanes_exact", "knn_obs_envlanes", True),
                      ("pallas_twolevel", "knn_obs_twolevel", False),
                      ("pallas_envlanes", "knn_obs_envlanes", False))
# K6-K8 take one 128-agent tile; K9 any N and E (130: an env tail)
LADDER_SHAPES = ((NUM_ENVS, 105, 10), (100, 110, 10), (8, 128, 16),
                 (6, 15, 4))
# K6 and K7 take k up to n: each warp's winner table at its largest
LADDER_FULL_K = (8, 128, 128)
# the ladders on states with a third of the agents dead
LADDER_DEAD_SHAPES = ((NUM_ENVS, 105, 10), (8, 128, 16))
ENVLANES_SHAPES = ((NUM_ENVS, 105, 10), (130, 15, 4), (3, 200, 6),
                   (8, 1024, 10))
PLAIN_MAX_ENVS_AT_1024 = 8  # plain compares at N = 1024 stay small
# the warp scan's ordering cases (csrc/knn_common.cuh: WarpList, the k-list
# one entry a lane): (state, E, N, k) -- an exact-tie lattice, a full warp
# of list and k = 1, a partial (N = 33) and a full (N = 64) last round of
# 32 candidates
WARP_SCAN_CASES = (("lattice", 8, 1024, 10), ("random", 4, 33, 32),
                   ("random", 4, 64, 32), ("random", 4, 33, 1),
                   ("random", 4, 64, 1), ("random", 2, 1024, 32))
WARP_SCAN_VARIANTS = (
    ("knn_obs_flat_exact", ("flat_exact",)),
    ("knn_obs_mxu", ("mxu", "mxu_exact")),
    ("knn_obs_flat", ("flat",)),
    ("knn_obs_flat_mxudist", ("flat_mxudist", "flat_mxudist_exact")),
    ("knn_obs_tiled", ("tiled", "tiled_exact", "tiled_mxudist",
                       "tiled_mxudist_exact")),
    ("knn_obs_envlanes", ("envlanes", "envlanes_exact")),
)
K5_K_LIMIT = 16
# K2's single tile (N <= 128, k <= 16), and its exact-tie lattice
K2_AGENT_LIMIT = 128
K2_K_LIMIT = 16
K2_LATTICE = (8, 128, 10)
# K9 at an N whose env would not fit a block whole: 8 chunks of 1024
ENVLANES_LARGE = (2, 8192, 10)
# the card's update against the CPU's on the same batch slice and state:
# float32 GEMMs and reductions sum in other orders on the two devices
# (relative gradient differences of about 1e-6), and Adam's normalized step
# turns those into parameter differences far below the learning rate
UPDATE_PARAM_TOL = 1e-5
UPDATE_ENVS = 25  # envs of the last training batch in that comparison
# the full-step path (TagGridWorld and the classic-control envs; no kNN
# kernel): the CUDA step vs the CPU step over this many rolled states, at
# this many envs; classic-control state and observations within 1e-5 (CUDA
# sin/cos and the division by a host scalar through its reciprocal move
# last bits), TagGridWorld bit for bit
FULL_STEP_STATES = 60
FULL_STEP_CHECK_ENVS = 1024
CLASSIC_STEP_TOL = 1e-5
# the env-only loops: (label, registered env, envs, seed, the env's
# settings or the run config whose env section gives them); TagGridWorld at
# the JAX bench's geometry (bench.py:448-459), CartPole at its
# cartpole_100k count (bench.py:518-520), the other four envs at that count
# with their run configs' episodes and reset pools
ENV_LOOP_STEPS = 200
ENV_LOOPS = (
    ("TagGridWorld", "TagGridWorld", 32768, 7,
     dict(num_taggers=4, grid_length=20, episode_length=100,
          use_full_observation=False)),
    ("CartPole", "ClassicControlCartPoleEnv", 131072, 5,
     dict(episode_length=200)),
    ("MountainCar", "ClassicControlMountainCarEnv", 131072, 5,
     "single_mountain_car"),
    ("ContinuousMountainCar", "ClassicControlContinuousMountainCarEnv",
     131072, 5, "single_continuous_mountain_car"),
    ("Acrobot", "ClassicControlAcrobotEnv", 131072, 5, "single_acrobot"),
    ("Pendulum", "ClassicControlPendulumEnv", 131072, 5, "single_pendulum"),
)
# A2C training of the full-step path's run configs at full width, this
# many iterations each
FULL_STEP_TRAINING = ("tag_gridworld", "tag_gridworld_with_reset_pool",
                      "single_cartpole", "single_acrobot",
                      "single_mountain_car")
FULL_STEP_TRAIN_ITERS = 3
# DDPG training of its run configs at full width, this many iterations each
DDPG_TRAINING = ("single_pendulum", "single_continuous_mountain_car")
DDPG_TRAIN_ITERS = 4
# a resumed run against a straight one: the same eager program on the same
# inputs, so 1e-6 is far above any difference it could have
RESUME_PARAM_TOL = 1e-6
# the JAX bench's tuned flagship training stage (bench.py:744-813): 2000
# envs x 100 steps, two A2C policies with 400 contiguous env-axis
# minibatches of 5 envs (each forwarded env-major), a bf16 model
# and batch, K1; this many iterations, then profile_phases with this many
# repeats, then one iteration under update_recompute_obs
TUNED_ENVS = 2000
TUNED_STEPS = 100
TUNED_MINIBATCHES = 400
TUNED_ITERS = 3
TUNED_PROFILE_REPEATS = 2
# the update options' card checks: tests/test_torch_update_options.py's
# small TagContinuous (2 taggers + 8 runners, k = 4, 8 envs x 10 steps, fc
# (16, 16)) on K1; card against CPU within UPDATE_PARAM_TOL, a bf16 model's
# outputs bit for bit at that size and, at the tuned width, within the CPU
# tests' bf16 bound (each head within 2^-7 of that head's largest
# magnitude, normwise: tests/test_torch_update_options.py says why), and
# remat and recompute against their controls on the card bit for bit
OPTIONS_CHECK_ENVS = 8
OPTIONS_CHECK_STEPS = 10
BF16_NORMWISE = 2.0 ** -7
# the heterogeneous spaces and the full observation: the shipped
# asymmetric_pursuit run config (2 pursuers + 3 evaders, 100 envs x 100
# steps, fc (64, 64)) and tag_continuous with use_full_observation (100
# envs x 250 steps, 110 agents, 764 features), this many iterations each;
# the CUDA step against the CPU step within NEW_STEP_TOL (positions,
# observations, rewards), the physics within 1e-5
NEW_TRAIN_ITERS = 3
NEW_STEP_TOL = 1e-6
# the full observation's update on the CPU: the first envs of the batch,
# 250 steps x 100 runners x 764 features each
FULL_OBS_UPDATE_ENVS = 5
# the chem-search envs and DummyEnv: the CUDA step against the CPU step at
# this many envs, on the JAX tests' configs (tests/test_chem_search.py)
CHEM_ENVS = 10_000
# serving the flagship's bundles: this many rolled states, and this many
# draws on one state for each head's frequencies against its softmax
SERVING_STEPS = 20
SERVING_DRAWS = 20_000
# the repo's JAX checkpoints read on the card; a categorical action may
# differ from the CPU's only where the CPU's top two logits lie this close
JAX_ARTIFACTS = ("cartpole_a2c_cpu", "pendulum_ddpg_cpu",
                 "tag_continuous_cpu")
NEAR_TIE = 1e-5
# the eager backend's C++ step against its Python loop over this many states
EAGER_STATES = 50
# the auto-scaler's probes of the full-observation config: one that fits
# and one that must run out of memory
PROBE_ENVS = (100, 2000)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _check_sass(library, symbol, opcode, functions=2):
    """``cuobjdump -sass`` of the built ``lib<library>`` must show
    ``opcode`` in each of the ``functions`` device functions whose name
    holds ``symbol``; prints each function's count and its first such
    line.  K4's tensor-core tile: HMMA in both ``tile_kernel`` functions of
    ``knn_obs``; the ladders K6-K8: REDUX (the warp's hardware
    min-reduction) in both ``ladder_kernel`` functions of
    ``knn_obs_ladder``."""
    from warpdrive_tpu_torch.ops import cuda_build

    cuobjdump = Path(cuda_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(cuda_build.library_path(library))],
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    found, function = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            function = line.split("Function :")[1].strip()
        elif function and symbol in function and opcode in line:
            found.setdefault(function, []).append(line.strip())
    assert len(found) == functions, \
        f"{opcode} in {symbol} functions: {sorted(found)}"
    for function, lines in sorted(found.items()):
        print(f"SASS {function}: {len(lines)} {opcode}, first: {lines[0]}")


def _cuda_ms(fn, repeats: int, inner: int) -> float:
    """Median over ``repeats`` of the mean device time of ``inner`` calls."""
    import torch

    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def _random_knn_inputs(E, N, k, seed, device):
    """Random kNN inputs with about 20% dead agents, via the env's own
    feature build."""
    import numpy as np
    import torch

    from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous

    n_taggers = max(2, N // 20)
    env = TorchTagContinuous(
        num_taggers=n_taggers, num_runners=N - n_taggers, grid_length=20.0,
        episode_length=500, use_full_observation=False,
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
        "_timestep_": rng.randint(0, 500, (E,)).astype(np.int32),
    }
    state = {name: torch.from_numpy(v).to(device) for name, v in state.items()}
    return _knn_args(env, state)


def _knn_args(env, state):
    feats, still_f, t_norm = env._knn_inputs(state)
    return (
        (state["loc_x"].contiguous(), state["loc_y"].contiguous(), feats,
         env._consts(feats.device)["types_f"], still_f, t_norm),
        env.num_agents,
        env.num_other_agents_observed,
    )


# K4's swap class over the cases where its share is bounded: the largest
# share, and the largest gap of a swap as a share of W over every case
_K4_SWAP = {"share": 0.0, "worst_gap_of_W": 0.0}


def _compare_knn(label, args, n_agents, k, variant="flat_exact",
                 tol=MAX_ABS_TOL, bound_share=True):
    """Kernel vs plain on the same inputs.  Every kernel but K4: 0 slot
    mismatches and a max abs diff <= ``tol``.  K4 (the ``flat_mxudist``
    variants): the swap class of ``knn_obs.check_swap_class``, its share
    bounded where ``bound_share``.  Returns the max abs diff over every
    entry (for K4 a swapped slot's entries included)."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs

    out = knn_obs.knn_observation(*args, n_agents=n_agents, k=k,
                                  variant=variant)
    plain = knn_obs.knn_observation_plain(*args, n_agents=n_agents, k=k,
                                          variant=variant)
    torch.cuda.synchronize()
    E, N = args[0].shape
    finite = bool(torch.isfinite(out).all())
    assert finite, f"{label}: non-finite kernel output"
    if variant.startswith("flat_mxudist"):
        report = knn_obs.check_swap_class(out, plain, args, k, variant,
                                          bound_share=bound_share)
        print(f"kernel vs plain [{variant}, {label}] E={E} N={N} k={k}: "
              f"swap class held; {report['swaps']} of {report['slots']} "
              f"valid slots pick another candidate (largest gap "
              f"{report['worst_ratio']:.3g} of W), swap share "
              f"{report['share']:.3g} ("
              f"{'bounded' if bound_share else 'ties by construction, not bounded'}"
              f"), max abs diff {report['max_abs']:.3g}, finite {finite}")
        if bound_share:
            _K4_SWAP["share"] = max(_K4_SWAP["share"], report["share"])
        _K4_SWAP["worst_gap_of_W"] = max(_K4_SWAP["worst_gap_of_W"],
                                         report["worst_ratio"])
        return report["max_abs"]
    slots = out[..., :-1].reshape(E, N, k, 8)
    ref = plain[..., :-1].reshape(E, N, k, 8)
    mismatches = int((slots != ref).any(dim=-1).sum()) + int(
        (out[..., -1] != plain[..., -1]).sum()
    )
    max_abs = float((out - plain).abs().max())
    print(f"kernel vs plain [{variant}, {label}] E={E} N={N} k={k}: "
          f"slot mismatches {mismatches} of {E * N * k}, max abs diff "
          f"{max_abs:.3g}, finite {finite}")
    assert mismatches == 0, f"{label}: {mismatches} slot mismatches"
    assert max_abs <= tol, f"{label}: max abs diff {max_abs}"
    return max_abs


def _lattice_knn_inputs(E, N, k, seed, device):
    """Random inputs with the agents moved onto an integer lattice, so exact
    distance ties are everywhere."""
    import numpy as np
    import torch

    args, n, kk = _random_knn_inputs(E, N, k, seed, device)
    rng = np.random.RandomState(seed)
    side = int(np.ceil(np.sqrt(N)))
    cells = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                     -1).reshape(-1, 2)
    xy = np.stack([cells[rng.permutation(len(cells))[:N]] for _ in range(E)])
    loc_x = torch.from_numpy(xy[..., 0].astype(np.float32) * 1.5).to(device)
    loc_y = torch.from_numpy(xy[..., 1].astype(np.float32) * 1.5).to(device)
    return (loc_x, loc_y) + tuple(args[2:]), n, kk


def _dead_third_inputs(E, N, k, seed, device):
    """Random inputs with about a third of the agents dead, drawn anew."""
    import numpy as np
    import torch

    args, n, kk = _random_knn_inputs(E, N, k, seed, device)
    rng = np.random.RandomState(seed + 1)
    still_f = torch.from_numpy(
        (rng.uniform(size=(E, N)) >= 1 / 3).astype(np.float32)).to(device)
    return args[:4] + (still_f,) + args[5:], n, kk


def _training_env_state(run_config, steps, seed):
    """The training env at the config's width, rolled ``steps`` steps with
    random actions on the card."""
    import torch

    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous

    env = TorchTagContinuous(**run_config["env"])
    engine = EnvEngine(env_obj=env, num_envs=run_config["trainer"]["num_envs"],
                       seed=seed, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    state = {k: v for k, v in engine.state.items()
             if k not in ("observations", "sampled_actions")}
    shape = (engine.n_envs, engine.n_agents)
    for _ in range(steps):
        actions = torch.stack(
            [torch.randint(0, int(n), shape, generator=gen, device=DEVICE)
             for n in env.action_space[0].nvec], dim=-1)
        state = engine.auto_reset(engine.step_physics(state, actions), gen)
    return env, state


def _check_k2(run_config):
    """K2 vs plain, both modes: random states at four shapes, an exact-tie
    lattice and a state rolled 100 steps by the training env.  Returns the
    largest abs diff and the rolled state's inputs."""
    max_abs = 0.0
    cases = []
    for E, N, k in K2_SHAPES:
        cases.append(("random",) + _random_knn_inputs(E, N, k, seed=N + k,
                                                       device=DEVICE))
    for E, N, k in ((100, 110, 10), (8, 128, 16)):
        cases.append(("lattice",) + _lattice_knn_inputs(E, N, k, seed=k,
                                                         device=DEVICE))
    env, state = _training_env_state(run_config, ROLLED_STEPS, seed=1)
    rolled = _knn_args(env, state)
    cases.append((f"training env rolled {ROLLED_STEPS} steps",) + rolled)
    for label, args, n, k in cases:
        for variant in ("mxu_exact", "mxu"):
            max_abs = max(max_abs, _compare_knn(label, args, n, k, variant,
                                                tol=K2_MAX_ABS_TOL))
    return max_abs, rolled


def _check_step_against_cpu(gpu, cpu, label, steps=60, swap_class=False):
    """One-step parity of the CUDA step (kernel observation) with the CPU
    step (plain observation) from the same states, along a CUDA rollout of
    ``steps`` steps with numpy-drawn actions; ``gpu`` and ``cpu`` are one
    system built on each device.  Observations agree to 1e-6, or with
    ``swap_class`` in all but a share below 2e-3 of their entries (the
    MXU-distance class between devices, ``tests/test_knn_obs_kernel.py``)."""
    import numpy as np
    import torch

    from warpdrive_tpu_torch.ops.knn_obs import SWAP_ATOL, SWAP_SHARE

    eg, ec = gpu["engine"], cpu["engine"]
    E = eg.n_envs
    nvec = gpu["env"].action_space[0].nvec
    rng = np.random.RandomState(5)
    state = gpu["state"]
    worst = {"obs": 0.0, "physics": 0.0, "obs swap share": 0.0}
    for t in range(steps):
        host = {k: v.cpu() for k, v in state.items()}
        obs_g, obs_c = eg.observe(state).cpu(), ec.observe(host)
        worst["obs"] = max(worst["obs"], float((obs_g - obs_c).abs().max()))
        off = ~torch.isclose(obs_g, obs_c, rtol=1e-5, atol=SWAP_ATOL)
        worst["obs swap share"] = max(worst["obs swap share"],
                                      float(off.float().mean()))
        actions = np.stack(
            [rng.randint(0, n, (E, eg.n_agents)) for n in nvec], -1
        ).astype(np.int32)
        nxt_g = eg.step_physics(state, torch.from_numpy(actions).to(DEVICE))
        nxt_c = ec.step_physics(host, torch.from_numpy(actions))
        for name, value in nxt_c.items():
            got = nxt_g[name].cpu()
            if value.dtype == torch.float32:
                worst["physics"] = max(worst["physics"],
                                       float((got - value).abs().max()))
            else:
                assert torch.equal(got, value), f"{name} differs at t={t}"
        state = eg.auto_reset(nxt_g)
    print(f"CUDA step vs CPU step [{label}], {steps} states: max abs diff "
          f"obs {worst['obs']:.3g} (largest share of entries off by more "
          f"than {SWAP_ATOL}: {worst['obs swap share']:.3g}), physics "
          f"{worst['physics']:.3g}")
    if swap_class:
        assert worst["obs swap share"] < SWAP_SHARE, worst
    else:
        assert worst["obs"] <= MAX_ABS_TOL, worst
    assert worst["physics"] <= 1e-5, worst  # CUDA vs CPU cos/sin/sqrt ulps


def _near_tie_inputs(device):
    """One env of 15 agents where agent 1 lies a few ulps farther from
    observer 0 than agent 2, inside the 7-bit packed tie window and outside
    the 4-bit one that the v9 kernel packs at N = 15."""
    import numpy as np
    import torch

    f32 = np.float32
    x0 = f32(10.0)
    for a in np.arange(1.30, 1.40, 0.001, dtype=np.float32):
        xa, xb = f32(x0 + a), f32(x0 + a)
        found = False
        for _ in range(3):
            xb = np.nextafter(xb, f32(0))
            ka, kb = np.array([(xa - x0) * (xa - x0), (xb - x0) * (xb - x0)],
                              np.float32).view(np.int32)
            if kb < ka and ka & ~127 == kb & ~127 and ka & ~15 != kb & ~15:
                found = True
                break
        if found:
            break
    assert found, "no near-tie found"
    args, n, k = _random_knn_inputs(1, 15, 2, seed=4, device=device)
    loc_x = args[0].clone()
    loc_y = args[1].clone()
    loc_x[0, :3] = torch.tensor([x0, xa, xb])
    loc_y[0, :3] = 10.0
    loc_x[0, 3:] = torch.linspace(1.0, 19.0, 12)  # far from the three
    loc_y[0, 3:] = 2.0
    still_f = torch.ones_like(args[4])
    return (loc_x, loc_y, args[2], args[3], still_f, args[5]), n, k


def _check_k3():
    """K3 vs plain: random states, the N = 15 near-tie, and the
    ``pallas_flat`` flagship rolled 100 steps.  Returns the largest abs
    diff and the flagship system with its rolled state's inputs."""
    import torch

    from warpdrive_tpu_torch.presets import build_flagship

    max_abs = 0.0
    for E, N, k in ((NUM_ENVS, 105, 10), (6, 15, 4)):
        args, n, kk = _random_knn_inputs(E, N, k, seed=N + 3, device=DEVICE)
        max_abs = max(max_abs, _compare_knn("random", args, n, kk, "flat",
                                            tol=EXACT_TOL))
    args, n, k = _near_tie_inputs(DEVICE)
    max_abs = max(max_abs, _compare_knn("packed-bits near-tie", args, n, k,
                                        "flat", tol=EXACT_TOL))
    from warpdrive_tpu_torch.ops import knn_obs

    out = knn_obs.knn_observation(*args, n_agents=n, k=k, variant="flat")
    # 4 index bits at N = 15 keep the nearer agent 2 first
    assert float(out[0, 0, 0]) == float(args[2][0, 0, 2] - args[2][0, 0, 0])
    system = build_flagship(num_envs=NUM_ENVS, fc_dims=FC_DIMS, seed=0,
                            knn_algorithm="pallas_flat", device=DEVICE)
    generator = torch.Generator(device=DEVICE).manual_seed(1)
    state, checksum = system["state"], torch.zeros((), device=DEVICE)
    for _ in range(ROLLED_STEPS):
        state, checksum = system["env_only_step"]((state, checksum),
                                                  generator)
    system["state"] = state
    rolled = _knn_args(system["env"], state)
    max_abs = max(max_abs, _compare_knn(
        f"pallas_flat flagship rolled {ROLLED_STEPS} steps", *rolled, "flat",
        tol=EXACT_TOL))
    return max_abs, system, generator, rolled


def _rolled_many_agents(num_envs, algo, steps, seed):
    """The 1024-agent configuration on the card rolled ``steps`` steps."""
    import torch

    from warpdrive_tpu_torch.presets import build_many_agents

    system = build_many_agents(num_envs=num_envs, seed=seed,
                               knn_algorithm=algo, device=DEVICE)
    generator = torch.Generator(device=DEVICE).manual_seed(seed)
    state, checksum = system["state"], torch.zeros((), device=DEVICE)
    for _ in range(steps):
        state, checksum = system["env_only_step"]((state, checksum),
                                                  generator)
    return system["env"], state


def _check_k4_k5():
    """K4 in both modes and K5 in its four vs plain: random states, and the
    1024-agent configuration rolled 100 steps at 8 envs.  Returns each
    kernel's largest abs diff."""
    env, state = _rolled_many_agents(PLAIN_MAX_ENVS_AT_1024,
                                     "pallas_flat_mxudist", ROLLED_STEPS,
                                     seed=3)
    rolled = _knn_args(env, state)
    label = f"1024 agents rolled {ROLLED_STEPS} steps"
    max_abs = {"knn_obs_flat_mxudist": 0.0, "knn_obs_tiled": 0.0}
    for name, shapes, variants in (
        ("knn_obs_flat_mxudist", K4_SHAPES,
         ("flat_mxudist", "flat_mxudist_exact")),
        ("knn_obs_tiled", K5_SHAPES,
         ("tiled", "tiled_exact", "tiled_mxudist", "tiled_mxudist_exact")),
    ):
        cases = [("random",) + _random_knn_inputs(E, N, k, seed=N + k + 5,
                                                  device=DEVICE)
                 for E, N, k in shapes]
        cases.append((label,) + rolled)
        for case, args, n, k in cases:
            for variant in variants:
                max_abs[name] = max(max_abs[name], _compare_knn(
                    case, args, n, k, variant, tol=EXACT_TOL))
    return max_abs


def _check_k6_k9():
    """K6-K9 vs plain in every mode: random states at each kernel's shapes,
    an exact-tie lattice, the N = 15 packed near-tie (where the 7-bit
    orders of K6 and K8 take agent 1, K9's 4-bit and the exact orders the
    nearer agent 2), for K6-K8 states with a third of the agents dead
    (``LADDER_DEAD_SHAPES``), for K6 and K7 k = n = 128 on a random state
    and a lattice (``LADDER_FULL_K``), and the flagship rolled 100 steps
    with each name of ``FLAGSHIP_KNN_LOOPS``.  Returns each kernel's largest abs diff and, by
    name, the rolled flagship system, its generator and its rolled
    inputs."""
    import torch

    from warpdrive_tpu_torch.envs.tag_continuous import _KNN_VARIANTS
    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.presets import build_flagship

    max_abs, rolled = {}, {}
    near, n15, k15 = _near_tie_inputs(DEVICE)
    for algo, kernel, _ in FLAGSHIP_KNN_LOOPS:
        variant = _KNN_VARIANTS[algo]
        shapes = (ENVLANES_SHAPES if kernel == "knn_obs_envlanes"
                  else LADDER_SHAPES)
        cases = [("random",) + _random_knn_inputs(E, N, k, seed=N + k + 7,
                                                  device=DEVICE)
                 for E, N, k in shapes]
        cases += [("lattice",) + _lattice_knn_inputs(E, N, k, seed=k + 9,
                                                     device=DEVICE)
                  for E, N, k in shapes[:2]]
        cases.append(("packed-bits near-tie", near, n15, k15))
        if kernel != "knn_obs_envlanes":
            cases += [("a third dead",) + _dead_third_inputs(
                E, N, k, seed=N + 5, device=DEVICE)
                for E, N, k in LADDER_DEAD_SHAPES]
        if kernel in ("knn_obs_packed", "knn_obs_onehot"):
            cases.append(("random, k = n",) + _random_knn_inputs(
                *LADDER_FULL_K, seed=3, device=DEVICE))
            cases.append(("lattice, k = n",) + _lattice_knn_inputs(
                *LADDER_FULL_K, seed=4, device=DEVICE))
        system = build_flagship(num_envs=NUM_ENVS, fc_dims=FC_DIMS, seed=0,
                                knn_algorithm=algo, device=DEVICE)
        generator = torch.Generator(device=DEVICE).manual_seed(1)
        state, checksum = system["state"], torch.zeros((), device=DEVICE)
        for _ in range(ROLLED_STEPS):
            state, checksum = system["env_only_step"]((state, checksum),
                                                      generator)
        system["state"] = state
        rolled[algo] = (system, generator, _knn_args(system["env"], state))
        cases.append((f"{algo} flagship rolled {ROLLED_STEPS} steps",)
                     + rolled[algo][2])
        for label, args, n, k in cases:
            max_abs[kernel] = max(max_abs.get(kernel, 0.0), _compare_knn(
                label, args, n, k, variant, tol=EXACT_TOL))
        out = knn_obs.knn_observation(*near, n_agents=n15, k=k15,
                                      variant=variant)
        first = 1 if knn_obs.packed_bits(variant, n15) == 7 else 2
        assert float(out[0, 0, 0]) == float(near[2][0, 0, first]
                                            - near[2][0, 0, 0]), variant
    return max_abs, rolled


def _check_warp_scan():
    """The warp scan (K1-K5 and K9) vs plain in every mode on the cases
    that exercise its k-list: ``WARP_SCAN_CASES`` (K5 and K2 at k <= 16,
    K2 at N <= 128 and on its own lattice ``K2_LATTICE``), the N = 15
    packed near-tie, and K9 at ``ENVLANES_LARGE``; K4 by its swap class,
    whose share is bounded on the random states only.  Returns each
    kernel's largest abs diff."""
    max_abs = {}
    cases = []
    for state, E, N, k in WARP_SCAN_CASES + (("lattice",) + K2_LATTICE,):
        make = (_lattice_knn_inputs if state == "lattice"
                else _random_knn_inputs)
        cases.append((state,) + make(E, N, k, seed=N + k + 11,
                                     device=DEVICE))
    cases.append(("packed-bits near-tie",) + _near_tie_inputs(DEVICE))
    for kernel, variants in WARP_SCAN_VARIANTS:
        tol = MAX_ABS_TOL if kernel == "knn_obs_flat_exact" else EXACT_TOL
        for label, args, n, k in cases:
            if kernel == "knn_obs_mxu":
                if n > K2_AGENT_LIMIT:
                    continue
                k = min(k, K2_K_LIMIT)
            elif (label, args[0].shape[0], n, k) == ("lattice",) + K2_LATTICE:
                continue  # K2's lattice
            if kernel == "knn_obs_tiled":
                k = min(k, K5_K_LIMIT)
            for variant in variants:
                max_abs[kernel] = max(max_abs.get(kernel, 0.0), _compare_knn(
                    label, args, n, k, variant, tol=tol,
                    bound_share=label == "random"))
    E, N, k = ENVLANES_LARGE
    args, n, kk = _random_knn_inputs(E, N, k, seed=N, device=DEVICE)
    for variant in ("envlanes", "envlanes_exact"):
        max_abs["knn_obs_envlanes"] = max(
            max_abs["knn_obs_envlanes"],
            _compare_knn("8 chunks of candidates", args, n, kk, variant,
                         tol=EXACT_TOL))
    return max_abs


def _drive_knn_loops(rolled):
    """The flagship loops of ``FLAGSHIP_KNN_LOOPS`` at 1024 envs from each
    name's rolled state, ``MAIN_PATH_STEPS`` steps of each loop, with the
    counts set to 0 just before and read just after: each step must launch
    exactly one of its name's kernel and no other.  Returns the timings
    and the counts by (name, loop)."""
    from warpdrive_tpu_torch.ops import knn_obs

    results, launches = {}, {}
    for algo, kernel, full in FLAGSHIP_KNN_LOOPS:
        system, generator, _ = rolled[algo]
        loops = ("env_only_step", "full_loop_step") if full else (
            "env_only_step",)
        for loop in loops:
            r, counts, system["state"] = _time_loop(system, generator,
                                                    MAIN_PATH_STEPS, loop)
            print(f"{loop} [{algo}]: {r['ms_per_step']:.4f} ms/step, "
                  f"{r['env_steps_per_s']:.0f} env-steps/s at {NUM_ENVS} "
                  f"envs x {system['num_agents']} agents ({MAIN_PATH_STEPS} "
                  f"steps, host {r['host_s']:.3f} s); launches {counts}")
            expected = {name: 0 for name in knn_obs.LAUNCH_COUNTS}
            expected[kernel] = MAIN_PATH_STEPS
            assert counts == expected, f"launches {counts}, expected {expected}"
            _physics_path(f"4e {algo} {loop}", r["physics_launches"],
                          MAIN_PATH_STEPS)
            results[algo, loop], launches[algo, loop] = r, counts
    return results, launches


def _drive_main_path(system, generator):
    """Both loops at full width; returns per-loop timings and launches."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs, tag_physics

    env_only = system["env_only_step"]
    full_loop = system["full_loop_step"]
    models = system["models"]
    state = system["state"]
    checksum = torch.zeros((), device=state["_done_"].device)

    for _ in range(5):  # warm-up: allocator, library and kernel loading
        state, checksum = env_only((state, checksum), generator)
        state = full_loop(models, state, generator)
    torch.cuda.synchronize()

    knn_obs.reset_launch_counts()
    tag_physics.reset_launch_counts()
    result = {}
    for name in ("env_only_step", "full_loop_step"):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(MAIN_PATH_STEPS):
            if name == "env_only_step":
                state, checksum = env_only((state, checksum), generator)
            else:
                state = full_loop(models, state, generator)
        stop.record()
        stop.synchronize()
        host_s = time.perf_counter() - t0
        ms = start.elapsed_time(stop) / MAIN_PATH_STEPS
        result[name] = {
            "ms_per_step": ms,
            "env_steps_per_s": system["num_envs"] / (ms / 1e3),
            "host_s": host_s,
            "launches_after": dict(knn_obs.LAUNCH_COUNTS),
        }
    launches = dict(knn_obs.LAUNCH_COUNTS)
    _check_loop_state(state, checksum,
                      (system["num_envs"], system["num_agents"]))
    return result, launches, state


def _check_loop_state(state, checksum, shape):
    """A loop's state after its steps: a finite observation checksum,
    every float array finite, the rewards ``(envs, agents)`` and the done
    flags 0 or 1."""
    import torch

    assert torch.isfinite(checksum), "non-finite observation checksum"
    for name, value in state.items():
        if value.is_floating_point():
            assert torch.isfinite(value).all(), f"non-finite {name}"
    assert tuple(state["rewards"].shape) == shape
    assert bool(((state["_done_"] == 0) | (state["_done_"] == 1)).all())


def _physics_path(label, launches, want):
    """The physics kernel's ``launches`` on the main path ``label``, counted
    from 0 on that path, must be ``want``; kept for the kernel's record."""
    assert launches == want, (
        f"{label}: {launches} physics launches, expected {want}")
    _PHYSICS_PATHS[label] = _PHYSICS_PATHS.get(label, 0) + launches


def _time_loop(system, generator, steps, loop="env_only_step", warmup=5):
    """``warmup`` then ``steps`` steps of ``loop`` (``env_only_step`` or
    ``full_loop_step``); the launch counts, the kNN kernels' and the
    physics kernel's, are set to 0 after the warm-up and read after the
    timed steps.  Returns the timings (with ``physics_launches``), the kNN
    counts and the final state."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs, tag_physics

    step = system[loop]
    state = system["state"]
    checksum = torch.zeros((), device=state["_done_"].device)

    def advance(state, checksum):
        if loop == "env_only_step":
            return step((state, checksum), generator)
        return step(system["models"], state, generator), checksum

    for _ in range(warmup):
        state, checksum = advance(state, checksum)
    torch.cuda.synchronize()
    knn_obs.reset_launch_counts()
    tag_physics.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state, checksum = advance(state, checksum)
    stop.record()
    stop.synchronize()
    host_s = time.perf_counter() - t0
    launches = dict(knn_obs.LAUNCH_COUNTS)
    physics = tag_physics.LAUNCH_COUNTS["tag_physics"]
    _check_loop_state(state, checksum,
                      (system["num_envs"], system["num_agents"]))
    ms = start.elapsed_time(stop) / steps
    return {"ms_per_step": ms,
            "env_steps_per_s": system["num_envs"] / (ms / 1e3),
            "agent_steps_per_s": system["num_envs"] * system["num_agents"]
            / (ms / 1e3),
            "host_s": host_s, "physics_launches": physics}, launches, state


def _drive_many_agents():
    """The 1024-agent env-only loop at 256 envs for each of
    ``MANY_AGENT_LOOPS``, each launching exactly one of its kernel per step
    and no other.  Returns the systems, timings and launches by algorithm."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.presets import build_many_agents

    systems, results, launches = {}, {}, {}
    for algo, kernel in MANY_AGENT_LOOPS:
        system = build_many_agents(num_envs=MANY_AGENT_ENVS, seed=0,
                                   knn_algorithm=algo, device=DEVICE)
        generator = torch.Generator(device=DEVICE).manual_seed(0)
        r, counts, state = _time_loop(system, generator, MANY_AGENT_STEPS)
        system["state"], system["generator"] = state, generator
        print(f"1024-agent env_only_step [{algo}]: {r['ms_per_step']:.4f} "
              f"ms/step, {r['env_steps_per_s']:.0f} env-steps/s, "
              f"{r['agent_steps_per_s']:.0f} agent-steps/s at "
              f"{MANY_AGENT_ENVS} envs x {system['num_agents']} agents "
              f"({MANY_AGENT_STEPS} steps, host {r['host_s']:.3f} s); "
              f"launches {counts}")
        expected = {name: 0 for name in knn_obs.LAUNCH_COUNTS}
        expected[kernel] = MANY_AGENT_STEPS
        assert counts == expected, f"launches {counts}, expected {expected}"
        _physics_path(f"4c {algo}", r["physics_launches"], MANY_AGENT_STEPS)
        systems[algo], results[algo], launches[algo] = system, r, counts
    # the same loops in the reverse order, so that each loop's wall is read
    # both early and late in the run; each system keeps the state of its
    # first pass, which the kernel timing of phase 5 reads
    for algo, kernel in reversed(MANY_AGENT_LOOPS):
        system = systems[algo]
        r, counts, _ = _time_loop(system, system["generator"],
                                  MANY_AGENT_STEPS)
        print(f"1024-agent env_only_step [{algo}], reverse order: "
              f"{r['ms_per_step']:.4f} ms/step (host {r['host_s']:.3f} s); "
              f"launches {counts}")
        expected = {name: 0 for name in knn_obs.LAUNCH_COUNTS}
        expected[kernel] = MANY_AGENT_STEPS
        assert counts == expected, f"launches {counts}, expected {expected}"
        _physics_path(f"4c {algo}", r["physics_launches"], MANY_AGENT_STEPS)
        launches[f"{algo}, reverse order"] = counts
    return systems, results, launches


def _drive_training(run_config, before_train=None):
    """The training path at the run config's width, through the CLI's
    ``setup_trainer`` and ``train()``, with the kernels' launch counts, the
    kNN kernels' and the physics kernel's, set to 0 just before and read
    just after; ``before_train(trainer)``, when given, runs between the
    two.  Returns the trainer, the kNN counts and the set-up and training
    seconds with the physics launches (``physics_launches``)."""
    import math

    import torch

    from warpdrive_tpu_torch.ops import knn_obs, tag_physics
    from warpdrive_tpu_torch.training.scripts.train import setup_trainer

    results_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        knn_obs.reset_launch_counts()
        tag_physics.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = setup_trainer(run_config, results_dir=results_dir,
                                verbose=False, device=DEVICE)
        setup_s = time.perf_counter() - t0
        before = {tag: {k: v.detach().clone()
                        for k, v in m.state_dict().items()}
                  for tag, m in trainer.models.items()}
        if before_train is not None:
            before_train(trainer)
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(knn_obs.LAUNCH_COUNTS)
        physics = tag_physics.LAUNCH_COUNTS["tag_physics"]

        with open(Path(results_dir) / "results.json", encoding="utf-8") as f:
            last = json.loads(f.read().splitlines()[-1])
        for tag, metrics in last["metrics"].items():
            bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
            assert not bad, f"{tag}: non-finite metrics {bad}"
        for tag, model in trainer.models.items():
            moved = max(float((v - before[tag][k]).abs().max())
                        for k, v in model.state_dict().items())
            assert moved > 0, f"{tag}: parameters did not move"
            ckpt = Path(trainer._ckpt_path(tag, trainer.current_timestep))
            assert ckpt.is_file(), f"no checkpoint {ckpt}"
            metrics = last["metrics"][tag]
            print(f"training {tag}: largest parameter change {moved:.4g}, "
                  f"checkpoint {ckpt.name}, last metrics: total loss "
                  f"{metrics['Total loss']:.5f}, gradient norm "
                  f"{metrics['Gradient norm']:.5f}")
    finally:
        shutil.rmtree(results_dir, ignore_errors=True)
    steps = trainer.training_batch_size_per_env * trainer.num_envs
    for it, (roll_ms, upd_ms) in enumerate(trainer.phase_ms):
        print(f"training iteration {it + 1}: rollout {roll_ms:.3f} ms, "
              f"update {upd_ms:.3f} ms, "
              f"{steps / ((roll_ms + upd_ms) / 1e3):.0f} env-steps/s")
    return trainer, launches, {"setup_s": setup_s, "train_s": train_s,
                               "physics_launches": physics}


def _update_card_vs_cpu(trainer, envs=UPDATE_ENVS, float64=False):
    """One update of each trained policy on the card and on the CPU, from
    copies of the trained parameters and optimizer state, on the first
    ``envs`` envs of the last training batch (action masks included): the
    parameters within ``UPDATE_PARAM_TOL``.  With ``float64`` the CPU also
    runs the update in float64, and each float32 update is held to that
    one instead, within ``UPDATE_PARAM_TOL`` or a hundredth of the
    learning rate, the larger: Adam's normalised step turns the float32
    rounding of a gradient entry near 0 into a share of a step, which at
    the full observation's 764 features exceeds ``UPDATE_PARAM_TOL`` on
    the card.  Returns the largest parameter difference card vs CPU."""
    import torch

    from warpdrive_tpu_torch.training.trainer_a2c import (
        ClippedAdam,
        policy_update,
    )

    runs = [(DEVICE, torch.float32), ("cpu", torch.float32)]
    if float64:
        runs.append(("cpu", torch.float64))
    worst = 0.0
    timestep = trainer.current_timestep
    for tag in trainer.policies_to_train:
        batch = {k: v[:, :envs].contiguous()
                 for k, v in trainer._policy_batch(trainer._batch, tag).items()}
        lr = trainer.lr_schedules[tag].value_at(timestep)
        params = {}
        losses = {}
        for device, dtype in runs:
            model = copy.deepcopy(trainer.models[tag]).to(device, dtype)
            opt = ClippedAdam(dict(model.named_parameters()),
                              max_norm=trainer.optimizers[tag].max_norm)
            opt.load_state_dict(trainer.optimizers[tag].state_dict())
            metrics = policy_update(
                model, opt, trainer.algorithms[tag],
                {k: v.to(device, dtype) if v.is_floating_point()
                 else v.to(device) for k, v in batch.items()},
                timestep, lr)
            losses[device, dtype] = float(metrics["Total loss"])
            params[device, dtype] = {
                k: v.detach().cpu().double()
                for k, v in model.state_dict().items()}

        def diff(a, b):
            return max(float((params[a][k] - params[b][k]).abs().max())
                       for k in params[b])

        def worst_tensor(a, b):
            return max(params[b], key=lambda k: float(
                (params[a][k] - params[b][k]).abs().max()))

        card, cpu = runs[0], runs[1]
        worst = max(worst, diff(card, cpu))
        line = (f"update card vs CPU [{tag}, {envs} envs x "
                f"{trainer.training_batch_size_per_env} steps]: loss "
                f"{losses[card]:.7f} vs {losses[cpu]:.7f}, max abs "
                f"parameter diff {diff(card, cpu):.3g}")
        if not float64:
            print(f"{line} (tolerance {UPDATE_PARAM_TOL})")
            assert diff(card, cpu) <= UPDATE_PARAM_TOL, \
                f"{tag}: parameters differ by {diff(card, cpu)}"
            continue
        exact = runs[2]
        card_err, cpu_err = diff(card, exact), diff(cpu, exact)
        bound = max(UPDATE_PARAM_TOL, lr / 100)
        print(f"{line}; from the CPU's float64 update (loss "
              f"{losses[exact]:.7f}): card {card_err:.3g} (in "
              f"{worst_tensor(card, exact)}), CPU float32 {cpu_err:.3g} (in "
              f"{worst_tensor(cpu, exact)}); tolerance {bound:.3g}, a "
              f"hundredth of the learning rate {lr:.3g} or "
              f"{UPDATE_PARAM_TOL}")
        assert max(card_err, cpu_err) <= bound, \
            f"{tag}: card {card_err}, CPU {cpu_err} from float64"
    return worst


def _env_settings(settings):
    """An env loop's settings: given, or a run config's env section."""
    from warpdrive_tpu_torch.utils.config import load_run_config

    if isinstance(settings, str):
        return dict(load_run_config(settings)["env"])
    return dict(settings)


def _check_full_steps():
    """The full-step path's CUDA step against its CPU step from the same
    states (``tools/consistency.py:step_against_cpu``) over
    ``FULL_STEP_STATES`` rolled states at ``FULL_STEP_CHECK_ENVS`` envs:
    TagGridWorld with full (the run config's env) and partial (the bench's
    geometry) observations bit for bit; each classic-control env (its run
    config's env, CartPole's with its pool of 1000) state and observations
    within ``CLASSIC_STEP_TOL``, rewards and done flags equal.  Then a
    forced and a done-driven pool reset on the card of TagGridWorldWith
    ResetPool and CartPole with a pool, each after ``FULL_STEP_STATES``
    random steps (``check_pool_reset``: reset rows are pool rows, the reset
    envs' observations ``observe_fn`` of the reset state).  Returns the
    largest float difference by env."""
    import torch

    from warpdrive_tpu_torch.envs import register_all_envs
    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.presets import random_actions_fn
    from warpdrive_tpu_torch.tools.consistency import (
        check_pool_reset,
        step_against_cpu,
    )
    from warpdrive_tpu_torch.utils.config import load_run_config
    from warpdrive_tpu_torch.utils.env_registrar import env_registrar

    register_all_envs()

    def engines(env_name, settings, devices=(DEVICE, "cpu"), seed=3):
        cls = env_registrar.get(env_name, backend="torch")
        return [EnvEngine(env_obj=cls(seed=seed, **settings),
                          num_envs=FULL_STEP_CHECK_ENVS, seed=seed,
                          device=device) for device in devices]

    cases = [("TagGridWorld, full obs", "TagGridWorld",
              _env_settings("tag_gridworld"), 0.0),
             ("TagGridWorld, partial obs", "TagGridWorld",
              _env_settings(ENV_LOOPS[0][4]), 0.0)]
    cases += [(f"{label}", env_name, _env_settings(
        "single_cartpole" if label == "CartPole" else settings),
        CLASSIC_STEP_TOL) for label, env_name, _, _, settings in ENV_LOOPS[1:]]
    worst = {}
    for label, env_name, settings, tol in cases:
        settings.pop("seed", None)
        diffs = step_against_cpu(*engines(env_name, settings),
                                 steps=FULL_STEP_STATES)
        print(f"CUDA step vs CPU step [{label}], {FULL_STEP_STATES} states "
              f"at {FULL_STEP_CHECK_ENVS} envs: max abs diff "
              + ", ".join(f"{k} {v:.3g}" for k, v in sorted(diffs.items()))
              + "; integer arrays equal")
        assert diffs["rewards"] == 0.0, diffs
        assert max(diffs.values()) <= tol, diffs
        worst[label] = max(diffs.values())

    for label, env_name, run_config in (
            ("TagGridWorldWithResetPool", "TagGridWorldWithResetPool",
             "tag_gridworld_with_reset_pool"),
            ("CartPole with a pool", "ClassicControlCartPoleEnv",
             "single_cartpole")):
        settings = dict(load_run_config(run_config)["env"])
        settings.pop("seed", None)
        [engine] = engines(env_name, settings, devices=(DEVICE,))
        generator = torch.Generator(device=DEVICE).manual_seed(3)
        actions = random_actions_fn(engine, DEVICE)
        state = engine.state
        for _ in range(FULL_STEP_STATES):
            state = engine.step(state, actions(generator))
        forced = check_pool_reset(engine, state)
        done = torch.rand((engine.n_envs,), generator=generator,
                          device=DEVICE) < 0.3
        partial = check_pool_reset(engine, state, done=done)
        pools = {t: tuple(p.shape) for t, p in engine.store.pools.items()}
        print(f"pool reset on the card [{label}, pools {pools}]: forced "
              f"{forced} envs and done-driven {partial} envs; every reset "
              "row a pool row, their observations observe_fn of the reset "
              "state, the others unchanged")
    return worst


def _drive_env_loops():
    """The full-step path's env-only loops (``ENV_LOOPS``), each
    ``ENV_LOOP_STEPS`` steps after 5 warm-up steps with the kernels' launch
    counts set to 0 after the warm-up: random device actions, the step, an
    observation checksum and the auto-reset; none may launch a kNN kernel.
    Returns the systems (with their generators) and the timings by label."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.presets import build_env_only_loop

    no_launches = {name: 0 for name in knn_obs.LAUNCH_COUNTS}
    systems, results = {}, {}
    for label, env_name, num_envs, seed, settings in ENV_LOOPS:
        settings = _env_settings(settings)
        settings.pop("seed", None)
        system = build_env_only_loop(env_name, num_envs, seed=seed,
                                     device=DEVICE, **settings)
        generator = torch.Generator(device=DEVICE).manual_seed(seed)
        r, counts, state = _time_loop(system, generator, ENV_LOOP_STEPS)
        system["state"], system["generator"] = state, generator
        print(f"{label} env_only_step: {r['ms_per_step']:.4f} ms/step, "
              f"{r['env_steps_per_s']:.0f} env-steps/s at {num_envs} envs x "
              f"{system['num_agents']} agents ({ENV_LOOP_STEPS} steps, host "
              f"{r['host_s']:.3f} s; {settings}); launches {counts}")
        assert counts == no_launches, f"{label}: launches {counts}"
        assert r["physics_launches"] == 0, r
        systems[label], results[label] = system, r
    return systems, results


def _drive_full_step_training():
    """A2C training of ``FULL_STEP_TRAINING`` at full width through
    ``_drive_training`` (``setup_trainer`` and ``train()``), each for
    ``FULL_STEP_TRAIN_ITERS`` iterations, no kNN kernel launched; the pool
    variants must have their pools registered.  Returns the trainers and
    the mean (rollout ms, update ms, env-steps/s) of iterations 2 on, by
    config."""
    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.utils.config import load_run_config

    no_launches = {name: 0 for name in knn_obs.LAUNCH_COUNTS}
    trainers, means = {}, {}
    for name in FULL_STEP_TRAINING:
        cfg = load_run_config(name)
        trainer_cfg = cfg["trainer"]
        trainer_cfg["num_episodes"] = (FULL_STEP_TRAIN_ITERS
                                       * trainer_cfg["train_batch_size"]
                                       // cfg["env"]["episode_length"])
        trainer_cfg["seed"] = 0
        trainer, launches, times = _drive_training(cfg)
        assert trainer.num_iters == FULL_STEP_TRAIN_ITERS
        assert launches == no_launches, f"{name}: launches {launches}"
        assert times["physics_launches"] == 0, times
        pools = {t: tuple(p.shape)
                 for t, p in trainer.engine.store.pools.items()}
        if "reset_pool_size" in cfg["env"] or "with_reset_pool" in name:
            assert pools, f"{name}: no reset pool registered"
        steps = trainer.training_batch_size_per_env * trainer.num_envs
        later = trainer.phase_ms[1:]
        roll_ms = statistics.mean(r for r, _ in later)
        upd_ms = statistics.mean(u for _, u in later)
        rate = steps / ((roll_ms + upd_ms) / 1e3)
        print(f"training {name}: {trainer.num_iters} iterations of "
              f"{trainer.num_envs} envs x {trainer.training_batch_size_per_env}"
              f" steps, pools {pools}, in {times['train_s']:.3f} s (setup "
              f"{times['setup_s']:.3f} s); iterations 2-{trainer.num_iters}, "
              f"mean: rollout {roll_ms:.3f} ms, update {upd_ms:.3f} ms, "
              f"{rate:.0f} env-steps/s; launches {launches}")
        trainers[name], means[name] = trainer, (roll_ms, upd_ms, rate)
    return trainers, means


def _knn_bound_ms(E, N, k, d2_pairs, mxu_distance=False):
    """Least time for the kNN function on the card: each input read once and
    the output written once at the HBM rate, or the distance arithmetic at
    its peak rate, whichever is larger.  A pair costs 5 float32 flops in
    the difference form (2 sub, 2 mul, 1 add) at 67 TFLOP/s, and in the MXU
    expansion 12 bf16 multiply-adds, 24 flops, at the tensor cores' 989
    TFLOP/s: the same work whatever implements it, K5's scalar form
    included."""
    bytes_in = 4 * (3 * E * N + 5 * E * N + N + E)
    bytes_out = 4 * E * N * (8 * k + 1)
    t_bytes = (bytes_in + bytes_out) / _PEAK_BYTES_PER_S
    t_ops = (24 * d2_pairs / _PEAK_BF16_FLOPS if mxu_distance
             else 5 * d2_pairs / _PEAK_F32_FLOPS)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), bound_by, bytes_in + bytes_out


def _kernel_device_ms(fn, calls=50, symbols=_KERNEL_SYMBOLS):
    """The device time a call of ``fn`` spends in the port's kernel whose
    device function holds one of ``symbols`` (the kNN kernels' by default;
    one launch a call), by ``torch.profiler`` over ``calls`` back-to-back
    calls: the kernel's own time, without the host's call rate."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the profiler may drop an event of a long run of short launches, so
    # the time a launch is over the launches it recorded; a window in which
    # it recorded none is profiled again, up to three times
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and any(name in e.key for name in symbols)]
        launches = sum(e.count for e in events)
        if launches:
            break
    assert 0 < launches <= calls, f"profiled {launches} kernel launches"
    return sum(e.self_device_time_total for e in events) / 1e3 / launches


def _launch_floor():
    """The launch latency floor: a one-element add, back to back (median of
    21 x 50) and by its device time (profiler, 50 launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device=DEVICE)
    back_to_back = _cuda_ms(lambda: x.add_(1.0), repeats=21, inner=50)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            x.add_(1.0)
        torch.cuda.synchronize()
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3 / 50
    print(f"launch floor (a one-element add): back to back {back_to_back:.5f}"
          f" ms, device {device:.5f} ms a launch")
    return back_to_back, device


def _device_ms(prof) -> float:
    """Device time of a profiled window: the kernels' own time, summed over
    the device-side events only (a CPU op's entry repeats its kernels')."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               # a scheduled window's step range spans its kernels
               and not e.key.startswith("ProfilerStep")) / 1e3


def _stepper(system, generator, loop):
    """One step of ``loop`` (``env_only_step`` or ``full_loop_step``) on
    ``system``, carrying its state in ``system["state"]``."""
    import torch

    checksum = torch.zeros((), device=DEVICE)

    def step():
        if loop == "env_only_step":
            system["state"], _ = system["env_only_step"](
                (system["state"], checksum), generator)
        else:
            system["state"] = system["full_loop_step"](
                system["models"], system["state"], generator)

    return step


def _profile(windows, steps=10):
    """A ``torch.profiler`` table of device time by kernel for each of
    ``windows`` -- (label, advance, unit, wall ms per unit): ``steps``
    calls of ``advance``, or one for a training iteration -- with the device
    ms per unit beside the wall ms per unit of the same work measured
    without the profiler (the profiler slows the host), the device's idle
    share, 1 - device / wall, and the kNN kernel's device time a launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for label, advance, unit, wall_ms in windows:
        n = 1 if unit == "iteration" else steps
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                advance()
            torch.cuda.synchronize()
        device_ms = _device_ms(prof) / n
        knn = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and any(name in e.key for name in _KERNEL_SYMBOLS)]
        launches = sum(e.count for e in knn)
        knn_ms = sum(e.self_device_time_total for e in knn) / 1e3
        print(f"profile {label} ({n} {unit}s): device {device_ms:.4f} ms per "
              f"{unit}, wall without the profiler {wall_ms:.4f} ms, device "
              f"idle share {100 * (1 - device_ms / wall_ms):.1f}%; the kNN "
              f"kernel {knn_ms / max(launches, 1):.5f} ms a launch over "
              f"{launches} launches; device time by kernel:")
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=25))


def _time_knn(name, args, n_agents, k, variant, label, plain_repeats=11,
              plain_inner=5):
    """Kernel vs plain on one input (``_compare_knn``: bit for bit, or K4's
    swap class), then their times there: the kernel's median of 21 x 50
    back-to-back wrapper calls (the inputs stay in L2), which at a small
    shape is the host's call rate, and its own device time a launch
    (``_kernel_device_ms``); plain ``plain_repeats`` x ``plain_inner``;
    beside the bound."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs

    max_abs = _compare_knn(label, args, n_agents, k, variant, tol=EXACT_TOL)
    E, N = args[0].shape

    def call():
        knn_obs.knn_observation(*args, n_agents=n_agents, k=k,
                                variant=variant)

    kernel_ms = _cuda_ms(call, repeats=21, inner=50)
    device_ms = _kernel_device_ms(call)
    plain_ms = _cuda_ms(
        lambda: knn_obs.knn_observation_plain(*args, n_agents=n_agents, k=k,
                                              variant=variant),
        repeats=plain_repeats, inner=plain_inner,
    )
    alive = (args[4] >= 0.5).sum(dim=1).to(torch.float64)
    d2_pairs = float((alive * (alive - 1)).sum())  # pairs of live agents
    bound_ms, bound_by, nbytes = _knn_bound_ms(
        E, N, k, d2_pairs, mxu_distance="mxudist" in variant)
    print(f"{name} [{variant}, {label}] at E={E} N={N} k={k}: kernel "
          f"{kernel_ms:.5f} ms back to back, {device_ms:.5f} ms device, "
          f"plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{nbytes} bytes, {d2_pairs:.0f} live pairs); "
          f"{100 * bound_ms / device_ms:.1f}% of bound")
    return {"max_abs_err": max_abs, "ms": kernel_ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def _physics_bound_ms(E, N, tables):
    """Least time for the physics step on the card: each input read once
    and each output written once at the HBM rate -- the five float32
    fields, the int32 still-in-the-game flags and two action indices an
    agent, the timestep an env and ``tables`` (the constants' floats and
    ints) in; the five fields, the flags and the reward an agent, the
    timestep and the done flag an env out.  Its few dozen flops an agent
    and T distances lie far below the float32 peak: bytes."""
    bytes_in = 4 * (8 * E * N + E + tables)
    bytes_out = 4 * (7 * E * N + 2 * E)
    return (1e3 * (bytes_in + bytes_out) / _PEAK_BYTES_PER_S,
            bytes_in + bytes_out)


def _time_physics(env, state, label):
    """The physics kernel against ``physics_plain`` on ``state`` with
    random int32 actions, bit for bit in every field it writes; then the
    kernel's time back to back (21 x 50 calls), its own device time
    (profiler, 50 calls) and the plain version's (11 x 5), beside the
    bound."""
    import torch

    from warpdrive_tpu_torch.ops import tag_physics

    E, N = state["loc_x"].shape
    gen = torch.Generator(device=DEVICE).manual_seed(N)
    actions = torch.stack(
        [torch.randint(0, int(n), (E, N), generator=gen, device=DEVICE,
                       dtype=torch.int32)
         for n in env.action_space[0].nvec], dim=-1)
    before = tag_physics.LAUNCH_COUNTS["tag_physics"]
    out = env.physics_fn(state, actions)
    plain = env.physics_plain(state, actions)
    torch.cuda.synchronize()
    assert tag_physics.LAUNCH_COUNTS["tag_physics"] == before + 1
    max_abs = 0.0
    for name in ("loc_x", "loc_y", "speed", "direction", "acceleration",
                 "still_in_the_game", "rewards", "_timestep_", "_done_"):
        a, b = out[name], plain[name]
        if a.dtype == torch.float32:
            max_abs = max(max_abs, float((a - b).abs().max()))
            a, b = a.view(torch.int32), b.view(torch.int32)
        bad = int((a != b).sum())
        assert bad == 0, f"physics [{label}]: {bad} entries of {name} differ"

    def call():
        env.physics_fn(state, actions)

    kernel_ms = _cuda_ms(call, repeats=21, inner=50)
    device_ms = _kernel_device_ms(call, symbols=(_PHYSICS_SYMBOL,))
    plain_ms = _cuda_ms(lambda: env.physics_plain(state, actions),
                        repeats=11, inner=5)
    consts = env._consts(torch.device(DEVICE))
    tables = sum(consts[name].numel() for name in (
        "max_speed", "step_rewards", "tagger_slot", "acc_table",
        "turn_table"))
    bound_ms, nbytes = _physics_bound_ms(E, N, tables)
    print(f"tag_physics [{label}] at E={E} N={N} T={env.num_taggers}: bit "
          f"for bit with physics_plain; kernel {kernel_ms:.5f} ms back to "
          f"back, {device_ms:.5f} ms device, plain {plain_ms:.5f} ms, bound "
          f"{bound_ms:.5f} ms (bytes: {nbytes}); "
          f"{100 * bound_ms / device_ms:.1f}% of bound")
    return {"max_abs_err": max_abs, "ms": kernel_ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes"}


def _ddpg_config(name):
    """A DDPG run config at full width, cut to ``DDPG_TRAIN_ITERS``
    iterations, trainer and env seeds 0 (the env draws its initial state
    and pool from its seed), metrics logged every iteration."""
    from warpdrive_tpu_torch.utils.config import load_run_config

    cfg = load_run_config(name)
    trainer_cfg = cfg["trainer"]
    trainer_cfg["num_episodes"] = (DDPG_TRAIN_ITERS
                                   * trainer_cfg["train_batch_size"]
                                   // cfg["env"]["episode_length"])
    trainer_cfg["seed"] = 0
    cfg["env"]["seed"] = 0
    cfg["saving"]["metrics_log_freq"] = 1
    return cfg


def _ddpg_nets(trainer) -> dict:
    """Copies of a DDPG trainer's nets and targets, and its Adam counts."""
    out = {}
    for kind in ("nets", "targets"):
        for net, by_tag in getattr(trainer, kind).items():
            for tag, model in by_tag.items():
                for k, v in model.state_dict().items():
                    out[f"{kind}.{net}.{tag}.{k}"] = v.detach().clone()
    for net, by_tag in trainer.optimizers.items():
        for tag, opt in by_tag.items():
            out[f"count.{net}.{tag}"] = opt.count
    return out


def _nets_diff(a: dict, b: dict) -> float:
    """The largest difference of two ``_ddpg_nets``; Adam counts must be
    equal."""
    assert a.keys() == b.keys()
    worst = 0.0
    for k, v in a.items():
        if k.startswith("count."):
            assert v == b[k], f"{k}: {v} != {b[k]}"
        else:
            worst = max(worst, float((v - b[k]).abs().max()))
    return worst


def _drive_ddpg_training():
    """DDPG training of ``DDPG_TRAINING`` at full width through
    ``setup_trainer`` and ``train()``, ``DDPG_TRAIN_ITERS`` iterations each,
    with the kernels' launch counts set to 0 just before and read just
    after: iteration 1 must leave the nets, the targets and the Adam counts
    as built (the replay window is not full yet), the later iterations
    report "Buffer full" 1.0 and every metric is finite, the online actor
    ends apart from its target, both checkpoints exist and no kNN kernel
    is launched.  Returns the trainers and the mean (rollout ms, update ms,
    env-steps/s) of iterations 2 on, by config."""
    import math

    import torch

    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.training.scripts.train import setup_trainer
    from warpdrive_tpu_torch.training.trainer_ddpg import TrainerDDPG

    no_launches = {name: 0 for name in knn_obs.LAUNCH_COUNTS}
    trainers, means = {}, {}
    for name in DDPG_TRAINING:
        cfg = _ddpg_config(name)
        results_dir = tempfile.mkdtemp(prefix="chip_smoke_ddpg_")
        try:
            knn_obs.reset_launch_counts()
            t0 = time.perf_counter()
            trainer = setup_trainer(cfg, results_dir=results_dir,
                                    verbose=False, device=DEVICE)
            setup_s = time.perf_counter() - t0
            assert isinstance(trainer, TrainerDDPG)
            assert trainer.num_iters == DDPG_TRAIN_ITERS
            built = _ddpg_nets(trainer)
            after_first = {}
            iteration = trainer._iteration

            def watched(timestep, full=True, iteration=iteration,
                        after_first=after_first, trainer=trainer):
                metrics = iteration(timestep, full=full)
                if not after_first:
                    after_first.update(_ddpg_nets(trainer))
                return metrics

            trainer._iteration = watched
            t0 = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            del trainer._iteration  # the class's method again
            launches = dict(knn_obs.LAUNCH_COUNTS)
            assert launches == no_launches, f"{name}: launches {launches}"
            first_moved = _nets_diff(after_first, built)
            assert first_moved == 0.0, \
                f"{name}: iteration 1 moved the nets by {first_moved}"

            with open(Path(results_dir) / "results.json",
                      encoding="utf-8") as f:
                records = [json.loads(line)["metrics"]["shared"]
                           for line in f.read().splitlines()]
            full = [r["Buffer full"] for r in records]
            assert full == [0.0] + [1.0] * (DDPG_TRAIN_ITERS - 1), full
            for r in records:
                bad = {k: v for k, v in r.items() if not math.isfinite(v)}
                assert not bad, f"{name}: non-finite metrics {bad}"
            online = trainer.nets["actor"]["shared"].state_dict()
            target = trainer.targets["actor"]["shared"].state_dict()
            apart = max(float((v - target[k]).abs().max())
                        for k, v in online.items())
            assert apart > 0, f"{name}: the actor equals its target"
            ckpts = [Path(trainer._ckpt_path("shared",
                                             trainer.current_timestep, net))
                     for net in ("actor", "critic")]
            assert all(c.is_file() for c in ckpts), f"no checkpoints {ckpts}"
            last = records[-1]
        finally:
            shutil.rmtree(results_dir, ignore_errors=True)
        steps = trainer.training_batch_size_per_env * trainer.num_envs
        for it, (roll_ms, upd_ms) in enumerate(trainer.phase_ms):
            print(f"DDPG {name} iteration {it + 1}: rollout {roll_ms:.3f} "
                  f"ms, update {upd_ms:.3f} ms, "
                  f"{steps / ((roll_ms + upd_ms) / 1e3):.0f} env-steps/s, "
                  f"buffer full {full[it]}")
        later = trainer.phase_ms[1:]
        roll_ms = statistics.mean(r for r, _ in later)
        upd_ms = statistics.mean(u for _, u in later)
        rate = steps / ((roll_ms + upd_ms) / 1e3)
        pools = {t: tuple(p.shape)
                 for t, p in trainer.engine.store.pools.items()}
        print(f"DDPG {name}: {trainer.num_iters} iterations of "
              f"{trainer.num_envs} envs x {trainer.training_batch_size_per_env}"
              f" steps, window {trainer.buffer_capacity} rows, pools {pools}"
              f", in {train_s:.3f} s (setup {setup_s:.3f} s); iteration 1 "
              f"moved nothing; iterations 2-{trainer.num_iters}, mean: "
              f"rollout {roll_ms:.3f} ms, update {upd_ms:.3f} ms, {rate:.0f} "
              f"env-steps/s; actor vs target {apart:.4g}; last metrics: "
              f"critic loss {last['Critic loss']:.5f}, actor loss "
              f"{last['Actor loss']:.5f}; launches {launches}")
        trainers[name], means[name] = trainer, (roll_ms, upd_ms, rate)
    return trainers, means


def _ddpg_update_card_vs_cpu(trainer):
    """One DDPG update of each trained policy on the card and on the CPU,
    from copies of the trained nets, targets and optimizer states, on the
    trainer's whole replay window.  Returns the largest parameter
    difference."""
    from warpdrive_tpu_torch.training.trainer_a2c import ClippedAdam
    from warpdrive_tpu_torch.training.trainer_ddpg import ddpg_policy_update

    worst = 0.0
    timestep = trainer.current_timestep
    for tag in trainer.policies_to_train:
        batch = {"obs": trainer._window[f"obs_{tag}"],
                 "actions": trainer._window[f"actions_{tag}"],
                 "rewards": trainer._window[f"rewards_{tag}"],
                 "done": trainer._window["done"]}
        lrs = {net: trainer.lr_schedules[net][tag].value_at(timestep)
               for net in ("actor", "critic")}
        params, losses = {}, {}
        for device in (DEVICE, "cpu"):
            nets, targets, opts = {}, {}, {}
            for net in ("actor", "critic"):
                nets[net] = copy.deepcopy(trainer.nets[net][tag]).to(device)
                targets[net] = copy.deepcopy(
                    trainer.targets[net][tag]).to(device)
                source = trainer.optimizers[net][tag]
                opts[net] = ClippedAdam(dict(nets[net].named_parameters()),
                                        max_norm=source.max_norm)
                opts[net].load_state_dict(source.state_dict())
            metrics = ddpg_policy_update(
                nets, targets, opts, trainer.algorithms[tag],
                {k: v.to(device) for k, v in batch.items()}, timestep, lrs,
                trainer.tau[tag])
            losses[device] = (float(metrics["Critic loss"]),
                              float(metrics["Actor loss"]))
            params[device] = {
                f"{kind}.{net}.{k}": v.detach().cpu()
                for kind, by_net in (("net", nets), ("target", targets))
                for net, model in by_net.items()
                for k, v in model.state_dict().items()}
        diff = max(float((params[DEVICE][k] - params["cpu"][k]).abs().max())
                   for k in params["cpu"])
        print(f"DDPG update card vs CPU [{tag}, window "
              f"{tuple(batch['obs'].shape[:2])}]: critic, actor loss "
              f"{losses[DEVICE][0]:.7f}, {losses[DEVICE][1]:.7f} vs "
              f"{losses['cpu'][0]:.7f}, {losses['cpu'][1]:.7f}; max abs "
              f"parameter diff (nets and targets) {diff:.3g} (tolerance "
              f"{UPDATE_PARAM_TOL})")
        assert diff <= UPDATE_PARAM_TOL, f"{tag}: parameters differ by {diff}"
        worst = max(worst, diff)
    return worst


def _check_ring_buffer():
    """``RingBufferManager`` with its default storage, the card: 11 rows of
    Pendulum's observations at full width (10,000 envs x 1 agent x 3)
    enqueued into a capacity of 4 unroll, oldest first, exactly as the same
    buffer on the CPU after every enqueue."""
    import torch

    from warpdrive_tpu_torch.training.ring_buffer import (
        RingBuffer,
        RingBufferManager,
    )

    shape = (10_000, 1, 3)
    on_card, on_cpu = RingBufferManager(), RingBufferManager()
    buf = on_card.add("obs", capacity=4, item_shape=shape)
    on_cpu.add("obs", capacity=4, item_shape=shape, device="cpu")
    assert buf.device.type == "cuda", buf.device
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    for _ in range(11):
        row = torch.randn(shape, generator=gen, device=DEVICE)
        on_card.enqueue("obs", row)
        on_cpu.enqueue("obs", row.cpu())
        assert torch.equal(on_card.unroll("obs").cpu(),
                           on_cpu.unroll("obs")), "ring buffer unroll"
    assert RingBuffer.isfull(on_card.get("obs")[1])
    print(f"ring buffer on {buf.device}: 11 enqueues of {shape} into 4 "
          f"slots unroll as on the CPU, bit for bit")


def _timed(fn):
    """``fn()`` and its host seconds, up to a synchronised device."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _tuned_config(iters, recompute=False):
    """The tuned flagship training stage as a run config for the CLI's
    ``setup_trainer``: the JAX bench's env (``FLAGSHIP_ENV_KWARGS``, env seed
    274880, ``pallas_flat_exact``; ``knn_block_envs`` has no meaning on the
    card), trainer seed 1 (which ``setup_trainer`` also gives the engine,
    where the bench's engine has seed 31), ``iters`` iterations."""
    from warpdrive_tpu_torch.presets import FLAGSHIP_ENV_KWARGS

    policy = {"to_train": True, "algorithm": "A2C", "vf_loss_coeff": 1,
              "entropy_coeff": 0.05, "clip_grad_norm": True,
              "max_grad_norm": 0.5, "gamma": 0.98, "lr": 0.001,
              "num_minibatches": TUNED_MINIBATCHES,
              "shuffle_minibatches": False,
              "model": {"type": "fully_connected", "fc_dims": [256, 256],
                        "dtype": "bfloat16"}}
    batch = TUNED_ENVS * TUNED_STEPS
    return {
        "name": "tag_continuous",
        "env": dict(FLAGSHIP_ENV_KWARGS, seed=274880,
                    knn_algorithm="pallas_flat_exact"),
        "trainer": {"num_envs": TUNED_ENVS, "train_batch_size": batch,
                    "num_episodes": iters * batch
                    // FLAGSHIP_ENV_KWARGS["episode_length"],
                    "seed": 1, "batch_dtype": "bfloat16",
                    "update_recompute_obs": recompute},
        "policy": {"runner": dict(policy, lr=0.005), "tagger": dict(policy)},
        "saving": {"metrics_log_freq": iters,
                   "model_params_save_freq": 10**9},
    }


def _drive_tuned_training():
    """4j: the tuned flagship stage at full width through ``setup_trainer``
    and ``train()`` (``_drive_training``), ``TUNED_ITERS`` iterations with
    exactly ``TUNED_STEPS`` K1 launches each and no other kernel; then
    ``profile_phases``, whose updates launch no kernel; then one iteration
    under ``update_recompute_obs``, with ``TUNED_STEPS`` K1 launches in the
    rollout and one for each policy and minibatch pass in the update.
    Returns both trainers, the two training runs' launches and the means
    of iterations 2 on and the profile."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs

    no_launches = {name: 0 for name in knn_obs.LAUNCH_COUNTS}
    torch.cuda.reset_peak_memory_stats()
    trainer, launches, times = _drive_training(_tuned_config(TUNED_ITERS))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    assert trainer.num_iters == TUNED_ITERS
    expected = dict(no_launches, knn_obs_flat_exact=TUNED_ITERS * TUNED_STEPS)
    assert launches == expected, f"launches {launches}, expected {expected}"
    _physics_path("4j tuned flagship training", times["physics_launches"],
                  TUNED_ITERS * TUNED_STEPS)
    for tag, model in trainer.models.items():
        opts = trainer.update_options[tag]
        assert model.dtype == torch.bfloat16, tag
        assert trainer._batch[f"obs_{tag}"].dtype == torch.bfloat16, tag
        assert (opts.num_minibatches, opts.shuffle) == (
            TUNED_MINIBATCHES, False), opts
        assert trainer.optimizers[tag].count == \
            TUNED_ITERS * TUNED_MINIBATCHES, tag
    steps = TUNED_ENVS * TUNED_STEPS
    later = trainer.phase_ms[1:]
    roll_ms = statistics.mean(r for r, _ in later)
    upd_ms = statistics.mean(u for _, u in later)
    print(f"tuned flagship training: {TUNED_ITERS} iterations of "
          f"{TUNED_ENVS} envs x {TUNED_STEPS} steps x "
          f"{trainer.engine.n_agents} agents, {TUNED_MINIBATCHES} contiguous "
          f"minibatches of {TUNED_ENVS // TUNED_MINIBATCHES} envs a policy, "
          f"bf16 model and batch, in {times['train_s']:.3f} s (setup "
          f"{times['setup_s']:.3f} s), peak device memory {peak_gib:.2f} "
          f"GiB; iterations 2-{TUNED_ITERS}, mean: rollout {roll_ms:.3f} ms, "
          f"update {upd_ms:.3f} ms, "
          f"{steps / ((roll_ms + upd_ms) / 1e3):.0f} env-steps/s; launches "
          f"{launches}")

    knn_obs.reset_launch_counts()
    prof = trainer.profile_phases(repeats=TUNED_PROFILE_REPEATS)
    # (1 + repeats) iterations, (1 + repeats) rollouts and one rollout for
    # the update's batch; the updates launch none
    rollouts = 2 * (1 + TUNED_PROFILE_REPEATS) + 1
    expected = dict(no_launches, knn_obs_flat_exact=rollouts * TUNED_STEPS)
    assert dict(knn_obs.LAUNCH_COUNTS) == expected, knn_obs.LAUNCH_COUNTS
    print("tuned flagship profile_phases: " + ", ".join(
        f"{key} {prof[key]:.3f}" for key in (
            "iteration_ms", "rollout_ms", "update_ms", "update_ms_residual",
            "steps_per_sec", "rollout_steps_per_sec"))
        + "; repeats: iteration "
        + ", ".join(f"{ms:.3f}" for ms in prof["iteration_ms_repeats"])
        + "; rollout "
        + ", ".join(f"{ms:.3f}" for ms in prof["rollout_ms_repeats"])
        + "; update "
        + ", ".join(f"{ms:.3f}" for ms in prof["update_ms_repeats"]))

    rec, rec_launches, rec_times = _drive_training(_tuned_config(1, True))
    expected = dict(no_launches, knn_obs_flat_exact=TUNED_STEPS + len(
        rec.policies_to_train) * TUNED_MINIBATCHES)
    assert rec_launches == expected, \
        f"launches {rec_launches}, expected {expected}"
    _physics_path("4j tuned flagship, update_recompute_obs",
                  rec_times["physics_launches"], TUNED_STEPS)
    batch = rec._batch
    assert not any(key.startswith("obs_") for key in batch)
    phys_gb = sum(v.numel() * v.element_size()
                  for v in batch["phys"].values()) / 1e9
    obs_gb = sum(v.numel() * v.element_size()
                 for k, v in trainer._batch.items()
                 if k.startswith("obs_")) / 1e9
    rec_roll, rec_upd = rec.phase_ms[0]
    print(f"tuned flagship, update_recompute_obs: 1 iteration in "
          f"{rec_times['train_s']:.3f} s, rollout {rec_roll:.3f} ms, update "
          f"{rec_upd:.3f} ms; recorded state {phys_gb:.3f} GB in place of "
          f"{obs_gb:.3f} GB of bf16 observations; launches {rec_launches}")
    return trainer, rec, launches, rec_launches, {
        "rollout_ms": roll_ms, "update_ms": upd_ms, "profile": prof}


def _options_check_config(**trainer):
    """The small TagContinuous of the update options' CPU tests, on K1."""
    from warpdrive_tpu_torch.utils.config import load_run_config

    cfg = load_run_config("tag_continuous")
    cfg["env"].update({"num_taggers": 2, "num_runners": 8,
                       "episode_length": 20, "num_other_agents_observed": 4,
                       "knn_algorithm": "pallas_flat_exact"})
    cfg["trainer"].update({
        "num_envs": OPTIONS_CHECK_ENVS,
        "train_batch_size": OPTIONS_CHECK_ENVS * OPTIONS_CHECK_STEPS,
        "num_episodes": 40, "seed": 3, **trainer})
    for tag in ("runner", "tagger"):
        cfg["policy"][tag]["model"]["fc_dims"] = [16, 16]
    return cfg


def _check_update_options(tuned):
    """The update options on the card at a small size: minibatched updates
    (contiguous, PPO over 2 epochs x 2 shuffled minibatches with an
    injected table) card against CPU within ``UPDATE_PARAM_TOL``; remat
    against none and recompute against store (float32 batch) on the card,
    bit for bit; the bf16 model card against CPU, bit for bit at the small
    size, and at full width on the first 5 envs of the ``tuned`` trainer's
    last batch (50,000 rows), with freshly initialised weights, as the CPU
    tests hold it, and with the trained runner's: each head (each logit
    head, the value) within ``BF16_NORMWISE`` of that head's largest
    magnitude."""
    import numpy as np
    import torch

    from warpdrive_tpu_torch.algos.policygradient import PPO
    from warpdrive_tpu_torch.models.fully_connected import FullyConnected
    from warpdrive_tpu_torch.training.scripts.train import setup_trainer
    from warpdrive_tpu_torch.training.trainer_a2c import (
        ClippedAdam,
        UpdateOptions,
        policy_update,
    )

    results_dir = tempfile.mkdtemp(prefix="chip_smoke_options_")
    try:
        store = setup_trainer(_options_check_config(),
                              results_dir=results_dir, verbose=False,
                              device=DEVICE)
        rec = setup_trainer(_options_check_config(update_recompute_obs=True),
                            results_dir=results_dir, verbose=False,
                            device=DEVICE)
    finally:
        shutil.rmtree(results_dir, ignore_errors=True)
    for tag in rec.models:  # the same parameters on both
        rec.models[tag].load_state_dict(store.models[tag].state_dict())
    batch, rec_batch = store._rollout(), rec._rollout()
    assert torch.equal(batch["done"], rec_batch["done"])
    E = OPTIONS_CHECK_ENVS
    table = torch.from_numpy(np.stack(
        [np.random.RandomState(e).permutation(E) for e in range(2)]
    ).reshape(4, E // 2))

    def update(tag, device, options, algo=None, policy_batch=None,
               observe=None, index_table=None):
        model = copy.deepcopy(store.models[tag]).to(device)
        opt = ClippedAdam(dict(model.named_parameters()),
                          max_norm=store.optimizers[tag].max_norm)
        opt.load_state_dict(store.optimizers[tag].state_dict())
        policy_batch = policy_batch or store._policy_batch(batch, tag)
        policy_update(
            model, opt, algo or store.algorithms[tag],
            {k: v.to(device) if torch.is_tensor(v) else v
             for k, v in policy_batch.items()},
            0, store.lr_schedules[tag].value_at(0), options=options,
            index_table=index_table, observe=observe)
        return {k: v.detach().cpu() for k, v in model.state_dict().items()}

    def diff(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    tuned_obs = tuned._batch["obs_runner"][:, :5].to(torch.float32)
    trained = tuned.models["runner"]
    fresh = FullyConnected(tuned_obs.shape[-1], trained.fc_dims,
                           trained.output_dims,
                           generator=torch.Generator().manual_seed(0))
    # (label, observations, weights, bit for bit)
    bf16_cases = [
        ("runner, small", batch["obs_runner"], store.models["runner"], True),
        ("tuned width, fresh weights", tuned_obs, fresh, False),
        ("tuned width, the trained runner", tuned_obs, trained, False)]
    ppo = PPO(clip_param=0.1, discount_factor_gamma=0.98, vf_loss_coeff=1,
              entropy_coeff=0.05)
    cases = {
        "contiguous": (UpdateOptions(num_minibatches=4), None, None),
        "PPO 2 epochs x 2 shuffled, injected table": (
            UpdateOptions(num_epochs=2, num_minibatches=2, shuffle=True), ppo,
            table),
    }
    for tag in store.policies_to_train:
        card = {}
        for label, (opts, algo, idx) in cases.items():
            card[label] = update(tag, DEVICE, opts, algo, index_table=idx)
            worst = diff(card[label], update(tag, "cpu", opts, algo,
                                             index_table=idx))
            print(f"update option card vs CPU [{tag}, {label}]: max abs "
                  f"parameter diff {worst:.3g} (tolerance "
                  f"{UPDATE_PARAM_TOL})")
            assert worst <= UPDATE_PARAM_TOL, f"{tag} {label}: {worst}"
        pairs = {
            "remat vs none": (
                update(tag, DEVICE, UpdateOptions(num_minibatches=4,
                                                  remat=True)),
                card["contiguous"]),
        }
        observe = rec._observe_policy(tag)
        rec_policy = rec._policy_batch(rec_batch, tag)
        for label, opts in (("whole batch", UpdateOptions()),
                            ("4 minibatches", UpdateOptions(
                                num_minibatches=4))):
            pairs[f"recompute vs store, {label}"] = (
                update(tag, DEVICE, opts, policy_batch=rec_policy,
                       observe=observe),
                update(tag, DEVICE, opts))
        for label, (a, b) in pairs.items():
            worst = diff(a, b)
            print(f"update option on the card [{tag}, {label}]: max abs "
                  f"parameter diff {worst:.3g} (bit for bit required)")
            assert worst == 0.0, f"{tag} {label}: {worst}"

    for label, obs, model, exact in bf16_cases:
        outs = {}
        for device in (DEVICE, "cpu"):
            bf16 = FullyConnected(obs.shape[-1], model.fc_dims,
                                  model.output_dims, dtype=torch.bfloat16,
                                  device=device)
            bf16.load_state_dict(model.state_dict())
            with torch.no_grad():
                heads, value = bf16(obs.to(device))
            outs[device] = [out.cpu() for out in (*heads, value)]
        for i, (card, cpu) in enumerate(zip(outs[DEVICE], outs["cpu"])):
            head = f"head {i}" if i < len(outs["cpu"]) - 1 else "value"
            assert card.dtype == torch.float32
            largest = float(cpu.abs().max())
            bound = 0.0 if exact else BF16_NORMWISE * largest
            worst = float((card - cpu).abs().max())
            print(f"bf16 model card vs CPU [{label}, obs "
                  f"{tuple(obs.shape)}, {head}]: max abs diff {worst:.3g}, "
                  f"entries differing {int((card != cpu).sum())} of "
                  f"{card.numel()}, largest output {largest:.4g} "
                  + ("(bit for bit required)" if exact else
                     f"(tolerance {bound:.3g}: {BF16_NORMWISE:.4g} of it)"))
            assert worst <= bound, \
                f"bf16 model [{label}, {head}]: {worst} > {bound}"


def _iters_config(name, iters, **env):
    """A shipped run config (its env updated by ``env``) for ``iters``
    training iterations, trainer seed 0."""
    from warpdrive_tpu_torch.utils.config import load_run_config

    cfg = load_run_config(name)
    cfg["env"].update(env)
    trainer_cfg = cfg["trainer"]
    trainer_cfg["num_episodes"] = (iters * trainer_cfg["train_batch_size"]
                                   // cfg["env"]["episode_length"])
    trainer_cfg["seed"] = 0
    return cfg


def _training_means(trainer):
    """Mean rollout ms, update ms and env-steps/s of iterations 2 on."""
    steps = trainer.training_batch_size_per_env * trainer.num_envs
    later = trainer.phase_ms[1:]
    roll_ms = statistics.mean(r for r, _ in later)
    upd_ms = statistics.mean(u for _, u in later)
    return roll_ms, upd_ms, steps / ((roll_ms + upd_ms) / 1e3)


def _drive_asymmetric_pursuit():
    """Phase 4k: the shipped ``asymmetric_pursuit`` run config at full
    width -- separate per-policy placeholders, the evaders' Dict
    observations with an ``action_mask`` key. The CUDA step against the CPU
    step over ``FULL_STEP_STATES`` rolled states (``loc``, every observation
    key and the rewards within ``NEW_STEP_TOL``, integer arrays equal);
    ``NEW_TRAIN_ITERS`` iterations through ``setup_trainer`` and
    ``train()`` with no kNN launch and, over every rollout step, no evader
    action on a 0 of its mask; one update of both policies on the card
    against the CPU; ``evaluate_episodes``' per-policy sums.  Returns the
    trainer, its launches and its means."""
    import numpy as np
    import torch

    from warpdrive_tpu_torch.envs.asymmetric_pursuit import (
        TorchAsymmetricPursuit,
    )
    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.tools.consistency import step_against_cpu

    cfg = _iters_config("asymmetric_pursuit", NEW_TRAIN_ITERS)
    E = cfg["trainer"]["num_envs"]
    engines = []
    for device in (DEVICE, "cpu"):
        env = TorchAsymmetricPursuit(**cfg["env"])
        engines.append(EnvEngine(
            env_obj=env, num_envs=E, seed=0, device=device,
            policy_tag_to_agent_id_map=env.policy_map(),
            create_separate_placeholders_for_each_policy=True))
    diffs = step_against_cpu(*engines, steps=FULL_STEP_STATES)
    print(f"CUDA step vs CPU step [asymmetric_pursuit], {FULL_STEP_STATES} "
          f"states at {E} envs: max abs diff "
          + ", ".join(f"{k} {v:.3g}" for k, v in sorted(diffs.items()))
          + f" (tolerance {NEW_STEP_TOL}); integer arrays equal")
    assert max(diffs.values()) <= NEW_STEP_TOL, diffs

    masked = []

    def count_masked(trainer):
        # train() on the card runs the captured rollout
        assert trainer._programmed
        rollout = trainer._rollout_programmed

        def checked():
            batch = rollout()
            chosen = batch["mask_evader"].gather(
                3, batch["actions_evader"].long())
            masked.append(((chosen == 0).sum(), chosen.numel()))
            return batch

        trainer._rollout_programmed = checked

    trainer, launches, times = _drive_training(cfg, count_masked)
    assert launches == {name: 0 for name in knn_obs.LAUNCH_COUNTS}, launches
    assert times["physics_launches"] == 0, times
    assert trainer.num_iters == NEW_TRAIN_ITERS
    n_masked = int(sum(int(m) for m, _ in masked))
    draws = sum(n for _, n in masked)
    T = trainer.training_batch_size_per_env
    print(f"masked-action gate [asymmetric_pursuit evaders]: {n_masked} "
          f"draws on a masked move of {draws} ({len(masked)} rollouts of "
          f"{T} steps x {E} envs x 3 evaders)")
    assert n_masked == 0 and draws == NEW_TRAIN_ITERS * T * E * 3
    _update_card_vs_cpu(trainer)
    rew, _ = trainer.evaluate_episodes()
    assert rew["pursuer"].shape == (E, 2) and rew["evader"].shape == (E, 3)
    assert all(np.isfinite(r).all() for r in rew.values())
    roll_ms, upd_ms, rate = means = _training_means(trainer)
    print(f"training asymmetric_pursuit: {trainer.num_iters} iterations of "
          f"{E} envs x {T} steps x 5 agents in {times['train_s']:.3f} s "
          f"(setup {times['setup_s']:.3f} s); iterations "
          f"2-{trainer.num_iters}, mean: rollout {roll_ms:.3f} ms, update "
          f"{upd_ms:.3f} ms, {rate:.0f} env-steps/s; evaluate_episodes sums "
          f"pursuer {rew['pursuer'].shape} mean "
          f"{float(rew['pursuer'].mean()):.4f}, evader "
          f"{rew['evader'].shape} mean {float(rew['evader'].mean()):.4f}; "
          f"launches {launches}")
    torch.cuda.synchronize()
    return trainer, launches, means


def _drive_full_obs_training():
    """Phase 4l: the shipped ``tag_continuous`` run config with
    ``use_full_observation`` (110 agents, 7 x 109 + 1 = 764 features, no
    kNN): the CUDA step against the CPU step over ``FULL_STEP_STATES``
    rolled states (observations within ``NEW_STEP_TOL``, physics within
    1e-5); ``NEW_TRAIN_ITERS`` iterations through ``setup_trainer`` and
    ``train()`` with no kNN launch, the device's peak memory read around
    them; one update on the card and on the CPU on the first
    ``FULL_OBS_UPDATE_ENVS`` envs, each held to the CPU's float64 update
    (``_update_card_vs_cpu``).  Returns the trainer, its launches and its
    means."""
    import torch

    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
    from warpdrive_tpu_torch.ops import knn_obs

    cfg = _iters_config("tag_continuous", NEW_TRAIN_ITERS,
                        use_full_observation=True)
    E = cfg["trainer"]["num_envs"]
    systems = []
    for device in (DEVICE, "cpu"):
        env = TorchTagContinuous(**cfg["env"])
        engine = EnvEngine(env_obj=env, num_envs=E, seed=0, device=device)
        systems.append({"engine": engine, "env": env,
                        "state": dict(engine.state)})
    assert systems[0]["env"].obs_size == 764
    knn_obs.reset_launch_counts()
    _check_step_against_cpu(*systems, "tag_continuous, full observation",
                            steps=FULL_STEP_STATES)
    assert sum(knn_obs.LAUNCH_COUNTS.values()) == 0

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer, launches, times = _drive_training(cfg)
    peak = torch.cuda.max_memory_allocated()
    assert launches == {name: 0 for name in knn_obs.LAUNCH_COUNTS}, launches
    T = trainer.training_batch_size_per_env
    _physics_path("4l tag_continuous, full observation",
                  times["physics_launches"], trainer.num_iters * T)
    obs_bytes = sum(v.numel() * v.element_size()
                    for k, v in trainer._batch.items()
                    if k.startswith("obs_"))
    roll_ms, upd_ms, rate = means = _training_means(trainer)
    print(f"training tag_continuous, full observation: "
          f"{trainer.num_iters} iterations of {E} envs x {T} steps x "
          f"{trainer.engine.n_agents} agents x 764 features in "
          f"{times['train_s']:.3f} s (setup {times['setup_s']:.3f} s); "
          f"iterations 2-{trainer.num_iters}, mean: rollout {roll_ms:.3f} "
          f"ms, update {upd_ms:.3f} ms, {rate:.0f} env-steps/s; observation "
          f"batch {obs_bytes / 1e9:.3f} GB; device memory peak "
          f"{peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB above the "
          f"{base / 1e9:.3f} GB allocated before) of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} "
          f"GB; launches {launches}")
    _update_card_vs_cpu(trainer, envs=FULL_OBS_UPDATE_ENVS, float64=True)
    return trainer, launches, means


def _chem_configs() -> dict:
    """tests/test_chem_search.py's configs: one atom on an 8 x 8 synthetic
    landscape with the z-slab 2-6 (2-D and 3-D modes), two atoms on a
    random 6 x 6 x 3 mesh."""
    import numpy as np

    from warpdrive_tpu_torch.envs.chem_search import make_synthetic_landscape

    def one_atom(is_3d):
        return {"ienergy": 0.5, "max_denergy": 2.0, "nx": 8, "ny": 8,
                "nz": 8, "z_slab_lower": 2, "z_slab_upper": 6,
                "initial_state": [1, 1, 3],
                "final_state": [6, 6, 4 if is_3d else 3],
                "terminate_reward": 10.0, "min_reward": -1.0,
                "episode_length": 25,
                "en_array": make_synthetic_landscape(8, 8, 4, seed=4)}

    en6 = np.random.RandomState(8).uniform(
        -1.0, 1.0, size=(6, 6, 3, 6, 6, 3)).astype(np.float32)
    two_atom = {"ienergy": 0.2, "max_denergy": 2.0, "nx": 6, "ny": 6,
                "nz": 6, "z_slab_lower": 1, "z_slab_upper": 4,
                "initial_state": [1, 1, 2, 4, 4, 2],
                "final_state": [5, 5, 2, 0, 0, 2], "terminate_reward": 10.0,
                "min_reward": -1.0, "episode_length": 20, "en_array": en6}
    return {
        "one atom, 2-D": ("SingleAgentOneAtomChemSearch", one_atom(False)),
        "one atom, 3-D": ("SingleAgentOneAtomChemSearch", one_atom(True)),
        "two atoms": ("SingleAgentTwoAtomChemSearch", two_atom),
        "DummyEnv": ("DummyEnv", {"num_agents": 5, "episode_length": 10,
                                  "target": 16}),
    }


def _check_chem_and_dummy_steps():
    """Phase 4m: the chem-search envs and DummyEnv, the CUDA step against
    the CPU step over ``FULL_STEP_STATES`` rolled states at ``CHEM_ENVS``
    envs: positions (and every integer array) equal, observations and
    rewards within ``NEW_STEP_TOL``; no kNN launch."""
    from warpdrive_tpu_torch.envs import register_all_envs
    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.tools.consistency import step_against_cpu
    from warpdrive_tpu_torch.utils.env_registrar import env_registrar

    register_all_envs()
    knn_obs.reset_launch_counts()
    for label, (env_name, settings) in _chem_configs().items():
        cls = env_registrar.get(env_name, backend="torch")
        engines = [EnvEngine(env_obj=cls(**settings), num_envs=CHEM_ENVS,
                             seed=3, device=device)
                   for device in (DEVICE, "cpu")]
        (diffs, secs) = _timed(lambda: step_against_cpu(
            *engines, steps=FULL_STEP_STATES))
        print(f"CUDA step vs CPU step [{label}], {FULL_STEP_STATES} states "
              f"at {CHEM_ENVS} envs in {secs:.3f} s: max abs diff "
              + ", ".join(f"{k} {v:.3g}" for k, v in sorted(diffs.items()))
              + f" (tolerance {NEW_STEP_TOL}); positions and integer "
              "arrays equal")
        assert max(diffs.values()) <= NEW_STEP_TOL, diffs
    assert sum(knn_obs.LAUNCH_COUNTS.values()) == 0
    return {name: 0 for name in knn_obs.LAUNCH_COUNTS}


def _drive_item9(pendulum, tag_trainer):
    """Evaluation and episode fetching on the card, each with the kernels'
    launch counts set to 0 just before and read just after:
    ``evaluate_episodes`` of the Pendulum DDPG trainer (no kNN launch) and
    of the ``tag_continuous`` A2C trainer at full width, then that
    trainer's ``fetch_episode_states`` and ``fetch_logged_episode`` of
    ``loc_x``, ``loc_y`` and ``still_in_the_game`` (a contiguous log mask),
    each making exactly one K2 launch a step.  Returns the launches of the
    ``tag_continuous`` episodes."""
    import numpy as np

    from warpdrive_tpu_torch.ops import knn_obs

    no_launches = {name: 0 for name in knn_obs.LAUNCH_COUNTS}
    knn_obs.reset_launch_counts()
    (rew, steps), secs = _timed(pendulum.evaluate_episodes)
    assert dict(knn_obs.LAUNCH_COUNTS) == no_launches
    T = pendulum.engine.episode_length
    assert rew["shared"].shape == (pendulum.num_envs, 1)
    assert np.isfinite(rew["shared"]).all()
    assert (steps["shared"] == T - 1).all(), "Pendulum is done at its end"
    print(f"evaluate_episodes [single_pendulum, {pendulum.num_envs} envs x "
          f"{T} steps]: {secs:.3f} s, {pendulum.num_envs * T / secs:.0f} "
          f"env-steps/s; mean episodic reward "
          f"{float(rew['shared'].mean()):.3f}; no kNN launch")

    T = tag_trainer.engine.episode_length
    one_a_step = dict(no_launches, knn_obs_mxu=T)
    total = dict(no_launches)
    names = ["loc_x", "loc_y", "still_in_the_game"]
    runs = (
        ("evaluate_episodes", tag_trainer.evaluate_episodes),
        ("fetch_episode_states", lambda: tag_trainer.fetch_episode_states(
            names, env_id=0, include_rewards_actions=True,
            include_probabilities=True)),
        ("fetch_logged_episode",
         lambda: tag_trainer.fetch_logged_episode(env_id=0)),
    )
    for label, run in runs:
        knn_obs.reset_launch_counts()
        out, secs = _timed(run)
        launches = dict(knn_obs.LAUNCH_COUNTS)
        assert launches == one_a_step, f"{label}: launches {launches}"
        total = {k: total[k] + v for k, v in launches.items()}
        if label == "evaluate_episodes":
            rew, steps = out
            assert all(np.isfinite(r).all() for r in rew.values())
            detail = ", ".join(
                f"{tag} mean reward {float(rew[tag].mean()):.4f}"
                for tag in sorted(rew))
            detail += f", mean steps {float(steps['runner'].mean()):.1f}"
        else:
            assert sorted(k for k in out if k in names) == sorted(names)
            lengths = {out[n].shape[0] for n in names}
            assert len(lengths) == 1 and 2 <= lengths.pop() <= T + 1
            assert all(np.isfinite(out[n]).all() for n in names)
            detail = f"{out['loc_x'].shape[0]} logged steps, shapes " + \
                ", ".join(f"{n} {out[n].shape}" for n in names)
        print(f"{label} [tag_continuous, {tag_trainer.num_envs} envs x "
              f"{tag_trainer.engine.n_agents} agents, episode {T}]: "
              f"{secs:.3f} s, {1e3 * secs / T:.3f} ms a step; {detail}; "
              f"launches {launches}")
    return total


def _check_ddpg_resume(straight):
    """``save_full_state`` after 2 iterations of ``single_pendulum``, a
    fresh trainer of other seeds (other nets, draws, initial state and
    pool) ``load_full_state`` and ``train()`` for the last 2, against
    ``straight``, which ran the 4 through ``train()``:
    nets, targets (within ``RESUME_PARAM_TOL``) and Adam counts.  Prints
    whether they are equal bit for bit."""
    from warpdrive_tpu_torch.training.scripts.train import setup_trainer

    dirs = [tempfile.mkdtemp(prefix="chip_smoke_resume_") for _ in range(2)]
    try:
        cfg = _ddpg_config("single_pendulum")
        first = setup_trainer(cfg, results_dir=dirs[0], verbose=False,
                              device=DEVICE)
        for _ in range(2):
            first._iteration(first.current_timestep)
            first.current_timestep += first.train_batch_size
            first.iters_completed += 1
        path = first.save_full_state()
        cfg = _ddpg_config("single_pendulum")
        cfg["trainer"]["seed"] = cfg["env"]["seed"] = 1
        resumed = setup_trainer(cfg, results_dir=dirs[1], verbose=False,
                                device=DEVICE)
        resumed.load_full_state(path)
        resumed.train()
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    assert resumed.iters_completed == straight.iters_completed
    diff = _nets_diff(_ddpg_nets(resumed), _ddpg_nets(straight))
    windows = max(float((v.float() - straight._window[k].float()).abs().max())
                  for k, v in resumed._window.items())
    print(f"full-state resume [single_pendulum, 2 + 2 iterations vs 4]: max "
          f"abs diff of nets and targets {diff:.3g} (tolerance "
          f"{RESUME_PARAM_TOL}), of the replay window {windows:.3g}; bit for "
          f"bit: {diff == 0.0 and windows == 0.0}")
    assert diff <= RESUME_PARAM_TOL, f"resumed nets differ by {diff}"


def _flagship_trainer(system):
    """A ``TrainerA2C`` over the flagship ``system``'s engine (two A2C
    policies with its widths) holding the preset's own parameters: what a
    user exports bundles from."""
    from warpdrive_tpu_torch.training.trainer_a2c import TrainerA2C

    fc = list(system["models"]["runner"].fc_dims)
    E = system["num_envs"]
    config = {
        "name": "flagship_serving",
        "trainer": {"num_envs": E, "train_batch_size": E,
                    "num_episodes": E, "seed": 0},
        "policy": {tag: {"to_train": True, "algorithm": "A2C",
                         "model": {"type": "fully_connected",
                                   "fc_dims": fc}}
                   for tag in ("runner", "tagger")},
        "saving": {},
    }
    trainer = TrainerA2C(
        env_wrapper=system["engine"], config=config,
        policy_tag_to_agent_id_map={t: v.tolist() for t, v in
                                    system["policy_ids"].items()},
        results_dir=tempfile.mkdtemp(prefix="chip_smoke_serving_"),
        verbose=False)
    for tag, model in trainer.models.items():
        model.load_state_dict(system["models"][tag].state_dict())
    return trainer


def _drive_serving(pendulum, card):
    """Phase 4n: serving at full width.  The flagship (1024 envs x 105
    agents, fc (256, 256), K1) exports its runner and tagger policies to
    bundles (``serving.export_policy``), each loaded back on the card
    (``load_policy``); for ``SERVING_STEPS`` steps the K1 observation batch
    of the rolled state is answered by both bundles' ``act(argmax=True)``
    and every action must equal the preset's own argmax from the same
    parameters bit for bit (102,400 runner and 5,120 tagger requests a
    step); ``act(argmax=False)`` draws only in-range actions and, on one
    state repeated ``SERVING_DRAWS`` times, each head's frequencies lie
    within 5 sigma of its softmax; the DDPG actor of ``single_pendulum``
    serves exactly the trainer's noise-free actions.  Prints the ms per
    request batch (CUDA events).  Returns the launches, counted from 0 just
    before the requests: one K1 launch a step to serve, one to roll."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.presets import build_flagship
    from warpdrive_tpu_torch.serving import export_policy, load_policy

    t0 = time.perf_counter()
    system = build_flagship(num_envs=NUM_ENVS, fc_dims=FC_DIMS, seed=0,
                            device=DEVICE)
    trainer = _flagship_trainer(system)
    bundles = tempfile.mkdtemp(prefix="chip_smoke_bundles_")
    try:
        acts = {}
        for tag in ("runner", "tagger"):
            export_policy(trainer, tag, str(Path(bundles) / tag))
            acts[tag], manifest = load_policy(str(Path(bundles) / tag),
                                              device=DEVICE)
            assert manifest["fc_dims"] == list(FC_DIMS)
        pendulum_act, _ = load_policy(
            export_policy(pendulum, "shared", str(Path(bundles) / "ddpg")),
            device=DEVICE)
    finally:
        shutil.rmtree(bundles, ignore_errors=True)
    engine, models = system["engine"], system["models"]
    ids = {t: torch.as_tensor(v, dtype=torch.long, device=DEVICE)
           for t, v in system["policy_ids"].items()}
    generator = torch.Generator(device=DEVICE)
    generator.manual_seed(0)
    state = system["state"]
    knn_obs.reset_launch_counts()
    requests = {tag: 0 for tag in ids}
    with torch.no_grad():
        for _ in range(SERVING_STEPS):
            obs_all = engine.observe(state)
            for tag, idx in ids.items():
                obs_p = obs_all[:, idx]
                served = acts[tag](obs_p)
                logits_list, _ = models[tag](obs_p)
                want = torch.stack([lg.argmax(-1).to(torch.int32)
                                    for lg in logits_list], -1)
                assert served.dtype == torch.int32 and \
                    served.device.type == torch.device(DEVICE).type
                assert torch.equal(served, want), f"served {tag} differs"
                requests[tag] += obs_p.shape[0] * obs_p.shape[1]
            state = system["full_loop_step"](models, state, generator)
    torch.cuda.synchronize()
    launches = dict(knn_obs.LAUNCH_COUNTS)
    expected = {name: 0 for name in knn_obs.LAUNCH_COUNTS}
    expected["knn_obs_flat_exact"] = 2 * SERVING_STEPS
    assert launches == expected, f"launches {launches}"

    obs_all = engine.observe(state)
    times = {}
    for tag, idx in ids.items():
        obs_p = obs_all[:, idx].contiguous()
        times[tag] = _cuda_ms(lambda: acts[tag](obs_p), repeats=11, inner=20)
        draws = acts[tag](obs_p, generator=generator, argmax=False)
        heads = models[tag].output_dims
        for h, n in enumerate(heads):
            assert int(draws[..., h].min()) >= 0 and \
                int(draws[..., h].max()) < n, f"{tag} head {h} out of range"
        one = obs_p[:1, :1].expand(SERVING_DRAWS, 1, -1)
        draws = acts[tag](one, generator=generator, argmax=False)
        with torch.no_grad():
            logits_list, _ = models[tag](obs_p[:1, :1])
        worst = 0.0
        for h, (n, logits) in enumerate(zip(heads, logits_list)):
            p = torch.softmax(logits.reshape(-1).double(), -1)
            freq = torch.bincount(draws[:, 0, h].long(),
                                  minlength=n).double() / SERVING_DRAWS
            sigma = torch.sqrt(p * (1 - p) / SERVING_DRAWS)
            gap = float(((freq - p).abs() / sigma.clamp(min=1e-12)).max())
            worst = max(worst, gap)
            assert gap <= 5.0, f"{tag} head {h}: {gap:.2f} sigma"
        print(f"serving [{tag}]: {requests[tag]} requests over "
              f"{SERVING_STEPS} steps ({requests[tag] // SERVING_STEPS} a "
              f"step), every action equal to the preset's argmax bit for "
              f"bit; {times[tag]:.4f} ms per request batch of "
              f"{obs_p.shape[0]} x {obs_p.shape[1]} (act, argmax); draws "
              f"in range, {SERVING_DRAWS} draws on one state within "
              f"{worst:.2f} sigma of the softmax (bound 5)")

    obs_p, _ = pendulum._policy_obs_and_mask(pendulum.engine.state, None,
                                             "shared")
    with torch.no_grad():
        want = pendulum.nets["actor"]["shared"](obs_p)
    served = pendulum_act(obs_p)
    assert torch.equal(served, want), "the DDPG actor bundle differs"
    ddpg_ms = _cuda_ms(lambda: pendulum_act(obs_p), repeats=11, inner=20)
    print(f"serving [single_pendulum DDPG actor]: {obs_p.shape[0]} requests "
          f"equal to the trainer's noise-free actions bit for bit; "
          f"{ddpg_ms:.4f} ms per request batch; card {card}; phase 4n "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


def _artifact_config(artifact):
    """The artifact's ``run_config.json`` as given, its checkpoints named
    in each policy's ``model_ckpt_filepath``; TagContinuous observes
    through K2 (``pallas_mxu_exact``, whose exact order selects what
    ``passes`` selected in training)."""
    folder = Path(__file__).resolve().parent / "artifacts" / artifact
    cfg = json.loads((folder / "run_config.json").read_text())
    for tag, policy in cfg["policy"].items():
        model = policy["model"]
        if policy.get("algorithm") == "DDPG":
            model["model_ckpt_filepath"] = {
                net: str(next(folder.glob(f"{tag}_{net}_*.state_dict")))
                for net in ("actor", "critic")}
        else:
            model["model_ckpt_filepath"] = str(
                next(folder.glob(f"{tag}_[0-9]*.state_dict")))
    if cfg["name"] == "tag_continuous":
        cfg["env"]["knn_algorithm"] = "pallas_mxu_exact"
    return cfg


def _loaded_nets(card, cpu) -> dict:
    """``{label: (card module, CPU module)}`` of every net a checkpoint
    loads: the A2C models, DDPG's actors and critics."""
    if card.models:
        return {tag: (m, cpu.models[tag]) for tag, m in card.models.items()}
    return {f"{tag} {net}": (card.nets[net][tag], cpu.nets[net][tag])
            for net in ("actor", "critic") for tag in card.policies}


def _check_jax_checkpoints():
    """Phase 4o: the repo's JAX checkpoints (flax msgpack, read by the
    port's own codec) of ``artifacts/cartpole_a2c_cpu``,
    ``pendulum_ddpg_cpu`` and ``tag_continuous_cpu``, each trainer built
    from the artifact's ``run_config.json`` on the card and on the CPU:
    the loaded tensors equal on both; ``evaluate_episodes`` on both (mean
    returns and steps printed); on the states of the CPU's fetched episode
    (observed on the card through K2 for TagContinuous), the card's argmax
    actions equal the CPU's except where the CPU's top two logits lie
    within ``NEAR_TIE`` (counted), DDPG's actions within
    ``UPDATE_PARAM_TOL``.  Returns the launches, counted from 0 just before
    the card's runs."""
    import numpy as np
    import torch

    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.training.scripts.train import setup_trainer

    t0 = time.perf_counter()
    total = {name: 0 for name in knn_obs.LAUNCH_COUNTS}
    for artifact in JAX_ARTIFACTS:
        cfg = _artifact_config(artifact)
        dirs, trainers = [], {}
        try:
            for device in (DEVICE, "cpu"):
                dirs.append(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
                trainers[device] = setup_trainer(
                    copy.deepcopy(cfg), results_dir=dirs[-1], verbose=False,
                    device=device)
        finally:
            for d in dirs:
                shutil.rmtree(d, ignore_errors=True)
        card, cpu = trainers[DEVICE], trainers["cpu"]
        assert card.current_timestep == cpu.current_timestep > 0
        for label, (ours, theirs) in _loaded_nets(card, cpu).items():
            for key, value in ours.state_dict().items():
                assert torch.equal(value.cpu(), theirs.state_dict()[key]), \
                    f"{artifact} {label} {key}"

        knn_obs.reset_launch_counts()
        (rew, steps), card_s = _timed(card.evaluate_episodes)
        cpu_rew, cpu_steps = cpu.evaluate_episodes()
        names = [k for k in cpu.engine.state]
        episode = cpu.fetch_episode_states(names, env_id=0)
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in episode.items()}
        on_card = {k: v.to(DEVICE) for k, v in host.items()}
        split = card.engine.has_split_step
        obs_card = card.engine.observe(on_card) if split else None
        obs_cpu = cpu.engine.observe(host) if split else None
        torch.cuda.synchronize()
        launches = dict(knn_obs.LAUNCH_COUNTS)
        total = {k: total[k] + v for k, v in launches.items()}
        T = card.engine.episode_length
        expected = {name: 0 for name in knn_obs.LAUNCH_COUNTS}
        if split:
            expected["knn_obs_mxu"] = T + 1
        assert launches == expected, f"{artifact}: launches {launches}"

        near_ties = compared = 0
        worst = 0.0
        for tag in card.policies:
            ours = card._policy_obs_and_mask(on_card, obs_card, tag)[0]
            theirs = cpu._policy_obs_and_mask(host, obs_cpu, tag)[0]
            with torch.no_grad():
                if tag in card.models:
                    got = [lg.cpu() for lg in card.models[tag](ours)[0]]
                    want = cpu.models[tag](theirs)[0]
                else:
                    got = [card.nets["actor"][tag](ours).cpu()]
                    want = [cpu.nets["actor"][tag](theirs)]
            for g, w in zip(got, want):
                if tag not in card.models:
                    worst = max(worst, float((g - w).abs().max()))
                    compared += w.numel()
                    continue
                top2 = torch.topk(w, 2, dim=-1).values
                tie = (top2[..., 0] - top2[..., 1]) <= NEAR_TIE
                differ = g.argmax(-1) != w.argmax(-1)
                assert not bool((differ & ~tie).any()), \
                    f"{artifact} {tag}: actions differ outside near-ties"
                near_ties += int(tie.sum())
                compared += tie.numel()
        assert worst <= UPDATE_PARAM_TOL, f"{artifact}: DDPG {worst}"
        means = {tag: (float(rew[tag].mean()), float(cpu_rew[tag].mean()))
                 for tag in sorted(rew)}
        print(f"JAX checkpoint [{artifact}] (timestep "
              f"{card.current_timestep}) loaded on the card and the CPU, "
              f"tensors equal; evaluate_episodes on the card "
              f"{card_s:.3f} s: "
              + "; ".join(f"{tag} mean return card {c:.4f} / CPU {h:.4f}"
                          for tag, (c, h) in means.items())
              + f"; mean steps card "
              f"{float(next(iter(steps.values())).mean()):.2f} / CPU "
              f"{float(next(iter(cpu_steps.values())).mean()):.2f}; the "
              f"CPU episode's {host[names[0]].shape[0]} states: "
              f"{compared} actions compared, {near_ties} near-ties (CPU top "
              f"two within {NEAR_TIE}), DDPG max abs diff {worst:.3g}; "
              f"launches {launches}")
    print(f"phase 4o {time.perf_counter() - t0:.1f} s")
    return total


def _drive_eager_backend():
    """Phase 4p: the eager host-env backend.  ``single_cartpole`` at its
    run config's size (100 envs x 500 steps) with ``trainer.env_backend:
    cpp`` (``CpuEnvEngine(native=True)``: the C++ stepper on the host, the
    policy and update on the card) for 2 iterations through
    ``setup_trainer`` and ``train()``: finite losses, moved parameters, a
    checkpoint, no kNN launch; the C++ step against the Python loop over
    ``EAGER_STATES`` rolled states at that size (state within
    ``CLASSIC_STEP_TOL``, done flags equal); env-steps/s and the device's
    idle share over one more iteration.  Returns the launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from warpdrive_tpu_torch.envs.cpu_engine import CpuEnvEngine
    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.utils.constants import Constants

    t0 = time.perf_counter()
    cfg = _iters_config("single_cartpole", 2)
    cfg["trainer"]["env_backend"] = "cpp"
    trainer, launches, times = _drive_training(cfg)
    assert isinstance(trainer.engine, CpuEnvEngine)
    assert trainer.engine._native is not None
    assert launches == {name: 0 for name in knn_obs.LAUNCH_COUNTS}, launches
    assert times["physics_launches"] == 0, times
    E = trainer.num_envs
    T = trainer.training_batch_size_per_env

    # seeded: an unseeded env draws its own pool and starts
    engines = [CpuEnvEngine(env_name="ClassicControlCartPoleEnv",
                            env_config=dict(cfg["env"], seed=5), num_envs=E,
                            native=native, device=DEVICE)
               for native in (True, False)]
    assert engines[0]._native is not None and engines[1]._native is None
    rng = np.random.default_rng(0)
    worst, resets = 0.0, 0
    for _ in range(EAGER_STATES):
        actions = rng.integers(0, 2, (E, 1, 1)).astype(np.int32)
        fast, loop = (eng.step_all_envs(actions) for eng in engines)
        for key in (Constants.OBSERVATIONS, Constants.REWARDS):
            worst = max(worst, float((fast[key] - loop[key]).abs().max()))
        assert torch.equal(fast[Constants.DONE], loop[Constants.DONE])
        resets += int(loop[Constants.DONE].sum())
        for eng in engines:
            eng.reset_only_done_envs()
    assert worst <= CLASSIC_STEP_TOL, f"C++ vs Python loop {worst}"

    roll_ms, upd_ms, rate = _training_means(trainer)
    timestep = trainer.current_timestep
    torch.cuda.synchronize()
    start = time.perf_counter()
    trainer._iteration(timestep)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - start)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer._iteration(timestep)
        torch.cuda.synchronize()
    device_ms = _device_ms(prof)
    print(f"eager backend [single_cartpole, C++ stepper on the host, "
          f"{E} envs x {T} steps]: {trainer.num_iters} iterations in "
          f"{times['train_s']:.3f} s; iteration 2: rollout {roll_ms:.3f} ms, "
          f"update {upd_ms:.3f} ms, {rate:.0f} env-steps/s; one more "
          f"iteration {wall_ms:.3f} ms wall, {E * T / (wall_ms / 1e3):.0f} "
          f"env-steps/s, device {device_ms:.3f} ms (profiler), device idle "
          f"share {100 * (1 - device_ms / wall_ms):.1f}%; C++ step vs "
          f"Python loop over {EAGER_STATES} states at {E} envs: max abs "
          f"diff {worst:.3g} (tolerance {CLASSIC_STEP_TOL}), done flags "
          f"equal, {resets} resets; phase 4p "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


def _check_autoscaler_probes(system, generator):
    """Phase 4q: the auto-scaler's probe on the card, after the parent
    frees its allocator's cache.  The full-observation ``tag_continuous``
    config of 4l (250 steps an env) probed in a fresh subprocess at 100
    envs must fit, and at 2,000 envs (250 x 2000 x 110 x 764 x 4 B = 168 GB
    of observation batch alone) must fail with ``OutOfMemoryError`` in its
    output; then the parent still allocates and launches K1."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.tools.autoscaler import run_probe

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = _iters_config("tag_continuous", 1, use_full_observation=True)
    steps = cfg["trainer"]["train_batch_size"] // cfg["trainer"]["num_envs"]
    results = {}
    for envs in PROBE_ENVS:
        trial = copy.deepcopy(cfg)
        trial["trainer"]["num_envs"] = envs
        trial["trainer"]["train_batch_size"] = envs * steps
        results[envs] = run_probe(trial, device=DEVICE, timeout_s=600)
        last = [line for line in results[envs]["output"].splitlines()
                if line.startswith("PROBE_")]
        print(f"autoscaler probe [tag_continuous full observation, {envs} "
              f"envs x {steps} steps]: fits {results[envs]['fits']}, "
              f"{results[envs]['seconds']:.1f} s, "
              f"{last[-1][:200] if last else 'no PROBE line'}")
    fit, oom = (results[e] for e in PROBE_ENVS)
    assert fit["fits"] and fit["steps_per_sec"], fit["output"][-3000:]
    assert not oom["fits"] and "OutOfMemoryError" in oom["output"], \
        oom["output"][-3000:]

    knn_obs.reset_launch_counts()
    probe = torch.ones((1 << 28,), device=DEVICE)  # 1 GiB
    assert float(probe.sum()) == float(1 << 28)
    del probe
    checksum = torch.zeros((), device=DEVICE)
    system["state"], checksum = system["env_only_step"](
        (system["state"], checksum), generator)
    torch.cuda.synchronize()
    assert torch.isfinite(checksum)
    assert knn_obs.LAUNCH_COUNTS["knn_obs_flat_exact"] == 1
    print(f"autoscaler probes: the parent held {held / 1e9:.3f} GB after "
          f"freeing its cache; afterwards it allocated 1 GiB and launched "
          f"K1 (checksum finite); phase 4q {time.perf_counter() - t0:.1f} s")


# phase 4r: the shipped tag_continuous run config at full width over
# process meshes; this many iterations through train(), and the tolerance
# of a two-rank (or tensor-parallel) update against the one-process update
MULTI_ITERS = 2
MULTI_PARAM_TOL = 1e-5


def _multi_config():
    """The shipped ``tag_continuous`` run config (100 envs x 110 agents,
    250 steps an iteration, K2 ``pallas_mxu_exact``) for ``MULTI_ITERS``
    iterations, metrics at each."""
    from warpdrive_tpu_torch.utils.config import load_run_config

    cfg = load_run_config("tag_continuous")
    cfg["trainer"]["seed"] = 0
    T = cfg["trainer"]["train_batch_size"] // cfg["trainer"]["num_envs"]
    cfg["trainer"]["num_episodes"] = (MULTI_ITERS * T
                                      * cfg["trainer"]["num_envs"]
                                      // cfg["env"]["episode_length"])
    cfg["saving"]["metrics_log_freq"] = 1
    return cfg


def _host_params(trainer) -> dict:
    return {tag: {k: v.detach().cpu().clone()
                  for k, v in m.state_dict().items()}
            for tag, m in trainer.models.items()}


def _params_diff(a: dict, b: dict) -> float:
    return max(float((a[tag][k] - b[tag][k]).abs().max())
               for tag in a for k in a[tag])


def _row_digests(batch: dict, rows=None) -> dict:
    """An exact digest of every env row of each ``(T, E, ...)`` tensor of
    a rollout batch: the row's 32-bit words against fixed int64 weights,
    summed with wraparound; equal rows give equal digests."""
    import torch

    out = {}
    for key, x in sorted(batch.items()):
        if not isinstance(x, torch.Tensor):
            continue
        words = x.transpose(0, 1).contiguous().view(torch.int32)
        words = words.reshape(words.shape[0], -1).to(torch.int64)
        gen = torch.Generator().manual_seed(words.shape[1])
        weights = torch.randint(1, 2**62, (words.shape[1],), generator=gen,
                                dtype=torch.int64).to(words.device)
        out[key] = (words * weights).sum(dim=1).cpu()
        if rows is not None:
            out[key] = out[key][rows]
    return out


def _timed_iterations(trainer, mesh=None, n=2) -> dict:
    """``n`` iterations after ``train()``: the wall ms of each (the device
    caught up), their update ms (CUDA events) and, under a mesh, the ms
    the collectives took (the device caught up before and after each)."""
    from warpdrive_tpu_torch.parallel.mesh import GroupStats

    if mesh is not None:
        mesh.timed, mesh.stats = True, GroupStats()
    walls = []
    for _ in range(n):
        trainer._sync()
        t0 = time.perf_counter()
        trainer._iteration(trainer.current_timestep)
        trainer._sync()
        walls.append(1e3 * (time.perf_counter() - t0))
    trainer._resolve_phase_marks()
    update_ms = sum(u for _, u in trainer.phase_ms[-n:])
    out = {"iteration_ms": statistics.mean(walls), "update_ms": update_ms / n}
    if mesh is not None:
        out["collective_ms"] = 1e3 * mesh.stats.seconds / n
        out["collectives"] = dict(mesh.stats.calls)
        mesh.timed = False
    return out


def _multi_rank_gloo(device, cfg, results_dir, actions, digests, update):
    """4r (b), one of two gloo ranks on the card: replaying the recorded
    actions, the rank's rollout against its rows of the one-process
    rollout (digests); one update from the shared start against the
    one-process update; then ``train()`` and two timed iterations."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.training.scripts.train import setup_trainer

    import logging

    knn_obs.reset_launch_counts()
    # a gloo rank keeps the eager iteration and says so (4t (e))
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        trainer = setup_trainer(copy.deepcopy(cfg), num_devices=2,
                                results_dir=results_dir, verbose=False,
                                device=device)
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    eager = (not trainer._programmed
             and "program: eager (gloo process mesh)" in logged)
    batch = trainer._rollout(actions.to(device))
    got = _row_digests(batch)
    want = {k: v[trainer.env_rows] for k, v in digests.items()}
    mismatched = [k for k in want if not torch.equal(got[k], want[k])]
    assert not mismatched, f"rows of {mismatched} differ from one process"
    trainer._update(batch, 0)
    update_diff = _params_diff(_host_params(trainer), update)
    assert update_diff <= MULTI_PARAM_TOL, update_diff
    trainer.train()
    timed = _timed_iterations(trainer, trainer.mesh)
    return {"rows": (trainer.env_rows.start, trainer.env_rows.stop),
            "update_diff": update_diff, "params": _host_params(trainer),
            "iters": trainer.iters_completed, "timed": timed,
            "launches": dict(knn_obs.LAUNCH_COUNTS), "eager": eager}


def _multi_rank_tp(device, cfg, results_dir):
    """4r (c), one of a dp1 x tp2 pair on the card: one iteration from the
    seed."""
    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.training.scripts.train import setup_trainer

    knn_obs.reset_launch_counts()
    trainer = setup_trainer(copy.deepcopy(cfg), num_devices=2, tp=2,
                            results_dir=results_dir, verbose=False,
                            device=device)
    trainer._iteration(0)
    shards = {tag: {n: tuple(m.shape) for n, m in opt.mu.items()}
              for tag, opt in trainer.optimizers.items()}
    return {"params": _host_params(trainer), "shards": shards,
            "launches": dict(knn_obs.LAUNCH_COUNTS)}


def _drive_multi_device(card):
    """Phase 4r: the shipped ``tag_continuous`` run config at full width
    (100 envs x 110 agents, K2) over process meshes.

    (a) a one-rank NCCL group trains ``MULTI_ITERS`` iterations through
    the distributed path (the env cut, the SUM all-reduces, the global
    denominators and metrics), and its parameters equal the plain
    trainer's of the same seed bit for bit: a sum over one rank is the
    identity.  (b) two gloo ranks on the card, 50 envs each: replaying the
    one-process rollout's actions, each rank's rollout (through K2) is its
    rows of that rollout exactly; one update from the same start is within
    ``MULTI_PARAM_TOL`` of the one-process update; ``train()`` leaves the
    parameters equal on both ranks bit for bit, and only the lead has
    written results and checkpoints.  (c) a dp1 x tp2 pair on the card:
    one iteration within ``MULTI_PARAM_TOL`` of the unsharded one.  Then
    ``dryrun_multichip(4)`` on the card (a 2 x 2 mesh of gloo ranks; K1).
    Prints the NCCL version, the all-reduces an iteration runs, and ms per
    iteration of one process, the one-rank group and the two ranks with
    gloo's share of the update, beside the card.  Returns the launches
    of every rank, counted from 0 just before each run."""
    import torch
    import torch.distributed as dist

    from warpdrive_tpu_torch.entry import dryrun_multichip
    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.parallel.launch import free_port, launch
    from warpdrive_tpu_torch.parallel.mesh import initialize_multihost
    from warpdrive_tpu_torch.training.scripts.train import setup_trainer

    t0 = time.perf_counter()
    cfg = _multi_config()
    total = {name: 0 for name in knn_obs.LAUNCH_COUNTS}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_multi_"))
    try:
        # the plain trainer: the reference of (a), timed as one process
        plain = setup_trainer(copy.deepcopy(cfg), results_dir=str(tmp / "p"),
                              verbose=False, device=DEVICE)
        plain.train()
        plain_params = _host_params(plain)
        plain_timed = _timed_iterations(plain)
        _release_programs(plain)

        # (a) the one-rank NCCL group
        initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                             backend="nccl", device="cuda:0")
        try:
            knn_obs.reset_launch_counts()
            one = setup_trainer(copy.deepcopy(cfg), num_devices=1,
                                results_dir=str(tmp / "a"), verbose=False,
                                device=DEVICE)
            mesh = one.mesh
            mesh.stats.calls.clear()
            one.train()
            launches = dict(knn_obs.LAUNCH_COUNTS)
            reduces = mesh.stats.calls.get("all_reduce", 0)
            T = one.training_batch_size_per_env
            assert launches == dict({name: 0 for name in launches},
                                    knn_obs_mxu=MULTI_ITERS * T), launches
            for name, count in launches.items():
                total[name] += count
            diff = _params_diff(_host_params(one), plain_params)
            assert diff == 0.0, f"one-rank NCCL group vs plain: {diff}"
            assert dist.get_backend() == "nccl"
            assert mesh.world_size == 1
            one_timed = _timed_iterations(one, mesh)
        finally:
            dist.destroy_process_group()
        version = "NCCL " + ".".join(map(str, torch.cuda.nccl.version()))
        print(f"4r (a) one-rank NCCL group ({version}): "
              f"{MULTI_ITERS} iterations, parameters equal to the plain "
              f"trainer's bit for bit; {reduces / MULTI_ITERS:.0f} "
              f"all-reduces an iteration (with its log point), K2 launches "
              f"{launches['knn_obs_mxu']}")

        # (b) two gloo ranks sharing the card, against one process
        ref = setup_trainer(copy.deepcopy(cfg), results_dir=str(tmp / "r"),
                            verbose=False, device=DEVICE)
        start = _host_params(ref)
        batch = ref._rollout()
        actions = torch.zeros(
            (T, ref.num_envs, ref.engine.n_agents, 2), dtype=torch.int32)
        for tag, ids in ref.policy_tag_to_agent_id_map.items():
            actions[:, :, ids] = batch[f"actions_{tag}"].cpu()
        digests = _row_digests(batch)
        # the replay starts from the state as built: a fresh trainer
        ref = setup_trainer(copy.deepcopy(cfg), results_dir=str(tmp / "r2"),
                            verbose=False, device=DEVICE)
        assert _params_diff(_host_params(ref), start) == 0.0
        replayed = ref._rollout(actions.to(DEVICE))
        assert all(torch.equal(v, digests[k])
                   for k, v in _row_digests(replayed).items())
        ref._update(replayed, 0)
        update = _host_params(ref)
        del batch, replayed, ref
        torch.cuda.empty_cache()
        results = launch(_multi_rank_gloo, 2,
                         args=(cfg, str(tmp / "b"), actions, digests,
                               update),
                         device="cuda:0", backend="gloo", timeout_s=600)
        E = cfg["trainer"]["num_envs"]
        assert [r["rows"] for r in results] == [(0, E // 2), (E // 2, E)]
        assert _params_diff(results[0]["params"], results[1]["params"]) \
            == 0.0, "the two ranks' parameters differ"
        files = sorted(p.name for p in (tmp / "b").iterdir())
        ts = results[0]["iters"] * T * E
        assert files == sorted(["run_config.json", "results.json",
                                f"runner_{ts}.state_dict",
                                f"tagger_{ts}.state_dict"]), files
        with open(tmp / "b" / "results.json", encoding="utf-8") as f:
            records = f.read().splitlines()
        assert len(records) == MULTI_ITERS, records  # written once
        for r in results:
            for name, count in r["launches"].items():
                total[name] += count
        assert all(r["eager"] for r in results), \
            "a gloo rank ran programs or did not log that it is eager"
        print("4t (e) both gloo ranks logged 'program: eager (gloo process "
              "mesh)' and ran the eager iteration")
        two = results[0]["timed"]
        share = two["collective_ms"] / two["update_ms"]
        print(f"4r (b) two gloo ranks on one card, {E // 2} envs each: "
              f"rollouts "
              f"equal to their rows of one process's, update within "
              f"{max(r['update_diff'] for r in results):.3g} of one "
              f"process's, parameters equal on both ranks after train(); "
              f"lead-only files {files}; collectives an iteration "
              f"{two['collectives']}")

        # (c) a dp1 x tp2 pair against the unsharded iteration
        ref = setup_trainer(copy.deepcopy(cfg), results_dir=str(tmp / "c0"),
                            verbose=False, device=DEVICE)
        ref._iteration(0)
        unsharded = _host_params(ref)
        _release_programs(ref)
        del ref
        torch.cuda.empty_cache()
        tp = launch(_multi_rank_tp, 2, args=(cfg, str(tmp / "c")),
                    device="cuda:0", backend="gloo", timeout_s=600)
        tp_diff = max(_params_diff(r["params"], unsharded) for r in tp)
        assert tp_diff <= MULTI_PARAM_TOL, f"tp2 vs unsharded: {tp_diff}"
        assert _params_diff(tp[0]["params"], tp[1]["params"]) == 0.0
        cut = sum(s != tuple(unsharded[tag][n].shape)
                  for tag, shapes in tp[0]["shards"].items()
                  for n, s in shapes.items())
        assert cut > 0, "tp2 cut no parameter"
        for r in tp:
            for name, count in r["launches"].items():
                total[name] += count
        print(f"4r (c) dp1 x tp2 on one card: one iteration within "
              f"{tp_diff:.3g} of the unsharded one, {cut} parameters cut")

        # the dry run's three program shapes on a 2 x 2 mesh (K1)
        dry = dryrun_multichip(4, device="cuda:0", backend="gloo")
        for r in dry:
            for name, count in r["launches"].items():
                total[name] += count
        assert all(r["launches"]["knn_obs_flat_exact"] > 0 for r in dry), \
            [r["launches"] for r in dry]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"4r ms per iteration ({card}): one process "
          f"{plain_timed['iteration_ms']:.3f} (update "
          f"{plain_timed['update_ms']:.3f}); one-rank NCCL group "
          f"{one_timed['iteration_ms']:.3f} (update "
          f"{one_timed['update_ms']:.3f}, collectives "
          f"{one_timed['collective_ms']:.3f}); two gloo ranks on one card "
          f"{two['iteration_ms']:.3f} (update {two['update_ms']:.3f}, gloo "
          f"{two['collective_ms']:.3f} = {100 * share:.1f}% of the update); "
          f"phase 4r {time.perf_counter() - t0:.1f} s; launches {total}")
    return total


# phase 4s: the compiled iteration -- captured programs against the eager
# steps and iterations they replace, on identical carries and generator
# states: the flagship loops and the 1024-agent loop this many steps a
# turn, every side this many turns, and this many steps or passes in each
# profiled window
COMPILED_STEPS = 100
COMPILED_TURNS = 3
COMPILED_PROFILE_STEPS = 10
# the tuned stage's update passes in a profiled window (its whole update
# is ~1 M device events, too many for the profiler)
COMPILED_PROFILE_PASSES = 20
# windows of a profiled loop or program at most, each profiled again while
# the profiler recorded fewer kNN kernels than were launched
# (``_profiled_credited``)
PROFILE_WINDOWS = 3
# the tuned stage's iterations of each side, each timed (an eager one takes
# ~15 s: 800 passes of ~1,240 eager ops)
TUNED_COMPILED_ITERS = 2


def _profiled(fn, calls, host=True):
    """``fn()`` once as the profiler's warm-up step (not recorded: a
    window's first kernels can go missing), then ``calls`` x ``fn()``
    recorded, the device caught up before each step ends; with ``host``
    the host's activity too (an eager iteration's host ops are ~10^5
    events: the device's alone are cheaper to read).  Returns the device
    ms and the kNN kernels' launches the profiler recorded (by their
    device functions' names) and the launches the wrappers counted and the
    replays credited over the recorded calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from warpdrive_tpu_torch.ops import knn_obs

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        before = dict(knn_obs.LAUNCH_COUNTS)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
    counted = sum(knn_obs.launches_since(before).values())
    knn = sum(e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and any(name in e.key for name in _KERNEL_SYMBOLS))
    return _device_ms(prof), knn, counted


def _wall_ms(fn, calls=1):
    """Host ms of ``calls`` x ``fn()``, the device caught up before and
    after."""
    _, seconds = _timed(lambda: [fn() for _ in range(calls)])
    return 1e3 * seconds


def _trainer_carry(trainer) -> dict:
    """Every tensor an A2C iteration reads and writes, on the host side of
    a comparison: parameters, Adam moments and counts, the env state, the
    episodic accounting, the batch and the rollout generator's state."""
    import torch

    return {
        "models": {t: m.state_dict() for t, m in trainer.models.items()},
        "optimizers": {t: {"count": torch.tensor(o.count), "mu": o.mu,
                           "nu": o.nu}
                       for t, o in trainer.optimizers.items()},
        "env_state": trainer._env_state,
        "episodes": {"acc": trainer._ep_acc, "sum": trainer._ep_sum,
                     "count": trainer._ep_count},
        "batch": trainer._batch,
        "generator": trainer.generator.get_state(),
    }


def _flat(tree, path=""):
    import torch

    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flat(value, f"{path}/{key}")


def _assert_bitwise(label, a, b):
    """Two trees of tensors equal bit for bit (dtype, shape and values)."""
    import torch

    left, right = dict(_flat(a)), dict(_flat(b))
    assert left.keys() == right.keys(), \
        f"{label}: {left.keys() ^ right.keys()}"
    for path, x in left.items():
        y = right[path]
        same = (x.dtype == y.dtype and x.shape == y.shape
                and torch.equal(x.reshape(-1).view(torch.uint8)
                                if x.is_floating_point() else x,
                                y.reshape(-1).view(torch.uint8)
                                if y.is_floating_point() else y))
        assert same, f"{label}: {path} differs"
    return len(left)


def _compiled_loop(label, system, loop, start, kernel, steps):
    """One preset loop, eager against its captured form
    (``presets.captured_loop``) from the same state and generator state:
    ``steps`` steps each (the captured form's first call warms it up and
    captures it), compared bit for bit; then ``COMPILED_TURNS`` timed turns
    of ``steps`` steps each, in turns (eager, captured), compared again;
    then a profiled window of each, whose kNN launches the profiler counts
    against the credited ones.  Returns the launches, by kernel."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.presets import captured_loop

    def clone(state):
        return {k: v.clone() for k, v in state.items()}

    t0 = time.perf_counter()
    eager_gen = torch.Generator(device=DEVICE).manual_seed(7)
    state = {"state": clone(start),
             "checksum": torch.zeros((), device=DEVICE)}

    def eager():
        if loop == "env_only_step":
            state["state"], state["checksum"] = system[loop](
                (state["state"], state["checksum"]), eager_gen)
        else:
            state["state"] = system[loop](system["models"], state["state"],
                                          eager_gen)

    program = captured_loop(system, loop,
                            torch.Generator(device=DEVICE).manual_seed(7),
                            state=clone(start))
    total = dict.fromkeys(knn_obs.LAUNCH_COUNTS, 0)

    def counted(fn, n):
        knn_obs.reset_launch_counts()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        got = dict(knn_obs.LAUNCH_COUNTS)
        want = dict.fromkeys(got, 0)
        want[kernel] = n
        assert got == want, f"{label}: launches {got}, expected {want}"
        for name, count in got.items():
            total[name] += count

    def carry():
        return {k: program.buffers[k] for k in ("state", "checksum")}

    counted(eager, steps)
    counted(program, steps)
    compared = _assert_bitwise(label, carry(), state)
    walls = {"eager": [], "captured": []}
    for _ in range(COMPILED_TURNS):
        for mode, fn in (("eager", eager), ("captured", program)):
            knn_obs.reset_launch_counts()
            walls[mode].append(_wall_ms(fn, steps) / steps)
            for name, count in knn_obs.LAUNCH_COUNTS.items():
                total[name] += count
    _assert_bitwise(label, carry(), state)
    idle = {}
    profiled_steps = 1 + COMPILED_PROFILE_STEPS
    for mode, fn in (("eager", eager), ("captured", program)):
        knn_obs.reset_launch_counts()
        if mode == "eager":
            device_ms, profiled, _ = _profiled(
                fn, COMPILED_PROFILE_STEPS, host=False)
        else:
            device_ms, profiled, _, windows = _profiled_credited(
                label, fn, COMPILED_PROFILE_STEPS)
            # a window profiled again stepped the captured side on: the
            # eager side takes as many steps, for the comparison below
            for _ in range((windows - 1) * profiled_steps):
                eager()
            profiled_steps *= windows
        for name, count in knn_obs.LAUNCH_COUNTS.items():
            total[name] += count
        device_ms /= COMPILED_PROFILE_STEPS
        idle[mode] = (device_ms,
                      100 * (1 - device_ms / statistics.median(walls[mode])),
                      profiled)
    _assert_bitwise(label, carry(), state)
    print(f"4s {label}: captured equals eager bit for bit ({compared} "
          f"tensors) after {steps}, {steps * (1 + COMPILED_TURNS)} and "
          f"{steps * (1 + COMPILED_TURNS) + profiled_steps} steps; "
          f"graph kernels {program.graph_nodes['kernel']}; ms/step in turns "
          f"(eager, "
          f"captured): " + ", ".join(
              f"({e:.4f}, {c:.4f})"
              for e, c in zip(walls["eager"], walls["captured"]))
          + "; device ms/step (eager, captured) "
          f"({idle['eager'][0]:.4f}, {idle['captured'][0]:.4f}), idle "
          f"({idle['eager'][1]:.1f}%, {idle['captured'][1]:.1f}%); "
          f"{kernel} launches in a window of {COMPILED_PROFILE_STEPS} "
          f"steps, profiled (eager, captured) ({idle['eager'][2]}, "
          f"{idle['captured'][2]}), captured ones credited; "
          f"{time.perf_counter() - t0:.1f} s")
    return total


def _compiled_training(label, cfg, tmp, iterations, kernel, launches_of,
                       turns=COMPILED_TURNS):
    """A2C training, the eager iteration against the programmed one, from
    two trainers of one config (identical carries and generators):
    ``iterations`` iterations compared bit for bit after each (the first
    programmed one full, the others hot, as ``train()`` runs them; the full
    one's metrics equal the eager ones'), the last ``turns`` of them (or
    all) timed in turns; the launches of each exactly ``launches_of(T)``
    of ``kernel``.  Prints ms per iteration in turns, rollout and update
    ms, the kernel nodes of the programs' graphs and the peak device
    memory of each side.  Returns both trainers and the launches."""
    import math

    import torch

    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.parallel.mesh import reduce_metrics

    from warpdrive_tpu_torch.training.scripts.train import setup_trainer

    t_start = time.perf_counter()
    eager, programmed = (
        setup_trainer(copy.deepcopy(cfg),
                      results_dir=str(tmp / f"{label}_{side}"),
                      verbose=False, device=DEVICE)
        for side in ("eager", "programmed"))
    setup_s = time.perf_counter() - t_start
    assert programmed._programmed, "train() on the card runs programs"
    T = eager.training_batch_size_per_env
    steps = T * eager.num_envs
    total = dict.fromkeys(knn_obs.LAUNCH_COUNTS, 0)
    walls = {"eager": [], "programmed": []}
    peaks = {}
    for i in range(iterations):
        t = i * steps
        for side, run in (
                ("eager", lambda: eager._iteration_eager(t)),
                ("programmed",
                 lambda: programmed._iteration_programmed(t, full=i == 0))):
            knn_obs.reset_launch_counts()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            reserved = torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics = run()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            if i == 0:
                peaks[side] = (
                    (torch.cuda.max_memory_allocated() - base) / 2**30,
                    (torch.cuda.memory_reserved() - reserved) / 2**30)
                if side == "eager":
                    eager_metrics = reduce_metrics(metrics)
                else:
                    got = reduce_metrics(metrics)
                    for tag, m in eager_metrics.items():
                        for name, value in m.items():
                            other = got[tag][name]
                            assert value == other or (
                                math.isnan(value) and math.isnan(other)), \
                                f"{label} {tag} {name}: {value} vs {other}"
            if i >= iterations - turns:
                walls[side].append(wall)
            got = dict(knn_obs.LAUNCH_COUNTS)
            want = dict.fromkeys(got, 0)
            want[kernel] = launches_of(T, eager)
            assert got == want, f"{label} {side}: {got}, expected {want}"
            for name, count in got.items():
                total[name] += count
        compared = _assert_bitwise(f"{label}, iteration {i + 1}",
                                   _trainer_carry(programmed),
                                   _trainer_carry(eager))
    for trainer in (eager, programmed):
        trainer._resolve_phase_marks()
    later = slice(1, None) if iterations > 1 else slice(None)
    phases = {side: [statistics.mean(x) for x in zip(*t.phase_ms[later])]
              for side, t in (("eager", eager), ("programmed", programmed))}
    captures = {(key if isinstance(key, str) else " ".join(key)):
                p.graph_nodes["kernel"]
                for key, p in programmed._programs.items()
                if p.graph_nodes is not None}
    print(f"4s {label}: programmed equals eager bit for bit ({compared} "
          f"tensors) after each of {iterations} iterations (the first full, "
          f"then hot), the full metrics equal; ms per iteration in turns "
          f"(eager, programmed): " + ", ".join(
              f"({e:.3f}, {p:.3f})"
              for e, p in zip(walls["eager"], walls["programmed"]))
          + f"; rollout and update ms (eager) {phases['eager'][0]:.3f}, "
          f"{phases['eager'][1]:.3f}, (programmed) "
          f"{phases['programmed'][0]:.3f}, {phases['programmed'][1]:.3f}; "
          f"graph kernels {captures}; peak allocated and reserved growth in the "
          f"first iteration, GiB: eager {peaks['eager'][0]:.3f}, "
          f"{peaks['eager'][1]:.3f}, programmed {peaks['programmed'][0]:.3f}"
          f", {peaks['programmed'][1]:.3f}; launches {total}; setup "
          f"{setup_s:.1f} s, {time.perf_counter() - t_start:.1f} s in all")
    return eager, programmed, total, walls


def _compiled_idle(label, eager_fn, programmed_fn, calls, kernel=None,
                   phase="4s"):
    """The device's idle share of ``calls`` x each side's function, after
    one call each (a program's capture): device ms (profiler) against the
    wall ms of the same calls without it (the profiler lengthens every
    kernel, so a device-bound program can read below 0).  Where ``kernel``
    is given, the launches counted or credited and the profiler's count
    are printed beside it: a window of ~10^4 kernels has lost one event of
    the profiler's (``_check_credited`` holds them equal on shorter
    windows).  Returns the shares and every call's launches."""
    from warpdrive_tpu_torch.ops import knn_obs

    t0 = time.perf_counter()
    out, launches = {}, dict.fromkeys(knn_obs.LAUNCH_COUNTS, 0)
    for side, fn in (("eager", eager_fn), ("programmed", programmed_fn)):
        knn_obs.reset_launch_counts()
        fn()
        wall = _wall_ms(fn, calls)
        device_ms, profiled, counted = _profiled(
            fn, calls, host=side == "programmed")
        for name, count in knn_obs.LAUNCH_COUNTS.items():
            launches[name] += count
        out[side] = (device_ms, wall, 100 * (1 - device_ms / wall), counted,
                     profiled)
    print(f"{phase} {label}, {calls} calls a side: " + "; ".join(
        f"{side} device {d:.3f} ms of wall {w:.3f} ms, idle {i:.1f}%"
        + (f", {kernel} launches counted {c}, profiled {p}" if kernel
           else "")
        for side, (d, w, i, c, p) in out.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    return out, launches


def _release_programs(*trainers):
    """Release the trainers' captured programs (``release_programs``: their
    graphs' memory pools; a programmed iteration captures them again), then
    free what the device's cache holds, trainers that are gone included (a
    trainer and its programs' bodies refer to each other)."""
    import gc

    import torch

    for trainer in trainers:
        trainer.release_programs()
    gc.collect()
    torch.cuda.empty_cache()


def _memory_line(label):
    """The device memory this process holds, allocated and reserved."""
    import torch

    print(f"device memory {label}: allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")


def _program_check_configs() -> list:
    """The five configurations of ``tests/test_torch_program.py`` at its
    small sizes, on the card: ``(label, run config, K2 launches an
    iteration of T steps)`` -- the ``tag_continuous`` run config cut to 5
    envs x 20 agents, PPO over 2 epochs x 4 shuffled minibatches with remat
    and a bf16 model and batch, ``update_recompute_obs`` (K2 in each of its
    2 x 2 passes too), ``single_cartpole`` with a reset pool and
    ``asymmetric_pursuit`` (no kernel)."""
    from warpdrive_tpu_torch.utils.config import load_run_config

    def saving(cfg):
        cfg["saving"].update({"metrics_log_freq": 10**9,
                              "model_params_save_freq": 10**9})
        return cfg

    def small_tag(policy=None, **trainer):
        cfg = load_run_config("tag_continuous")
        cfg["env"].update({"num_taggers": 2, "num_runners": 8,
                           "episode_length": 12,
                           "num_other_agents_observed": 4})
        cfg["trainer"].update({"num_envs": 8, "train_batch_size": 80,
                               "num_episodes": 24, "seed": 7, **trainer})
        for tag in ("runner", "tagger"):
            cfg["policy"][tag]["model"]["fc_dims"] = [16, 16]
            cfg["policy"][tag].update(policy or {})
        return saving(cfg)

    cut = load_run_config("tag_continuous")
    cut["env"].update({"num_taggers": 2, "num_runners": 18,
                       "episode_length": 12})
    cut["trainer"].update({"num_envs": 5, "train_batch_size": 50,
                           "num_episodes": 15, "seed": 3})
    ppo = small_tag(dict(algorithm="PPO", num_epochs=2, num_minibatches=4,
                         shuffle_minibatches=True, remat=True),
                    batch_dtype="bfloat16")
    for tag in ("runner", "tagger"):
        ppo["policy"][tag]["model"]["dtype"] = "bfloat16"
    cartpole = load_run_config("single_cartpole")
    cartpole["env"].update({"episode_length": 20, "reset_pool_size": 16,
                            "seed": 5})
    cartpole["trainer"].update({"num_envs": 8, "train_batch_size": 80,
                                "num_episodes": 12, "seed": 3})
    pursuit = load_run_config("asymmetric_pursuit")
    pursuit["env"].update({"episode_length": 12, "seed": 2})
    pursuit["trainer"].update({"num_envs": 4, "train_batch_size": 40,
                               "num_episodes": 10, "seed": 3})
    for tag in ("pursuer", "evader"):
        pursuit["policy"][tag]["model"]["fc_dims"] = [16, 16]
    return [
        ("tag_continuous cut to 5 x 20", saving(cut), lambda T: T),
        ("PPO 2 x 4 shuffled, remat, bf16", ppo, lambda T: T),
        ("update_recompute_obs", small_tag(dict(num_minibatches=2),
                                           update_recompute_obs=True),
         lambda T: T + 2 * 2),
        ("single_cartpole with a pool", saving(cartpole), lambda T: 0),
        ("asymmetric_pursuit", saving(pursuit), lambda T: 0),
    ]


def _profiled_credited(label, fn, calls, host=True, reset=None):
    """``_profiled(fn, calls, host)`` where the kNN launches counted or
    credited must equal ``calls`` in every window, and the profiler's
    count of kNN kernels must equal them in one of ``PROFILE_WINDOWS``: a
    window in which the profiler recorded fewer (it drops all or part of a
    short window's records now and then) is profiled again, after
    ``reset()`` when given; one in which it recorded more fails.  Returns
    the last window's device ms, profiled and credited counts, and the
    number of windows profiled."""
    for window in range(1, PROFILE_WINDOWS + 1):
        if reset is not None:
            reset()
        device_ms, profiled, credited = _profiled(fn, calls, host)
        assert credited == calls and profiled <= credited, (
            f"{label}: {credited} kNN launches credited over {calls} "
            f"calls, {profiled} profiled")
        if profiled == credited:
            return device_ms, profiled, credited, window
        print(f"{label}: the profiler recorded {profiled} of {credited} kNN "
              f"launches in window {window}; profiling it again")
    raise AssertionError(
        f"{label}: the profiler recorded fewer kNN launches than were "
        f"credited in each of {PROFILE_WINDOWS} windows")


def _check_credited(label, program, calls, kernel, phase="4s", reset=None):
    """``calls`` replays of ``program`` (after a warm-up replay), each
    launching ``kernel`` once inside its graph: the launches credited to
    ``kernel`` must equal ``calls`` and the profiler's count of kNN
    kernels (``_profiled_credited``, ``reset`` before each window).
    Returns every replay's launches."""
    from warpdrive_tpu_torch.ops import knn_obs

    knn_obs.reset_launch_counts()
    _, profiled, credited, windows = _profiled_credited(
        label, program, calls, reset=reset)
    launches = dict(knn_obs.LAUNCH_COUNTS)
    assert launches[kernel] == windows * (calls + 1), (
        f"{label}: {launches[kernel]} {kernel} launches credited over "
        f"{windows} windows of {calls + 1} replays")
    print(f"{phase} {label}: {kernel} launches credited = profiled = "
          f"{calls} over {calls} replays"
          + (f" ({windows} windows profiled)" if windows > 1 else ""))
    return launches


def _runner_passes(eager, programmed):
    """The runner's hot update pass, one call a pass: eager (on the eager
    trainer's batch) and the programmed trainer's program, each sweep
    begun again (at timestep 0) when its passes are spent."""
    lr = eager.lr_schedules["runner"].value_at(0)

    def cycling(update, one_pass):
        calls = [0]

        def call():
            if calls[0] % update.opts.passes == 0:
                update.begin(0, lr)
            calls[0] += 1
            one_pass()

        return call

    eager_pass = eager._update_pass("runner", eager._batch)
    return (cycling(eager_pass, lambda: eager_pass.run_pass(full=False)),
            cycling(programmed._update_passes["runner"],
                    programmed._programs["runner", "hot"]))


def _drive_compiled_iteration(rolled, many_state, run_config):
    """Phase 4s: the compiled iteration on the card against the eager one,
    on identical carries and generator states.

    (a) the flagship's ``env_only_step`` and ``full_loop_step`` (1024 envs,
    K1) from the rolled state of phase 3 and the 1024-agent
    ``env_only_step`` (256 envs, K1) from 4c's state, each against its
    ``presets.captured_loop`` form (``_compiled_loop``); (b) the shipped
    ``tag_continuous`` run config uncut (K2), 2 iterations compared and
    timed in turns (``_compiled_training``), then the idle share of one
    iteration of each side; (c) the tuned flagship stage (``_tuned_config``:
    2000 x 100, mb400, bf16, K1), 2 iterations in turns, compared, then
    the idle shares of the rollout and of 20 update passes;
    one iteration under ``update_recompute_obs`` (K1 in every pass),
    compared, and 20 of its passes profiled.  (d) ``profile_trace`` and
    ``graceful_close`` of (b)'s programmed trainer, then the five
    configurations of ``tests/test_torch_program.py`` at its small sizes
    (``_program_check_configs``), 3 iterations each.  Every comparison is
    bit for bit: parameters, Adam moments and counts, env state, episodic
    accounting, batch and the generator's state.  Returns the launches, by
    kernel."""
    import gc

    import torch

    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.presets import build_flagship, build_many_agents

    t_start = time.perf_counter()
    total = dict.fromkeys(knn_obs.LAUNCH_COUNTS, 0)

    def add(counts):
        for name, count in counts.items():
            total[name] += count

    flagship = build_flagship(num_envs=NUM_ENVS, fc_dims=FC_DIMS, seed=0,
                              device=DEVICE)
    for loop in ("env_only_step", "full_loop_step"):
        add(_compiled_loop(f"flagship {loop}, {NUM_ENVS} envs", flagship,
                           loop, rolled, "knn_obs_flat_exact",
                           COMPILED_STEPS))
    many = build_many_agents(num_envs=MANY_AGENT_ENVS, seed=0,
                             knn_algorithm="pallas_flat_exact",
                             device=DEVICE)
    add(_compiled_loop(f"1024-agent env_only_step, {MANY_AGENT_ENVS} envs",
                       many, "env_only_step", many_state,
                       "knn_obs_flat_exact", COMPILED_STEPS))
    del flagship, many

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_compiled_"))
    try:
        cfg = copy.deepcopy(run_config)
        eager, programmed, counts, _ = _compiled_training(
            "tag_continuous training", cfg, tmp, 2 + COMPILED_TURNS,
            "knn_obs_mxu", lambda T, trainer: T)
        add(counts)
        t = 10**6
        add(_compiled_idle(
            "tag_continuous iteration", lambda: eager._iteration_eager(t),
            lambda: programmed._iteration_programmed(t, full=False), 1,
            "knn_obs_mxu")[1])
        # the rollout step writes rows 0-10 of each window
        add(_check_credited("tag_continuous rollout step",
                            programmed._programs["rollout"],
                            COMPILED_PROFILE_STEPS, "knn_obs_mxu",
                            reset=programmed._row.zero_))
        knn_obs.reset_launch_counts()
        t0 = time.perf_counter()
        trace = Path(programmed.profile_trace(str(tmp / "trace"),
                                              iterations=1))
        programmed.graceful_close()
        add(knn_obs.LAUNCH_COUNTS)
        print(f"4s profile_trace: {trace.name}, "
              f"{trace.stat().st_size / 2**20:.1f} MiB; graceful_close; "
              f"{time.perf_counter() - t0:.1f} s")
        _release_programs(eager, programmed)
        del eager, programmed

        for label, cfg, k2_of in _program_check_configs():
            eager, programmed, counts, _ = _compiled_training(
                label, cfg, tmp, 3, "knn_obs_mxu",
                lambda T, trainer, k2_of=k2_of: k2_of(T))
            add(counts)
            _release_programs(eager, programmed)
        del eager, programmed

        eager, programmed, counts, _ = _compiled_training(
            "tuned flagship stage", _tuned_config(TUNED_COMPILED_ITERS), tmp,
            TUNED_COMPILED_ITERS, "knn_obs_flat_exact", lambda T, trainer: T)
        add(counts)
        add(_compiled_idle(
            "tuned flagship rollout", eager._rollout,
            programmed._rollout_programmed, 1, "knn_obs_flat_exact")[1])
        add(_check_credited("tuned flagship rollout step",
                            programmed._programs["rollout"],
                            COMPILED_PROFILE_STEPS, "knn_obs_flat_exact",
                            reset=programmed._row.zero_))
        add(_compiled_idle(
            "tuned flagship update passes",
            *_runner_passes(eager, programmed), COMPILED_PROFILE_PASSES)[1])
        _release_programs(eager, programmed)
        del eager, programmed
        gc.collect()
        torch.cuda.empty_cache()

        eager, programmed, counts, _ = _compiled_training(
            "tuned flagship stage, update_recompute_obs",
            _tuned_config(1, recompute=True), tmp, 1, "knn_obs_flat_exact",
            lambda T, trainer: T + len(trainer.policies_to_train)
            * TUNED_MINIBATCHES, turns=1)
        add(counts)
        eager_passes, programmed_passes = _runner_passes(eager, programmed)
        add(_compiled_idle(
            "tuned flagship recompute passes", eager_passes,
            programmed_passes, COMPILED_PROFILE_PASSES,
            "knn_obs_flat_exact")[1])
        add(_check_credited("tuned flagship recompute pass",
                            programmed_passes, COMPILED_PROFILE_STEPS // 2,
                            "knn_obs_flat_exact"))
        _release_programs(eager, programmed)
        del eager, programmed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4s {time.perf_counter() - t_start:.1f} s; launches "
          f"{total}")
    return total


# phase 4t: the rest of the compiled execution model -- DDPG's programs, the
# evaluation and fetch programs, the engine facade's, the eager backend's
# update programs and a one-rank NCCL group's, each against its eager
# counterpart on identical carries and generator states; the facade's
# flagship steps, and the full observation's float64 update card vs CPU
FACADE_STEPS = 100
EAGER_BACKEND_ITERS = 2
# ClippedAdam's step with float64 moments and parameters, on the card and on
# the CPU from the same gradients: the same float64 operations (the bias
# corrections' float32 powers aside, an ulp apart at most), far below this
FLOAT64_UPDATE_TOL = 1e-9


def _ddpg_carry(trainer) -> dict:
    """Every tensor a DDPG iteration reads and writes: nets, targets, Adam
    moments and counts, the window, the OU state, the env state, the
    episodic accounting and the rollout generator's state."""
    import torch

    return {
        "nets": {net: {t: m.state_dict() for t, m in by_tag.items()}
                 for net, by_tag in trainer.nets.items()},
        "targets": {net: {t: m.state_dict() for t, m in by_tag.items()}
                    for net, by_tag in trainer.targets.items()},
        "optimizers": {net: {t: {"count": torch.tensor(o.count), "mu": o.mu,
                                 "nu": o.nu}
                             for t, o in by_tag.items()}
                       for net, by_tag in trainer.optimizers.items()},
        "window": trainer._window, "ou": trainer._ou,
        "env_state": trainer._env_state,
        "episodes": {"acc": trainer._ep_acc, "sum": trainer._ep_sum,
                     "count": trainer._ep_count},
        "filled": torch.tensor(trainer.filled),
        "generator": trainer.generator.get_state(),
    }


def _metrics_equal(label, want, got, meshes=(None, None)):
    """Two metric dicts (each reduced over its mesh) equal."""
    import math

    from warpdrive_tpu_torch.parallel.mesh import reduce_metrics

    want, got = (reduce_metrics(m, mesh) for m, mesh in zip((want, got),
                                                            meshes))
    assert want.keys() == got.keys(), label
    for tag, m in want.items():
        assert m.keys() == got[tag].keys(), f"{label} {tag}"
        for name, value in m.items():
            other = got[tag][name]
            assert value == other or (math.isnan(value)
                                      and math.isnan(other)), \
                f"{label} {tag} {name}: {value} vs {other}"


def _drive_ddpg_programs():
    """4t (a): DDPG training of ``DDPG_TRAINING`` at full width, the eager
    iteration against the programmed one from two trainers of one config,
    ``DDPG_TRAIN_ITERS`` iterations (the first full, across the warm-up
    gate, the rest hot), compared bit for bit after each; then the device's
    idle share of one iteration of each side (and compared again).  No kNN
    launch.  Returns the wall ms an iteration of each side."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.training.scripts.train import setup_trainer

    no_launches = dict.fromkeys(knn_obs.LAUNCH_COUNTS, 0)
    out = {}
    for name in DDPG_TRAINING:
        t_start = time.perf_counter()
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_4t_"))
        try:
            eager, programmed = (
                setup_trainer(_ddpg_config(name),
                              results_dir=str(tmp / side), verbose=False,
                              device=DEVICE)
                for side in ("eager", "programmed"))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        assert programmed._programmed, "DDPG on the card runs programs"
        steps = eager.training_batch_size_per_env * eager.num_envs
        walls = {"eager": [], "programmed": []}
        gate = []
        for i in range(DDPG_TRAIN_ITERS):
            t = i * steps
            got = {}
            for side, run in (
                    ("eager", lambda: eager._iteration_eager(t)),
                    ("programmed", lambda: programmed._iteration_programmed(
                        t, full=i == 0))):
                knn_obs.reset_launch_counts()
                got[side], secs = _timed(run)
                walls[side].append(1e3 * secs)
                assert dict(knn_obs.LAUNCH_COUNTS) == no_launches
            if i == 0:
                _metrics_equal(f"DDPG {name}", got["eager"],
                               got["programmed"])
            gate.append(programmed.filled >= programmed.buffer_capacity)
            compared = _assert_bitwise(f"DDPG {name}, iteration {i + 1}",
                                       _ddpg_carry(programmed),
                                       _ddpg_carry(eager))
        assert gate == [False] + [True] * (DDPG_TRAIN_ITERS - 1), gate
        t = DDPG_TRAIN_ITERS * steps
        idle, _ = _compiled_idle(
            f"DDPG {name} iteration", lambda: eager._iteration_eager(t),
            lambda: programmed._iteration_programmed(t, full=False), 1,
            phase="4t (a)")
        _assert_bitwise(f"DDPG {name}, after the idle windows",
                        _ddpg_carry(programmed), _ddpg_carry(eager))
        captures = {(k if isinstance(k, str) else " ".join(k)):
                    p.graph_nodes["kernel"]
                    for k, p in programmed._programs.items()
                    if p.graph_nodes is not None}
        print(f"4t (a) DDPG {name} ({eager.num_envs} envs x "
              f"{eager.training_batch_size_per_env} steps, window "
              f"{eager.buffer_capacity}): programmed equals eager bit for bit "
              f"({compared} tensors) after each of {DDPG_TRAIN_ITERS} "
              f"iterations (the first full and short of the window, the "
              f"full metrics equal; the rest hot) and after the idle "
              f"windows; ms an iteration (eager, programmed): " + ", ".join(
                  f"({e:.3f}, {p:.3f})"
                  for e, p in zip(walls["eager"], walls["programmed"]))
              + f"; idle eager {idle['eager'][2]:.1f}%, programmed "
              f"{idle['programmed'][2]:.1f}%; graph kernels {captures}; "
              f"{time.perf_counter() - t_start:.1f} s; no kNN launch")
        out[name] = {side: statistics.median(w[1:])
                     for side, w in walls.items()}
        _release_programs(eager, programmed)
        del eager, programmed
    return out


def _same_arrays(label, a, b):
    """Two trees of numpy arrays equal bit for bit."""
    import numpy as np

    if isinstance(a, dict):
        assert a.keys() == b.keys(), label
        for k in a:
            _same_arrays(f"{label}/{k}", a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), label
        for i, (x, y) in enumerate(zip(a, b)):
            _same_arrays(f"{label}/{i}", x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape \
            and a.tobytes() == b.tobytes(), f"{label} differs"


def _drive_episode_programs(tag_trainer, pendulum):
    """4t (b): evaluation and episode fetching, each programmed call
    against the same call run eagerly (``plain_calls``: every program's
    body called op by op) from the same evaluation and store generator
    states: ``evaluate_episodes`` (most likely actions) and
    ``fetch_episode_states`` of the ``tag_continuous`` trainer (K2, uncut)
    and of the Pendulum trainer, and the former's ``fetch_logged_episode``;
    outputs and generators bit for bit, ms a step of each side; then the K2
    launches credited to 10 replays of the evaluation step against the
    profiler's count.  Returns the launches."""
    import torch

    from warpdrive_tpu_torch.core.program import plain_calls
    from warpdrive_tpu_torch.ops import knn_obs

    total = dict.fromkeys(knn_obs.LAUNCH_COUNTS, 0)
    t_start = time.perf_counter()

    def gens(trainer):
        return (trainer.eval_generator, trainer.engine.store.generator)

    tag_names = ["loc_x", "loc_y", "still_in_the_game"]
    cases = [
        ("tag_continuous", tag_trainer, "knn_obs_mxu", (
            ("evaluate_episodes",
             lambda: tag_trainer.evaluate_episodes(use_argmax=True)),
            ("fetch_episode_states", lambda: tag_trainer.fetch_episode_states(
                tag_names, env_id=3, include_rewards_actions=True,
                include_probabilities=True)),
            ("fetch_logged_episode",
             lambda: tag_trainer.fetch_logged_episode(env_id=3)))),
        ("single_pendulum", pendulum, None, (
            ("evaluate_episodes",
             lambda: pendulum.evaluate_episodes(use_argmax=True)),
            ("fetch_episode_states", lambda: pendulum.fetch_episode_states(
                ["state"], env_id=5, include_rewards_actions=True)))),
    ]
    for label, trainer, kernel, runs in cases:
        T = trainer.engine.episode_length
        for run_label, run in runs:
            run()  # built and captured (or replayed, if 4i built it)
            start = [g.get_state() for g in gens(trainer)]
            results, ms, launches = {}, {}, {}
            for side in ("programmed", "eager"):
                for g, state in zip(gens(trainer), start):
                    g.set_state(state)
                knn_obs.reset_launch_counts()
                if side == "eager":
                    with plain_calls():
                        results[side], secs = _timed(run)
                else:
                    results[side], secs = _timed(run)
                ms[side] = 1e3 * secs / T
                launches[side] = dict(knn_obs.LAUNCH_COUNTS)
                for name, count in launches[side].items():
                    total[name] += count
                if side == "programmed":
                    ends = [g.get_state() for g in gens(trainer)]
            for g, state in zip(gens(trainer), ends):
                assert torch.equal(g.get_state(), state), \
                    f"{label} {run_label}: the generators differ"
            _same_arrays(f"{label} {run_label}", results["eager"],
                         results["programmed"])
            want = dict.fromkeys(knn_obs.LAUNCH_COUNTS, 0)
            if kernel:
                want[kernel] = T
            assert launches["eager"] == launches["programmed"] == want, \
                f"{label} {run_label}: launches {launches}"
            print(f"4t (b) {run_label} [{label}, {trainer.num_envs} envs x "
                  f"{trainer.engine.n_agents} agents, episode {T}]: "
                  f"programmed equals eager bit for bit, generators too; ms "
                  f"a step eager {ms['eager']:.4f}, programmed "
                  f"{ms['programmed']:.4f}; launches a side {want}")
    program = tag_trainer._episode_programs[("evaluate", True)]
    for name, count in _check_credited(
            "tag_continuous evaluation step", program,
            COMPILED_PROFILE_STEPS, "knn_obs_mxu", phase="4t (b)").items():
        total[name] += count
    print(f"4t (b) {time.perf_counter() - t_start:.1f} s; launches {total}")
    return total


def _drive_facade_programs():
    """4t (c): the flagship (1024 envs, K1) through the engine facade: two
    engines of one build, one replaying the facade's programs, one calling
    their bodies op by op (``plain_calls``); ``FACADE_STEPS`` x
    ``step_all_envs`` (the same
    device-drawn actions) and ``reset_only_done_envs``, then
    ``reset_all_envs``, twice (the first pass with every step's outputs
    digested, the second timed), compared bit for bit (every step's
    outputs, every state entry and the store's generator); ms a step of
    each side, and the K1 launches credited to 10 replays of the step
    against the profiler's count.  Returns the launches."""
    import torch

    from warpdrive_tpu_torch.core.program import plain_calls
    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.presets import build_flagship

    t_start = time.perf_counter()
    engines = {}
    for side in ("eager", "programmed"):
        engines[side] = build_flagship(num_envs=NUM_ENVS, fc_dims=FC_DIMS,
                                       seed=0, device=DEVICE)["engine"]
    eng = engines["eager"]
    E, N = eng.n_envs, eng.n_agents
    nvec = [int(n) for n in eng.action_space[0].nvec]
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    actions = [torch.stack([torch.randint(0, n, (E, N), generator=gen,
                                          device=DEVICE, dtype=torch.int32)
                            for n in nvec], -1)
               for _ in range(FACADE_STEPS)]
    total = dict.fromkeys(knn_obs.LAUNCH_COUNTS, 0)
    ms, digests = {}, {}
    for side, engine in engines.items():
        engine.reset_all_envs()  # the state as built
        def plain(side=side):
            return (plain_calls() if side == "eager"
                    else contextlib.nullcontext())

        # a pass with every step's outputs digested, then a timed one
        for timed in (False, True):
            knn_obs.reset_launch_counts()
            outs = []

            def steps(engine=engine, outs=outs, timed=timed):
                for a in actions:
                    out = engine.step_all_envs(a)
                    if not timed:
                        outs.append(_row_digests(
                            {k: v[None] for k, v in out.items()}))
                    engine.reset_only_done_envs()

            with plain():
                _, secs = _timed(steps)
            launches = dict(knn_obs.LAUNCH_COUNTS)
            assert launches == dict(dict.fromkeys(launches, 0),
                                    knn_obs_flat_exact=FACADE_STEPS), \
                f"facade {side}: launches {launches}"
            for name, count in launches.items():
                total[name] += count
            if timed:
                ms[side] = 1e3 * secs / FACADE_STEPS
            else:
                digests[side] = outs
        with plain():
            engine.reset_all_envs()
    for i, (a, b) in enumerate(zip(digests["eager"],
                                   digests["programmed"])):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), f"facade step {i + 1}: {k}"
    compared = _assert_bitwise(
        "facade state", dict(engines["programmed"].state),
        dict(engines["eager"].state))
    assert torch.equal(engines["programmed"].store.generator.get_state(),
                       engines["eager"].store.generator.get_state())
    program = engines["programmed"]._facade_programs["step"]
    for name, count in _check_credited(
            "flagship facade step", program, COMPILED_PROFILE_STEPS,
            "knn_obs_flat_exact", phase="4t (c)").items():
        total[name] += count
    captures = {k: p.graph_nodes["kernel"]
                for k, p in engines["programmed"]._facade_programs.items()
                if p.graph_nodes is not None}
    print(f"4t (c) flagship facade ({E} envs x {N} agents): "
          f"2 x {FACADE_STEPS} step_all_envs + reset_only_done_envs, then "
          f"reset_all_envs: programmed equals eager bit for bit ({compared} "
          f"state tensors, every step's outputs, the store's generator); ms "
          f"a step eager {ms['eager']:.4f}, programmed "
          f"{ms['programmed']:.4f}; graph kernels "
          f"{captures}; "
          f"{time.perf_counter() - t_start:.1f} s; launches {total}")
    return total


def _drive_eager_backend_programs():
    """4t (d): 4p's ``single_cartpole`` (100 envs x 500 steps) with
    ``trainer.env_backend: cpp``: two trainers with identically seeded
    envs, the eager iteration against the programmed one (the host-stepped
    rollout into the static batch, then the update programs),
    ``EAGER_BACKEND_ITERS`` iterations compared bit for bit (parameters,
    Adam moments and counts, batch, generator, the engine's outputs); then
    the device's idle share of an update of each side, compared again.
    No kNN launch."""
    import torch

    from warpdrive_tpu_torch.envs.cpu_engine import CpuEnvEngine
    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.training.scripts.train import setup_trainer

    t_start = time.perf_counter()
    cfg = _iters_config("single_cartpole", EAGER_BACKEND_ITERS)
    cfg["trainer"]["env_backend"] = "cpp"
    cfg["env"]["seed"] = 5
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_4t_"))
    try:
        eager, programmed = (
            setup_trainer(copy.deepcopy(cfg), results_dir=str(tmp / side),
                          verbose=False, device=DEVICE)
            for side in ("eager", "programmed"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert isinstance(programmed.engine, CpuEnvEngine)
    assert programmed._programmed

    def carry(trainer):
        out = _trainer_carry(trainer)
        del out["env_state"]  # the host engine's: its outputs instead
        out["engine"] = dict(trainer.engine.state)
        return out

    steps = eager.training_batch_size_per_env * eager.num_envs
    walls = {"eager": [], "programmed": []}
    for i in range(EAGER_BACKEND_ITERS):
        t = i * steps
        got = {}
        for side, run in (
                ("eager", lambda: eager._iteration_eager(t)),
                ("programmed", lambda: programmed._iteration_programmed(
                    t, full=i == 0))):
            knn_obs.reset_launch_counts()
            got[side], secs = _timed(run)
            walls[side].append(1e3 * secs)
            assert sum(knn_obs.LAUNCH_COUNTS.values()) == 0
        if i == 0:
            _metrics_equal("eager backend", got["eager"], got["programmed"])
        compared = _assert_bitwise(f"eager backend, iteration {i + 1}",
                                   carry(programmed), carry(eager))
    assert "rollout" not in programmed._programs
    t = EAGER_BACKEND_ITERS * steps
    idle, _ = _compiled_idle(
        "eager backend update",
        lambda: eager._update(eager._batch, t),
        lambda: programmed._update_programmed(t, full=False), 1,
        phase="4t (d)")
    _assert_bitwise("eager backend, after the idle windows",
                    carry(programmed), carry(eager))
    phases = {side: tr.phase_ms for side, tr in
              (("eager", eager), ("programmed", programmed))}
    eager._resolve_phase_marks()
    programmed._resolve_phase_marks()
    print(f"4t (d) eager backend [single_cartpole, C++ stepper, "
          f"{eager.num_envs} envs x {eager.training_batch_size_per_env} "
          f"steps]: programmed update equals the eager one bit for bit "
          f"({compared} tensors) after each of {EAGER_BACKEND_ITERS} "
          f"iterations; ms an iteration (eager, programmed): " + ", ".join(
              f"({e:.3f}, {p:.3f})"
              for e, p in zip(walls["eager"], walls["programmed"]))
          + "; update ms (eager, programmed): " + ", ".join(
              f"({e[1]:.3f}, {p[1]:.3f})"
              for e, p in zip(phases["eager"], phases["programmed"]))
          + f"; update idle eager {idle['eager'][2]:.1f}%, programmed "
          f"{idle['programmed'][2]:.1f}%; "
          f"{time.perf_counter() - t_start:.1f} s; no kNN launch")
    _release_programs(eager, programmed)


def _drive_nccl_programs():
    """4t (e): the shipped ``tag_continuous`` run config (K2) in a
    one-rank NCCL group: a trainer that runs programs (their collectives
    captured; the communicator made by ``Mesh.warm_up`` before any
    capture), the same group's trainer run eagerly and the plain
    programmed trainer, ``MULTI_ITERS`` iterations each (the first full),
    all three carries bit for bit and the group's two sides' full metrics
    equal (the plain trainer finishes its metrics on its rank, the group
    over it: float32 rounding apart).  Returns the launches."""
    import torch.distributed as dist

    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.parallel.launch import free_port
    from warpdrive_tpu_torch.parallel.mesh import initialize_multihost
    from warpdrive_tpu_torch.training.scripts.train import setup_trainer

    t_start = time.perf_counter()
    cfg = _multi_config()
    total = dict.fromkeys(knn_obs.LAUNCH_COUNTS, 0)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_4t_nccl_"))
    # the plain trainer before the group (inside one, a trainer joins it)
    trainers = {"plain": setup_trainer(copy.deepcopy(cfg),
                                       results_dir=str(tmp / "p"),
                                       verbose=False, device=DEVICE)}
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                         device="cuda:0")
    try:
        for side in ("nccl programmed", "nccl eager"):
            trainers[side] = setup_trainer(
                copy.deepcopy(cfg), num_devices=1,
                results_dir=str(tmp / side.replace(" ", "_")),
                verbose=False, device=DEVICE)
        assert trainers["plain"].mesh is None
        assert trainers["nccl programmed"].mesh.backend == "nccl"
        assert trainers["nccl programmed"]._programmed
        T = cfg["trainer"]["train_batch_size"] // cfg["trainer"]["num_envs"]
        steps = T * cfg["trainer"]["num_envs"]
        walls = {side: [] for side in trainers}
        for i in range(MULTI_ITERS):
            t = i * steps
            got = {}
            for side, trainer in trainers.items():
                knn_obs.reset_launch_counts()
                if side == "nccl eager":
                    run = (lambda trainer=trainer:
                           trainer._iteration_eager(t))
                else:
                    run = (lambda trainer=trainer:
                           trainer._iteration_programmed(t, full=i == 0))
                got[side], secs = _timed(run)
                walls[side].append(1e3 * secs)
                launches = dict(knn_obs.LAUNCH_COUNTS)
                assert launches == dict(dict.fromkeys(launches, 0),
                                        knn_obs_mxu=T), (side, launches)
                for name, count in launches.items():
                    total[name] += count
            if i == 0:
                # the group's metrics are finished over it (Deferred), the
                # plain trainer's on its rank: equal between the group's
                # two sides, within float32 rounding of the plain ones
                mesh = trainers["nccl eager"].mesh
                _metrics_equal("4t (e) the group's full metrics",
                               got["nccl eager"], got["nccl programmed"],
                               (mesh, mesh))
            for side in ("nccl programmed", "nccl eager"):
                compared = _assert_bitwise(
                    f"4t (e) {side} vs plain, iteration {i + 1}",
                    _trainer_carry(trainers[side]),
                    _trainer_carry(trainers["plain"]))
        captured = sorted(
            " ".join(k) if isinstance(k, tuple) else k
            for k, p in trainers["nccl programmed"]._programs.items()
            if p.graph is not None)
        assert captured, "the NCCL trainer captured no program"
        print(f"4t (e) one-rank NCCL group [tag_continuous, K2]: the "
              f"programmed trainer (captured: {captured}) and the group's "
              f"eager iteration each equal the plain programmed trainer bit "
              f"for bit ({compared} tensors) after each of {MULTI_ITERS} "
              f"iterations, the group's full metrics equal; ms an iteration "
              + "; ".join(f"{side} " + ", ".join(f"{w:.3f}" for w in ws)
                          for side, ws in walls.items())
              + f"; {time.perf_counter() - t_start:.1f} s; launches {total}")
        _release_programs(*trainers.values())
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return total


def _full_obs_float64_update(trainer):
    """4t (f): 4l's full-observation update (its batch, the first
    ``FULL_OBS_UPDATE_ENVS`` envs) with float64 parameters, Adam moments and
    batch on the card against the same on the CPU, from copies of the
    trained parameters and Adam state, bisected: the heads' outputs (the
    model returns them in float32, as the JAX model does), the loss, the
    gradients and the parameters after the update; then ``ClippedAdam``
    alone, stepped on the card with the CPU's gradients, against the CPU's
    parameters (within ``FLOAT64_UPDATE_TOL``).  Returns the largest
    parameter difference of each policy's update."""
    import torch

    from warpdrive_tpu_torch.training.trainer_a2c import (
        ClippedAdam,
        _forward,
        policy_update,
    )

    class Recording(ClippedAdam):
        def step(self, grads, lr):
            self.grads = {n: g.detach().clone() for n, g in grads.items()}
            return super().step(grads, lr)

    def fresh(tag, device):
        model = copy.deepcopy(trainer.models[tag]).to(device, torch.float64)
        opt = Recording(dict(model.named_parameters()),
                        max_norm=trainer.optimizers[tag].max_norm)
        opt.load_state_dict(trainer.optimizers[tag].state_dict())
        return model, opt

    def host(tree):
        return {k: v.detach().cpu() for k, v in tree.items()}

    def diff(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in b)

    worst = {}
    timestep = trainer.current_timestep
    for tag in trainer.policies_to_train:
        batch = {k: v[:, :FULL_OBS_UPDATE_ENVS].contiguous()
                 for k, v in trainer._policy_batch(trainer._batch,
                                                   tag).items()}
        lr = trainer.lr_schedules[tag].value_at(timestep)
        runs = {}
        for device in (DEVICE, "cpu"):
            model, opt = fresh(tag, device)
            b = {k: v.to(device, torch.float64) if v.is_floating_point()
                 else v.to(device) for k, v in batch.items()}
            with torch.no_grad():
                heads, value = _forward(model, b["obs"], b.get("mask"))
            outputs = {f"head_{i}": h for i, h in enumerate(heads)}
            outputs["value"] = value
            metrics = policy_update(model, opt, trainer.algorithms[tag], b,
                                    timestep, lr)
            runs[device] = {"outputs": host(outputs),
                            "loss": float(metrics["Total loss"]),
                            "grads": host(opt.grads),
                            "params": host(model.state_dict())}
        card, cpu = runs[DEVICE], runs["cpu"]
        grad_scale = max(float(g.abs().max()) for g in cpu["grads"].values())
        # ClippedAdam alone: the CPU's gradients stepped on the card
        model, opt = fresh(tag, DEVICE)
        ClippedAdam.step(opt, {n: g.to(DEVICE)
                               for n, g in cpu["grads"].items()}, lr)
        adam_alone = diff(host(model.state_dict()), cpu["params"])
        worst[tag] = diff(card["params"], cpu["params"])
        print(f"4t (f) full-observation update with float64 parameters "
              f"[{tag}, {FULL_OBS_UPDATE_ENVS} envs x "
              f"{trainer.training_batch_size_per_env} steps], card vs CPU: "
              f"heads and value (float32) max abs diff "
              f"{diff(card['outputs'], cpu['outputs']):.3g}; loss "
              f"{card['loss']!r} vs {cpu['loss']!r}; gradients max abs diff "
              f"{diff(card['grads'], cpu['grads']):.3g} of a largest "
              f"{grad_scale:.3g}; parameters after the update "
              f"{worst[tag]:.3g} (learning rate {lr:.3g}); ClippedAdam "
              f"alone on the CPU's gradients {adam_alone:.3g} (tolerance "
              f"{FLOAT64_UPDATE_TOL})")
        assert all(torch.isfinite(v).all() for v in card["params"].values())
        assert adam_alone <= FLOAT64_UPDATE_TOL, f"{tag}: {adam_alone}"
    return worst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print torch.profiler kernel tables")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from warpdrive_tpu_torch.ops import cuda_build, knn_obs, tag_physics
    from warpdrive_tpu_torch.presets import build_flagship, build_many_agents
    from warpdrive_tpu_torch.utils.config import load_run_config

    # 1. the card
    card = _card_line()
    cap = torch.cuda.get_device_capability(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, capability {cap}, "
          f"{torch.cuda.device_count()} device(s)")
    assert cap == (9, 0), f"the kernels are built for sm_90a, card is {cap}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build every kernel from the checkout
    t0 = time.perf_counter()
    report = cuda_build.build(cuda_build.kernel_sources())
    print(f"built {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in sorted(report.items()):
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                        "spill")):
                print(f"  {name}: {line.strip()}")
    _check_sass("knn_obs", "tile_kernel", "HMMA")
    _check_sass("knn_obs_ladder", "ladder_kernel", "REDUX")

    # 3. kernels vs plain, and the CUDA step vs the CPU step
    max_abs = {"knn_obs_flat_exact": 0.0}
    for E, N, k in ((NUM_ENVS, 105, 10), (8, 1024, 10), (6, 15, 4)):
        knn_args, n, kk = _random_knn_inputs(E, N, k, seed=N, device=DEVICE)
        max_abs["knn_obs_flat_exact"] = max(
            max_abs["knn_obs_flat_exact"],
            _compare_knn("random", knn_args, n, kk))

    system = build_flagship(num_envs=NUM_ENVS, fc_dims=FC_DIMS, seed=0,
                            device=DEVICE)
    generator = torch.Generator(device=DEVICE)
    generator.manual_seed(0)
    rolled = system["state"]
    checksum = torch.zeros((), device=DEVICE)
    for _ in range(ROLLED_STEPS):
        rolled, checksum = system["env_only_step"]((rolled, checksum),
                                                   generator)
    env = system["env"]
    rolled_args, n, kk = _knn_args(env, rolled)
    max_abs["knn_obs_flat_exact"] = max(
        max_abs["knn_obs_flat_exact"],
        _compare_knn(f"rolled {ROLLED_STEPS} steps", rolled_args, n, kk))

    run_config = load_run_config("tag_continuous")
    run_config["trainer"]["seed"] = 0
    max_abs["knn_obs_mxu"], train_rolled = _check_k2(run_config)
    max_abs["knn_obs_flat"], fast, fast_gen, fast_rolled = _check_k3()
    max_abs.update(_check_k4_k5())
    k6_k9_abs, knn_rolled = _check_k6_k9()
    max_abs.update(k6_k9_abs)
    for name, value in _check_warp_scan().items():
        max_abs[name] = max(max_abs[name], value)
    for algo in ("pallas_flat_exact", "pallas_onehot", "pallas_twolevel_exact",
                 "pallas_envlanes_exact"):
        _check_step_against_cpu(
            build_flagship(num_envs=4, fc_dims=(8, 8), seed=5,
                           knn_algorithm=algo, device=DEVICE),
            build_flagship(num_envs=4, fc_dims=(8, 8), seed=5,
                           knn_algorithm=algo, device="cpu"),
            f"flagship, {algo}")
    for algo in ("pallas_flat_exact", "pallas_tiled_exact",
                 "pallas_flat_mxudist", "pallas_envlanes_exact"):
        _check_step_against_cpu(
            build_many_agents(num_envs=4, seed=5, knn_algorithm=algo,
                              device=DEVICE),
            build_many_agents(num_envs=4, seed=5, knn_algorithm=algo,
                              device="cpu"),
            f"1024 agents, {algo}", steps=20,
            swap_class=algo == "pallas_flat_mxudist")

    _check_full_steps()

    no_launches = {name: 0 for name in knn_obs.LAUNCH_COUNTS}
    # 4a. the flagship rollout, counts from 0
    system["state"] = rolled
    loops, launches, _ = _drive_main_path(system, generator)
    for name, r in loops.items():
        print(f"{name}: {r['ms_per_step']:.4f} ms/step, "
              f"{r['env_steps_per_s']:.0f} env-steps/s at {NUM_ENVS} envs "
              f"x {system['num_agents']} agents ({MAIN_PATH_STEPS} steps, "
              f"host {r['host_s']:.3f} s); launches so far "
              f"{r['launches_after']}")
    expected = dict(no_launches, knn_obs_flat_exact=2 * MAIN_PATH_STEPS)
    assert launches == expected, f"launches {launches}, expected {expected}"
    assert loops["env_only_step"]["launches_after"] == dict(
        no_launches, knn_obs_flat_exact=MAIN_PATH_STEPS)
    _physics_path("4a flagship loops",
                  tag_physics.LAUNCH_COUNTS["tag_physics"],
                  2 * MAIN_PATH_STEPS)

    # 4b. the training path, counts from 0
    trainer, train_launches, train_times = _drive_training(run_config)
    steps_per_iter = trainer.training_batch_size_per_env * trainer.num_envs
    expected = dict(no_launches, knn_obs_mxu=trainer.num_iters
                    * trainer.training_batch_size_per_env)
    print(f"training: {trainer.num_iters} iterations of {steps_per_iter} "
          f"env-steps at {trainer.num_envs} envs x {trainer.engine.n_agents} "
          f"agents in {train_times['train_s']:.3f} s (setup "
          f"{train_times['setup_s']:.3f} s); launches {train_launches}")
    assert train_launches == expected, \
        f"launches {train_launches}, expected {expected}"
    _physics_path("4b tag_continuous training",
                  train_times["physics_launches"],
                  trainer.num_iters * trainer.training_batch_size_per_env)
    later = trainer.phase_ms[1:]
    roll_ms = statistics.mean(r for r, _ in later)
    upd_ms = statistics.mean(u for _, u in later)
    print(f"training iterations 2-{trainer.num_iters}, mean: rollout "
          f"{roll_ms:.3f} ms, update {upd_ms:.3f} ms, iteration "
          f"{roll_ms + upd_ms:.3f} ms, "
          f"{steps_per_iter / ((roll_ms + upd_ms) / 1e3):.0f} env-steps/s")
    _update_card_vs_cpu(trainer)

    # 4c. the 1024-agent loops, counts from 0 before each
    many, many_loops, many_launches = _drive_many_agents()

    # 4d. the pallas_flat flagship env-only loop, counts from 0
    fast_loop, fast_launches, _ = _time_loop(fast, fast_gen, MAIN_PATH_STEPS)
    print(f"pallas_flat env_only_step: {fast_loop['ms_per_step']:.4f} "
          f"ms/step, {fast_loop['env_steps_per_s']:.0f} env-steps/s at "
          f"{NUM_ENVS} envs x {fast['num_agents']} agents "
          f"({MAIN_PATH_STEPS} steps, host {fast_loop['host_s']:.3f} s); "
          f"launches {fast_launches}")
    expected = dict(no_launches, knn_obs_flat=MAIN_PATH_STEPS)
    assert fast_launches == expected, \
        f"launches {fast_launches}, expected {expected}"
    _physics_path("4d pallas_flat env_only_step",
                  fast_loop["physics_launches"], MAIN_PATH_STEPS)

    # 4e. the flagship loops of K6-K9, counts from 0 before each
    knn_loops, knn_launches = _drive_knn_loops(knn_rolled)

    # 4f. the full-step path's env-only loops, counts from 0 before each
    env_loops, env_loop_times = _drive_env_loops()

    # 4g. A2C training of the full-step path's run configs, counts from 0
    # before each, and one tag_gridworld update on the card vs the CPU
    full_trainers, full_train_means = _drive_full_step_training()
    _update_card_vs_cpu(full_trainers["tag_gridworld"])

    # 4h. DDPG training of its run configs, counts from 0 before each, and
    # one update on the card vs the CPU
    ddpg_trainers, ddpg_means = _drive_ddpg_training()
    for ddpg_trainer in ddpg_trainers.values():
        _ddpg_update_card_vs_cpu(ddpg_trainer)
    _check_ring_buffer()

    # 4i. evaluation, episode fetching and logging, counts from 0 before
    # each, and a full-state resume
    item9_launches = _drive_item9(ddpg_trainers["single_pendulum"], trainer)
    _check_ddpg_resume(ddpg_trainers["single_pendulum"])

    # 4j. the tuned flagship training stage, counts from 0 before each run,
    # and the update options on the card
    tuned, tuned_rec, tuned_launches, tuned_rec_launches, tuned_means = \
        _drive_tuned_training()
    _check_update_options(tuned)

    # 4k. the asymmetric_pursuit run config (separate placeholders, Dict
    # observations, action masks), counts from 0
    pursuit, pursuit_launches, pursuit_means = _drive_asymmetric_pursuit()

    # 4l. tag_continuous with the full observation, counts from 0
    full_obs, full_obs_launches, full_obs_means = _drive_full_obs_training()
    # 4t (f). its update in float64, card against CPU
    _full_obs_float64_update(full_obs)

    # 4m. the chem-search envs and DummyEnv, counts from 0
    chem_launches = _check_chem_and_dummy_steps()

    # 4n. serving the flagship's bundles at full width (K1) and the DDPG
    # actor's, counts from 0
    serving_launches = _drive_serving(ddpg_trainers["single_pendulum"], card)

    # 4o. the repo's JAX checkpoints on the card and the CPU (K2), counts
    # from 0
    ckpt_launches = _check_jax_checkpoints()

    # 4p. the eager host-env backend with the C++ steppers, counts from 0
    eager_launches = _drive_eager_backend()

    # 4q. the auto-scaler's probes in subprocesses, then the parent's
    # health; the full-observation batch (8.4 GB) is made again at need,
    # and every trainer's captured programs (their graphs' memory pools)
    # are captured again at need
    full_obs._batch = None
    _release_programs(trainer, *full_trainers.values(), tuned, tuned_rec,
                      pursuit, full_obs)
    _memory_line("before 4q")
    _check_autoscaler_probes(system, generator)

    # 4r. the tag_continuous run config over process meshes: a one-rank
    # NCCL group, two gloo ranks and a dp1 x tp2 pair on the card, and the
    # multi-device dry run; counts from 0 before each run
    _memory_line("before 4r")
    multi_launches = _drive_multi_device(card)
    _memory_line("before 4s")

    # 4s. the compiled iteration: captured loops and programmed training
    # against the eager ones, counts from 0 before each run
    compiled_launches = _drive_compiled_iteration(
        rolled, many["pallas_flat_exact"]["state"], run_config)

    # 4t. the rest of the compiled execution model against its eager
    # counterparts, counts from 0 before each run: DDPG, evaluation and
    # fetching, the facade, the eager backend, a one-rank NCCL group
    t_4t = time.perf_counter()
    _drive_ddpg_programs()
    programs_launches = _drive_episode_programs(
        trainer, ddpg_trainers["single_pendulum"])
    for name, count in _drive_facade_programs().items():
        programs_launches[name] += count
    _drive_eager_backend_programs()
    for name, count in _drive_nccl_programs().items():
        programs_launches[name] += count
    print(f"phase 4t {time.perf_counter() - t_4t:.1f} s; launches "
          f"{programs_launches}")

    physics_launches = sum(_PHYSICS_PATHS.values())
    print(f"physics launches on the main paths: {physics_launches} "
          f"({_PHYSICS_PATHS})")

    # 5. kernel vs plain and their times at the main paths' shapes
    many_args = _knn_args(many["pallas_flat_exact"]["env"],
                          many["pallas_flat_exact"]["state"])
    big = dict(plain_repeats=3, plain_inner=2)  # plain at 256 x 1024: ~GiB
    many_label = f"1024-agent state, {MANY_AGENT_ENVS} envs"
    # the main paths' modes first: they fill the kernels line
    timed = {
        "knn_obs_flat_exact": _time_knn(
            "knn_obs_flat_exact", rolled_args, n, kk, "flat_exact",
            "flagship state"),
        "knn_obs_mxu": _time_knn(
            "knn_obs_mxu", *train_rolled, "mxu_exact", "training state"),
        "knn_obs_flat": _time_knn(
            "knn_obs_flat", *fast_rolled, "flat", "pallas_flat flagship "
            "state"),
        "knn_obs_flat_mxudist": _time_knn(
            "knn_obs_flat_mxudist", *many_args, "flat_mxudist", many_label,
            **big),
        "knn_obs_tiled": _time_knn(
            "knn_obs_tiled", *many_args, "tiled_exact", many_label, **big),
        "knn_obs_packed": _time_knn(
            "knn_obs_packed", *knn_rolled["pallas"][2], "packed",
            "pallas flagship state"),
        "knn_obs_onehot": _time_knn(
            "knn_obs_onehot", *knn_rolled["pallas_onehot"][2], "onehot",
            "pallas_onehot flagship state"),
        "knn_obs_twolevel": _time_knn(
            "knn_obs_twolevel", *knn_rolled["pallas_twolevel_exact"][2],
            "twolevel_exact", "pallas_twolevel_exact flagship state"),
        "knn_obs_envlanes": _time_knn(
            "knn_obs_envlanes", *knn_rolled["pallas_envlanes_exact"][2],
            "envlanes_exact", "pallas_envlanes_exact flagship state"),
    }
    at_1024 = {
        "knn_obs_flat_exact": _time_knn(
            "knn_obs_flat_exact", *many_args, "flat_exact", many_label,
            **big),
        "knn_obs_flat_mxudist": timed["knn_obs_flat_mxudist"],
        "knn_obs_tiled": timed["knn_obs_tiled"],
        "knn_obs_envlanes": _time_knn(
            "knn_obs_envlanes", *many_args, "envlanes_exact", many_label,
            **big),
    }
    others = [
        ("knn_obs_mxu", _time_knn("knn_obs_mxu", rolled_args, n, kk,
                                  "mxu_exact", "flagship state")),
        ("knn_obs_mxu", _time_knn("knn_obs_mxu", *train_rolled, "mxu",
                                  "training state")),
        ("knn_obs_flat_mxudist", _time_knn(
            "knn_obs_flat_mxudist", *many_args, "flat_mxudist_exact",
            many_label, **big)),
        ("knn_obs_flat_mxudist", _time_knn(
            "knn_obs_flat_mxudist", rolled_args, n, kk, "flat_mxudist",
            "flagship state")),
        ("knn_obs_tiled", _time_knn("knn_obs_tiled", *many_args,
                                    "tiled_mxudist", many_label, **big)),
        ("knn_obs_twolevel", _time_knn(
            "knn_obs_twolevel", *knn_rolled["pallas_twolevel"][2],
            "twolevel", "pallas_twolevel flagship state")),
        ("knn_obs_envlanes", _time_knn(
            "knn_obs_envlanes", *knn_rolled["pallas_envlanes"][2],
            "envlanes", "pallas_envlanes flagship state")),
    ]
    for name, r in [*timed.items(), *at_1024.items(), *others]:
        max_abs[name] = max(max_abs[name], r["max_abs_err"])
    # K1 at the tuned stage's shapes: its rollout state (2000 envs) and the
    # first minibatch's rows under update_recompute_obs (5 envs x 100 steps)
    rows = {k: v.transpose(0, 1)[:TUNED_ENVS // TUNED_MINIBATCHES]
            .reshape((-1,) + v.shape[2:])
            for k, v in tuned_rec._batch["phys"].items()}
    for label, state in ((f"tuned stage state, {TUNED_ENVS} envs",
                          tuned._env_state),
                         ("tuned stage recompute minibatch, "
                          f"{TUNED_ENVS // TUNED_MINIBATCHES} envs x "
                          f"{TUNED_STEPS} steps", rows)):
        r = _time_knn("knn_obs_flat_exact",
                      *_knn_args(tuned.engine.env, state), "flat_exact",
                      label)
        max_abs["knn_obs_flat_exact"] = max(max_abs["knn_obs_flat_exact"],
                                            r["max_abs_err"])
    _launch_floor()  # what K2's training-shape times compare with
    # the physics kernel at the flagship's and the training config's shapes
    physics = {
        "flagship": _time_physics(env, rolled, "flagship state"),
        "training": _time_physics(
            *_training_env_state(run_config, ROLLED_STEPS, seed=1),
            "training state"),
    }
    for variant in ("tiled", "tiled_mxudist_exact"):  # K5's other modes
        max_abs["knn_obs_tiled"] = max(max_abs["knn_obs_tiled"], _compare_knn(
            many_label, *many_args, variant, tol=EXACT_TOL))
    env_only_ms = loops["env_only_step"]["ms_per_step"]
    rollout_step_ms = roll_ms / trainer.training_batch_size_per_env
    print(f"knn_obs_flat_exact share of env_only_step "
          f"{100 * timed['knn_obs_flat_exact']['ms'] / env_only_ms:.1f}%; "
          f"knn_obs_mxu share of a training rollout step "
          f"{100 * timed['knn_obs_mxu']['ms'] / rollout_step_ms:.1f}%; "
          f"knn_obs_flat share of the pallas_flat env_only_step "
          f"{100 * timed['knn_obs_flat']['ms'] / fast_loop['ms_per_step']:.1f}"
          "%")
    for algo, kernel, _ in FLAGSHIP_KNN_LOOPS[:4]:
        step_ms = knn_loops[algo, "env_only_step"]["ms_per_step"]
        print(f"{kernel} share of the {algo} env_only_step "
              f"{100 * timed[kernel]['ms'] / step_ms:.1f}% "
              f"({timed[kernel]['ms']:.5f} of {step_ms:.4f} ms)")
    for algo, kernel in MANY_AGENT_LOOPS:
        step_ms = many_loops[algo]["ms_per_step"]
        print(f"{kernel} share of the 1024-agent {algo} step "
              f"{100 * at_1024[kernel]['ms'] / step_ms:.1f}% "
              f"({at_1024[kernel]['ms']:.5f} of {step_ms:.4f} ms)")

    # the profiler tables last: a window of a million events (the tuned
    # update) has left later profiling recording no kernel
    if args.profile:
        windows = [
            (loop, _stepper(system, generator, loop), "step",
             loops[loop]["ms_per_step"])
            for loop in ("env_only_step", "full_loop_step")
        ]
        windows.append(("training iteration",
                        lambda: trainer._iteration(trainer.current_timestep),
                        "iteration", roll_ms + upd_ms))
        windows += [
            (f"1024-agent {algo}", _stepper(m, m["generator"],
                                            "env_only_step"),
             "step", many_loops[algo]["ms_per_step"])
            for algo, m in many.items()
        ]
        windows.append(("pallas_flat env_only_step",
                        _stepper(fast, fast_gen, "env_only_step"), "step",
                        fast_loop["ms_per_step"]))
        windows += [
            (f"{loop} [{algo}]", _stepper(knn_rolled[algo][0],
                                          knn_rolled[algo][1], loop),
             "step", r["ms_per_step"])
            for (algo, loop), r in knn_loops.items()
        ]
        windows += [
            (f"{label} env_only_step", _stepper(m, m["generator"],
                                                "env_only_step"),
             "step", env_loop_times[label]["ms_per_step"])
            for label, m in env_loops.items()
        ]
        windows += [
            (f"training iteration [{name}]",
             lambda t=t: t._iteration(t.current_timestep), "iteration",
             means[name][0] + means[name][1])
            for trainers, means in (
                (full_trainers, full_train_means),
                (ddpg_trainers, ddpg_means),
                ({"asymmetric_pursuit": pursuit},
                 {"asymmetric_pursuit": pursuit_means}),
                ({"tag_continuous, full observation": full_obs},
                 {"tag_continuous, full observation": full_obs_means}))
            for name, t in trainers.items()
        ]
        tuned_t = tuned.current_timestep
        windows += [
            ("tuned flagship rollout",
             lambda: tuned._rollout_phase(tuned_t), "iteration",
             tuned_means["rollout_ms"]),
            ("tuned flagship update",
             lambda: tuned._update_phase(tuned._batch, tuned_t), "iteration",
             tuned_means["update_ms"]),
        ]
        _profile(windows)

    # launches on the main paths: 4a, 4c, 4j, 4n, 4r, 4s and 4t for K1,
    # 4b, 4i, 4o, 4r, 4s and 4t for K2, 4d for K3, 4c for K4 and K5, 4e for
    # K6-K8,
    # 4c and 4e for K9; 4k-4m and 4p launch none
    all_launches = {name: launches[name] + train_launches[name]
                    + multi_launches[name] + compiled_launches[name]
                    + programs_launches[name]
                    + item9_launches[name] + fast_launches[name]
                    + tuned_launches[name] + tuned_rec_launches[name]
                    + pursuit_launches[name] + full_obs_launches[name]
                    + chem_launches[name] + serving_launches[name]
                    + ckpt_launches[name] + eager_launches[name]
                    + sum(c[name] for c in many_launches.values())
                    + sum(c[name] for c in knn_launches.values())
                    for name in knn_obs.LAUNCH_COUNTS}
    kernels = []
    for name, info in knn_obs.KERNELS.items():
        assert all_launches[name] > 0, f"{name} never launched on a path"
        kernels.append({
            "name": name,
            "route": info["route"],
            "source": info["source"],
            "replaces": info["replaces"],
            "launches": all_launches[name],
            "max_abs_err": max_abs[name],
            **{key: timed[name][key]
               for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                           "bound_by")},
            "library_ms": None,
        })
        if name == "knn_obs_flat_mxudist":
            kernels[-1]["swap_share"] = _K4_SWAP["share"]
            kernels[-1]["swap_worst_gap_of_W"] = _K4_SWAP["worst_gap_of_W"]
    # the physics kernel: its launches on the main paths of 4a-4l, each
    # counted on its own path and checked (``_PHYSICS_PATHS``), and its
    # times at the flagship's shape (the training shape's in its own record)
    kernels.append({
        "name": "tag_physics",
        **tag_physics.KERNEL,
        "launches": physics_launches,
        "max_abs_err": max(r["max_abs_err"] for r in physics.values()),
        **{key: physics["flagship"][key]
           for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                       "bound_by")},
        "training_shape": {key: physics["training"][key]
                           for key in ("ms", "device_ms", "plain_ms",
                                       "bound_ms")},
        "library_ms": None,
    })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
