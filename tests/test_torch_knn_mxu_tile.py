"""The swap class of kernel K4 (``flat_mxudist[_exact]``), whose MXU
distance the card forms on the tensor cores (``csrc/knn_common.cuh:
tile_kernel``): the tensor cores sum the 12 expansion terms in their own
order, perhaps with truncating adds, so kernel and plain version may pick
different neighbours where two distances lie within the summation error.

Here, on the CPU: (1) every other float32 order of the sum -- reversed,
pairwise and in blocks of four, each with rounded and with emulated
truncating adds -- lies within 2e of the plain version's sequential sum,
e = 16 * 2^-23 * sum_t |term_t| (``knn_obs.summation_window``), on random
states and on a 1024-agent state rolled with the port's CPU path; (2) the
gate that ``chip_smoke.py`` and the card tests hold K4 to
(``knn_obs.check_swap_class``) passes an allowed near-tie swap and fails
a swap outside its window W, a changed valid bit, a changed feature, a
candidate picked twice and, where bounded, a swap share of 2e-3 or more;
(3) the tile's geometry that the wrapper's staging limit copies is the
one the CUDA sources set."""

import re

import numpy as np
import pytest
import torch

from warpdrive_tpu_torch.ops import cuda_build, knn_obs
from warpdrive_tpu_torch.presets import build_many_agents

F32 = np.float32
K4_VARIANTS = ["flat_mxudist", "flat_mxudist_exact"]


def _random_args(E, N, seed, box=20.0):
    rng = np.random.RandomState(seed)
    arrays = (rng.uniform(0, box, (E, N)).astype(F32),
              rng.uniform(0, box, (E, N)).astype(F32),
              rng.uniform(-1, 1, (E, 5, N)).astype(F32),
              (rng.uniform(size=N) < 0.2).astype(F32),
              (rng.uniform(size=(E, N)) > 0.2).astype(F32),
              rng.uniform(0, 1, E).astype(F32))
    return tuple(torch.from_numpy(a) for a in arrays)


def _rolled_many_agents(steps=3):
    system = build_many_agents(num_envs=2, seed=1, device="cpu",
                               knn_algorithm="pallas_flat_mxudist")
    gen = torch.Generator().manual_seed(1)
    state, checksum = system["state"], torch.zeros(())
    for _ in range(steps):
        state, checksum = system["env_only_step"]((state, checksum), gen)
    return state["loc_x"].contiguous(), state["loc_y"].contiguous()


def _terms(loc_x, loc_y):
    """Every (observer, candidate) pair's 12 exact float32 terms, padded
    with 4 zeros to the tile's 16: (E, N_i, N_j, 16)."""
    centred = knn_obs.centred_coords(loc_x, loc_y)
    amat, bmat = knn_obs.expansion_operands(centred[:, 0], centred[:, 1])
    terms = (amat.to(torch.float32)[:, None, :, :]
             * bmat.to(torch.float32).transpose(1, 2)[:, :, None, :])
    return torch.cat([terms, torch.zeros_like(terms[..., :4])], dim=-1)


def _truncating_add(a, b):
    """a + b in float32 rounded toward zero: the exact sum (in float64,
    where the sum of two float32 values is exact up to 2^-53) truncated."""
    exact = a.to(torch.float64) + b.to(torch.float64)
    near = exact.to(torch.float32)
    over = near.to(torch.float64).abs() > exact.abs()
    return torch.where(over, torch.nextafter(near, torch.zeros_like(near)),
                       near)


def _rounding_add(a, b):
    return a + b


def _sequential(terms, add, order):
    d = terms[..., order[0]]
    for t in order[1:]:
        d = add(d, terms[..., t])
    return d


def _pairwise(terms, add):
    parts = [terms[..., t] for t in range(terms.shape[-1])]
    while len(parts) > 1:
        parts = [add(parts[m], parts[m + 1]) for m in range(0, len(parts), 2)]
    return parts[0]


def _blocks_of_four(terms, add):
    blocks = [_sequential(terms, add, range(b, b + 4))
              for b in range(0, terms.shape[-1], 4)]
    return _sequential(torch.stack(blocks, dim=-1), add, range(len(blocks)))


@pytest.mark.parametrize("state", ["random-105", "random-1024", "rolled-1024"])
def test_reordered_sums_stay_within_2e_of_the_sequential_one(state):
    if state == "rolled-1024":
        loc_x, loc_y = _rolled_many_agents()
        loc_x, loc_y = loc_x[:1], loc_y[:1]
    else:
        N = int(state.split("-")[1])
        loc_x, loc_y = _random_args(2 if N == 105 else 1, N, seed=N)[:2]
    terms = _terms(loc_x, loc_y)
    plain = _sequential(terms, _rounding_add, range(knn_obs._EXPANSION_TERMS))
    centred = knn_obs.centred_coords(loc_x, loc_y)
    plain_d2 = knn_obs.expansion_sq_dist(*knn_obs.expansion_operands(
        centred[:, 0], centred[:, 1]))
    # the plain version's own distance, before its clamp
    assert torch.equal(torch.clamp(plain, min=0.0) + 0.0, plain_d2)
    bound = 2 * knn_obs.summation_window(terms)
    for add in (_rounding_add, _truncating_add):
        for other in (_sequential(terms, add, range(15, -1, -1)),
                      _pairwise(terms, add), _blocks_of_four(terms, add)):
            gap = (other - plain).abs()
            assert bool((gap <= bound).all()), float((gap - bound).max())
        # the orders do differ somewhere: the window is not vacuous
        assert bool((_pairwise(terms, add) != plain).any())


def _tie_args():
    """One env of 15 live agents around an observer at (10, 10): agents 1
    and 2 at distance 1 on either side, six pairs symmetric about (10, 10)
    farther out.  Every centred coordinate is a small integer, exact in
    bf16, so every order of the sum gives d2 = 1 for both agents 1 and 2:
    an exact tie, which the plain version breaks by the lower index."""
    xs = [10, 11, 9]
    ys = [10, 10, 10]
    for dx, dy in ((3, 4), (-5, 2), (6, -1), (2, 7), (-4, -6), (8, 3)):
        xs += [10 + dx, 10 - dx]
        ys += [10 + dy, 10 - dy]
    rng = np.random.RandomState(2)
    loc_x = torch.tensor([xs], dtype=torch.float32)
    loc_y = torch.tensor([ys], dtype=torch.float32)
    feats = torch.from_numpy(rng.uniform(-1, 1, (1, 5, 15)).astype(F32))
    types_f = torch.zeros(15)
    types_f[::4] = 1.0
    return (loc_x, loc_y, feats, types_f, torch.ones(1, 15),
            torch.tensor([0.5]))


def _swap_slots(out, k, e, i, s, t):
    """``out`` with slots s and t of observer (e, i) exchanged."""
    swapped = out.clone()
    row = swapped[e, i, :-1].reshape(k, 8)
    row[[s, t]] = row[[t, s]]
    return swapped


@pytest.mark.parametrize("variant", K4_VARIANTS)
def test_gate_passes_an_allowed_near_tie_swap(variant):
    args = _tie_args()
    k = 4
    ref = knn_obs.knn_observation_plain(*args, n_agents=15, k=k,
                                        variant=variant)
    report = knn_obs.check_swap_class(ref.clone(), ref, args, k, variant,
                                      bound_share=False)
    assert report["swaps"] == 0 and report["share"] == 0.0
    # observer 0's first two slots hold agents 1 and 2 at d2 = 1 each
    swapped = _swap_slots(ref, k, 0, 0, 0, 1)
    report = knn_obs.check_swap_class(swapped, ref, args, k, variant,
                                      bound_share=False)
    assert report["swaps"] == 2 and report["worst_ratio"] == 0.0
    # 15 rows of 33 entries: the swap's share is far above the bound
    with pytest.raises(ValueError, match="condition 4"):
        knn_obs.check_swap_class(swapped, ref, args, k, variant)


@pytest.mark.parametrize("variant", K4_VARIANTS)
def test_gate_fails_a_candidate_picked_twice(variant):
    """Plain picks agents 1 and 2 (an exact tie) in observer 0's first two
    slots; a kernel that wrote agent 1 into both keeps each slot within W
    of the plain pick, but picks one candidate twice."""
    args = _tie_args()
    k = 4
    ref = knn_obs.knn_observation_plain(*args, n_agents=15, k=k,
                                        variant=variant)
    report = knn_obs.check_swap_class(ref.clone(), ref, args, k, variant,
                                      bound_share=False)
    assert report["max_abs"] == 0.0
    twice = ref.clone()
    twice[0, 0, 8:16] = ref[0, 0, 0:8]
    with pytest.raises(ValueError, match="picked twice"):
        knn_obs.check_swap_class(twice, ref, args, k, variant,
                                 bound_share=False)
    swapped = _swap_slots(ref, k, 0, 0, 0, 1)
    report = knn_obs.check_swap_class(swapped, ref, args, k, variant,
                                      bound_share=False)
    assert report["max_abs"] == float((swapped - ref).abs().max()) > 0.0


@pytest.mark.parametrize("variant", K4_VARIANTS)
def test_gate_fails_what_the_swap_class_does_not_allow(variant):
    E, N, k = 4, 64, 10
    args = _random_args(E, N, seed=9)
    ref = knn_obs.knn_observation_plain(*args, n_agents=N, k=k,
                                        variant=variant)
    report = knn_obs.check_swap_class(ref.clone(), ref, args, k, variant)
    assert report["swaps"] == 0
    live = int(torch.nonzero(args[4][0] >= 0.5)[0])
    # a swap of the nearest and the third nearest: far outside W
    with pytest.raises(ValueError, match="condition 3"):
        knn_obs.check_swap_class(_swap_slots(ref, k, 0, live, 0, 2), ref,
                                 args, k, variant)
    changed = ref.clone()
    changed[0, live, 7] = 0.0  # slot 0's valid bit
    with pytest.raises(ValueError, match="condition 1"):
        knn_obs.check_swap_class(changed, ref, args, k, variant)
    changed = ref.clone()
    changed[0, live, 8 * 3 + 1] += 1e-3  # slot 3's rel_y
    with pytest.raises(ValueError, match="condition 2"):
        knn_obs.check_swap_class(changed, ref, args, k, variant)
    dead = int(torch.nonzero(args[4][0] < 0.5)[0])
    changed = ref.clone()
    changed[0, dead, -1] = 0.5  # a dead observer's zero row
    with pytest.raises(ValueError, match="condition 1"):
        knn_obs.check_swap_class(changed, ref, args, k, variant)


def _bucket_args():
    """One env of 1024 live agents whose mean is exactly (0, 0), with the
    observer 0 there, agent 1 at (1, 0) and agent 2 at (-(1 + 2^-15), 0);
    every coordinate takes at most 16 bits, so the bf16 hi/lo pairs hold
    it exactly.  Agent 2's d2 is 1 + 2^-14, 512 ulps above agent 1's 1:
    outside the summation window W = 4e (about 7.6e-6 here), inside one
    bucket of the 10-bit packed key at N = 1024."""
    rng = np.random.RandomState(5)
    xs = [0.0, 1.0, -(1.0 + 2.0 ** -15), 2.0 ** -15, 0.0, 0.0]
    ys = [0.0, 0.0, 0.0, 25.0, -12.0, -13.0]
    pairs = rng.randint(5, 31, (509, 2)) * rng.choice([-1, 1], (509, 2))
    for dx, dy in pairs:
        xs += [dx, -dx]
        ys += [dy, -dy]
    loc_x = torch.tensor([xs], dtype=torch.float32)
    loc_y = torch.tensor([ys], dtype=torch.float32)
    feats = torch.from_numpy(rng.uniform(-1, 1, (1, 5, 1024)).astype(F32))
    return (loc_x, loc_y, feats, torch.zeros(1024), torch.ones(1, 1024),
            torch.tensor([0.5]))


@pytest.mark.parametrize("variant", K4_VARIANTS)
def test_packed_window_takes_in_one_bucket(variant):
    """In the packed order two candidates within one packed bucket (2^b
    ulps) may swap even where the summation window alone does not take the
    swap in; in the exact order they may not."""
    args = _bucket_args()
    assert float(knn_obs.centred_coords(args[0], args[1]).abs()[0, :, 0]
                 .max()) == 0.0
    k = 4
    ref = knn_obs.knn_observation_plain(*args, n_agents=1024, k=k,
                                        variant=variant)
    swapped = _swap_slots(ref, k, 0, 0, 0, 1)  # agents 1 and 2
    if variant == "flat_mxudist":
        report = knn_obs.check_swap_class(swapped, ref, args, k, variant)
        assert report["swaps"] == 2 and 0.4 < report["worst_ratio"] < 1.0
    else:
        with pytest.raises(ValueError, match="condition 3"):
            knn_obs.check_swap_class(swapped, ref, args, k, variant)


def test_wrapper_copies_the_tiles_geometry_from_the_sources():
    """``knn_obs.staged_bytes`` sizes K4's staging from copies of the
    tile's constants; they must be the ones ``csrc/`` builds with."""
    text = "".join((cuda_build.CSRC_DIR / name).read_text()
                   for name in ("knn_common.cuh", "knn_obs.cu"))

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert constant("kTileRows") == knn_obs._TILE_ROWS
    assert constant("kTileDepth") == knn_obs._TILE_DEPTH
    assert constant("kTileChunk") == knn_obs._TILE_CHUNK
    assert constant("kTileMinAgents") == knn_obs._TILE_MIN_AGENTS
    assert constant("kTerms") == knn_obs._EXPANSION_TERMS
