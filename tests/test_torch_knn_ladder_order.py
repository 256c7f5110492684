"""A numpy model of the ladder kernels' passes (``ladder_kernel`` in
``warpdrive_tpu_torch/csrc/knn_obs_ladder.cu``), the selection of K6
(``packed``), K7 (``onehot``) and K8 (``twolevel[_exact]``) on the card,
held against the order of ``knn_observation_plain``.

The model does what a warp does for one observer, for every observer at
once.  Candidate ``j = lane + 32q`` (q < 4) sits in lane ``j % 32`` as a
32-bit key: ``bits(d2)`` as unsigned in the exact order, the int32
``(bits(d2) & ~127) | j`` in the 7-bit packed one; self, dead and missing
candidates hold the all-ones key (``INT_MAX`` packed).  Each lane sorts its
four entries by (key, j) and a pass reads the lanes' heads: the warp's
least key (one ``__reduce_min_sync``); in the exact order, the least j
among the heads at that key (a second one); the winner's lane pops its
head.  The passes stop at the first key at or above ``bits(1e18)``, and
the winners go to a table of k indices from which the row is written.  A
second model takes the passes without the sort (each lane's local min and
the lowest q that holds it, only the winner's entry knocked out); the two
give the same tables.  The rows built from the tables must equal the plain
version's bit for bit on random states, exact-tie lattices, several
candidates at one d2 in one lane and across lanes, the N = 15 packed
near-tie, a third of the agents dead, N = 1, 33, 64, 105 and 128, and k =
1, 10, 16 and k = n = 128.  The CUDA kernels are held against the same plain version on the card
(``chip_smoke.py``, ``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import torch

from test_torch_knn_warp_order import _inputs, near_tie_coords
from warpdrive_tpu_torch.ops import knn_obs

LANES = 32
PER_LANE = 4  # N <= 128
F32 = np.float32
EXACT_INVALID = np.uint32(0xFFFFFFFF)
PACKED_INVALID = np.int32(np.iinfo(np.int32).max)
VALID_LIMIT = np.float32(knn_obs._VALID_MAX).view(np.int32)
LADDER = ("onehot", "twolevel_exact", "packed", "twolevel")


def _state(E, N, seed, state):
    """``_inputs`` of the warp-scan model, and two states of its own:
    "dead-third", random with about a third of the agents dead, and
    "lane-ties", where twelve candidates lie at d2 = 25 exactly from
    observer 0 of every env, four of them in lane 5 and others in lanes 0,
    1, 2, 3, 4, 8 and 31."""
    if state == "dead-third":
        inputs = list(_inputs(E, N, seed, "random"))
        rng = np.random.RandomState(seed + 1)
        inputs[4] = (rng.uniform(size=(E, N)) >= 1 / 3).astype(F32)
        return tuple(inputs)
    if state == "lane-ties":
        inputs = list(_inputs(E, N, seed, "random"))
        loc_x = np.linspace(1.0, 19.0, N, dtype=F32)[None].repeat(E, 0)
        loc_y = np.full((E, N), 1.0, F32)
        offsets = [(3, 4), (4, 3), (-3, -4), (-4, -3), (5, 0), (0, 5),
                   (-5, 0), (0, -5), (3, -4), (-4, 3), (-3, 4), (4, -3)]
        loc_x[:, 0] = loc_y[:, 0] = 10.0
        for j, (dx, dy) in zip(LANE_TIES, offsets):
            loc_x[:, j] = 10.0 + dx
            loc_y[:, j] = 10.0 + dy
        inputs[0], inputs[1] = loc_x, loc_y
        inputs[4] = np.ones((E, N), F32)
        return tuple(inputs)
    return _inputs(E, N, seed, state)


# observer 0's twelve candidates at d2 = 25 in the "lane-ties" state
LANE_TIES = (5, 37, 69, 101, 3, 40, 64, 96, 1, 2, 100, 127)


def lane_keys(inputs, variant):
    """Each observer's candidates as the kernel holds them: keys and
    indices (O, 32, 4), candidate j = lane + 32q at [lane, q], and whether
    the order is exact."""
    loc_x, loc_y, _, _, still_f, _ = inputs
    E, N = loc_x.shape
    dx = loc_x[:, None, :] - loc_x[:, :, None]  # [e, i, j]
    dy = loc_y[:, None, :] - loc_y[:, :, None]
    d2 = (dx * dx + dy * dy).astype(F32)
    candidate = (still_f >= 0.5)[:, None, :] & ~np.eye(N, dtype=bool)
    bits = knn_obs.packed_bits(variant, N)
    exact = bits == 0
    if exact:
        key = np.where(candidate, d2.view(np.uint32), EXACT_INVALID)
    else:
        assert bits == 7
        packed = (d2.view(np.int32) & ~127) | np.arange(N, dtype=np.int32)
        key = np.where(candidate, packed, PACKED_INVALID)
    key = key.reshape(E * N, N)
    invalid = EXACT_INVALID if exact else PACKED_INVALID
    full = np.full((E * N, LANES * PER_LANE), invalid, key.dtype)
    full[:, :N] = key
    # [o, lane, q] = candidate lane + 32q
    lanes = full.reshape(E * N, PER_LANE, LANES).transpose(0, 2, 1).copy()
    idx = (np.arange(LANES)[:, None]
           + LANES * np.arange(PER_LANE)[None, :]).astype(np.int64)
    return lanes, np.broadcast_to(idx, lanes.shape).copy(), exact


def _is_valid(m, exact):
    if exact:
        return m < VALID_LIMIT.astype(np.uint32)
    return m < VALID_LIMIT


def ladder_sorted(key, idx, exact, k):
    """The kernel's passes: each lane's entries sorted by (key, j), a pass
    over the heads.  Returns the winner table (O, k), -1 past the valid
    winners, and each observer's count of valid winners."""
    O = key.shape[0]
    order = np.lexsort((idx, key), axis=-1)
    key = np.take_along_axis(key, order, -1)
    idx = np.take_along_axis(idx, order, -1)
    invalid = EXACT_INVALID if exact else PACKED_INVALID
    table = np.full((O, k), -1, np.int64)
    n_valid = np.zeros(O, np.int64)
    going = np.ones(O, bool)
    for s in range(k):
        head, head_j = key[:, :, 0], idx[:, :, 0]
        m = head.min(axis=1)  # the first REDUX
        if exact:
            at_m = head == m[:, None]
            w = np.where(at_m, head_j, np.iinfo(np.int64).max).min(axis=1)
            won = head_j == w[:, None]  # the second REDUX's lane
        else:
            w = (m & 127).astype(np.int64)
            won = head == m[:, None]  # keys are unique
        going &= _is_valid(m, exact)  # the passes stop at the first invalid
        table[going, s] = w[going]
        n_valid += going
        popped_key = np.concatenate(
            [key[:, :, 1:], np.full((O, LANES, 1), invalid, key.dtype)], -1)
        popped_idx = np.concatenate(
            [idx[:, :, 1:], np.zeros((O, LANES, 1), idx.dtype)], -1)
        key = np.where(won[..., None], popped_key, key)
        idx = np.where(won[..., None], popped_idx, idx)
    return table, n_valid


def ladder_knockout(key, idx, exact, k):
    """The passes without the sort: each lane's local min over its four
    entries and the lowest q that holds it, the warp's min, in the exact
    order the least index among the lanes at the min; only the winning
    entry is knocked out."""
    O = key.shape[0]
    key = key.copy()
    invalid = EXACT_INVALID if exact else PACKED_INVALID
    table = np.full((O, k), -1, np.int64)
    n_valid = np.zeros(O, np.int64)
    going = np.ones(O, bool)
    for s in range(k):
        q_low = key.argmin(axis=2)  # argmin takes the lowest q at the min
        local = np.take_along_axis(key, q_low[..., None], 2)[..., 0]
        m = local.min(axis=1)
        if exact:
            low_j = np.take_along_axis(idx, q_low[..., None], 2)[..., 0]
            w = np.where(local == m[:, None], low_j,
                         np.iinfo(np.int64).max).min(axis=1)
        else:
            w = (m & 127).astype(np.int64)
        going &= _is_valid(m, exact)
        table[going, s] = w[going]
        n_valid += going
        key = np.where(idx == w[:, None, None], invalid, key)
    return table, n_valid


def rows_of(inputs, table, n_valid, k):
    """(E, N, 8k+1) observation rows from the winner tables."""
    _, _, feats, types_f, still_f, t_norm = inputs
    E, N = still_f.shape
    idx = np.maximum(table, 0).reshape(E, N, k)
    gate = (np.arange(k) < n_valid.reshape(E, N, 1)) & (
        still_f >= 0.5)[..., None]
    nbr = np.stack([feats[e][:, idx[e]] for e in range(E)])  # (E, 5, N, k)
    rel = nbr - feats[:, :, :, None]
    slots = np.zeros((E, N, k, 8), F32)
    slots[..., :5] = np.where(gate[..., None], rel.transpose(0, 2, 3, 1), 0)
    slots[..., 5] = np.where(gate, types_f[idx], 0)
    slots[..., 6] = slots[..., 7] = gate
    t_col = np.where(still_f >= 0.5, t_norm[:, None], 0)[..., None]
    return np.concatenate([slots.reshape(E, N, 8 * k), t_col], axis=2)


def _plain(inputs, k, variant):
    E, N = inputs[0].shape
    return knn_obs.knn_observation_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in inputs),
        n_agents=N, k=k, variant=variant).numpy()


CASES = [
    ("random", 2, 1, 1), ("random", 3, 33, 1), ("random", 3, 33, 10),
    ("random", 3, 33, 16), ("random", 2, 64, 10), ("random", 2, 64, 16),
    ("random", 4, 105, 1), ("random", 4, 105, 10), ("random", 2, 128, 16),
    ("lattice", 3, 64, 10), ("lattice", 3, 105, 10), ("lattice", 2, 128, 16),
    ("near-tie", 2, 15, 2), ("near-tie", 2, 15, 10),
    ("dead-third", 3, 33, 16), ("dead-third", 3, 105, 10),
    ("lane-ties", 1, 128, 16),
]
# the per-slot kernels K6 and K7 take k up to n: the table at its largest
FULL_K_CASES = [("random", 2, 128, 128), ("lattice", 2, 128, 128),
                ("dead-third", 2, 128, 128), ("lane-ties", 1, 128, 128)]


def _ids(cases):
    return [f"{s}-E{E}-N{N}-k{k}" for s, E, N, k in cases]


def _check(state, E, N, k, variant):
    inputs = _state(E, N, seed=N + k, state=state)
    key, idx, exact = lane_keys(inputs, variant)
    table, n_valid = ladder_sorted(key, idx, exact, k)
    np.testing.assert_array_equal(rows_of(inputs, table, n_valid, k),
                                  _plain(inputs, k, variant))
    return inputs, key, idx, exact, table, n_valid


@pytest.mark.parametrize("variant", LADDER)
@pytest.mark.parametrize("state,E,N,k", CASES, ids=_ids(CASES))
def test_ladder_rows_equal_the_plain_order(state, E, N, k, variant):
    _check(state, E, N, k, variant)


@pytest.mark.parametrize("variant", ["onehot", "packed"])
@pytest.mark.parametrize("state,E,N,k", FULL_K_CASES, ids=_ids(FULL_K_CASES))
def test_per_slot_ladder_rows_equal_the_plain_order_at_k_n(state, E, N, k,
                                                           variant):
    """k = n = 128: the table's 128 slots, past every observer's 127
    candidates, so the passes stop early on every row."""
    *_, n_valid = _check(state, E, N, k, variant)
    assert n_valid.max() <= N - 1


@pytest.mark.parametrize("variant", LADDER)
@pytest.mark.parametrize("state,N,k", [("random", 105, 10),
                                       ("lattice", 128, 16),
                                       ("lane-ties", 128, 16),
                                       ("dead-third", 33, 16)])
def test_sorted_heads_equal_the_knockout_passes(state, N, k, variant):
    """Sorting each lane's entries once and passing over the heads takes
    the same winners as the lane-local min with its lowest q and a
    knock-out of the winning entry."""
    inputs = _state(2, N, seed=N, state=state)
    key, idx, exact = lane_keys(inputs, variant)
    sorted_table, sorted_n = ladder_sorted(key, idx, exact, k)
    knockout_table, knockout_n = ladder_knockout(key, idx, exact, k)
    np.testing.assert_array_equal(sorted_table, knockout_table)
    np.testing.assert_array_equal(sorted_n, knockout_n)


@pytest.mark.parametrize("variant", ["onehot", "twolevel_exact"])
def test_equal_distances_in_one_lane_take_the_lowest_index_first(variant):
    """Observer 0 of the "lane-ties" state has twelve candidates at d2 =
    25, four of them in lane 5 (j = 5, 37, 69, 101): the exact order takes
    all twelve first, in ascending j, one a pass."""
    inputs = _state(1, 128, seed=0, state="lane-ties")
    key, idx, exact = lane_keys(inputs, variant)
    table, _ = ladder_sorted(key, idx, exact, 12)
    assert list(table[0]) == sorted(LANE_TIES)


@pytest.mark.parametrize("variant,first", [("packed", 1), ("twolevel", 1),
                                           ("onehot", 2),
                                           ("twolevel_exact", 2)])
def test_near_tie_follows_the_packed_bits(variant, first):
    """At N = 15 agent 1 lies a few ulps farther from observer 0 than agent
    2, inside the 7-bit packed tie window: the packed order takes agent 1
    (the lower index) first, the exact order agent 2 (the nearer)."""
    near_tie_coords()  # the state's construction must find its near-tie
    inputs = _state(1, 15, seed=3, state="near-tie")
    key, idx, exact = lane_keys(inputs, variant)
    table, _ = ladder_sorted(key, idx, exact, 2)
    assert table[0, 0] == first
