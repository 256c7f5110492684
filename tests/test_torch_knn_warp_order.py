"""A numpy model of the warp scan's lane-held k-list (``WarpList`` in
``warpdrive_tpu_torch/csrc/knn_common.cuh``), the selection of K1-K5 and
K9 on the card, held against the order of ``knn_observation_plain``.

The model does what a warp does for one observer, for every observer at
once: candidates come in rounds of 32, candidate ``base + l`` in lane l; a
round's ballot takes the lanes whose key beats the list's k-th key
(``worst``); those lanes enter one at a time, lowest lane first, each
checked again against the list as it stands; an entering key goes to
position ``pos`` = the number of held keys <= it, and the lanes from
``pos`` on shift up by one, as ``__shfl_up_sync`` shifts them.  The first
round, into the empty list, the kernel sorts across the lanes by (key,
index); a test here holds that sort to the insertions it stands for.  The
rows built from the model's lists must equal the plain version's bit for
bit, in the exact and the packed order, on random states, exact-distance
lattice ties, the N = 15 packed near-tie, partial and full last rounds (N
= 33, 64) and N = 1024, with k = 1, 10 and 32; and at K2's limits (N <=
128, k <= 16, a lattice at N = 128) in its exact order and its 7-bit
packed one.  The CUDA kernels are held
against the same plain version on the card (``chip_smoke.py``,
``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import torch

from warpdrive_tpu_torch.ops import knn_obs

LANES = 32
F32 = np.float32
INT_MAX = np.iinfo(np.int32).max


def _inputs(E, N, seed, state):
    """Random kNN inputs with about 20% dead agents; ``state`` "lattice"
    moves the agents onto an integer lattice (exact ties everywhere) and
    "near-tie" builds the N = 15 packed near-tie in env 0."""
    rng = np.random.RandomState(seed)
    loc_x = rng.uniform(0, 20, (E, N)).astype(F32)
    loc_y = rng.uniform(0, 20, (E, N)).astype(F32)
    feats = rng.uniform(-1, 1, (E, 5, N)).astype(F32)
    types_f = (rng.uniform(size=N) < 0.2).astype(F32)
    still_f = (rng.uniform(size=(E, N)) > 0.2).astype(F32)
    t_norm = rng.uniform(0, 1, E).astype(F32)
    if state == "lattice":
        side = int(np.ceil(np.sqrt(N)))
        cells = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                         -1).reshape(-1, 2)
        xy = np.stack([cells[rng.permutation(len(cells))[:N]]
                       for _ in range(E)])
        loc_x = xy[..., 0].astype(F32) * F32(1.5)
        loc_y = xy[..., 1].astype(F32) * F32(1.5)
    elif state == "near-tie":
        x0, xa, xb = near_tie_coords()
        loc_x[0, :3] = [x0, xa, xb]
        loc_y[0, :3] = 10.0
        loc_x[0, 3:] = np.linspace(1.0, 19.0, N - 3, dtype=F32)
        loc_y[0, 3:] = 2.0
        still_f[0] = 1.0
    return loc_x, loc_y, feats, types_f, still_f, t_norm


def near_tie_coords():
    """x of observer 0 and of agents 1 and 2 at y = 10: agent 1 lies a few
    ulps farther than agent 2, inside the 7-bit packed tie window and
    outside the 4-bit one that the v9 order packs at N = 15."""
    x0 = F32(10.0)
    for a in np.arange(1.30, 1.40, 0.001, dtype=F32):
        xa = xb = F32(x0 + a)
        for _ in range(3):
            xb = np.nextafter(xb, F32(0))
            ka, kb = np.array([(xa - x0) * (xa - x0), (xb - x0) * (xb - x0)],
                              F32).view(np.int32)
            if kb < ka and ka & ~127 == kb & ~127 and ka & ~15 != kb & ~15:
                return x0, xa, xb
    raise AssertionError("no near-tie found")


def _keys(inputs, variant):
    """Each (observer, candidate) pair's key, as the kernel forms it, and
    whether the candidate is valid: (E, N, N) arrays."""
    loc_x, loc_y, _, _, still_f, _ = inputs
    E, N = loc_x.shape
    if "mxudist" in variant:
        centred = knn_obs.centred_coords(torch.from_numpy(loc_x),
                                         torch.from_numpy(loc_y))
        d2 = knn_obs.expansion_sq_dist(*knn_obs.expansion_operands(
            centred[:, 0], centred[:, 1])).numpy()
    else:
        dx = loc_x[:, None, :] - loc_x[:, :, None]  # [e, i, j]
        dy = loc_y[:, None, :] - loc_y[:, :, None]
        d2 = dx * dx + dy * dy
    candidate = (still_f >= 0.5)[:, None, :] & ~np.eye(N, dtype=bool)
    bits = knn_obs.packed_bits(variant, N)
    if bits:
        key = (d2.view(np.int32) & ~((1 << bits) - 1)) | np.arange(
            N, dtype=np.int32)
        valid = candidate & (key < knn_obs._VALID_MAX_PACKED)
        return np.where(valid, key, INT_MAX).astype(np.int32), valid
    valid = candidate & (d2 < knn_obs._VALID_MAX)
    return np.where(valid, d2, np.inf).astype(F32), valid


def warp_list(key, valid, k, sort_first=True):
    """The lists of a warp scan over ``key``/``valid`` (O, N), one observer
    a row: (indices (O, 32), n_valid (O,), entries (O,)), lane s < k
    holding the s-th best; ``entries`` counts the keys that entered after
    the first round.  ``sort_first`` takes the first round as the kernel
    does, sorted by (key, index), else as insertions like every other."""
    O, N = key.shape
    sentinel = INT_MAX if key.dtype == np.int32 else np.inf
    lkey = np.full((O, LANES), sentinel, key.dtype)
    lidx = np.zeros((O, LANES), np.int64)
    worst = np.full(O, sentinel, key.dtype)
    n_valid = np.zeros(O, np.int64)
    entries = np.zeros(O, np.int64)
    lanes = np.arange(LANES)
    rows = np.arange(O)
    for base in range(0, N, LANES):
        j = base + lanes
        inside = j < N
        v = np.zeros((O, LANES), bool)
        v[:, inside] = valid[:, j[inside]]
        c = np.full((O, LANES), sentinel, key.dtype)
        c[:, inside] = np.where(v[:, inside], key[:, j[inside]], sentinel)
        n_valid += v.sum(axis=1)
        if base == 0 and sort_first:
            order = np.lexsort((np.broadcast_to(lanes, c.shape), c), axis=1)
            lkey = np.take_along_axis(c, order, axis=1)
            lidx = order.astype(np.int64)
            worst = lkey[:, k - 1].copy()
            continue
        ballot = c < worst[:, None]
        for src in range(LANES):  # the passing lanes, lowest first
            ck = c[:, src]
            enter = ballot[:, src] & (ck < worst)  # checked again
            if not enter.any():
                continue
            pos = (lkey <= ck[:, None]).sum(axis=1)
            up_key = np.concatenate([lkey[:, :1], lkey[:, :-1]], axis=1)
            up_idx = np.concatenate([lidx[:, :1], lidx[:, :-1]], axis=1)
            at, above = lanes == pos[:, None], lanes > pos[:, None]
            new_key = np.where(above, up_key, np.where(at, ck[:, None], lkey))
            new_idx = np.where(above, up_idx, np.where(at, base + src, lidx))
            lkey = np.where(enter[:, None], new_key, lkey)
            lidx = np.where(enter[:, None], new_idx, lidx)
            worst = np.where(enter, lkey[rows, k - 1], worst)
            entries += enter
    return lidx, n_valid, entries


def _rows_of(inputs, lidx, n_valid, k):
    """(E, N, 8k+1) observation rows from the model's lists."""
    _, _, feats, types_f, still_f, t_norm = inputs
    E, N = still_f.shape
    idx = lidx.reshape(E, N, LANES)[..., :k]
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
        *(torch.from_numpy(a) for a in inputs), n_agents=N, k=k,
        variant=variant).numpy()


CASES = [
    ("random", 2, 33, 1), ("random", 2, 33, 10), ("random", 2, 33, 32),
    ("random", 2, 64, 1), ("random", 2, 64, 10), ("random", 2, 64, 32),
    ("random", 2, 1024, 1), ("random", 2, 1024, 10), ("random", 1, 1024, 32),
    ("lattice", 3, 33, 32), ("lattice", 3, 64, 10), ("lattice", 2, 1024, 1),
    ("lattice", 2, 1024, 10), ("lattice", 1, 1024, 32),
    ("near-tie", 2, 15, 1), ("near-tie", 2, 15, 2), ("near-tie", 2, 15, 10),
]


@pytest.mark.parametrize("variant", ["flat_exact", "flat"])
@pytest.mark.parametrize("state,E,N,k", CASES,
                         ids=[f"{s}-E{E}-N{N}-k{k}" for s, E, N, k in CASES])
def test_warp_list_rows_equal_the_plain_order(state, E, N, k, variant):
    inputs = _inputs(E, N, seed=N + k, state=state)
    key, valid = _keys(inputs, variant)
    lidx, n_valid, _ = warp_list(key.reshape(E * N, N),
                                 valid.reshape(E * N, N), k)
    np.testing.assert_array_equal(_rows_of(inputs, lidx, n_valid, k),
                                  _plain(inputs, k, variant))


K2_CASES = [c for c in CASES if c[2] <= 128 and c[3] <= 16] + [
    ("lattice", 8, 128, 10)]


@pytest.mark.parametrize("variant", ["mxu_exact", "mxu"])
@pytest.mark.parametrize("state,E,N,k", K2_CASES,
                         ids=[f"{s}-E{E}-N{N}-k{k}" for s, E, N, k in K2_CASES])
def test_warp_list_rows_equal_the_plain_order_at_k2_limits(state, E, N, k,
                                                           variant):
    """K2 on the warp scan: the exact order and v3's 7-bit packed key."""
    inputs = _inputs(E, N, seed=N + k + 1, state=state)
    key, valid = _keys(inputs, variant)
    lidx, n_valid, _ = warp_list(key.reshape(E * N, N),
                                 valid.reshape(E * N, N), k)
    np.testing.assert_array_equal(_rows_of(inputs, lidx, n_valid, k),
                                  _plain(inputs, k, variant))


@pytest.mark.parametrize("variant", ["flat_mxudist_exact", "flat_mxudist"])
def test_warp_list_follows_the_mxu_distance_order(variant):
    inputs = _inputs(2, 64, seed=7, state="lattice")
    key, valid = _keys(inputs, variant)
    lidx, n_valid, _ = warp_list(key.reshape(128, 64), valid.reshape(128, 64),
                                 10)
    np.testing.assert_array_equal(_rows_of(inputs, lidx, n_valid, 10),
                                  _plain(inputs, 10, variant))


@pytest.mark.parametrize("state,N", [("random", 33), ("lattice", 64),
                                     ("lattice", 1024)])
@pytest.mark.parametrize("variant", ["flat_exact", "flat"])
def test_sorted_first_round_equals_its_insertions(state, N, variant):
    """Sorting the first round by (key, index) leaves the valid entries of
    the first k lanes and the count that inserting its lanes one at a time
    leaves."""
    inputs = _inputs(2, N, seed=N, state=state)
    key, valid = _keys(inputs, variant)
    key, valid = key.reshape(2 * N, N), valid.reshape(2 * N, N)
    for k in (1, 10, min(32, N)):
        sorted_first = warp_list(key, valid, k)
        inserted = warp_list(key, valid, k, sort_first=False)
        np.testing.assert_array_equal(sorted_first[1], inserted[1])
        held = np.arange(k) < sorted_first[1][:, None]
        np.testing.assert_array_equal(
            np.where(held, sorted_first[0][:, :k], -1),
            np.where(held, inserted[0][:, :k], -1))


def test_near_tie_takes_the_nearer_agent_at_4_bits():
    """At N = 15 the v9 order packs 4 index bits: observer 0 takes the
    nearer agent 2 before agent 1, in both orders."""
    inputs = _inputs(1, 15, seed=3, state="near-tie")
    for variant in ("flat_exact", "flat"):
        key, valid = _keys(inputs, variant)
        lidx, _, _ = warp_list(key[0], valid[0], 2)
        assert list(lidx[0, :2]) == [2, 1], variant


def test_equal_keys_keep_the_lowest_index_first():
    """Four candidates at one distance, two of them in one round: the
    list keeps them in ascending index."""
    N = 70
    key = np.full((1, N), 50.0, F32)
    key[0, [5, 40, 9, 66]] = 1.0
    valid = np.ones((1, N), bool)
    lidx, n_valid, _ = warp_list(key, valid, 6)
    assert list(lidx[0, :6]) == [5, 9, 40, 66, 0, 1]
    assert n_valid[0] == N


def test_few_candidates_enter_at_1024_agents():
    """At N = 1024 in random order about k (1 + ln(N / k)) candidates
    enter a k = 10 list, some 56, against 1023 that the scan offers."""
    rng = np.random.RandomState(0)
    key = rng.uniform(0, 1, (256, 1024)).astype(F32)
    _, _, entries = warp_list(key, np.ones_like(key, bool), 10,
                              sort_first=False)
    expected = 10 + 10 * sum(1.0 / m for m in range(11, 1025))
    assert abs(entries.mean() - expected) < 3, (entries.mean(), expected)
