"""The port's v9 variants ``flat`` (kernel K3), ``flat_mxudist`` and
``flat_mxudist_exact`` (K4), through their plain versions on the CPU, against
the JAX package's ``knn_observation`` in interpret mode; the packed bit
count of ``flat`` against the v3 kernel's on a constructed near-tie; and the
MXU distance operands against the JAX formula.  Inputs are drawn with numpy
and handed to both sides.

Tolerances: the JAX kernels select features through bf16 hi/lo pairs
(``tests/test_knn_obs_kernel.py``'s 8e-6), the port gathers exact float32.
The ``flat`` selection must be equal.  The ``mxudist`` variants centre the
coordinates on a mean that torch and XLA sum in different orders, and XLA's
product sums its 12 terms in its own order, so near-tied candidates may
swap: the share of entries off by more than 8e-6 must stay below 2e-3, the
class ``tests/test_knn_obs_kernel.py`` holds the JAX kernel to."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from warpdrive_tpu.envs.tag_continuous import TpuTagContinuous
from warpdrive_tpu.ops.knn_obs import _bf16_pair
from warpdrive_tpu.ops.knn_obs import knn_observation as jax_knn_observation
from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
from warpdrive_tpu_torch.ops import knn_obs
from warpdrive_tpu_torch.utils.constants import Constants

FEATURE_ATOL = 8e-6
SWAP_SHARE = 2e-3


def _knn_inputs(E, N, seed, box=20.0):
    """Random kNN inputs with about 20% dead agents, as numpy float32."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    loc_x = rng.uniform(0, box, (E, N)).astype(f32)
    loc_y = rng.uniform(0, box, (E, N)).astype(f32)
    feats = np.concatenate(
        [(np.stack([loc_x, loc_y], 1) / f32(box * np.sqrt(2))).astype(f32),
         rng.uniform(-1, 1, (E, 3, N)).astype(f32)], axis=1)
    types_f = (rng.uniform(size=N) < 0.2).astype(f32)
    still_f = (rng.uniform(size=(E, N)) > 0.2).astype(f32)
    t_norm = rng.uniform(0, 1, E).astype(f32)
    return loc_x, loc_y, feats, types_f, still_f, t_norm


def _port(inputs, k, variant):
    N = inputs[0].shape[1]
    before = dict(knn_obs.LAUNCH_COUNTS)
    out = knn_obs.knn_observation(*(torch.from_numpy(a) for a in inputs),
                                  n_agents=N, k=k, variant=variant).numpy()
    assert knn_obs.LAUNCH_COUNTS == before  # CPU tensors take the plain path
    assert out.shape == (inputs[0].shape[0], N, 8 * k + 1)
    return out


def _jax(inputs, k, variant):
    return np.asarray(jax_knn_observation(
        *(jnp.asarray(a) for a in inputs), n_agents=inputs[0].shape[1], k=k,
        interpret=True, variant=variant))


def assert_same_selection(out, ref, k):
    E, N = out.shape[:2]
    slots = out[..., :-1].reshape(E, N, k, 8)
    ref_slots = ref[..., :-1].reshape(E, N, k, 8)
    np.testing.assert_array_equal(slots[..., 5:], ref_slots[..., 5:])
    np.testing.assert_array_equal(out[..., -1], ref[..., -1])
    np.testing.assert_allclose(out, ref, rtol=0, atol=FEATURE_ATOL)


def assert_swap_class(out, ref):
    bad = 1.0 - np.isclose(out, ref, atol=FEATURE_ATOL).mean()
    assert bad < SWAP_SHARE, f"too many selection swaps: {bad:.4%}"


@pytest.mark.parametrize("N,k,E", [(15, 4, 6), (105, 10, 4), (200, 6, 3)])
@pytest.mark.parametrize("variant",
                         ["flat", "flat_mxudist", "flat_mxudist_exact"])
def test_flat_variants_match_jax_v9_kernel(variant, N, k, E):
    inputs = _knn_inputs(E, N, seed=N + k)
    out = _port(inputs, k, variant)
    ref = _jax(inputs, k, variant)
    if variant == "flat":
        # the same keys from the same difference-form distances
        assert_same_selection(out, ref, k)
    else:
        assert_swap_class(out, ref)


def test_packed_bits_follow_the_tile_size():
    assert knn_obs.packed_bits("flat", 15) == 4
    assert knn_obs.packed_bits("tiled", 105) == 7
    assert knn_obs.packed_bits("flat_mxudist", 1024) == 10
    assert knn_obs.packed_bits("mxu", 15) == 7  # v3's fixed _CLEAR_MASK
    for variant in ("flat_exact", "flat_mxudist_exact", "tiled_exact",
                    "mxu_exact"):
        assert knn_obs.packed_bits(variant, 300) == 0


def _near_tie_4_vs_7_bits():
    """Offsets xb < xa from an observer at x0 whose float32 squared
    distances differ (b's smaller) and agree once the low 7 mantissa bits
    are cleared, but not once only the low 4 are: a 7-bit packed order puts
    the lower index first, a 4-bit one the nearer candidate."""
    f32 = np.float32
    x0 = f32(10.0)
    for a in np.arange(1.30, 1.40, 0.001, dtype=np.float32):
        xa = f32(x0 + a)
        xb = xa
        for _ in range(3):
            xb = np.nextafter(xb, f32(0))
            da = (xa - x0) * (xa - x0)
            db = (xb - x0) * (xb - x0)
            ka, kb = np.array([da, db], np.float32).view(np.int32)
            if (db < da and ka & ~127 == kb & ~127
                    and ka & ~15 != kb & ~15):
                return xa, xb
    raise AssertionError("no near-tie found")


def _env_kwargs(num_agents, k):
    n_taggers = max(2, num_agents // 5)
    return dict(num_taggers=n_taggers, num_runners=num_agents - n_taggers,
                grid_length=20.0, episode_length=100,
                use_full_observation=False, num_other_agents_observed=k,
                seed=3)


def near_tie_state():
    """One env of 15 agents where agent 1 (at ``xa``) lies a few ulps
    farther from observer 0 than agent 2 (at ``xb``), inside the 7-bit
    packed tie window and outside the 4-bit one; returns the state, ``xa``
    and ``xb``."""
    xa, xb = _near_tie_4_vs_7_bits()
    N = 15
    rng = np.random.RandomState(4)
    # the other agents keep more than 5 units from the three
    far = np.stack([rng.uniform(0, 20, 40), rng.uniform(0, 20, 40)], 1)
    far = far[np.hypot(far[:, 0] - 10, far[:, 1] - 10) > 5][:N - 3]
    state = {
        "loc_x": np.concatenate([[10.0, xa, xb], far[:, 0]])[None],
        "loc_y": np.concatenate([[10.0, 10.0, 10.0], far[:, 1]])[None],
        "speed": rng.uniform(0, 1, (1, N)),
        "acceleration": rng.uniform(-0.1, 0.1, (1, N)),
        "direction": rng.uniform(0, 2 * np.pi, (1, N)),
    }
    state = {name: v.astype(np.float32) for name, v in state.items()}
    state["still_in_the_game"] = np.ones((1, N), np.int32)
    state[Constants.TIMESTEP] = np.array([7], np.int32)
    return state, xa, xb


def near_tie_rel_x(x):
    """Slot 0's relative x of an agent at ``x`` seen from observer 0 of
    :func:`near_tie_state`, as the observation computes it."""
    diag = np.float32(20.0 * np.sqrt(2))
    return np.float32(x / diag) - np.float32(np.float32(10.0) / diag)


def test_flat_packs_fewer_bits_than_mxu_on_a_near_tie():
    """At N = 15 the v9 kernel packs 4 index bits and v3 packs 7.  Agent 1
    lies a few ulps farther from observer 0 than agent 2, inside v3's tie
    window and outside v9's: ``pallas_flat`` picks 2 first, ``pallas_mxu``
    1, and the port follows the JAX kernel in both."""
    state, xa, xb = near_tie_state()
    N, k = 15, 2
    nearest = {}
    for algo in ("pallas_flat", "pallas_mxu"):
        penv = TorchTagContinuous(**_env_kwargs(N, k), knn_algorithm=algo)
        jenv = TpuTagContinuous(**_env_kwargs(N, k), knn_algorithm=algo)
        out = penv.observe_batch_fn(
            {name: torch.from_numpy(v.copy()) for name, v in state.items()}
        ).numpy()
        ref = np.asarray(jenv.observe_batch_fn(
            {name: jnp.asarray(v) for name, v in state.items()}))
        assert_same_selection(out, ref, k)
        nearest[algo] = out[0, 0, 0]  # observer 0, slot 0: relative x
    assert nearest["pallas_flat"] == near_tie_rel_x(xb)
    assert nearest["pallas_mxu"] == near_tie_rel_x(xa)


@pytest.mark.parametrize("N,box", [(105, 20.0), (1024, 60.0)])
def test_mxudist_operands_match_the_jax_formula(N, box):
    """Given the same centred coordinates, the port's operands equal the
    JAX build (``knn_obs.py:1181-1205``) bit for bit; the centring itself
    differs by at most an ulp of the coordinates; and the expansion's d2 is
    the difference form's to within its cancellation error."""
    loc_x, loc_y = _knn_inputs(3, N, seed=N, box=box)[:2]
    jx, jy = jnp.asarray(loc_x), jnp.asarray(loc_y)
    xc = jx - jnp.mean(jx, axis=1, keepdims=True)
    yc = jy - jnp.mean(jy, axis=1, keepdims=True)
    xh, xl = _bf16_pair(xc)
    yh, yl = _bf16_pair(yc)
    nh, nl = _bf16_pair(xc * xc + yc * yc)
    ones = jnp.ones_like(nh)
    two = jnp.bfloat16(-2.0)
    amat = jnp.stack([xh, xh, xl, xl, yh, yh, yl, yl, nh, nl, ones, ones], 2)
    bmat = jnp.stack([two * xh, two * xl, two * xh, two * xl, two * yh,
                      two * yl, two * yh, two * yl, ones, ones, nh, nl], 1)

    pa, pb = knn_obs.expansion_operands(torch.from_numpy(np.array(xc)),
                                        torch.from_numpy(np.array(yc)))
    assert pa.dtype == pb.dtype == torch.bfloat16
    assert pa.shape == (3, N, 12) and pb.shape == (3, 12, N)
    np.testing.assert_array_equal(pa.float().numpy(),
                                  np.asarray(amat.astype(jnp.float32)))
    np.testing.assert_array_equal(pb.float().numpy(),
                                  np.asarray(bmat.astype(jnp.float32)))

    tx, ty = torch.from_numpy(loc_x), torch.from_numpy(loc_y)
    centred = knn_obs.centred_coords(tx, ty)
    assert centred.shape == (3, 2, N) and centred.is_contiguous()
    for port_c, jax_c in ((centred[:, 0], xc), (centred[:, 1], yc)):
        np.testing.assert_allclose(port_c.numpy(), np.asarray(jax_c), rtol=0,
                                   atol=2 * np.spacing(np.float32(box)))
    amat_only, none = knn_obs.expansion_operands(centred[:, 0], centred[:, 1],
                                                 with_bmat=False)
    assert none is None

    d2 = knn_obs.expansion_sq_dist(
        *knn_obs.expansion_operands(centred[:, 0], centred[:, 1]))
    assert torch.equal(amat_only,
                       knn_obs.expansion_operands(centred[:, 0],
                                                  centred[:, 1])[0])
    diff = ((tx[:, None, :] - tx[:, :, None]) ** 2
            + (ty[:, None, :] - ty[:, :, None]) ** 2)
    assert (d2 >= 0).all()
    err = float((d2 - diff).abs().max())
    assert err < 1e-5 * box * box, err
