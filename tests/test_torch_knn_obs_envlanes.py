"""The port's envs-on-lanes variants (kernel K9: ``envlanes``,
``envlanes_exact``), through their plain versions on the CPU, against the
JAX package's v8 kernel (``_knn_obs_kernel_v8``), which ``knn_observation``
runs in interpret mode on a CPU backend; the shapes of
``tests/test_knn_obs_kernel.py:test_envlanes_kernel_multi_tile`` (200
agents, and 130 envs, past one 128-env lane tile), the flagship width and a
lattice of exact ties.  Inputs are drawn with numpy and handed to both
sides.

v8 selects features as exact float32 one-hot sums, so the port's gather
equals it bit for bit (max diff 0), and selection, type, valid flags and
time are identical."""

import numpy as np
import pytest
import torch

from test_torch_knn_obs_flat import (
    _jax,
    _knn_inputs,
    _port,
    assert_same_selection,
)
from test_torch_knn_obs_ladder import lattice_xy
from warpdrive_tpu_torch.ops import knn_obs


@pytest.mark.parametrize("N,k,E,ties", [
    (200, 6, 3, False), (15, 4, 130, False), (105, 10, 4, False),
    (105, 10, 4, True),
], ids=["200-agents", "130-envs", "flagship-width", "lattice"])
@pytest.mark.parametrize("variant", ["envlanes", "envlanes_exact"])
def test_envlanes_variants_match_jax_v8_kernel(variant, N, k, E, ties):
    inputs = _knn_inputs(E, N, seed=N + k)
    if ties:
        inputs[0][:], inputs[1][:] = lattice_xy(E, N, seed=k)
    out = _port(inputs, k, variant)
    ref = _jax(inputs, k, variant)
    assert_same_selection(out, ref, k)
    np.testing.assert_array_equal(out, ref)


def test_envlanes_takes_any_agent_count_and_k_up_to_32_on_the_card():
    """v8 has no agent or k cap; the CUDA kernel keeps a sorted list of at
    most 32 entries and stages candidates in chunks, so shared memory sets
    no agent limit."""
    for variant in ("envlanes", "envlanes_exact"):
        knn_obs.check_kernel_limits(variant, 20000, 32)
        with pytest.raises(ValueError, match="k <= 32"):
            knn_obs.check_kernel_limits(variant, 200, 33)
    inputs = [torch.from_numpy(a) for a in _knn_inputs(2, 150, seed=2)]
    out = knn_obs.knn_observation(*inputs, n_agents=150, k=40,
                                  variant="envlanes_exact")
    assert out.shape == (2, 150, 321)
