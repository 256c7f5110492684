"""The port's CUDA kernels on the card: each kernel against its plain PyTorch
version, and the flagship loops launching it once per step.

These tests need an NVIDIA GPU and skip elsewhere.  The file imports no JAX,
so on a machine with a card and no JAX it runs without the repo's
``conftest.py``::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
from warpdrive_tpu_torch.ops import knn_obs
from warpdrive_tpu_torch.presets import build_flagship


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


@pytest.mark.cuda
@pytest.mark.parametrize("E,N,k", [(1024, 105, 10), (8, 1024, 10), (6, 15, 4),
                                   (3, 40, 20), (2, 2000, 32)])
def test_knn_kernel_matches_plain_on_card(card, E, N, k):
    """Bit for bit, including the K_MAX=32 instantiation and an N whose
    staged inputs need more than 48 KB of shared memory."""
    args = _knn_args(N, k, E, seed=N, device=card)
    before = knn_obs.LAUNCH_COUNTS["knn_obs_flat_exact"]
    out = knn_obs.knn_observation(*args, n_agents=N, k=k)
    assert knn_obs.LAUNCH_COUNTS["knn_obs_flat_exact"] == before + 1
    plain = knn_obs.knn_observation_reference(*args, n_agents=N, k=k)
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
    assert knn_obs.LAUNCH_COUNTS == {"knn_obs_flat_exact": 6}
    assert torch.isfinite(checksum)
    assert state["loc_x"].device.type == "cuda"
