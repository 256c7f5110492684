"""Shared settings of the benchmark's CPU tests: each cell at a size a test
run holds (the harness runs the plain versions on the CPU)."""

import pytest

SMALL = {
    "tag_continuous.train": {
        "config": {"run_config.trainer.num_envs": 4,
                   "run_config.trainer.train_batch_size": 64},
        "traffic": {"units": 2, "settle_chunk_units": 1},
    },
    "flagship.sim": {
        "config": {"num_envs": 6},
        "traffic": {"units": 30, "warmup_units": 2,
                    "settle_chunk_units": 1},
    },
}

SEED = 2**31 + 1234567  # past 32 signed bits, as the driver's are


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, not at
    import, so that every worker collects the same tests)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")
