"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Entry points default to ``"cuda"``.  Without a usable GPU that request
    raises: the port never carries on on the CPU unless the caller asks for
    it with ``device="cpu"`` (as the tests do).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev
