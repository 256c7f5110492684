"""
The port's counterpart of ``__graft_entry__.py:entry()``: one full loop
step of the flagship system (TagContinuous, 5 taggers + 100 runners, two
MLP policies) -- the kNN observation, the policy forward, categorical
sampling, the env step and the done-driven auto-reset -- with its example
arguments.
"""

from __future__ import annotations

import torch


def entry(device="cuda"):
    """Return ``(fn, example_args)``: ``fn(models, state, generator)`` is
    ``full_loop_step`` of ``build_flagship(num_envs=4, fc_dims=(64, 64),
    seed=0)`` on ``device``, and the arguments are its models, its rollout
    state and a ``torch.Generator`` seeded 0 (in place of JAX's PRNG
    key)."""
    from warpdrive_tpu_torch.presets import build_flagship

    system = build_flagship(num_envs=4, fc_dims=(64, 64), seed=0,
                            device=device)
    generator = torch.Generator(device=system["engine"].device)
    generator.manual_seed(0)
    return system["full_loop_step"], (system["models"], system["state"],
                                      generator)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry(): OK")
