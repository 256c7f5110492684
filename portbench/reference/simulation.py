"""
The numbers that judge recorded env steps of the simulation loop.

The loop draws its random actions inside its captured step and keeps only
the state, so the reference follows it step by step from the program's own
state: for each sampled step it takes the recorded state before the step
and the one after it, tells which legal action pair each agent took (the
one whose heading, speed and acceleration lie nearest the recorded ones),
steps the env itself with those actions and compares everything else the
step wrote.  An env the program reset in the step is held to the starting
layout; one it reset before the episode's end must have had every runner
still in the game tagged in that step (each reads the tag penalty).  The
start, which this skips, is checked by itself: the program's state before
its first step against the layout the reference draws from the seed.  The
observation, which the loop keeps only as a float32 sum (its checksum,
zeroed before each sampled step), is judged by that sum against the
reference's observation of the recorded state before the step, and entry
by entry by a second observation of that state by the program.
"""

from __future__ import annotations

from portbench.reference.tagenv import (
    DONE,
    FLOAT_FIELDS,
    REWARDS,
    STILL,
    TIMESTEP,
    TagEnv,
)


def start_mismatches(program_start: dict, env: TagEnv) -> int:
    """Entries of the program's first state that differ from the layout."""
    count = 0
    for name, want in env.start.items():
        if name in program_start:
            count += int((program_start[name].to(want.dtype) != want).sum())
    return count


def judge(samples: list, obs: list, sums: list, env: TagEnv) -> dict:
    """``samples``: ``(pre, post)`` state pairs of recorded steps;
    ``obs``: the observation of each ``pre`` by the side judged; ``sums``:
    the sum of the observation each step made, by the side judged.
    Returns the largest gap of a floating-point field over the envs that
    were not reset, the count of mismatched flags, counters and rewards
    (and of resets the reference does not bear out), the largest
    observation gap, and the largest gap of an observation's sum over the
    sum of its magnitudes."""
    transition_gap, obs_gap, obs_sum_gap, mismatches = 0.0, 0.0, 0.0, 0
    L = env.episode_length
    for (pre, post), seen, total in zip(samples, obs, sums):
        prog_reset = post[TIMESTEP] == 0
        actions = env.infer_actions(pre, post)
        ref = env.step(pre, actions)
        ran = ~prog_reset  # a step due to reset shows as ref[DONE] != 0
        for name in FLOAT_FIELDS:
            gap = (post[name][ran].float() - ref[name][ran].float()).abs()
            if gap.numel():
                transition_gap = max(transition_gap, float(gap.max()))
        for name in (STILL, TIMESTEP, DONE, REWARDS):
            mismatches += int((post[name][ran].to(ref[name].dtype)
                               != ref[name][ran]).sum())
        for name in FLOAT_FIELDS + (STILL,):
            want = env.start[name][prog_reset]
            mismatches += int((post[name][prog_reset].to(want.dtype)
                               != want).sum())
        mismatches += int((post[DONE][prog_reset] != 0).sum())
        early = prog_reset & (pre[TIMESTEP] + 1 < L)
        runners_in = (pre[STILL] > 0) & env.c["is_runner"][None]
        untagged = runners_in & (post[REWARDS] > env.tag_penalty + 0.5)
        mismatches += int(untagged[early].sum())
        want = env.observe(pre)
        obs_gap = max(obs_gap, float((seen.float() - want).abs().max()))
        obs_sum_gap = max(obs_sum_gap, abs(total - float(want.double().sum()))
                          / max(float(want.double().abs().sum()), 1e-30))
    return {"transition_gap": transition_gap, "obs_gap": obs_gap,
            "obs_sum_gap": obs_sum_gap, "mismatches": float(mismatches)}


def control(samples: list, env: TagEnv, low: TagEnv) -> tuple:
    """The control's recorded steps: the reference in ``low``'s precision
    put in the program's place, from each recorded state with the actions
    the program took; returns ``(samples, obs, sums)`` to judge as the
    program's."""
    out, obs, sums = [], [], []
    for pre, post in samples:
        actions = env.infer_actions(pre, post)
        stepped = low.reset_done(low.step(low.cast(pre), actions))
        out.append((pre, {k: (v.float() if v.is_floating_point() else v)
                          for k, v in stepped.items()}))
        obs.append(low.observe(low.cast(pre)))
        sums.append(float(obs[-1].double().sum()))
    return out, obs, sums
