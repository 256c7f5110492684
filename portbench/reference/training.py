"""
The reference's follow of a training run's first steps, and the numbers
that judge the program's steps against it.

The benchmark hands both sides the same inputs: the env's seed (its
layout), the parameters it made from the seed, and the configuration.  The
program's sampled actions are its outputs: the reference steps the env
with them, as it reads a served model's tokens, and judges every other
output of the program against its own.

What the program gave (``prog``):

* ``start``: its env state before the first step;
* ``actions[s][tag]`` ``(T, E, A, 2)``, ``rewards[s][tag]`` ``(T, E, A)``,
  ``done[s]`` ``(T, E)``: its batch after step ``s``;
* ``obs_rows[s]``: ``{t: {tag: (E, A, F)}}``, a sample of its batch's
  observations, and ``obs_sums[s][tag]`` ``(T, E, A)``: every row of its
  batch's observations summed with the weights :func:`row_weights`;
* ``loss[s][tag]``: its total loss, where the step reported it;
* ``mu1[tag]``: its Adam first moment after step 1 (the first gradient, as
  the optimizer got it, times 1 - b1);
* ``theta0[tag]``, ``theta[tag]``: the parameters it started from (the
  benchmark's) and those after the last step.
"""

from __future__ import annotations

import statistics

import torch

from portbench.reference import a2c
from portbench.reference.tagenv import DONE, REWARDS, TagEnv


def row_weights(features: int, device) -> torch.Tensor:
    """The weights of an observation row's checksum, distinct for every
    feature, so that a value moved to another slot changes the sum."""
    return 1.0 + torch.arange(features, dtype=torch.float64,
                              device=device) / features


def row_sums(obs: torch.Tensor) -> torch.Tensor:
    """``(..., F)`` observations -> their weighted row sums in float64."""
    return (obs.double() * row_weights(obs.shape[-1], obs.device)).sum(-1)


def follow(prog: dict, env_cfg: dict, env_seed: int, policies: dict,
           fc_dims, matmul: str = "float32", half_batch: bool = False,
           alter: tuple = None) -> dict:
    """The reference's own outputs for the program's steps: per step its
    rewards, done flags, sampled observation rows and row sums, each
    policy's loss and the loss's scale (the sum of its terms' magnitudes);
    its first clipped gradient; its parameters after the last step.
    ``policies``: ``{tag: {"agent_type", "lr", "gamma", "vf_loss_coeff",
    "entropy_coeff", "max_grad_norm"}}``.

    The faults a control reads: ``half_batch`` takes each loss over the
    first half of the envs alone; ``alter`` ``(step, t, env, agent,
    feature, delta)`` moves one observation, and adds 1 to that agent's
    reward, where they are produced."""
    steps = len(prog["actions"])
    first = prog["actions"][0]
    some = next(iter(first.values()))
    T, E = some.shape[:2]
    device = some.device
    env = TagEnv(env_cfg, env_seed, E, device)
    ids = {tag: env.ids_of(p["agent_type"]) for tag, p in policies.items()}
    heads = len(env.action_levels)
    params = {tag: {n: t.detach().clone() for n, t in prog["theta0"][tag]
                    .items()} for tag in policies}
    opts = {tag: a2c.ClippedAdam(params[tag], p["max_grad_norm"])
            for tag, p in policies.items()}
    out = {"rewards": [], "done": [], "obs_rows": [], "obs_sums": [],
           "loss": [], "scale": [], "grad1": {}}
    state = {k: v.clone() for k, v in env.start.items()}
    N = env.num_agents
    for s in range(steps):
        acts = torch.zeros((T, E, N, 2), dtype=torch.int32, device=device)
        for tag in policies:
            acts[:, :, ids[tag]] = prog["actions"][s][tag].to(torch.int32)
        obs_b = {tag: torch.empty((T, E, len(ids[tag]), 8 * env.k + 1),
                                  device=device) for tag in policies}
        rew_b = {tag: torch.empty((T, E, len(ids[tag])), device=device)
                 for tag in policies}
        done_b = torch.empty((T, E), dtype=torch.int32, device=device)
        rows = {}
        with torch.no_grad():
            for t in range(T):
                obs = env.observe(state)
                if alter is not None and (s, t) == alter[:2]:
                    obs[alter[2], alter[3], alter[4]] += alter[5]
                for tag in policies:
                    obs_b[tag][t] = obs[:, ids[tag]]
                if t in prog["obs_rows"][s]:
                    rows[t] = {tag: obs[:, ids[tag]] for tag in policies}
                state = env.step(state, acts[t])
                if alter is not None and (s, t) == alter[:2]:
                    state[REWARDS][alter[2], alter[3]] += 1.0
                for tag in policies:
                    rew_b[tag][t] = state[REWARDS][:, ids[tag]]
                done_b[t] = state[DONE]
                state = env.reset_done(state)
        losses, scales = {}, {}
        keep = slice(0, E // 2 if half_batch else E)
        for tag, p in policies.items():
            leaves = {n: t.clone().requires_grad_(True)
                      for n, t in params[tag].items()}
            logits, values = a2c.forward(leaves, obs_b[tag][:, keep],
                                         len(fc_dims), heads, matmul)
            loss, terms = a2c.a2c_loss(
                logits, values, prog["actions"][s][tag][:, keep],
                rew_b[tag][:, keep], done_b[:, keep],
                p["gamma"], p["vf_loss_coeff"], p["entropy_coeff"])
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            if s == 0:
                out["grad1"][tag] = opts[tag].clip(grads)
            params[tag] = opts[tag].step(params[tag], grads, p["lr"])
            pl, vf, ent = (float(x.detach()) for x in terms)
            losses[tag] = float(loss.detach())
            scales[tag] = (abs(pl) + abs(p["vf_loss_coeff"] * vf)
                           + abs(p["entropy_coeff"] * ent))
            del logits, values, loss, grads, leaves
        out["rewards"].append(rew_b)
        out["done"].append(done_b)
        out["obs_rows"].append(rows)
        out["obs_sums"].append({tag: row_sums(o) for tag, o in obs_b.items()})
        out["loss"].append(losses)
        out["scale"].append(scales)
        del obs_b
    out["theta"] = params
    out["start"] = env.start
    out["levels"] = env.action_levels
    return out


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def worst_leaf(prog_norms: dict, ref_norms: dict) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    median = statistics.median(ref_norms.values())
    return max(abs(prog_norms[n] - ref_norms[n]) / max(ref_norms[n], median)
               for n in ref_norms) if ref_norms else 0.0


def judge(prog: dict, ref: dict, policies: dict) -> dict:
    """The numbers compared, each a gap between the program and the
    reference (0 where they agree)."""
    loss_gap = 0.0
    for s, losses in enumerate(prog["loss"]):
        for tag, value in losses.items():
            loss_gap = max(loss_gap, abs(value - ref["loss"][s][tag])
                           / max(ref["scale"][s][tag], 1e-12))
    grad_gap = change_gap = 0.0
    for tag in policies:
        g_ref = {n: _norm(g) for n, g in ref["grad1"][tag].items()}
        g_prog = {n: _norm(m) / (1.0 - a2c.B1)
                  for n, m in prog["mu1"][tag].items()}
        grad_gap = max(grad_gap, worst_leaf(g_prog, g_ref))
        # leaves the reference's gradient leaves still (under a thousandth
        # of the median leaf's) move under Adam by round-off alone
        floor = 1e-3 * statistics.median(g_ref.values())
        kept = [n for n, g in g_ref.items() if g >= floor]
        theta0 = prog["theta0"][tag]
        d_ref = {n: _norm(ref["theta"][tag][n] - theta0[n]) for n in kept}
        d_prog = {n: _norm(prog["theta"][tag][n] - theta0[n]) for n in kept}
        change_gap = max(change_gap, worst_leaf(d_prog, d_ref))
    obs_gap = obs_sum_gap = 0.0
    for s, rows in enumerate(prog["obs_rows"]):
        for t, by_tag in rows.items():
            for tag, o in by_tag.items():
                obs_gap = max(obs_gap, float(
                    (o.float() - ref["obs_rows"][s][t][tag]).abs().max()))
        for tag, sums in prog["obs_sums"][s].items():
            obs_sum_gap = max(obs_sum_gap, float(
                (sums - ref["obs_sums"][s][tag]).abs().max()))
    mismatches = 0
    for name, ref_start in ref["start"].items():
        if name in prog["start"]:
            mismatches += int((prog["start"][name].to(ref_start.dtype)
                               != ref_start).sum())
    for s in range(len(prog["actions"])):
        mismatches += int((prog["done"][s].to(torch.int32)
                           != ref["done"][s]).sum())
        for tag in policies:
            mismatches += int((prog["rewards"][s][tag]
                               != ref["rewards"][s][tag]).sum())
    for s in range(len(prog["actions"])):
        for tag, a in prog["actions"][s].items():
            levels = torch.as_tensor(ref["levels"], device=a.device)
            mismatches += int(((a < 0) | (a >= levels)).sum())
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "obs_gap": obs_gap,
            "obs_sum_gap": obs_sum_gap, "mismatches": float(mismatches)}


CONTROLS = ("tf32", "half_batch", "altered")


def control(kind: str, prog: dict, env_cfg: dict, env_seed: int,
            policies: dict, fc_dims, ref: dict) -> dict:
    """A control's numbers: the reference put in the program's place on the
    same inputs and actions, judged as the program is; ``kind`` "tf32"
    (every product on TF32 operands), "half_batch" (each loss over half
    the envs) or "altered" (one observation moved where it is produced)."""
    opts = {"tf32": {"matmul": "tf32"}, "half_batch": {"half_batch": True},
            "altered": {"alter": _alteration(prog)}}[kind]
    ctl = follow(prog, env_cfg, env_seed, policies, fc_dims, **opts)
    as_prog = dict(prog)
    as_prog["loss"] = [{tag: ctl["loss"][s][tag] for tag in prog["loss"][s]}
                       for s in range(len(prog["loss"]))]
    as_prog["mu1"] = {tag: {n: (1.0 - a2c.B1) * g for n, g in
                            ctl["grad1"][tag].items()} for tag in policies}
    for key in ("theta", "rewards", "done", "start", "obs_sums"):
        as_prog[key] = ctl[key]
    as_prog["obs_rows"] = [
        {t: ctl["obs_rows"][s][t] for t in prog["obs_rows"][s]}
        for s in range(len(prog["obs_rows"]))]
    return judge(as_prog, ref, policies)


def _alteration(prog: dict) -> tuple:
    """Where the "altered" control moves its answers: at the first step's
    first sampled row, a quarter added to env 0's first agent's first
    relative feature, and 1 to its reward."""
    return (0, min(prog["obs_rows"][0]), 0, 0, 0, 0.25)
