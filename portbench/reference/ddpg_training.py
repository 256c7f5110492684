"""
The reference's follow of a DDPG training run's compared iterations, and
the numbers that judge the program's iterations against it.

The benchmark hands both sides the same inputs: the env's seed (its
starting state and reset pool), the parameters it made from the seed (the
targets start as copies) and the configuration.  The program's random
draws are given too: each iteration's OU noise as the program drew it
(``stddev N(0, 1)``), and its generator's state before each rollout step,
from which the reference draws that step's reset rows itself
(:meth:`Pendulum.draw_rows`).  The reference recomputes everything else:
the observations, the actor's actions with their exploration, the env's
steps, rewards, done flags and resets, the replay window, both losses, both
optimizers' steps and the targets.  It steps its env with the program's
actions, as it reads a served model's tokens, and judges the program's
actions against its own.

What the program gave (``prog``):

* ``start``: its env state before the first iteration (``state`` ``(E, 1,
  2)``, ``timestep`` and ``done`` ``(E,)``) and ``pool``, its reset pool;
* ``theta0``: ``{"actor", "critic"}`` parameters the benchmark made;
* ``stretches``: runs of consecutive iterations, each ``{"carry",
  "iterations"}``: the first from the start (``carry`` None); a later one
  from the program's own carry before it (``state``, ``timestep``, ``ou``,
  ``window``, ``filled``, ``nets``, ``targets`` and ``adam``: each net's
  ``count``, ``mu``, ``nu``);
* each iteration: its ``timestep``, ``noise`` ``(T, E, A, C)``, ``gen``
  (``T`` generator states), its rows ``obs`` ``(T, E, A, F)``, ``actions``
  ``(T, E, A, C)``, ``rewards`` ``(T, E, A)``, ``done`` ``(T, E)``, the
  losses its update reported (None where it reported none), and after it
  ``nets``, ``targets``, ``state`` and ``timestep_after``.
"""

from __future__ import annotations

import torch

from portbench.reference import ddpg
from portbench.reference.a2c import ClippedAdam
from portbench.reference.pendulum import Pendulum

_NETS = ("actor", "critic")


def _settings(cfg: dict) -> dict:
    """What the reference reads of the run configuration: its one
    policy's rules, the exploration and the window's ``n``."""
    (policy,) = cfg["policy"].values()
    lr = policy["lr"]
    if not isinstance(lr, dict):
        lr = {"actor": lr, "critic": lr}
    sampler = (cfg.get("sampler") or {}).get("params") or {}
    return {"gamma": float(policy["gamma"]), "tau": float(policy["tau"]),
            "n": int(cfg["trainer"].get("n_step", 1)), "lr": lr,
            "max_norm": (float(policy["max_grad_norm"])
                         if policy.get("clip_grad_norm", True) else None),
            "output_w": float(policy["model"]["actor"]["output_w"]),
            "damping": float(sampler.get("damping", 0.15)),
            "scale": float(sampler.get("scale", 1.0))}


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def _clone(tree: dict) -> dict:
    return {n: t.detach().clone() for n, t in tree.items()}


def _start_carry(env: Pendulum, prog: dict, shape: tuple, W: int) -> dict:
    """The reference's own carry before the first iteration: its env's
    start, OU state and window zero, the benchmark's parameters, fresh
    optimizers."""
    E, A, F, C = shape
    device = env.device

    def zeros(*s, dtype=torch.float32):
        return torch.zeros(s, dtype=dtype, device=device)

    return {"env": {k: v.clone() for k, v in env.start.items()},
            "ou": zeros(E, A, C),
            "window": {"obs": zeros(W, E, A, F), "actions": zeros(W, E, A, C),
                       "rewards": zeros(W, E, A),
                       "done": zeros(W, E, dtype=torch.int32)},
            "filled": 0,
            "nets": {net: _clone(prog["theta0"][net]) for net in _NETS},
            "targets": {net: _clone(prog["theta0"][net]) for net in _NETS},
            "adam": None}


def _program_carry(carry: dict) -> dict:
    """The program's carry in the reference's terms."""
    return {"env": {"x": carry["state"][:, 0].clone(),
                    "t": carry["timestep"].to(torch.int32).clone()},
            "ou": carry["ou"].clone(),
            "window": {k: v.clone() for k, v in carry["window"].items()},
            "filled": int(carry["filled"]),
            "nets": {net: _clone(carry["nets"][net]) for net in _NETS},
            "targets": {net: _clone(carry["targets"][net]) for net in _NETS},
            "adam": carry["adam"]}


def _optimizers(carry: dict, params: dict, max_norm) -> dict:
    opts = {net: ClippedAdam(params[net], max_norm) for net in _NETS}
    if carry["adam"] is not None:
        for net in _NETS:
            state = carry["adam"][net]
            opts[net].count = int(state["count"])
            opts[net].mu = _clone(state["mu"])
            opts[net].nu = _clone(state["nu"])
    return opts


def follow(prog: dict, cfg: dict, env_seed: int, matmul: str = "float32",
           fault: str = None) -> dict:
    """The reference's own outputs for the program's compared iterations:
    ``start`` and ``pool`` (its env's), and for each stretch, for each
    iteration, its rows (``obs``, ``actions``, ``rewards``, ``done``), its
    losses and the actor's loss scale, and after it ``nets``, ``targets``,
    ``state`` ``(E, 2)`` and ``timestep_after``.

    ``fault`` puts a known fault into the reference (the controls):
    ``"no_polyak"`` leaves the targets where they are, ``"updated_critic"``
    takes the actor's loss through the critic after its step (upstream's
    order), ``"half_window"`` takes the losses over the first half of the
    envs, ``"ou_reset"`` drops the OU state between steps, ``"altered"``
    adds 1 to env 0's first reward of each stretch where it is
    produced."""
    ddpg.float32_products()
    s = _settings(cfg)
    first = prog["stretches"][0]["iterations"][0]
    T, E, A, C = first["noise"].shape
    F = first["obs"].shape[-1]
    device = first["noise"].device
    W = T + s["n"] - 1
    env = Pendulum(cfg["env"], env_seed, E, device)
    damping, scale = _f32(s["damping"], device), _f32(s["scale"], device)
    tau = _f32(s["tau"], device)
    keep = slice(0, E // 2) if fault == "half_window" else slice(None)
    out = {"start": env.start, "pool": env.pool, "stretches": []}
    for stretch in prog["stretches"]:
        carry = (_start_carry(env, prog, (E, A, F, C), W)
                 if stretch["carry"] is None
                 else _program_carry(stretch["carry"]))
        state, ou, window = carry["env"], carry["ou"], carry["window"]
        nets, targets = carry["nets"], carry["targets"]
        opts = _optimizers(carry, nets, s["max_norm"])
        filled = carry["filled"]
        results = []
        for it in stretch["iterations"]:
            rows = {"obs": [], "actions": [], "rewards": [], "done": []}
            with torch.no_grad():
                for t in range(T):
                    obs = env.observe(state)[:, None, :]  # one agent
                    mu = ddpg.actor(nets["actor"], obs, s["output_w"], matmul)
                    if fault == "ou_reset":
                        ou = torch.zeros_like(ou)
                    action, ou = ddpg.ou_step(mu, ou, it["noise"][t],
                                              damping, scale)
                    state, reward, done = env.step(
                        state, it["actions"][t].reshape(E))
                    if fault == "altered" and t == 0 and not results:
                        reward = reward.clone()
                        reward[0] += 1.0
                    state = env.reset(state, done,
                                      env.draw_rows(it["gen"][t], E))
                    for key, value in (("obs", obs), ("actions", action),
                                       ("rewards", reward[:, None]),
                                       ("done", done)):
                        rows[key].append(value)
            rows = {k: torch.stack(v) for k, v in rows.items()}
            # the window takes the program's actions, those the env took
            taken = {**rows, "actions": it["actions"]}
            window = {k: torch.cat([window[k][T:], taken[k].to(
                window[k].dtype)]) for k in window}
            filled = min(filled + T, W)
            c_loss, c_grads = ddpg.critic_loss(
                nets, targets, window, s["gamma"], s["n"], s["output_w"],
                matmul, keep)
            full = filled >= W
            new = {}
            if full:
                new["critic"] = opts["critic"].step(
                    nets["critic"], c_grads, _lr(s, "critic", it))
            # upstream's order takes the actor's loss through the new critic
            through = (new["critic"] if full and fault == "updated_critic"
                       else nets["critic"])
            a_loss, a_scale, a_grads = ddpg.actor_loss(
                nets["actor"], through, window, s["n"], s["output_w"],
                matmul, keep)
            if full:
                new["actor"] = opts["actor"].step(
                    nets["actor"], a_grads, _lr(s, "actor", it))
                nets = new
                if fault != "no_polyak":
                    targets = {net: ddpg.polyak(targets[net], nets[net], tau)
                               for net in _NETS}
            results.append({**rows, "critic_loss": c_loss,
                            "actor_loss": a_loss, "actor_scale": a_scale,
                            "nets": nets, "targets": targets,
                            "state": state["x"].clone(),
                            "timestep_after": state["t"].clone()})
        out["stretches"].append(results)
    return out


def _lr(s: dict, net: str, it: dict) -> float:
    return float(ddpg.schedule(s["lr"][net], it["timestep"]))


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def moved_gap(prog: dict, ref: dict, before: dict, floor: float) -> float:
    """The distance between the program's parameters and the reference's,
    over all leaves of the net, relative to the reference's move from
    ``before``, or to ``floor`` where that is larger (a state left where
    it was reads 1).  The whole net is judged: a leaf that barely moves
    would judge a last-place rounding of its values as a fault."""
    return (_norm_all(prog, ref)
            / max(_norm_all(ref, before), floor, 1e-30))


def _norm_all(a: dict, b: dict) -> float:
    """The norm of ``a - b`` over every leaf."""
    return sum(_norm(a[n] - b[n]) ** 2 for n in b) ** 0.5


def _floor(ref: dict, before: dict) -> float:
    """The net's move over its stretch: the smallest scale an iteration
    of it is judged on (the warm-up's iterations move nothing)."""
    return _norm_all(ref, before)


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def judge(prog: dict, ref: dict) -> dict:
    """The numbers compared, each a gap between the program and the
    reference (0 where they agree)."""
    gaps = dict.fromkeys(("obs_gap", "action_gap", "reward_gap",
                          "reset_gap", "critic_loss_gap", "actor_loss_gap",
                          "change_gap", "target_gap"), 0.0)
    mismatches = 0
    start = prog["start"]
    gaps["reset_gap"] = _max_abs(start["state"][:, 0], ref["start"]["x"])
    mismatches += int((start["timestep"].to(torch.int32)
                       != ref["start"]["t"]).sum())
    mismatches += int((start["done"] != 0).sum())
    if prog["pool"] is not None:
        gaps["reset_gap"] = max(gaps["reset_gap"], _max_abs(
            prog["pool"][:, 0], ref["pool"]))
    for stretch, results in zip(prog["stretches"], ref["stretches"]):
        if stretch["carry"] is None:
            before = {"nets": prog["theta0"], "targets": prog["theta0"]}
        else:
            before = stretch["carry"]
        last = results[-1]
        floors = {kind: {net: _floor(last[kind][net], before[kind][net])
                         for net in _NETS} for kind in ("nets", "targets")}
        for it, r in zip(stretch["iterations"], results):
            for key, name in (("obs", "obs_gap"), ("actions", "action_gap"),
                              ("rewards", "reward_gap")):
                gaps[name] = max(gaps[name], _max_abs(it[key], r[key]))
            mismatches += int((it["done"].to(torch.int32)
                               != r["done"]).sum())
            mismatches += int((it["timestep_after"].to(torch.int32)
                               != r["timestep_after"]).sum())
            gaps["reset_gap"] = max(gaps["reset_gap"], _max_abs(
                it["state"][:, 0], r["state"]))
            if it["critic_loss"] is not None:
                gaps["critic_loss_gap"] = max(
                    gaps["critic_loss_gap"],
                    abs(it["critic_loss"] - r["critic_loss"])
                    / max(abs(r["critic_loss"]), 1e-30))
                gaps["actor_loss_gap"] = max(
                    gaps["actor_loss_gap"],
                    abs(it["actor_loss"] - r["actor_loss"])
                    / max(r["actor_scale"], 1e-30))
            for kind, name in (("nets", "change_gap"),
                               ("targets", "target_gap")):
                for net in _NETS:
                    gaps[name] = max(gaps[name], moved_gap(
                        it[kind][net], r[kind][net], before[kind][net],
                        floors[kind][net]))
    return {**gaps, "mismatches": float(mismatches)}


CONTROLS = ("tf32", "bfloat16", "no_polyak", "updated_critic", "half_window",
            "ou_reset", "altered")


def control(kind: str, prog: dict, cfg: dict, env_seed: int,
            ref: dict) -> dict:
    """A control's numbers: the reference put in the program's place on the
    same inputs, with every product in a lower precision (``kind``
    "tf32", "bfloat16") or with a known fault (the other ``CONTROLS``,
    :func:`follow`'s ``fault``), judged as the program is."""
    if kind in ("tf32", "bfloat16"):
        ctl = follow(prog, cfg, env_seed, matmul=kind)
    else:
        ctl = follow(prog, cfg, env_seed, fault=kind)
    as_prog = dict(prog)
    as_prog["stretches"] = []
    for stretch, results in zip(prog["stretches"], ctl["stretches"]):
        iterations = []
        for it, r in zip(stretch["iterations"], results):
            iterations.append({
                **it, **{k: r[k] for k in ("obs", "actions", "rewards",
                                           "done", "nets", "targets",
                                           "timestep_after")},
                "state": r["state"][:, None],
                "critic_loss": (None if it["critic_loss"] is None
                                else r["critic_loss"]),
                "actor_loss": (None if it["actor_loss"] is None
                               else r["actor_loss"])})
        as_prog["stretches"].append({**stretch, "iterations": iterations})
    return judge(as_prog, ref)
