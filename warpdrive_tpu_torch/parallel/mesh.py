"""
Process meshes and env-axis sharding over ``torch.distributed``.

The port's counterpart of ``warpdrive_tpu/parallel/mesh.py``.  The JAX
package builds one SPMD program over a device mesh and lets XLA insert the
collectives; here every device is driven by a process of its own (the
original WarpDrive's one-process-per-GPU design, and PyTorch's idiom), and
the collectives are explicit.  The contract is the JAX mesh's: a run of W
ranks over E global envs computes what one process computes over the same
E envs, exactly where the random draws are the same and within the update
tolerance where only the summation order differs.

* A :class:`Mesh` is ``dp x tp`` ranks over an initialized process group
  (``make_mesh``, ``make_mesh_2d``; ``initialize_multihost`` brings the
  group up).  Rank ``r`` is env rank ``r // tp`` and model rank ``r % tp``
  (JAX's device grid ``reshape(dp, tp)``); the *env group* of a rank holds
  the ranks of its model rank (gradients and global means are summed over
  it), its *model group* the ranks of its env rank (which hold the same
  envs and cut the parameters between them).
* Env rank ``d`` holds env rows ``[d E/dp, (d+1) E/dp)``: every tensor
  whose dim 0 is ``num_envs`` is cut to those rows, the time-major replay
  window's tensors (``buf``/``done_buf`` in JAX, ``window`` here) on dim 1,
  and everything else stays whole (:func:`env_cut_dim`).
* Losses are each rank's numerator over the global denominator and
  gradients are all-reduced with SUM (not DDP's mean, which equals the
  global mean only for equal unweighted shards); metrics that need every
  rank are :class:`Deferred` and combined at log points
  (:func:`reduce_metrics`).
* Tensor parallelism (``tp > 1``): each weight's largest axis that ``tp``
  divides is cut over the model group (:func:`tp_axis`,
  :func:`shard_params_tp`), and so are Adam's moments; the optimizer steps
  the rank's shard and gathers the cut weights across the model group
  before the next forward (``training/trainer_a2c.py:ClippedAdam``).

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``; a
caller may name gloo for CUDA tensors (two ranks sharing one card).  Gloo
reduces and broadcasts CUDA tensors but gathers none, so gathers of CUDA
tensors over gloo go through host copies.  There is no fallback: a failed
NCCL initialization raises.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

ENV_AXIS = "env"
MODEL_AXIS = "model"

# seconds a collective (and the rendezvous) may wait for its peers
DEFAULT_TIMEOUT_S = 300

# top-level training-state keys holding nets and optimizer states: never
# env-cut, whatever their dim 0 (a weight of 256 rows beside 256 envs)
_PARAM_KEYS = ("params", "opt", "actor", "critic", "target_actor",
               "target_critic", "opt_actor", "opt_critic", "models",
               "optimizers", "nets", "targets")
# top-level keys holding TIME-MAJOR replay tensors (capacity, E, ...): the
# env axis is dim 1
_REPLAY_KEYS = ("buf", "done_buf", "window")


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device, process_id: int = None) -> torch.device:
    """``device``, a bare ``cuda`` made this process's card: ``LOCAL_RANK``
    (as ``torchrun`` sets it), else the process id (``RANK`` without one),
    modulo the visible cards."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if process_id is None:
        process_id = os.environ.get("RANK", 0)
    local = int(os.environ.get("LOCAL_RANK", process_id))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def initialize_multihost(coordinator_address: str = None,
                         num_processes: int = None, process_id: int = None,
                         backend: str = None, device="cuda",
                         timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the process group: ``coordinator_address`` (``host:port`` of
    process 0's rendezvous), ``num_processes`` and this ``process_id``;
    without a coordinator, the ``MASTER_ADDR``/``MASTER_PORT``/
    ``WORLD_SIZE``/``RANK`` variables (``env://``, as ``torchrun`` sets
    them).  ``backend`` defaults to the device's; collectives and the
    rendezvous wait at most ``timeout_s`` seconds.  A CUDA device (a bare
    ``cuda``: :func:`local_device`) is made current first, as NCCL
    needs."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    backend = backend or default_backend(device)
    dev = local_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = dict(backend=backend, timeout=timedelta(seconds=timeout_s))
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        kwargs.update(init_method=f"tcp://{coordinator_address}",
                      world_size=int(num_processes), rank=int(process_id))
    else:
        kwargs["init_method"] = "env://"
    dist.init_process_group(**kwargs)


def _rank_device(backend: str):
    """A rank's device when the caller names none: its own card under NCCL
    (``LOCAL_RANK``, else the rank modulo the visible cards), the CPU under
    gloo."""
    if backend != "nccl":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK",
                               dist.get_rank() % torch.cuda.device_count()))
    return torch.device("cuda", local)


@dataclass
class GroupStats:
    """What the collectives cost: calls by kind, host seconds waited."""

    calls: dict = field(default_factory=dict)
    seconds: float = 0.0

    def count(self, kind: str):
        self.calls[kind] = self.calls.get(kind, 0) + 1


class Mesh:
    """``dp x tp`` ranks of the initialized process group.  Build it with
    :func:`make_mesh` or :func:`make_mesh_2d`."""

    def __init__(self, dp: int, tp: int, device=None):
        if not dist.is_initialized():
            raise ValueError(
                "a mesh needs an initialized process group: start the ranks "
                "with warpdrive_tpu_torch.parallel.launch.launch (or the "
                "CLI's -n), or call initialize_multihost in each process")
        world = dist.get_world_size()
        if dp * tp != world:
            raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} ranks, the "
                             f"process group has {world}")
        self.dp, self.tp = int(dp), int(tp)
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.device = (torch.device(device) if device is not None
                       else _rank_device(self.backend))
        self.env_rank, self.model_rank = divmod(self.rank, self.tp)
        self.stats = GroupStats()
        # when set, each collective waits for the device before and after,
        # so ``stats.seconds`` holds the collectives' own time
        self.timed = False
        # every rank creates every group, in the same order
        self.env_group = self.model_group = None
        for m in range(self.tp):
            ranks = [d * self.tp + m for d in range(self.dp)]
            group = (dist.group.WORLD if len(ranks) == world
                     else dist.new_group(ranks))
            if m == self.model_rank:
                self.env_group, self._env_ranks = group, ranks
        for d in range(self.dp):
            ranks = [d * self.tp + m for m in range(self.tp)]
            group = (dist.group.WORLD if len(ranks) == world
                     else dist.new_group(ranks) if self.tp > 1 else None)
            if d == self.env_rank:
                self.model_group, self._model_ranks = group, ranks

    # ------------------------------------------------------------ layout
    @property
    def world_size(self) -> int:
        return self.dp * self.tp

    @property
    def is_lead(self) -> bool:
        return self.rank == 0

    def env_rows(self, num_envs: int) -> slice:
        """The global env rows this rank holds."""
        if num_envs % self.dp:
            raise ValueError(f"num_envs={num_envs} must divide evenly over "
                             f"{self.dp} env-axis shards")
        size = num_envs // self.dp
        return slice(self.env_rank * size, (self.env_rank + 1) * size)

    def env_rank_of_row(self, row: int, num_envs: int) -> int:
        return int(row) // (num_envs // self.dp)

    # -------------------------------------------------------- collectives
    def _group(self, axis: str):
        return {ENV_AXIS: self.env_group, MODEL_AXIS: self.model_group,
                "world": dist.group.WORLD}[axis]

    def _ranks(self, axis: str) -> list:
        return {ENV_AXIS: self._env_ranks, MODEL_AXIS: self._model_ranks,
                "world": list(range(self.world_size))}[axis]

    def _stage(self, x: torch.Tensor, gather: bool = False) -> torch.Tensor:
        """The tensor the backend communicates: NCCL's on the rank's card,
        gloo's where it lies, except that gloo gathers CUDA tensors through
        host copies."""
        if self.backend == "nccl":
            return x.to(self.device)
        return x.cpu() if gather and x.is_cuda else x

    def _run(self, kind: str, fn, x: torch.Tensor):
        self.stats.count(kind)
        # a graph capture (core/program.py) waits for nothing
        timed = (self.timed and x.is_cuda
                 and not torch.cuda.is_current_stream_capturing())
        if timed:
            torch.cuda.synchronize(x.device)
        start = time.perf_counter()
        out = fn()
        if timed:
            torch.cuda.synchronize(x.device)
        self.stats.seconds += time.perf_counter() - start
        return out

    def all_reduce(self, x: torch.Tensor, axis: str = ENV_AXIS,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced over the axis's group, in place; returns ``x``."""
        staged = self._stage(x)

        def run():
            dist.all_reduce(staged, op=op, group=self._group(axis))
            if staged is not x:
                x.copy_(staged)
            return x

        return self._run("all_reduce", run, x)

    def broadcast(self, x: torch.Tensor, src: int = 0,
                  axis: str = "world") -> torch.Tensor:
        """``x`` from the axis group's member ``src`` (its index in the
        group), in place; returns ``x``."""
        staged = self._stage(x)

        def run():
            dist.broadcast(staged, src=self._ranks(axis)[src],
                           group=self._group(axis))
            if staged is not x:
                x.copy_(staged)
            return x

        return self._run("broadcast", run, x)

    def all_gather(self, x: torch.Tensor, dim: int = 0,
                   axis: str = ENV_AXIS) -> torch.Tensor:
        """Every member's ``x`` (all of one shape) concatenated on ``dim``
        in group order, on ``x``'s device."""
        staged = self._stage(x, gather=True).contiguous()

        def run():
            parts = [torch.empty_like(staged)
                     for _ in range(len(self._ranks(axis)))]
            dist.all_gather(parts, staged, group=self._group(axis))
            return torch.cat(parts, dim=dim).to(x.device)

        return self._run("all_gather", run, x)

    def warm_up(self):
        """Create the communicators a captured program's collectives use,
        the env group's and (tp > 1) the model group's, with one all-reduce
        each, outside any capture: NCCL makes a group's communicator at its
        first collective, which a graph capture cannot hold."""
        one = torch.zeros((1,), device=self.device)
        self.all_reduce(one)
        if self.tp > 1:
            self.all_reduce(one, MODEL_AXIS)

    def reduce_grads(self, grads) -> list:
        """Gradients summed over the env group: one all-reduce of them
        flattened together."""
        grads = list(grads)
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce(flat)
        out, start = [], 0
        for g in grads:
            out.append(flat[start:start + g.numel()].view_as(g))
            start += g.numel()
        return out

    @torch.no_grad()
    def broadcast_module(self, module: torch.nn.Module):
        """``module``'s parameters and buffers from rank 0."""
        for t in list(module.parameters()) + list(module.buffers()):
            self.broadcast(t.data)


def make_mesh(num_devices: int = None, device=None) -> Mesh:
    """A 1-D mesh: every rank of the process group on the env axis.
    ``num_devices``, when given, must be the group's size (one process a
    device)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    num_devices = world if num_devices is None else int(num_devices)
    if num_devices != world:
        raise ValueError(f"num_devices={num_devices}, but the process group "
                         f"has {world} ranks (one process a device)")
    return Mesh(dp=num_devices, tp=1, device=device)


def make_mesh_2d(dp: int, tp: int, device=None) -> Mesh:
    """A ``(env, model)`` mesh: env rows cut over ``dp`` ranks, parameters
    over ``tp``."""
    return Mesh(dp=dp, tp=tp, device=device)


# ------------------------------------------------------- the env-axis cut
def env_cut_dim(key: str, x, num_envs: int, time_major: bool = False):
    """The dim a tensor is cut on over the env axis, or None: dim 1 for
    the time-major replay tensors, dim 0 for any other tensor whose dim 0
    is ``num_envs``."""
    if not isinstance(x, torch.Tensor):
        return None
    if time_major or key in _REPLAY_KEYS:
        return 1 if x.ndim >= 2 and x.shape[1] == num_envs else None
    return 0 if x.ndim >= 1 and x.shape[0] == num_envs else None


def _cut(x: torch.Tensor, dim, rows: slice) -> torch.Tensor:
    if dim is None:
        return x
    return x.narrow(dim, rows.start, rows.stop - rows.start).clone()


def shard_state(state: dict, mesh: Mesh, num_envs: int) -> dict:
    """The rank's rows of an env state: every tensor whose dim 0 is
    ``num_envs`` cut, everything else whole."""
    rows = mesh.env_rows(num_envs)
    return {k: _cut(v, env_cut_dim(k, v, num_envs, False), rows)
            for k, v in state.items()}


def carry_env_dims(carry, num_envs: int):
    """The env-axis dim of each tensor of a single-process training state
    (nested dicts), by the cut rule: None for nets and optimizer states,
    dim 1 for the replay window's tensors, dim 0 for any other tensor of
    ``num_envs`` rows, None for everything else."""

    def walk(tree, time_major):
        if isinstance(tree, dict):
            return {k: (None if k in _PARAM_KEYS
                        else walk(v, time_major or k in _REPLAY_KEYS))
                    for k, v in tree.items()}
        return env_cut_dim("", tree, num_envs, time_major)

    return walk(carry, False)


def _map_cut(fn, carry, dims):
    """``fn(tensor, dim)`` at every leaf of ``carry`` whose entry in the
    ``dims`` tree is a dim; every other leaf and subtree as it is."""
    if dims is None:
        return carry
    if isinstance(carry, dict):
        return {k: _map_cut(fn, v, dims.get(k)) for k, v in carry.items()}
    return fn(carry, dims)


def shard_carry(carry, mesh: Mesh, num_envs: int, dims=None):
    """The rank's share of a training state (nested dicts): the tensors
    that ``dims`` (a tree of env-axis dims, by default
    :func:`carry_env_dims` of ``carry``) names cut to the rank's rows,
    everything else whole."""
    rows = mesh.env_rows(num_envs)
    dims = carry_env_dims(carry, num_envs) if dims is None else dims
    return _map_cut(lambda x, d: _cut(x, d, rows), carry, dims)


def gather_carry(carry, mesh: Mesh, dims):
    """The inverse of :func:`shard_carry` with the same ``dims``: exactly
    the tensors it cut gathered over the env group, on their env axis."""
    return _map_cut(mesh.all_gather, carry, dims)


def to_host(x: torch.Tensor, mesh: Mesh = None, dim: int = None
            ) -> np.ndarray:
    """A host numpy array of ``x``; an env-cut tensor (``dim``, its env
    axis, given with a ``mesh``) gathered over the env group first."""
    if mesh is not None and dim is not None:
        x = mesh.all_gather(x, dim)
    return x.detach().cpu().numpy()


def apply_env_sharding(engine, num_devices: int = None, mesh: Mesh = None,
                       tp: int = 1):
    """Attach a mesh to an :class:`~warpdrive_tpu_torch.envs.engine.
    EnvEngine` and keep the rank's env rows of its state.  The engine has
    built the whole initial state from its seed, so rank ``r`` starts bit
    for bit at its rows of the single-process engine; ``n_envs`` stays
    global and ``engine.env_rows`` names the rows; every rank must have
    built the same state (raises otherwise); ``engine.env_dims`` records
    each state key's env-axis dim (None: whole).  The store's generator
    (pool rows of forced resets) becomes a per-rank stream: env rank ``d``
    reseeds it ``seed + 1000 d``.

    :param tp: model-axis size; > 1 builds a ``(env, model)`` mesh over
        the whole group, whose trainers cut their parameters over it.
    """
    if mesh is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        total = world if num_devices is None else int(num_devices)
        if total % tp:
            raise ValueError(f"{total} devices not divisible by tp={tp}")
        mesh = (make_mesh(num_devices=total, device=engine.device)
                if tp == 1 else
                make_mesh_2d(dp=total // tp, tp=tp, device=engine.device))
    rows = mesh.env_rows(engine.n_envs)  # raises unless dp divides E
    _check_same_everywhere(engine, mesh)
    engine.mesh = mesh
    engine.env_rows = rows
    # the cut of each state key, decided on the whole state
    engine.env_dims = {k: env_cut_dim(k, v, engine.n_envs)
                       for k, v in engine.state.items()}
    engine.state = shard_state(engine.state, mesh, engine.n_envs)
    engine.store.state = engine.state
    if mesh.env_rank:
        engine.store.generator.manual_seed(
            int(engine.store.meta["seed"]) + 1000 * mesh.env_rank)
    return engine


def _check_same_everywhere(engine, mesh: Mesh):
    """Raise unless every rank built the same initial state, reset
    snapshot and pools: an env that draws its own (built without a seed)
    would give each rank other envs and other agents."""
    store = engine.store
    tensors = [t for part in (engine.state, store.snapshot, store.pools)
               for _, t in sorted(part.items())]
    sums = torch.stack([t.to(torch.float64).sum() for t in tensors])
    both = torch.cat([sums, -sums]).to(mesh.device)
    mesh.all_reduce(both, "world", op=dist.ReduceOp.MAX)
    if not torch.equal(both[:len(sums)], -both[len(sums):]):
        raise ValueError(
            "the ranks built different initial env states: give the env a "
            "seed, so that every rank builds the same envs")


# --------------------------------------------------- tensor parallelism
def tp_axis(shape, tp: int):
    """The axis a parameter is cut on over ``tp`` ranks: its largest axis
    that ``tp`` divides (the lowest of equal ones), or None (whole)."""
    for ax in sorted(range(len(shape)), key=lambda a: -shape[a]):
        if shape[ax] % tp == 0 and shape[ax] >= tp:
            return ax
    return None


def tp_shard(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a whole parameter (or of its gradient or
    moments) over the model group: a view cut on :func:`tp_axis`, or the
    tensor itself where it is not cut."""
    ax = tp_axis(x.shape, mesh.tp) if mesh.tp > 1 else None
    if ax is None:
        return x
    size = x.shape[ax] // mesh.tp
    return x.narrow(ax, mesh.model_rank * size, size)


def shard_params_tp(params: dict, mesh: Mesh) -> dict:
    """``{name: this rank's shard}`` of a parameter dict (a
    ``state_dict``, or JAX's parameters gathered and mapped by
    ``params_from_flax``)."""
    return {name: tp_shard(p, mesh) for name, p in params.items()}


# ---------------------------------------------------------- global metrics
class Deferred:
    """A metric whose value needs every env rank: the rank's ``sums``
    (summed over the ranks) and ``maxes`` (maximized), combined by
    ``finish(sums, maxes)``.  ``finish`` may return another
    :class:`Deferred`, a second pass over the first one's results (the
    centred squares of a variance about the global mean).  Finished over
    the env group at a log point (:func:`reduce_metrics`), or on the rank
    alone (:meth:`local`)."""

    def __init__(self, sums=(), maxes=(), finish=None):
        self.sums = [torch.as_tensor(s, dtype=torch.float32).reshape(-1)
                     for s in sums]
        self.maxes = [torch.as_tensor(m, dtype=torch.float32).reshape(-1)
                      for m in maxes]
        self.finish = finish or (lambda s, m: (s or m)[0])

    def local(self) -> torch.Tensor:
        """The value over this rank's rows alone."""
        return _finish_all([self], None)[0]


def _finish_all(deferred: list, mesh) -> list:
    """The values of ``deferred`` (other entries pass as they are): each
    pass one SUM and one MAX all-reduce over the env group for all of
    them, or none without a mesh."""
    out = list(deferred)
    pending = [i for i, d in enumerate(out) if isinstance(d, Deferred)]
    while pending:
        for kind, op in (("sums", dist.ReduceOp.SUM),
                         ("maxes", dist.ReduceOp.MAX)):
            parts = [p for i in pending for p in getattr(out[i], kind)]
            if mesh is not None and parts:
                flat = torch.cat([p.to(mesh.device) for p in parts])
                mesh.all_reduce(flat, op=op)
                parts = torch.split(flat, [p.numel() for p in parts])
            reduced = iter(parts)
            for i in pending:
                setattr(out[i], f"_{kind}",
                        [x if x.numel() > 1 else x[0]
                         for _, x in zip(getattr(out[i], kind), reduced)])
        out = [d.finish(d._sums, d._maxes) if i in pending else d
               for i, d in enumerate(out)]
        pending = [i for i in pending if isinstance(out[i], Deferred)]
    return out


def _max_of(x: torch.Tensor) -> torch.Tensor:
    """``x``'s largest entry; -inf for a rank that holds no row."""
    if x.numel() == 0:
        return torch.full((), -float("inf"), device=x.device)
    return x.max().to(torch.float32)


class MetricOps:
    """The metric reductions of the algorithms, each one formula: with an
    env group a :class:`Deferred` over every rank's rows, without one the
    same finished at once on the rank's tensors."""

    def __init__(self, group=None):
        self.group = group

    def out(self, d: Deferred):
        return d if self.group is not None else d.local()

    def value(self, x: torch.Tensor):
        """A loss term each rank holds a part of (its numerator over the
        global denominator): the sum over ranks."""
        return self.out(Deferred(sums=[x]))

    def mean(self, x: torch.Tensor):
        return self.out(Deferred(sums=[x.float().sum(), float(x.numel())],
                                 finish=lambda s, m: s[0] / s[1]))

    def max(self, x: torch.Tensor):
        return self.out(Deferred(maxes=[_max_of(x)]))

    def min(self, x: torch.Tensor):
        return self.out(Deferred(maxes=[_max_of(-x)],
                                 finish=lambda s, m: -m[0]))

    def std_mean(self, x: torch.Tensor, dim: int):
        """The mean over the other axes of the population std along
        ``dim``; along the env axis (1) in two passes over every rank's
        rows: the mean, then the centred squares."""
        if dim != 1:
            std = x.std(dim=dim, correction=0)
            return self.mean(std)
        x = x.float()

        def centred(s, m):
            n = s[1]
            mean = (s[0] / n).reshape(x.sum(dim=1).shape).unsqueeze(1)
            return Deferred(sums=[((x - mean) ** 2).sum(dim=1)],
                            finish=lambda s2, m2: torch.sqrt(s2[0] / n).mean())

        return self.out(Deferred(sums=[x.sum(dim=1), float(x.shape[1])],
                                 finish=centred))

    def variance_explained(self, adv: torch.Tensor, ret: torch.Tensor,
                           eps: float):
        """``max(1 - var(adv) / (var(ret) + eps), -1)`` over all entries,
        the variances in two passes: the means, then the centred
        squares."""

        def centred(s, m):
            n = s[2]
            return Deferred(
                sums=[((adv - s[0] / n) ** 2).sum(),
                      ((ret - s[1] / n) ** 2).sum()],
                finish=lambda s2, m2: torch.clamp(
                    1.0 - (s2[0] / n) / (s2[1] / n + eps), min=-1.0))

        return self.out(Deferred(
            sums=[adv.sum(), ret.sum(), float(adv.numel())],
            finish=centred))


def reduce_metrics(metrics: dict, mesh: Mesh = None) -> dict:
    """``{tag: {name: float}}`` of a metric dict: :class:`Deferred` values
    finished over the env group (one SUM and one MAX all-reduce a pass for
    all of them; every rank must call this at the same log point), or on
    the rank alone without a mesh; tensors and numbers read as they
    are."""
    names = [(tag, name) for tag, m in metrics.items() for name in m]
    values = _finish_all([metrics[tag][name] for tag, name in names], mesh)
    out = {tag: {} for tag in metrics}
    for (tag, name), v in zip(names, values):
        out[tag][name] = float(v)
    return out
