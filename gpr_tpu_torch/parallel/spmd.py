"""One process per rank: the port's counterpart of ``jax.shard_map`` over a
1-D data mesh.  No module of the JAX package corresponds to this one.

The JAX package runs its data-parallel code as one program over a device
mesh: ``shard_map`` calls the same function on every shard and
``lax.psum`` reduces across them.  The port runs the same function in one
process per rank.  :func:`run_spmd` spawns the ranks of a
``torch.distributed`` world, gives each a :class:`DataMesh`, calls the
function in every one of them and returns rank 0's result.  The Newton,
sweep, IFT and CG code of the models already reduces through an
``allsum`` hook; bound to :meth:`DataMesh.allsum` it all-reduces, so that
code runs unchanged on row shards.

Backend and device: NCCL with one card per rank (``cuda:rank``) where the
machine has a card for every rank; gloo on the CPU
(``GPR_TPU_PLATFORM=cpu``) and where ranks share a card, their tensors
staying on the card (gloo's collectives then go through pinned host
buffers, counted in ``DataMesh.staged``).  Nothing falls back: without a
card and without ``GPR_TPU_PLATFORM=cpu`` :func:`run_spmd` raises.

The gradient rule of ``allsum``.  A replicated scalar L is computed on
every rank, so each rank's backward of L alone would count the replicated
part of the graph P times.  :class:`AllSum`'s backward all-reduces its
cotangent (the transpose of a sum over ranks), and
:func:`sharded_value_and_grad` backpropagates L / P, then all-reduces the
gradient of the replicated leaves: the replicated part then sums to one
copy and every row's contribution arrives once.  Every sharded objective
takes its gradient there.  Inside a custom backward (the IFT solves) the
hook runs without a graph and is a plain all-reduce.

Lock step: every branch the host takes reads a value that came out of a
collective (the L-BFGS reads the broadcast value and the all-reduced
gradient; the Newton line search, EP and CG read all-reduced sums), so no
rank takes a different number of collectives than another.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import signal
import tempfile
import threading
import traceback

import torch
import torch.distributed as dist

DATA_AXIS = "data"
#: seconds a collective waits for the other ranks before it raises
GROUP_TIMEOUT = 120.0


def _platform(platform: str | None) -> str:
    """"cpu" or "cuda": ``platform``, else ``GPR_TPU_PLATFORM`` (as the
    CLI reads it), else the card."""
    platform = platform or os.environ.get("GPR_TPU_PLATFORM") or "cuda"
    if platform == "gpu":
        platform = "cuda"
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"platform {platform!r}: gpr_tpu_torch runs on "
                         "cuda or cpu")
    return platform


def choose_backend(platform: str, n_ranks: int) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    if platform == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"


def rank_device(platform: str, rank: int) -> torch.device:
    """The rank's device: the CPU, or card ``rank`` modulo the cards."""
    if platform == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """A 1-D data mesh: the ranks of ``group`` (global ranks ``ranks``),
    this process's ``rank`` among them and its ``device``.  It stands
    where the JAX package takes a ``Mesh``.  ``staged`` counts, by
    collective, the calls that went through pinned host buffers (gloo on
    a card)."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    ranks: tuple
    staged: dict = dataclasses.field(default_factory=dict)

    def _run(self, name, op, *tensors):
        """``op(*tensors)`` in place, staged through pinned host buffers
        where gloo meets a card."""
        if self.backend != "gloo" or not tensors[0].is_cuda:
            op(*tensors)
            return
        self.staged[name] = self.staged.get(name, 0) + 1
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t)
        op(*host)
        for h, t in zip(host, tensors):
            t.copy_(h, non_blocking=False)

    def all_reduce_(self, t):
        """Sum ``t`` over the ranks, in place (no autograd)."""
        self._run("all_reduce",
                  lambda x: dist.all_reduce(x, group=self.group), t)
        return t

    def broadcast(self, x, src: int = 0):
        """A copy of rank ``src``'s ``x`` on every rank (no autograd)."""
        t = x.detach().clone().contiguous()
        self._run("broadcast", lambda h: dist.broadcast(
            h, self.ranks[src], group=self.group), t)
        return t

    def allsum(self, x):
        """The port's ``psum``: the sum of ``x`` over the ranks, with the
        gradient rule of the module docstring."""
        return AllSum.apply(x, self)

    def all_gather(self, x):
        """The ranks' ``x`` stacked along dim 0 in rank order; its
        backward all-reduces the cotangent and keeps this rank's block."""
        return AllGather.apply(x, self)

    def ppermute(self, x):
        """``x`` sent one rank up the ring: rank j receives rank j-1's."""
        if self.size == 1:
            return x
        src = x.detach().contiguous()
        out = torch.empty_like(src)
        up = self.ranks[(self.rank + 1) % self.size]
        down = self.ranks[(self.rank - 1) % self.size]

        def op(s, r):
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, s, up, group=self.group),
                dist.P2POp(dist.irecv, r, down, group=self.group)])
            for req in reqs:
                req.wait()

        self._run("ppermute", op, src, out)
        return out


class AllSum(torch.autograd.Function):
    """(x, mesh) -> sum of x over the ranks; the backward all-reduces the
    cotangent (module docstring)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.detach().clone().contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.detach().clone().contiguous()), None


class AllGather(torch.autograd.Function):
    """(x, mesh) -> the ranks' x stacked along dim 0."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        src = x.detach().contiguous()
        out = [torch.empty_like(src) for _ in range(mesh.size)]

        def op(s, *o):
            dist.all_gather(list(o), s, group=mesh.group)

        mesh._run("all_gather", op, src, *out)
        return torch.cat(out)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce_(g.detach().clone().contiguous())
        r = ctx.mesh.rank * ctx.rows
        return g[r:r + ctx.rows], None


def allsum_fields(mesh: DataMesh, obj):
    """``obj`` (a dataclass of tensors, e.g. ``StreamStats``) with every
    field summed over the ranks in one collective."""
    names = [f.name for f in dataclasses.fields(obj)]
    vals = [getattr(obj, n) for n in names]
    dtype = vals[0].dtype
    flat = mesh.allsum(torch.cat([v.reshape(-1).to(dtype) for v in vals]))
    out, at = {}, 0
    for n, v in zip(names, vals):
        out[n] = flat[at:at + v.numel()].reshape(v.shape).to(v.dtype)
        at += v.numel()
    return dataclasses.replace(obj, **out)


def sharded_grad(mesh: DataMesh, value, inputs):
    """Gradients of the replicated scalar ``value`` with respect to the
    replicated leaves ``inputs``: the backward of value / P, all-reduced in
    one collective (module docstring).  Leaves the value does not reach
    get zeros."""
    got = torch.autograd.grad(value / mesh.size, inputs, allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g
           for g, x in zip(got, inputs)]
    dtype = got[0].dtype
    flat = mesh.all_reduce_(torch.cat([g.reshape(-1).to(dtype)
                                       for g in got]))
    out, at = [], 0
    for g in got:
        out.append(flat[at:at + g.numel()].reshape(g.shape).to(g.dtype))
        at += g.numel()
    return tuple(out)


def sharded_value_and_grad(mesh: DataMesh, f, x, *args):
    """(f(x, *args), its gradient in x) of a replicated scalar objective:
    the value is rank 0's, broadcast, and the gradient all-reduced, so
    every rank reads the same bits.  ``functools.partial(
    sharded_value_and_grad, mesh, f)`` is an ``fg_of`` for
    ``optim.fit_packed_objective``."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        val = f(x, *args)
        (g,) = sharded_grad(mesh, val, (x,))
    return mesh.broadcast(val.detach()), g


def make_mesh(n_devices: int | None = None) -> DataMesh | None:
    """The 1-D mesh over the first ``n_devices`` ranks of this process's
    world (default: all of them).  Every rank of the world must call it;
    ranks outside the mesh get None."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    rank = dist.get_rank()
    ranks = tuple(range(n))
    group = dist.group.WORLD if n == world else dist.new_group(list(ranks))
    if rank >= n:
        return None
    platform = _platform(None)
    return DataMesh(group=group, rank=rank, size=n,
                    device=rank_device(platform, rank),
                    backend=dist.get_backend(group), ranks=ranks)


def _to_cpu(obj):
    """``obj`` with every tensor in (nested) tuples, lists and dicts moved
    to the CPU, for the trip back to the caller."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_cpu(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_cpu(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def _error_payload(exc, tb):
    """The pickled exception where it pickles, else a RuntimeError with
    its text; the rank's traceback rides along."""
    try:
        return pickle.dumps((exc, tb))
    except Exception:  # an exception carrying something unpicklable
        return pickle.dumps((RuntimeError(repr(exc)), tb))


def _worker(fn, rank, n_ranks, store_path, platform, backend, timeout,
            args, results):
    os.environ["GPR_TPU_PLATFORM"] = platform
    try:
        if platform == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank_device(platform, rank))
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n_ranks), rank=rank,
            world_size=n_ranks,
            timeout=datetime.timedelta(seconds=timeout))
        out = fn(make_mesh(), *args)
        results.put(("ok", rank, pickle.dumps(_to_cpu(out) if rank == 0
                                              else None)))
    except BaseException as exc:  # reported to the caller, which re-raises
        results.put(("err", rank, _error_payload(exc,
                                                 traceback.format_exc())))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _start_ignoring_sigint(procs):
    """Start the ranks with SIGINT ignored, which they keep across exec:
    a terminal's ^C reaches the whole process group, and the ranks' lives
    are the caller's to end (``run_spmd`` stops them when it raises)."""
    main = threading.current_thread() is threading.main_thread()
    old = signal.signal(signal.SIGINT, signal.SIG_IGN) if main else None
    try:
        for p in procs:
            p.start()
    finally:
        if old is not None:
            signal.signal(signal.SIGINT, old)


def run_spmd(fn, n_ranks: int, *args, platform: str | None = None,
             timeout: float = GROUP_TIMEOUT):
    """Run ``fn(mesh, *args)`` on each of ``n_ranks`` spawned ranks and
    return rank 0's result, its tensors on the CPU.

    ``fn`` and ``args`` travel by pickle (``fn`` by its import path).
    ``platform`` "cpu" or "cuda" (default ``GPR_TPU_PLATFORM``, else the
    card) picks backend and devices (module docstring); on the CPU each
    rank runs one torch thread.  The world meets through a ``FileStore`` in
    a temporary directory, so concurrent worlds never compete for a port.
    The first rank to raise makes this raise its exception (its traceback
    in the message's note) after the other ranks are stopped; a collective
    that waits longer than ``timeout`` seconds raises in its rank.  The
    ranks ignore SIGINT: a caller that wants them to stop early tells them
    so through its ``args`` (the CLI passes an ``Event``)."""
    platform = _platform(platform)
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_spmd: no CUDA device; set "
                           "GPR_TPU_PLATFORM=cpu (or platform='cpu') to "
                           "run the ranks on the CPU")
    backend = choose_backend(platform, n_ranks)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="gpr_spmd_")
    procs = [ctx.Process(target=_worker, daemon=True, args=(
        fn, rank, n_ranks, os.path.join(tmp, "store"), platform, backend,
        timeout, args, results)) for rank in range(n_ranks)]
    grace = 1.0  # seconds a rank gets to exit before it is stopped
    try:
        _start_ignoring_sigint(procs)
        got = {}
        while len(got) < n_ranks:
            try:
                kind, rank, payload = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    r = dead[0]
                    raise RuntimeError(
                        f"run_spmd: rank {r} exited with code "
                        f"{procs[r].exitcode} before it reported")
                continue
            if kind == "err":
                exc, tb = pickle.loads(payload)
                exc.add_note(f"raised in rank {rank} of {n_ranks}:\n{tb}")
                raise exc
            got[rank] = pickle.loads(payload)
        grace = 30.0  # every rank reported: let them tear the group down
        return got[0]
    finally:
        for p in procs:
            if p.is_alive():
                p.join(timeout=grace)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
