"""One process per rank: the port's counterpart of ``jax.shard_map`` over a
1-D data mesh or a 2-D (data x model) mesh.  No module of the JAX package
corresponds to this one.

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

A 2-D mesh (:func:`make_mesh_2d`, :class:`Mesh2D`) puts rank r at
(i, j) = divmod(r, M), the row-major device order of ``jax.make_mesh``;
it holds a :class:`DataMesh` over the D ranks that share j (the data
axis), one over the M ranks that share i (the model axis) and one over all
D M.  Every collective's backward is its transpose (``allsum`` and
``all_gather`` all-reduce the cotangent, ``ppermute`` shifts it back), so
the rule above holds with P = D M: ``sharded_value_and_grad`` and
``sharded_grad`` divide by the whole mesh and all-reduce over it.

Lock step: every branch the host takes reads a value that came out of a
collective (the L-BFGS reads the broadcast value and the all-reduced
gradient; the Newton line search, EP and CG read all-reduced sums), so no
rank takes a different number of collectives than another.  On a 2-D
mesh every rank also builds the same autograd graph (code that differs by
rank masks, it does not branch), so the backward's collectives come in the
same order on every rank.
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
MODEL_AXIS = "model"
#: seconds a collective waits for the other ranks before it raises
GROUP_TIMEOUT = 120.0
#: this process's collective timeout (``run_spmd`` sets it in each rank)
_timeout = GROUP_TIMEOUT


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

    def all_gather(self, x, dim: int = 0):
        """The ranks' ``x`` concatenated along ``dim`` in rank order (dim 1:
        ``lax.all_gather(..., axis=1, tiled=True)``); its backward
        all-reduces the cotangent and keeps this rank's block."""
        return AllGather.apply(x, self, dim)

    def ppermute(self, x, shift: int = 1):
        """``x`` sent ``shift`` ranks up the ring: rank j receives rank
        j - shift's.  Its backward sends the cotangent ``shift`` ranks
        down."""
        if shift % self.size == 0:
            return x
        return PPermute.apply(x, self, shift)

    def _shift(self, x, shift: int):
        """One ring transfer of ``x`` (no autograd)."""
        src = x.detach().contiguous()
        out = torch.empty_like(src)
        up = self.ranks[(self.rank + shift) % self.size]
        down = self.ranks[(self.rank - shift) % self.size]

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
    """(x, mesh, dim) -> the ranks' x concatenated along dim."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.width = mesh, dim, x.shape[dim]
        src = x.detach().contiguous()
        out = [torch.empty_like(src) for _ in range(mesh.size)]

        def op(s, *o):
            dist.all_gather(list(o), s, group=mesh.group)

        mesh._run("all_gather", op, src, *out)
        return torch.cat(out, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce_(g.detach().clone().contiguous())
        return g.narrow(ctx.dim, ctx.mesh.rank * ctx.width,
                        ctx.width), None, None


class PPermute(torch.autograd.Function):
    """(x, mesh, shift) -> rank j - shift's x; the backward shifts the
    cotangent back (the transpose of a permutation is its inverse)."""

    @staticmethod
    def forward(ctx, x, mesh, shift):
        ctx.mesh, ctx.shift = mesh, shift
        return mesh._shift(x, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._shift(g, -ctx.shift), None, None


def allsum_many(mesh: DataMesh, tensors):
    """Each tensor of ``tensors`` summed over the ranks, in one collective
    (carried in the first one's dtype)."""
    dtype = tensors[0].dtype
    flat = mesh.allsum(torch.cat([t.reshape(-1).to(dtype)
                                  for t in tensors]))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def allsum_fields(mesh: DataMesh, obj):
    """``obj`` (a dataclass of tensors, e.g. ``StreamStats``) with every
    field summed over the ranks in one collective."""
    names = [f.name for f in dataclasses.fields(obj)]
    return dataclasses.replace(obj, **dict(zip(names, allsum_many(
        mesh, [getattr(obj, n) for n in names]))))


def _whole(mesh):
    """The mesh over every rank of ``mesh``: a 2-D mesh's ``all``."""
    return getattr(mesh, "all", mesh)


def sharded_grad(mesh, value, inputs):
    """Gradients of the replicated scalar ``value`` with respect to the
    replicated leaves ``inputs``: the backward of value / P, all-reduced in
    one collective (module docstring; on a 2-D mesh P = D M).  Leaves the
    value does not reach get zeros."""
    mesh = _whole(mesh)
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


def sharded_value_and_grad(mesh, f, x, *args):
    """(f(x, *args), its gradient in x) of a replicated scalar objective:
    the value is rank 0's, broadcast, and the gradient all-reduced, so
    every rank reads the same bits.  ``functools.partial(
    sharded_value_and_grad, mesh, f)`` is an ``fg_of`` for
    ``optim.fit_packed_objective``; ``mesh`` a 1-D or a 2-D mesh."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        val = f(x, *args)
        (g,) = sharded_grad(mesh, val, (x,))
    return _whole(mesh).broadcast(val.detach()), g


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
    group = _group(ranks, world)
    if rank >= n:
        return None
    return _member(group, ranks, rank)


def _group(ranks, world: int):
    """The process group of ``ranks`` (collective: every rank of the
    world calls it, member or not)."""
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(list(ranks),
                          timeout=datetime.timedelta(seconds=_timeout))


def _member(group, ranks, rank: int) -> DataMesh:
    """This rank's DataMesh over ``group``."""
    return DataMesh(group=group, rank=ranks.index(rank), size=len(ranks),
                    device=rank_device(_platform(None), rank),
                    backend=dist.get_backend(group), ranks=ranks)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh2D:
    """A 2-D (data x model) mesh: this rank's :class:`DataMesh` over the
    ranks that share its column j (``data``: the rows' axis, ``psum``
    over ``DATA_AXIS``), over those that share its row i (``model``: the
    inducing columns' axis) and over all of them (``all``).  It stands
    where the JAX package takes a 2-D ``Mesh``."""

    data: DataMesh
    model: DataMesh
    all: DataMesh

    @property
    def i(self) -> int:
        return self.data.rank

    @property
    def j(self) -> int:
        return self.model.rank

    @property
    def device(self) -> torch.device:
        return self.all.device

    @property
    def backend(self) -> str:
        return self.all.backend

    @property
    def size(self) -> int:
        return self.all.size

    @property
    def shape(self) -> dict:
        """{DATA_AXIS: D, MODEL_AXIS: M}, as ``Mesh.shape``."""
        return {DATA_AXIS: self.data.size, MODEL_AXIS: self.model.size}

    @property
    def staged(self) -> dict:
        """The three meshes' host-staged collectives, by axis and name."""
        return {f"{axis}.{name}": count for axis in ("data", "model", "all")
                for name, count in getattr(self, axis).staged.items()}


def make_mesh_2d(n_data: int, n_model: int) -> Mesh2D | None:
    """The (n_data, n_model) mesh over the first n_data * n_model ranks of
    this process's world: rank r at (i, j) = divmod(r, n_model), data
    member i holding rows [i n/D, (i+1) n/D) (``sharded.shard_batch``).
    Every rank of the world must call it (it creates all D + M + 1 groups,
    in one order, members or not); ranks outside the mesh get None."""
    world = dist.get_world_size()
    n = n_data * n_model
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model}: both axes need >= 1")
    if n > world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n} devices, "
                         f"have {world}")
    all_ranks = tuple(range(n))
    columns = [tuple(i * n_model + j for i in range(n_data))
               for j in range(n_model)]
    rows = [tuple(i * n_model + j for j in range(n_model))
            for i in range(n_data)]
    g_all = _group(all_ranks, world)
    g_data = [_group(r, world) for r in columns]
    g_model = [_group(r, world) for r in rows]
    rank = dist.get_rank()
    if rank >= n:
        return None
    i, j = divmod(rank, n_model)
    return Mesh2D(data=_member(g_data[j], columns[j], rank),
                  model=_member(g_model[i], rows[i], rank),
                  all=_member(g_all, all_ranks, rank))


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
    global _timeout
    os.environ["GPR_TPU_PLATFORM"] = platform
    _timeout = timeout
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
