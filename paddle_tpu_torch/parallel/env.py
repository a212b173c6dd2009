"""Mesh and collective context of the port: named axes over a
``torch.distributed`` process group.

The JAX package's mesh (``paddle_tpu/parallel/env.py``) is a
``jax.sharding.Mesh`` over the devices one controller drives, and its
collectives are ``lax.psum``/``all_gather``/``ppermute`` over a named
axis inside ``shard_map``. Here one process runs each rank (the torch
idiom): the launcher (``distributed/launch.py``) gives every process its
rank, the world size and a rendezvous, ``make_mesh`` joins the process
group and lays the ranks out row-major over the mesh's axes (the JAX
``make_mesh``'s device order), with one subgroup per slice of each axis;
``psum``/``pmean``/``all_gather``/``broadcast`` are eager collectives
over an axis's subgroup and ``send``/``recv`` point-to-point ops along
it (the pipeline's stage hops).

Backend. NCCL when each rank has a card of its own; gloo when ranks share
one card (NCCL refuses two ranks on one device) or run on the CPU. Gloo
moves CUDA tensors through host copies: for the DGC exchange those are the
k-sized (index, value) pairs, not the gradient.

``mesh_context`` installs the mesh of a ``CompiledProgram`` run (the
``pipeline_stack`` lowering finds its stage and ring axes there);
``dgc_axis_context`` installs the axis (and the step of this run, read
once by ``CompiledProgram``) that the ``dgc_momentum`` lowering exchanges
over; ``data_axis_context`` the axis of a dense data-parallel run, over
which the batch reductions it marks all-reduce
(``parallel/data_parallel.py``); ``collective_context`` binds the
``ring_id`` of the ``c_*`` collective ops to an axis
(``layers/collective.py``), as the JAX package's ``collective_context``
binds it to a mesh axis name. ``psum_diff`` and ``identity_psum_grad``
are the two autograd forms a tensor-parallel body needs (Megatron's
``g`` and ``f``). ``collective_stats`` counts each collective's calls
and the bytes this rank sent, in all or by axis with its host seconds,
so a test can see what went on the wire; ``collective_times`` splits the
fused all-reduce's host seconds into the copy to the host, the backend's
exchange and the copy back.
"""

import contextlib
import itertools
import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Axis", "Mesh", "make_mesh", "ParallelEnv", "default_backend",
           "dgc_axis_context", "current_dgc_axis", "current_dgc_step",
           "data_axis_context", "current_data_axis", "collective_context",
           "current_mesh_axis", "mesh_context", "current_mesh", "psum",
           "psum_diff", "identity_psum_grad", "psum_fused", "send", "recv",
           "pmean", "pmax", "pmin", "all_gather", "all_gather_rows",
           "all_gather_pairs", "broadcast", "broadcast_", "collective_stats",
           "collective_times", "reset_collective_stats"]

INIT_METHOD_ENV = "PADDLE_DIST_INIT_METHOD"


class ParallelEnv:
    """Process-level distributed environment discovered from env vars
    (reference: python/paddle/fluid/dygraph/parallel.py:54 ParallelEnv,
    launch.py:105 PADDLE_TRAINER_ID/PADDLE_TRAINERS_NUM), as in the JAX
    package, plus the rendezvous the launcher sets."""

    def __init__(self):
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._endpoints = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        self._init_method = os.environ.get(INIT_METHOD_ENV, "")

    @property
    def rank(self):
        return self._rank

    @property
    def local_rank(self):
        return self._rank

    @property
    def nranks(self):
        return self._world_size

    @property
    def world_size(self):
        return self._world_size

    @property
    def trainer_endpoints(self):
        return self._endpoints

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def init_method(self):
        """The launcher's rendezvous (a ``file://`` path in a temp dir),
        else ``tcp://`` at the first trainer endpoint."""
        if self._init_method:
            return self._init_method
        if self._endpoints and self._endpoints[0]:
            return f"tcp://{self._endpoints[0]}"
        return ""

    @property
    def dev_id(self):
        """The card this rank runs on: its own when there are enough,
        else card 0, shared by every rank."""
        if default_backend(self._world_size) == "nccl":
            return self.local_rank % torch.cuda.device_count()
        return 0


def default_backend(world_size):
    """NCCL when each of ``world_size`` ranks can have a card of its own,
    else gloo (ranks share a card, or there is none)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


class Axis:
    """One mesh axis: its name, size, this process's index along it, the
    process group of this rank's slice along it (None for a size-1 axis)
    and the world ranks of that slice, in axis order (``ranks``; the
    peers of ``send``/``recv``)."""

    def __init__(self, name, size, rank, group=None, backend=None,
                 ranks=None):
        self.name = name
        self.size = int(size)
        self.rank = int(rank)
        self.group = group
        self.backend = backend
        self.ranks = tuple(ranks) if ranks is not None else tuple(
            range(self.size))

    def __repr__(self):
        return (f"Axis({self.name!r}, size={self.size}, rank={self.rank}, "
                f"backend={self.backend!r})")


class Mesh:
    """Named axes over the ranks of a process group, laid out row-major
    (rank ``((i0 * n1) + i1) * n2 + i2`` sits at ``(i0, i1, i2)``), as the
    JAX package's ``make_mesh`` lays out devices. ``axis(name)`` is this
    rank's ``Axis`` along ``name``."""

    def __init__(self, *axes, rank=None):
        if not axes:
            raise ValueError("a mesh needs at least one axis")
        self._axes = {a.name: a for a in axes}
        if len(self._axes) != len(axes):
            raise ValueError(f"mesh axis names repeat: "
                             f"{[a.name for a in axes]}")
        self.axis_names = tuple(a.name for a in axes)
        self.shape = tuple(a.size for a in axes)
        if rank is None:
            rank = 0
            for a in axes:
                rank = rank * a.size + a.rank
        self._rank = int(rank)

    def axis(self, name):
        try:
            return self._axes[name]
        except KeyError:
            raise KeyError(f"mesh has no axis {name!r} (axes "
                           f"{self.axis_names})") from None

    def size(self, name, default=1):
        """The size of axis ``name``, ``default`` when the mesh has none."""
        a = self._axes.get(name)
        return a.size if a is not None else default

    @property
    def coords(self):
        """``{axis name: this rank's index along it}``."""
        return {n: a.rank for n, a in self._axes.items()}

    @property
    def rank(self):
        return self._rank

    @property
    def backend(self):
        return next((a.backend for a in self._axes.values() if a.backend),
                    None)

    def __repr__(self):
        return f"Mesh({', '.join(repr(a) for a in self._axes.values())})"


# process groups of the axis slices, by (mesh shape, axis names): every
# rank creates every group once, in one order, as torch.distributed needs
_groups = {}


def _slice_ranks(shape, i, coords):
    """The world ranks along axis ``i`` through ``coords``, row-major."""
    out = []
    for j in range(shape[i]):
        c = list(coords)
        c[i] = j
        r = 0
        for n, k in zip(shape, c):
            r = r * n + k
        out.append(r)
    return out


def _axis_groups(shape, names):
    """``{axis name: {slice ranks: group}}`` of every slice of every axis
    of size > 1, made on every rank in the same order."""
    key = (tuple(shape), tuple(names))
    groups = _groups.get(key)
    if groups is None:
        groups = {}
        for i, name in enumerate(names):
            if shape[i] == 1:
                continue
            others = [range(n) if k != i else range(1)
                      for k, n in enumerate(shape)]
            made = {}
            for coords in itertools.product(*others):
                ranks = tuple(_slice_ranks(shape, i, coords))
                made[ranks] = dist.new_group(list(ranks))
            groups[name] = made
        _groups[key] = groups
    return groups


def make_mesh(shape=None, axis_names=None, backend=None, init_method=None):
    """A mesh over this process's ranks (``ParallelEnv``): ``shape=None`` is
    a 1-D ``"data"`` axis over every rank, else ``shape`` names one size
    per axis of ``axis_names`` and their product is the world size. Joins
    the process group on first use, with ``backend`` (default
    ``default_backend``) and the launcher's rendezvous, and makes one
    subgroup per slice of each axis of more than one rank. A world of one
    needs no process group."""
    env = ParallelEnv()
    world = env.world_size
    if shape is None:
        shape = (world,)
        axis_names = axis_names or ("data",)
    shape = tuple(int(n) for n in shape)
    names = tuple(axis_names or ("data",))
    if len(names) != len(shape):
        raise ValueError(f"mesh shape {shape} has {len(shape)} axes, names "
                         f"{names} {len(names)}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} != world size {world}")
    if world == 1:
        return Mesh(*[Axis(n, 1, 0) for n in names])
    if not dist.is_initialized():
        backend = backend or default_backend(world)
        method = init_method or env.init_method
        if not method:
            raise RuntimeError(
                "no rendezvous for the process group: run under "
                "paddle_tpu_torch.distributed.launch, or set "
                f"{INIT_METHOD_ENV}")
        if backend == "nccl":
            # NCCL binds each rank to its own card (give the executor
            # CUDAPlace(ParallelEnv().dev_id) too)
            torch.cuda.set_device(env.dev_id)
        dist.init_process_group(backend, init_method=method, rank=env.rank,
                                world_size=world)
    elif dist.get_world_size() != world:
        raise RuntimeError(f"process group of {dist.get_world_size()} ranks, "
                           f"env says {world}")
    rank, be = dist.get_rank(), dist.get_backend()
    if len(shape) == 1:
        return Mesh(Axis(names[0], world, rank, group=dist.group.WORLD,
                         backend=be))
    coords = np.unravel_index(rank, shape)
    groups = _axis_groups(shape, names)
    axes = []
    for i, name in enumerate(names):
        ranks = tuple(_slice_ranks(shape, i, coords))
        axes.append(Axis(name, shape[i], int(coords[i]),
                         group=groups[name][ranks] if shape[i] > 1 else None,
                         backend=be, ranks=ranks))
    return Mesh(*axes, rank=rank)


# -- the mesh of the run ------------------------------------------------------
_mesh_ctx = threading.local()


@contextlib.contextmanager
def mesh_context(mesh):
    """Installed by ``CompiledProgram`` around a run over ``mesh``: op
    lowerings that work along its axes (``pipeline_stack``) find it, as
    the JAX package's ``mesh_context`` installs the mesh a program is
    compiled against."""
    old = getattr(_mesh_ctx, "mesh", None)
    _mesh_ctx.mesh = mesh
    try:
        yield
    finally:
        _mesh_ctx.mesh = old


def current_mesh():
    return getattr(_mesh_ctx, "mesh", None)


# -- DGC context ------------------------------------------------------------
_dgc = threading.local()


@contextlib.contextmanager
def dgc_axis_context(axis, step=None):
    """Installed by ``CompiledProgram`` around a data-parallel DGC run: the
    ``dgc_momentum`` lowering exchanges (index, value) pairs over ``axis``
    (an ``Axis``; None keeps the dense fused form), and takes the phase of
    its warm-up ramp from ``step``, this run's step counter read once on
    the host (None: the lowering reads it itself, or needs it not)."""
    old = getattr(_dgc, "state", (None, None))
    _dgc.state = (axis, step)
    try:
        yield
    finally:
        _dgc.state = old


def current_dgc_axis():
    return getattr(_dgc, "state", (None, None))[0]


def current_dgc_step():
    return getattr(_dgc, "state", (None, None))[1]


# -- dense data-parallel context and c_* ring bindings ------------------------
_ctx = threading.local()


@contextlib.contextmanager
def data_axis_context(axis):
    """Installed by ``CompiledProgram`` around a dense data-parallel run:
    the batch reductions that its plan marks (``mean``, ``reduce_sum`` of
    this rank's rows) all-reduce over ``axis``."""
    old = getattr(_ctx, "data_axis", None)
    _ctx.data_axis = axis
    try:
        yield
    finally:
        _ctx.data_axis = old


def current_data_axis():
    return getattr(_ctx, "data_axis", None)


@contextlib.contextmanager
def collective_context(bindings):
    """``bindings``: ``{ring_id: Axis}``, the rings the ``c_*`` ops run
    over (the JAX package's ``collective_context``, which binds a ring to
    a mesh axis name). Outside one, a ``c_*`` op is an identity."""
    old = getattr(_ctx, "rings", {})
    _ctx.rings = dict(bindings)
    try:
        yield
    finally:
        _ctx.rings = old


def current_mesh_axis(ring_id=0):
    """The ``Axis`` bound to ``ring_id``, or None."""
    return getattr(_ctx, "rings", {}).get(ring_id)


# -- collectives ------------------------------------------------------------
_stats_lock = threading.Lock()
_stats = {}
_axis_stats = {}
_times = {}


def _count(kind, tensor, axis=None, seconds=0.0):
    n = tensor.numel() * tensor.element_size()
    with _stats_lock:
        calls, sent = _stats.get(kind, (0, 0))
        _stats[kind] = (calls + 1, sent + n)
        if axis is not None:
            calls, sent, s = _axis_stats.get((kind, axis.name), (0, 0, 0.0))
            _axis_stats[(kind, axis.name)] = (calls + 1, sent + n,
                                              s + seconds)


def _time(kind, d2h, wire, h2d):
    with _stats_lock:
        old = _times.get(kind, (0.0, 0.0, 0.0))
        _times[kind] = (old[0] + d2h, old[1] + wire, old[2] + h2d)


def collective_stats(by_axis=False):
    """``{kind: (calls, bytes this rank sent)}`` since the last reset; with
    ``by_axis``, ``{(kind, axis name): (calls, bytes, host seconds)}``, the
    seconds from the copy to the host to the copy back on the host clock
    (a receive's bytes are the bytes it took in)."""
    with _stats_lock:
        return dict(_axis_stats) if by_axis else dict(_stats)


def collective_times():
    """``{kind: (seconds copying to the host, in the backend's exchange,
    copying back)}`` of the fused all-reduces since the last reset (host
    clock; the copy to the host starts after a wait for the card, so it
    holds no queued compute)."""
    with _stats_lock:
        return dict(_times)


def reset_collective_stats():
    with _stats_lock:
        _stats.clear()
        _axis_stats.clear()
        _times.clear()


def _transport(x, axis):
    """The buffer the backend moves: gloo takes CUDA tensors through a
    host copy."""
    if axis.backend == "gloo" and x.device.type != "cpu":
        return x.detach().to("cpu", copy=True)
    return x.detach().clone()


def psum(x, axis):
    """Sum of ``x`` over the ranks of ``axis``: every rank gets the same
    bits (the backend reduces each element once and broadcasts it)."""
    return _reduce(x, axis, dist.ReduceOp.SUM, "all_reduce")


def _reduce(x, axis, op, kind):
    if axis.size == 1:
        return x
    t0 = time.perf_counter()
    buf = _transport(x.contiguous(), axis)
    dist.all_reduce(buf, op=op, group=axis.group)
    out = buf.to(x.device)
    _count(kind, buf, axis, time.perf_counter() - t0)
    return out


class _SumIdentityGrad(torch.autograd.Function):
    """``psum`` whose grad is the identity: the cotangent of a sum that
    every rank of the axis holds is the same on every rank, so each
    rank's term takes it whole (the transpose of ``lax.psum`` of a value
    that varies over the axis, under ``shard_map``'s replication types;
    Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, axis):
        return psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _IdentitySumGrad(torch.autograd.Function):
    """The identity whose grad is ``psum``: a value every rank of the axis
    holds, read by ops whose results differ by rank (they read a shard of
    a weight), gets the sum of the ranks' cotangents, as ``shard_map``
    sums the cotangent of an axis-invariant operand (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.axis), None


def psum_diff(x, axis):
    """``psum`` that ``torch.autograd`` passes the cotangent through."""
    if axis.size == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return psum(x, axis)
    return _SumIdentityGrad.apply(x, axis)


def identity_psum_grad(x, axis):
    """``x``, whose grad ``torch.autograd`` sums over ``axis``."""
    if axis.size == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _IdentitySumGrad.apply(x, axis)


def send(x, axis, dst):
    """Start sending ``x`` to index ``dst`` along ``axis``; returns the
    pending work and the buffer it reads, which must live until
    ``work.wait()``."""
    t0 = time.perf_counter()
    buf = _transport(x.contiguous(), axis)
    work = dist.isend(buf, dst=axis.ranks[dst], group=axis.group)
    _count("send", buf, axis, time.perf_counter() - t0)
    return work, buf


def recv(shape, dtype, device, axis, src):
    """A tensor of ``shape`` and ``dtype`` on ``device``, received from
    index ``src`` along ``axis``."""
    t0 = time.perf_counter()
    device = torch.device(device)
    host = axis.backend == "gloo" or device.type == "cpu"
    buf = torch.empty(tuple(shape), dtype=dtype,
                      device="cpu" if host else device)
    dist.recv(buf, src=axis.ranks[src], group=axis.group)
    out = buf.to(device)
    _count("recv", buf, axis, time.perf_counter() - t0)
    return out


def pmax(x, axis):
    """Elementwise max of ``x`` over the ranks of ``axis``."""
    return _reduce(x, axis, dist.ReduceOp.MAX, "all_reduce_max")


def pmin(x, axis):
    """Elementwise min of ``x`` over the ranks of ``axis``."""
    return _reduce(x, axis, dist.ReduceOp.MIN, "all_reduce_min")


def psum_fused(tensors, axis):
    """The sums over ``axis`` of ``tensors``, with one all-reduce per dtype
    of one flat buffer, counted as
    ``all_reduce_fused``; every rank gets the same bits.
    ``collective_times`` records the split of each buffer's host
    seconds."""
    out = list(tensors)
    if axis.size == 1 or not out:
        return out
    by_dtype = {}
    for i, t in enumerate(out):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        parts = [out[i] for i in idx]
        device = parts[0].device
        flat = torch.cat([p.reshape(-1) for p in parts])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        buf = _transport(flat, axis)
        t1 = time.perf_counter()
        dist.all_reduce(buf, group=axis.group)
        t2 = time.perf_counter()
        _count("all_reduce_fused", buf, axis, t2 - t0)
        flat = buf.to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        _time("all_reduce_fused", t1 - t0, t2 - t1, time.perf_counter() - t2)
        at = 0
        for i, p in zip(idx, parts):
            out[i] = flat[at:at + p.numel()].view(p.shape)
            at += p.numel()
    return out


def pmean(x, axis):
    """Mean of ``x`` over the ranks of ``axis`` (``psum / n``)."""
    if axis.size == 1:
        return x
    return psum(x, axis) / axis.size


def all_gather(x, axis):
    """``[n, *x.shape]``: every rank's ``x``, in rank order."""
    if axis.size == 1:
        return x[None]
    t0 = time.perf_counter()
    buf = _transport(x.contiguous(), axis)
    outs = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(outs, buf, group=axis.group)
    out = torch.stack(outs).to(x.device)
    _count("all_gather", buf, axis, time.perf_counter() - t0)
    return out


def all_gather_rows(x, axis):
    """Every rank's ``x`` concatenated on dim 0, in rank order: the global
    value of a var that holds this rank's rows of the batch."""
    if axis.size == 1:
        return x
    g = all_gather(x, axis)
    return g.reshape((g.shape[0] * g.shape[1],) + tuple(g.shape[2:]))


def broadcast(x, axis, src=0):
    """The ``x`` of index ``src`` along ``axis`` on every rank of it (a new
    tensor on ``x``'s device)."""
    if axis.size == 1:
        return x
    t0 = time.perf_counter()
    buf = _transport(x.contiguous(), axis)
    dist.broadcast(buf, src=axis.ranks[src], group=axis.group)
    out = buf.to(x.device)
    if axis.rank == src:
        _count("broadcast", buf, axis, time.perf_counter() - t0)
    return out


def broadcast_(tensors, axis, src=0):
    """Overwrite each of ``tensors`` in place with rank ``src``'s, one
    broadcast per dtype of one flat buffer."""
    if axis.size == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for parts in by_dtype.values():
        flat = broadcast(torch.cat([p.reshape(-1) for p in parts]), axis, src)
        at = 0
        for p in parts:
            p.copy_(flat[at:at + p.numel()].view(p.shape))
            at += p.numel()


def all_gather_pairs(idx, vals, axis):
    """All-gather an int32 index and a float32 value vector of one length
    as one buffer (the value bits ride as int32, untouched): ``([n, k]
    int32, [n, k] float32)`` in rank order. 2 * k * n values on the
    wire."""
    if idx.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"want int32 indices and float32 values, got "
                        f"{idx.dtype} and {vals.dtype}")
    both = all_gather(torch.stack([idx, vals.view(torch.int32)]), axis)
    return both[:, 0], both[:, 1].contiguous().view(torch.float32)
