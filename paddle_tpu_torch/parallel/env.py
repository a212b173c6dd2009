"""Mesh and collective context of the port: a 1-D ``"data"`` axis over a
``torch.distributed`` process group.

The JAX package's mesh (``paddle_tpu/parallel/env.py``) is a
``jax.sharding.Mesh`` over the devices one controller drives, and its
collectives are ``lax.psum``/``all_gather`` over a named axis inside
``shard_map``. Here one process runs each rank (the torch idiom): the
launcher (``distributed/launch.py``) gives every process its rank, the
world size and a rendezvous, ``make_mesh`` joins the process group, and
``psum``/``pmean``/``all_gather`` are eager collectives over it.

Backend. NCCL when each rank has a card of its own; gloo when ranks share
one card (NCCL refuses two ranks on one device) or run on the CPU. Gloo
moves CUDA tensors through host copies: for the DGC exchange those are the
k-sized (index, value) pairs, not the gradient.

``dgc_axis_context`` installs the axis (and the step of this run, read
once by ``CompiledProgram``) that the ``dgc_momentum`` lowering exchanges
over; ``data_axis_context`` the axis of a dense data-parallel run, over
which the batch reductions it marks all-reduce
(``parallel/data_parallel.py``); ``collective_context`` binds the
``ring_id`` of the ``c_*`` collective ops to an axis
(``layers/collective.py``), as the JAX package's ``collective_context``
binds it to a mesh axis name. ``collective_stats`` counts each
collective's calls and the bytes this rank sent, so a test can see what
went on the wire; ``collective_times`` splits the fused all-reduce's
host seconds into the copy to the host, the backend's exchange and the
copy back.
"""

import contextlib
import os
import threading
import time

import torch
import torch.distributed as dist

__all__ = ["Axis", "Mesh", "make_mesh", "ParallelEnv", "default_backend",
           "dgc_axis_context", "current_dgc_axis", "current_dgc_step",
           "data_axis_context", "current_data_axis", "collective_context",
           "current_mesh_axis", "psum", "psum_fused",
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
    """One mesh axis: its name, size, this process's index along it, and
    the process group (None for a size-1 axis)."""

    def __init__(self, name, size, rank, group=None, backend=None):
        self.name = name
        self.size = int(size)
        self.rank = int(rank)
        self.group = group
        self.backend = backend

    def __repr__(self):
        return (f"Axis({self.name!r}, size={self.size}, rank={self.rank}, "
                f"backend={self.backend!r})")


class Mesh:
    """A 1-D mesh: one named axis over the ranks of a process group."""

    def __init__(self, axis):
        self._axis = axis
        self.axis_names = (axis.name,)
        self.shape = (axis.size,)

    def axis(self, name):
        if name != self._axis.name:
            raise KeyError(f"mesh has no axis {name!r} (axes "
                           f"{self.axis_names})")
        return self._axis

    @property
    def rank(self):
        return self._axis.rank

    @property
    def backend(self):
        return self._axis.backend

    def __repr__(self):
        return f"Mesh({self._axis!r})"


def make_mesh(shape=None, axis_names=None, backend=None, init_method=None):
    """A 1-D ``"data"`` mesh over this process's ranks (``ParallelEnv``):
    joins the process group on first use, with ``backend`` (default
    ``default_backend``) and the launcher's rendezvous. A world of one
    needs no process group. A mesh of more than one axis is not ported
    (ROADMAP M11)."""
    env = ParallelEnv()
    world = env.world_size
    if shape is not None and len(tuple(shape)) != 1:
        raise NotImplementedError(
            f"a {len(tuple(shape))}-D mesh is not ported yet (ROADMAP M11); "
            "the port's mesh is one data axis")
    if shape is not None and int(tuple(shape)[0]) != world:
        raise ValueError(f"mesh shape {tuple(shape)} != world size {world}")
    names = tuple(axis_names or ("data",))
    if len(names) != 1:
        raise NotImplementedError("a multi-axis mesh is not ported yet "
                                  "(ROADMAP M11)")
    if world == 1:
        return Mesh(Axis(names[0], 1, 0))
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
    return Mesh(Axis(names[0], world, dist.get_rank(),
                     group=dist.group.WORLD, backend=dist.get_backend()))


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
_times = {}


def _count(kind, tensor):
    with _stats_lock:
        calls, sent = _stats.get(kind, (0, 0))
        _stats[kind] = (calls + 1, sent + tensor.numel() * tensor.element_size())


def _time(kind, d2h, wire, h2d):
    with _stats_lock:
        old = _times.get(kind, (0.0, 0.0, 0.0))
        _times[kind] = (old[0] + d2h, old[1] + wire, old[2] + h2d)


def collective_stats():
    """``{kind: (calls, bytes this rank sent)}`` since the last reset."""
    with _stats_lock:
        return dict(_stats)


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
    if axis.size == 1:
        return x
    buf = _transport(x.contiguous(), axis)
    _count("all_reduce", buf)
    dist.all_reduce(buf, group=axis.group)
    return buf.to(x.device)


def _reduce(x, axis, op, kind):
    if axis.size == 1:
        return x
    buf = _transport(x.contiguous(), axis)
    _count(kind, buf)
    dist.all_reduce(buf, op=op, group=axis.group)
    return buf.to(x.device)


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
        _count("all_reduce_fused", buf)
        dist.all_reduce(buf, group=axis.group)
        t2 = time.perf_counter()
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
    buf = _transport(x.contiguous(), axis)
    _count("all_gather", buf)
    outs = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(outs, buf, group=axis.group)
    return torch.stack(outs).to(x.device)


def all_gather_rows(x, axis):
    """Every rank's ``x`` concatenated on dim 0, in rank order: the global
    value of a var that holds this rank's rows of the batch."""
    if axis.size == 1:
        return x
    g = all_gather(x, axis)
    return g.reshape((g.shape[0] * g.shape[1],) + tuple(g.shape[2:]))


def broadcast(x, axis, src=0):
    """Rank ``src``'s ``x`` on every rank (a new tensor on ``x``'s
    device)."""
    if axis.size == 1:
        return x
    buf = _transport(x.contiguous(), axis)
    if axis.rank == src:
        _count("broadcast", buf)
    dist.broadcast(buf, src=src, group=axis.group)
    return buf.to(x.device)


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
