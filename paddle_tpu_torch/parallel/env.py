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
over; ``collective_stats`` counts each collective's calls and the bytes
this rank sent, so a test can see what went on the wire.
"""

import contextlib
import os
import threading

import torch
import torch.distributed as dist

__all__ = ["Axis", "Mesh", "make_mesh", "ParallelEnv", "default_backend",
           "dgc_axis_context", "current_dgc_axis", "current_dgc_step",
           "psum", "pmean", "all_gather", "all_gather_pairs",
           "collective_stats", "reset_collective_stats"]

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


# -- collectives ------------------------------------------------------------
_stats_lock = threading.Lock()
_stats = {}


def _count(kind, tensor):
    with _stats_lock:
        calls, sent = _stats.get(kind, (0, 0))
        _stats[kind] = (calls + 1, sent + tensor.numel() * tensor.element_size())


def collective_stats():
    """``{kind: (calls, bytes this rank sent)}`` since the last reset."""
    with _stats_lock:
        return dict(_stats)


def reset_collective_stats():
    with _stats_lock:
        _stats.clear()


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
