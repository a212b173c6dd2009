"""Pipeline parallelism: microbatched stage execution over a mesh axis, the
counterpart of the JAX package's ``parallel/pipeline.py``.

The JAX package runs the GPipe schedule as one ``lax.scan`` inside
``shard_map``: every device runs the same stage body on its shard of the
stacked layer parameters, activations hop to the next stage by
``lax.ppermute``, stage 0 injects a fresh microbatch each tick, and
reverse-mode AD transposes the scan into the backward pipeline. The port
runs one process per rank, so the schedule is the same ticks on
point-to-point ops along the ``stage`` axis (``parallel/env.py``
``send``/``recv``): at tick ``t`` stage ``s`` runs microbatch ``t - s``,
receiving it from stage ``s - 1`` (stage 0 takes microbatch ``t`` of its
input) and sending its result to stage ``s + 1``; ``M + n_stage - 1``
ticks in all, a stage idle in ``n_stage - 1`` of them (the bubble). A
stage runs no body in the ticks the JAX scan spends on padding. The
backward (``pipeline_backward``) is the reverse schedule: the last stage
starts from its outputs' cotangents, each stage sends the cotangent of
its input to the stage before, microbatches in reverse order.
"""

import torch

from paddle_tpu_torch.parallel import env as penv

__all__ = ["SCHEDULE_KINDS", "split_microbatches", "predicted_bubble",
           "pipeline_apply", "pipeline_backward"]

#: the schedule kinds of the JAX package's pipeline runtime; the port runs
#: ``"gpipe"`` (``"1f1b"`` is ROADMAP M11's pipeline runtime)
SCHEDULE_KINDS = ("gpipe", "1f1b")


def split_microbatches(x, num_microbatches):
    """``[B, ...]`` -> the ``M`` views ``[B/M, ...]``."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} does not split into "
                         f"{num_microbatches} microbatches")
    return list(x.reshape((num_microbatches, b // num_microbatches)
                          + tuple(x.shape[1:])).unbind(0))


def predicted_bubble(n_stage, num_microbatches):
    """The idle share of a stage under GPipe: ``(S - 1) / (M + S - 1)``."""
    return (n_stage - 1) / (num_microbatches + n_stage - 1)


def _stage(axis):
    return (axis.size, axis.rank) if axis is not None else (1, 0)


def _wait(pending):
    for work, _buf in pending:
        work.wait()
    pending.clear()


def pipeline_apply(run_stage, x_mb, axis):
    """The forward schedule over ``axis`` (the stage ``Axis``; None or a
    size-1 axis runs the microbatches one after another, the JAX
    package's degenerate path). ``run_stage(h, m)`` runs this stage's
    layers on microbatch ``m``; ``x_mb`` is the list of microbatches
    (only stage 0 reads it). Returns the last stage's ``M`` outputs on
    every stage (the JAX package sums them over ``stage`` with zeros off
    the last stage, bit for bit a broadcast from it)."""
    n, s = _stage(axis)
    like = x_mb[0]
    outs, pending = [None] * len(x_mb), []
    for m in range(len(x_mb)):
        h = x_mb[m] if s == 0 else penv.recv(like.shape, like.dtype,
                                             like.device, axis, s - 1)
        y = run_stage(h, m)
        if s < n - 1:
            pending.append(penv.send(y.detach(), axis, s + 1))
        else:
            outs[m] = y
    _wait(pending)
    if n == 1:
        return outs
    if s == n - 1:
        full = torch.stack([o.detach() for o in outs])
    else:
        full = torch.empty((len(x_mb),) + tuple(like.shape),
                           dtype=like.dtype, device=like.device)
    full = penv.broadcast(full, axis, src=n - 1)
    if s == n - 1:
        return outs
    return list(full.unbind(0))


def pipeline_backward(backward_stage, d_outs, like, axis):
    """The reverse schedule: ``backward_stage(m, dy)`` runs the backward
    of this stage's layers on microbatch ``m`` from the cotangent ``dy``
    of its output and returns the cotangent of its input. The last stage
    starts from ``d_outs[m]``; the cotangents of the stack's input are
    stage 0's, then broadcast over the stage (the input is replicated
    there, and its cotangent is the sum over stages, zero off stage 0).
    ``like`` is one microbatch (shape, dtype, device)."""
    n, s = _stage(axis)
    dxs, pending = [None] * len(d_outs), []
    for m in reversed(range(len(d_outs))):
        dy = d_outs[m] if s == n - 1 else penv.recv(
            like.shape, like.dtype, like.device, axis, s + 1)
        dx = backward_stage(m, dy)
        if s > 0:
            pending.append(penv.send(dx, axis, s - 1))
        else:
            dxs[m] = dx
    _wait(pending)
    if n == 1:
        return dxs
    if s == 0:
        full = torch.stack(dxs)
    else:
        full = torch.empty((len(d_outs),) + tuple(like.shape),
                           dtype=like.dtype, device=like.device)
    return list(penv.broadcast(full, axis, src=0).unbind(0))
