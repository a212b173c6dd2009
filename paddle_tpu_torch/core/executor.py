"""Executor: runs a Program eagerly, one op at a time, over a Scope.

The JAX package traces a whole block into one XLA computation and
keeps a per-op interpreter as its debug path
(``paddle_tpu/core/executor.py`` ``_block_plan`` / ``_interpret_block``).
PyTorch runs eagerly, so here the interpreter IS the execution path, the
reference's own design (reference: paddle/fluid/framework/executor.cc:195
Executor::Run — a loop dispatching one kernel per op). Per-op resolution
(op-def lookup, non-empty slots, the in-place plan below) is computed once
per program version and cached on the executor. ``*_grad`` op types
resolve through ``core/backward.py``'s ``resolve_op_def``, which
synthesizes their lowerings. Ops run under ``torch.no_grad()``: a grad
lowering turns autograd on for its own recomputed forward only.

Before planning a program, ``run`` applies the deferred sparse-update
rewrites (``passes.py``), as the JAX executor does before it compiles
one. A feed that no op reads (the raw ids beside a sharded embedding's
slot feeds) stays on the host.

A ``CompiledProgram`` (``compiler.py``) runs through its own ``_run``,
which calls back into ``run`` with this rank's rows of the batch (and,
for dense data parallelism, a plan with the collectives in place).

The random-key stream is the JAX executor's (``paddle_tpu/core/
executor.py`` ``_next_rng_key``, ``_run_op_step``): every run, startup and
eval runs too, increments ``_rng_counter``; the run key is
``fold_in(PRNGKey(program.random_seed or 0), counter)`` (a DGC
data-parallel run folds in its rank next, as the JAX package folds
``axis_index``; a dense one draws its rows' block of the global draw
instead, ``__rng_block__``);
each stateful op gets ``fold_in(run_key, rng_id)`` as
``ins["__rng_key__"]``, ``rng_id`` being the op's ``__rng_id__`` (which
its grad op carries too) or else its index in the block. Keys are pairs of
Python ints (``core/prng.py``): no tensor, no device sync.

Persistables written by the program — the optimizer's ``ParamOut`` /
``Moment*Out`` and the step counter's ``increment``, whose output names
equal their input names — go back to the scope at the end of ``run``.

In-place arenas. The decode and inject programs persist the KV arenas
with ``scatter(arena, rows, new) -> assign(out, output=arena)``. The JAX
package donates the arena buffers so XLA updates them in place
(``paddle_tpu/core/lowering.py`` ``lower_step``). Eagerly, the scatter
would clone the whole ``[R, H]`` arena per K and V per layer per step;
instead the plan marks such a scatter ``_inplace`` when its ``X`` is a
persistable that the same program re-assigns from the scatter's output
and no other op of the program reads or writes ``X``. The scatter then
writes into ``X``'s tensor, and the assign hands back that same tensor.
"""

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.backward import resolve_op_def
from paddle_tpu_torch.core.ir import default_main_program
from paddle_tpu_torch.core.places import default_place
from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.kernels import registry as kernel_registry
from paddle_tpu_torch.passes import (
    apply_deferred_sharded_embedding_rewrite, apply_deferred_sparse_rewrite)
from paddle_tpu_torch.utils.enforce import EnforceError

# pseudo-ops that the executor elides (feed/fetch are direct env access here)
ELIDED_OPS = {"feed", "fetch"}


class _OpStep:
    """One op's pre-resolved execution plan: op-def lookup, attrs (with
    the in-place mark applied), the non-empty input/output slots, the id
    its random key is folded from and, for a random op on a dense
    data-parallel rank's rows, the block of the global draw it takes
    (``rng_block``, passed as ``ins["__rng_block__"]``)."""

    __slots__ = ("op", "op_def", "attrs", "inputs", "outputs", "rng_id",
                 "rng_block")

    def __init__(self, op, op_def, attrs, inputs, outputs, rng_id):
        self.op = op
        self.op_def = op_def
        self.attrs = attrs
        self.inputs = inputs
        self.outputs = outputs
        self.rng_id = rng_id
        self.rng_block = None


def _inplace_scatter(ops, i, block):
    """Whether ``ops[i]`` (a scatter) may write into its ``X``: ``X`` is a
    persistable, a later ``assign`` copies the scatter's ``Out`` back into
    ``X``, and no other op of the program reads or writes ``X`` — so no
    reader can see the old value change under it."""
    op = ops[i]
    x, out = op.input("X"), op.output("Out")
    if len(x) != 1 or len(out) != 1:
        return False
    var = block._find_var_recursive(x[0])
    if var is None or not var.persistable:
        return False
    persisted = False
    for j, other in enumerate(ops):
        if j == i:
            continue
        if (j > i and not persisted and other.type == "assign"
                and other.input("X") == out and other.output("Out") == x):
            persisted = True
            continue
        if x[0] in other.input_names() or x[0] in other.output_names():
            return False
    return persisted


def block_plan(block):
    """The per-op plan of ``block`` (uncached; ``Executor`` caches it per
    program version)."""
    indexed = [(i, op) for i, op in enumerate(block.ops)
               if op.type not in ELIDED_OPS]
    ops = [op for _, op in indexed]
    plan = []
    for i, (op_index, op) in enumerate(indexed):
        attrs = op.attrs
        if op.type == "scatter" and _inplace_scatter(ops, i, block):
            attrs = dict(attrs, _inplace=True)
        if op.type.endswith("_grad"):
            # the generic grad lowering differentiates only what the op emits
            attrs = dict(attrs, __grad_outputs__=[
                slot for slot, names in op.outputs.items() if names])
        plan.append(_OpStep(
            op, resolve_op_def(op.type), attrs,
            [(slot, names) for slot, names in op.inputs.items() if names],
            list(op.outputs.items()),
            op.attrs.get("__rng_id__", op_index),
        ))
    return plan


def _to_numpy(t):
    """A fetch as a numpy array. numpy has no bfloat16, so a bfloat16
    fetch comes back as float32, an exact widening (the JAX package
    returns ``ml_dtypes.bfloat16`` arrays)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Executor:
    """Feeds a Program, runs it and returns its fetches (reference:
    python/paddle/fluid/executor.py:432).

    ``place`` defaults to ``CUDAPlace(0)`` and raises when there is no
    card; pass ``CPUPlace()`` to run on the CPU. Random ops draw from the
    run's key: ``program.random_seed`` and this executor's run counter."""

    def __init__(self, place=None):
        self.place = default_place(place)
        self.device = self.place.device
        self._rng_counter = 0
        self._plans = {}

    def _plan(self, program):
        key = (program._uid, program._version)
        plan = self._plans.get(key)
        if plan is None:
            if len(self._plans) >= 64:
                self._plans.clear()
            block = program.global_block()
            persistable = [
                v.name for v in block.vars.values() if v.persistable
            ]
            read = {n for op in block.ops for n in op.input_names()}
            plan = (block_plan(block), persistable, read)
            self._plans[key] = plan
        return plan

    def _next_rng_key(self, program):
        """The next run's key (the JAX executor's ``_next_rng_key``)."""
        self._rng_counter += 1
        return prng.fold_in(prng.prng_key(program.random_seed or 0),
                            self._rng_counter)

    def _to_device(self, value, var):
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        arr = np.asarray(value)
        if var is not None and var.dtype is not None:
            arr = arr.astype(var.dtype, copy=False)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _from_scope(self, scope, name, block):
        owner = scope._find_owner(name)
        if owner is None:
            raise EnforceError(
                f"variable '{name}' is read by the program but not "
                "initialized in scope (run the startup program first?)"
            )
        v = owner._vars[name]
        if not isinstance(v, torch.Tensor) or v.device != self.device:
            # commit once: later runs find the tensor on the device, and
            # in-place updates land in the scope's own tensor
            v = self._to_device(v, block._find_var_recursive(name))
            owner.set(name, v)
        return v

    def _run_steps(self, steps, env, scope, block, run_key):
        for step in steps:
            ins = {}
            for slot, names in step.inputs:
                vals = []
                for n in names:
                    v = env.get(n)
                    if v is None:
                        v = env[n] = self._from_scope(scope, n, block)
                    vals.append(v)
                ins[slot] = vals
            if step.op_def.stateful:
                ins["__rng_key__"] = [prng.fold_in(run_key, step.rng_id)]
                if step.rng_block is not None:
                    ins["__rng_block__"] = [step.rng_block]
            if step.op_def.creates:
                ins["__device__"] = [self.device]
            try:
                outs = step.op_def.lowering()(ins, step.attrs)
            except EnforceError:
                raise
            except Exception as e:
                raise EnforceError(
                    f"lowering failed: {e}",
                    op_type=step.op.type,
                    op_callstack=step.op.attrs.get("op_callstack"),
                ) from e
            for slot, names in step.outputs:
                vals = outs.get(slot)
                if vals is None:
                    continue
                for name, val in zip(names, vals):
                    if val is not None:
                        env[name] = val

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, _rank=None, _rewrite_plan=None):
        """``_rank`` (``CompiledProgram``'s DGC run) is folded into the
        run key before the per-op fold. ``_rewrite_plan`` (its dense
        data-parallel run) maps the block's plan to the one this run
        executes: the collectives of ``parallel/data_parallel.py`` in
        their places, the grads' all-reduce after the last grad op and
        before the first optimizer op."""
        from paddle_tpu_torch.compiler import CompiledProgram

        if isinstance(program, CompiledProgram):
            return program._run(self, feed, fetch_list, scope, return_numpy)
        program = program if program is not None else default_main_program()
        run_key = self._next_rng_key(program)
        if _rank is not None:
            run_key = prng.fold_in(run_key, _rank)
        apply_deferred_sparse_rewrite(program)
        apply_deferred_sharded_embedding_rewrite(program)
        feed = feed or {}
        fetch_names = [
            f if isinstance(f, str) else f.name for f in (fetch_list or [])
        ]
        scope = scope if scope is not None else global_scope()
        block = program.global_block()
        steps, persistable, read = self._plan(program)
        if _rewrite_plan is not None:
            steps = _rewrite_plan(steps)
        late = kernel_registry.late_launches()
        env = {
            name: self._to_device(value, block.vars.get(name))
            for name, value in feed.items()
            if name in read or name in fetch_names
        }
        with torch.no_grad():
            self._run_steps(steps, env, scope, block, run_key)
        for name in persistable:
            if name in env:
                (scope._find_owner(name) or scope).set(name, env[name])
        fetches = []
        for n in fetch_names:
            if n in env:
                fetches.append(env[n])
            elif scope.has_var(n):
                fetches.append(self._from_scope(scope, n, block))
            else:
                raise EnforceError(
                    f"fetch variable '{n}' is not produced by the program, "
                    "fed, or present in scope"
                )
        if return_numpy:
            fetches = [_to_numpy(f) for f in fetches]
        if kernel_registry.late_launches() != late:
            self._raise_late(steps, synced=return_numpy and bool(fetches))
        return fetches

    def _raise_late(self, steps, synced):
        """A kernel that finds a bad input on the card (K6's id check)
        launched in this run: raise what it found, attributed to the ops
        that report late, as the plain path's eager check is attributed
        to its op. The fetch copy synced with the card; without one, wait
        for the current stream, which ran the launches."""
        if self.device.type == "cuda" and not synced:
            torch.cuda.current_stream(self.device).synchronize()
        try:
            kernel_registry.raise_late(self.device)
        except ValueError as e:
            types = sorted({s.op.type for s in steps if s.op_def.reports_late})
            raise EnforceError(f"lowering failed: {e}",
                               op_type=", ".join(types) or None) from e

    def close(self):
        self._plans.clear()
