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
slot feeds) stays on the host, and so does a feed that the host reads
(``host_read_feeds``: the ids of the program's sharded, PS and remote
tables; the remote lookup's lowering pulls their rows on the host), as a
CPU tensor.

``train_from_dataset`` / ``infer_from_dataset`` are the JAX executor's
dataset mode (``paddle_tpu/core/executor.py``): the trainer and device
worker come from the program's ``_fleet_opt`` (``device_worker.py``), the
batches come through a ``DevicePrefetcher`` that keeps the host-read
feeds on the host (the JAX package skips its prefetcher for PS programs
instead), a program with remote tables is driven one batch ahead so the
next batch's rows are prefetched behind the current step's pushes, and a
``fetch_handler`` with ``background=True`` delivers from a
``FetchHandlerMonitor`` thread.

``while`` and ``conditional_block`` (``CONTROL_FLOW_OPS``) run their
sub-blocks' plans through ``ops/control_flow.py``, as the JAX executor
dispatches them (``paddle_tpu/core/executor.py`` ``CONTROL_FLOW_OPS``):
a ``while`` reads its condition on the host once an iteration.

Remat (``RecomputeOptimizer``): in a program with
``recompute_segment_grad`` ops, the plan drops each segment's interior
values after their last forward reader (``segment_liveness``), keeping
those the segment's policy names (``kernels/remat.py``), which the grad
op receives as ``ins["__saved__"]`` and which are dropped after it. A
fetched value, a persistable and a value a sub-block reads are never
dropped. The grad op replays the segment (``ops/recompute.py``) with the
run key as ``ins["__base_rng__"]`` (``needs_base_rng``). A program
without segments keeps every value to the end of the run, as before.

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

import time

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.backward import _OP_ROLE_OPTIMIZE, resolve_op_def
from paddle_tpu_torch.core.ir import default_main_program
from paddle_tpu_torch.core.places import default_place
from paddle_tpu_torch.core.registry import OpDef
from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.kernels import registry as kernel_registry
from paddle_tpu_torch.ops import control_flow
from paddle_tpu_torch.passes import (
    apply_deferred_sharded_embedding_rewrite, apply_deferred_sparse_rewrite)
from paddle_tpu_torch.utils.enforce import EnforceError

# pseudo-ops that the executor elides (feed/fetch are direct env access here)
ELIDED_OPS = {"feed", "fetch"}
# op types run structurally over their sub-blocks (ops/control_flow.py)
CONTROL_FLOW_OPS = control_flow.CONTROL_FLOW_OPS


def _structural(ins, attrs):
    raise EnforceError("a control-flow op runs through the executor, "
                       "which runs its sub-blocks")


class _OpStep:
    """One op's pre-resolved execution plan: op-def lookup, attrs (with
    the in-place mark applied), the non-empty input/output slots, the id
    its random key is folded from and, for a random op on a dense
    data-parallel rank's rows, the block of the global draw it takes
    (``rng_block``, passed as ``ins["__rng_block__"]``)."""

    __slots__ = ("op", "op_def", "attrs", "inputs", "outputs", "rng_id",
                 "rng_block", "control_flow")

    def __init__(self, op, op_def, attrs, inputs, outputs, rng_id):
        self.op = op
        self.op_def = op_def
        self.attrs = attrs
        self.inputs = inputs
        self.outputs = outputs
        self.rng_id = rng_id
        self.rng_block = None
        self.control_flow = op.type in CONTROL_FLOW_OPS


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
    # outputs whose op's grad op reads them (a saves_for_grad op keeps
    # what its grad needs only then)
    grad_read = {n for op in ops if op.type.endswith("_grad")
                 for n in op.input("Out")}
    plan = []
    for i, (op_index, op) in enumerate(indexed):
        attrs = op.attrs
        if op.type == "scatter" and _inplace_scatter(ops, i, block):
            attrs = dict(attrs, _inplace=True)
        if op.type.endswith("_grad"):
            # the generic grad lowering differentiates only what the op emits
            attrs = dict(attrs, __grad_outputs__=[
                slot for slot, names in op.outputs.items() if names])
        op_def = (OpDef(op.type, _structural) if op.type in CONTROL_FLOW_OPS
                  else resolve_op_def(op.type))
        if op_def.saves_for_grad and grad_read & set(op.output("Out")):
            attrs = dict(attrs, _save_for_grad=True)
        plan.append(_OpStep(
            op, op_def, attrs,
            [(slot, names) for slot, names in op.inputs.items() if names],
            list(op.outputs.items()),
            op.attrs.get("__rng_id__", op_index),
        ))
    return plan


def segment_liveness(block, steps, persistable):
    """``{id(op): (drop, saved)}`` for the steps of a plan of ``block``
    with recompute segments, else ``{}``: ``drop`` names the segment
    interiors that go from the env after that step (their last reader or
    writer; for a kept value, its segment's grad op), ``saved`` a grad
    op's kept values. Persistables and values read inside a sub-block
    stay."""
    from paddle_tpu_torch.kernels import remat

    grads = [i for i, s in enumerate(steps)
             if s.op.type == "recompute_segment_grad"]
    if not grads:
        return {}
    hold = set(persistable) | {
        n for b in block.program.blocks if b is not block
        for op in b.ops for n in op.input_names()}
    last = {}
    for i, s in enumerate(steps):
        for _, names in list(s.inputs) + list(s.outputs):
            for n in names:
                last[n] = i
    drops, saved = {}, {}
    for gi in grads:
        attrs = steps[gi].op.attrs
        kept = remat.kept_names(attrs)
        saved[gi] = tuple(kept)
        kept = set(kept)
        for n in attrs["__segment_saved_names__"]["save_all"]:
            if n in hold or n not in last:
                continue
            at = max(last[n], gi) if n in kept else last[n]
            drops.setdefault(at, []).append(n)
    return {id(s.op): (tuple(drops.get(i, ())), saved.get(i, ()))
            for i, s in enumerate(steps) if i in drops or i in saved}


def host_read_feeds(program):
    """The feeds of ``program`` that the host reads: the raw ids of its
    sharded-engine, PS and remote tables (``_sharded_tables``,
    ``_sparse_tables``, ``_remote_tables``). The DataLoader, the
    prefetcher of ``train_from_dataset`` and ``Executor.run`` keep them on
    the host; every other feed goes to the card."""
    prog = getattr(program, "program", program)  # unwrap CompiledProgram
    return {t["ids"]
            for reg in ("_sharded_tables", "_sparse_tables", "_remote_tables")
            for t in (getattr(prog, reg, None) or {}).values()}


def _to_numpy(t):
    """A fetch as a numpy array. numpy has no bfloat16, so a bfloat16
    fetch comes back as float32, an exact widening (the JAX package
    returns ``ml_dtypes.bfloat16`` arrays)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _Runner:
    """What a ``needs_block`` op runs its sub-blocks with: the executor's
    plan of a block and its step loop over an env, reading the run's
    scope for names the env lacks."""

    __slots__ = ("exe", "scope")

    def __init__(self, exe, scope):
        self.exe = exe
        self.scope = scope

    def plan(self, block):
        return self.exe._sub_plan(block)

    def run(self, steps, env, key, block):
        self.exe._run_steps(steps, env, self.scope, block, key)


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
            # a feed read only inside a sub-block is read too
            read = {n for b in program.blocks for op in b.ops
                    for n in op.input_names()}
            steps = block_plan(block)
            plan = (steps, persistable, read,
                    segment_liveness(block, steps, persistable))
            self._plans[key] = plan
        return plan

    def _next_rng_key(self, program):
        """The next run's key (the JAX executor's ``_next_rng_key``)."""
        self._rng_counter += 1
        return prng.fold_in(prng.prng_key(program.random_seed or 0),
                            self._rng_counter)

    def _to_device(self, value, var, device=None):
        device = self.device if device is None else device
        if isinstance(value, torch.Tensor):
            return value.to(device)
        arr = np.asarray(value)
        if var is not None and var.dtype is not None:
            arr = arr.astype(var.dtype, copy=False)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

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

    def _sub_plan(self, block):
        """A sub-block's plan, cached beside the program's."""
        prog = block.program
        key = (prog._uid, prog._version, block.idx)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = block_plan(block)
        return plan

    def _control_flow(self, step, env, scope, block, run_key):
        def run_block(sub, local, key):
            self._run_steps(self._sub_plan(sub), local, scope, sub, key)

        def value(name, local):
            v = local.get(name)
            if v is None and scope._find_owner(name) is not None:
                v = local[name] = self._from_scope(scope, name, block)
            return v

        try:
            control_flow.run_control_flow_op(step.op, block, env, run_key,
                                             run_block, value)
        except EnforceError:
            raise
        except Exception as e:
            raise EnforceError(
                f"lowering failed: {e}", op_type=step.op.type,
                op_callstack=step.op.attrs.get("op_callstack")) from e

    def _run_steps(self, steps, env, scope, block, run_key, live=None,
                   keep=()):
        """Run ``steps`` over ``env``. ``live`` (``segment_liveness``)
        drops segment interiors after their last reader and hands the kept
        ones to their grad op; names in ``keep`` (the fetches) stay."""
        for step in steps:
            if step.control_flow:
                self._control_flow(step, env, scope, block, run_key)
                continue
            entry = live.get(id(step.op)) if live else None
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
            if step.op_def.needs_base_rng:
                ins["__base_rng__"] = [run_key]
            if entry is not None and entry[1]:
                ins["__saved__"] = [{n: env[n] for n in entry[1] if n in env}]
            if step.op_def.creates:
                ins["__device__"] = [self.device]
            if step.op_def.needs_block:
                ins["__block__"] = [block]
                ins["__runner__"] = [_Runner(self, scope)]
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
            if entry is not None:
                for n in entry[0]:
                    if n not in keep:
                        env.pop(n, None)

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
        steps, persistable, read, live = self._plan(program)
        if _rewrite_plan is not None:
            steps = _rewrite_plan(steps)
        late = kernel_registry.late_launches()
        host = host_read_feeds(program)
        cpu = torch.device("cpu")
        env = {
            name: self._to_device(value, block.vars.get(name),
                                  cpu if name in host else None)
            for name, value in feed.items()
            if name in read or name in fetch_names
        }
        with torch.no_grad():
            self._run_steps(steps, env, scope, block, run_key, live,
                            set(fetch_names))
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

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None, is_infer=False):
        """Dataset-mode training loop (reference: python/paddle/fluid/
        executor.py:1124 train_from_dataset -> C++ Executor::RunFromDataset
        with thread-per-core DeviceWorkers), as the JAX executor runs it:
        the per-batch driver comes from the program's `_fleet_opt` via
        TrainerFactory (device_worker.py): Hogwild = plain step,
        DownpourSGD = the PS pull/step/push loop; its run configuration
        (fetch/debug/infer) travels on the TrainerDesc. Returns the last
        batch's fetches."""
        from paddle_tpu_torch.dataio.prefetch import DevicePrefetcher
        from paddle_tpu_torch.device_worker import TrainerFactory
        from paddle_tpu_torch.utils.enforce import enforce

        enforce(dataset is not None, "dataset is required")
        prog_obj = getattr(program, "program", program)
        if is_infer:
            # evaluation must not update state: a program still carrying
            # optimizer ops (or in-step grad pushes) would train on the
            # eval data — demand the test clone, like the reference's
            # infer-trainer contract
            bad = [
                op.type
                for op in prog_obj.global_block().ops
                if op.attrs.get("op_role", 0) == _OP_ROLE_OPTIMIZE
                or op.type == "distributed_push_sparse"
            ]
            enforce(
                not bad,
                "infer_from_dataset got a TRAINING program (contains "
                f"{sorted(set(bad))[:3]}...): pass the "
                "clone(for_test=True) inference program instead",
            )
        trainer = TrainerFactory()._create_trainer(
            getattr(prog_obj, "_fleet_opt", None)
        )
        trainer._set_thread(thread)
        trainer._set_debug(debug)
        trainer._set_infer(is_infer)
        trainer._set_fetch_var_and_info(fetch_list, fetch_info, print_period)
        trainer._set_program(prog_obj)
        worker = trainer._device_worker
        worker.prepare(self, prog_obj, scope)

        fetch_list = trainer._fetch_vars
        fetch_info = trainer._fetch_info or [str(f) for f in fetch_list]
        print_period = trainer._print_period
        debug = trainer._debug
        step = 0
        last = None
        last_handled = time.monotonic()
        # background=True on the FetchHandler moves delivery off the
        # training loop onto a period-driven monitor thread (reference:
        # FetchHandlerMonitor) — a long epoch reports on schedule even
        # when single steps are slow
        monitor = None
        if fetch_list and fetch_handler is not None and getattr(
                fetch_handler, "background", False):
            from paddle_tpu_torch.observability.fetcher import (
                FetchHandlerMonitor)

            monitor = FetchHandlerMonitor(fetch_handler).start()
        # lookahead iteration ONLY for programs with remote tables: the
        # NEXT batch's ids are announced before the current step runs, so
        # the PS pull overlaps the step — the dataset-mode analog of the
        # reference's prefetch thread (reference: paddle/fluid/operators/
        # distributed/parameter_prefetch.cc). Other programs keep strict
        # one-batch-at-a-time iteration.
        lookahead = bool(getattr(prog_obj, "_remote_tables", None))
        # the copy of batch N+1 overlaps step N (buffered_reader.cc); the
        # ids the host reads stay on the host, cast to their vars' types
        block = prog_obj.global_block()
        specs = {n: (v.dtype, v.shape) for n, v in block.vars.items()
                 if v.is_data}
        it = iter(DevicePrefetcher(
            dataset._iter_batches(), depth=2, device=self.device,
            host_keys=host_read_feeds(prog_obj), specs=specs,
            name="train_from_dataset"))
        feed = next(it, None)
        nxt = None
        try:
            while feed is not None:
                if lookahead:
                    nxt = next(it, None)
                    if nxt is not None:
                        from paddle_tpu_torch.distributed import lookup

                        lookup.prefetch_for_program(prog_obj, nxt)
                out = worker.run_batch(
                    self, program, feed, fetch_list=fetch_list, scope=scope
                )
                last = out
                if fetch_list and fetch_handler is not None:
                    names = [f if isinstance(f, str) else f.name
                             for f in fetch_list]
                    if monitor is not None:
                        # the monitor owns the cadence; the loop only
                        # publishes the newest values (one dict swap)
                        monitor.update(dict(zip(names, out)))
                    else:
                        # in-loop cadence with a step fallback so short
                        # runs still observe fetches
                        now = time.monotonic()
                        if (now - last_handled >= fetch_handler.period_secs
                                or step % print_period == 0):
                            fetch_handler.handler(dict(zip(names, out)))
                            last_handled = now
                elif fetch_list and (debug or step % print_period == 0):
                    msgs = [
                        f"{info}={np.asarray(v).reshape(-1)[:1][0]:.6f}"
                        for info, v in zip(fetch_info, out)
                    ]
                    print(f"step {step}: " + ", ".join(msgs))
                step += 1
                feed = nxt if lookahead else next(it, None)
        finally:
            # a mid-epoch raise must not leak the monitor's daemon thread;
            # the final tick delivers the last published fetch either way
            if monitor is not None:
                monitor.stop()
        worker.finish()
        return last

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None):
        return self.train_from_dataset(
            program, dataset, scope, thread, debug, fetch_list, fetch_info,
            print_period, fetch_handler, is_infer=True,
        )

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
