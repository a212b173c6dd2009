"""CompiledProgram: data-parallel training over the port's data mesh.

The JAX package's ``CompiledProgram`` (``paddle_tpu/compiler.py``; the
reference's ParallelExecutor, python/paddle/fluid/compiler.py:87,
:160 with_data_parallel) jit-compiles the step over a device mesh. The
port runs it on every rank of a ``torch.distributed`` process group
(``parallel.env.make_mesh``), one process per rank; every rank is fed the
same global batch and takes its own rows, ``[r*B/n, (r+1)*B/n)``, as the
JAX multi-controller path does (dim 0 must divide n). Two forms:

* dense data parallelism, GSPMD's global step (``parallel/
  data_parallel.py``): the block runs on the rank's rows with the
  collectives GSPMD would put in (batch reductions all-reduced, the
  parameter grads summed over the ranks in one fused all-reduce before
  the first optimizer op, random ops on rows drawing the rank's block of
  the global draw); on its first run in a scope every persistable the
  program reads is broadcast from rank 0, so a replicated value is one
  value; fetches come back as the JAX global values (rows all-gathered
  on dim 0). The result is the one-device step on the whole batch, to
  within float rounding, and the ranks' parameters stay bit-equal;
* DGC's sparse exchange, for a program carrying ``DGCMomentumOptimizer``:
  the block runs inside ``dgc_axis_context``, each ``dgc_momentum``
  exchanges top-k (index, value) pairs over the mesh; the DGC
  accumulators U/V are per-rank error-feedback state with a leading axis
  of 1 (expanded from the declared shape on every call, so a fresh scope
  works behind a warm executor); only scalar float fetches are allowed,
  and come back as cross-rank means; the step counter is read once per
  run (none for a statically sparse schedule); a run folds the rank into
  its key (``paddle_tpu/compiler.py``'s ``fold_in(rng_key,
  axis_index)``), so the ranks draw different dropout masks. With
  ``FLAGS_dgc_sparse_exchange=0``, or (with the JAX package's warning)
  over a program with ops whose state comes from the batch or that open
  collectives of their own, a DGC program runs the dense fused form:
  the dense path, then ``dgc_momentum`` with no exchange.

A world of one runs the plain executor, as the JAX package's one-device
mesh does. What is not ported raises ``NotImplementedError`` naming its
ROADMAP item: multi-axis meshes and the placement options (M11), ops on
rows whose effect on the batch is not known, and batch statistics
across ranks (sync batch norm, M11).
"""

import warnings
import weakref

import numpy as np
import torch

from paddle_tpu_torch.core.executor import _to_numpy
from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.ops.optimizers import dgc_statically_sparse
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.parallel.data_parallel import (
    BATCH_STAT_OPS, ROWS, check_program, feed_kind, plan_dense)
from paddle_tpu_torch.passes import (
    apply_deferred_sharded_embedding_rewrite, apply_deferred_sparse_rewrite)
from paddle_tpu_torch.utils.enforce import EnforceError, enforce
from paddle_tpu_torch.utils.flags import flags

__all__ = ["BuildStrategy", "ExecutionStrategy", "CompiledProgram"]

# ops whose lowerings open collectives of their own (the JAX package's
# _opens_shard_map on a 1-D mesh, with the c_* ops)
_OWN_COLLECTIVE_OPS = ("pipeline_stack",)


class BuildStrategy:
    """Accepted for API parity (reference: paddle/fluid/framework/details/
    build_strategy.h:37). The port runs ops eagerly: operator fusion and
    memory reuse are not passes it has, and the dense data-parallel grads
    always go in one all-reduce per dtype, so setting those fields changes
    nothing, and says so once per field and process."""

    _PARITY_ONLY = ("fuse_all_reduce_ops", "fuse_elewise_add_act_ops",
                    "memory_optimize", "enable_inplace")
    _warned = set()

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    def __init__(self):
        d = object.__setattr__
        d(self, "reduce_strategy", BuildStrategy.ReduceStrategy.AllReduce)
        d(self, "fuse_all_reduce_ops", True)
        d(self, "fuse_elewise_add_act_ops", True)
        d(self, "memory_optimize", True)
        d(self, "enable_inplace", True)
        d(self, "num_trainers", 1)
        d(self, "trainer_id", 0)

    def __setattr__(self, name, value):
        if name in self._PARITY_ONLY and name not in BuildStrategy._warned:
            BuildStrategy._warned.add(name)
            warnings.warn(f"BuildStrategy.{name} is a no-op in the eager "
                          "port (set once per process; this message will "
                          "not repeat)", stacklevel=2)
        object.__setattr__(self, name, value)


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP M11)")


class CompiledProgram:
    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._is_data_parallel = False
        self._mesh = None
        self._loss_name = None
        self._dense_plans = {}
        self._synced = weakref.WeakKeyDictionary()
        self._warned = set()

    @property
    def program(self):
        return self._program

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """Data parallelism over every rank of this process's world
        (``make_mesh()``). ``places`` and ``share_vars_from`` are not
        ported: each rank runs on its executor's place."""
        if places is not None or share_vars_from is not None:
            raise _not_ported("with_data_parallel(places=, share_vars_from=)")
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._mesh = penv.make_mesh()
        return self

    def with_parallel(self, mesh=None, loss_name=None, param_rules=None,
                      param_specs=None, input_specs=None, spec_layout=None,
                      axis_tags=None, pipeline_schedule=None,
                      pipeline_interleave=None):
        """Data parallelism over ``mesh`` (default ``make_mesh()``), a 1-D
        ``"data"`` mesh. Parameter and input placement, axis tags and
        pipeline schedules belong to the GSPMD, tensor-parallel and
        pipeline forms, which are not ported (M11)."""
        placement = dict(param_rules=param_rules, param_specs=param_specs,
                         input_specs=input_specs, spec_layout=spec_layout,
                         axis_tags=axis_tags,
                         pipeline_schedule=pipeline_schedule,
                         pipeline_interleave=pipeline_interleave)
        given = sorted(k for k, v in placement.items()
                       if v not in (None, False))
        if given:
            raise _not_ported(f"with_parallel({', '.join(given)}=)")
        self._is_data_parallel = True
        self._loss_name = loss_name
        self._mesh = mesh if mesh is not None else penv.make_mesh()
        if len(self._mesh.axis_names) != 1:
            raise _not_ported("a multi-axis mesh")
        return self

    # ------------------------------------------------------------------
    def _dgc_sparse(self, block, dgc_ops, n):
        """Whether this run takes DGC's sparse exchange: a DGC program on
        more than one rank with ``FLAGS_dgc_sparse_exchange`` on, and no
        op whose state comes from the batch or that opens collectives of
        its own; over such ops the dense fused form runs, with the JAX
        package's warning (once per program version)."""
        if n == 1 or not dgc_ops or not flags.dgc_sparse_exchange:
            return False
        manual = sorted({
            op.type for op in block.ops
            if (op.type in BATCH_STAT_OPS and not op.attrs.get("is_test"))
            or op.type in _OWN_COLLECTIVE_OPS or op.type.startswith("c_")})
        if not manual:
            return True
        key = (self._program._uid, self._program._version)
        if key not in self._warned:
            self._warned.add(key)
            warnings.warn(
                "DGCMomentumOptimizer: sparse exchange needs a pure "
                f"data-parallel mesh without manual-region ops (found "
                f"{manual}); falling back to the dense fused form (no wire "
                "savings)")
        return False

    @staticmethod
    def _check_fetches(block, fetch_names):
        # batch-shaped fetches would be silently averaged across different
        # examples by the cross-rank mean: refuse them on declared shapes
        for n in fetch_names:
            fv = block._find_var_recursive(n)
            shape = tuple(fv.shape or ()) if fv is not None else ()
            static = [d for d in shape if d and d > 0]
            dynamic = any(d in (-1, None) or (d and d < 0) for d in shape)
            non_float = fv is None or (
                fv.dtype is not None and "float" not in str(fv.dtype))
            if dynamic or non_float or int(np.prod(static or [1])) > 1:
                raise EnforceError(
                    f"fetch '{n}' (declared shape {list(shape)}, dtype "
                    f"{getattr(fv, 'dtype', None)}) is not a scalar float: "
                    "DGC sparse-exchange mode runs the block per rank and "
                    "can only fetch scalar float losses/metrics (cross-rank "
                    "means). Fetch those instead")

    @staticmethod
    def _local_feed(feed, axis):
        out = {}
        n, r = axis.size, axis.rank
        for name, value in feed.items():
            shape = tuple(value.shape) if hasattr(value, "shape") \
                else np.shape(value)
            if not isinstance(value, torch.Tensor):
                value = np.asarray(value)
            enforce(
                len(shape) == 0 or shape[0] % n == 0,
                f"feed '{name}' dim 0 ({shape[0] if shape else 1}) must "
                f"divide its sharding ('{axis.name}',) (total {n})")
            if len(shape) == 0 or n == 1:
                out[name] = value
            else:
                b = shape[0] // n
                out[name] = value[r * b:(r + 1) * b]
        return out

    @staticmethod
    def _expand_state(scope, block, names, n):
        """Per-rank U/V: a declared-shape value becomes ``[1, ...]``. Runs
        on every call (shapes only: no copy from the card)."""
        for name in sorted(names):
            if not scope.has_var(name):
                continue
            val = scope.find_var(name)
            cur = tuple(val.shape)
            declared = tuple(block._find_var_recursive(name).shape or ())
            if cur == declared:
                val = val if isinstance(val, torch.Tensor) \
                    else torch.as_tensor(np.asarray(val))
                scope.set(name, val[None].clone())
            elif cur != (1,) + declared:
                raise EnforceError(
                    f"dgc accumulator {name} has shape {cur}, expected "
                    f"{declared} or {(1,) + declared} (one rank of {n})")

    @staticmethod
    def _host_step(scope, dgc_ops, sparse):
        """The step counter of this run, read once (one sync with the
        card); None when a statically sparse schedule needs none, or the
        ops count steps in more than one var (each then reads its own)."""
        if sparse and all(dgc_statically_sparse(
                op.attrs.get("rampup_begin_step", 0.0),
                op.attrs.get("sparsity", [0.999])) for op in dgc_ops):
            return None
        names = {op.input("CurrentStep")[0] for op in dgc_ops}
        if len(names) != 1 or not scope.has_var(next(iter(names))):
            return None
        val = scope.find_var(next(iter(names)))
        return float(np.asarray(val.detach().cpu() if isinstance(
            val, torch.Tensor) else val).reshape(-1)[0])

    def _sync_persistables(self, exe, scope, block, axis):
        """On the first dense run of this program version in ``scope``:
        every persistable the program reads, broadcast from rank 0 (one
        buffer per dtype), so a replicated value means one value, as the
        JAX package's ``_to_global`` makes it."""
        key = (self._program._uid, self._program._version)
        done = self._synced.setdefault(scope, set())
        if key in done:
            return
        names = sorted({
            n for op in block.ops for n in op.input_names()
            if getattr(block._find_var_recursive(n), "persistable", False)
            and scope.has_var(n)})
        penv.broadcast_([exe._from_scope(scope, n, block) for n in names],
                        axis)
        done.add(key)

    def _dense_rewrite(self, block, feed, fetch_names, axis, got):
        """The executor's plan hook of a dense run: the block's plan with
        the collectives in place (``plan_dense``, cached per program
        version and feed signature); the plan used lands in ``got``."""
        kinds = {n: feed_kind(v) for n, v in feed.items()}

        def rewrite(steps):
            key = (id(steps), self._program._uid, self._program._version,
                   tuple(sorted(kinds.items())), tuple(fetch_names),
                   axis.rank)
            plan = self._dense_plans.get(key)
            if plan is None:
                if len(self._dense_plans) >= 64:
                    self._dense_plans.clear()
                plan = self._dense_plans[key] = plan_dense(
                    steps, block, kinds, fetch_names, axis.rank)
            got.append(plan)
            return plan.steps

        return rewrite

    def _run(self, exe, feed, fetch_list, scope, return_numpy):
        if not self._is_data_parallel:
            return exe.run(self._program, feed, fetch_list, scope,
                           return_numpy)
        feed = feed or {}
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        scope = scope if scope is not None else global_scope()
        program = self._program
        apply_deferred_sparse_rewrite(program)
        apply_deferred_sharded_embedding_rewrite(program)
        block = program.global_block()
        axis = self._mesh.axis(self._mesh.axis_names[0])
        n = axis.size
        dgc_ops = [op for op in block.ops if op.type == "dgc_momentum"]
        sparse = self._dgc_sparse(block, dgc_ops, n)
        local = self._local_feed(feed, axis)
        if sparse:
            self._check_fetches(block, fetch_names)
            self._expand_state(scope, block, {
                name for op in dgc_ops for slot in ("U", "V")
                for name in op.input(slot)}, n)
        step = self._host_step(scope, dgc_ops, sparse) if dgc_ops else None
        if n == 1 or sparse:
            with penv.dgc_axis_context(axis if sparse else None, step):
                fetches = exe.run(program, feed=local,
                                  fetch_list=fetch_names, scope=scope,
                                  return_numpy=False,
                                  _rank=axis.rank if sparse else None)
            if sparse:
                fetches = [penv.pmean(f, axis) if f.is_floating_point()
                           else f for f in fetches]
        else:
            got = []
            check_program(block)
            self._sync_persistables(exe, scope, block, axis)
            with penv.data_axis_context(axis), \
                    penv.dgc_axis_context(None, step):
                fetches = exe.run(
                    program, feed=local, fetch_list=fetch_names,
                    scope=scope, return_numpy=False,
                    _rewrite_plan=self._dense_rewrite(
                        block, local, fetch_names, axis, got))
            plan = got[-1]
            fetches = [penv.all_gather_rows(f, axis)
                       if plan.fetch_kind(name) == ROWS else f
                       for name, f in zip(fetch_names, fetches)]
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches
