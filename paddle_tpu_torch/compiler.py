"""CompiledProgram: parallel training over the port's mesh.

The JAX package's ``CompiledProgram`` (``paddle_tpu/compiler.py``; the
reference's ParallelExecutor, python/paddle/fluid/compiler.py:87,
:160 with_data_parallel) jit-compiles the step over a device mesh. The
port runs it on every rank of a ``torch.distributed`` process group
(``parallel.env.make_mesh``), one process per rank; every rank is fed the
same global batch and takes its own rows along the ``"data"`` axis,
``[r*B/n, (r+1)*B/n)``, as the JAX multi-controller path does (dim 0
must divide n). Three forms:

* dense data parallelism, GSPMD's global step (``parallel/
  data_parallel.py``): the block runs on the rank's rows with the
  collectives GSPMD would put in (batch reductions all-reduced, the
  parameter grads summed over the data axis in one fused all-reduce
  before the first optimizer op, random ops on rows drawing the rank's
  block of the global draw); fetches come back as the JAX global values
  (rows all-gathered on dim 0). The result is the one-device step on the
  whole batch, to within float rounding, and the ranks' parameters stay
  bit-equal;
* hybrid parallelism on a mesh of more axes (``"data"``, ``"stage"``,
  ``"model"``): parameters are placed by ``param_specs`` / ``param_rules``
  / ``spec_layout`` (``parallel/sharding.py``, ``parallel/spec_layout.py``)
  and each rank holds its shard of every parameter and optimizer slot;
  a ``pipeline_stack`` op (``ops/pipeline.py``) runs GPipe over
  ``"stage"`` and its body's Megatron all-reduces over ``"model"``; the
  data axis is the dense form above. Sharded fetches come back global
  (gathered over their axes);
* DGC's sparse exchange, for a program carrying ``DGCMomentumOptimizer``
  on a pure data-parallel mesh: the block runs inside
  ``dgc_axis_context``, each ``dgc_momentum`` exchanges top-k (index,
  value) pairs over the mesh; the DGC accumulators U/V are per-rank
  error-feedback state with a leading axis of 1 (expanded from the
  declared shape on every call, so a fresh scope works behind a warm
  executor); only scalar float fetches are allowed, and come back as
  cross-rank means; the step counter is read once per run (none for a
  statically sparse schedule); a run folds the rank into its key
  (``paddle_tpu/compiler.py``'s ``fold_in(rng_key, axis_index)``), so the
  ranks draw different dropout masks. With
  ``FLAGS_dgc_sparse_exchange=0``, or (with the JAX package's warning)
  over a multi-axis mesh or a program with ops whose state comes from
  the batch or that open collectives of their own, a DGC program runs
  the dense fused form: the dense path, then ``dgc_momentum`` with no
  exchange.

On the first run of a program version in a scope, every persistable the
program reads becomes the rank's shard and is broadcast along each axis
it is replicated over, so a replicated value is one value. A world of
one runs the plain executor, as the JAX package's one-device mesh does.
What is not ported raises ``NotImplementedError`` naming its ROADMAP
item: feed specs, axis tags and the pipeline runtime's schedules (M11),
ops on rows whose effect on the batch is not known, ops outside a
``pipeline_stack`` over sharded values, and batch statistics across
ranks (sync batch norm, M11).
"""

import warnings
import weakref

import numpy as np
import torch

from paddle_tpu_torch.core.executor import _to_numpy
from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.ops.optimizers import dgc_statically_sparse
from paddle_tpu_torch.core.backward import _OP_ROLE_OPTIMIZE
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.parallel.data_parallel import (
    BATCH_STAT_OPS, ROWS, check_program, feed_kind, plan_dense)
from paddle_tpu_torch.parallel.sharding import (
    P, derive_shardings, shard_of, shard_shape, spec_axes as _spec_axes)
from paddle_tpu_torch.parallel.spec_layout import SpecLayout
from paddle_tpu_torch.passes import (
    apply_deferred_sharded_embedding_rewrite, apply_deferred_sparse_rewrite)
from paddle_tpu_torch.utils.enforce import EnforceError, enforce
from paddle_tpu_torch.utils.flags import flags

__all__ = ["BuildStrategy", "ExecutionStrategy", "CompiledProgram"]

# ops whose lowerings open collectives of their own (the JAX package's
# _opens_shard_map on a 1-D mesh, with the c_* ops)
_OWN_COLLECTIVE_OPS = ("pipeline_stack",)
# mesh axes the batch's rows never split over
_NOT_ROWS_AXES = ("stage", "model", "tp", "fsdp")


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
        self._placed = weakref.WeakKeyDictionary()
        self._spec_cache = {}
        self._warned = set()
        self._param_rules = None
        self._param_specs = None
        self._spec_layout = None

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
        """Parallelism over ``mesh`` (default ``make_mesh()``, a 1-D
        ``"data"`` mesh), of any number of axes: the batch on ``"data"``,
        parameters placed by ``param_specs`` (exact name -> spec, e.g. a
        ``PipelinedStack``'s ``param_spec_overrides()``), ``param_rules``
        (a pattern table, ``parallel/sharding.py``) or ``spec_layout``
        (the role registry, ``parallel/spec_layout.py``; ``True`` is the
        default one), as the JAX package places them: each rank holds its
        shard of every parameter and slot. Without a placement every
        parameter is replicated (the port has no static sharding analyzer
        to choose the registry for a tensor-parallel mesh: pass
        ``spec_layout=True``). Feed specs, axis tags and pipeline
        schedules but the stack's own GPipe are not ported (M11)."""
        placement = dict(input_specs=input_specs, axis_tags=axis_tags,
                         pipeline_schedule=pipeline_schedule,
                         pipeline_interleave=pipeline_interleave)
        given = sorted(k for k, v in placement.items()
                       if v not in (None, False))
        if given:
            raise _not_ported(f"with_parallel({', '.join(given)}=)")
        if spec_layout is True:
            spec_layout = SpecLayout()
        if spec_layout not in (None, False) and param_rules is not None:
            raise EnforceError(
                "with_parallel: pass either spec_layout (the role "
                "registry) or param_rules (a pattern table), not both; "
                "use param_specs or SpecLayout.override() for exact "
                "per-var placements")
        self._is_data_parallel = True
        self._loss_name = loss_name
        self._mesh = mesh if mesh is not None else penv.make_mesh()
        self._param_rules = param_rules
        self._param_specs = dict(param_specs) if param_specs else None
        self._spec_layout = spec_layout or None
        self._spec_cache = {}
        return self

    # ------------------------------------------------------------------
    def _dgc_sparse(self, block, dgc_ops, n, axis_name):
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
        multi_axis = any(size > 1 for name, size in zip(
            self._mesh.axis_names, self._mesh.shape) if name != axis_name)
        if not manual and not multi_axis:
            return True
        key = (self._program._uid, self._program._version)
        if key not in self._warned:
            self._warned.add(key)
            warnings.warn(
                "DGCMomentumOptimizer: sparse exchange needs a pure "
                f"data-parallel mesh without manual-region ops (found "
                f"{manual or 'multi-axis mesh'}); falling back to the dense "
                "fused form (no wire savings)")
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

    def _specs(self, block, names, shapes):
        """``{name: spec}`` of the persistables ``names`` (global
        ``shapes``): the JAX package's placement order (a role registry
        with ``param_specs`` over it, else the pattern table with the
        ``param_specs`` first, else every value replicated)."""
        mesh = self._mesh
        if self._spec_layout is not None:
            return self._spec_layout.derive_shardings(
                self._program, names, shapes, mesh,
                overrides=self._param_specs)
        if self._param_rules is not None or self._param_specs:
            return derive_shardings(names, shapes, mesh,
                                    rules=self._param_rules,
                                    overrides=self._param_specs)
        return {n: P() for n in names}

    def specs(self, names=None):
        """``{name: spec}`` of the program's persistables (``names``, by
        default every one) by their declared shapes, as a run places
        them: what ``convert.shard_params`` cuts global arrays by."""
        block = self._program.global_block()
        key = (self._program._uid, self._program._version)
        specs = self._spec_cache.get(key)
        if specs is None:
            # derived over every persistable: a slot takes its parameter's
            every = sorted(v.name for v in block.vars.values()
                           if v.persistable)
            specs = self._specs(block, every, [
                tuple(block.vars[n].shape or ()) for n in every])
            self._spec_cache = {key: specs}
        return specs if names is None else {n: specs[n] for n in names}

    def global_value(self, scope, name):
        """The JAX global value of persistable ``name``: this rank's value
        in ``scope`` gathered over the axes its spec shards it on (a
        collective: every rank of those axes calls it)."""
        return self._global(scope.find_var(name), self.specs([name])[name])

    @staticmethod
    def _check_placement(block, specs, mesh):
        """Refuse what a rank's shards cannot run: an op outside a
        ``pipeline_stack`` (and the optimizer's elementwise updates) that
        reads a sharded value, and a stack whose stacked parameters do not
        split their layers over a stage axis of more than one rank."""
        def sharded(n):
            return any(e is not None for e in specs.get(n, ()))

        for op in block.ops:
            if op.type == "pipeline_stack":
                stage = op.attrs.get("stage_axis", "stage")
                if mesh.size(stage) > 1:
                    bad = [n for n in op.input("StackedParams")
                           if tuple(specs.get(n, ()))[:1] != (stage,)]
                    if bad:
                        raise EnforceError(
                            f"pipeline_stack over a {stage} axis of "
                            f"{mesh.size(stage)}: stacked parameters {bad} "
                            f"are not placed with their layers on '{stage}' "
                            "(pass param_specs=stack.param_spec_overrides())")
                continue
            if op.type == "pipeline_stack_grad" or op.attrs.get(
                    "op_role") == _OP_ROLE_OPTIMIZE:
                continue
            reads = sorted(n for n in op.input_names() if sharded(n))
            if reads:
                raise _not_ported(
                    f"op '{op.type}' over sharded values {reads} outside a "
                    "pipeline_stack")

    def _place_persistables(self, exe, scope, block):
        """On the first run of this program version in ``scope``: every
        persistable the program reads becomes this rank's shard of it by
        its spec (a scope value of the declared, global shape is sliced;
        one of the shard's shape is taken as placed), then each value is
        broadcast along every axis it is replicated over, from index 0, one
        buffer per dtype: a replicated value is one value, as the JAX
        package's ``_to_global`` makes it. Returns the specs."""
        key = (self._program._uid, self._program._version)
        done = self._placed.setdefault(scope, {})
        if key in done:
            return done[key]
        mesh = self._mesh
        names = sorted({
            n for b in self._program.blocks for op in b.ops
            for n in op.input_names()
            if getattr(block._find_var_recursive(n), "persistable", False)
            and scope.has_var(n)})
        values = [exe._from_scope(scope, n, block) for n in names]
        shapes = []
        for n, v in zip(names, values):
            decl = tuple(block._find_var_recursive(n).shape or ())
            shapes.append(decl if decl and all(d > 0 for d in decl)
                          else tuple(v.shape))
        specs = self._specs(block, names, shapes)
        self._check_placement(block, specs, mesh)
        owner = {n: scope._find_owner(n) or scope for n in names}
        by_axis = {a: [] for a in mesh.axis_names if mesh.size(a) > 1}
        for n, v, shape in zip(names, values, shapes):
            spec = specs[n]
            local = shard_shape(shape, spec, mesh)
            if tuple(v.shape) == tuple(shape) and local != tuple(shape):
                v = shard_of(v, spec, mesh).clone()
                owner[n].set(n, v)
            elif tuple(v.shape) != local:
                raise EnforceError(
                    f"persistable '{n}' has shape {tuple(v.shape)}: neither "
                    f"its global shape {tuple(shape)} nor its shard "
                    f"{local} under spec {tuple(spec)}")
            used = _spec_axes(spec)
            for a in by_axis:
                if a not in used:
                    by_axis[a].append(v)
        for a, tensors in by_axis.items():
            penv.broadcast_(tensors, mesh.axis(a))
        done[key] = specs
        return specs

    def _global(self, value, spec):
        """The JAX global value of a rank's shard under ``spec``: gathered
        over the axes of each sharded dim, the innermost axis first."""
        mesh = self._mesh
        for dim, entry in enumerate(tuple(spec)):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            for a in reversed(axes):
                axis = mesh.axis(a)
                if axis.size > 1:
                    g = penv.all_gather(value, axis)
                    value = torch.cat(list(g.unbind(0)), dim=dim)
        return value

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

    def _data_axis(self):
        """The axis the batch's rows split over: ``"data"``, else the
        mesh's first axis unless it is a stage or a tensor axis; None when
        every rank takes the whole batch."""
        mesh = self._mesh
        if "data" in mesh.axis_names:
            return mesh.axis("data")
        first = mesh.axis_names[0]
        if first in _NOT_ROWS_AXES:
            return None
        return mesh.axis(first)

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
        mesh = self._mesh
        axis = self._data_axis() or penv.Axis("data", 1, 0)
        n = axis.size
        dgc_ops = [op for op in block.ops if op.type == "dgc_momentum"]
        sparse = self._dgc_sparse(block, dgc_ops, n, axis.name)
        local = self._local_feed(feed, axis)
        if sparse:
            self._check_fetches(block, fetch_names)
            self._expand_state(scope, block, {
                name for op in dgc_ops for slot in ("U", "V")
                for name in op.input(slot)}, n)
        step = self._host_step(scope, dgc_ops, sparse) if dgc_ops else None
        if sparse or int(np.prod(mesh.shape)) == 1:
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
            specs = self._place_persistables(exe, scope, block)
            rewrite = (self._dense_rewrite(block, local, fetch_names, axis,
                                           got) if n > 1 else None)
            with penv.mesh_context(mesh), penv.data_axis_context(axis), \
                    penv.dgc_axis_context(None, step):
                fetches = exe.run(
                    program, feed=local, fetch_list=fetch_names,
                    scope=scope, return_numpy=False, _rewrite_plan=rewrite)
            fetches = [penv.all_gather_rows(f, axis)
                       if got and got[-1].fetch_kind(name) == ROWS else f
                       for name, f in zip(fetch_names, fetches)]
            fetches = [self._global(f, specs.get(_base_name(name), P()))
                       for name, f in zip(fetch_names, fetches)]
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches


def _base_name(name):
    """The persistable whose spec a fetch takes: a grad's parameter."""
    return name[:-len("@GRAD")] if name.endswith("@GRAD") else name
