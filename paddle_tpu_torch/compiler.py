"""CompiledProgram: data-parallel training over the port's data mesh.

The JAX package's ``CompiledProgram`` (``paddle_tpu/compiler.py``; the
reference's ParallelExecutor, python/paddle/fluid/compiler.py:87,
:160 with_data_parallel) jit-compiles the step over a device mesh. The
port ports its DGC sparse-exchange mode: a program carrying
``DGCMomentumOptimizer`` runs on every rank of a ``torch.distributed``
process group (``parallel.env.make_mesh``), one process per rank:

* every rank is fed the same global batch and takes its own rows,
  ``[r*B/n, (r+1)*B/n)``, as the JAX multi-controller path does; dim 0
  must divide n;
* the block runs through the port's ``Executor`` on the rank's rows inside
  ``dgc_axis_context``: each ``dgc_momentum`` exchanges top-k (index,
  value) pairs over the mesh, so every rank applies the same update and
  the parameters stay bit-identical across ranks;
* the DGC accumulators U/V are per-rank error-feedback state with a
  leading axis of 1 (this rank's slice of the JAX scope's ``[n, ...]``):
  a declared-shape value is expanded on every call, so a fresh scope
  works behind a warm executor;
* only scalar float fetches are allowed (a batch-shaped fetch would mix
  the ranks' rows); they come back as cross-rank means;
* the step counter is read once per run (none for a statically sparse
  schedule) and carried to the lowerings in the DGC context;
* a run takes one key from the executor's counter and folds the rank into
  it (``paddle_tpu/compiler.py``'s ``fold_in(rng_key, axis_index)``), so
  the ranks draw different dropout masks.

A world of one runs the dense fused form through the plain executor, as
the JAX package's one-device mesh does. What is not ported raises
``NotImplementedError`` naming ROADMAP M11: data parallelism without DGC
(GSPMD-style), the dense fused form across ranks
(``FLAGS_dgc_sparse_exchange=0``), multi-axis meshes and placement
options, and programs with ops whose state is computed from the batch
(``batch_norm``, ...) or that open their own collectives.
"""

import warnings

import numpy as np
import torch

from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.ops.optimizers import dgc_statically_sparse
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.passes import (
    apply_deferred_sharded_embedding_rewrite, apply_deferred_sparse_rewrite)
from paddle_tpu_torch.utils.enforce import EnforceError, enforce
from paddle_tpu_torch.utils.flags import flags

__all__ = ["BuildStrategy", "ExecutionStrategy", "CompiledProgram"]

# ops whose persistable write-back is computed from the batch, or whose
# lowerings open collectives of their own (the JAX package's
# _batch_stat_writeback / _opens_shard_map)
_BATCH_STAT_OPS = ("batch_norm", "data_norm", "center_loss")
_OWN_COLLECTIVE_OPS = ("pipeline_stack", "moe_ffn")


class BuildStrategy:
    """Accepted for API parity (reference: paddle/fluid/framework/details/
    build_strategy.h:37). The port runs ops eagerly: operator fusion,
    memory reuse and all-reduce fusion are not passes it has, so setting
    those fields changes nothing, and says so once per field and
    process."""

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
    def _check_program(self, block, dgc_ops, n):
        if n == 1:
            return
        if not dgc_ops:
            raise _not_ported(
                "data-parallel training without DGCMomentumOptimizer "
                "(the GSPMD-style all-reduce of dense gradients)")
        if not flags.dgc_sparse_exchange:
            raise _not_ported(
                "the dense fused DGC form across ranks "
                "(FLAGS_dgc_sparse_exchange=0)")
        manual = sorted({
            op.type for op in block.ops
            if (op.type in _BATCH_STAT_OPS and not op.attrs.get("is_test"))
            or op.type in _OWN_COLLECTIVE_OPS or op.type.startswith("c_")
            or (op.type == "scaled_dot_product_attention"
                and op.attrs.get("seq_parallel"))})
        if manual:
            raise _not_ported(
                f"DGC data parallelism over a program with {manual} (their "
                "state comes from the batch, or they run collectives of "
                "their own)")

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
        self._check_program(block, dgc_ops, n)
        sparse = n > 1
        if sparse:
            self._check_fetches(block, fetch_names)
            self._expand_state(scope, block, {
                name for op in dgc_ops for slot in ("U", "V")
                for name in op.input(slot)}, n)
        step = self._host_step(scope, dgc_ops, sparse) if dgc_ops else None
        with penv.dgc_axis_context(axis if sparse else None, step):
            fetches = exe.run(program, feed=self._local_feed(feed, axis),
                              fetch_list=fetch_names, scope=scope,
                              return_numpy=False,
                              _rank=axis.rank if sparse else None)
        if sparse:
            fetches = [penv.pmean(f, axis) if f.is_floating_point() else f
                       for f in fetches]
        if return_numpy:
            return [f.detach().cpu().numpy() for f in fetches]
        return fetches
