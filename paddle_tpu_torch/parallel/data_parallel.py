"""Dense data parallelism: GSPMD's global step, run per rank.

The JAX package runs a data-parallel program as one global step over a
device mesh (``paddle_tpu/compiler.py`` ``CompiledProgram._run``): feeds
are sharded on ``P("data")``, parameters are replicated, and XLA's GSPMD
partitioner puts an all-reduce wherever a value sums over the batch. Its
result is the one-device step on the whole batch. The port runs one
process per rank, each on its rows ``[r*B/n, (r+1)*B/n)`` of the global
batch, and reproduces that step by placing the same collectives itself.
GSPMD gives this for free; the JAX package has no module like this one.

Every var of the block holds one of three kinds of value:

* ``ROWS`` — dim 0 is this rank's slice of the batch (the feeds, and
  what per-row ops compute from them);
* ``REPL`` — replicated: the same value on every rank (parameters and
  other persistables, constants, the results of batch reductions);
* ``PARTIAL`` — this rank's term of a sum over the ranks: a grad of a
  replicated value that a per-row op used (a parameter's grad sums over
  rows), before its all-reduce.

``plan_dense`` walks the executor's per-op plan once per (program
version, feed signature) and returns a new plan:

* a batch reduction of rows (``mean``; ``reduce_sum`` over dim 0 or
  every dim) is marked ``_dp_batch``: its lowering all-reduces the local
  sum (``parallel.env.psum``) and ``mean`` divides by the global count.
  Its grad op is marked ``_dp_batch="rerun"``: the generic grad's rerun
  of the forward keeps the local sum over the global count, whose
  backward hands the replicated cotangent to the rows unchanged, with no
  collective (the rerun's value is never read);
* a grad op that makes a rows grad from a ``PARTIAL`` cotangent (a batch
  reduction whose value flows back into rows, ``x - mean(x)``) gets that
  cotangent all-reduced first, as GSPMD does;
* the ``PARTIAL`` values live at the first op that reads one and does not
  pass it on linearly (the first optimizer or AMP op) are all-reduced
  there, summed and not averaged, in one flat buffer per dtype: every
  rank then holds the same bits;
* a random op on rows draws this rank's block of the global draw: the
  executor gives it ``__rng_block__`` = rank, and K8 hashes the counters
  ``[rank * n, (rank + 1) * n)`` under the run's key, unfolded, as the
  JAX global draw hashes each element's flat index. Replicated random
  ops draw from counter 0 on every rank;
* fetches come back as the JAX global values: ``ROWS`` all-gathered on
  dim 0, ``PARTIAL`` all-reduced, ``REPL`` as they are;
* a recompute segment's grad op (``ops/recompute.py``) learns from its
  serialized segment what the forward's ops were: its ``_dp_replay``
  names the segment's batch reductions (replayed with the global value in
  the graph of the local sum) and its random ops on rows (replayed on
  this rank's block of the draw), and a replicated input's grad is
  ``PARTIAL`` where the segment carries it into rows. A batch reduction
  whose value flows back into rows inside a segment raises (its
  cotangent would need an all-reduce inside the replay).

An op that reads rows must be one whose effect on the batch this module
knows (``_rows_kind``); an unknown one, or one that moves the batch off
dim 0 (a transpose with ``perm[0] != 0``, a reshape whose target names a
batch size, a slice or concat on dim 0) raises ``NotImplementedError``
naming it and ROADMAP M11, and so do the ops whose training state comes
from the batch (``batch_norm``, ``data_norm``, ``center_loss``: sync
batch norm is a later M11 item). Nothing is guessed.
"""

from paddle_tpu_torch.core.registry import OpDef
from paddle_tpu_torch.parallel import env as penv

__all__ = ["ROWS", "REPL", "PARTIAL", "DensePlan", "check_program",
           "plan_dense", "feed_kind"]

ROWS, REPL, PARTIAL = "rows", "replicated", "partial"

# ops that compute each row of the batch from that row alone (and from
# replicated values): rows in, rows out
_PER_ROW = frozenset((
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min", "square",
    "sign", "pow", "scale", "clip", "relu", "gelu", "tanh", "sigmoid",
    "cast", "assign", "sum", "fill_zeros_like", "not_equal", "less_than",
    "where",
    "dropout", "bernoulli", "cross_entropy",
    "sigmoid_cross_entropy_with_logits", "square_error_cost", "conv2d",
    "pool2d", "lookup_table_v2", "batched_gather", "multihead_matmul",
    "scaled_dot_product_attention", "fc",
    # the c_* collectives: identities outside a bound ring, as under the
    # JAX package's GSPMD path
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_allgather", "c_broadcast", "c_reducescatter",
    "c_sync_calc_stream", "c_sync_comm_stream",
))
# the slots of a per-row op that must not hold rows (a weight a row is
# multiplied by; rows there would contract over the batch)
_WEIGHT_SLOTS = {"mul": ("Y",), "fc": ("W",), "conv2d": ("Filter",),
                 "lookup_table_v2": ("W",), "multihead_matmul": ("W",)}
# ops that pass a PARTIAL value on linearly: their output is PARTIAL too
_LINEAR = frozenset(("assign", "cast", "sum"))
# ops whose training state comes from the batch (the JAX package's
# _batch_stat_writeback)
BATCH_STAT_OPS = ("batch_norm", "data_norm", "center_loss")
_ELEMENTWISE = frozenset(t for t in _PER_ROW if t.startswith("elementwise"))


def _not_ported(op_type, why):
    return NotImplementedError(
        f"dense data parallelism over op '{op_type}': {why} is not ported "
        "yet (ROADMAP M11)")


class _CollectiveOp:
    """The stand-in op of a collective step (error attribution only)."""

    def __init__(self, type):
        self.type = type
        self.attrs = {}


def _collective_step(step_cls, label, names, fuse):
    """A plan step that all-reduces ``names`` in the executor's env over
    the run's data axis: one flat buffer per dtype with ``fuse`` (counted
    as ``all_reduce_fused``, the grads), else one all-reduce each (a
    cotangent flowing back into rows). ``label`` names the step in
    errors."""

    def lower(ins, attrs):
        axis = penv.current_data_axis()
        if fuse:
            return {"Out": penv.psum_fused(ins["X"], axis)}
        return {"Out": [penv.psum(x, axis) for x in ins["X"]]}

    return step_cls(_CollectiveOp(label), OpDef(label, lower), {},
                    [("X", list(names))], [("Out", list(names))], None)


def _ndim(block, name):
    v = block._find_var_recursive(name)
    return len(v.shape) if v is not None and v.shape is not None else None


def _shape(block, name):
    v = block._find_var_recursive(name)
    return tuple(v.shape) if v is not None and v.shape is not None else None


def _batch_dim_of_y(x_ndim, y_shape, axis):
    """The dim of ``Y`` that Paddle's elementwise broadcast aligns with
    ``X``'s dim 0, or None."""
    if y_shape is None or x_ndim is None:
        return None
    if axis is None or axis == -1:
        return 0 if len(y_shape) == x_ndim else None
    return 0 if axis == 0 else None


class DensePlan:
    """The plan of one dense data-parallel run: ``steps`` for the
    executor and the kind of each var at the end (``kinds``)."""

    def __init__(self, steps, kinds):
        self.steps = steps
        self.kinds = kinds

    def fetch_kind(self, name):
        return self.kinds.get(name, REPL)


def _reduces_batch(attrs, ndim):
    """Whether a ``reduce_sum`` with ``attrs`` over an ``ndim``-D input
    sums over dim 0 (the batch)."""
    dims = attrs.get("dim", [0])
    dims = [dims] if isinstance(dims, int) else list(dims)
    return bool(attrs.get("reduce_all")) or ndim is None \
        or 0 in [d % ndim for d in dims]


def _rows_kind(op, rows, block):
    """(kind of the outputs, whether the op is a batch reduction) of a
    forward op with rows in the input slots ``rows``; raises for an op
    this module does not know, or one that takes the batch off dim 0."""
    t, a = op.type, op.attrs
    if t == "batch_norm" and a.get("is_test"):
        return ROWS, False
    if t in _PER_ROW:
        bad = [s for s in _WEIGHT_SLOTS.get(t, ()) if s in rows]
        if bad:
            raise _not_ported(t, f"rows in its weight slot {bad}")
        if t in _ELEMENTWISE and "X" in rows and "Y" not in rows:
            y = _shape(block, op.input("Y")[0])
            dim = _batch_dim_of_y(_ndim(block, op.input("X")[0]), y,
                                  a.get("axis", -1))
            if dim is not None and y[dim] > 1:
                raise _not_ported(t, f"a replicated Y whose dim {dim} "
                                     f"({y[dim]}) meets the batch")
        return ROWS, False
    if t == "mul":
        if "Y" in rows:
            raise _not_ported(t, "rows in Y (a product over the batch)")
        if a.get("x_num_col_dims", 1) < 1:
            raise _not_ported(t, "x_num_col_dims < 1")
        return ROWS, False
    if t == "matmul":
        nx = _ndim(block, op.input("X")[0])
        ny = _ndim(block, op.input("Y")[0])
        if "X" in rows and (nx is None or nx < 2
                            or (nx == 2 and a.get("transpose_X"))):
            raise _not_ported(t, "a product over the batch of X")
        if "Y" in rows and (ny is None or ny < 3):
            raise _not_ported(t, "a product over the batch of Y")
        return ROWS, False
    if t in ("softmax", "log_softmax", "softmax_with_cross_entropy",
             "top_k"):
        slot = "Logits" if t == "softmax_with_cross_entropy" else "X"
        nd = _ndim(block, op.input(slot)[0])
        if nd is None or nd < 2 or a.get("axis", -1) % nd == 0:
            raise _not_ported(t, "a normalisation over the batch dim")
        return ROWS, False
    if t == "layer_norm":
        if a.get("begin_norm_axis", 1) < 1:
            raise _not_ported(t, "begin_norm_axis 0 (over the batch)")
        return ROWS, False
    if t in ("reshape", "reshape2"):
        shape = list(a.get("shape") or ())
        if op.input("Shape") or op.input("ShapeTensor"):
            raise _not_ported(t, "a shape given as a tensor")
        if not shape or shape[0] not in (0, -1):
            raise _not_ported(
                t, f"target shape {shape}, whose dim 0 names a batch size "
                   "(it must be 0 or -1 to keep the batch on dim 0)")
        return ROWS, False
    if t == "transpose2":
        perm = list(a.get("axis") or ())
        if not perm or perm[0] != 0:
            raise _not_ported(t, f"perm {perm}, which moves the batch off "
                                 "dim 0")
        return ROWS, False
    if t in ("slice", "squeeze2", "unsqueeze2"):
        axes = list(a.get("axes") or ())
        if (t == "squeeze2" and not axes) or 0 in axes:
            raise _not_ported(t, f"axes {axes}, which take dim 0")
        return ROWS, False
    if t == "concat":
        nd = _ndim(block, op.input("X")[0])
        if len(rows.get("X", ())) != len(op.input("X")):
            raise _not_ported(t, "rows beside replicated inputs")
        if nd is None or a.get("axis", 0) % nd == 0:
            raise _not_ported(t, "a concat over the batch dim")
        return ROWS, False
    if t == "gather":
        if "X" in rows:
            raise _not_ported(t, "a gather from rows (across the batch)")
        return ROWS, False
    if t in ("uniform_random_batch_size_like",
             "gaussian_random_batch_size_like"):
        if a.get("input_dim_idx", 0) != 0 or a.get("output_dim_idx", 0) != 0:
            raise _not_ported(t, "a batch dim other than dim 0")
        return ROWS, False
    if t == "pipeline_stack":
        # its layers run on each microbatch of the rank's rows; its
        # stacked parameters are weights
        bad = [s for s in ("StackedParams", "Ex") if s in rows]
        if bad:
            raise _not_ported(t, f"rows in {bad}")
        return ROWS, False
    if t == "mean":
        return REPL, True
    if t == "reduce_sum":
        if _reduces_batch(a, _ndim(block, op.input("X")[0])):
            return REPL, True
        return ROWS, False
    raise _not_ported(t, "an op on rows of the batch whose effect on the "
                         "batch is not known here")


def check_program(block):
    """Refuse, before any collective runs, the ops whose training state
    comes from the batch: their statistics across the ranks (sync batch
    norm) are a later M11 item."""
    stats = sorted({op.type for op in block.ops
                    if op.type in BATCH_STAT_OPS
                    and not op.attrs.get("is_test")})
    if stats:
        raise NotImplementedError(
            f"dense data parallelism over {stats} in training: their batch "
            "statistics across the ranks (sync batch norm) are not ported "
            "yet (ROADMAP M11)")


def _segment_replay(attrs, kinds, batch_ops, row_random, rank):
    """The ``_dp_replay`` attrs of a ``recompute_segment_grad`` and the
    replicated names whose grads its replay makes ``PARTIAL`` (those the
    segment carries, through replicated values, into an op on rows)."""
    seg = attrs["__segment__"]
    ids = [a.get("__rng_id__") for _, _, _, a in seg]

    def names(slots):
        return [n for ns in slots.values() for n in ns]

    batch_outs = {n for (_, _, outs, a) in seg
                  if a.get("__rng_id__") in batch_ops for n in names(outs)}
    partial = set()
    for op_type, ins, outs, a in reversed(seg):
        io = names(ins) + names(outs)
        on_rows = any(kinds.get(n) == ROWS for n in io)
        if on_rows and a.get("__rng_id__") not in batch_ops and \
                batch_outs & set(names(ins)):
            raise _not_ported(
                "recompute_segment_grad",
                f"a batch reduction's value read by '{op_type}' on rows "
                "inside a recompute segment (its cotangent would need an "
                "all-reduce inside the replay)")
        if on_rows or partial & set(names(outs)):
            partial.update(n for n in names(ins) if kinds.get(n) != ROWS)
    replay = {"rerun": [i for i in ids if i in batch_ops],
              "rng_block": {i: rank for i in ids if i in row_random}}
    return replay, partial


def plan_dense(steps, block, feed_kinds, fetch_names, rank):
    """The ``DensePlan`` of the executor plan ``steps`` (``_OpStep`` list)
    of ``block``: ``feed_kinds`` maps each feed to ``ROWS`` or ``REPL``
    (a 0-d feed). Vars read before any op writes them come from the scope:
    replicated."""
    step_cls = type(steps[0]) if steps else None
    kinds = dict(feed_kinds)
    # the last step that reads each var (fetches and persistables: the end)
    last_read = {}
    for i, s in enumerate(steps):
        for _, names in s.inputs:
            for n in names:
                last_read[n] = i
    end = len(steps)
    persistable = {v.name for v in block.vars.values() if v.persistable}
    for n in list(fetch_names) + sorted(persistable):
        last_read[n] = end

    out = []
    # the batch reductions, by the __rng_id__ their grad ops carry too,
    # and the random ops on rows
    batch_ops, row_random = set(), set()

    def live_partials(i):
        return sorted(n for n, k in kinds.items()
                      if k == PARTIAL and last_read.get(n, -1) >= i)

    def reduce_now(names, label, fused=True):
        if not names:
            return
        out.append(_collective_step(step_cls, label, names, fused))
        for n in names:
            kinds[n] = REPL

    for i, step in enumerate(steps):
        op = step.op
        t = op.type
        ins = {slot: [kinds.get(n, REPL) for n in names]
               for slot, names in step.inputs}
        attrs, rng_block = step.attrs, None
        if t.endswith("_grad"):
            fwd_in = attrs.get("__fwd_inputs__", [])
            fwd_out = attrs.get("__fwd_outputs__", [])
            rows_out = any(k == ROWS for s in fwd_out for k in ins.get(s, ()))
            rows_in = any(k == ROWS for s in fwd_in for k in ins.get(s, ()))
            cot = [n for slot, names in step.inputs if slot.endswith("@GRAD")
                   for n in names]
            partial_cot = [n for n in cot if kinds.get(n) == PARTIAL]
            if rows_in and partial_cot:
                # a batch reduction whose value flows back into rows: the
                # rows' grads need the whole cotangent
                reduce_now(partial_cot, "c_allreduce_sum (dense data "
                           "parallel: a cotangent flowing back into rows)",
                           fused=False)
                partial_cot = []
            if attrs.get("__rng_id__") in batch_ops:
                attrs = dict(attrs, _dp_batch="rerun")
            if rows_in and step.op_def.stateful:
                rng_block = rank
            seg_partial = None
            if t == "recompute_segment_grad":
                replay, seg_partial = _segment_replay(
                    attrs, kinds, batch_ops, row_random, rank)
                attrs = dict(attrs, _dp_replay=replay)
            for slot, names in step.outputs:
                base = slot[:-len("@GRAD")] if slot.endswith("@GRAD") \
                    else None
                fwd_names = dict(step.inputs).get(base, [])
                for j, n in enumerate(names):
                    fwd = fwd_names[j] if j < len(fwd_names) else None
                    k = kinds.get(fwd, REPL)
                    if k == ROWS:
                        kinds[n] = ROWS
                    elif partial_cot or (rows_out if seg_partial is None
                                         else fwd in seg_partial):
                        kinds[n] = PARTIAL
                    else:
                        kinds[n] = REPL
        else:
            partial_in = [n for _, names in step.inputs for n in names
                          if kinds.get(n) == PARTIAL]
            every = [n for _, names in step.inputs for n in names]
            if partial_in and t in _LINEAR and \
                    len(partial_in) == len(every):
                for _, names in step.outputs:
                    for n in names:
                        kinds[n] = PARTIAL
                out.append(step)
                continue
            if partial_in:
                # the first op that reads a grad and does not pass it on:
                # every grad still to be read is summed here, at once
                reduce_now(live_partials(i), "c_allreduce_sum (dense data "
                           "parallel: the grads, fused)")
            rows = {slot: names for slot, names in step.inputs
                    if any(kinds.get(n) == ROWS for n in names)}
            if not rows:
                kind = REPL
            else:
                kind, batch = _rows_kind(op, rows, block)
                if batch:
                    attrs = dict(attrs, _dp_batch=True)
                    batch_ops.add(attrs.get("__rng_id__"))
                if step.op_def.stateful and kind == ROWS:
                    rng_block = rank
                    row_random.add(attrs.get("__rng_id__"))
            for _, names in step.outputs:
                for n in names:
                    kinds[n] = kind
        if attrs is not step.attrs or rng_block is not None:
            step = step_cls(op, step.op_def, attrs, step.inputs,
                            step.outputs, step.rng_id)
            step.rng_block = rng_block
        out.append(step)
    written_rows = sorted(n for n in persistable
                          if kinds.get(n) == ROWS and any(
                              n in names for s in steps
                              for _, names in s.outputs))
    if written_rows:
        raise NotImplementedError(
            f"dense data parallelism: persistables {written_rows} are "
            "written from rows of the batch (one value a rank) is not "
            "ported yet (ROADMAP M11)")
    reduce_now(sorted(n for n in set(fetch_names) | persistable
                      if kinds.get(n) == PARTIAL),
               "c_allreduce_sum (dense data parallel: partial fetches)")
    return DensePlan(out, kinds)


def feed_kind(value):
    """``ROWS`` for a feed with a dim 0 (sharded on the batch), ``REPL``
    for a 0-d one."""
    shape = tuple(getattr(value, "shape", ()) or ())
    return ROWS if len(shape) else REPL

