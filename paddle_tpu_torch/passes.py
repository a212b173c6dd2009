"""Named program-rewrite passes and a pass manager, the port's copy of the
JAX package's ``passes.py`` (reference: paddle/fluid/framework/ir/pass.h:40
Pass::Apply, paddle/fluid/inference/analysis/ir_pass_manager.cc:36).

A pass is a callable ``(Program, PassContext) -> Program`` registered by
name; it may mutate in place and return the same Program. Each records
what it did under ``ctx.stats[name]`` with the JAX pass's keys.

* training rewrites: ``sparse_weight_update`` and
  ``sharded_embedding_update``, applied by the executor before it plans
  a program (``apply_deferred_sparse_rewrite``,
  ``apply_deferred_sharded_embedding_rewrite``), as the JAX executor does
  before it compiles one;
* inference passes, which ``inference/predictor.py`` composes:
  ``strip_debug_ops``, ``flip_test_mode``, ``dead_code_elimination``,
  ``fold_constants``, the export-time fusions ``conv_bn_fuse``,
  ``fc_fuse`` and ``multihead_matmul_fuse`` (whose target,
  ``scaled_dot_product_attention``, runs on the hand-written flash
  kernel K1) and ``bf16_cast``.

Producer/consumer reasoning goes through the control-flow-aware use-def
analysis (``analysis/usedef.py``): a var read only by a while body still
counts as consumed, so a fusion cannot delete a producer a sub-block
reads. ``PassManager(verify_each_pass=True)`` runs the verifier
(``analysis/verify.py``) after every pass and raises naming the pass that
broke an invariant.
"""

import numpy as np
import torch

from paddle_tpu_torch.analysis.usedef import build_usedef
from paddle_tpu_torch.core.ir import Operator
from paddle_tpu_torch.utils.enforce import EnforceError, enforce

__all__ = [
    "register_pass",
    "get_pass",
    "PassContext",
    "PassManager",
    "apply_deferred_sparse_rewrite",
    "apply_deferred_sharded_embedding_rewrite",
]

_PASS_REGISTRY = {}


def register_pass(name):
    """Decorator: register a pass callable under `name`
    (reference: paddle/fluid/framework/ir/pass.h REGISTER_PASS)."""

    def deco(fn):
        enforce(name not in _PASS_REGISTRY, f"pass '{name}' already registered")
        _PASS_REGISTRY[name] = fn
        return fn

    return deco


def get_pass(name):
    enforce(name in _PASS_REGISTRY, f"no pass named '{name}'; have "
            f"{sorted(_PASS_REGISTRY)}")
    return _PASS_REGISTRY[name]


class PassContext:
    """Shared state passed to every pass: the scope holding parameters (so
    weight-rewriting passes can transform values, not just the graph), the
    fetch targets (for liveness), and free-form options (``device``: where
    ``fold_constants`` evaluates and leaves its values; when unset, the
    port's default place, ``cuda:0``, which raises with no card)."""

    def __init__(self, scope=None, feed_names=(), fetch_names=(), **options):
        self.scope = scope
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.options = options
        self.stats = {}  # pass name -> info dict, for debugging/reporting

    def opt(self, key, default=None):
        return self.options.get(key, default)


class PassManager:
    """Apply a sequence of named passes. With ``verify_each_pass=True``
    the verifier runs after every pass; a pass that introduces a NEW
    error-grade diagnostic (relative to the program as it entered the
    manager) raises EnforceError naming that pass. Per-pass diagnostics
    are recorded under ``ctx.stats['verify'][pass_name]`` either way."""

    def __init__(self, pass_names, verify_each_pass=False):
        self.pass_names = list(pass_names)
        self.verify_each_pass = verify_each_pass
        for n in self.pass_names:
            get_pass(n)  # fail fast on unknown names

    def _verify(self, program, ctx):
        from paddle_tpu_torch.analysis.verify import verify_program

        return verify_program(
            program, feed_names=ctx.feed_names, fetch_names=ctx.fetch_names,
        )

    def run(self, program, ctx=None):
        ctx = ctx or PassContext()
        seen = None
        if self.verify_each_pass:
            # pre-existing diagnostics are the caller's, not a pass's
            seen = {d.key() for d in self._verify(program, ctx)}
        for name in self.pass_names:
            out = get_pass(name)(program, ctx)
            program = out if out is not None else program
            if self.verify_each_pass:
                diags = self._verify(program, ctx)
                for d in diags:
                    d.pass_name = name
                fresh = [
                    d for d in diags
                    if d.severity == "error" and d.key() not in seen
                ]
                ctx.stats.setdefault("verify", {})[name] = [
                    str(d) for d in diags if d.key() not in seen
                ]
                if fresh:
                    detail = "\n".join(str(d) for d in fresh)
                    raise EnforceError(
                        f"pass '{name}' broke program invariants "
                        f"({len(fresh)} new error"
                        f"{'s' if len(fresh) > 1 else ''}):\n{detail}"
                    )
                seen |= {d.key() for d in diags}
        return program


# ---------------------------------------------------------------------------
# semantic inference passes
# ---------------------------------------------------------------------------


@register_pass("dead_code_elimination")
def _dce_pass(program, ctx):
    """Drop ops that don't (transitively) feed a fetch and have no side
    effects (reference: paddle/fluid/framework/prune.cc). Only the global
    block: sub-blocks carry their liveness through their control-flow op.
    Requires ctx.fetch_names."""
    from paddle_tpu_torch.analysis.usedef import live_ops

    if not ctx.fetch_names:
        return program
    block = program.global_block()
    live = {id(op) for op in live_ops(block, ctx.fetch_names)}
    before = len(block.ops)
    block.ops = [op for op in block.ops if id(op) in live]
    removed = before - len(block.ops)
    if removed:
        program._bump_version()
    ctx.stats["dead_code_elimination"] = {"removed_ops": removed}
    return program


@register_pass("flip_test_mode")
def _flip_test_pass(program, ctx):
    """Force is_test=True on every op with a train/test split (dropout,
    batch_norm, ...) — the inference analog of clone(for_test)."""
    from paddle_tpu_torch.core.ir import _test_mode_attrs

    flipped = 0
    for block in program.blocks:
        for op in block.ops:
            if "is_test" in _test_mode_attrs(op.type) \
                    and not op.attrs.get("is_test"):
                op.attrs["is_test"] = True
                flipped += 1
    if flipped:
        program._bump_version()
    ctx.stats["flip_test_mode"] = {"flipped_ops": flipped}
    return program


@register_pass("bf16_cast")
def _bf16_cast_pass(program, ctx):
    """Cast the matrix-product regions to bfloat16 with the AMP white and
    black lists (``amp/decorator.py``; reference: the precision passes of
    paddle/fluid/inference/api/paddle_pass_builder.cc). The predictor then
    folds the weights' casts into bf16 weights (``_fold_param_casts``)."""
    from paddle_tpu_torch.amp.decorator import (AutoMixedPrecisionLists,
                                                rewrite_program_amp)

    rewrite_program_amp(
        program,
        amp_lists=AutoMixedPrecisionLists(
            custom_white_list=ctx.opt("bf16_white_list"),
            custom_black_list=ctx.opt("bf16_black_list"),
        ),
        dest_dtype="bfloat16",
    )
    ctx.stats["bf16_cast"] = {"enabled": True}
    return program


@register_pass("fold_constants")
def _fold_constants_pass(program, ctx):
    """Evaluate constant subgraphs (starting from fill_constant, then ops
    whose inputs are all folded) once at analysis time and leave their
    values in the scope, on ``ctx.opt("device")`` (``cuda:0`` when unset;
    no card then raises), as persistables. Requires ctx.scope."""
    from paddle_tpu_torch.core.backward import resolve_op_def
    from paddle_tpu_torch.core.places import default_place
    from paddle_tpu_torch.core.registry import OpRegistry

    if ctx.scope is None:
        return program
    device = ctx.opt("device")
    device = (default_place().device if device is None
              else torch.device(device))
    block = program.global_block()
    const_vals = {}
    folded_ops = []
    feed_set = set(ctx.feed_names)
    for op in block.ops:
        ins = [n for ns in op.inputs.values() for n in ns]
        foldable = (op.type == "fill_constant" and not ins) or (
            ins and all(n in const_vals for n in ins)
        )
        op_def = None
        if foldable and OpRegistry.has(op.type):
            op_def = resolve_op_def(op.type)
            foldable = not op_def.stateful and not any(
                n in feed_set for n in op.output_names()
            )
        else:
            foldable = False
        if not foldable:
            # a non-folded op overwriting a tracked var invalidates its
            # constant value
            for n in op.output_names():
                const_vals.pop(n, None)
            continue
        env = {slot: [const_vals[n] for n in names]
               for slot, names in op.inputs.items()}
        if op_def.creates:
            env["__device__"] = [device]
        try:
            with torch.no_grad():
                out = op_def.lowering()(env, dict(op.attrs))
        except Exception:
            out = None
        ok = out is not None
        new_vals = {}
        if ok:
            for slot, names in op.outputs.items():
                vals = out.get(slot)
                if vals is None or len(vals) != len(names):
                    ok = False
                    break
                for n, v in zip(names, vals):
                    new_vals[n] = torch.as_tensor(v, device=device)
        if ok:
            const_vals.update(new_vals)
            folded_ops.append(op)
        else:
            # the op runs at serve time and overwrites its outputs
            for n in op.output_names():
                const_vals.pop(n, None)
    if folded_ops:
        folded_set = {id(op) for op in folded_ops}
        block.ops = [op for op in block.ops if id(op) not in folded_set]
        # keep only constants still read by the remaining program
        still_read = {
            n for op in block.ops for n in op.input_names()
        } | set(ctx.fetch_names)
        for n, v in const_vals.items():
            if n in still_read:
                ctx.scope.set(n, v)
                var = block._find_var_recursive(n)
                if var is not None:
                    var.persistable = True
        program._bump_version()
    ctx.stats["fold_constants"] = {
        "folded_ops": len(folded_ops),
        "materialized": int(
            sum(1 for n in const_vals if ctx.scope.has_var(n))
        ),
    }
    return program


@register_pass("strip_debug_ops")
def _strip_debug_pass(program, ctx):
    """Remove print instrumentation for serving builds."""
    removed = 0
    for block in program.blocks:
        before = len(block.ops)
        block.ops = [op for op in block.ops if op.type not in ("print",)]
        removed += before - len(block.ops)
    if removed:
        program._bump_version()
    ctx.stats["strip_debug_ops"] = {"removed_ops": removed}
    return program


# ---------------------------------------------------------------------------
# training rewrites (applied by the executor, deferred)
# ---------------------------------------------------------------------------


@register_pass("sparse_weight_update")
def _sparse_weight_update_pass(program, ctx):
    """Fuse lookup_table*_grad + sgd into a row-sparse sgd_sparse update —
    the SelectedRows analog for the dense path (reference:
    paddle/fluid/framework/selected_rows.h:32; operators/optimizers/
    sgd_op.h sparse branch). The [V, D] dense gradient never materializes.
    Applies only where the dense grad has exactly one producer (the lookup
    grad) and one consumer (the sgd) — grad clip, regularizers, or
    multi-use embeddings keep the dense form. (The JAX package also skips
    it for a microbatched program; the port has no pipeline optimizer.)"""
    block = program.global_block()
    usedef = build_usedef(block)

    lookup_types = {"lookup_table_grad", "lookup_table_v2_grad"}
    rewrites = []  # (sgd_op, grad_op)
    for op in block.ops:
        if op.type != "sgd":
            continue
        gname = op.inputs["Grad"][0]
        prods = usedef.producers.get(gname, [])
        cons = usedef.consumers.get(gname, [])
        v = block.vars.get(gname)
        if (
            len(prods) == 1
            and prods[0].type in lookup_types
            and len(cons) == 1
            and cons[0] is op
            and not (v is not None and v.persistable)
        ):
            rewrites.append((op, prods[0]))

    if not rewrites:
        ctx.stats["sparse_weight_update"] = {"rewritten": 0}
        return program

    replaced = {id(o) for pair in rewrites for o in pair}
    new_ops = []
    for op in block.ops:
        if id(op) not in replaced:
            new_ops.append(op)
            continue
        match = next((pair for pair in rewrites if pair[0] is op), None)
        if match is None:
            continue  # the grad op: dropped (fused into sgd_sparse)
        sgd_op, grad_op = match
        # RowGrad is the lookup OUTPUT's cotangent (Out@GRAD input slot)
        new_ops.append(Operator(
            block, "sgd_sparse",
            {
                "Param": list(sgd_op.inputs["Param"]),
                "Ids": list(grad_op.inputs["Ids"]),
                "RowGrad": list(grad_op.inputs["Out@GRAD"]),
                "LearningRate": list(sgd_op.inputs["LearningRate"]),
            },
            {"ParamOut": list(sgd_op.outputs["ParamOut"])},
            {
                "padding_idx": grad_op.attrs.get("padding_idx", -1),
                "op_role": sgd_op.attrs.get("op_role", 0),
            },
        ))
        block.vars.pop(sgd_op.inputs["Grad"][0], None)
    block.ops = new_ops
    program._bump_version()
    ctx.stats["sparse_weight_update"] = {"rewritten": len(rewrites)}
    return program


@register_pass("sharded_embedding_update")
def _sharded_embedding_update_pass(program, ctx):
    """Fuse sharded_embedding_lookup_grad + the dense optimizer op into one
    ``sharded_embedding_sgd`` row update on the hot slab. Mandatory where
    it matches: a dense optimizer step on the slab touches rows the batch
    never looked up (Adam moments drift untouched cached rows), which
    breaks the engine's cache-size invariance — so a grad the pass CANNOT
    fuse (extra consumers, grad clip) is a build error, not a silent
    fallback."""
    block = program.global_block()
    slabs = {
        t["slab"]: t
        for t in (getattr(program, "_sharded_tables", None) or {}).values()
    }
    grad_ops = [
        op for op in block.ops
        if op.type == "sharded_embedding_lookup_grad"
        and op.inputs.get("Table", [None])[0] in slabs
    ]
    if not grad_ops:
        ctx.stats["sharded_embedding_update"] = {"rewritten": 0}
        return program
    usedef = build_usedef(block)
    rewrites = {}  # id(grad_op) -> (grad_op, opt_op)
    for gop in grad_ops:
        gname = gop.outputs["Table@GRAD"][0]
        slab = gop.inputs["Table"][0]
        cons = usedef.consumers.get(gname, [])
        ok = (
            len(cons) == 1
            and cons[0].inputs.get("Grad", [None])[0] == gname
            and cons[0].inputs.get("Param", [None])[0] == slab
        )
        if not ok:
            raise EnforceError(
                f"sharded table slab '{slab}': its gradient must flow "
                "straight into one optimizer op (the engine's row-sparse "
                "SGD replaces it). Gradient clip / regularizers / extra "
                f"consumers are unsupported on sharded tables; consumers: "
                f"{[c.type for c in cons]}"
            )
        rewrites[id(gop)] = (gop, cons[0])

    opt_ids = {id(opt) for _g, opt in rewrites.values()}
    new_ops, dropped_vars = [], set()
    for op in block.ops:
        if id(op) in opt_ids:
            # the dense optimizer op: dropped; its private accumulators
            # (moments, beta pows) become dead vars
            for slot, names in op.inputs.items():
                if slot in ("Param", "Grad", "LearningRate"):
                    continue
                dropped_vars.update(names)
            continue
        if id(op) not in rewrites:
            new_ops.append(op)
            continue
        gop, opt = rewrites[id(op)]
        gname = gop.outputs["Table@GRAD"][0]
        slab = gop.inputs["Table"][0]
        new_ops.append(Operator(
            block, "sharded_embedding_sgd",
            {
                "Table": [slab],
                "Slots": list(gop.inputs["Slots"]),
                "Inv": list(gop.inputs["Inv"]),
                "OutGrad": list(gop.inputs["Out@GRAD"]),
            },
            {"TableOut": [slab]},
            {
                "lr": slabs[slab]["lr"],
                "table_name": slabs[slab]["table_name"],
                "op_role": opt.attrs.get("op_role", 0),
            },
        ))
        dropped_vars.add(gname)
    block.ops = new_ops
    # drop vars no remaining op touches (the dense grad + dead slots)
    still_used = {
        n for op in block.ops
        for names in list(op.inputs.values()) + list(op.outputs.values())
        for n in names
    }
    for n in dropped_vars - still_used:
        block.vars.pop(n, None)
    program._bump_version()
    ctx.stats["sharded_embedding_update"] = {"rewritten": len(rewrites)}
    return program


def apply_deferred_sharded_embedding_rewrite(program):
    """Execution-time hook: ``layers.sharded_embedding`` marks the
    program; the executor calls this before planning it, so the rewrite
    sees the final op list."""
    if not getattr(program, "_wants_sharded_embedding_update", False):
        return
    if not any(
        op.type == "sharded_embedding_lookup_grad"
        for op in program.global_block().ops
    ):
        # inference program (or minimize not run yet): nothing to fuse;
        # keep the mark so a later-minimized program still rewrites
        return
    program._wants_sharded_embedding_update = False
    _PASS_REGISTRY["sharded_embedding_update"](program, PassContext())


def apply_deferred_sparse_rewrite(program):
    """Execution-time hook: ``SGDOptimizer.minimize`` marks the program
    instead of rewriting it; the executor calls this before planning it."""
    if not getattr(program, "_wants_sparse_embedding", False):
        return
    program._wants_sparse_embedding = False
    _PASS_REGISTRY["sparse_weight_update"](program, PassContext())


# ---------------------------------------------------------------------------
# export-time pattern fusion (reference: framework/ir/fc_fuse_pass.cc,
# conv_bn_fuse_pass.cc, multihead_matmul_fuse_pass.cc)
# ---------------------------------------------------------------------------

# activations fusable only when their attrs match what the fc op computes
_FUSABLE_ACT = {
    "relu": lambda a: True,
    "tanh": lambda a: True,
    "sigmoid": lambda a: True,
    "gelu": lambda a: not a.get("approximate", False),
    "relu6": lambda a: a.get("threshold", 6.0) == 6.0,
}


@register_pass("fc_fuse")
def _fc_fuse_pass(program, ctx):
    """mul + elementwise_add(1-D bias) [+ activation] -> one `fc` op
    (reference: paddle/fluid/framework/ir/fc_fuse_pass.cc:1). An
    intermediate read by a while/conditional_block body counts its
    control-flow op as a consumer, so the pattern refuses to swallow it."""
    block = program.global_block()
    usedef = build_usedef(block, ctx.fetch_names)
    drop = set()
    rewrites = {}  # id(mul op) -> replacement Operator
    for op in block.ops:
        if op.type != "mul" or id(op) in drop:
            continue
        if op.attrs.get("y_num_col_dims", 1) != 1:
            continue
        w_var = block._find_var_recursive(op.inputs["Y"][0])
        if w_var is None or not w_var.shape or len(w_var.shape) != 2:
            continue  # the fc lowering assumes a 2-D weight
        k = op.attrs.get("x_num_col_dims", 1)
        out = op.outputs["Out"][0]
        add = usedef.sole_consumer(out)
        if add is None or add.type != "elementwise_add":
            continue
        if add.inputs["X"][0] != out:  # bias must be the Y operand
            continue
        # the bias aligns on the LAST axis (mul out rank is k+1)
        if add.attrs.get("axis", -1) not in (-1, k):
            continue
        bias_name = add.inputs["Y"][0]
        bias_var = block._find_var_recursive(bias_name)
        if bias_var is None or not bias_var.shape or len(bias_var.shape) != 1:
            continue
        add_out = add.outputs["Out"][0]
        act_op = usedef.sole_consumer(add_out)
        act = ""
        final_out = add_out
        tail = [op, add]
        if (
            act_op is not None
            and act_op.type in _FUSABLE_ACT
            and _FUSABLE_ACT[act_op.type](act_op.attrs)
        ):
            act = act_op.type
            final_out = act_op.outputs["Out"][0]
            tail.append(act_op)
        rewrites[id(op)] = Operator(
            block, "fc",
            {
                "Input": list(op.inputs["X"]),
                "W": list(op.inputs["Y"]),
                "Bias": [bias_name],
            },
            {"Out": [final_out]},
            {
                "in_num_col_dims": op.attrs.get("x_num_col_dims", 1),
                "activation_type": act,
            },
        )
        drop.update(id(o) for o in tail)
    if not rewrites:
        ctx.stats["fc_fuse"] = {"fused": 0}
        return program
    new_ops = []
    for op in block.ops:
        if id(op) in rewrites:
            new_ops.append(rewrites[id(op)])
        elif id(op) not in drop:
            new_ops.append(op)
    block.ops = new_ops
    program._bump_version()
    ctx.stats["fc_fuse"] = {"fused": len(rewrites)}
    return program


def _host_f64(value):
    """A scope value as a float64 numpy array on the host."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float64).numpy()
    return np.asarray(value, np.float64)


@register_pass("conv_bn_fuse")
def _conv_bn_fuse_pass(program, ctx):
    """Fold inference-mode batch_norm into the preceding conv's weights
    (reference: paddle/fluid/framework/ir/conv_bn_fuse_pass.cc:1):
    W' = W * gamma / sqrt(var + eps) per out-channel, and the BN becomes a
    per-channel bias add. The fold runs in float64 on the host, as the JAX
    pass does, and the folded weight and bias go back to the filter's
    device in its dtype. Requires ctx.scope."""
    if ctx.scope is None:
        ctx.stats["conv_bn_fuse"] = {"fused": 0, "skipped": "no scope"}
        return program
    block = program.global_block()
    usedef = build_usedef(block, ctx.fetch_names)
    drop = set()
    replacements = {}  # id(bn op) -> new bias-add Operator
    fused = 0
    for op in block.ops:
        if op.type not in ("conv2d", "depthwise_conv2d") or id(op) in drop:
            continue
        if op.attrs.get("data_format", "NCHW") not in ("NCHW", "AnyLayout"):
            continue
        conv_out = op.outputs["Output"][0]
        nxt = usedef.sole_consumer(conv_out)
        bias_add = None
        bn = nxt
        if nxt is not None and nxt.type == "elementwise_add":
            y = block._find_var_recursive(nxt.inputs["Y"][0])
            if y is None or not y.persistable:
                continue
            bias_add = nxt
            bn = usedef.sole_consumer(nxt.outputs["Out"][0])
        if bn is None or bn.type != "batch_norm":
            continue
        if not bn.attrs.get("is_test"):
            continue
        if bn.attrs.get("data_layout", "NCHW") != "NCHW":
            continue
        # BN side outputs must be dead; MeanOut/VarianceOut alias the bn's
        # own Mean/Variance inputs, so the bn reading them is no consumer
        side = [
            n
            for slot in ("MeanOut", "VarianceOut", "SavedMean",
                         "SavedVariance")
            for n in bn.outputs.get(slot, ())
            if any(c is not bn for c in usedef.consumers.get(n, ()))
        ]
        if side:
            continue
        w_name = op.inputs["Filter"][0]
        if len(usedef.consumers.get(w_name, [])) != 1:
            continue  # shared filter: folding would corrupt the other use
        names = {
            "scale": bn.inputs["Scale"][0],
            "shift": bn.inputs["Bias"][0],
            "mean": bn.inputs["Mean"][0],
            "var": bn.inputs["Variance"][0],
        }
        if not all(ctx.scope.has_var(n) for n in names.values()) or \
                not ctx.scope.has_var(w_name):
            continue
        gamma = _host_f64(ctx.scope.find_var(names["scale"]))
        beta = _host_f64(ctx.scope.find_var(names["shift"]))
        mean = _host_f64(ctx.scope.find_var(names["mean"]))
        var = _host_f64(ctx.scope.find_var(names["var"]))
        w_t = ctx.scope.find_var(w_name)
        w = _host_f64(w_t)
        eps = bn.attrs.get("epsilon", 1e-5)
        factor = gamma / np.sqrt(var + eps)  # [Cout]
        new_w = w * factor[:, None, None, None]
        if bias_add is not None:
            # only a per-channel bias (size Cout, broadcast on axis 1) can
            # fold into the BN shift
            if bias_add.attrs.get("axis", -1) != 1:
                continue
            b_name = bias_add.inputs["Y"][0]
            b = (_host_f64(ctx.scope.find_var(b_name))
                 if ctx.scope.has_var(b_name) else None)
            if b is None or b.size != mean.size:
                continue
        else:
            b = np.zeros_like(mean)
        new_b = beta + (b.reshape(-1) - mean) * factor
        w_dtype = (w_t.dtype if isinstance(w_t, torch.Tensor)
                   else torch.from_numpy(np.asarray(w_t)).dtype)
        w_device = (w_t.device if isinstance(w_t, torch.Tensor)
                    else torch.device("cpu"))
        # materialize the folded bias under a fresh persistable var
        bn_out = bn.outputs["Y"][0]
        fb_name = f"{w_name}__bn_folded_bias"
        block.create_var(
            name=fb_name, shape=[int(new_b.shape[0])],
            dtype=str(w_dtype).replace("torch.", ""), persistable=True,
        )
        ctx.scope.set(fb_name, torch.from_numpy(new_b).to(w_device, w_dtype))
        ctx.scope.set(w_name, torch.from_numpy(new_w).to(w_device, w_dtype))
        replacements[id(bn)] = Operator(
            block, "elementwise_add",
            {"X": [conv_out], "Y": [fb_name]},
            {"Out": [bn_out]},
            {"axis": 1},
        )
        if bias_add is not None:
            drop.add(id(bias_add))
        fused += 1
    if not fused:
        ctx.stats["conv_bn_fuse"] = {"fused": 0}
        return program
    new_ops = []
    for op in block.ops:
        if id(op) in replacements:
            new_ops.append(replacements[id(op)])
        elif id(op) not in drop:
            new_ops.append(op)
    block.ops = new_ops
    program._bump_version()
    ctx.stats["conv_bn_fuse"] = {"fused": fused}
    return program


def _sdpa_bias(block, usedef, add, new_ops):
    """The ``[B, S]`` key bias for sdpa from the additive ``[B, 1, 1, S]``
    one: its pre-reshape source when there is one, else a flattening
    ``reshape`` appended to ``new_ops``. None when the bias has another
    form (a raw 2-D add would broadcast as trailing [S_q, S_k], a
    relative-position bias: different math)."""
    bias_name = add.inputs["Y"][0]
    bv = block._find_var_recursive(bias_name)
    if bv is None or bv.shape is None:
        return None
    bshape = list(bv.shape)
    if not (len(bshape) == 4 and bshape[1] == 1 and bshape[2] == 1):
        return None
    bprod = usedef.producers.get(bias_name, [])
    if len(bprod) == 1 and bprod[0].type in ("reshape2", "reshape"):
        cand = bprod[0].inputs["X"][0]
        cv = block._find_var_recursive(cand)
        if cv is not None and cv.shape is not None and len(cv.shape) == 2:
            return cand
    flat = f"{bias_name}__sdpa_flat"
    block.create_var(name=flat, shape=[bshape[0], bshape[3]], dtype=bv.dtype)
    new_ops.append(Operator(
        block, "reshape",
        {"X": [bias_name]}, {"Out": [flat]},
        {"shape": [0, int(bshape[3])]
         if bshape[3] and bshape[3] > 0 else [0, -1]},
    ))
    return flat


@register_pass("multihead_matmul_fuse")
def _multihead_fuse_pass(program, ctx):
    """Collapse the unfused attention core — matmul(qk^T, alpha)
    [+ additive bias] -> softmax [-> test-mode dropout] -> matmul(pv) —
    into one scaled_dot_product_attention op, which the hand-written flash
    kernel K1 serves (reference: paddle/fluid/framework/ir/
    multihead_matmul_fuse_pass.cc:1)."""
    block = program.global_block()
    usedef = build_usedef(block, ctx.fetch_names)
    drop = set()
    rewrites = {}  # id(pv matmul) -> list of replacement Operators
    fused = 0
    for sm in block.ops:
        if sm.type != "softmax" or id(sm) in drop:
            continue
        if sm.attrs.get("axis", -1) not in (-1, 3):
            continue
        prod = usedef.producers.get(sm.inputs["X"][0], [])
        if len(prod) != 1:
            continue
        add = None
        qk = prod[0]
        if qk.type == "elementwise_add":
            add = qk
            p2 = usedef.producers.get(add.inputs["X"][0], [])
            if len(p2) != 1:
                continue
            qk = p2[0]
            if usedef.sole_consumer(qk.outputs["Out"][0], add) is None:
                continue
        if qk.type != "matmul" or not qk.attrs.get("transpose_Y"):
            continue
        if qk.attrs.get("transpose_X"):
            continue
        if usedef.sole_consumer((add or qk).outputs["Out"][0], sm) is None:
            continue
        q_name = qk.inputs["X"][0]
        k_name = qk.inputs["Y"][0]
        qv = block._find_var_recursive(q_name)
        if qv is None or qv.shape is None or len(qv.shape) != 4:
            continue  # [B, H, S, D] attention only
        # downstream: softmax -> (dropout) -> matmul(p, v)
        pv = usedef.sole_consumer(sm.outputs["Out"][0])
        dropout = None
        if pv is not None and pv.type == "dropout":
            impl = pv.attrs.get(
                "dropout_implementation", "downgrade_in_infer"
            )
            identity = pv.attrs.get("is_test") and (
                impl == "upscale_in_train"
                or not pv.attrs.get("dropout_prob", 0.0)
            )
            if not identity:
                continue
            # dropping the op must not orphan a live Mask reader
            if any(
                usedef.consumers.get(n)
                for n in pv.outputs.get("Mask", ())
            ) or any(n in usedef.protected
                     for n in pv.outputs.get("Mask", ())):
                continue
            dropout = pv
            pv = usedef.sole_consumer(dropout.outputs["Out"][0])
        if (
            pv is None
            or pv.type != "matmul"
            or pv.attrs.get("transpose_X")
            or pv.attrs.get("transpose_Y")
            or pv.attrs.get("alpha", 1.0) != 1.0
        ):
            continue
        if pv.inputs["X"][0] != (dropout or sm).outputs["Out"][0]:
            continue
        new_ops = []
        sdpa_ins = {"Q": [q_name], "K": [k_name], "V": [pv.inputs["Y"][0]]}
        if add is not None:
            src = _sdpa_bias(block, usedef, add, new_ops)
            if src is None:
                continue
            sdpa_ins["Bias"] = [src]
        new_ops.append(Operator(
            block, "scaled_dot_product_attention",
            sdpa_ins,
            {"Out": [pv.outputs["Out"][0]]},
            {"sm_scale": qk.attrs.get("alpha", 1.0) or 1.0},
        ))
        # insert at the PV matmul's position — the LAST op of the matched
        # pattern dominates every pattern input (V's producer may sit
        # between the QK matmul and the PV matmul in program order)
        rewrites[id(pv)] = new_ops
        drop.update(
            id(o) for o in (qk, add, sm, dropout) if o is not None
        )
        fused += 1
    if not fused:
        ctx.stats["multihead_matmul_fuse"] = {"fused": 0}
        return program
    out_ops = []
    for op in block.ops:
        if id(op) in rewrites:
            out_ops.extend(rewrites[id(op)])
        elif id(op) not in drop:
            out_ops.append(op)
    block.ops = out_ops
    program._bump_version()
    ctx.stats["multihead_matmul_fuse"] = {"fused": fused}
    return program
