"""Program rewrites: the two sparse-update fusions of the JAX package's
``passes.py`` and their deferred execution-time hooks.

Each rewrite mutates the program in place and returns how many updates it
fused. Producer/consumer reasoning goes through ``analysis/usedef.py``.
``Executor.run`` calls ``apply_deferred_sparse_rewrite`` and
``apply_deferred_sharded_embedding_rewrite`` before it plans a program,
as the JAX executor does before it compiles one, so the rewrites see the
final op list (backward and optimizer present). The JAX package's pass
registry and its other passes are not ported (ROADMAP M12)."""

from paddle_tpu_torch.analysis.usedef import build_usedef
from paddle_tpu_torch.core.ir import Operator
from paddle_tpu_torch.utils.enforce import EnforceError

__all__ = [
    "sparse_weight_update",
    "sharded_embedding_update",
    "apply_deferred_sparse_rewrite",
    "apply_deferred_sharded_embedding_rewrite",
]


def sparse_weight_update(program):
    """Fuse lookup_table*_grad + sgd into a row-sparse sgd_sparse update —
    the SelectedRows analog for the dense path (reference:
    paddle/fluid/framework/selected_rows.h:32; operators/optimizers/
    sgd_op.h sparse branch). The [V, D] dense gradient never materializes.
    Applies only where the dense grad has exactly one producer (the lookup
    grad) and one consumer (the sgd) — grad clip, regularizers, or
    multi-use embeddings keep the dense form."""
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
        return 0

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
    return len(rewrites)


def sharded_embedding_update(program):
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
        return 0
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
    return len(rewrites)


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
    sharded_embedding_update(program)


def apply_deferred_sparse_rewrite(program):
    """Execution-time hook: ``SGDOptimizer.minimize`` marks the program
    instead of rewriting it; the executor calls this before planning it.
    (The JAX package also skips it for a microbatched program; the port
    has no pipeline optimizer yet.)"""
    if not getattr(program, "_wants_sparse_embedding", False):
        return
    program._wants_sparse_embedding = False
    sparse_weight_update(program)
