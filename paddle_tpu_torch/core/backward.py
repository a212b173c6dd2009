"""Tape-free autodiff by program rewriting.

The same architecture as the JAX package's ``core/backward.py`` and the
reference's append_backward (reference: python/paddle/fluid/backward.py:1139
— walk forward ops in reverse, emit grad OpDescs, sum-aggregate repeated
gradients :361): ``append_backward`` emits the same grad ops, var names and
attributes as the JAX package's, so both packages build the same training
program.

The grad op of a forward op without a hand-written grad (``register_grad``)
is synthesized from its forward lowering: the generic grad lowering reruns
that lowering on detached copies of its inputs under
``torch.enable_grad()`` and calls ``torch.autograd.grad`` with the op's
output grads as cotangents. It differentiates the SAME lowering the forward
ran (the kernel lowering when the op has one), so an op whose kernel
wrapper is a ``torch.autograd.Function`` (flash attention) reaches that
Function's backward kernels. Eager PyTorch has no XLA to CSE the rerun
forward against the forward pass, so each grad op recomputes its op's
forward: the cost of a generic first slice.

Grad op calling convention (desc-level):
  type:    f"{fwd_type}_grad"
  inputs:  every forward input slot, every forward output slot, plus
           f"{out_slot}@GRAD" per forward output slot that has a gradient
  outputs: f"{in_slot}@GRAD" per forward input slot needing a gradient
  attrs:   forward attrs + __fwd_inputs__/__fwd_outputs__ slot lists
"""

import torch

from paddle_tpu_torch.core.ir import Parameter
from paddle_tpu_torch.core.registry import OpDef, OpRegistry
from paddle_tpu_torch.utils.enforce import EnforceError, enforce

_OP_ROLE_FORWARD = 0
_OP_ROLE_BACKWARD = 1
_OP_ROLE_OPTIMIZE = 2
_OP_ROLE_LOSS = 256

#: run-time context the executor passes to stateful/creating ops: a
#: stateful op's grad gets its forward's key (the grad op carries the
#: forward's ``__rng_id__``) and counter block, so a rerun forward draws
#: the same bits, as the JAX package's generic grad passes
#: ``__rng_key__`` to its vjp
_CONTEXT_SLOTS = ("__rng_key__", "__rng_block__", "__device__")


# ---------------------------------------------------------------------------
# generic grad lowering via torch.autograd
# ---------------------------------------------------------------------------


def make_generic_grad_lowering(base):
    """Differentiate ``base``'s lowering (``base.lowering()``: the kernel
    lowering when it has one) with ``torch.autograd.grad``."""

    def lower(ins, attrs):
        fwd_in_slots = [s for s in attrs["__fwd_inputs__"] if s in ins]
        fwd_out_slots = attrs["__fwd_outputs__"]
        fwd_ins = {s: ins[s] for s in fwd_in_slots}
        # a slot participates if ANY member is floating; non-float members
        # get zero grads, so the emitted @GRAD list stays aligned with the
        # forward member list. The executor names the slots the grad op
        # emits (``__grad_outputs__``): eager autograd computes every leaf's
        # grad, so a slot no op reads is not made a leaf
        wanted = attrs.get("__grad_outputs__")
        diff_slots = [
            s for s in fwd_in_slots
            if s not in base.nondiff_inputs
            and (wanted is None or f"{s}@GRAD" in wanted)
            and any(x.is_floating_point() for x in fwd_ins[s])
        ]
        if not diff_slots:
            return {}
        clean_attrs = {k: v for k, v in attrs.items() if not k.startswith("__")}
        with torch.enable_grad():
            full = {s: list(vals) for s, vals in fwd_ins.items()}
            leaves = []
            for s in diff_slots:
                for i, x in enumerate(full[s]):
                    if x.is_floating_point():
                        full[s][i] = x.detach().requires_grad_()
                        leaves.append(full[s][i])
            for s in _CONTEXT_SLOTS:
                if s in ins:
                    full[s] = ins[s]
            outs = base.lowering()(full, clean_attrs)
            primals, cotangents = [], []
            for s in fwd_out_slots:
                given = ins.get(f"{s}@GRAD")
                if not given:
                    continue
                for p, g in zip(outs.get(s, ()), given):
                    # an output no leaf reaches (XShape, an integer output)
                    # has a zero grad contribution
                    if g is not None and p is not None and p.requires_grad:
                        primals.append(p)
                        cotangents.append(g.to(p.dtype))
            grads = (torch.autograd.grad(primals, leaves, cotangents,
                                         allow_unused=True)
                     if primals else [None] * len(leaves))
        it = iter(grads)
        result = {}
        for s in diff_slots:
            gs = []
            for x in fwd_ins[s]:
                g = next(it) if x.is_floating_point() else None
                gs.append(torch.zeros_like(x) if g is None else g)
            result[f"{s}@GRAD"] = gs
        return result

    return lower


_GRAD_DEF_CACHE = {}


def resolve_op_def(op_type):
    """Registry lookup that lazily synthesizes ``<type>_grad`` defs."""
    if OpRegistry.has(op_type):
        return OpRegistry.get(op_type)
    if op_type.endswith("_grad"):
        cached = _GRAD_DEF_CACHE.get(op_type)
        if cached is not None:
            return cached
        base_type = op_type[: -len("_grad")]
        if OpRegistry.has(base_type):
            base = OpRegistry.get(base_type)
            lower = base.grad or make_generic_grad_lowering(base)
            gdef = OpDef(op_type, lower, stateful=base.stateful,
                         creates=base.creates, needs_block=base.needs_block)
            _GRAD_DEF_CACHE[op_type] = gdef
            return gdef
    raise EnforceError(f"op {op_type} is not registered")


# ---------------------------------------------------------------------------
# append_backward
# ---------------------------------------------------------------------------


def _requires_grad_vars(block, ops, no_grad_set, extra_seeds=()):
    """Forward propagation of the requires-grad property. `extra_seeds` are
    vars the caller wants gradients for even if they are not leaves (the
    PS fleet's pulled rows and remote lookup outputs)."""
    produced = {n for op in ops for n in op.output_names()}
    requires = set(extra_seeds)
    for v in block.vars.values():
        if v.name in no_grad_set:
            continue
        if isinstance(v, Parameter) and v.trainable:
            requires.add(v.name)
        elif not v.stop_gradient and v.name not in produced:
            # leaf inputs explicitly marked differentiable
            requires.add(v.name)
    for op in ops:
        if any(n in requires for n in op.input_names()):
            for n in op.output_names():
                v = block._find_var_recursive(n)
                if n in no_grad_set or (v is not None and v.stop_gradient):
                    continue
                requires.add(n)
    return requires


def _create_grad_var(block, fwd_name, grad_name):
    if grad_name in block.vars:
        return block.vars[grad_name]
    fwd = block._find_var_recursive(fwd_name)
    return block.create_var(
        name=grad_name,
        shape=fwd.shape if fwd is not None else None,
        dtype=fwd.dtype if fwd is not None else "float32",
        persistable=False,
        stop_gradient=True,
    )


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    extra_seeds=()):
    """Append grad ops for ``loss`` to its program; returns
    ``[(param, grad)]`` (reference: python/paddle/fluid/backward.py:1139).
    ``extra_seeds`` names vars whose ``@GRAD`` is finalized too, as in the
    JAX package (``fleet/parameter_server.py`` seeds each PS table's rows
    feed and each remote lookup's output).

    Recompute segments (``program._recompute_checkpoints``) are not
    ported yet (ROADMAP M8)."""
    block = loss.block
    program = block.program
    if getattr(program, "_recompute_checkpoints", None):
        raise NotImplementedError(
            "recompute segments are not ported yet (ROADMAP M8)")
    no_grad_set = set(no_grad_set or ())
    enforce(
        loss.shape is None or all(d == 1 or d == -1 for d in loss.shape),
        f"loss must be scalar-like, got shape {loss.shape}",
    )

    fwd_ops = list(block.ops)
    # find the op producing the loss; everything after it is irrelevant
    loss_op_idx = None
    for i in reversed(range(len(fwd_ops))):
        if loss.name in fwd_ops[i].output_names():
            loss_op_idx = i
            break
    enforce(loss_op_idx is not None, f"loss var {loss.name} has no producer op")
    fwd_ops = fwd_ops[: loss_op_idx + 1]
    if fwd_ops:
        fwd_ops[-1].attrs["op_role"] = _OP_ROLE_LOSS

    requires = _requires_grad_vars(block, fwd_ops, no_grad_set, extra_seeds)

    # relevance: ops on a path from requires-grad vars to the loss
    pending = {loss.name}
    relevant = []
    for op in reversed(fwd_ops):
        if op.type in ("feed", "fetch"):
            continue
        if any(n in pending for n in op.output_names()) and any(
            n in requires for n in op.input_names()
        ):
            relevant.append(op)
            pending.update(n for n in op.input_names() if n in requires)
    relevant_set = set(id(op) for op in relevant)

    # partial-gradient bookkeeping: var -> list of partial grad var names
    partials = {}

    def finalize(name):
        """Collapse partial grads for ``name`` into the canonical
        ``name@GRAD``, inserting a sum op when there are multiple
        contributions (reference: python/paddle/fluid/backward.py:361)."""
        canonical = name + "@GRAD"
        plist = partials.get(name)
        if not plist:
            return None
        if len(plist) == 1:
            if plist[0] != canonical:
                _create_grad_var(block, name, canonical)
                block.append_op(
                    "assign",
                    inputs={"X": [plist[0]]},
                    outputs={"Out": [canonical]},
                    attrs={"op_role": _OP_ROLE_BACKWARD},
                )
            partials[name] = [canonical]
            return canonical
        _create_grad_var(block, name, canonical)
        block.append_op(
            "sum",
            inputs={"X": list(plist)},
            outputs={"Out": [canonical]},
            attrs={"op_role": _OP_ROLE_BACKWARD},
        )
        partials[name] = [canonical]
        return canonical

    def add_partial(name):
        canonical = name + "@GRAD"
        existing = partials.setdefault(name, [])
        pname = canonical if not existing else f"{name}@GRAD@RENAME@{len(existing)}"
        existing.append(pname)
        _create_grad_var(block, name, pname)
        return pname

    # seed: d loss / d loss = 1
    loss_grad_name = loss.name + "@GRAD"
    _create_grad_var(block, loss.name, loss_grad_name)
    block.append_op(
        "fill_constant",
        inputs={},
        outputs={"Out": [loss_grad_name]},
        attrs={
            "shape": list(loss.shape) if loss.shape else [1],
            "dtype": loss.dtype,
            "value": 1.0,
            "op_role": _OP_ROLE_BACKWARD,
        },
    )
    partials[loss.name] = [loss_grad_name]

    walk_ops = [op for op in fwd_ops if id(op) in relevant_set]
    for op in reversed(walk_ops):
        # outputs' grads must be finalized before this op's grad runs
        out_grad_slots = {}
        has_any = False
        for slot, names in op.outputs.items():
            gnames = []
            for n in names:
                g = finalize(n)
                gnames.append(g)
                if g is not None:
                    has_any = True
            out_grad_slots[slot] = gnames
        if not has_any:
            continue
        grad_inputs = {}
        for slot, names in op.inputs.items():
            grad_inputs[slot] = list(names)
        for slot, names in op.outputs.items():
            grad_inputs[slot] = list(names)
            gnames = out_grad_slots[slot]
            if any(g is not None for g in gnames):
                filled = []
                for i, g in enumerate(gnames):
                    if g is None:
                        # zero-fill grads for unused sibling outputs so the
                        # slot stays well-formed in the desc
                        zname = f"{names[i]}@GRAD@ZERO"
                        _create_grad_var(block, names[i], zname)
                        block.append_op(
                            "fill_zeros_like",
                            inputs={"X": [names[i]]},
                            outputs={"Out": [zname]},
                            attrs={"op_role": _OP_ROLE_BACKWARD},
                        )
                        filled.append(zname)
                    else:
                        filled.append(g)
                grad_inputs[f"{slot}@GRAD"] = filled
        grad_outputs = {}
        for slot, names in op.inputs.items():
            gnames = []
            for n in names:
                v = block._find_var_recursive(n)
                if (
                    n in requires
                    and n not in no_grad_set
                    and not (v is not None and v.stop_gradient
                             and not isinstance(v, Parameter))
                ):
                    gnames.append(add_partial(n))
                else:
                    gnames.append(None)
            if any(g is not None for g in gnames):
                grad_outputs[f"{slot}@GRAD"] = [
                    g if g is not None else f"{names[i]}@GRAD@UNUSED"
                    for i, g in enumerate(gnames)
                ]
                for i, g in enumerate(gnames):
                    if g is None:
                        _create_grad_var(block, names[i], f"{names[i]}@GRAD@UNUSED")
        if not grad_outputs:
            continue
        grad_attrs = {k: v for k, v in op.attrs.items() if k != "op_callstack"}
        grad_attrs["__fwd_inputs__"] = list(op.inputs.keys())
        grad_attrs["__fwd_outputs__"] = list(op.outputs.keys())
        grad_attrs["op_role"] = _OP_ROLE_BACKWARD
        block.append_op(
            f"{op.type}_grad",
            inputs=grad_inputs,
            outputs=grad_outputs,
            attrs=grad_attrs,
        )

    for name in extra_seeds:
        finalize(name)

    # finalize any leaf grads never finalized (params consumed once)
    params_and_grads = []
    if parameter_list is not None:
        params = [
            block._find_var_recursive(p) if isinstance(p, str) else p
            for p in parameter_list
        ]
    else:
        params = [
            v for v in program.global_block().vars.values()
            if isinstance(v, Parameter) and v.trainable
        ]
    for p in params:
        if p.name in no_grad_set:
            continue
        g = finalize(p.name)
        if g is not None:
            params_and_grads.append((p, block.vars[g]))
    return params_and_grads
