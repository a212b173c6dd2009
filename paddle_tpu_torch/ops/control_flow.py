"""Control-flow ops, with the semantics of the JAX package's
``ops/control_flow.py``: ``while`` and ``conditional_block`` run their
sub-blocks, and the helpers ``increment`` and ``less_than_scalar``.

The JAX package lowers a sub-block to ``lax.while_loop`` / ``lax.cond``
inside the step's XLA computation. The port runs programs eagerly, so a
``while`` is a host loop over its sub-block's plan that reads its
condition on the host once an iteration (one device sync each), and a
``conditional_block`` reads its predicate once and runs one branch.

Carried state follows the JAX package's ``_sub_block_rw``: every
variable the sub-block writes that already has a value before the op
(in the run's env or the scope) is carried; the sub-block's other
writes are temporaries, gone after each iteration and after the loop.
Iteration ``i`` of a loop runs its stateful ops on ``fold_in(run key,
i)``, as the JAX body folds its counter; a branch runs on the run key.
The executor (``core/executor.py``) dispatches the ops here with
``run_block(block, env, key)``, which runs a block's plan over ``env``,
and ``value(name, env)``, which finds a name's value before the op, or
None.
"""

import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import first
from paddle_tpu_torch.utils.enforce import EnforceError

#: op types the executor runs over their sub-blocks
CONTROL_FLOW_OPS = frozenset({"while", "conditional_block"})


def sub_block_rw(sub):
    """(names written, names read) by ``sub``'s ops, in first-seen order."""
    written, read = [], []
    seen_w, seen_r = set(), set()
    for sop in sub.ops:
        for n in sop.input_names():
            if n not in seen_r:
                read.append(n)
                seen_r.add(n)
        for n in sop.output_names():
            if n not in seen_w:
                written.append(n)
                seen_w.add(n)
    return written, read


def _truth(t):
    """A one-element predicate's value on the host (a sync on the card)."""
    return bool(t.reshape(()).item())


def run_control_flow_op(op, block, env, run_key, run_block, value):
    if op.type == "while":
        _run_while(op, block, env, run_key, run_block, value)
    elif op.type == "conditional_block":
        _run_cond(op, block, env, run_key, run_block, value)
    else:
        raise EnforceError(f"unhandled control-flow op {op.type}")


def _run_while(op, block, env, run_key, run_block, value):
    sub = block.program.block(op.attrs["sub_block"])
    cond_name = op.inputs["Condition"][0]
    written, _ = sub_block_rw(sub)
    state = {}
    for n in dict.fromkeys([cond_name] + written):
        v = value(n, env)
        if v is not None:
            state[n] = v
    it = 0
    while _truth(state[cond_name]):
        local = dict(env)
        local.update(state)
        run_block(sub, local, prng.fold_in(run_key, it))
        state = {n: local[n] for n in state}
        it += 1
    env.update(state)


def _run_cond(op, block, env, run_key, run_block, value):
    """Two-armed conditional: attrs ``sub_block`` (true) and optionally
    ``sub_block_false``; outputs listed in ``op.outputs['Out']``."""
    out_names = op.outputs.get("Out", [])
    false_idx = op.attrs.get("sub_block_false", -1)
    before = {n: value(n, env) for n in out_names}
    if false_idx < 0:
        missing = [n for n, v in before.items() if v is None]
        if missing:
            raise EnforceError(
                f"conditional_block outputs {missing} have no value when the "
                f"condition is false — provide a false branch (false_fn) that "
                f"produces them, or initialize the vars before the cond"
            )
    pred = value(op.inputs["Cond"][0], env)
    if _truth(pred):
        idx = op.attrs["sub_block"]
    elif false_idx >= 0:
        idx = false_idx
    else:
        env.update(before)
        return
    local = dict(env)
    run_block(block.program.block(idx), local, run_key)
    for n in out_names:
        env[n] = local[n]


# -- small helper ops used by loop constructs -------------------------------


@register_op("increment")
def _increment(ins, attrs):
    x = first(ins, "X")
    return {"Out": [x + torch.tensor(attrs.get("step", 1.0), dtype=x.dtype,
                                     device=x.device)]}


@register_op("less_than_scalar")
def _less_than_scalar(ins, attrs):
    return {"Out": [first(ins, "X") < attrs["value"]]}
