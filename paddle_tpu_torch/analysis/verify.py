"""Program verifier: structured well-formedness diagnostics over a Program,
copied from the JAX package's ``analysis/verify.py``.

``verify_program`` walks the IR and returns structured ``Diagnostic``s;
``io.save_inference_model`` runs it on the pruned program before it
writes anything.

Checked invariants:
  * use-before-def   — an op reads a var no earlier op produced and that is
                       neither persistable, a declared feed (is_data), nor an
                       explicit feed name. Control-flow sub-blocks are walked
                       with the defined-set at their op's position.
  * dangling-var     — an op names a var not declared in the block chain.
  * dtype/rank       — declared var metadata violates the op's static
                       signature (``analysis/signatures.py``).
  * unknown-op       — op type with no registered lowering (and no
                       synthesizable ``*_grad`` base, see core/backward.py).
  * shadowed-var     — a sub-block declares a var name an ancestor also
                       declares (legal but almost always a rewrite bug).
  * sub-blocks       — sub_block attrs must reference existing blocks;
                       unreachable non-root blocks are reported.

The JAX package's optional sharding check (``mesh=``) needs its
``parallel/sharding.py``, which the port does not have yet (ROADMAP M11):
passing ``mesh=`` raises ``NotImplementedError``.

Severity is "error" for invariants whose violation breaks execution and
"warning" for suspicious-but-runnable shapes. A verifier must never flag a
well-formed program: anything uncertain is a warning or unchecked.
"""

from paddle_tpu_torch.analysis.signatures import get_signature

__all__ = ["Diagnostic", "verify_program"]

#: op types executed structurally by the interpreter, not via the registry
_STRUCTURAL_OPS = frozenset({"while", "conditional_block", "feed", "fetch"})

#: sub-blocks whose reads resolve through op-private state the IR doesn't
#: express (StaticRNN memories; pipeline_stack binds its stage body's
#: inputs from the stacked tensors at run time) — use-before-def is not
#: decidable there
_OPAQUE_SUB_BLOCK_OPS = frozenset(
    {"recurrent", "recurrent_grad", "pipeline_stack", "pipeline_stack_grad"}
)

#: op attrs that hold a sub-block index (while/conditional_block/recurrent)
_SUB_BLOCK_ATTRS = ("sub_block", "sub_block_false")


def sub_block_indices(op):
    """Sub-block indices referenced by ``op``'s attrs (skips -1 sentinels)."""
    out = []
    for attr in _SUB_BLOCK_ATTRS:
        idx = op.attrs.get(attr)
        if idx is not None and idx >= 0:
            out.append(idx)
    return out


class Diagnostic:
    """One verifier finding, with op attribution for error surfacing."""

    def __init__(self, severity, code, message, block_idx=None, op_index=None,
                 op_type=None, var=None, callstack=None):
        self.severity = severity  # "error" | "warning"
        self.code = code
        self.message = message
        self.block_idx = block_idx
        self.op_index = op_index
        self.op_type = op_type
        self.var = var
        self.callstack = callstack

    def __repr__(self):
        return f"Diagnostic({self.severity}, {self.code}, {self.message!r})"

    def __str__(self):
        loc = []
        if self.block_idx is not None:
            loc.append(f"block {self.block_idx}")
        if self.op_index is not None:
            loc.append(f"op #{self.op_index}")
        if self.op_type:
            loc.append(f"<{self.op_type}>")
        head = f"[{self.severity}] {self.code}: {self.message}"
        if loc:
            head += f"  ({', '.join(loc)})"
        if self.callstack:
            head += "\n  [user callstack]\n" + "".join(
                "  " + line for line in self.callstack
            )
        return head


def _diag(diags, severity, code, message, block=None, op_index=None, op=None,
          var=None):
    diags.append(Diagnostic(
        severity, code, message,
        block_idx=block.idx if block is not None else None,
        op_index=op_index,
        op_type=op.type if op is not None else None,
        var=var,
        callstack=op.attrs.get("op_callstack") if op is not None else None,
    ))


def _op_resolvable(op_type):
    from paddle_tpu_torch.core.registry import OpRegistry

    if op_type in _STRUCTURAL_OPS or OpRegistry.has(op_type):
        return True
    if op_type.endswith("_grad"):
        # core/backward.py synthesizes grad defs from the base lowering
        return OpRegistry.has(op_type[: -len("_grad")])
    return False


def _declared_dtype(block, name):
    v = block._find_var_recursive(name)
    return None if v is None or v.dtype is None else str(v.dtype)


def _check_signature(block, op, op_index, diags):
    sig = get_signature(op.type)
    if sig is None:
        return
    for group in sig.same_dtype:
        seen = {}
        for slot in group:
            for n in op.inputs.get(slot, []) + op.outputs.get(slot, []):
                dt = _declared_dtype(block, n)
                if dt is not None:
                    seen.setdefault(dt, n)
        if len(seen) > 1:
            pairs = ", ".join(f"{n}:{dt}" for dt, n in sorted(seen.items()))
            _diag(diags, "error", "dtype-mismatch",
                  f"op '{op.type}' requires one dtype across slots "
                  f"{'/'.join(group)}, got {pairs}",
                  block=block, op_index=op_index, op=op,
                  var=next(iter(seen.values())))
    for slot, want in sig.ranks.items():
        want_set = want if isinstance(want, tuple) else (want,)
        for n in op.inputs.get(slot, []) + op.outputs.get(slot, []):
            v = block._find_var_recursive(n)
            if v is None or v.shape is None:
                continue
            if len(v.shape) not in want_set:
                _diag(diags, "error", "rank-mismatch",
                      f"op '{op.type}' slot {slot} expects rank "
                      f"{'/'.join(map(str, want_set))}, var '{n}' has shape "
                      f"{list(v.shape)}",
                      block=block, op_index=op_index, op=op, var=n)
    for slot, family in sig.dtype_family.items():
        for n in op.inputs.get(slot, []) + op.outputs.get(slot, []):
            dt = _declared_dtype(block, n)
            if dt is not None and not dt.startswith(family):
                _diag(diags, "error", "dtype-mismatch",
                      f"op '{op.type}' slot {slot} expects a {family} dtype, "
                      f"var '{n}' is {dt}",
                      block=block, op_index=op_index, op=op, var=n)


def _ancestor_declares(block, name):
    b = block.parent_block
    while b is not None:
        if name in b.vars:
            return b
        b = b.parent_block
    return None


def _walk_block(program, block, defined, feed_names, diags,
                check_defs=True, _path=frozenset()):
    """Verify one block's ops in order; `defined` is the set of names known
    to hold values when the block starts executing (mutated as ops produce).
    Sub-blocks are walked at their control-flow op's position with a COPY of
    the defined-set — their writes escape only through the op's own outputs
    (loop carry re-writes already-defined names). `_path` carries the block
    indices on the current recursion path so a cyclic sub_block reference
    becomes a diagnostic, not a RecursionError."""
    for name in block.vars:
        if block.idx != 0 and _ancestor_declares(block, name) is not None:
            _diag(diags, "warning", "shadowed-var",
                  f"sub-block {block.idx} declares '{name}' which an "
                  f"enclosing block also declares", block=block, var=name)
    for op_index, op in enumerate(block.ops):
        if op.type in ("feed", "fetch"):
            continue
        if not _op_resolvable(op.type):
            _diag(diags, "error", "unknown-op",
                  f"op type '{op.type}' has no registered lowering",
                  block=block, op_index=op_index, op=op)
        for name in op.input_names():
            v = block._find_var_recursive(name)
            if v is None:
                _diag(diags, "error", "dangling-input",
                      f"op '{op.type}' reads '{name}' which is not declared "
                      f"in block {block.idx} or its ancestors",
                      block=block, op_index=op_index, op=op, var=name)
                continue
            if (
                check_defs
                and name not in defined
                and not v.persistable
                and not v.is_data
                and name not in feed_names
            ):
                _diag(diags, "error", "use-before-def",
                      f"op '{op.type}' reads '{name}' before any op produces "
                      f"it (not persistable, not a feed)",
                      block=block, op_index=op_index, op=op, var=name)
        for idx in sub_block_indices(op):
            if idx >= program.num_blocks():
                _diag(diags, "error", "bad-sub-block",
                      f"op '{op.type}' references sub-block {idx} but the "
                      f"program has {program.num_blocks()} blocks",
                      block=block, op_index=op_index, op=op)
                continue
            if idx == block.idx or idx in _path:
                _diag(diags, "error", "bad-sub-block",
                      f"op '{op.type}' references sub-block {idx} which is "
                      f"already on the enclosing block path — cyclic "
                      f"control flow",
                      block=block, op_index=op_index, op=op)
                continue
            _walk_block(
                program, program.block(idx), set(defined), feed_names, diags,
                check_defs=check_defs
                and op.type not in _OPAQUE_SUB_BLOCK_OPS,
                _path=_path | {block.idx},
            )
        for name in op.output_names():
            if block._find_var_recursive(name) is None:
                _diag(diags, "error", "dangling-output",
                      f"op '{op.type}' writes '{name}' which is not declared "
                      f"in block {block.idx} or its ancestors",
                      block=block, op_index=op_index, op=op, var=name)
            defined.add(name)
        _check_signature(block, op, op_index, diags)


def _check_block_graph(program, diags):
    reachable = {0}
    for b in program.blocks:
        for op in b.ops:
            for idx in sub_block_indices(op):
                if idx < program.num_blocks():
                    reachable.add(idx)
    for b in program.blocks:
        if b.idx not in reachable:
            _diag(diags, "warning", "orphaned-sub-block",
                  f"block {b.idx} is not referenced by any control-flow op",
                  block=b)


def verify_program(program, feed_names=(), fetch_names=(), mesh=None):
    """Run all verifier checks over `program`; returns a list of Diagnostics
    (errors first). `feed_names` supplements vars marked is_data as the
    block-0 inputs assumed present. The sharding-spec check (`mesh`) is
    not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "verify_program(mesh=...): the sharding-spec check needs "
            "parallel/sharding.py, not ported yet (ROADMAP M11)")
    diags = []
    feed_names = set(feed_names)
    _check_block_graph(program, diags)
    # parent chains must strictly decrease (blocks are created parent-first)
    # — var lookup walks them unboundedly, so a cyclic chain would hang
    # every later check; report and stop at the structural level instead
    chain_ok = True
    for b in program.blocks:
        want_ok = b.parent_idx < 0 if b.idx == 0 else \
            0 <= b.parent_idx < b.idx
        if not want_ok:
            _diag(diags, "error", "bad-block-parent",
                  f"block {b.idx} has parent_idx {b.parent_idx} — parent "
                  f"indices must be earlier blocks (cycle-free chain)",
                  block=b)
            chain_ok = False
    if not chain_ok:
        diags.sort(key=lambda d: 0 if d.severity == "error" else 1)
        return diags
    defined = set(feed_names)
    _walk_block(program, program.global_block(), defined, feed_names, diags)

    # fetches must exist somewhere in the program
    declared = {n for b in program.blocks for n in b.vars}
    for name in fetch_names:
        if name not in declared:
            _diag(diags, "error", "dangling-fetch",
                  f"fetch target '{name}' is not declared in the program",
                  block=program.global_block(), var=name)

    diags.sort(key=lambda d: 0 if d.severity == "error" else 1)
    return diags
