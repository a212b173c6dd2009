"""Dygraph-to-static AST transforms for data-dependent `if` and loops: a
copy of the JAX package's ``dygraph/ast_transform.py``, which is pure
Python (the port keeps its own copy and imports nothing of that package).

reference: python/paddle/fluid/dygraph/dygraph_to_static/ast_transformer.py
(IfElseTransformer) and loop_transformer.py (LoopTransformer) — the
reference rewrites Python `if` on tensors into layers.cond sub-blocks and
`while`/`for` into layers.While. The forms here:

* `if`: the rewritten statement evaluates BOTH branches and selects per
  returned tensor with the `where` op, which needs no sub-block machinery
  under trace capture. Eager calls keep plain Python branching.
* `while` / `for i in range(...)`: carried variables (names assigned in the
  body) become explicit cond/body function parameters; at run time a
  concrete condition keeps the plain Python loop (eager mode, or constant
  trip counts under capture — unrolled exactly as before), while a symbolic
  condition under capture builds a `while` op sub-block (which the
  executor runs as a host loop, ops/control_flow.py) with the carried
  names written back each iteration.

Contract (documented limits, loud failures otherwise):
- both `if` branches run under trace: side-effecting branches (py_func,
  prints, state write-backs) are NOT eligible;
- variables must be assignable by simple names; `return` inside a
  transformed `if`, and `break`/`continue`/`return` inside a transformed
  loop body, are rejected at transform time (those loops stay plain
  Python: static trip counts still work, data-dependent ones hit the loud
  capture guard);
- loop-carried variables must hold tensor values (or numbers promotable
  to tensors); state read before its in-body assignment must be assigned
  BEFORE the loop (write-before-read temps — e.g. a nested loop's counter
  — get a synthesized zero init from their traced shape);
- `for x in <tensor>` iteration is not converted (use layers.while_loop or
  index with a range loop);
- after a ZERO-trip converted `for`, the loop variable holds `start`
  (CPython leaves it unbound/stale) — carried state needs an init value;
  likewise a write-before-read body temp (synthesized zero init) reads as
  ZEROS after a zero-trip `while` where CPython would raise NameError —
  trip counts are run-time values, so the divergence cannot be detected
  at trace time.
"""

import ast
import inspect
import textwrap

__all__ = ["convert_ifelse", "ast_transform"]

# the port's own global keys: a module whose functions both packages
# transform keeps both packages' helpers
_HELPER = "__paddle_tpu_torch_select_if__"
_WHILE_HELPER = "__paddle_tpu_torch_while__"
_CMP_HELPER = "__paddle_tpu_torch_loop_cmp__"


def _assigned_names(stmts):
    """Simple Name targets assigned anywhere in `stmts` — at THIS function
    scope (nested def/lambda bodies have their own locals)."""
    names = []

    class V(ast.NodeVisitor):
        def visit_Assign(self, node):
            for t in node.targets:
                self._collect(t)
            self.generic_visit(node)

        def visit_AugAssign(self, node):
            self._collect(node.target)
            self.generic_visit(node)

        def visit_AnnAssign(self, node):
            self._collect(node.target)
            self.generic_visit(node)

        def visit_For(self, node):
            self._collect(node.target)
            self.generic_visit(node)

        def visit_NamedExpr(self, node):
            # walrus binds at function scope — a converted body must carry it
            self._collect(node.target)
            self.generic_visit(node)

        def visit_With(self, node):
            for item in node.items:
                if item.optional_vars is not None:
                    self._collect(item.optional_vars)
            self.generic_visit(node)

        visit_AsyncWith = visit_With

        def visit_Import(self, node):
            for a in node.names:
                if a.name == "*":
                    continue
                name = (a.asname or a.name).split(".")[0]
                if name not in names:
                    names.append(name)

        visit_ImportFrom = visit_Import

        def visit_FunctionDef(self, node):
            pass  # nested scope

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

        def _collect(self, t):
            if isinstance(t, ast.Name):
                if t.id not in names:
                    names.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    self._collect(e)
            elif isinstance(t, ast.Starred):
                self._collect(t.value)

    v = V()
    for s in stmts:
        v.visit(s)
    return names


def _has_flow_escape(stmts):
    """Control flow that would escape the `if` being converted: `return`
    at this function scope, or break/continue NOT owned by a loop inside
    the branch. Nested function defs are their own scope."""

    class V(ast.NodeVisitor):
        found = False
        loop_depth = 0

        def visit_Return(self, node):
            self.found = True

        def visit_Break(self, node):
            if self.loop_depth == 0:
                self.found = True

        visit_Continue = visit_Break

        def _loop(self, node):
            self.loop_depth += 1
            self.generic_visit(node)
            self.loop_depth -= 1

        visit_For = _loop
        visit_While = _loop
        visit_AsyncFor = _loop

        def visit_FunctionDef(self, node):
            pass  # own scope

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

    v = V()
    for s in stmts:
        v.visit(s)
    return v.found


def _has_loop_escape(stmts):
    """Constructs that cannot live inside a converted loop body: `return`,
    `break`/`continue` belonging to the loop being converted (depth 0),
    and global/nonlocal declarations (the body becomes a nested def)."""

    class V(ast.NodeVisitor):
        found = False
        loop_depth = 0

        def visit_Return(self, node):
            self.found = True

        def visit_Break(self, node):
            if self.loop_depth == 0:
                self.found = True

        visit_Continue = visit_Break

        def visit_Global(self, node):
            self.found = True

        visit_Nonlocal = visit_Global

        def _loop(self, node):
            self.loop_depth += 1
            self.generic_visit(node)
            self.loop_depth -= 1

        visit_For = _loop
        visit_While = _loop
        visit_AsyncFor = _loop

        def visit_FunctionDef(self, node):
            pass  # own scope

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

    v = V()
    for s in stmts:
        v.visit(s)
    return v.found


def _contains_named_expr(node):
    return any(isinstance(n, ast.NamedExpr) for n in ast.walk(node))


class _IfTransformer(ast.NodeTransformer):
    def __init__(self):
        self.count = 0

    # -- loops (the reference's LoopTransformer,
    #    dygraph_to_static/loop_transformer.py) -------------------------
    def _thunks(self, params):
        return ast.Tuple(
            elts=[
                ast.Lambda(
                    args=ast.arguments(posonlyargs=[], args=[],
                                       kwonlyargs=[], kw_defaults=[],
                                       defaults=[]),
                    body=ast.Name(id=x, ctx=ast.Load()),
                )
                for x in params
            ],
            ctx=ast.Load(),
        )

    def visit_While(self, node):
        self.generic_visit(node)
        if (
            node.orelse
            or _has_loop_escape(node.body)
            or _contains_named_expr(node.test)
        ):
            return node
        names = _assigned_names(node.body)
        if not names:
            # a body assigning nothing can only terminate via side
            # effects — not expressible as carried state; leave plain
            return node
        n = self.count
        self.count += 1
        cname, bname = f"__pt_wcond_{n}", f"__pt_wbody_{n}"

        def fn_args():
            return ast.arguments(
                posonlyargs=[],
                args=[ast.arg(arg=x) for x in names],
                kwonlyargs=[], kw_defaults=[], defaults=[],
            )

        ret = ast.Return(
            value=ast.Tuple(
                elts=[ast.Name(id=x, ctx=ast.Load()) for x in names],
                ctx=ast.Load(),
            )
        )
        cdef = ast.FunctionDef(
            name=cname, args=fn_args(),
            body=[ast.Return(value=node.test)], decorator_list=[],
        )
        bdef = ast.FunctionDef(
            name=bname, args=fn_args(),
            body=list(node.body) + [ret], decorator_list=[],
        )
        call = ast.Call(
            func=ast.Name(id=_WHILE_HELPER, ctx=ast.Load()),
            args=[
                ast.Name(id=cname, ctx=ast.Load()),
                ast.Name(id=bname, ctx=ast.Load()),
                self._thunks(names),
                ast.Tuple(
                    elts=[ast.Constant(value=x) for x in names],
                    ctx=ast.Load(),
                ),
            ],
            keywords=[],
        )
        assign = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=x, ctx=ast.Store()) for x in names],
                ctx=ast.Store(),
            )],
            value=call,
        )
        return [cdef, bdef, assign]

    def visit_For(self, node):
        self.generic_visit(node)
        if node.orelse or not isinstance(node.target, ast.Name):
            return node
        it = node.iter
        if not (
            isinstance(it, ast.Call)
            and isinstance(it.func, ast.Name)
            and it.func.id == "range"
            and not it.keywords
            and 1 <= len(it.args) <= 3
        ):
            return node  # non-range iteration stays plain Python
        if _has_loop_escape(node.body):
            return node
        n = self.count
        self.count += 1
        start = it.args[0] if len(it.args) >= 2 else ast.Constant(value=0)
        stop = it.args[1] if len(it.args) >= 2 else it.args[0]
        step = it.args[2] if len(it.args) == 3 else ast.Constant(value=1)
        s_start, s_stop, s_step, s_i = (
            f"__pt_start_{n}", f"__pt_stop_{n}", f"__pt_step_{n}",
            f"__pt_i_{n}",
        )
        tgt = node.target.id

        def nm(x, ctx=None):
            return ast.Name(id=x, ctx=ctx or ast.Load())

        # a PRIVATE counter advances the loop; the user's loop variable is
        # assigned FROM it each iteration, so a body that reassigns the
        # loop variable (for i in ...: i = 99) still iterates like CPython
        # and the post-loop value of the loop variable is the last body
        # value, not one-step-past. (Zero-trip loops leave the loop var at
        # `start` — the documented divergence from CPython's unbound/stale
        # name, needed because a carried var must have an initial value.)
        pre = [
            ast.Assign(targets=[nm(s_start, ast.Store())], value=start),
            ast.Assign(targets=[nm(s_stop, ast.Store())], value=stop),
            ast.Assign(targets=[nm(s_step, ast.Store())], value=step),
            ast.Assign(targets=[nm(s_i, ast.Store())], value=nm(s_start)),
            ast.Assign(targets=[nm(tgt, ast.Store())], value=nm(s_start)),
        ]
        body = (
            [ast.Assign(targets=[nm(tgt, ast.Store())], value=nm(s_i))]
            + list(node.body)
            + [
                ast.Assign(
                    targets=[nm(s_i, ast.Store())],
                    value=ast.BinOp(
                        left=nm(s_i), op=ast.Add(), right=nm(s_step)
                    ),
                )
            ]
        )
        w = ast.While(
            test=ast.Call(
                func=nm(_CMP_HELPER),
                args=[nm(s_i), nm(s_stop), nm(s_step)],
                keywords=[],
            ),
            body=body,
            orelse=[],
        )
        converted = self.visit_While(w)
        return pre + (converted if isinstance(converted, list) else [converted])

    def visit_If(self, node):
        self.generic_visit(node)  # innermost-first
        if _has_flow_escape(node.body) or _has_flow_escape(node.orelse):
            # leave THIS `if` as plain Python: static predicates still work
            # (eager bool), data-dependent ones hit the loud capture guard
            return node
        names = _assigned_names(node.body + node.orelse)
        # every assigned name becomes a helper parameter fed by a lazy
        # thunk of its current value (or an _Undefined placeholder): the
        # helpers' return tuple then never references an unbound free
        # variable, and read-before-write inside a branch sees the value
        # from before the `if` (Python closure-write rule workaround)
        params = list(names)
        n = self.count
        self.count += 1
        tname = f"__pt_true_{n}"
        fname = f"__pt_false_{n}"
        ret = ast.Return(
            value=ast.Tuple(
                elts=[ast.Name(id=x, ctx=ast.Load()) for x in names],
                ctx=ast.Load(),
            )
        )
        def fn_args():
            return ast.arguments(
                posonlyargs=[],
                args=[ast.arg(arg=x) for x in params],
                kwonlyargs=[], kw_defaults=[], defaults=[],
            )

        tdef = ast.FunctionDef(
            name=tname,
            args=fn_args(),
            body=list(node.body) + [ret],
            decorator_list=[],
        )
        fdef = ast.FunctionDef(
            name=fname,
            args=fn_args(),
            body=(list(node.orelse) + [ret]) if node.orelse else [ret],
            decorator_list=[],
        )
        # current values of read-write branch vars travel as LAZY thunks:
        # a default argument would evaluate at def time and explode when
        # the name is only assigned inside the `if` itself
        thunks = ast.Tuple(
            elts=[
                ast.Lambda(
                    args=ast.arguments(posonlyargs=[], args=[],
                                       kwonlyargs=[], kw_defaults=[],
                                       defaults=[]),
                    body=ast.Name(id=x, ctx=ast.Load()),
                )
                for x in params
            ],
            ctx=ast.Load(),
        )
        call = ast.Call(
            func=ast.Name(id=_HELPER, ctx=ast.Load()),
            args=[node.test,
                  ast.Name(id=tname, ctx=ast.Load()),
                  ast.Name(id=fname, ctx=ast.Load()),
                  thunks],
            keywords=[],
        )
        if names:
            assign = ast.Assign(
                targets=[ast.Tuple(
                    elts=[ast.Name(id=x, ctx=ast.Store()) for x in names],
                    ctx=ast.Store(),
                )],
                value=call,
            )
        else:
            assign = ast.Expr(value=call)
        return [tdef, fdef, assign]


class _Undefined:
    """Placeholder for a branch variable with no value yet: any use inside
    the branch (before its own assignment) fails loudly."""

    def _boom(self, *a, **k):
        raise RuntimeError(
            "converted `if`: this variable has no value on every path "
            "(it was assigned in only one branch, or not before the "
            "`if`); assign it on all paths before using it"
        )

    __getattr__ = __call__ = __add__ = __radd__ = __mul__ = __rmul__ = \
        __sub__ = __rsub__ = __truediv__ = __rtruediv__ = __bool__ = \
        __eq__ = __ne__ = __lt__ = __le__ = __gt__ = __ge__ = \
        __getitem__ = __iter__ = __len__ = __neg__ = __pos__ = \
        __pow__ = __rpow__ = __mod__ = __rmod__ = __matmul__ = \
        __rmatmul__ = __float__ = __int__ = __index__ = _boom
    # __eq__ override kills default hashing; identity hash is the right
    # semantic for a placeholder
    __hash__ = object.__hash__


def _select_if(pred, true_fn, false_fn, thunks=()):
    """Runtime dispatch: eager bool -> Python branch; symbolic tensor ->
    run BOTH branches and `where`-select each returned value. `thunks`
    lazily read the CURRENT values of read-write branch variables."""
    from paddle_tpu_torch.dygraph.base import trace_op
    from paddle_tpu_torch.dygraph.varbase import VarBase

    vals = []
    for th in thunks:
        try:
            vals.append(th())
        except (NameError, UnboundLocalError):
            vals.append(_Undefined())
    if not isinstance(pred, VarBase) or pred.value is not None:
        return true_fn(*vals) if pred else false_fn(*vals)
    if not thunks:
        raise RuntimeError(
            "a data-dependent `if` whose branches assign no variables is "
            "side-effect-only and cannot be converted to a select; use "
            "layers.cond or restructure"
        )
    tv = true_fn(*vals)
    fv = false_fn(*vals)
    tv = tv if isinstance(tv, tuple) else (tv,)
    fv = fv if isinstance(fv, tuple) else (fv,)
    outs = []
    for t, f in zip(tv, fv):
        if isinstance(t, _Undefined) or isinstance(f, _Undefined):
            # the variable exists on one path only (branch-local temp, loop
            # var, nested def): no select possible. Mirror Python: fine if
            # never used after the `if`, loud on use.
            outs.append(_Undefined())
            continue
        if isinstance(t, VarBase) or isinstance(f, VarBase):
            # mixed tensor/scalar branches (`y = 0.0` before the if, then
            # `y = x * 2` inside): promote the plain value to a constant
            # tensor so the select works
            from paddle_tpu_torch.dygraph.base import to_variable
            import numpy as _np

            if not isinstance(t, VarBase):
                t = to_variable(_np.asarray(t, dtype=_np.dtype(f.dtype)))
            if not isinstance(f, VarBase):
                f = to_variable(_np.asarray(f, dtype=_np.dtype(t.dtype)))
            outs.append(trace_op(
                "where", {"Condition": [pred], "X": [t], "Y": [f]}, {}
            )["Out"][0])
        else:
            raise RuntimeError(
                "converted `if` produced a non-tensor branch value under "
                "trace; only tensor-valued branches can be selected "
                f"(got {type(t).__name__}/{type(f).__name__})"
            )
    # always a tuple: the rewritten assignment unpacks a tuple target
    return tuple(outs)


def _loop_cmp(i, stop, step):
    """for-range loop condition: `i < stop` for positive step, `i > stop`
    for a NEGATIVE CONSTANT step. A symbolic (tensor) step is compared as
    positive — documented limit, matching the reference's loop transform."""
    from paddle_tpu_torch.dygraph.varbase import VarBase

    if not isinstance(step, VarBase) and step == 0:
        raise ValueError("range() arg 3 must not be zero")
    neg = not isinstance(step, VarBase) and step < 0
    return (i > stop) if neg else (i < stop)


def _run_while(cond_fn, body_fn, thunks, names):
    """Runtime dispatch for a converted loop: concrete condition -> plain
    Python while (eager mode; constant trip counts under capture unroll
    exactly as an untransformed trace would); symbolic condition under
    capture -> a `while` op whose sub-block runs the traced body and
    writes each carried name back (ops/control_flow.py runs it)."""
    import numpy as _np

    from paddle_tpu_torch.dygraph import base
    from paddle_tpu_torch.dygraph.base import to_variable
    from paddle_tpu_torch.dygraph.varbase import VarBase

    vals = []
    for th in thunks:
        try:
            vals.append(th())
        except (NameError, UnboundLocalError):
            vals.append(_Undefined())
    c = cond_fn(*vals)
    if not isinstance(c, VarBase) or c.value is not None:
        while bool(c):
            out = body_fn(*vals)
            vals = list(out) if isinstance(out, tuple) else [out]
            c = cond_fn(*vals)
        return tuple(vals)

    cap = base._capture
    if cap is None:
        raise RuntimeError(
            "converted loop: symbolic condition outside capture mode"
        )
    from paddle_tpu_torch.layers.control_flow import While
    from paddle_tpu_torch.utils import unique_name as _un

    prog = cap.main_program
    svs = []
    undef_slots = []
    for nm, v in zip(names, vals):
        if isinstance(v, _Undefined):
            # a name assigned inside the body but never defined before the
            # loop (e.g. an inner loop's counter re-initialized each outer
            # iteration): its init shape becomes known once the body is
            # traced — materialize a zero init then. Reading it BEFORE its
            # in-body assignment still fails loudly (_Undefined._boom).
            svs.append(None)
            undef_slots.append(len(svs) - 1)
            continue
        if isinstance(v, VarBase):
            vb = v
        else:
            arr = _np.asarray(v)
            if arr.ndim == 0:
                # fluid's scalar convention is shape [1]; a 0-d init would
                # mismatch the [1] the body's arithmetic produces
                arr = arr.reshape(1)
            vb = to_variable(arr)
        sv = vb.static_var
        if sv is None:
            sv = cap.to_static_var(vb)
        svs.append(sv)
    cond_sv = c.static_var
    parent = prog.current_block()
    with While(cond_sv):
        sub = prog.current_block()
        out = body_fn(*[
            VarBase.from_static(sv) if sv is not None else _Undefined()
            for sv in svs
        ])
        out = out if isinstance(out, tuple) else (out,)
        for idx in undef_slots:
            nv = out[idx]
            nsv = nv.static_var if isinstance(nv, VarBase) else None
            shape = (
                list(nsv.shape)
                if nsv is not None and nsv.shape is not None
                else None
            )
            if (
                shape is None
                or any(d is None or d < 0 for d in shape)
            ):
                raise RuntimeError(
                    f"converted loop: variable '{names[idx]}' is loop "
                    "state with no value before the loop and no statically "
                    "known in-body shape; initialize it before the loop"
                )
            init_name = _un.generate(f"__pt_loop_init_{names[idx]}")
            parent.create_var(name=init_name, shape=shape, dtype=nsv.dtype)
            # emitted into the PARENT block; the while op is appended after
            # it on __exit__, so the init dominates the loop
            parent.append_op(
                "fill_constant", {}, {"Out": [init_name]},
                {"shape": shape, "dtype": nsv.dtype, "value": 0.0},
            )
            svs[idx] = parent.var(init_name)
        for nm, sv, nv in zip(names, svs, out):
            if not isinstance(nv, VarBase):
                try:
                    nv = to_variable(_np.asarray(nv))
                except Exception:
                    raise RuntimeError(
                        f"converted loop: variable '{nm}' takes non-tensor "
                        f"value {type(nv).__name__} inside the loop; only "
                        "tensor (or numeric) loop state can be carried"
                    ) from None
            nsv = nv.static_var
            if nsv is None:
                nsv = cap.to_static_var(nv)
            # write the new value back under the carried name: the while
            # lowering carries exactly the pre-existing names the
            # sub-block writes (ops/control_flow.py _run_while)
            sub.append_op("assign", {"X": [nsv.name]}, {"Out": [sv.name]})
        c2 = cond_fn(*[VarBase.from_static(sv) for sv in svs])
        if not isinstance(c2, VarBase) or c2.static_var is None:
            raise RuntimeError(
                "converted loop: the condition must stay tensor-valued "
                "inside the loop"
            )
        sub.append_op(
            "assign", {"X": [c2.static_var.name]}, {"Out": [cond_sv.name]}
        )
    return tuple(VarBase.from_static(sv) for sv in svs)


def ast_transform(fn):
    """Rewrite `fn`'s data-dependent `if` statements. Returns the
    transformed function, or None when the source cannot be transformed
    (caller falls back to plain tracing + the loud capture guard)."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return None
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    fdef.decorator_list = []  # avoid re-applying @declarative etc.
    tr = _IfTransformer()
    tr.visit(tree)
    if tr.count == 0:
        return None
    ast.fix_missing_locations(tree)
    try:
        code = compile(tree, f"<ast_transform {fn.__name__}>", "exec")
    except (SyntaxError, ValueError):
        return None
    # exec against the LIVE module globals (not a snapshot): names defined
    # or monkeypatched after decoration, and recursion through the module
    # global, must resolve. The helper key is collision-safe.
    glb = getattr(fn, "__globals__", None)
    if glb is None:
        return None
    glb[_HELPER] = _select_if
    glb[_WHILE_HELPER] = _run_while
    glb[_CMP_HELPER] = _loop_cmp
    # re-bind the function's closure-free form; closures over outer locals
    # cannot be rebuilt from source -> bail to the fallback
    if getattr(fn, "__closure__", None):
        return None
    loc = {}
    exec(code, glb, loc)
    out = loc.get(fdef.name)
    if out is None:
        return None
    out.__wrapped_original__ = fn
    return out


def convert_ifelse(fn):
    """Public decorator: transform if possible, else return fn unchanged
    (plain trace + loud guard)."""
    return ast_transform(fn) or fn
