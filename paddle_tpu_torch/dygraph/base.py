"""Dygraph (imperative) mode: eager op dispatch and a tape of grad ops,
with the semantics of the JAX package's ``dygraph/base.py``
(reference: paddle/fluid/imperative/tracer.h:44 Tracer, tracer.cc:87
TraceOp, engine.h:42 BasicEngine).

Every eager op dispatches through the SAME registry lowering the
executor runs (``core/registry.py``: the kernel lowering where the op has
one, so a dygraph ``Dropout`` draws its mask with K8 on the card). Where
the JAX tape keeps each op's ``jax.vjp`` pullback, this one keeps the
op's inputs, outputs and attributes, and ``run_backward`` runs the op's
grad lowering on them: the one ``core/backward.py`` resolves for the
static program's ``<type>_grad`` op (a hand-written grad where the op
has one, dropout's from its saved mask; else the forward rerun under
``torch.autograd``). Cotangents add up as the JAX tape adds them:
``prev + g`` in reverse tape order.

A random op takes ``fold_in(PRNGKey(seed), counter)`` from the tracer,
in tape order, as do the eager parameter draws (``layers.py``
``eager_initialize``), so on the CPU the initial weights and dropout
masks are the JAX dygraph's bit for bit. Eager tensors live on the
guard's place: ``guard()`` with no place takes ``CUDAPlace(0)`` and
raises without a card; tests pass ``CPUPlace()``. ``to_variable`` keeps
int64 where the JAX package narrows it to int32 (``core/dtypes.py``).

Dual dispatch (the reference's tracer-vs-OpDesc split): inside a
``static_capture`` context, ``trace_op`` appends the op to a Program
block instead — dygraph-to-static (``jit.py``) with no change to module
code.
"""

import contextlib

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.backward import resolve_op_def
from paddle_tpu_torch.core.dtypes import convert_dtype, to_torch_dtype
from paddle_tpu_torch.core.places import default_place
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.utils import unique_name
from paddle_tpu_torch.utils.enforce import EnforceError, enforce

_tracer = None


class Tracer:
    """Eager-mode execution state: the place, the grad tape and the key
    stream (reference: paddle/fluid/imperative/tracer.h:44)."""

    def __init__(self, seed=0, place=None):
        self.place = default_place(place)
        self.device = self.place.device
        self._has_grad = True
        self._train_mode = True
        self._tape = []
        self._seed = seed
        self._rng_counter = 0

    def next_rng_key(self):
        self._rng_counter += 1
        return prng.fold_in(prng.prng_key(self._seed), self._rng_counter)

    def reset_tape(self):
        self._tape = []


def _dygraph_tracer():
    return _tracer


def in_dygraph_mode():
    return _tracer is not None


def current_device():
    """The eager tensors' device: the guard's, else the host."""
    return _tracer.device if _tracer is not None else torch.device("cpu")


@contextlib.contextmanager
def guard(place=None, seed=0):
    """Enter imperative mode on ``place`` (default ``CUDAPlace(0)``)
    (reference: python/paddle/fluid/dygraph/base.py guard)."""
    global _tracer
    old = _tracer
    _tracer = Tracer(seed=seed, place=place)
    try:
        yield
    finally:
        _tracer = old


def enable_dygraph(place=None):
    global _tracer
    if _tracer is None:
        _tracer = Tracer(place=place)


def disable_dygraph():
    global _tracer
    _tracer = None


@contextlib.contextmanager
def no_grad_ctx():
    tracer = _dygraph_tracer()
    if tracer is None:
        yield
        return
    old = tracer._has_grad
    tracer._has_grad = False
    try:
        yield
    finally:
        tracer._has_grad = old


def no_grad(fn=None):
    """Usable as decorator or context manager (reference:
    python/paddle/fluid/dygraph/base.py no_grad)."""
    if fn is None:
        return no_grad_ctx()

    def wrapper(*args, **kwargs):
        with no_grad_ctx():
            return fn(*args, **kwargs)

    return wrapper


def to_numpy(t):
    """A tensor as a numpy array (bfloat16 widened to float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# static capture (dygraph-to-static)
# ---------------------------------------------------------------------------

_capture = None


class _CaptureContext:
    """While active, trace_op appends ops to `main_program` instead of
    executing; eager parameters materialize as static Parameters
    initialized with their current values (``NumpyArrayInitializer``)."""

    def __init__(self, main_program, startup_program):
        self.main_program = main_program
        self.startup_program = startup_program
        self.var_map = {}  # id(VarBase) -> static Variable
        # id() keys are only stable while the object lives: keep a strong
        # reference to every mapped VarBase, or a freed temporary (e.g. the
        # scalar constant `x * 2.0` materializes) lets a LATER temporary
        # reuse its id and silently alias its static var
        self._retained = []

    def to_static_var(self, vb):
        from paddle_tpu_torch.initializer import NumpyArrayInitializer

        if vb.static_var is not None:
            return vb.static_var
        sv = self.var_map.get(id(vb))
        if sv is not None:
            return sv
        block = self.main_program.global_block()
        value = to_numpy(vb.value)
        dtype = convert_dtype(vb.value.dtype)
        if getattr(vb, "trainable", None) is not None:
            # an eager ParamBase: becomes a static Parameter carrying its
            # current value through the startup program
            sv = block.create_parameter(
                shape=list(value.shape),
                dtype=dtype,
                name=vb.name,
                trainable=vb.trainable,
            )
            sblock = self.startup_program.global_block()
            sblock.create_var(
                name=vb.name,
                shape=list(value.shape),
                dtype=dtype,
                persistable=True,
            )
            NumpyArrayInitializer(value)(sv, sblock)
        else:
            # a non-parameter eager tensor from outside the capture: freeze
            # it as a constant
            sv = block.create_var(
                name=unique_name.generate(vb.name or "captured"),
                shape=list(value.shape),
                dtype=dtype,
            )
            block.append_op(
                "assign_value",
                {},
                {"Out": [sv.name]},
                {
                    "shape": list(value.shape),
                    "dtype": dtype,
                    "values": value.reshape(-1).tolist(),
                },
            )
        self.var_map[id(vb)] = sv
        self._retained.append(vb)
        return sv


@contextlib.contextmanager
def static_capture(main_program, startup_program):
    global _capture
    old = _capture
    _capture = _CaptureContext(main_program, startup_program)
    try:
        yield _capture
    finally:
        _capture = old


def in_capture_mode():
    return _capture is not None


# ---------------------------------------------------------------------------
# eager op dispatch
# ---------------------------------------------------------------------------


def _flatten_outs(outs):
    """Deterministic flattening of a lowering's {slot: [tensors]} output."""
    flat, index = [], []
    for slot in sorted(outs):
        vals = outs[slot]
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for i, v in enumerate(vals):
            flat.append(v)
            index.append((slot, i))
    return flat, index


def _as_tensor(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


def trace_op(op_type, ins, attrs=None, out_slots=("Out",), stop_gradient=False):
    """Run one op eagerly (or append it to the captured program).

    ins: {slot: [VarBase, ...]}; returns {slot: [VarBase, ...]}. When an
    input needs a grad, the tape records the op for ``run_backward``
    (reference analog: Tracer::TraceOp + TraceBackward, tracer.cc:87,136).
    """
    from paddle_tpu_torch.dygraph.varbase import VarBase

    attrs = dict(attrs or {})
    attrs.pop("op_callstack", None)
    if in_capture_mode():
        return _capture_op(op_type, ins, attrs, out_slots)

    tracer = _dygraph_tracer()
    enforce(tracer is not None, "dygraph op outside dygraph mode")
    op_def = get_op_def(op_type)

    raw_ins = {}
    for slot, vals in ins.items():
        if vals is None:
            continue
        vals = vals if isinstance(vals, (list, tuple)) else [vals]
        raw_ins[slot] = [v.value if isinstance(v, VarBase)
                         else _as_tensor(v, tracer.device) for v in vals]
    if op_def.stateful:
        raw_ins["__rng_key__"] = [tracer.next_rng_key()]
        if not tracer._train_mode:
            attrs.setdefault("is_test", True)
    if op_def.creates:
        raw_ins["__device__"] = [tracer.device]

    # which (slot, pos) get gradients
    diff_positions = []
    for slot, vals in ins.items():
        if vals is None or slot in op_def.nondiff_inputs:
            continue
        vals = vals if isinstance(vals, (list, tuple)) else [vals]
        for i, v in enumerate(vals):
            if (
                isinstance(v, VarBase)
                and not v.stop_gradient
                and raw_ins[slot][i].is_floating_point()
            ):
                diff_positions.append((slot, i, v))

    need_grad = bool(diff_positions) and tracer._has_grad and not stop_gradient
    try:
        with torch.no_grad():
            outs = op_def.lowering()(raw_ins, attrs)
    except EnforceError:
        raise
    except Exception as e:
        raise EnforceError(f"dygraph op failed: {e}", op_type=op_type) from e
    flat, index = _flatten_outs(outs)
    out_vbs = [
        None if v is None else VarBase(
            v,
            stop_gradient=not (need_grad and v.is_floating_point()),
            name=unique_name.generate(f"{op_type}_out"),
        )
        for v in flat
    ]
    if need_grad:
        tracer._tape.append(_TapeEntry(
            op_type, raw_ins, attrs, outs, diff_positions,
            [(slot, i, vb) for vb, (slot, i) in zip(out_vbs, index)
             if vb is not None and not vb.stop_gradient]))
    return _pack_outs(out_vbs, index)


class _TapeEntry:
    """One recorded op: what its grad lowering needs (the forward's inputs
    with their run-time context, attributes and outputs), the inputs that
    take a grad and the outputs that carry one."""

    __slots__ = ("op_type", "ins", "attrs", "outs", "input_vars",
                 "output_vars")

    def __init__(self, op_type, ins, attrs, outs, input_vars, output_vars):
        self.op_type = op_type
        self.ins = ins
        self.attrs = attrs
        self.outs = outs
        self.input_vars = input_vars
        self.output_vars = output_vars

    def vjp(self, cotangents):
        """The inputs' grads, in ``input_vars`` order, from the outputs'
        cotangents (``{(slot, i): tensor}``): the op's grad lowering, as
        the static backward's ``<type>_grad`` op runs it."""
        fwd_in = [s for s in self.ins if not s.startswith("__")]
        fwd_out = sorted(self.outs)
        gins = dict(self.ins)
        for s in fwd_out:
            vals = self.outs[s]
            vals = list(vals) if isinstance(vals, (list, tuple)) else [vals]
            gins[s] = vals
            gins[f"{s}@GRAD"] = [cotangents.get((s, i)) for i in range(len(vals))]
        wanted = sorted({f"{slot}@GRAD" for slot, _, _ in self.input_vars})
        gattrs = dict(self.attrs, __fwd_inputs__=fwd_in,
                      __fwd_outputs__=fwd_out, __grad_outputs__=wanted)
        with torch.no_grad():
            res = resolve_op_def(self.op_type + "_grad").lowering()(gins, gattrs)
        return [res[f"{slot}@GRAD"][i] for slot, i, _ in self.input_vars]


def _pack_outs(out_vbs, index):
    outs = {}
    for vb, (slot, i) in zip(out_vbs, index):
        outs.setdefault(slot, []).append(vb)
    return outs


def _capture_op(op_type, ins, attrs, out_slots):
    """Append the op to the program under capture; output shapes come
    from the shared abstract evaluation (layer_helper.infer_op_shapes)."""
    from paddle_tpu_torch.dygraph.varbase import VarBase
    from paddle_tpu_torch.layer_helper import infer_op_shapes

    # CURRENT block, not the global one: a converted loop body traces its
    # ops into the `while` op's sub-block (ast_transform)
    block = _capture.main_program.current_block()
    in_names = {}
    for slot, vals in ins.items():
        if vals is None:
            continue
        vals = vals if isinstance(vals, (list, tuple)) else [vals]
        names = []
        for v in vals:
            enforce(isinstance(v, VarBase), f"capture input must be VarBase, got {type(v)}")
            names.append(_capture.to_static_var(v).name)
        in_names[slot] = names

    specs = infer_op_shapes(op_type, block, in_names, attrs)
    out_names = {}
    slots = sorted(specs) if specs else list(out_slots)
    for slot in slots:
        n = len(specs[slot]) if specs else 1
        names = []
        for i in range(n):
            name = unique_name.generate(f"{op_type}_{slot.lower()}")
            shape, dtype = (specs[slot][i] if specs else (None, "float32"))
            block.create_var(name=name, shape=shape, dtype=dtype)
            names.append(name)
        out_names[slot] = names
    block.append_op(op_type, in_names, out_names, attrs)

    outs = {}
    for slot, names in out_names.items():
        outs[slot] = [VarBase.from_static(block.var(n)) for n in names]
    return outs


# ---------------------------------------------------------------------------
# backward engine
# ---------------------------------------------------------------------------


def run_backward(loss, retain_graph=False):
    """Reverse tape walk with gradient accumulation (reference:
    paddle/fluid/imperative/engine.cc BasicEngine,
    gradient_accumulator.cc)."""
    tracer = _dygraph_tracer()
    enforce(tracer is not None, ".backward() outside dygraph mode")
    grads = {id(loss): torch.ones_like(loss.value)}

    for entry in reversed(tracer._tape):
        cotangents = {}
        any_needed = False
        for slot, i, ov in entry.output_vars:
            g = grads.get(id(ov))
            if g is None:
                g = torch.zeros_like(ov.value)
            else:
                any_needed = True
            cotangents[(slot, i)] = g
        if not any_needed:
            continue
        for iv, g in zip(entry.input_vars, entry.vjp(cotangents)):
            iv = iv[2]
            if g is None:
                continue
            prev = grads.get(id(iv))
            grads[id(iv)] = g if prev is None else prev + g
            iv._accumulate_grad(grads[id(iv)])
    if not retain_graph:
        tracer.reset_tape()


def to_variable(value, name=None, zero_copy=None, dtype=None):
    """numpy / scalar / tensor -> eager VarBase on the guard's device
    (reference: python/paddle/fluid/dygraph/base.py to_variable).
    float64 narrows to float32 as in the JAX package; int64 stays int64."""
    from paddle_tpu_torch.dygraph.varbase import VarBase

    if isinstance(value, VarBase):
        return value
    device = current_device()
    name = name or unique_name.generate("generated_tensor")
    if isinstance(value, torch.Tensor):
        t = value.detach().to(device)
        if dtype is not None:
            t = t.to(to_torch_dtype(dtype))
        elif t.dtype == torch.float64:
            t = t.float()
        return VarBase(t, name=name)
    arr = np.asarray(value)
    if dtype is not None:
        arr = arr.astype(np.dtype(convert_dtype(dtype)))
    elif arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return VarBase(torch.from_numpy(np.ascontiguousarray(arr)).to(device),
                   name=name)

