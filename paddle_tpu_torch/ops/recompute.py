"""Recompute (activation checkpointing) segment ops, with the semantics of
the JAX package's ``ops/recompute.py``.

``append_backward`` collapses each forward segment between two user
checkpoints into one ``recompute_segment_grad`` op
(``core/backward.py`` ``_collapse_segments``). The segment's forward ops
stay in the program and run as they do without remat; what changes is
what stays alive for the backward. The executor drops the segment's
interior values after their last forward reader, except those the
segment's policy keeps (``kernels/remat.py``), and the grad op replays the
segment at backward time: under ``torch.enable_grad()`` from its detached
boundary inputs, then ``torch.autograd.grad`` for ``__diff_ins__``.

In the replay:

* a stateful op gets ``fold_in(base, __rng_id__)``, the key it had in the
  forward (the executor gives the grad op the run key as
  ``__base_rng__``), and, on a rank of a dense data-parallel run, the
  same block of the global draw (``_dp_replay``, stamped by
  ``parallel/data_parallel.py``): a replayed dropout draws the forward's
  mask again;
* a product (``remat.DOT_OPS``) whose output the policy kept is not
  recomputed. Its lowering runs under ``_Hollow``, which records the
  products in autograd's graph but computes none of them, and ``_Graft``
  puts the kept value in its place: the backward is autograd's own for
  the product, the same two products (two convolution backwards) as
  without the kept value;
* an op with a hand-written grad (``register_grad``: dropout from its
  mask, the embedding gather's deterministic row sums) runs through
  ``_HandGrad``, whose backward is that grad lowering, as the op's grad
  op would run it. The products' grads are wrappers of the generic grad
  (a float32 guard around autograd) and take autograd directly;
* every other op runs its lowering (the kernel lowering where it has one:
  flash attention's ``torch.autograd.Function``, so K1 runs in the replay
  and K2a/K2b in its backward) under autograd.

The backward runs under ``FLOAT32_REDUCTIONS`` and ``FLOAT32_CONVS`` on
the card, as the products' own grad ops do. Replaying the same ops on the
same values, the grads are the same bits under every policy.
"""

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.backward import resolve_op_def
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.kernels import remat
from paddle_tpu_torch.ops.common import first
from paddle_tpu_torch.ops.math import FLOAT32_REDUCTIONS
from paddle_tpu_torch.ops.nn import FLOAT32_CONVS
from paddle_tpu_torch.utils.enforce import EnforceError

_aten = torch.ops.aten
#: the products a kept dot's lowering reaches below autograd
_PRODUCTS = frozenset((
    _aten.mm.default, _aten.bmm.default, _aten.addmm.default,
    _aten.baddbmm.default, _aten.mv.default, _aten.dot.default,
    _aten.convolution.default,
))


def _to_meta(a):
    return a.to("meta") if isinstance(a, torch.Tensor) else a


class _Hollow(TorchDispatchMode):
    """Products return an uninitialised tensor of their result's shape.
    The mode sits below autograd, so each product is recorded in the
    graph with the inputs its backward reads; its value is never
    computed, and nothing reads it (``_Graft`` takes its place)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            meta = func(*tree_map(_to_meta, args), **tree_map(_to_meta, kwargs))
            return torch.empty(meta.shape, dtype=meta.dtype,
                               device=args[0].device)
        return func(*args, **kwargs)


class _Graft(torch.autograd.Function):
    """``value`` in the graph of ``hollow``: the kept output of a product
    whose backward is ``hollow``'s."""

    @staticmethod
    def forward(ctx, hollow, value):
        return value.detach()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Context:
    """A non-tensor input of a replayed op (its key, its device)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class _HandCall:
    """One replayed op with a hand-written grad: its def and attrs, where
    its tensor inputs sit (``layout``: slot -> [tensor index, or a
    ``_Context``]), which of them are leaves, and its outputs' slots and
    counts. It holds no tensor: the tensors go through
    ``save_for_backward``, so no reference cycle keeps a replay's graph
    alive after its backward."""

    __slots__ = ("op_def", "attrs", "layout", "leaves", "n_in", "out_layout")

    def __init__(self, op_def, ins, attrs):
        self.op_def, self.attrs = op_def, attrs
        self.layout, self.leaves, self.n_in = {}, [], 0
        for slot, vals in ins.items():
            entry = []
            for v in vals:
                if isinstance(v, torch.Tensor):
                    if (v.requires_grad and not slot.startswith("__")
                            and slot not in op_def.nondiff_inputs):
                        self.leaves.append((slot, len(entry), self.n_in))
                    entry.append(self.n_in)
                    self.n_in += 1
                else:
                    entry.append(_Context(v))
            self.layout[slot] = entry
        self.out_layout = None

    def tensors(self, ins):
        return [v for slot, vals in ins.items() for v in vals
                if isinstance(v, torch.Tensor)]

    def ins(self, tensors):
        return {slot: [v.value if isinstance(v, _Context) else tensors[v]
                       for v in entry] for slot, entry in self.layout.items()}

    def outs(self, flat):
        it = iter(flat)
        return {slot: [next(it) for _ in range(n)]
                for slot, n in self.out_layout}


class _HandGrad(torch.autograd.Function):
    """An op whose grad is its hand-written ``<type>_grad`` lowering, called
    with the grad op's convention (``core/backward.py``): the forward's
    inputs and outputs by slot, ``<slot>@GRAD`` for the outputs given a
    grad, ``__fwd_inputs__``/``__fwd_outputs__``/``__grad_outputs__``."""

    @staticmethod
    def forward(ctx, call, *tensors):
        outs = _as_lists(call.op_def.lowering()(call.ins(tensors), call.attrs))
        call.out_layout = [(slot, len(vals)) for slot, vals in outs.items()]
        flat = [v for vals in outs.values() for v in vals]
        ctx.call = call
        ctx.save_for_backward(*tensors, *flat)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(
            *[v for v in flat if not v.is_floating_point()])
        return tuple(flat)

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        saved = ctx.saved_tensors
        gins = call.ins(saved[:call.n_in])
        outs = call.outs(saved[call.n_in:])
        it = iter(grads)
        for slot, vals in outs.items():
            gins[slot] = vals
            gs = [next(it) for _ in vals]
            if any(g is not None for g in gs):
                gins[f"{slot}@GRAD"] = [torch.zeros_like(v) if g is None
                                        else g for v, g in zip(vals, gs)]
        slots = list(dict.fromkeys(s for s, _, _ in call.leaves))
        gattrs = dict(call.attrs, __fwd_inputs__=[
                          s for s in call.layout if not s.startswith("__")],
                      __fwd_outputs__=list(outs),
                      __grad_outputs__=[f"{s}@GRAD" for s in slots])
        res = call.op_def.grad(gins, gattrs)
        out = [None] * call.n_in
        for slot, i, k in call.leaves:
            gl = res.get(f"{slot}@GRAD")
            out[k] = gl[i] if gl is not None and i < len(gl) else None
        return (None,) + tuple(out)


def _as_lists(outs):
    return {slot: list(vals) if isinstance(vals, (list, tuple)) else [vals]
            for slot, vals in outs.items()}


def _hand_grad(op_def, ins, attrs):
    """``op_def``'s lowering through ``_HandGrad`` where a differentiable
    input needs a grad, else as it is."""
    call = _HandCall(op_def, ins, attrs)
    if not call.leaves:
        return _as_lists(op_def.lowering()(ins, attrs))
    return call.outs(_HandGrad.apply(call, *call.tensors(ins)))


def _graft_all(graph_outs, values):
    """``values``' tensors in the graph of ``graph_outs``' (slot by slot)."""
    return {slot: [_Graft.apply(g, v) if g is not None and g.requires_grad
                   else v for g, v in zip(
                       graph_outs.get(slot) or [None] * len(vals), vals)]
            for slot, vals in values.items()}


def replay_segment(segment, env, base_rng, device=None, saved=None,
                   graph=False, dp=None):
    """Run a serialized op list against ``env`` (name -> tensor), mutating
    it. ``segment`` entries are (type, inputs, outputs, attrs) as
    ``append_backward`` captured them. With ``graph`` the ops build
    autograd's graph (the grad op's replay): ``saved`` holds the values
    the policy kept, ``dp`` the dense data-parallel plan's replay attrs
    (``rerun``: the batch reductions' ``__rng_id__``s; ``rng_block``:
    ``__rng_id__`` -> this rank's block of a random op's draw)."""
    saved = saved or {}
    dp = dp or {}
    rerun = set(dp.get("rerun", ()))
    blocks = dp.get("rng_block", {})
    for op_type, inputs, outputs, attrs in segment:
        op_def = resolve_op_def(op_type)
        if op_def.needs_block:
            raise NotImplementedError(
                f"a recompute segment over '{op_type}', an op that runs "
                "sub-blocks, is not ported yet (ROADMAP M11)")
        ins = {
            slot: [env[n] for n in names]
            for slot, names in inputs.items()
            if names and all(n in env for n in names)
        }
        rid = attrs.get("__rng_id__")
        if op_def.stateful:
            if base_rng is None:
                raise EnforceError(
                    f"stateful op {op_type} in recompute segment but no base "
                    f"rng key available"
                )
            ins["__rng_key__"] = [prng.fold_in(base_rng, rid)]
            if rid in blocks:
                ins["__rng_block__"] = [blocks[rid]]
        if op_def.creates:
            ins["__device__"] = [device]
        names = [n for ns in outputs.values() for n in ns]
        lower = op_def.lowering()
        if not graph:
            outs = lower(ins, dict(attrs, _dp_batch=True)
                         if rid in rerun else attrs)
        elif op_type in remat.DOT_OPS and names and all(
                n in saved for n in names):
            with _Hollow():
                hollow = _as_lists(lower(ins, attrs))
            outs = _graft_all(hollow, {
                slot: [saved[n] for n in ns] for slot, ns in outputs.items()})
        elif rid in rerun:
            # a batch reduction on a data-parallel rank: the global value
            # (the forward's bits) in the graph of the local sum, whose
            # backward hands the replicated cotangent to the rows
            with torch.no_grad():
                value = _as_lists(lower(ins, dict(attrs, _dp_batch=True)))
            outs = _graft_all(
                _as_lists(lower(ins, dict(attrs, _dp_batch="rerun"))), value)
        elif op_def.grad is not None and op_type not in remat.DOT_OPS:
            outs = _hand_grad(op_def, ins, attrs)
        else:
            outs = lower(ins, attrs)
        for slot, onames in outputs.items():
            if slot not in outs:
                continue
            vals = outs[slot]
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            for name, val in zip(onames, vals):
                if val is not None:
                    env[name] = val
    return env


@register_op("recompute_segment", needs_base_rng=True, creates=True)
def _recompute_segment(ins, attrs):
    """Forward replay of a segment (used if a segment pseudo-op is ever
    materialized in a program; normally only the grad op below runs)."""
    env = dict(zip(attrs["__in_names__"], ins["X"]))
    base_rng = ins.get("__base_rng__", [None])[0]
    replay_segment(attrs["__segment__"], env, base_rng,
                   first(ins, "__device__"), dp=attrs.get("_dp_replay"))
    return {"Out": [env[n] for n in attrs["__out_names__"]]}


def _backward_guards(device):
    """The products' grads in float32 on the card, as their own grad ops
    run them (``ops/math.py``, ``ops/nn.py``)."""
    stack = contextlib.ExitStack()
    if device is not None and device.type == "cuda":
        stack.enter_context(FLOAT32_REDUCTIONS)
        stack.enter_context(FLOAT32_CONVS)
    return stack


@register_op("recompute_segment_grad", needs_base_rng=True, creates=True)
def _recompute_segment_grad(ins, attrs):
    in_names = attrs["__in_names__"]
    out_names = attrs["__out_names__"]
    diff_ins = [n for n in attrs["__diff_ins__"] if n in in_names]
    diff_outs = [n for n in attrs["__diff_outs__"] if n in out_names]
    xs = ins["X"]
    if not diff_ins:
        return {}
    saved = ins.get("__saved__", [{}])[0]
    missing = [n for n in remat.kept_names(attrs) if n not in saved]
    if missing:
        raise EnforceError(
            f"remat policy {attrs.get('__remat_policy__')!r} keeps "
            f"{missing[:3]} for this segment, but the executor did not "
            "hand them over")
    base_rng = ins.get("__base_rng__", [None])[0]
    device = first(ins, "__device__")
    gouts = ins.get("Out@GRAD", [])
    with torch.enable_grad():
        env = dict(zip(in_names, xs))
        leaves = []
        for n in diff_ins:
            env[n] = env[n].detach().requires_grad_()
            leaves.append(env[n])
        replay_segment(attrs["__segment__"], env, base_rng, device, saved,
                       graph=True, dp=attrs.get("_dp_replay"))
        primals, cotangents = [], []
        for n in diff_outs:
            pos = out_names.index(n)
            g = gouts[pos] if pos < len(gouts) else None
            p = env[n]
            if g is None or not p.requires_grad:
                continue
            primals.append(p)
            cotangents.append(g.to(p.dtype))
        with _backward_guards(device):
            grads = (torch.autograd.grad(primals, leaves, cotangents,
                                         allow_unused=True)
                     if primals else [None] * len(leaves))
    out = [None] * len(xs)
    for n, leaf, g in zip(diff_ins, leaves, grads):
        out[in_names.index(n)] = torch.zeros_like(leaf) if g is None else g
    return {"X@GRAD": out}
