"""The ``pipeline_stack`` op and its grad: GPipe pipeline parallelism on
the Program IR, the counterpart of the JAX package's ``ops/pipeline.py``.

The per-layer body is a sub-block (built by ``layers/pipeline.py``
``PipelinedStack``) and its parameters are STACKED with a leading
``[num_layers]`` axis; under ``CompiledProgram`` over a mesh with a
``stage`` axis each rank holds its stage's rows of every stacked
parameter (``[L / n_stage, ...]``, and its shard of the other dims by the
parameter's spec). The op runs ``parallel/pipeline.py``'s schedule over
the ``stage`` axis, each stage running its layers on one microbatch at a
time through the executor's plan of the sub-block, with the body's
``c_*`` rings bound to mesh axes by the op's ``ring_bindings`` (the
Megatron all-reduce over ``model``). Off a stage axis (no mesh, or a
stage axis of one) the same microbatch loop runs with no sends: the JAX
package's degenerate path.

The grad is a lowering of its own. The generic grad reruns an op's
forward under autograd (``core/backward.py``), which here would repeat
every send, receive and ``model`` all-reduce. Instead, when the program
holds ``pipeline_stack_grad`` (the executor's plan marks the op
``_save_for_grad``), the forward runs each microbatch's stage under
``torch.autograd`` and keeps its graph on the op's output tensor, and
the grad runs the reverse schedule over those graphs
(``pipeline_backward``). Across a ``model`` axis the body's values are
of two kinds, as ``shard_map``'s replication types have them: those
every rank of the axis holds (the layer input, the norms, what the
all-reduce returns) and those that differ by rank (computed from a shard
of a weight). ``c_allreduce_sum`` passes its cotangent through
(Megatron's ``g``), and a value of the first kind read by an op of the
second (the column-parallel matmul's input) is read through an identity
whose grad sums the ranks' cotangents (Megatron's ``f``): two
all-reduces a layer in the forward, two in the backward.

Random ops of the body draw from the op's key folded with the layer's
global index, as the JAX body does. Only ``schedule="gpipe"`` runs; the
``"1f1b"`` runtime is ROADMAP M11's pipeline runtime.
"""

import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.registry import OpDef, register_grad, register_op
from paddle_tpu_torch.ops.math import FLOAT32_REDUCTIONS
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.parallel.data_parallel import _CollectiveOp
from paddle_tpu_torch.parallel.pipeline import (
    pipeline_apply, pipeline_backward, split_microbatches)
from paddle_tpu_torch.parallel.sharding import spec_axes
from paddle_tpu_torch.utils.enforce import EnforceError

# the collectives whose result every rank of the ring holds
_INVARIANT_COLLECTIVES = frozenset((
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_allgather", "c_broadcast"))


def _sum_grad_lower(ins, attrs):
    axis = penv.current_mesh_axis(attrs["ring_id"])
    x = ins["X"][0]
    return {"Out": [x if axis is None else penv.identity_psum_grad(x, axis)]}


_SUM_GRAD = OpDef("identity (grad summed over the ring)", _sum_grad_lower)


def _is_float(block, name):
    v = block._find_var_recursive(name)
    return v is None or v.dtype is None or "float" in str(v.dtype)


def sum_grads_over_ring(steps, varying, ring, block):
    """``steps`` (a plan of ``block``) with the values every rank of
    ``ring`` holds read through an identity whose grad sums over the ring
    wherever an op reads them beside a value that differs by rank.
    ``varying`` names the values that differ by rank at the start (the
    parameter shards); an op's outputs differ by rank when one of its
    inputs does, but those of a collective over ``ring``."""
    if not steps:
        return steps
    step_cls = type(steps[0])
    varying = set(varying)
    wrapped, out = {}, []
    for step in steps:
        names = [n for _, ns in step.inputs for n in ns]
        if not any(n in varying for n in names):
            out.append(step)
            continue
        if (step.op.type in _INVARIANT_COLLECTIVES
                and step.attrs.get("ring_id", 0) == ring):
            out.append(step)
            continue
        inputs = []
        for slot, ns in step.inputs:
            renamed = []
            for n in ns:
                if n not in varying and _is_float(block, n):
                    w = wrapped.get(n)
                    if w is None:
                        w = wrapped[n] = f"{n}@SUM_GRAD.{ring}"
                        attrs = {"ring_id": ring}
                        out.append(step_cls(
                            _CollectiveOp(_SUM_GRAD.type), _SUM_GRAD,
                            attrs, [("X", [n])], [("Out", [w])], None))
                    n = w
                renamed.append(n)
            inputs.append((slot, renamed))
        new = step_cls(step.op, step.op_def, step.attrs, inputs, step.outputs,
                       step.rng_id)
        new.rng_block = step.rng_block
        out.append(new)
        varying.update(n for _, ns in step.outputs for n in ns)
    return out


class _Stack:
    """One run of a ``pipeline_stack`` op: its sub-block, this rank's
    stage, its rings, and (when kept for the grad) the graph of each
    microbatch's stage."""

    def __init__(self, ins, attrs):
        block = ins["__block__"][0]
        self.runner = ins["__runner__"][0]
        self.sub = block.program.block(attrs["sub_block"])
        self.x = ins["X"][0]
        self.stacked = list(ins.get("StackedParams", []))
        if not self.stacked:
            raise EnforceError("pipeline_stack needs stacked layer params")
        self.ex = dict(zip(attrs.get("ex_vars", []), ins.get("Ex", [])))
        self.inner_x = attrs["inner_x"]
        self.inner_out = attrs["inner_out"]
        self.param_inner = list(attrs.get("param_inner_vars", []))
        self.param_specs = list(attrs.get("param_specs")
                                or [()] * len(self.stacked))
        self.num_mb = int(attrs.get("num_microbatches", 1))
        self.rng = ins.get("__rng_key__", [prng.prng_key(0)])[0]
        schedule = attrs.get("schedule") or "gpipe"
        if schedule != "gpipe":
            raise NotImplementedError(
                f"pipeline_stack schedule {schedule!r} is not ported yet "
                "(ROADMAP M11: the pipeline runtime); the port runs gpipe")
        mesh = penv.current_mesh()
        stage = attrs.get("stage_axis", "stage")
        self.axis = None
        if mesh is not None and mesh.size(stage) > 1:
            self.axis = mesh.axis(stage)
        self.rings = {}
        for ring, name in (attrs.get("ring_bindings") or {}).items():
            if mesh is not None and name in mesh.axis_names:
                self.rings[int(ring)] = mesh.axis(name)
        n, s = (self.axis.size, self.axis.rank) if self.axis else (1, 0)
        self.layers = self.stacked[0].shape[0]
        self.offset = s * self.layers
        if n > 1 and self.x.shape[0] % self.num_mb:
            raise EnforceError(
                f"pipeline_stack: batch {self.x.shape[0]} does not split "
                f"into {self.num_mb} microbatches")

    def _body(self):
        steps = self.runner.plan(self.sub)
        for ring, axis in self.rings.items():
            if axis.size > 1:
                varying = {inner for inner, spec in zip(self.param_inner,
                                                        self.param_specs)
                           if axis.name in spec_axes(spec)}
                steps = sum_grads_over_ring(steps, varying, ring, self.sub)
        return steps

    def _layer(self, steps, h, l, params, ex):
        env = dict(ex)
        env[self.inner_x] = h
        env.update(zip(self.param_inner, params[l]))
        key = prng.fold_in(self.rng, self.offset + l)
        with penv.collective_context(self.rings):
            self.runner.run(steps, env, key, self.sub)
        return env[self.inner_out]

    def forward(self, keep):
        """The op's output; with ``keep``, each microbatch's graph stays
        for ``backward``."""
        steps = self._body()
        x = self.x
        split = self.num_mb > 1 and x.shape[0] % self.num_mb == 0
        x_mb = split_microbatches(x, self.num_mb) if split else [x]

        def leaf(t):
            return t.detach().requires_grad_() if keep and \
                t.is_floating_point() else t

        self.params = [[leaf(p[l]) for p in self.stacked]
                       for l in range(self.layers)]
        self.ex_leaves = {n: leaf(v) for n, v in self.ex.items()}
        self.h_in, self.h_out = [None] * len(x_mb), [None] * len(x_mb)

        def run_stage(h, m):
            with torch.set_grad_enabled(keep):
                if keep:
                    h = self.h_in[m] = h.detach().requires_grad_()
                for l in range(self.layers):
                    h = self._layer(steps, h, l, self.params, self.ex_leaves)
            if keep:
                self.h_out[m] = h
            return h

        outs = pipeline_apply(run_stage, x_mb, self.axis)
        return torch.cat([o.detach() for o in outs]).reshape(x.shape)

    def backward(self, d_out):
        """``{slot@GRAD: [...]}`` from the cotangent of the output."""
        x = self.x
        d_mb = (split_microbatches(d_out, len(self.h_out))
                if len(self.h_out) > 1 else [d_out])

        def backward_stage(m, dy):
            h_in, h_out = self.h_in[m], self.h_out[m]
            with torch.enable_grad(), FLOAT32_REDUCTIONS.on(dy):
                torch.autograd.backward([h_out], [dy.to(h_out.dtype)])
            self.h_out[m] = None
            g = h_in.grad
            return torch.zeros_like(h_in) if g is None else g.detach()

        dxs = pipeline_backward(backward_stage, d_mb, d_mb[0], self.axis)
        grads = {"X@GRAD": [torch.cat(dxs).reshape(x.shape)]}

        def grad_of(t):
            g = t.grad if isinstance(t, torch.Tensor) and t.requires_grad \
                else None
            return torch.zeros_like(t) if g is None else g

        grads["StackedParams@GRAD"] = [
            torch.stack([grad_of(self.params[l][j])
                         for l in range(self.layers)])
            for j in range(len(self.stacked))]
        ex_grads = []
        for n in self.ex:
            g = grad_of(self.ex_leaves[n])
            if self.axis is not None and g.is_floating_point():
                g = penv.psum(g, self.axis)
            ex_grads.append(g)
        if ex_grads:
            grads["Ex@GRAD"] = ex_grads
        return grads


@register_op("pipeline_stack", stateful=True, needs_block=True,
             saves_for_grad=True)
def _pipeline_stack(ins, attrs):
    if "__runner__" not in ins:
        # shape inference: the output has the input's shape
        x = ins["X"][0]
        return {"Out": [torch.empty_like(x)]}
    run = _Stack(ins, attrs)
    keep = bool(attrs.get("_save_for_grad"))
    out = run.forward(keep)
    if keep:
        out._pipeline_stack_run = run
    return {"Out": [out]}


@register_grad("pipeline_stack")
def _pipeline_stack_grad(ins, attrs):
    out = ins["Out"][0]
    run = getattr(out, "_pipeline_stack_run", None)
    if run is None:
        raise EnforceError(
            "pipeline_stack_grad needs its forward kept for the grad "
            "(_save_for_grad): running the forward again would repeat "
            "every send, receive and all-reduce of the stack")
    del out._pipeline_stack_run
    return run.backward(ins["Out@GRAD"][0])
