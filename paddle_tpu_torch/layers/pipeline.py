"""PipelinedStack: build a pipelined layer stack in the Program IR, the
counterpart of the JAX package's ``layers/pipeline.py``.

The user writes the per-layer body ONCE inside ``with stack.layer():``
(the way StaticRNN declares its step); parameters created through
``stack.layer_param`` are stacked with a leading ``[num_layers]`` axis,
and the whole stack lowers to ONE ``pipeline_stack`` op
(``ops/pipeline.py``) that runs the GPipe schedule over the mesh's
``stage`` axis under ``CompiledProgram.with_parallel`` (reference:
python/paddle/fluid/optimizer.py:3414 PipelineOptimizer +
section_worker.cc:142).

    stack = layers.PipelinedStack(num_layers=12, num_microbatches=4)
    with stack.layer():
        h = stack.input(x)                       # [mb, S, H] per microbatch
        w = stack.layer_param([H, H], spec=(None, "model"))
        h2 = ops using h, w ...
        stack.output(h2)
    out = stack()                                # same shape as x

Pass ``stack.param_spec_overrides()`` into ``with_parallel(param_specs=
...)`` so each rank holds its stage's layers (and its shard of each
layer's dims). Homogeneous stages only: every pipelined layer shares one
body and one stacked param shape; embedding and head stages live outside
the stack in the same program (``models/gpt_ir.py``).
"""

from paddle_tpu_torch.core.ir import default_main_program
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr
from paddle_tpu_torch.parallel.pipeline import SCHEDULE_KINDS
from paddle_tpu_torch.parallel.sharding import P
from paddle_tpu_torch.utils.enforce import enforce

__all__ = ["PipelinedStack"]


class PipelinedStack:
    def __init__(self, num_layers, num_microbatches=1, stage_axis="stage",
                 ring_bindings=None, schedule="gpipe", interleave=None,
                 name=None):
        self.helper = LayerHelper("pipelined_stack", name=name)
        self.program = default_main_program()
        self.num_layers = int(num_layers)
        self.num_microbatches = int(num_microbatches)
        self.stage_axis = stage_axis
        # schedule: 'gpipe' | '1f1b' (interleaved; `interleave` chunks per
        # device). The port runs gpipe; the op raises naming M11 for 1f1b
        enforce(schedule in SCHEDULE_KINDS,
                f"PipelinedStack schedule must be one of {SCHEDULE_KINDS},"
                f" got {schedule!r}")
        self.schedule = schedule
        self.interleave = int(interleave) if interleave else None
        # ring_id -> mesh axis for collectives inside the body (TP psum)
        self.ring_bindings = dict(ring_bindings or {})
        self._entered = False
        self._input = None        # (outer_name, inner_name)
        self._output = None
        self._params = []         # (outer stacked name, inner name, spec)

    # -- body context ---------------------------------------------------
    class _Layer:
        def __init__(self, stack):
            self.stack = stack

        def __enter__(self):
            st = self.stack
            st.parent_idx = st.program.current_block_idx
            st.sub_block = st.program._create_block()
            st._entered = True
            return st

        def __exit__(self, exc_type, exc_val, exc_tb):
            self.stack.program._rollback()
            if exc_type is None:
                self.stack._complete()
            return False

    def layer(self):
        return PipelinedStack._Layer(self)

    # -- construction API ------------------------------------------------
    def input(self, x):
        enforce(self._entered, "input() must be called inside stack.layer()")
        enforce(self._input is None, "PipelinedStack takes ONE input")
        shape = list(x.shape) if x.shape else None
        # body sees one microbatch: batch dim shrinks to B/M (dynamic)
        if shape:
            shape = [-1] + shape[1:]
        inner = self.sub_block.create_var(
            name=f"{self.helper.name}.h_in", shape=shape, dtype=x.dtype
        )
        self._input = (x.name, inner.name)
        return inner

    def layer_param(self, shape, dtype="float32", attr=None, spec=None,
                    is_bias=False):
        """A per-layer parameter [*shape]; storage is stacked
        [num_layers, *shape]. `spec` gives the non-stage partition of the
        per-layer dims (e.g. (None, 'model') for a column-parallel matmul);
        the stacked array's spec becomes ('stage', *spec)."""
        enforce(self._entered, "layer_param() must be inside stack.layer()")
        attr = ParamAttr._to_attr(attr)
        if attr is None or attr is False:
            attr = ParamAttr()
        stacked_shape = [self.num_layers] + list(shape)
        # create the stacked parameter in the parent scope
        cur = self.program.current_block_idx
        self.program._rollback()
        try:
            p = self.helper.create_parameter(
                attr, shape=stacked_shape, dtype=dtype, is_bias=is_bias
            )
        finally:
            self.program.current_block_idx = cur
        inner = self.sub_block.create_var(
            name=f"{self.helper.name}.p_{len(self._params)}",
            shape=list(shape),
            dtype=dtype,
        )
        self._params.append(
            (p.name, inner.name, tuple(spec) if spec else ())
        )
        return inner

    def output(self, o):
        enforce(self._entered, "output() must be inside stack.layer()")
        enforce(self._output is None, "PipelinedStack produces ONE output")
        self._output = o.name

    # -- completion -----------------------------------------------------
    def _complete(self):
        enforce(self._input is not None, "PipelinedStack needs input()")
        enforce(self._output is not None, "PipelinedStack needs output()")
        parent = self.program.block(self.parent_idx)
        produced = {self._input[1]} | {inner for _, inner, _ in self._params}
        ex = []
        for sop in self.sub_block.ops:
            for n in sop.input_names():
                if n in produced or n in ex:
                    continue
                if parent._find_var_recursive(n) is not None:
                    ex.append(n)
            produced.update(sop.output_names())
        x_var = parent._find_var_recursive(self._input[0])
        out = parent.create_var(
            name=f"{self.helper.name}.out",
            shape=list(x_var.shape) if x_var.shape else None,
            dtype=x_var.dtype,
        )
        parent.append_op(
            "pipeline_stack",
            {
                "X": [self._input[0]],
                "StackedParams": [n for n, _, _ in self._params],
                "Ex": list(ex),
            },
            {"Out": [out.name]},
            {
                "sub_block": self.sub_block.idx,
                "inner_x": self._input[1],
                "inner_out": self._output,
                "param_inner_vars": [i for _, i, _ in self._params],
                "param_specs": [list(s) for _, _, s in self._params],
                "ex_vars": list(ex),
                "num_microbatches": self.num_microbatches,
                "stage_axis": self.stage_axis,
                "ring_bindings": self.ring_bindings,
                "schedule": self.schedule,
                "interleave": self.interleave,
            },
        )
        self._result = out

    def __call__(self):
        enforce(hasattr(self, "_result"), "PipelinedStack not completed")
        return self._result

    def param_spec_overrides(self):
        """{stacked param name: PartitionSpec('stage', *per-layer spec)} —
        feed to CompiledProgram.with_parallel(param_specs=...)."""
        return {
            name: P(self.stage_axis, *spec)
            for name, _, spec in self._params
        }
