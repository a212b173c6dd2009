"""Static op signatures: the declared-metadata constraints an op desc must
satisfy for its lowering to be well-typed, copied from the JAX package's
``analysis/signatures.py`` (the same table, so both verifiers refuse the
same programs).

The reference encodes these per-op in C++ InferShape/GetExpectedKernelType
(reference: paddle/fluid/framework/shape_inference.h, operator.cc). The
port's lowerings find a violation only when they run; this table gives
the verifier (``analysis/verify.py``) the *static* subset: rank
requirements on declared shapes and same-dtype groups over declared
dtypes, checked without running anything.

Only constraints that hold for EVERY legal call site belong here — the
verifier must never flag a well-formed program.
"""

__all__ = ["OpSignature", "get_signature"]


class OpSignature:
    """Constraints over an op desc's declared var metadata.

    same_dtype: groups of input/output slot names whose declared dtypes must
        all agree; every list member of each named slot participates
        (members with undeclared dtypes are skipped), so a single-slot
        group like ``("X",)`` requires all of that slot's members to match.
    ranks: {slot: rank or tuple-of-ranks} required len(shape) for the slot's
        members with declared shapes.
    dtype_family: {slot: family} where family is a dtype-name prefix
        ("float", "int", "bool", "uint") every declared member dtype must
        start with.
    """

    def __init__(self, same_dtype=(), ranks=None, dtype_family=None):
        self.same_dtype = tuple(tuple(g) for g in same_dtype)
        self.ranks = dict(ranks or {})
        self.dtype_family = dict(dtype_family or {})


_ELEMENTWISE = OpSignature(same_dtype=[("X", "Y")])

#: op type -> signature for the built-in op set. Extend alongside new ops.
_SIGNATURES = {
    # no rank constraint on mul: x/y_num_col_dims flatten arbitrary ranks
    "mul": OpSignature(same_dtype=[("X", "Y")]),
    "matmul": OpSignature(same_dtype=[("X", "Y")]),
    "elementwise_add": _ELEMENTWISE,
    "elementwise_sub": _ELEMENTWISE,
    "elementwise_mul": _ELEMENTWISE,
    "elementwise_div": _ELEMENTWISE,
    "elementwise_min": _ELEMENTWISE,
    "elementwise_max": _ELEMENTWISE,
    "elementwise_pow": _ELEMENTWISE,
    "sum": OpSignature(same_dtype=[("X",)]),
    "fc": OpSignature(
        same_dtype=[("Input", "W", "Bias")], ranks={"W": 2, "Bias": 1}
    ),
    "conv2d": OpSignature(
        same_dtype=[("Input", "Filter")], ranks={"Filter": 4}
    ),
    "depthwise_conv2d": OpSignature(
        same_dtype=[("Input", "Filter")], ranks={"Filter": 4}
    ),
    "batch_norm": OpSignature(
        ranks={"Scale": 1, "Bias": 1, "Mean": 1, "Variance": 1},
        dtype_family={"X": "float"},
    ),
    "scaled_dot_product_attention": OpSignature(
        same_dtype=[("Q", "K", "V")], ranks={"Q": 4, "K": 4, "V": 4}
    ),
    "cached_attention": OpSignature(
        same_dtype=[("Q", "KCache", "VCache", "Bias")],
        ranks={"Q": 2, "KCache": 3, "VCache": 3, "Bias": 3},
        dtype_family={"Q": "float"},
    ),
    "paged_attention": OpSignature(
        same_dtype=[("Q", "KArena", "VArena", "Bias")],
        ranks={"Q": 2, "KArena": 2, "VArena": 2, "Rows": 1, "Bias": 3},
        dtype_family={"Q": "float", "Rows": "int"},
    ),
    "lookup_table": OpSignature(
        dtype_family={"Ids": "int", "W": "float"}, ranks={"W": 2}
    ),
    "lookup_table_v2": OpSignature(
        dtype_family={"Ids": "int", "W": "float"}, ranks={"W": 2}
    ),
    "sgd": OpSignature(same_dtype=[("Param", "Grad")]),
    "softmax": OpSignature(dtype_family={"X": "float"}),
    "layer_norm": OpSignature(dtype_family={"X": "float"}),
    "dropout": OpSignature(dtype_family={"X": "float"}),
    # every op type the examples' programs and the JAX package's model
    # builders emit carries a signature, so the verifier covers them all
    # (the port has no lowering yet for some of them). Constraint
    # strength varies — an entry with no fields still marks the op as
    # audited (nothing about it is statically checkable for EVERY legal
    # call site, the verifier's hard rule).
    "adam": OpSignature(
        same_dtype=[("Param", "Moment1", "Moment2")],
        dtype_family={"Param": "float"},
    ),
    "momentum": OpSignature(same_dtype=[("Param", "Grad", "Velocity")]),
    "accuracy": OpSignature(dtype_family={"Indices": "int", "Label": "int"}),
    "assign": OpSignature(),
    "assign_value": OpSignature(),
    "cast": OpSignature(),
    "concat": OpSignature(same_dtype=[("X",)]),
    "cross_entropy": OpSignature(dtype_family={"X": "float"}),
    "fill_constant": OpSignature(),
    "fill_constant_batch_size_like": OpSignature(),
    "fill_zeros_like": OpSignature(),
    "gaussian_random": OpSignature(),
    "uniform_random": OpSignature(),
    "truncated_gaussian_random": OpSignature(),
    "log_softmax": OpSignature(dtype_family={"X": "float"}),
    "mean": OpSignature(dtype_family={"X": "float"}),
    "not_equal": OpSignature(),
    "equal": OpSignature(),
    "less_than": OpSignature(same_dtype=[("X", "Y")]),
    "less_equal": OpSignature(same_dtype=[("X", "Y")]),
    "greater_than": OpSignature(same_dtype=[("X", "Y")]),
    "pool2d": OpSignature(ranks={"X": 4}),
    "reduce_sum": OpSignature(),
    "reduce_mean": OpSignature(dtype_family={"X": "float"}),
    "reduce_max": OpSignature(),
    "relu": OpSignature(dtype_family={"X": "float"}),
    "sigmoid": OpSignature(dtype_family={"X": "float"}),
    "tanh": OpSignature(dtype_family={"X": "float"}),
    "gelu": OpSignature(dtype_family={"X": "float"}),
    # NO dtype tie between X and Out on the layout ops: declared int
    # widths legitimately drift (builders declare int32 or int64) while
    # the lowering preserves the runtime dtype regardless
    "reshape2": OpSignature(),
    "reshape": OpSignature(),
    "transpose2": OpSignature(),
    "transpose": OpSignature(),
    "squeeze2": OpSignature(),
    "unsqueeze2": OpSignature(),
    "flatten2": OpSignature(),
    "scale": OpSignature(),
    "sharded_embedding_lookup": OpSignature(
        dtype_family={"Table": "float", "Ids": "int"}, ranks={"Table": 2}
    ),
    "sharded_embedding_sgd": OpSignature(
        dtype_family={"Table": "float"}, ranks={"Table": 2}
    ),
    "sigmoid_cross_entropy_with_logits": OpSignature(
        dtype_family={"X": "float"}
    ),
    "softmax_with_cross_entropy": OpSignature(
        dtype_family={"Logits": "float"}
    ),
    "square_error_cost": OpSignature(
        same_dtype=[("X", "Y")], dtype_family={"X": "float"}
    ),
    "top_k": OpSignature(),
    "one_hot": OpSignature(dtype_family={"X": "int"}),
    "batched_gather": OpSignature(dtype_family={"Index": "int"}),
    "gather": OpSignature(dtype_family={"Index": "int"}),
    "scatter": OpSignature(dtype_family={"Ids": "int"}),
    "stack": OpSignature(same_dtype=[("X",)]),
    "slice": OpSignature(),
    "split": OpSignature(),
    "elementwise_mod": _ELEMENTWISE,
    "elementwise_floordiv": _ELEMENTWISE,
    "increment": OpSignature(),
    "shape": OpSignature(),
    "where": OpSignature(same_dtype=[("X", "Y")]),
    "arg_max": OpSignature(),
    "exp": OpSignature(dtype_family={"X": "float"}),
    "sqrt": OpSignature(dtype_family={"X": "float"}),
    "square": OpSignature(dtype_family={"X": "float"}),
    "clip": OpSignature(),
    "expand": OpSignature(),
    # the JAX package's pipeline/MoE ops: pipeline_stack wraps a sub-block (the
    # per-layer body is verified op-by-op through its own block), so the
    # wrapper itself only pins the carried activation dtype; moe_ffn ties
    # the routed activations to the stacked expert weights
    "pipeline_stack": OpSignature(dtype_family={"X": "float"}),
    "moe_ffn": OpSignature(
        same_dtype=[("X", "GateW", "W1", "W2")],
        dtype_family={"X": "float"},
        ranks={"GateW": 2, "W1": 3, "B1": 2, "W2": 3, "B2": 2},
    ),
}


def get_signature(op_type):
    """Signature for ``op_type``, or None."""
    return _SIGNATURES.get(op_type)
