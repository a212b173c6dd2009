"""Dygraph module library (reference: python/paddle/fluid/dygraph/nn.py —
Conv2D, Pool2D, Linear, BatchNorm, Embedding, LayerNorm, Dropout, ...).

Every module's forward is written against `trace_op`, so the same code runs
eagerly in dygraph mode and appends ops under static capture (jit.py) — the
dual-dispatch design the reference implements with tracer-vs-LayerHelper."""

import numpy as np

from paddle_tpu_torch.dygraph.base import trace_op
from paddle_tpu_torch.dygraph.layers import Layer
from paddle_tpu_torch.initializer import ConstantInitializer, NormalInitializer
from paddle_tpu_torch.utils.enforce import enforce


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


class Linear(Layer):
    """reference: python/paddle/fluid/dygraph/nn.py Linear."""

    def __init__(self, input_dim, output_dim, param_attr=None, bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter([input_dim, output_dim], attr=param_attr, dtype=dtype)
        self.bias = (
            None
            if bias_attr is False
            else self.create_parameter([output_dim], attr=bias_attr, dtype=dtype, is_bias=True)
        )
        self._act = act

    def forward(self, input):
        out = trace_op(
            "mul",
            {"X": [input], "Y": [self.weight]},
            {"x_num_col_dims": len(input.shape) - 1, "y_num_col_dims": 1},
        )["Out"][0]
        if self.bias is not None:
            out = trace_op(
                "elementwise_add",
                {"X": [out], "Y": [self.bias]},
                {"axis": len(out.shape) - 1},
            )["Out"][0]
        return _apply_act(out, self._act)


def _apply_act(x, act):
    if act is None:
        return x
    return trace_op(act, {"X": [x]}, {})["Out"][0]


class Conv2D(Layer):
    """reference: python/paddle/fluid/dygraph/nn.py Conv2D (NCHW)."""

    def __init__(
        self,
        num_channels,
        num_filters,
        filter_size,
        stride=1,
        padding=0,
        dilation=1,
        groups=1,
        param_attr=None,
        bias_attr=None,
        use_cudnn=True,
        act=None,
        dtype="float32",
    ):
        super().__init__(dtype=dtype)
        ksize = _pair(filter_size)
        self._attrs = {
            "strides": _pair(stride),
            "paddings": _pair(padding),
            "dilations": _pair(dilation),
            "groups": groups or 1,
        }
        std = (2.0 / (ksize[0] * ksize[1] * num_channels)) ** 0.5
        self.weight = self.create_parameter(
            [num_filters, num_channels // (groups or 1), *ksize],
            attr=param_attr,
            dtype=dtype,
            default_initializer=NormalInitializer(0.0, std),
        )
        self.bias = (
            None
            if bias_attr is False
            else self.create_parameter([num_filters], attr=bias_attr, dtype=dtype, is_bias=True)
        )
        self._act = act

    def forward(self, input):
        out = trace_op(
            "conv2d", {"Input": [input], "Filter": [self.weight]}, self._attrs
        )["Output"][0]
        if self.bias is not None:
            out = trace_op(
                "elementwise_add", {"X": [out], "Y": [self.bias]}, {"axis": 1}
            )["Out"][0]
        return _apply_act(out, self._act)


class Conv2DTranspose(Layer):
    def __init__(
        self,
        num_channels,
        num_filters,
        filter_size,
        output_size=None,
        padding=0,
        stride=1,
        dilation=1,
        groups=1,
        param_attr=None,
        bias_attr=None,
        act=None,
        dtype="float32",
    ):
        super().__init__(dtype=dtype)
        ksize = _pair(filter_size)
        self._attrs = {
            "strides": _pair(stride),
            "paddings": _pair(padding),
            "dilations": _pair(dilation),
            "groups": groups or 1,
        }
        self.weight = self.create_parameter(
            [num_channels, num_filters // (groups or 1), *ksize],
            attr=param_attr,
            dtype=dtype,
        )
        self.bias = (
            None
            if bias_attr is False
            else self.create_parameter([num_filters], attr=bias_attr, dtype=dtype, is_bias=True)
        )
        self._act = act

    def forward(self, input):
        out = trace_op(
            "conv2d_transpose",
            {"Input": [input], "Filter": [self.weight]},
            self._attrs,
        )["Output"][0]
        if self.bias is not None:
            out = trace_op(
                "elementwise_add", {"X": [out], "Y": [self.bias]}, {"axis": 1}
            )["Out"][0]
        return _apply_act(out, self._act)


class Pool2D(Layer):
    """reference: python/paddle/fluid/dygraph/nn.py Pool2D."""

    def __init__(
        self,
        pool_size=-1,
        pool_type="max",
        pool_stride=1,
        pool_padding=0,
        global_pooling=False,
        use_cudnn=True,
        ceil_mode=False,
        exclusive=True,
    ):
        super().__init__()
        self._attrs = {
            "pooling_type": pool_type,
            "ksize": _pair(pool_size),
            "strides": _pair(pool_stride),
            "paddings": _pair(pool_padding),
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        }

    def forward(self, input):
        return trace_op("pool2d", {"X": [input]}, self._attrs)["Out"][0]


class BatchNorm(Layer):
    """reference: python/paddle/fluid/dygraph/nn.py BatchNorm. Running stats
    are buffers; train-mode forward re-binds them to the op's MeanOut/
    VarianceOut (functional update, not mutation)."""

    def __init__(
        self,
        num_channels,
        act=None,
        is_test=False,
        momentum=0.9,
        epsilon=1e-5,
        param_attr=None,
        bias_attr=None,
        dtype="float32",
        data_layout="NCHW",
        use_global_stats=False,
    ):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [num_channels], attr=param_attr, dtype=dtype,
            default_initializer=ConstantInitializer(1.0),
        )
        self.bias = self.create_parameter(
            [num_channels], attr=bias_attr, dtype=dtype, is_bias=True
        )
        self._mean = self.register_buffer("_mean", np.zeros(num_channels, dtype))
        self._variance = self.register_buffer("_variance", np.ones(num_channels, dtype))
        self._attrs = {
            "momentum": momentum,
            "epsilon": epsilon,
            "data_layout": data_layout,
            "use_global_stats": use_global_stats,
        }
        self._act = act

    def forward(self, input):
        attrs = dict(self._attrs, is_test=not self.training)
        outs = trace_op(
            "batch_norm",
            {
                "X": [input],
                "Scale": [self.weight],
                "Bias": [self.bias],
                "Mean": [self._mean],
                "Variance": [self._variance],
            },
            attrs,
        )
        if self.training and outs.get("MeanOut") and outs["MeanOut"][0] is not None:
            if outs["MeanOut"][0].value is not None:
                self._mean.value = outs["MeanOut"][0].value
                self._variance.value = outs["VarianceOut"][0].value
        return _apply_act(outs["Y"][0], self._act)


class LayerNorm(Layer):
    def __init__(
        self,
        normalized_shape,
        scale=True,
        shift=True,
        begin_norm_axis=1,
        epsilon=1e-5,
        param_attr=None,
        bias_attr=None,
        act=None,
        dtype="float32",
    ):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        n = int(np.prod(normalized_shape))
        self.weight = (
            self.create_parameter([n], attr=param_attr, dtype=dtype,
                                  default_initializer=ConstantInitializer(1.0))
            if scale
            else None
        )
        self.bias = (
            self.create_parameter([n], attr=bias_attr, dtype=dtype, is_bias=True)
            if shift
            else None
        )
        self._attrs = {"begin_norm_axis": begin_norm_axis, "epsilon": epsilon}
        self._act = act

    def forward(self, input):
        ins = {"X": [input]}
        if self.weight is not None:
            ins["Scale"] = [self.weight]
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        out = trace_op("layer_norm", ins, self._attrs)["Y"][0]
        return _apply_act(out, self._act)


class GroupNorm(Layer):
    def __init__(self, channels, groups, epsilon=1e-5, param_attr=None, bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [channels], attr=param_attr, dtype=dtype,
            default_initializer=ConstantInitializer(1.0),
        )
        self.bias = self.create_parameter([channels], attr=bias_attr, dtype=dtype, is_bias=True)
        self._attrs = {"groups": groups, "epsilon": epsilon}
        self._act = act

    def forward(self, input):
        out = trace_op(
            "group_norm",
            {"X": [input], "Scale": [self.weight], "Bias": [self.bias]},
            self._attrs,
        )["Y"][0]
        return _apply_act(out, self._act)


class InstanceNorm(Layer):
    def __init__(self, num_channels, epsilon=1e-5, param_attr=None, bias_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [num_channels], attr=param_attr, dtype=dtype,
            default_initializer=ConstantInitializer(1.0),
        )
        self.bias = self.create_parameter([num_channels], attr=bias_attr, dtype=dtype, is_bias=True)
        self._attrs = {"epsilon": epsilon}

    def forward(self, input):
        return trace_op(
            "instance_norm",
            {"X": [input], "Scale": [self.weight], "Bias": [self.bias]},
            self._attrs,
        )["Y"][0]


class Embedding(Layer):
    """reference: python/paddle/fluid/dygraph/nn.py Embedding."""

    def __init__(self, size, is_sparse=False, is_distributed=False, padding_idx=None, param_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        enforce(len(size) == 2, "Embedding size must be [vocab, dim]")
        self.weight = self.create_parameter(list(size), attr=param_attr, dtype=dtype)
        self._attrs = {
            "padding_idx": -1 if padding_idx is None else padding_idx,
            "is_sparse": is_sparse,
        }

    def forward(self, input):
        return trace_op(
            "lookup_table_v2", {"W": [self.weight], "Ids": [input]}, self._attrs
        )["Out"][0]


class Dropout(Layer):
    def __init__(self, p=0.5, dropout_implementation="downgrade_in_infer", is_test=False):
        super().__init__()
        self._attrs = {
            "dropout_prob": p,
            "dropout_implementation": dropout_implementation,
        }

    def forward(self, input):
        attrs = dict(self._attrs, is_test=not self.training)
        return trace_op("dropout", {"X": [input]}, attrs)["Out"][0]


class PRelu(Layer):
    def __init__(self, mode="all", channel=None, input_shape=None, param_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        if mode == "all":
            shape = [1]
        elif mode == "channel":
            shape = [channel]
        else:
            shape = list(input_shape)[1:]
        self.weight = self.create_parameter(
            shape, attr=param_attr, dtype=dtype,
            default_initializer=ConstantInitializer(0.25),
        )
        self._mode = mode

    def forward(self, input):
        return trace_op(
            "prelu", {"X": [input], "Alpha": [self.weight]}, {"mode": self._mode}
        )["Out"][0]


class GRUUnit(Layer):
    """Single GRU step (reference: python/paddle/fluid/dygraph/nn.py GRUUnit,
    operators/gru_unit_op.cc). Composed from registry ops so it traces in
    both modes."""

    def __init__(self, size, param_attr=None, bias_attr=None, activation="tanh", gate_activation="sigmoid", dtype="float32"):
        super().__init__(dtype=dtype)
        self._hidden = size // 3
        d = self._hidden
        self.weight = self.create_parameter([d, d * 3], attr=param_attr, dtype=dtype)
        self.bias = (
            None
            if bias_attr is False
            else self.create_parameter([1, d * 3], attr=bias_attr, dtype=dtype, is_bias=True)
        )
        self._activation = activation
        self._gate_activation = gate_activation

    def forward(self, input, hidden):
        d = self._hidden

        def mm(a, b):
            return trace_op("matmul", {"X": [a], "Y": [b]}, {})["Out"][0]

        def sl(x, s, e):
            return trace_op(
                "slice", {"Input": [x]}, {"axes": [1], "starts": [s], "ends": [e]}
            )["Out"][0]

        gate_w = sl(self.weight, 0, d * 2)
        cand_w = sl(self.weight, d * 2, d * 3)
        xu = sl(input, 0, d)
        xr = sl(input, d, d * 2)
        xc = sl(input, d * 2, d * 3)
        hg = mm(hidden, gate_w)
        if self.bias is not None:
            bg = sl(self.bias, 0, d * 2)
            hg = hg + bg
        u = _apply_act(xu + sl(hg, 0, d), self._gate_activation)
        r = _apply_act(xr + sl(hg, d, d * 2), self._gate_activation)
        rh = r * hidden
        c = mm(rh, cand_w)
        if self.bias is not None:
            c = c + sl(self.bias, d * 2, d * 3)
        c = _apply_act(xc + c, self._activation)
        new_h = u * hidden + (1.0 - u) * c
        return new_h, new_h, c
