"""The common layer surface of the port (M12a): every layer function of
``paddle_tpu_torch.layers`` this slice adds builds the program the JAX
package's builds — op types, slots, attributes, var names and shapes,
parameters and startup ops — and the port's program runs on the CPU,
with every fetch finite and of the shape the build inferred.

Var dtypes are compared too, except where the JAX package runs an int64
var as int32 (64-bit types off) that the port keeps int64
(``core/dtypes.py``). Var shapes are compared where the JAX build
inferred one: the JAX package's ``split`` with ``sections`` cannot
(``jnp.cumsum`` of the sections is traced under ``jax.eval_shape``), the
port's can.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as pt
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.utils import unique_name as torch_names

R = np.random.RandomState(37)

# every feed a builder may declare: name -> (declared shape, array)
FEEDS = {
    "x": ([-1, 4, 6, 6], R.randn(2, 4, 6, 6).astype(np.float32)),
    "y": ([-1, 4, 6, 6], R.randn(2, 4, 6, 6).astype(np.float32)),
    "v": ([-1, 8], R.randn(2, 8).astype(np.float32)),
    "w": ([-1, 8], R.randn(2, 8).astype(np.float32)),
    "p": ([-1, 8], R.uniform(0.1, 0.9, (2, 8)).astype(np.float32)),
    "lab": ([-1, 1], np.array([[1.0], [0.0]], np.float32)),
    "ids": ([-1, 1], np.array([[3], [7]], np.int64)),
    "nd": ([3, 2], np.array([[1, 1], [0, 0], [1, 1]], np.int64)),
    "d": ([5], R.randn(5).astype(np.float32)),
}
_INT = {"ids": "int64", "nd": "int64"}


def _data(mod, name):
    shape, _ = FEEDS[name]
    return mod.data(name, shape, dtype=_INT.get(name, "float32"))


# layer -> builder(mod, feed) returning the var(s) to fetch
LAYERS = {
    # layers/nn.py
    **{n: (lambda n: lambda m, f: getattr(m.layers, n)(f("x")))(n)
       for n in ("abs", "cos", "sin", "exp", "tanh", "erf", "softplus",
                 "softsign", "relu6", "hard_sigmoid", "hard_swish", "elu",
                 "leaky_relu", "swish")},
    "log": lambda m, f: m.layers.log(m.layers.exp(f("x"))),
    "sqrt": lambda m, f: m.layers.sqrt(m.layers.abs(f("x"))),
    "leaky_relu_alpha": lambda m, f: m.layers.leaky_relu(f("x"), alpha=0.1),
    "argmax": lambda m, f: m.layers.argmax(f("v"), axis=1),
    "argmin": lambda m, f: m.layers.argmin(f("v"), axis=-1),
    "elementwise_pow": lambda m, f: m.layers.elementwise_pow(
        m.layers.abs(f("x")), f("y")),
    "huber_loss": lambda m, f: m.layers.huber_loss(f("v"), f("w"), delta=0.5),
    "kldiv_loss": lambda m, f: m.layers.kldiv_loss(f("v"), f("p"),
                                                   reduction="batchmean"),
    "mse_loss": lambda m, f: m.layers.mse_loss(f("v"), f("w")),
    "one_hot": lambda m, f: m.layers.one_hot(f("ids"), depth=10),
    "reduce_mean": lambda m, f: m.layers.reduce_mean(f("x"), dim=[2, 3]),
    "reduce_max": lambda m, f: m.layers.reduce_max(f("x"), dim=[1],
                                                   keep_dim=True),
    "reduce_min": lambda m, f: m.layers.reduce_min(f("v")),
    "reduce_prod": lambda m, f: m.layers.reduce_prod(f("p"), dim=[1]),
    "mul": lambda m, f: m.layers.mul(f("v"), m.layers.transpose(f("w"),
                                                                [1, 0])),
    "prelu": lambda m, f: m.layers.prelu(f("x"), mode="channel"),
    "group_norm": lambda m, f: m.layers.group_norm(f("x"), groups=2,
                                                   act="relu"),
    "instance_norm": lambda m, f: m.layers.instance_norm(f("x")),
    "conv2d_transpose": lambda m, f: m.layers.conv2d_transpose(
        f("x"), num_filters=6, filter_size=3, stride=2, padding=1),
    # layers/tensor.py
    "cond_select": lambda m, f: m.layers.cond_select(
        m.layers.greater_than(f("v"), f("w")), f("v"), f("w")),
    "create_tensor": lambda m, f: m.layers.assign(
        f("v"), output=m.layers.create_tensor("float32")),
    "cumsum": lambda m, f: m.layers.cumsum(f("v"), axis=1, exclusive=True,
                                           reverse=True),
    "expand": lambda m, f: m.layers.expand(f("v"), [2, 3]),
    "fill_constant_batch_size_like":
        lambda m, f: m.layers.fill_constant_batch_size_like(
            f("v"), [-1, 3], "float32", 0.5),
    "gather_nd": lambda m, f: m.layers.gather_nd(
        m.layers.reshape(f("v"), [2, 2, 4]), f("nd")),
    "isfinite": lambda m, f: m.layers.isfinite(f("x")),
    "linspace": lambda m, f: m.layers.linspace(0.5, 2.0, 7),
    "ones": lambda m, f: m.layers.ones([2, 3], "float32"),
    "ones_like": lambda m, f: m.layers.ones_like(f("v")),
    "pad": lambda m, f: m.layers.pad(f("v"), [0, 1, 2, 0], pad_value=1.5),
    "range": lambda m, f: m.layers.range(0, 5, 0.5),
    "shape": lambda m, f: m.layers.shape(f("x")),
    "split": lambda m, f: m.layers.split(f("x"), [1, 3], dim=1),
    "split_num": lambda m, f: m.layers.split(f("v"), 4, dim=-1),
    "stack": lambda m, f: m.layers.stack([f("v"), f("w")], axis=1),
    "unstack": lambda m, f: m.layers.unstack(f("x"), axis=1),
    "zeros": lambda m, f: m.layers.zeros([3], "int64"),
    "zeros_like": lambda m, f: m.layers.zeros_like(f("x")),
    "flatten": lambda m, f: m.layers.flatten(f("x"), axis=2),
    # layers/nn_extra.py
    "argsort": lambda m, f: m.layers.argsort(f("v"), descending=True),
    "brelu": lambda m, f: m.layers.brelu(f("x"), t_min=-0.5, t_max=0.5),
    "crop_tensor": lambda m, f: m.layers.crop_tensor(f("x"), [2, 2, 3, 3],
                                                     [0, 1, 2, 0]),
    "diag": lambda m, f: m.layers.diag(f("d")),
    "expand_as": lambda m, f: m.layers.expand_as(
        m.layers.reduce_sum(f("v"), dim=[0], keep_dim=True), f("w")),
    "eye": lambda m, f: m.layers.eye(3, 4),
    "label_smooth": lambda m, f: m.layers.label_smooth(
        m.layers.one_hot(f("ids"), depth=10), epsilon=0.2),
    "log_loss": lambda m, f: m.layers.log_loss(
        m.layers.slice(f("p"), axes=[1], starts=[0], ends=[1]), f("lab")),
    "pad2d": lambda m, f: m.layers.pad2d(f("x"), [1, 0, 2, 1], mode="reflect"),
    "rank": lambda m, f: m.layers.rank(f("x")),
    "reverse": lambda m, f: m.layers.reverse(f("x"), [1, 3]),
    "scatter_nd_add": lambda m, f: m.layers.scatter_nd_add(
        m.layers.reshape(f("v"), [2, 2, 4]), f("nd"),
        m.layers.slice(m.layers.reshape(f("w"), [4, 4]), axes=[0],
                       starts=[0], ends=[3])),
    "selu": lambda m, f: m.layers.selu(f("x")),
    "sign": lambda m, f: m.layers.sign(f("x")),
    "size": lambda m, f: m.layers.size(f("x")),
    "soft_relu": lambda m, f: m.layers.soft_relu(f("x"), threshold=1.0),
    "stanh": lambda m, f: m.layers.stanh(f("x")),
    "strided_slice": lambda m, f: m.layers.strided_slice(
        f("x"), axes=[2, 3], starts=[-1, 0], ends=[-7, 6], strides=[-2, 2]),
    "adaptive_pool2d": lambda m, f: m.layers.adaptive_pool2d(f("x"), 3,
                                                             pool_type="max"),
    # layers/extras.py and layers/extra3.py
    "hinge_loss": lambda m, f: m.layers.hinge_loss(
        m.layers.slice(f("v"), axes=[1], starts=[0], ends=[1]), f("lab")),
    "unique": lambda m, f: m.layers.unique(
        m.layers.reshape(f("ids"), [-1]), dtype="int64"),
}


def _build(mod, names, builder):
    main, startup = mod.Program(), mod.Program()
    declared = []

    def feed(name):
        declared.append(name)
        return _data(mod, name)

    with names.guard(), mod.program_guard(main, startup):
        out = builder(mod, feed)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    return main, startup, declared, outs


# a fault of both packages' shape inference (``layer_helper.py``): a
# dynamic dim runs as the sentinel 1031 and maps back to -1 only when the
# output dim is a multiple of it, so ``pad`` of a batch of -1 by 1 declares
# 1032 rows (ROADMAP queue C;
# test_a_padded_dynamic_dim_declares_the_sentinel_in_both_packages)
SENTINEL_DIMS = {"pad": 1032}


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_builds_the_jax_program(layer):
    jmain, jstartup, _, jouts = _build(jfluid, jax_names, LAYERS[layer])
    tmain, tstartup, _, touts = _build(pt, torch_names, LAYERS[layer])
    for want, got in ((jmain, tmain), (jstartup, tstartup)):
        wb, gb = want.global_block(), got.global_block()
        assert [op.desc() for op in gb.ops] == [op.desc() for op in wb.ops]
        wv = [v.desc() for v in wb.vars.values()]
        gv = [v.desc() for v in gb.vars.values()]
        for w, g in zip(wv, gv):
            if w["dtype"] == "int32" and g["dtype"] == "int64":
                w["dtype"] = "int64"
            if w["shape"] is None:
                w["shape"] = g["shape"]
        assert gv == wv
    assert [p.name for p in tmain.all_parameters()] == [
        p.name for p in jmain.all_parameters()]
    assert [v.name for v in touts] == [v.name for v in jouts]


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_program_runs_in_the_port(layer):
    main, startup, declared, outs = _build(pt, torch_names, LAYERS[layer])
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    got = exe.run(main, feed={n: FEEDS[n][1] for n in declared},
                  fetch_list=[v.name for v in outs], scope=scope)
    for var, value in zip(outs, got):
        value = np.asarray(value)
        if value.dtype.kind == "f":
            assert np.isfinite(value).all(), var.name
        if var.shape is not None:
            assert len(var.shape) == value.ndim, (var.name, var.shape)
            assert all(d in (-1, s, SENTINEL_DIMS.get(layer)) for d, s in zip(
                var.shape, value.shape)), (var.name, var.shape, value.shape)


def test_a_padded_dynamic_dim_declares_the_sentinel_in_both_packages():
    """The shared fault ``SENTINEL_DIMS`` names, as it stands: both
    packages declare ``pad``'s output ``[1032, 10]`` for a ``[-1, 8]``
    input padded by 1 row; the run gives 3 rows."""
    for mod, names in ((jfluid, jax_names), (pt, torch_names)):
        _, _, _, (out,) = _build(mod, names, LAYERS["pad"])
        assert list(out.shape) == [1032, 10], mod.__name__


def test_every_m12a_layer_function_is_exported_and_covered():
    names = ("abs argmax argmin cos sin exp log sqrt erf tanh elementwise_pow "
             "elu leaky_relu relu6 softplus softsign swish hard_sigmoid "
             "hard_swish huber_loss kldiv_loss mse_loss one_hot reduce_max "
             "reduce_mean reduce_min reduce_prod mul prelu group_norm "
             "instance_norm conv2d_transpose cond_select create_tensor cumsum "
             "expand fill_constant_batch_size_like gather_nd isfinite "
             "linspace ones ones_like pad range shape split stack unstack "
             "zeros zeros_like flatten argsort brelu crop_tensor diag "
             "expand_as eye label_smooth log_loss pad2d rank reverse "
             "scatter_nd_add selu sign size soft_relu stanh strided_slice "
             "adaptive_pool2d hinge_loss unique").split()
    assert len(names) == 72
    missing = [n for n in names if not callable(getattr(pt.layers, n, None))]
    assert not missing
    assert set(names) <= set(LAYERS)
