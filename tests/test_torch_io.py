"""Model io in the PyTorch port against the JAX package, on the CPU: files
written by one package are read by the other, bit for bit.

* separate-file saves (``.npy`` per variable and a CRC manifest) and
  combined saves (one ``.npz``), in both directions, and a corrupt
  ``.npy`` refused by both packages, naming its variable;
* bfloat16 in the combined format's ``__bf16__`` tag: ``ml_dtypes`` on the
  JAX side, ``torch.bfloat16`` on the port's, the same bits;
* ``save`` / ``load`` (``.pdparams`` / ``.pdopt``) and
  ``load_program_state`` / ``set_program_state``;
* ``Program._prune``'s op list and the ``__model__`` bytes of the book
  programs equal to the JAX package's under ``unique_name.guard()``
  (``fit_a_line``'s whole file; ``recognize_digits``' apart from the one
  index var the JAX package declares int32 and the port int64);
* an inference model exported by one package run by the other within
  1e-5 of the exporter's output (float32 sums in another order);
* a program the verifier refuses, refused before anything is written;
* ``save_train_model`` / ``load_train_model`` in both directions.

The book programs are built by the same function over either package;
the JAX startup's weights carry into the port by name, so both scopes
hold the same bits before anything is saved.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.resilience import faults as jax_faults
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params
from paddle_tpu_torch.utils import unique_name as torch_names
from paddle_tpu_torch.utils.enforce import EnforceError as TorchEnforceError
from paddle_tpu.utils.enforce import EnforceError as JaxEnforceError

INFER_TOL = 1e-5


def fit_a_line(mod):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        x = mod.data("x", shape=[-1, 13], dtype="float32")
        y = mod.data("y", shape=[-1, 1], dtype="float32")
        y_predict = mod.layers.fc(x, size=1, act=None)
        avg_cost = mod.layers.mean(mod.layers.square_error_cost(y_predict, y))
        mod.optimizer.SGD(learning_rate=0.01).minimize(avg_cost)
    return main, startup, ["x"], y_predict


def recognize_digits(mod):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        img = mod.data("img", shape=[-1, 1, 28, 28], dtype="float32")
        label = mod.data("label", shape=[-1, 1], dtype="int64")
        c1 = mod.layers.conv2d(img, num_filters=8, filter_size=5, act="relu")
        p1 = mod.layers.pool2d(c1, pool_size=2, pool_stride=2)
        c2 = mod.layers.conv2d(p1, num_filters=16, filter_size=5, act="relu")
        p2 = mod.layers.pool2d(c2, pool_size=2, pool_stride=2)
        flat = mod.layers.reshape(p2, [0, 16 * 4 * 4])
        prediction = mod.layers.fc(flat, size=10, act="softmax")
        loss = mod.layers.mean(mod.layers.cross_entropy(prediction, label))
        mod.layers.accuracy(prediction, label)
        mod.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, ["img"], prediction


BUILDERS = {"fit_a_line": fit_a_line, "recognize_digits": recognize_digits}
FEEDS = {
    "fit_a_line": lambda rng: {"x": rng.randn(6, 13).astype("float32")},
    "recognize_digits": lambda rng: {
        "img": rng.randn(4, 1, 28, 28).astype("float32")},
}


class Side:
    """One package's program, executor and scope for a builder."""

    def __init__(self, pkg, builder):
        self.pkg = pkg
        self.mod = fluid if pkg == "jax" else pt
        names = jax_names if pkg == "jax" else torch_names
        with names.guard():
            self.main, self.startup, self.feeds, self.target = builder(
                self.mod)
        self.exe = (fluid.Executor(fluid.CPUPlace()) if pkg == "jax"
                    else pt.Executor(place=pt.CPUPlace()))
        self.scope = self.mod.Scope()

    def guard(self, scope=None):
        return self.mod.scope_guard(self.scope if scope is None else scope)

    def array(self, name, scope=None):
        """A scope value as host numpy (bf16 as ml_dtypes.bfloat16)."""
        v = (self.scope if scope is None else scope).find_var(name)
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            return v.detach().cpu().numpy()
        return np.asarray(v)

    def persistables(self):
        return [v.name for v in self.main.global_block().vars.values()
                if v.persistable and not v.is_data]


def _pair(name):
    """(jax side, port side), both scopes holding the JAX startup's
    weights."""
    jax_side, port_side = Side("jax", BUILDERS[name]), Side(
        "port", BUILDERS[name])
    with jax_side.guard():
        jax_side.exe.run(jax_side.startup)
    with port_side.guard():
        port_side.exe.run(port_side.startup)
    load_params(port_side.scope, {n: jax_side.array(n)
                                  for n in port_side.persistables()})
    return jax_side, port_side


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


DIRECTIONS = [("jax", "port"), ("port", "jax")]


@pytest.mark.parametrize("filename", [None, "params"],
                         ids=["separate", "combined"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["jax_to_port", "port_to_jax"])
def test_persistables_cross_read(tmp_path, writer, reader, filename):
    sides = dict(zip(("jax", "port"), _pair("recognize_digits")))
    w, r = sides[writer], sides[reader]
    with w.guard():
        w.mod.io.save_persistables(w.exe, str(tmp_path), w.main,
                                   filename=filename)
    fresh = r.mod.Scope()
    with r.guard(fresh):
        names = r.mod.io.load_persistables(r.exe, str(tmp_path), r.main,
                                           filename=filename)
    assert sorted(names) == sorted(w.persistables())
    for n in names:
        assert _same_bits(r.array(n, fresh), w.array(n)), n
    if filename is None:
        with open(tmp_path / "__manifest__.json") as f:
            assert sorted(json.load(f)["crc32"]) == sorted(names)


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_a_corrupt_npy_names_its_variable(tmp_path, reader):
    jax_side, port_side = _pair("fit_a_line")
    with port_side.guard():
        pt.io.save_persistables(port_side.exe, str(tmp_path), port_side.main)
    victim = "fc_0.w_0"
    path = str(tmp_path / (victim + ".npy"))
    size = os.path.getsize(path)
    # a payload word (the header is the first 128 bytes)
    jax_faults.corrupt_file(path, offset=size - 8, nbytes=4)
    side = port_side if reader == "port" else jax_side
    err = TorchEnforceError if reader == "port" else JaxEnforceError
    with side.guard(side.mod.Scope()):
        with pytest.raises(err, match=victim):
            side.mod.io.load_persistables(side.exe, str(tmp_path), side.main)


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["jax_to_port", "port_to_jax"])
def test_bf16_tag_round_trips(tmp_path, writer, reader):
    rng = np.random.RandomState(3)
    bits = rng.randint(0, 2**16, size=(5, 7)).astype(np.uint16)
    bits[0, :3] = [0x7F80, 0xFF80, 0x7FC1]          # inf, -inf, a NaN
    want = bits.view(ml_dtypes.bfloat16)
    f32 = rng.randn(3).astype("float32")
    if writer == "jax":
        import jax.numpy as jnp

        with fluid.scope_guard(fluid.Scope()) as _:
            fluid.global_scope().set("w_bf16", jnp.asarray(want))
            fluid.global_scope().set("b", jnp.asarray(f32))
            fluid.io.save_vars(None, str(tmp_path), vars=["w_bf16", "b"],
                               filename="p")
    else:
        with pt.scope_guard(pt.Scope()):
            pt.global_scope().set(
                "w_bf16", torch.from_numpy(bits.view(np.int16)).view(
                    torch.bfloat16))
            pt.global_scope().set("b", torch.from_numpy(f32))
            pt.io.save_vars(None, str(tmp_path), vars=["w_bf16", "b"],
                            filename="p")
    with np.load(str(tmp_path / "p.npz"), allow_pickle=True) as z:
        assert [str(n) for n in z["__bf16__"]] == ["w_bf16"]
    if reader == "port":
        scope = pt.Scope()
        with pt.scope_guard(scope):
            pt.io.load_vars(pt.Executor(place=pt.CPUPlace()), str(tmp_path),
                            vars=["w_bf16", "b"], filename="p")
        got = scope.find_var("w_bf16")
        assert got.dtype == torch.bfloat16
        assert _same_bits(got.view(torch.int16).numpy(), bits.view(np.int16))
        assert _same_bits(scope.find_var("b").numpy(), f32)
    else:
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            fluid.io.load_vars(None, str(tmp_path), vars=["w_bf16", "b"],
                               filename="p")
        got = np.asarray(scope.find_var("w_bf16"))
        assert got.dtype == ml_dtypes.bfloat16
        assert _same_bits(got.view(np.uint16), bits)
        assert _same_bits(np.asarray(scope.find_var("b")), f32)


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["jax_to_port", "port_to_jax"])
def test_save_and_load_pdparams(tmp_path, writer, reader):
    sides = dict(zip(("jax", "port"), _pair("recognize_digits")))
    w, r = sides[writer], sides[reader]
    path = str(tmp_path / "model")
    with w.guard():
        w.mod.io.save(w.main, path)
    assert os.path.exists(path + ".pdparams.npz")
    assert os.path.exists(path + ".pdopt.npz")
    fresh = r.mod.Scope()
    with r.guard(fresh):
        r.mod.io.load(r.main, path, r.exe)
    for n in w.persistables():
        assert _same_bits(r.array(n, fresh), w.array(n)), n


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["jax_to_port", "port_to_jax"])
def test_program_state_round_trip(tmp_path, writer, reader):
    sides = dict(zip(("jax", "port"), _pair("fit_a_line")))
    w, r = sides[writer], sides[reader]
    path = str(tmp_path / "model")
    with w.guard():
        w.mod.io.save(w.main, path)
    state = r.mod.io.load_program_state(path)
    assert sorted(state) == sorted(w.persistables())
    fresh = r.mod.Scope()
    with r.guard(fresh):
        used = r.mod.io.set_program_state(r.main, state)
    assert used == sorted(w.persistables())
    for n in used:
        assert _same_bits(r.array(n, fresh), w.array(n)), n


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_prune_keeps_the_jax_op_list(name):
    jax_side, port_side = Side("jax", BUILDERS[name]), Side(
        "port", BUILDERS[name])
    descs = []
    for side in (jax_side, port_side):
        infer = side.main.clone(for_test=True)
        infer._prune([side.target.name])
        descs.append([op.desc() for op in infer.global_block().ops])
    assert [d["type"] for d in descs[1]] == [d["type"] for d in descs[0]]
    assert descs[1] == descs[0]
    assert len(descs[0]) < len(jax_side.main.global_block().ops)


# index vars the JAX package declares int32 (its 64-bit types are off)
# and the port int64 (core/dtypes.py): the one difference the model files
# may show
INDEX_VARS = {"fit_a_line": [], "recognize_digits": [
    ("top_k_0.tmp_1", "int32", "int64")]}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_model_file_bytes_equal_jax(tmp_path, name):
    jax_side, port_side = _pair(name)
    for side in (jax_side, port_side):
        with side.guard():
            got = side.mod.io.save_inference_model(
                str(tmp_path / side.pkg), side.feeds, [side.target],
                side.exe, main_program=side.main)
        assert got == [side.target.name]
    with open(tmp_path / "jax" / "__model__", "rb") as f:
        want = f.read()
    with open(tmp_path / "port" / "__model__", "rb") as f:
        got = f.read()
    if not INDEX_VARS[name]:
        assert got == want
    desc = json.loads(got)
    jax_vars = {v["name"]: v for v in json.loads(want)["blocks"][0]["vars"]}
    diffs = []
    for v in desc["blocks"][0]["vars"]:
        w = jax_vars[v["name"]]
        if v != w:
            diffs.append((v["name"], w["dtype"], v["dtype"]))
            v["dtype"] = w["dtype"]
    assert diffs == INDEX_VARS[name]
    assert json.dumps(desc, sort_keys=True).encode("utf-8") == want


@pytest.mark.parametrize("name", sorted(BUILDERS))
@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["jax_to_port", "port_to_jax"])
def test_inference_model_runs_in_the_other_package(tmp_path, name, writer,
                                                   reader):
    sides = dict(zip(("jax", "port"), _pair(name)))
    w, r = sides[writer], sides[reader]
    feed = FEEDS[name](np.random.RandomState(7))
    with w.guard():
        w.mod.io.save_inference_model(str(tmp_path), w.feeds, [w.target],
                                      w.exe, main_program=w.main)
        infer = w.main.clone(for_test=True)._prune([w.target.name])
        want = w.exe.run(infer, feed=feed, fetch_list=[w.target])[0]
    with r.guard(r.mod.Scope()):
        program, feed_names, fetch_vars = r.mod.io.load_inference_model(
            str(tmp_path), r.exe)
        assert feed_names == w.feeds
        got = r.exe.run(program, feed=feed, fetch_list=fetch_vars)[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=INFER_TOL, atol=INFER_TOL)


def _broken(mod):
    """An elementwise_add of a float32 and an int64 var: the verifier's
    dtype-mismatch."""
    main = mod.Program()
    block = main.global_block()
    x = block.create_var(name="x", shape=[-1, 4], dtype="float32",
                         is_data=True)
    y = block.create_var(name="y", shape=[-1, 4], dtype="int64",
                         is_data=True)
    out = block.create_var(name="out", shape=[-1, 4], dtype="float32")
    block.append_op(type="elementwise_add", inputs={"X": [x.name],
                                                    "Y": [y.name]},
                    outputs={"Out": [out.name]}, attrs={"axis": -1})
    return main, out


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_the_verifier_refuses_before_anything_is_written(tmp_path, pkg):
    mod = fluid if pkg == "jax" else pt
    err = JaxEnforceError if pkg == "jax" else TorchEnforceError
    main, out = _broken(mod)
    exe = (fluid.Executor(fluid.CPUPlace()) if pkg == "jax"
           else pt.Executor(place=pt.CPUPlace()))
    target = tmp_path / "model"
    with mod.scope_guard(mod.Scope()):
        with pytest.raises(err, match="dtype-mismatch"):
            mod.io.save_inference_model(str(target), ["x", "y"], [out], exe,
                                        main_program=main)
    assert not target.exists()


def test_the_verifiers_give_the_same_diagnostics():
    from paddle_tpu.analysis.verify import verify_program as jax_verify
    from paddle_tpu_torch.analysis.verify import verify_program

    got = [(d.severity, d.code, d.var, d.message)
           for d in verify_program(_broken(pt)[0], feed_names=["x", "y"])]
    want = [(d.severity, d.code, d.var, d.message)
            for d in jax_verify(_broken(fluid)[0], feed_names=["x", "y"])]
    assert got == want and got
    with pytest.raises(NotImplementedError, match="M11"):
        verify_program(_broken(pt)[0], mesh=object())


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["jax_to_port", "port_to_jax"])
def test_train_model_round_trip(tmp_path, writer, reader):
    sides = dict(zip(("jax", "port"), _pair("fit_a_line")))
    w, r = sides[writer], sides[reader]
    loss = [op for op in w.main.global_block().ops
            if op.type == "mean"][0].output("Out")[0]
    with w.guard():
        w.mod.io.save_train_model(str(tmp_path), w.main, w.startup,
                                  loss=loss, executor=w.exe)
    main, startup, loss_name = r.mod.io.load_train_model(str(tmp_path))
    assert loss_name == loss
    assert main.to_bytes() == w.main.to_bytes()
    assert startup.to_bytes() == w.startup.to_bytes()
    fresh = r.mod.Scope()
    with r.guard(fresh):
        r.mod.io.load_persistables(r.exe, str(tmp_path / "params"), main)
        feed = {"x": np.ones((4, 13), "float32"),
                "y": np.zeros((4, 1), "float32")}
        got = r.exe.run(main, feed=feed, fetch_list=[loss_name])[0]
    with w.guard():
        want = w.exe.run(w.main, feed=feed, fetch_list=[loss])[0]
    np.testing.assert_allclose(got, want, rtol=INFER_TOL, atol=INFER_TOL)


def test_loads_land_on_the_executors_device(tmp_path):
    _, port_side = _pair("fit_a_line")
    with port_side.guard():
        pt.io.save_persistables(port_side.exe, str(tmp_path), port_side.main)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        names = pt.io.load_persistables(port_side.exe, str(tmp_path),
                                        port_side.main)
    for n in names:
        t = scope.find_var(n)
        assert isinstance(t, torch.Tensor) and t.device == port_side.exe.device
