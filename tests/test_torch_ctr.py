"""CTR training in the PyTorch port against the JAX package, at a small
size on the CPU:

* the op lowerings the two CTR programs add, forward and grad, against
  the JAX package's (the bars of ``test_torch_train_ops.py``);
* the sparse-row kernel's plain version (K6, ``sparse_row_update`` on a
  CPU tensor) equals the JAX package's Pallas kernel in interpret mode bit
  for bit, with id 0 among the real ids and fill rows present, at int32
  and at int64 ids; rows past ``n_unique`` are never touched, whatever
  they hold; an id outside the table raises, also through
  ``Executor.run``;
* ``sgd_sparse`` equals the JAX package's with ``FLAGS_pallas_sparse_update``
  off and on, duplicate ids and ``padding_idx`` included, at the JAX test's
  bar (rtol 1e-5, atol 1e-6);
* both CTR builders (Wide&Deep over the engine, and ``build_ctr_train``
  with on-device tables and SGD) give the same programs as the JAX
  package's after the deferred rewrites: op types, slots, attributes and
  var names, in order; ``build_ctr_train``'s parameter-server modes give
  the JAX programs' op types and table registries;
* the dense CTR model (``vocab_size=1000``, 4 slots in place of 8 so the
  JAX step with 8 interpret-mode kernels compiles in seconds, 3 SGD steps
  at batch 8, flag off and on) from the JAX startup's state: the loss
  stream within rtol 1e-5 / atol 1e-6 and every parameter and table within
  atol 1e-6.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.core.registry import OpRegistry as JaxOps
from paddle_tpu.models import ctr as jax_ctr
from paddle_tpu.ops.pallas import sparse_update as jax_su
from paddle_tpu.passes import (
    apply_deferred_sharded_embedding_rewrite as jax_sharded_rewrite,
    apply_deferred_sparse_rewrite as jax_sparse_rewrite,
)
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu.utils.flags import flags as jax_flags
from paddle_tpu_torch import kernels
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.core.registry import OpRegistry as TorchOps
from paddle_tpu_torch.kernels import sparse_update as su
from paddle_tpu_torch.models import ctr as torch_ctr
from paddle_tpu_torch.models import wide_deep as torch_wd
from paddle_tpu_torch.passes import (
    apply_deferred_sharded_embedding_rewrite as torch_sharded_rewrite,
    apply_deferred_sparse_rewrite as torch_sparse_rewrite,
)
from paddle_tpu_torch.utils import unique_name as torch_names
from paddle_tpu_torch.utils.enforce import EnforceError
from paddle_tpu_torch.utils.flags import flags as torch_flags
from test_torch_train_ops import _assert_same, _grad_op, _run_jax, _run_torch

ROOT = Path(__file__).resolve().parents[1]
VOCAB, BATCH, STEPS, LR, SLOTS = 1000, 8, 3, 0.1, 4


# ---------------------------------------------------------------------------
# op lowerings
# ---------------------------------------------------------------------------

_R = np.random.RandomState(21)


def _f32(*shape):
    return _R.randn(*shape).astype(np.float32)


# op type -> (inputs {slot: [np arrays]}, attrs): the op types the CTR
# programs add (``test_torch_ops.py`` checks that every registered type
# has a case somewhere)
CASES = {
    "concat": ({"X": [_f32(2, 3), _f32(2, 5), _f32(2, 1)]}, {"axis": 1}),
    "sigmoid": ({"X": [_f32(3, 4) * 3]}, {}),
    "sigmoid_cross_entropy_with_logits": (
        {"X": [_f32(6, 1) * 3],
         "Label": [np.array([[0], [1], [1], [0], [-100], [1]], np.float32)]},
        {"ignore_index": -100, "normalize": True}),
    # a weight broadcast over the embedding width, as Wide&Deep pools
    "elementwise_mul": ({"X": [_f32(4, 5, 3)], "Y": [_f32(4, 5, 1)]},
                        {"axis": -1}),
    "sgd": ({"Param": [_f32(4, 3)], "Grad": [_f32(4, 3)],
             "LearningRate": [np.array([0.1], np.float32)]}, {}),
    "sgd_sparse": ({"Param": [_f32(10, 3)],
                    "Ids": [np.array([[1, 2], [9, 2], [0, 1]], np.int64)],
                    "RowGrad": [_f32(3, 2, 3)],
                    "LearningRate": [np.array([0.5], np.float32)]},
                   {"padding_idx": -1}),
    # 3 unique rows padded to a bucket of 8 by repeating slot 5
    "sharded_embedding_lookup": (
        {"Table": [_f32(16, 4)],
         "Slots": [np.array([5, 12, 0, 5, 5, 5, 5, 5], np.int32)],
         "Inv": [np.array([[0, 1], [2, 1], [0, 0]], np.int32)]},
        {"dim": 4, "capacity": 16}),
    "sharded_embedding_sgd": (
        {"Table": [_f32(16, 4)],
         "Slots": [np.array([5, 12, 0, 5, 5, 5, 5, 5], np.int32)],
         "Inv": [np.array([[0, 1], [2, 1], [0, 0]], np.int32)],
         "OutGrad": [_f32(3, 2, 4)]},
        {"lr": 0.1}),
}
GRAD_CASES = ("concat", "sigmoid", "sigmoid_cross_entropy_with_logits",
              "elementwise_mul", "sharded_embedding_lookup")


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_op_matches_jax_lowering(op_type):
    ins, attrs = CASES[op_type]
    _assert_same(_run_torch(op_type, ins, attrs),
                 _run_jax(op_type, ins, attrs))


@pytest.mark.parametrize("op_type", GRAD_CASES)
def test_grad_matches_jax_vjp(op_type):
    gins, gattrs = _grad_op(op_type, *CASES[op_type])
    got = _run_torch(op_type + "_grad", gins, gattrs)
    assert got, op_type
    _assert_same(got, _run_jax(op_type + "_grad", gins, gattrs),
                 rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K6: the sparse row update
# ---------------------------------------------------------------------------


def _row_update(seed, vocab, dim, n_real, n_fill):
    """Distinct real ids with id 0 among them, merged rows, and fill rows
    that repeat id 0 with zero rows (the JAX caller's padding)."""
    rng = np.random.RandomState(seed)
    param = rng.randn(vocab, dim).astype(np.float32)
    ids = rng.choice(np.arange(1, vocab), n_real - 1, replace=False)
    ids = np.concatenate([[0], ids]).astype(np.int32)
    rng.shuffle(ids)
    rows = rng.randn(n_real, dim).astype(np.float32)
    fill_ids = np.zeros(n_fill, np.int32)
    fill_rows = np.zeros((n_fill, dim), np.float32)
    return param, ids, rows, fill_ids, fill_rows


@pytest.mark.parametrize("vocab,dim,n_real,n_fill", [
    (30, 4, 7, 5), (64, 16, 20, 12), (64, 1, 33, 31), (9, 3, 9, 0)])
def test_row_update_plain_matches_jax_interpret(vocab, dim, n_real, n_fill):
    param, ids, rows, fill_ids, fill_rows = _row_update(
        vocab + dim, vocab, dim, n_real, n_fill)
    # the JAX caller orders fill rows first on its sequential grid
    want = np.asarray(jax_su.sparse_row_update(
        jnp.asarray(param), jnp.asarray(np.concatenate([fill_ids, ids])),
        jnp.asarray(np.concatenate([fill_rows, rows])), interpret=True))
    ids_t = torch.from_numpy(np.concatenate([ids, fill_ids]))
    rows_t = torch.from_numpy(np.concatenate([rows, fill_rows]))
    for fn in (su.sparse_row_update_plain, su.sparse_row_update):
        got = torch.from_numpy(param.copy())
        assert fn(got, ids_t, rows_t, n_unique=n_real) is got   # in place
        assert got.numpy().tobytes() == want.tobytes()
    untouched = np.setdiff1d(np.arange(vocab), ids)
    assert np.array_equal(want[untouched], param[untouched])
    assert not np.array_equal(want[0], param[0])


def test_row_update_never_touches_fill_rows():
    """Rows past ``n_unique`` are never read: fill rows holding NaN (or
    anything) leave param exactly as the real rows alone make it."""
    param, ids, rows, fill_ids, _ = _row_update(3, 40, 4, 6, 4)
    want = su.sparse_row_update_plain(torch.from_numpy(param.copy()),
                                      torch.from_numpy(ids),
                                      torch.from_numpy(rows))
    junk = np.full((4, 4), np.nan, np.float32)
    got = su.sparse_row_update(torch.from_numpy(param.copy()),
                               torch.from_numpy(np.concatenate([ids, fill_ids])),
                               torch.from_numpy(np.concatenate([rows, junk])),
                               n_unique=len(ids))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="n_unique"):
        su.sparse_row_update(got, torch.from_numpy(ids),
                             torch.from_numpy(rows), n_unique=len(ids) + 1)


@pytest.mark.parametrize("bad", [-1, 40, 2 ** 31 + 3])
def test_row_update_rejects_an_id_outside_the_table(bad):
    """An id outside ``[0, V)`` is a caller's bug: both versions raise
    before touching param (an int64 id of 2^31 or more would otherwise
    wrap onto another row in the kernel's int32 cast)."""
    param, ids, rows, _, _ = _row_update(3, 40, 4, 6, 4)
    ids = ids.astype(np.int64)
    ids[1] = bad
    for fn in (su.sparse_row_update_plain, su.sparse_row_update):
        got = torch.from_numpy(param.copy())
        with pytest.raises(ValueError, match="outside"):
            fn(got, torch.from_numpy(ids), torch.from_numpy(rows))
        assert got.numpy().tobytes() == param.tobytes()


@pytest.mark.parametrize("vocab,dim,n_real,n_fill", [
    (30, 4, 7, 5), (64, 16, 20, 12), (64, 1, 33, 31)])
def test_row_update_int64_ids_match_int32_and_jax(vocab, dim, n_real,
                                                   n_fill):
    """``torch.unique``'s int64 ids go into the wrapper as they come: the
    same bits as int32 ids and as the JAX kernel in interpret mode."""
    param, ids, rows, fill_ids, fill_rows = _row_update(
        vocab + dim + 1, vocab, dim, n_real, n_fill)
    want = np.asarray(jax_su.sparse_row_update(
        jnp.asarray(param), jnp.asarray(np.concatenate([fill_ids, ids])),
        jnp.asarray(np.concatenate([fill_rows, rows])), interpret=True))
    rows_t = torch.from_numpy(np.concatenate([rows, fill_rows]))
    got = {}
    for dtype in (np.int32, np.int64):
        t = torch.from_numpy(param.copy())
        su.sparse_row_update(t, torch.from_numpy(np.concatenate(
            [ids, fill_ids]).astype(dtype)), rows_t, n_unique=n_real)
        got[dtype] = t.numpy().tobytes()
    assert got[np.int32] == got[np.int64] == want.tobytes()


def test_executor_run_rejects_an_id_outside_the_table(monkeypatch):
    """On the CPU, ``sgd_sparse`` under the flag takes K6's plain version,
    which checks the ids before it touches the table: ``Executor.run``
    raises, attributing the op, and the table keeps every row."""
    monkeypatch.setattr(torch_flags, "pallas_sparse_update", True)
    main = torch_ctr.sgd_sparse_program(50, 4, 4)
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    table = torch.from_numpy(np.random.RandomState(2).randn(50, 4).astype(
        np.float32))
    start = table.clone()
    scope.set("table", table)
    feed = {"ids": np.array([3, 57, 5, 3], np.int64),
            "rows": np.ones((4, 4), np.float32),
            "lr": np.array([0.5], np.float32)}
    with pytest.raises(EnforceError, match="sgd_sparse") as info:
        exe.run(main, feed=feed, fetch_list=["lr"], scope=scope)
    assert isinstance(info.value.__cause__, ValueError)
    assert "outside" in str(info.value.__cause__)
    assert torch.equal(scope.find_var("table"), start)


# ---------------------------------------------------------------------------
# sgd_sparse under both flag settings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag", [False, True], ids=["flag_off", "flag_on"])
@pytest.mark.parametrize("padding_idx", [-1, 0, 7])
def test_sgd_sparse_matches_jax(monkeypatch, flag, padding_idx):
    rng = np.random.RandomState(11)
    V, D = 30, 4
    p = rng.randn(V, D).astype("float32")
    ids = np.array([3, 7, 3, 0, 29, 7, 7], np.int32)
    rows = rng.randn(7, D).astype("float32")
    lr = np.array([0.5], np.float32)
    attrs = {"padding_idx": padding_idx}
    monkeypatch.setattr(jax_flags, "pallas_sparse_update", flag)
    monkeypatch.setattr(torch_flags, "pallas_sparse_update", flag)
    want = np.asarray(JaxOps.get("sgd_sparse").lowering()(
        {"Param": [jnp.asarray(p)], "Ids": [jnp.asarray(ids)],
         "RowGrad": [jnp.asarray(rows)], "LearningRate": [jnp.asarray(lr)]},
        dict(attrs))["ParamOut"][0])
    param = torch.from_numpy(p.copy())
    got = TorchOps.get("sgd_sparse").lowering()(
        {"Param": [param], "Ids": [torch.from_numpy(ids).long()],
         "RowGrad": [torch.from_numpy(rows)],
         "LearningRate": [torch.from_numpy(lr)]}, dict(attrs))["ParamOut"][0]
    assert got is param                      # updated in place
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    untouched = np.setdiff1d(np.arange(V), ids)
    assert np.array_equal(got.numpy()[untouched], p[untouched])
    if padding_idx in ids:
        assert np.array_equal(got.numpy()[padding_idx], p[padding_idx])


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "wide_deep_example", ROOT / "examples" / "wide_deep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_dense_ctr(num_slots=8):
    with jax_names.guard():
        return jax_ctr.build_ctr_train(
            num_slots=num_slots, ps_mode=False, vocab_size=VOCAB,
            optimizer=fluid.optimizer.SGD(learning_rate=LR))


def _torch_dense_ctr(num_slots=8):
    with torch_names.guard():
        return torch_ctr.build_ctr_train(
            num_slots=num_slots, ps_mode=False, vocab_size=VOCAB,
            optimizer=pt.optimizer.SGD(learning_rate=LR))


def _jax_wide_deep():
    with jax_names.guard():
        return _jax_example().build_programs(fluid.Program(), fluid.Program())


def _torch_wide_deep():
    with torch_names.guard():
        return torch_wd.build_programs()


def _int64(descs):
    # the JAX package runs int64 index vars as int32 (64-bit types off);
    # the port keeps int64, its torch index type
    for v in descs:
        if v["dtype"] == "int32" and not v["name"].endswith(("__slots",
                                                             "__inv")):
            v["dtype"] = "int64"
    return descs


@pytest.mark.parametrize("program", [0, 1], ids=["main", "startup"])
@pytest.mark.parametrize("model", ["wide_deep", "dense_ctr"])
def test_programs_match_the_jax_builders(model, program):
    build = {"wide_deep": (_jax_wide_deep, _torch_wide_deep),
             "dense_ctr": (_jax_dense_ctr, _torch_dense_ctr)}[model]
    want, got = build[0]()[program], build[1]()[program]
    jax_sparse_rewrite(want)
    jax_sharded_rewrite(want)
    torch_sparse_rewrite(got)
    torch_sharded_rewrite(got)
    wb, gb = want.global_block(), got.global_block()
    assert [op.desc() for op in gb.ops] == [op.desc() for op in wb.ops]
    assert [v.desc() for v in gb.vars.values()] == \
        _int64([v.desc() for v in wb.vars.values()])
    types = [op.type for op in gb.ops]
    if program == 0 and model == "wide_deep":
        assert types.count("sharded_embedding_sgd") == 8
        assert types.count("adam") == 6          # the dense layers only
        assert got._sharded_tables == want._sharded_tables
    if program == 0 and model == "dense_ctr":
        assert types.count("sgd_sparse") == 16
        assert "lookup_table_v2_grad" not in types


def test_ps_modes_are_not_ported_yet():
    """The parameter-server modes build the JAX package's programs: the
    same op types in order, the same table registries and the
    DownpourSGD fleet options (they train in
    ``test_torch_ps_ctr.py``)."""
    for mode in (True, "remote"):
        with jax_names.guard():
            jmain, jstart, _f, _v = jax_ctr.build_ctr_train(ps_mode=mode)
        with torch_names.guard():
            main, start, _f, _v = torch_ctr.build_ctr_train(ps_mode=mode)
        assert ([op.type for op in main.global_block().ops]
                == [op.type for op in jmain.global_block().ops])
        assert ([op.type for op in start.global_block().ops]
                == [op.type for op in jstart.global_block().ops])
        reg = "_remote_tables" if mode == "remote" else "_sparse_tables"
        assert getattr(main, reg) == getattr(jmain, reg)
        assert len(getattr(main, reg)) == 16
        assert main._fleet_opt == jmain._fleet_opt == {
            "trainer": "DistMultiTrainer", "device_worker": "DownpourSGD"}


# ---------------------------------------------------------------------------
# dense CTR training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag", [False, True], ids=["flag_off", "flag_on"])
def test_dense_ctr_matches_jax(monkeypatch, flag):
    """From the JAX startup's state, 3 SGD steps on fresh batches: the
    loss stream and every parameter and table. The port's row update is
    K6's plain version (CPU tensors) under the flag; the JAX package's is
    its Pallas kernel in interpret mode."""
    monkeypatch.setattr(jax_flags, "pallas_sparse_update", flag)
    monkeypatch.setattr(torch_flags, "pallas_sparse_update", flag)
    rng = np.random.RandomState(4)
    batches = [jax_ctr.synthetic_batch(rng, BATCH, SLOTS, id_space=VOCAB)
               for _ in range(STEPS)]
    first = torch_ctr.synthetic_batch(np.random.RandomState(4), BATCH, SLOTS,
                                      id_space=VOCAB)
    assert all(np.array_equal(first[k], v) for k, v in batches[0].items())
    jmain, jstartup, _, (jloss, _) = _jax_dense_ctr(SLOTS)
    tmain, tstartup, _, (tloss, _) = _torch_dense_ctr(SLOTS)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    texe, tscope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {n: np.asarray(jscope.find_var(n))
                 for n in persistables_to_numpy(tscope, tmain)}
        load_params(tscope, state)
        want = [float(np.asarray(jexe.run(jmain, feed=dict(b),
                                           fetch_list=[jloss])[0])[0])
                for b in batches]
        jstate = {n: np.asarray(jscope.find_var(n)) for n in state}
    kernels.reset_launches()
    got = [float(texe.run(tmain, feed=dict(b), fetch_list=[tloss],
                          scope=tscope)[0][0]) for b in batches]
    assert kernels.launches("sparse_row_update") == 0     # CPU tensors
    assert [op.type for op in tmain.global_block().ops].count(
        "sgd_sparse") == 2 * SLOTS
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    tstate = persistables_to_numpy(tscope, tmain)
    assert set(tstate) == set(jstate) and len(tstate) == 2 * SLOTS + 6 + 1
    for n, w in jstate.items():
        np.testing.assert_allclose(tstate[n], w, rtol=0, atol=1e-6,
                                   err_msg=n)
        if n != "learning_rate_0":
            assert not np.array_equal(w, state[n]), n   # every table moved
