"""The port's parameter-server training (``fleet/parameter_server.py``,
``distributed/lookup.py``, the PS layers and ops) against the JAX
package's on a tiny CTR (2 slots x 2 ids, deep 4, MLP 8), each package
against its own native server:

* the ops: ``lookup_table_ps`` and its grad, ``auc`` (the accumulators
  bit for bit), ``distributed_lookup_table``'s local form and
  ``distributed_push_sparse``'s merged push, against the JAX lowerings;
* ``build_ctr_train(ps_mode=True)`` and ``"remote"`` from the JAX
  startup's state: the loss stream and the pulled rows within rtol 1e-5
  / atol 1e-6 of the JAX run (remote rows start at init_range 0.01 here:
  see ``_nonzero_remote_rows``), and within the JAX tests' bars (rtol
  2e-3, atol 2e-4) of the dense-table baseline with zero rows; remote
  prefetch hits every table after the first step, and ids of 2^31 or
  more are refused;
* geo mode (dense params merged through the server every 3 steps, the
  sparse pushes inline so that a run repeats): the JAX run's losses and
  merged copy, and the server's copy equal to the local params after the
  flush;
* the ``embedding(is_distributed=True)`` transpile: the JAX program's op
  types, table entries and startup ops;
* ``HeartBeatMonitor`` marks a worker that never beats lost, against
  either package's server;
* the DownpourSGD dataset flow (MultiSlot files from the generator, an
  ``InMemoryDataset``, ``train_from_dataset``, ``infer_from_dataset``
  on the test clone, ``FleetUtil``'s global AUC), against the JAX flow
  from the same start.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.distributed import lookup as jax_lookup
from paddle_tpu.fleet import parameter_server as jax_psfleet
from paddle_tpu.fleet.role_maker import UserDefinedRoleMaker as JaxRole
from paddle_tpu.incubate.data_generator import (
    MultiSlotDataGenerator as JaxGenerator)
from paddle_tpu.incubate.fleet_utils import FleetUtil as JaxFleetUtil
from paddle_tpu.models import ctr as jax_ctr
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params
from paddle_tpu_torch.distributed import lookup
from paddle_tpu_torch.distributed import ps as torch_ps
from paddle_tpu_torch.fleet import parameter_server as psfleet
from paddle_tpu_torch.fleet.role_maker import UserDefinedRoleMaker
from paddle_tpu_torch.incubate.checkpoint import HeartBeatMonitor
from paddle_tpu_torch.incubate.data_generator import MultiSlotDataGenerator
from paddle_tpu_torch.incubate.fleet_utils import FleetUtil
from paddle_tpu_torch.models import ctr
from paddle_tpu_torch.utils import unique_name as torch_names
from paddle_tpu_torch.utils.enforce import EnforceError
from test_torch_train_ops import _assert_same, _grad_op, _run_jax, _run_torch

VOCAB, LR = 50, 0.3
SMALL = dict(num_slots=2, ids_per_slot=2, deep_dim=4, hidden=(8,))
_R = np.random.RandomState(13)

# op type -> (inputs, attrs): the op types the PS programs add
# (``test_torch_ops.py`` checks every registered type has a case)
CASES = {
    "lookup_table_ps": ({"Rows": [_R.randn(5, 3).astype(np.float32)],
                         "Idx": [np.array([[0, 4], [2, 0], [4, 1]], np.int32)]},
                        {"table_id": 101}),
    "auc": ({"Predict": [_R.rand(16, 1).astype(np.float32)],
             "Label": [(_R.rand(16, 1) > 0.5).astype(np.int64)],
             "StatPos": [_R.randint(0, 5, 64).astype(np.int64)],
             "StatNeg": [_R.randint(0, 5, 64).astype(np.int64)]},
            {"num_thresholds": 63}),
    "distributed_lookup_table": (
        {"W": [_R.randn(10, 4).astype(np.float32)],
         "Ids": [np.array([[3], [9], [0]], np.int64),
                 np.array([[1, 2], [3, 3]], np.int64)]},
        {"table_name": "t", "dim": 4, "padding_idx": 3}),
    # runs against a lookup context (test_push_sparse_merges_as_jax)
    "distributed_push_sparse": (
        {"Ids": [np.array([[5], [7], [5]], np.int64)],
         "Grad": [_R.randn(3, 2).astype(np.float32)]},
        {"table_name": "t", "dim": 2}),
}


@pytest.mark.parametrize("op_type", ["lookup_table_ps",
                                     "distributed_lookup_table"])
def test_op_matches_jax_lowering(op_type):
    ins, attrs = CASES[op_type]
    _assert_same(_run_torch(op_type, ins, attrs),
                 _run_jax(op_type, ins, attrs))


def test_lookup_table_ps_grad_matches_the_jax_vjp():
    gins, gattrs = _grad_op("lookup_table_ps", *CASES["lookup_table_ps"])
    got = _run_torch("lookup_table_ps_grad", gins, gattrs)
    _assert_same(got, _run_jax("lookup_table_ps_grad", gins, gattrs),
                 rtol=1e-6, atol=1e-6)


def test_auc_accumulators_bit_for_bit():
    ins, attrs = CASES["auc"]
    got = _run_torch("auc", ins, attrs)
    want = _run_jax("auc", ins, attrs)
    for slot in ("StatPosOut", "StatNegOut"):
        np.testing.assert_array_equal(got[slot][0], want[slot][0])
    np.testing.assert_allclose(got["AUC"][0], want["AUC"][0], rtol=1e-6)


class _Recorder:
    def __init__(self):
        self.pushes = []

    def pull_sparse(self, table_id, uniq, dim):
        return np.stack([np.full(dim, float(i), "f") for i in uniq.tolist()])

    def push_sparse(self, table_id, ids, grads, lr):
        self.pushes.append((ids.copy(), np.array(grads), lr))


def test_push_sparse_merges_as_jax():
    ins, attrs = CASES["distributed_push_sparse"]
    got = {}
    for name, mod, run in (("jax", jax_lookup, _run_jax),
                           ("torch", lookup, _run_torch)):
        rec = _Recorder()
        ctx = mod.RemoteLookupContext(rec, sparse_lr=0.2)
        ctx.register("t", 7, 2)
        mod.activate(ctx)
        try:
            run("distributed_push_sparse", ins, attrs)
        finally:
            mod.deactivate()
        got[name] = rec.pushes
    (jids, jg, jlr), = got["jax"]
    (tids, tg, tlr), = got["torch"]
    assert jids.tolist() == tids.tolist() == [5, 7] and jlr == tlr == 0.2
    np.testing.assert_allclose(tg, jg, rtol=1e-6)


def test_the_remote_lookup_refuses_ids_of_2_31_and_a_missing_context():
    ctx = lookup.RemoteLookupContext(_Recorder())
    ctx.register("t", 7, 2)
    op = pt.core.registry.OpRegistry.get("distributed_lookup_table").lower
    ins = {"Ids": [torch.tensor([[2 ** 31]])],
           "__device__": [torch.device("cpu")]}
    with pytest.raises(EnforceError, match="no remote-lookup context"):
        op(ins, {"table_name": "t", "dim": 2})
    lookup.activate(ctx)
    try:
        with pytest.raises(EnforceError, match=r"\[0, 2\^31\)"):
            op(ins, {"table_name": "t", "dim": 2})
        ins["Ids"] = [torch.tensor([[2 ** 31 - 1], [4]])]
        out = op(ins, {"table_name": "t", "dim": 2})["Outputs"][0]
        np.testing.assert_array_equal(
            out.numpy(), np.array([[2 ** 31 - 1] * 2, [4, 4]], np.float32))
    finally:
        lookup.deactivate()


# ---------------------------------------------------------------------------
# training against the server, against the JAX package
# ---------------------------------------------------------------------------


def _batches(n=6, vocab=VOCAB, seed=42):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        feed = {f"slot_{i}": r.randint(0, vocab, size=(16, 2)).astype("int64")
                for i in range(2)}
        feed["click"] = (r.rand(16, 1) > 0.5).astype("float32")
        out.append(feed)
    return out


def _jax_run(ps_mode, batches, strategy=None):
    """The JAX package's run: (losses, startup state, pulled rows)."""
    fleet = jax_psfleet.fleet
    fleet.init(JaxRole(current_id=0, worker_num=1))
    with jax_names.guard():
        main, startup, _f, fetches = jax_ctr.build_ctr_train(
            optimizer=fluid.optimizer.SGD(learning_rate=LR), sparse_lr=LR,
            ps_mode=ps_mode, **SMALL)
    _nonzero_remote_rows(main)
    srv = fleet.init_server(port=0)
    losses = []
    try:
        fleet.init_worker(main)
        if strategy is not None:
            fleet._strategy = strategy
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            scope = fluid.global_scope()
            state = {v.name: np.asarray(scope.find_var(v.name))
                     for v in startup.global_block().vars.values()
                     if v.persistable}
            worker = fleet.worker(exe, main) if ps_mode is True else None
            if strategy is not None:
                _sync_pushes(worker, jax_ps_mod().Communicator)
            for i, b in enumerate(batches):
                if ps_mode is True:
                    out = worker.run(main, b, fetch_list=[fetches[0]])
                else:
                    if i + 1 < len(batches):
                        jax_lookup.prefetch_for_program(main, batches[i + 1])
                    out = exe.run(main, feed=b, fetch_list=[fetches[0]])
                losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
            if worker is not None:
                worker.flush()
            rows = _pull_all(fleet._client, main)
            geo = (fleet._client.pull_dense(jax_psfleet.PSWorker.GEO_DENSE_TABLE)
                   if strategy is not None and strategy.mode == "geo" else None)
    finally:
        fleet.stop_worker()
        srv.stop()
    return losses, state, rows, geo


def jax_ps_mod():
    from paddle_tpu.distributed import ps

    return ps


def _sync_pushes(worker, communicator):
    """Geo's sparse pushes go through an async Communicator, whose
    background pushes race the next step's pull; push inline so that a
    run repeats (the dense merge every ``merge_steps`` is unchanged)."""
    worker._comm.stop()
    worker._comm = communicator(worker._client, mode="sync")


def _pull_all(client, main):
    ids = np.arange(VOCAB, dtype=np.uint64)
    out = {}
    for reg in ("_sparse_tables", "_remote_tables"):
        for name, t in getattr(main, reg, {}).items():
            out[name] = client.pull_sparse(t["table_id"], ids, t["dim"])
    return out


def _nonzero_remote_rows(main):
    """Remote tables start at init_range 0.01 (``build_ctr_train`` gives
    0): with every row 0 the first logits are exactly 0, where the JAX
    package's ``sigmoid_cross_entropy_with_logits`` grad is off by 0.5
    (``jnp.abs``'s grad at 0 is 1; the port's is 0, the true value)."""
    for t in getattr(main, "_remote_tables", {}).values():
        t["init_range"] = 0.01


def _torch_run(ps_mode, batches, state, strategy=None, zero_remote=False):
    fleet = psfleet.fleet
    fleet.init(UserDefinedRoleMaker(current_id=0, worker_num=1))
    with torch_names.guard():
        main, startup, _f, fetches = ctr.build_ctr_train(
            optimizer=pt.optimizer.SGD(learning_rate=LR), sparse_lr=LR,
            ps_mode=ps_mode, **SMALL)
    if zero_remote is False:
        _nonzero_remote_rows(main)
    srv = fleet.init_server(port=0)
    losses = []
    try:
        fleet.init_worker(main)
        if strategy is not None:
            fleet._strategy = strategy
        ctx = lookup.active_context()
        exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
        with pt.scope_guard(scope):
            exe.run(startup)
            load_params(scope, state)
            worker = fleet.worker(exe, main) if ps_mode is True else None
            if strategy is not None:
                _sync_pushes(worker, torch_ps.Communicator)
            for i, b in enumerate(batches):
                if ps_mode is True:
                    if i + 1 < len(batches):
                        worker.prefetch(main, batches[i + 1])
                    out = worker.run(main, b, fetch_list=[fetches[0]])
                else:
                    if i + 1 < len(batches):
                        lookup.prefetch_for_program(main, batches[i + 1])
                    out = exe.run(main, feed=b, fetch_list=[fetches[0]])
                losses.append(float(out[0].reshape(-1)[0]))
            if worker is not None:
                worker.flush()
            rows = _pull_all(fleet._client, main)
            stats = dict(ctx.stats) if ctx is not None else None
            geo = None
            if strategy is not None and strategy.mode == "geo":
                geo = (fleet._client.pull_dense(psfleet.PSWorker.GEO_DENSE_TABLE),
                       worker._concat_params())
    finally:
        fleet.stop_worker()
        srv.stop()
    return losses, rows, stats, geo, main


def _dense_baseline(batches):
    """The JAX tests' local baseline in the port: dense tables, the deep
    ones zeroed, SGD."""
    with torch_names.guard():
        main, startup, _f, fetches = ctr.build_ctr_train(
            optimizer=pt.optimizer.SGD(learning_rate=LR), ps_mode=False,
            vocab_size=VOCAB, **SMALL)
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    for v in main.all_parameters():
        if v.name.startswith("deep_") and v.name.endswith("_w"):
            scope.set(v.name, torch.zeros(v.shape))
    dense = {v.name: scope.find_var(v.name).numpy().copy()
             for v in main.all_parameters()
             if not v.name.startswith(("wide_", "deep_"))}
    return [float(exe.run(main, feed=b, fetch_list=[fetches[0]],
                          scope=scope)[0][0]) for b in batches], dense


@pytest.mark.parametrize("ps_mode", [True, "remote"])
def test_ps_training_matches_jax_and_the_dense_baseline(ps_mode):
    batches = _batches()
    want, state, jrows, _ = _jax_run(ps_mode, batches)
    got, rows, stats, _, main = _torch_run(ps_mode, batches, state)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert sorted(rows) == sorted(jrows)
    for name in rows:
        np.testing.assert_allclose(rows[name], jrows[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    if ps_mode == "remote":
        n = len(main._remote_tables)
        assert stats["prefetch_hits"] >= (len(batches) - 1) * n
        assert stats["pulls"] <= n and stats["pushes"] == len(batches) * n
    # the dense baseline: zero rows (init_range 0 on the deep tables)
    if ps_mode == "remote":
        base, dense = _dense_baseline(batches)
        got_b, *_ = _torch_run(ps_mode, batches, dict(state, **{
            n: dense[n] for n in dense if n in state}), zero_remote=True)
        np.testing.assert_allclose(got_b, base, rtol=2e-3, atol=2e-4)


def test_host_pull_ps_matches_the_dense_baseline_with_zero_rows():
    batches = _batches()
    base, dense = _dense_baseline(batches)
    fleet = psfleet.fleet
    fleet.init(UserDefinedRoleMaker(current_id=0, worker_num=1))
    with torch_names.guard():
        main, startup, _f, fetches = ctr.build_ctr_train(
            optimizer=pt.optimizer.SGD(learning_rate=LR), sparse_lr=LR,
            ps_mode=True, **SMALL)
    for t in main._sparse_tables.values():
        t["init_range"] = 0.0
    srv = fleet.init_server(port=0)
    try:
        fleet.init_worker(main)
        exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
        with pt.scope_guard(scope):
            exe.run(startup)
            load_params(scope, dense)
            worker = fleet.worker(exe, main)
            got = [float(worker.run(main, b, fetch_list=[fetches[0]])[0][0])
                   for b in batches]
            worker.flush()
        uniq = {i: len(np.unique(np.concatenate(
            [b[f"slot_{i}"].ravel() for b in batches]))) for i in range(2)}
        stats = fleet._client.table_stats()
        for name, t in main._sparse_tables.items():
            assert stats[t["table_id"]] == uniq[int(name.split("_")[1])]
    finally:
        fleet.stop_worker()
        srv.stop()
    np.testing.assert_allclose(got, base, rtol=2e-3, atol=2e-4)


def test_geo_mode_matches_jax():
    batches = [_batches(1, seed=3)[0]] * 7       # not a multiple of 3
    jstrat = jax_psfleet.PSDistributedStrategy(mode="geo", merge_steps=3,
                                               sparse_lr=LR)
    want, state, _r, jgeo = _jax_run(True, batches, strategy=jstrat)
    strat = psfleet.PSDistributedStrategy(mode="geo", merge_steps=3,
                                          sparse_lr=LR)
    got, _rows, _s, (merged, local), _m = _torch_run(True, batches, state,
                                                     strategy=strat)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(merged, local, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(merged, jgeo, rtol=1e-5, atol=1e-6)
    assert got[-1] < got[0]


def _is_distributed_program(mod, fleet):
    names = jax_names if mod is fluid else torch_names
    with names.guard():
        main, startup = mod.Program(), mod.Program()
        with mod.program_guard(main, startup):
            a = mod.data("a", shape=[-1, 2], dtype="int64")
            b = mod.data("b", shape=[-1, 2], dtype="int64")
            label = mod.data("label", shape=[-1, 1], dtype="float32")
            ea = mod.layers.embedding(a, size=(1000, 8), is_distributed=True,
                                      param_attr=mod.ParamAttr(name="shared_emb"))
            eb = mod.layers.embedding(b, size=(1000, 8), is_distributed=True,
                                      param_attr=mod.ParamAttr(name="shared_emb"))
            feat = mod.layers.concat([mod.layers.reduce_sum(ea, dim=1),
                                      mod.layers.reduce_sum(eb, dim=1)], axis=1)
            logit = mod.layers.fc(feat, size=1)
            loss = mod.layers.mean(
                mod.layers.sigmoid_cross_entropy_with_logits(logit, label))
            strategy = (jax_psfleet if mod is fluid else psfleet
                        ).PSDistributedStrategy(mode="sync", sparse_lr=0.3)
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                fleet.distributed_optimizer(
                    mod.optimizer.SGD(learning_rate=0.3), strategy
                ).minimize(loss)
    assert any("transpiled" in str(x.message) for x in w)
    return main, startup, loss


def test_is_distributed_transpiles_as_the_jax_package():
    jfleet, fleet = jax_psfleet.fleet, psfleet.fleet
    jfleet.init(JaxRole(current_id=0, worker_num=1))
    fleet.init(UserDefinedRoleMaker(current_id=0, worker_num=1))
    jmain, jstart, _ = _is_distributed_program(fluid, jfleet)
    main, startup, loss = _is_distributed_program(pt, fleet)
    assert ([op.type for op in main.global_block().ops]
            == [op.type for op in jmain.global_block().ops])
    assert ([op.type for op in startup.global_block().ops]
            == [op.type for op in jstart.global_block().ops])
    assert main._remote_tables == jmain._remote_tables
    assert "shared_emb" not in main.global_block().vars
    assert main._fleet_opt == jmain._fleet_opt
    srv = fleet.init_server(port=0)
    try:
        fleet.init_worker(main)
        exe = pt.Executor(place=pt.CPUPlace())
        r = np.random.RandomState(0)
        feed = {"a": r.randint(0, 1000, (16, 2)).astype("int64"),
                "b": r.randint(0, 1000, (16, 2)).astype("int64"),
                "label": (r.rand(16, 1) > 0.5).astype("float32")}
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0][0])
                      for _ in range(8)]
        assert losses[-1] < losses[0]
        tid = list(main._remote_tables.values())[0]["table_id"]
        uniq = len(np.unique(np.concatenate([feed["a"], feed["b"]])))
        assert fleet._client.table_stats()[tid] == uniq
    finally:
        fleet.stop_worker()
        srv.stop()


@pytest.mark.parametrize("server", ["jax", "torch"])
def test_heartbeat_monitor_marks_a_silent_worker_lost(server):
    from paddle_tpu.distributed import ps as jax_ps

    srv = (jax_ps if server == "jax" else torch_ps).PSServer()
    client = torch_ps.PSClient([srv.endpoint])
    lost = []
    mon = HeartBeatMonitor(client, worker_id=0, worker_num=2, timeout=0.2,
                           period=0.05, on_lost=lambda w, a: lost.append(w))
    try:
        assert mon.start() is mon.start()          # idempotent while alive
        deadline = __import__("time").monotonic() + 10
        while not lost and __import__("time").monotonic() < deadline:
            __import__("time").sleep(0.05)
        assert lost == [1] and mon.lost == {1}
        assert mon._mu.name == "resilience.heartbeat"
    finally:
        mon.stop()
        client.close()
        srv.stop()


# ---------------------------------------------------------------------------
# the DownpourSGD dataset flow
# ---------------------------------------------------------------------------


def _gen(base):
    class G(base):
        def generate_sample(self, line):
            def it():
                toks = [int(x) for x in line.split()]
                yield [("ids", toks), ("click", [1 if toks[0] % 3 else 0])]
            return it
    return G()


def _downpour(mod, psf, role, data_file, state=None, epochs=4):
    fleet = psf.fleet
    fleet.init(role(current_id=0, worker_num=1))
    names = jax_names if mod is fluid else torch_names
    with names.guard():
        main, startup = mod.Program(), mod.Program()
        with mod.program_guard(main, startup):
            ids = mod.data("ids", shape=[-1, 2], dtype="int64")
            click = mod.data("click", shape=[-1, 1], dtype="int64")
            emb = mod.layers.sparse_embedding(ids, 8, name="dp_emb",
                                              init_range=0.05)
            logit = mod.layers.fc(mod.layers.reduce_sum(emb, dim=1), size=1)
            loss = mod.layers.mean(mod.layers.sigmoid_cross_entropy_with_logits(
                logit, mod.layers.cast(click, "float32")))
            pred = mod.layers.sigmoid(logit)
            _auc, (stat_pos, stat_neg) = mod.layers.auc(pred, click)
            fleet.distributed_optimizer(
                mod.optimizer.SGD(learning_rate=0.5),
                psf.PSDistributedStrategy(mode="sync", sparse_lr=0.5),
            ).minimize(loss)
    assert main._fleet_opt["device_worker"] == "DownpourSGD"
    ds = mod.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_batch_size(32)
    ds.set_use_var([ids, click])
    ds.set_filelist([str(data_file)])
    ds.load_into_memory()
    srv = fleet.init_server(port=0)
    try:
        fleet.init_worker(main)
        exe = (mod.Executor(mod.CPUPlace()) if mod is fluid
               else pt.Executor(place=pt.CPUPlace()))
        scope = mod.Scope()
        with mod.scope_guard(scope):
            exe.run(startup)
            if state is None:
                state = {v.name: np.asarray(scope.find_var(v.name))
                         for v in startup.global_block().vars.values()
                         if v.persistable}
            else:
                load_params(scope, state)
            losses = []
            for _ in range(epochs):
                out = exe.train_from_dataset(main, ds, fetch_list=[loss],
                                             print_period=10 ** 6)
                losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
            util = (JaxFleetUtil if mod is fluid else FleetUtil)(fleet)
            auc = util.get_global_auc(stat_pos.name, stat_neg.name)
            pos = np.asarray(util and (scope.find_var(stat_pos.name).numpy()
                                       if mod is pt else
                                       scope.find_var(stat_pos.name)))
            err = EnforceError if mod is pt else fluid.EnforceError
            with pytest.raises(err, match="for_test"):
                exe.infer_from_dataset(main, ds, fetch_list=[loss])
            tid = main._sparse_tables["dp_emb"]["table_id"]
            probe = np.arange(5, dtype=np.uint64)
            before = fleet._client.pull_sparse(tid, probe, 8).copy()
            exe.infer_from_dataset(main.clone(for_test=True), ds,
                                   fetch_list=[loss])
            np.testing.assert_array_equal(
                before, fleet._client.pull_sparse(tid, probe, 8))
    finally:
        fleet.stop_worker()
        srv.stop()
    return losses, auc, state, pos


def test_downpour_dataset_flow_with_fleet_util_auc(tmp_path):
    r = np.random.RandomState(7)
    lines = [f"{r.randint(0, 40)} {r.randint(0, 40)}" for _ in range(256)]
    out_lines = _gen(MultiSlotDataGenerator).run_from_memory(lines)
    assert out_lines == _gen(JaxGenerator).run_from_memory(lines)
    data_file = tmp_path / "part-0"
    data_file.write_text("\n".join(out_lines) + "\n")
    want, jauc, state, jpos = _downpour(fluid, jax_psfleet, JaxRole, data_file)
    got, auc, _s, pos = _downpour(pt, psfleet, UserDefinedRoleMaker,
                                  data_file, state=state)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert abs(auc - jauc) < 1e-3 and auc > 0.62, (auc, jauc)
    # every epoch's labels reached the accumulators in both
    assert pos.sum() == jpos.sum() > 0
