"""The collective fleet and the ``c_*`` collective ops of the PyTorch port
against the JAX package, on the CPU (``tests/test_torch_fleet.py`` is
fleet *serving*). The port's 2 ranks run ``tests/torch_dp_worker.py``
(gloo over a ``file://`` rendezvous under ``tmp_path``); the JAX package
runs on a 2-device mesh.

* The role makers of ``tests/test_fleet.py:21-56``, by their env and
  user-given topologies.
* ``test_collective_fleet_loss_parity`` (``tests/test_fleet.py:59-115``):
  ``fleet.init(PaddleCloudRoleMaker())``, ``fleet.distributed_optimizer(
  SGD(0.1), DistributedStrategy()).minimize(loss)`` and
  ``exe.run(fleet.main_program)`` track the single-device run within
  that test's bar (rtol 1e-4, atol 1e-5) at world 1 (in this process; bit
  for bit, the plain executor's step) and at world 2 (the ranks, the
  dense data-parallel step); with ``use_amp`` (bf16) at world 1 bit for
  bit against ``amp.decorate`` on one device, and at world 2 within 2e-2
  of it (bf16 products of half batches); at both worlds within rtol 2e-2
  of the JAX package's AMP step. ``recompute`` raises naming M8;
  placement fields raise naming M11; a multi-axis mesh too.
* Every ``c_*`` op inside a bound ring on each rank's input, bit-equal to
  the JAX lowering under a 2-device ``shard_map`` with the ring bound to
  ``"data"``; an identity outside a ring (the port of
  ``test_collective_ops_identity_outside_mesh``), and on a ring id that
  is not bound.
* DGC momentum under ``FLAGS_dgc_sparse_exchange=0``, and over a program
  with a ``c_allreduce_sum`` (with the JAX package's warning), runs the
  dense fused form on 2 ranks: equal to the JAX 2-device mesh's within
  rtol 1e-4, atol 1e-5.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import paddle_tpu as fluid
from paddle_tpu.core.registry import get_op_def as jax_op_def
from paddle_tpu.parallel.env import collective_context as jax_rings
from paddle_tpu.parallel.env import make_mesh as jax_make_mesh
from paddle_tpu.parallel.env import shard_map
from paddle_tpu.utils import unique_name as jax_names
import paddle_tpu_torch as pt
from paddle_tpu_torch.fleet import (
    DistributedStrategy,
    PaddleCloudRoleMaker,
    Role,
    UserDefinedRoleMaker,
    fleet,
)
from paddle_tpu_torch.layers import collective as C
from paddle_tpu_torch.utils import unique_name as torch_names
from test_torch_data_parallel import jax_regression, regression_inputs
from torch_dp_worker import run_gang

N = 2
OPS = ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
       "c_allreduce_prod", "c_allgather", "c_broadcast", "c_reducescatter",
       "c_sync_calc_stream", "c_sync_comm_stream")
DGC = dict(learning_rate=0.1, momentum=0.9, rampup_begin_step=0,
           sparsity=[0.75])
FLEET_STEPS = 3


def _fleet_data(rng):
    x = rng.rand(64, 8).astype("float32")
    return x, x.sum(axis=1, keepdims=True).astype("float32")


def _jax_op(op_type, x):
    mesh = jax_make_mesh((N,), ("data",), devices=jax.devices()[:N])
    lowering = jax_op_def(op_type).lower

    def local(v):
        with jax_rings({0: "data"}):
            return lowering({"X": [v[0]]}, {"ring_id": 0})["Out"][0][None]

    fn = shard_map(local, mesh=mesh, in_specs=(P("data"),),
                   out_specs=P("data"), check_vma=False)
    return np.asarray(jax.jit(fn)(jnp.asarray(x)))


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    rng = np.random.RandomState(20261018)
    x, y = _fleet_data(rng)
    reg = regression_inputs(rng)
    cases = {"fleet": {"kind": "fleet", "amp": False, "steps": FLEET_STEPS},
             "fleet_amp": {"kind": "fleet", "amp": True,
                           "steps": FLEET_STEPS},
             "collective": {"kind": "collective", "ops": list(OPS)}}
    inputs = {"fleet.x": x, "fleet.y": y, "fleet_amp.x": x, "fleet_amp.y": y}
    # each rank's input: [N, 4, 3] (ties between the ranks' values for max
    # and min, negatives for the product)
    xs = rng.randint(-3, 4, size=(N, 4, 3)).astype(np.float32) * 0.5
    inputs["collective.x"] = xs
    for name, flag, manual in (("dgc_flag0", False, False),
                               ("dgc_manual", True, True)):
        cases[name] = {"kind": "dgc_dense", "sparse_flag": flag,
                       "manual": manual, "steps": 3}
        inputs.update({f"{name}.{k}": v for k, v in reg.items()})

    def jax_side():
        out = {op: _jax_op(op, xs) for op in OPS}
        for name, flag, manual in (("dgc_flag0", False, False),
                                   ("dgc_manual", True, True)):
            with (pytest.warns(UserWarning, match="dense fused form")
                  if manual else contextlib.nullcontext()):
                out[name] = jax_regression(
                    reg, "mean", 3, manual=manual, sparse_flag=flag,
                    opt=fluid.optimizer.DGCMomentumOptimizer(**DGC))
        return out

    jax_out, ranks = run_gang(cases, inputs,
                              tmp_path_factory.mktemp("fleet"), jax_side)
    return dict(ranks=ranks, jax=jax_out, x=x, y=y, xs=xs)


# -- role makers (tests/test_fleet.py:21-56) ---------------------------------


def test_paddle_cloud_role_maker_env(monkeypatch):
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv(
        "PADDLE_TRAINER_ENDPOINTS", "10.0.0.1:6170,10.0.0.2:6170,10.0.0.3:6170"
    )
    rm = PaddleCloudRoleMaker()
    assert rm.is_worker()
    assert not rm.is_server()
    assert rm.worker_index() == 2
    assert rm.worker_num() == 3
    assert not rm.is_first_worker()
    assert rm.get_trainer_endpoints()[1] == "10.0.0.2:6170"


def test_paddle_cloud_role_maker_pserver(monkeypatch):
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST",
                       "127.0.0.1:7000,127.0.0.1:7001")
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:7001")
    rm = PaddleCloudRoleMaker(is_collective=False)
    assert rm.is_server()
    assert rm.server_index() == 1
    assert rm.server_num() == 2


def test_user_defined_role_maker():
    rm = UserDefinedRoleMaker(current_id=0, role=Role.WORKER, worker_num=4,
                              server_endpoints=["127.0.0.1:7164"])
    assert rm.is_first_worker()
    assert rm.worker_num() == 4
    assert rm.server_num() == 1


# -- the loss-parity test (tests/test_fleet.py:59-115) -----------------------


def _fleet_model(mod):
    x = mod.data("x", shape=[-1, 8])
    y = mod.data("y", shape=[-1, 1])
    h = mod.layers.fc(x, size=16, act="relu", param_attr=mod.ParamAttr(
        initializer=mod.initializer.Constant(0.05)))
    pred = mod.layers.fc(h, size=1, param_attr=mod.ParamAttr(
        initializer=mod.initializer.Constant(0.1)))
    return mod.layers.mean(mod.layers.square_error_cost(pred, y))


def _single_device(x, y, amp=False):
    """The program on one device with the plain (AMP-decorated) optimizer:
    the port's losses, and the JAX package's."""
    runs = []
    for mod in (pt, fluid):
        main, startup = mod.Program(), mod.Program()
        with mod.program_guard(main, startup):
            loss = _fleet_model(mod)
            opt = mod.optimizer.SGD(learning_rate=0.1)
            if amp:
                opt = mod.amp.decorate(opt, init_loss_scaling=2.0 ** 15,
                                       use_dynamic_loss_scaling=True)
            opt.minimize(loss)
        exe = mod.Executor(mod.CPUPlace())
        with mod.scope_guard(mod.Scope()):
            exe.run(startup)
            runs.append([float(exe.run(main, feed={"x": x, "y": y},
                                       fetch_list=[loss])[0][0])
                         for _ in range(FLEET_STEPS)])
    return runs


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "amp"])
def test_collective_fleet_loss_parity_world_1(monkeypatch, amp):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    x, y = _fleet_data(np.random.RandomState(20261018))
    port_ref, jax_ref = _single_device(x, y, amp)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        loss = _fleet_model(pt)
        fleet.init(PaddleCloudRoleMaker())
        strategy = DistributedStrategy()
        strategy.use_amp = amp
        fleet.distributed_optimizer(pt.optimizer.SGD(learning_rate=0.1),
                                    strategy).minimize(loss)
    assert fleet.worker_num() == 1 and fleet.is_first_worker()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(fleet.startup_program)
        got = [float(exe.run(fleet.main_program, feed={"x": x, "y": y},
                             fetch_list=[loss])[0][0])
               for _ in range(FLEET_STEPS)]
    assert got == port_ref
    np.testing.assert_allclose(got, jax_ref, rtol=1e-4 if not amp else 2e-2,
                               atol=1e-5)
    assert got[-1] < got[0]


def test_collective_fleet_loss_parity_world_2(gang):
    port_ref, jax_ref = _single_device(gang["x"], gang["y"])
    for arrays, meta in gang["ranks"]:
        got = arrays["fleet.losses"].reshape(-1)
        np.testing.assert_allclose(got, port_ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, jax_ref, rtol=1e-4, atol=1e-5)
        assert meta["fleet"]["worker_num"] == N
    assert [m["fleet"]["first"] for _, m in gang["ranks"]] == [True, False]


def test_collective_fleet_amp_composes_world_2(gang):
    port_ref, jax_ref = _single_device(gang["x"], gang["y"], amp=True)
    (a, _), (b, _) = gang["ranks"]
    np.testing.assert_array_equal(a["fleet_amp.losses"],
                                  b["fleet_amp.losses"])
    got = a["fleet_amp.losses"].reshape(-1)
    np.testing.assert_allclose(got, port_ref, rtol=2e-2)
    # the JAX package's AMP step on the whole batch (its GSPMD mesh step),
    # at the world-1 AMP bar
    np.testing.assert_allclose(got, jax_ref, rtol=2e-2, atol=1e-5)
    assert got[-1] < got[0]


def test_strategy_forms_not_ported_raise():
    def build(**fields):
        main, startup = pt.Program(), pt.Program()
        with torch_names.guard(), pt.program_guard(main, startup):
            loss = _fleet_model(pt)
            strategy = DistributedStrategy()
            for k, v in fields.items():
                setattr(strategy, k, v)
            fleet.distributed_optimizer(pt.optimizer.SGD(0.1),
                                        strategy).minimize(loss)
        return main

    # recompute builds since M8 landed: without checkpoints nothing
    # changes; at the hidden layer's output, two segments replay
    main = build(recompute=True)
    assert "recompute_segment_grad" not in [
        op.type for op in main.global_block().ops]
    main = pt.Program()
    with torch_names.guard(), pt.program_guard(main, pt.Program()):
        loss = _fleet_model(pt)
        strategy = DistributedStrategy()
        strategy.recompute = True
        strategy.recompute_checkpoints = [next(
            op.output("Out")[0] for op in main.global_block().ops
            if op.type == "relu")]
        fleet.distributed_optimizer(pt.optimizer.SGD(0.1),
                                    strategy).minimize(loss)
    types = [op.type for op in main.global_block().ops]
    assert types.count("recompute_segment_grad") == 2 and "sgd" in types
    # the placement fields and a multi-axis mesh build since they were
    # ported (tests/test_torch_hybrid.py runs them across ranks); feed
    # specs, axis tags and the pipeline runtime's schedules still raise
    for fields in ({"param_rules": [(".*", (None,))]},
                   {"param_specs": {"w": (None,)}}, {"spec_layout": True},
                   {"mesh_shape": (1, 1), "mesh_axis_names": ("data",
                                                              "model")}):
        build(**fields)
        compiled = fleet.main_program
        for field, value in fields.items():
            if field.startswith("mesh_"):
                assert compiled._mesh.axis_names == ("data", "model")
            else:
                got = getattr(compiled, "_" + field, None)
                assert got is not None, field
    for field, value in (("input_specs", {"x": ("data",)}),
                         ("mesh_axis_tags", {"data": "ici"}),
                         ("pipeline_schedule", "1f1b"),
                         ("pipeline_interleave", 2)):
        with pytest.raises(NotImplementedError, match=f"{field}.*M11"):
            build(**{field: value})
    # refused before the program changed: no optimizer op was added
    main = pt.Program()
    with pytest.raises(NotImplementedError, match="M11"):
        with torch_names.guard(), pt.program_guard(main, pt.Program()):
            loss = _fleet_model(pt)
            strategy = DistributedStrategy()
            strategy.pipeline_schedule = "1f1b"
            fleet.distributed_optimizer(pt.optimizer.SGD(0.1),
                                        strategy).minimize(loss)
    assert "sgd" not in [op.type for op in main.global_block().ops]


# -- the c_* ops --------------------------------------------------------------


def test_ranks_ran_over_gloo(gang):
    for _, meta in gang["ranks"]:
        assert meta["backend"] == "gloo" and meta["size"] == N


@pytest.mark.parametrize("op_type", OPS)
def test_collective_op_is_the_jax_lowering_in_a_bound_ring(gang, op_type):
    want = gang["jax"][op_type]
    for r, (arrays, _) in enumerate(gang["ranks"]):
        np.testing.assert_array_equal(arrays[f"collective.{op_type}"],
                                      want[r])


def test_collective_ops_on_an_unbound_ring_and_in_a_program(gang):
    xs = gang["xs"]
    for r, (arrays, _) in enumerate(gang["ranks"]):
        np.testing.assert_array_equal(arrays["collective.unbound"], xs[r])
        np.testing.assert_array_equal(arrays["collective.program"],
                                      xs.sum(axis=0))


@pytest.mark.parametrize("op_type", OPS)
def test_collective_ops_identity_outside_mesh(op_type):
    """The port of ``tests/test_data_parallel.py``'s test: a collective op
    in a single-trainer run is an identity (a ring of one)."""
    main = pt.Program()
    with torch_names.guard(), pt.program_guard(main, pt.Program()):
        x = pt.data("x", shape=[-1, 4])
        out = C._collective_layer(op_type, x)
    arr = np.random.RandomState(0).rand(2, 4).astype("float32")
    (res,) = pt.Executor(pt.CPUPlace()).run(main, feed={"x": arr},
                                             fetch_list=[out])
    np.testing.assert_array_equal(res, arr)


def test_collective_builders_emit_the_jax_ops():
    descs = []
    for mod, names in ((pt, torch_names), (fluid, jax_names)):
        main = mod.Program()
        with names.guard(), mod.program_guard(main, mod.Program()):
            x = mod.data("x", shape=[-1, 4])
            coll = mod.layers.collective
            coll._allreduce(x)
            coll._c_allgather(x, nranks=2)
            coll._c_broadcast(x, root=0)
            coll._c_reducescatter_layer(x, nranks=2, ring_id=1)
        descs.append([(op.type, op.inputs, op.outputs, op.attrs["ring_id"])
                      for op in main.global_block().ops])
    assert descs[0] == descs[1]


# -- DGC's dense fused form across ranks --------------------------------------


@pytest.mark.parametrize("name", ["dgc_flag0", "dgc_manual"])
def test_dgc_dense_fused_form_matches_the_jax_mesh(gang, name):
    want = gang["jax"][name]
    (a, _), (b, _) = gang["ranks"]
    for i in range(4):
        np.testing.assert_array_equal(a[f"{name}.param_{i}"],
                                      b[f"{name}.param_{i}"])
    for arrays, meta in gang["ranks"]:
        np.testing.assert_allclose(arrays[f"{name}.losses"], want["losses"],
                                   rtol=1e-4, atol=1e-5)
        for i, w in enumerate(want["params"]):
            np.testing.assert_allclose(arrays[f"{name}.param_{i}"], w,
                                       rtol=1e-4, atol=1e-5)
        warned = meta[name]["warnings"]
        if name == "dgc_manual":
            assert len(warned) == 1 and "c_allreduce_sum" in warned[0]
            assert "falling back to the dense fused form" in warned[0]
        else:
            assert warned == []
