"""Data-parallel training with DGC momentum in the PyTorch port against
the JAX package, on the CPU: the port on 2 ranks (one process each,
launched by ``paddle_tpu_torch.distributed.launch``, gloo over a
``file://`` rendezvous under ``tmp_path``; ``tests/torch_dgc_worker.py``
is one rank), the JAX package on a 2-device mesh.

* ``dgc_momentum`` op by op against the JAX lowering under a 2-device
  ``shard_map``, on the same U, V and per-rank gradients: bits equal on
  every rank, in the dense warm-up branch (``pmean``), the sparse branch
  (with Nesterov, with the ramp's ``k_dyn < k_max``, with the phase
  computed on the card for a statically sparse schedule, and through the
  blocked top-k under ``FLAGS_pallas_dgc_topk``). The dense fused form
  (no DGC axis) against the JAX lowering, bits equal, at 2^20 + 4099
  elements: its quantile is a sort, which has no size limit (where
  ``torch.quantile`` refuses over 2^24); at 2^24 the JAX reference's sort
  alone would take about 13 s on the CPU.
* The port's counterparts of ``tests/test_localsgd_dgc.py:78-301``:
  ``parallel.dgc.dgc_allreduce`` gives every rank the same update, the
  mean of the ranks' top-k (against a numpy reference, rtol 1e-5), and
  keeps exactly the unsent mass as each rank's residual, which ships
  every coordinate within 30 rounds; training converges with ``[1, ...]`` U/V per rank; before
  ``rampup_begin_step`` the steps equal ``MomentumOptimizer`` on the
  whole batch (rtol 1e-4, atol 1e-6, the JAX test's bar); a sparse step
  puts no gradient-sized all-reduce on the wire (the port's collective
  counts and bytes: the (index, value) all-gathers and the loss's 4-byte
  mean only); a fresh scope behind a warm executor works; a non-scalar
  fetch and a batch that does not divide raise the JAX package's errors.
The tiny Transformer's comparison is in
``tests/test_torch_dgc_transformer.py``. JAX's side of the op cases is
compiled with XLA's fusion pass off, so that each op rounds on its own
as it does when the lowering runs op by op: fused, XLA contracts
multiply-adds into FMAs, which neither eager JAX nor eager PyTorch does.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu_torch as pt
from paddle_tpu.core.registry import get_op_def as jax_op_def
from paddle_tpu.parallel.env import dgc_axis_context as jax_dgc_context
from paddle_tpu.parallel.env import make_mesh as jax_make_mesh
from paddle_tpu.parallel.env import shard_map
from paddle_tpu.utils.flags import flags as jax_flags
from paddle_tpu_torch import convert
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.distributed import launch
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.utils import unique_name as torch_names
from paddle_tpu_torch.utils.flags import flags as torch_flags
from torch_dgc_worker import run_gang

N = 2


def _attrs(begin, ramp, sparsity, nesterov=False):
    return {"mu": 0.9, "use_nesterov": nesterov,
            "rampup_begin_step": float(begin), "rampup_step": float(ramp),
            "sparsity": [float(s) for s in sparsity]}


# name: (param shape, step, attrs, pallas top-k, step read on the host)
OP_CASES = {
    "op_dense": ((64, 48), 0, _attrs(2, 1, [0.75]), False, True),
    "op_sparse": ((64, 48), 5, _attrs(2, 1, [0.75]), False, True),
    "op_nesterov": ((64, 48), 5, _attrs(2, 1, [0.75], True), False, True),
    "op_kdyn": ((64, 48), 3, _attrs(1, 4, [0.5, 0.9]), False, True),
    "op_static": ((64, 48), 7, _attrs(0, 1, [0.75]), False, False),
    "op_pallas": ((512, 300), 1, _attrs(0, 2, [0.99, 0.999]), True, True),
    "op_wire": ((1024,), 100, _attrs(0, 1, [0.999]), False, True),
}
def _op_inputs(rng, shape, step):
    return {
        "p": rng.randn(*shape).astype(np.float32),
        "g": rng.randn(N, *shape).astype(np.float32),
        "u": (rng.randn(N, *shape) * 0.1).astype(np.float32),
        "v": (rng.randn(N, *shape) * 0.1).astype(np.float32),
        "lr": np.asarray([0.1], np.float32),
        "step": np.asarray([step], np.float32),
    }


def _jax_op(data, attrs, pallas):
    mesh = jax_make_mesh((N,), ("data",), devices=jax.devices()[:N])
    lowering = jax_op_def("dgc_momentum").lower

    def local(p, g, u, v, lr, step):
        with jax_dgc_context("data"):
            outs = lowering({"Param": [p], "Grad": [g[0]], "U": [u], "V": [v],
                             "LearningRate": [lr], "CurrentStep": [step]},
                            attrs)
        return outs["ParamOut"][0], outs["UOut"][0], outs["VOut"][0]

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P("data"), P("data"), P("data"), P(), P()),
                   out_specs=(P(), P("data"), P("data")), check_vma=False)
    args = [jnp.asarray(data[k]) for k in ("p", "g", "u", "v", "lr", "step")]
    old = jax_flags.pallas_dgc_topk
    jax_flags.pallas_dgc_topk = pallas
    try:
        # XLA's fusion pass off: each op rounds on its own, as when the
        # lowering runs op by op (fused, XLA contracts multiply-adds into
        # FMAs, which neither eager JAX nor eager PyTorch does)
        out = jax.jit(fn).lower(*args).compile(compiler_options={
            "xla_disable_hlo_passes": "fusion"})(*args)
    finally:
        jax_flags.pallas_dgc_topk = old
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Start the port's 2 ranks on every case, compute the JAX side while
    they run, and collect both."""
    rng = np.random.RandomState(20261017)
    cases, inputs = {}, {}
    for name, (shape, step, attrs, pallas, host) in OP_CASES.items():
        cases[name] = {"kind": "op", "attrs": attrs, "pallas": pallas,
                       "host_step": host}
        if name == "op_wire":
            data = {"p": np.zeros(shape, np.float32),
                    "g": np.full((N,) + shape, 0.1, np.float32),
                    "u": np.zeros((N,) + shape, np.float32),
                    "v": np.zeros((N,) + shape, np.float32),
                    "lr": np.asarray([0.1], np.float32),
                    "step": np.asarray([step], np.float32)}
        else:
            data = _op_inputs(rng, shape, step)
        inputs.update({f"{name}.{k}": v for k, v in data.items()})
    xs = rng.randn(8, 16).astype(np.float32)
    ys = (xs @ rng.randn(16, 1)).astype(np.float32)
    x_wire = rng.randn(8, 1024).astype(np.float32)
    for name, case in {
            "train": dict(rampup_begin=2, dim=16, sparsity=[0.75], steps=25),
            "warmup": dict(rampup_begin=1000, dim=16, sparsity=[0.75],
                           steps=5, momentum=True),
            "wire": dict(rampup_begin=0, dim=1024, sparsity=[0.999],
                         steps=2)}.items():
        cases[name] = dict(case, kind="train")
        dim = case["dim"]
        inputs[f"{name}.x"] = xs if dim == 16 else x_wire
        inputs[f"{name}.y"] = ys
        inputs[f"{name}.init_0"] = (rng.randn(dim, 1) * 0.1).astype(np.float32)
        inputs[f"{name}.init_1"] = np.zeros([1], np.float32)
    for name in ("fresh", "errors"):
        cases[name] = {"kind": name}
        inputs[f"{name}.x"], inputs[f"{name}.y"] = xs, ys
    cases["allreduce"] = {"kind": "allreduce", "sparsity": 0.75,
                          "small_sparsity": 0.875, "rounds": 30}
    inputs["allreduce.g"] = rng.randn(N, 64).astype(np.float32)
    small = np.full((N, 8), 0.01, np.float32)
    small[:, 0] = 0.1                 # one big coordinate, the rest small
    inputs["allreduce.small"] = small


    def jax_side():
        return {name: _jax_op({k: inputs[f"{name}.{k}"] for k in
                               ("p", "g", "u", "v", "lr", "step")},
                              attrs, pallas)
                for name, (_, _, attrs, pallas, _) in OP_CASES.items()}

    jax_ops, ranks = run_gang(cases, inputs, tmp_path_factory.mktemp("dgc"),
                              jax_side)
    return dict(ranks=ranks, jax_ops=jax_ops, inputs=inputs)


def test_ranks_ran_over_gloo(gang):
    for _, meta in gang["ranks"]:
        assert meta["backend"] == "gloo" and meta["size"] == N


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_dgc_op_matches_the_jax_lowering_bit_for_bit(gang, name):
    p_out, u_out, v_out = gang["jax_ops"][name]
    for r, (arrays, _) in enumerate(gang["ranks"]):
        np.testing.assert_array_equal(arrays[f"{name}.ParamOut"], p_out)
        np.testing.assert_array_equal(arrays[f"{name}.UOut"], u_out[r:r + 1])
        np.testing.assert_array_equal(arrays[f"{name}.VOut"], v_out[r:r + 1])


def test_kdyn_case_masks_the_tail_of_the_top_k(gang):
    # sparsity 0.9 at this step keeps 307 of k_max = 1536 (from 0.5)
    arrays = gang["ranks"][0][0]
    sent = int((arrays["op_kdyn.VOut"] == 0).sum())
    assert sent == round(64 * 48 * (1 - 0.9))


def test_dense_warmup_is_one_all_reduce_and_sparse_steps_all_gather(gang):
    for _, meta in gang["ranks"]:
        assert meta["op_dense"]["collectives"] == {
            "all_reduce": [1, 64 * 48 * 4]}
        # one (index, value) all-gather of k = 1 pair: 8 bytes
        assert meta["op_wire"]["collectives"] == {"all_gather": [1, 8]}


def test_dense_fused_form_matches_jax_bit_for_bit():
    n = 2**20 + 4099
    rng = np.random.RandomState(3)
    data = {"Param": rng.randn(n).astype(np.float32),
            "Grad": rng.randn(n).astype(np.float32),
            "U": (rng.randn(n) * 0.1).astype(np.float32),
            "V": (rng.randn(n) * 0.1).astype(np.float32),
            "LearningRate": np.asarray([0.1], np.float32),
            "CurrentStep": np.asarray([3.0], np.float32)}
    attrs = _attrs(1, 4, [0.5, 0.9])
    want = jax_op_def("dgc_momentum").lower(
        {k: [jnp.asarray(v)] for k, v in data.items()}, attrs)
    got = get_op_def("dgc_momentum").lower(
        {k: [torch.from_numpy(v)] for k, v in data.items()}, attrs)
    for slot in ("ParamOut", "UOut", "VOut"):
        np.testing.assert_array_equal(got[slot][0].numpy(),
                                      np.asarray(want[slot][0]), slot)
    assert 0 < int((got["VOut"][0] == 0).sum()) < n


def test_dgc_allreduce_is_the_mean_of_the_ranks_top_k(gang):
    grads = np.stack([np.asarray(gang["inputs"]["allreduce.g"][r])
                      for r in range(N)])
    k = 16                                       # 64 values at sparsity 0.75
    dense = np.zeros(64)
    for r, (arrays, _) in enumerate(gang["ranks"]):
        acc = grads[r]
        idx = np.argsort(-np.abs(acc), kind="stable")[:k]
        dense[idx] += acc[idx]
        expect = acc.copy()
        expect[idx] = 0.0
        np.testing.assert_allclose(arrays["allreduce.residual"][0], expect,
                                   rtol=1e-5)
        np.testing.assert_array_equal(arrays["allreduce.update"],
                                      gang["ranks"][0][0]["allreduce.update"])
    np.testing.assert_allclose(gang["ranks"][0][0]["allreduce.update"][0],
                               dense / N, rtol=1e-5, atol=1e-6)


def test_dgc_allreduce_residual_ships_every_coordinate(gang):
    # k = 1 of 8 a round: the small coordinates ship through error feedback
    for arrays, _ in gang["ranks"]:
        assert (np.abs(arrays["allreduce.total"]) > 0).all()


def test_training_converges_with_per_rank_state(gang):
    for arrays, meta in gang["ranks"]:
        curve = arrays["train.curve"]
        assert np.isfinite(curve).all()
        assert curve[-1] < curve[0] * 0.2, curve
        shapes = meta["train"]["state_shapes"]
        assert len(shapes) == 4
        assert all(s[0] == 1 and len(s) >= 2 for s in shapes.values()), shapes
    a, b = (r[0] for r in gang["ranks"])
    for k in ("train.param_0", "train.param_1", "train.curve"):
        np.testing.assert_array_equal(a[k], b[k])


def test_warmup_equals_momentum_on_the_whole_batch(gang):
    arrays = gang["ranks"][0][0]
    np.testing.assert_allclose(arrays["warmup.curve"],
                               arrays["warmup.momentum_curve"], rtol=1e-4,
                               atol=1e-6)


def test_sparse_steps_put_no_gradient_sized_all_reduce_on_the_wire(gang):
    for _, meta in gang["ranks"]:
        for stats in meta["wire"]["collectives"]:
            # the loss's cross-rank mean (4 bytes) is the only all-reduce;
            # the weight [1024, 1] and bias [1] send k = 1 pair each
            assert stats["all_reduce"] == [1, 4], stats
            assert stats["all_gather"] == [2, 16], stats


def test_fresh_scope_behind_a_warm_executor(gang):
    for _, meta in gang["ranks"]:
        assert meta["fresh"]["u_shapes"] == [[1, 16, 1], [1, 16, 1]]
        assert meta["fresh"]["finite"] == [True, True]


def test_nonscalar_fetch_and_indivisible_batch_raise(gang):
    for _, meta in gang["ranks"]:
        assert "is not a scalar float" in meta["errors"]["nonscalar"]
        assert "must divide its sharding ('data',) (total 2)" in \
            meta["errors"]["indivisible"]


def test_convert_splits_and_gathers_rank_state():
    arrays = {"w": np.arange(6.0).reshape(2, 3), "u": np.arange(8.0).reshape(
        2, 2, 2)}
    ranks = convert.split_rank_state(arrays, 2, ["u"])
    assert ranks[1]["u"].shape == (1, 2, 2) and ranks[1]["w"].shape == (2, 3)
    back = convert.gather_rank_state(ranks, ["u"])
    assert all(np.array_equal(back[k], arrays[k]) for k in arrays)
    with pytest.raises(ValueError, match="leading axis"):
        convert.split_rank_state({"u": np.zeros((3, 2))}, 2, ["u"])


def _regression(momentum=False, dgc=True):
    main, startup = pt.Program(), pt.Program()
    with torch_names.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [8, 16])
        y = pt.data("y", [8, 1])
        loss = pt.layers.mean(pt.layers.square(pt.layers.elementwise_sub(
            pt.layers.fc(x, size=1), y)))
        opt = (pt.optimizer.DGCMomentumOptimizer(0.1, 0.9, rampup_begin_step=1,
                                                 sparsity=[0.75])
               if dgc else pt.optimizer.MomentumOptimizer(0.1, 0.9))
        opt.minimize(loss)
    return main, startup, loss


def test_world_of_one_runs_the_dense_fused_form():
    # with_data_parallel over this process's world of one: the plain
    # executor's dense fused form, the same losses bit for bit
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(8, 16).astype(np.float32),
            "y": rng.randn(8, 1).astype(np.float32)}
    main, startup, loss = _regression()
    curves = []
    for compiled in (False, True):
        startup.random_seed = 1
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        prog = (pt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name) if compiled else main)
        curves.append([float(exe.run(prog, feed=feed, fetch_list=[loss],
                                     scope=scope)[0][0]) for _ in range(4)])
    assert curves[0] == curves[1]


def test_what_is_not_ported_raises_naming_m11():
    # the dense data-parallel form and DGC's dense fused form across ranks
    # run since the dense path was ported (tests/test_torch_data_parallel.py
    # and tests/test_torch_fleet_collective.py hold them against the JAX
    # mesh); placement, multi-axis meshes and batch statistics still raise
    with pytest.raises(NotImplementedError, match="M11"):
        pt.CompiledProgram(pt.Program()).with_parallel(param_rules={})
    with pytest.raises(NotImplementedError, match="M11"):
        penv.make_mesh((2, 2), ("data", "model"))
    two = penv.Mesh(penv.Axis("data", 2, 0, backend="gloo"))
    exe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.zeros((8, 16), np.float32),
            "y": np.zeros((8, 1), np.float32)}
    main, startup, loss = _regression()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    # a batch-statistics op (its running stats would differ per rank): the
    # DGC program falls back to the dense form with the JAX package's
    # warning, which refuses it before any collective
    main.global_block().append_op("batch_norm", {}, {}, {"is_test": False})
    with pytest.warns(UserWarning, match="dense fused form"), \
            pytest.raises(NotImplementedError, match="batch_norm.*M11"):
        exe.run(pt.CompiledProgram(main).with_parallel(mesh=two), feed=feed,
                fetch_list=[loss], scope=scope)
    old = torch_flags.dgc_sparse_exchange
    torch_flags.dgc_sparse_exchange = False
    try:
        with pytest.raises(NotImplementedError, match="batch_norm.*M11"):
            exe.run(pt.CompiledProgram(main).with_parallel(mesh=two),
                    feed=feed, fetch_list=[loss], scope=scope)
    finally:
        torch_flags.dgc_sparse_exchange = old


def test_launcher_fails_fast_on_a_dead_rank(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n")
    procs = launch.spawn_gang([str(script)], nproc=2,
                              init_method=f"file://{tmp_path / 'store'}")
    codes = launch.wait_gang(procs, grace_s=1.0, timeout_s=30)
    assert codes[1] == 3 and codes[0] != 0


def test_worker_env_contract(tmp_path, monkeypatch):
    script = tmp_path / "env.py"
    script.write_text(
        "import json, os, sys\n"
        "keys = ['PADDLE_TRAINER_ID', 'PADDLE_TRAINERS_NUM', "
        "'PADDLE_TRAINER_ENDPOINTS', 'PADDLE_CURRENT_ENDPOINT', "
        "'PADDLE_DIST_INIT_METHOD', 'TRAINING_ROLE']\n"
        "env = {k: os.environ[k] for k in keys}\n"
        "json.dump(env, open(sys.argv[1] + env['PADDLE_TRAINER_ID'], 'w'))\n")
    codes = launch.launch_procs([str(script), str(tmp_path / "r")], nproc=2)
    assert codes == [0, 0]
    got = [json.loads((tmp_path / f"r{r}").read_text()) for r in range(2)]
    assert [g["PADDLE_TRAINER_ID"] for g in got] == ["0", "1"]
    assert {g["PADDLE_TRAINERS_NUM"] for g in got} == {"2"}
    init = got[0]["PADDLE_DIST_INIT_METHOD"]
    assert init == got[1]["PADDLE_DIST_INIT_METHOD"]
    assert init.startswith("file://")
    assert not os.path.exists(init[len("file://"):])   # the temp dir is gone
    for name, value in got[1].items():
        monkeypatch.setenv(name, value)
    env = penv.ParallelEnv()
    assert (env.rank, env.world_size, env.init_method) == (1, 2, init)
    assert env.current_endpoint == env.trainer_endpoints[1]
