"""One rank of ``tests/test_torch_dgc.py``'s data-parallel runs of the
PyTorch port, on the CPU over gloo. Started by the port's launcher
(``paddle_tpu_torch.distributed.launch.spawn_gang``), one process per rank:

    python tests/torch_dgc_worker.py CASES.json INPUTS.npz OUT_DIR

It runs every case named in CASES.json on the inputs and writes what it
saw to ``OUT_DIR/rank<r>.npz`` (arrays) and ``OUT_DIR/rank<r>.json``
(everything else); the test compares those with the JAX package, which
it computes while the ranks run (``run_gang``). Cases:

* ``op``: the ``dgc_momentum`` lowering called directly inside the DGC
  context, on this rank's gradient and U/V slice;
* ``train``: a small regression program under ``DGCMomentumOptimizer``
  through ``CompiledProgram.with_parallel``, with its loss curve, the
  collectives of its steps, and (``momentum``) the same steps under plain
  ``MomentumOptimizer`` on the whole batch;
* ``fresh``: two fresh scopes behind one ``CompiledProgram``;
* ``errors``: a non-scalar fetch and a batch that does not divide;
* ``allreduce``: ``parallel.dgc.dgc_allreduce`` on this rank's gradients,
  once, and 30 rounds of error feedback;
* ``transformer``: the tiny Transformer from a given state, with the
  dropout masks of its first step.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import dgc_state_names, load_params
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.parallel.dgc import dgc_allreduce
from paddle_tpu_torch.utils import unique_name
from paddle_tpu_torch.utils.flags import flags


def run_op(case, data, axis):
    r = axis.rank
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    ins = {
        "Param": [t(data["p"])],
        "Grad": [t(data["g"][r])],
        "U": [t(data["u"][r:r + 1])],
        "V": [t(data["v"][r:r + 1])],
        "LearningRate": [t(data["lr"])],
        "CurrentStep": [t(data["step"])],
    }
    old = flags.pallas_dgc_topk
    flags.pallas_dgc_topk = bool(case.get("pallas", False))
    penv.reset_collective_stats()
    try:
        step = float(data["step"][0]) if case.get("host_step", True) else None
        with penv.dgc_axis_context(axis, step):
            outs = get_op_def("dgc_momentum").lower(ins, case["attrs"])
    finally:
        flags.pallas_dgc_topk = old
    arrays = {k: outs[k][0].numpy() for k in ("ParamOut", "UOut", "VOut")}
    return arrays, {"collectives": penv.collective_stats()}


def build_regression(rampup_begin, dim, sparsity, momentum=False):
    main, startup = pt.Program(), pt.Program()
    with unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [8, dim])
        y = pt.data("y", [8, 1])
        pred = pt.layers.fc(x, size=1, act=None)
        loss = pt.layers.mean(pt.layers.square(
            pt.layers.elementwise_sub(pred, y)))
        if momentum:
            opt = pt.optimizer.MomentumOptimizer(0.1, 0.9)
        else:
            opt = pt.optimizer.DGCMomentumOptimizer(
                learning_rate=0.1, momentum=0.9,
                rampup_begin_step=rampup_begin, rampup_step=1,
                sparsity=sparsity)
        opt.minimize(loss)
    return main, startup, loss, pred


def run_train(case, data, mesh):
    main, startup, loss, _ = build_regression(
        case["rampup_begin"], case["dim"], case["sparsity"])
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    init = {p.name: data[f"init_{i}"]
            for i, p in enumerate(main.all_parameters())}
    load_params(scope, init)
    prog = pt.CompiledProgram(main).with_parallel(mesh=mesh,
                                                  loss_name=loss.name)
    feed = {"x": data["x"], "y": data["y"]}
    curve, stats = [], []
    for _ in range(case["steps"]):
        penv.reset_collective_stats()
        curve.append(float(exe.run(prog, feed=feed, fetch_list=[loss],
                                   scope=scope)[0].reshape(-1)[0]))
        stats.append(penv.collective_stats())
    arrays = {"curve": np.asarray(curve)}
    meta = {"collectives": stats, "state_shapes": {
        n: list(scope.find_var(n).shape) for n in dgc_state_names(main)}}
    for i, p in enumerate(main.all_parameters()):
        arrays[f"param_{i}"] = scope.find_var(p.name).numpy()
    if case.get("momentum"):
        mmain, mstartup, mloss, _ = build_regression(
            0, case["dim"], case["sparsity"], momentum=True)
        mscope = pt.Scope()
        exe.run(mstartup, scope=mscope)
        load_params(mscope, init)
        arrays["momentum_curve"] = np.asarray([
            float(exe.run(mmain, feed=feed, fetch_list=[mloss],
                          scope=mscope)[0].reshape(-1)[0])
            for _ in range(case["steps"])])
    return arrays, meta


def run_fresh(case, data, mesh):
    main, startup, loss, _ = build_regression(2, 16, [0.75])
    prog = pt.CompiledProgram(main).with_parallel(mesh=mesh,
                                                  loss_name=loss.name)
    exe = pt.Executor(pt.CPUPlace())
    uname = [n for n in dgc_state_names(main) if ".w_" in n and "dgc_u" in n][0]
    meta = {"u_shapes": [], "finite": []}
    for _ in range(2):          # the second scope meets a warm executor
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        out = exe.run(prog, feed={"x": data["x"], "y": data["y"]},
                      fetch_list=[loss], scope=scope)
        meta["u_shapes"].append(list(scope.find_var(uname).shape))
        meta["finite"].append(bool(np.isfinite(out[0]).all()))
    return {}, meta


def run_errors(case, data, mesh):
    main, startup, loss, pred = build_regression(2, 16, [0.75])
    prog = pt.CompiledProgram(main).with_parallel(mesh=mesh,
                                                  loss_name=loss.name)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    meta = {}
    for name, feed, fetch in (
            ("nonscalar", {"x": data["x"], "y": data["y"]}, [pred]),
            ("indivisible", {"x": data["x"][:7], "y": data["y"][:7]}, [loss])):
        try:
            exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
            meta[name] = None
        except pt.EnforceError as e:
            meta[name] = str(e)
    return {}, meta


def run_allreduce(case, data, mesh):
    r = mesh.rank
    g = torch.from_numpy(data["g"][r:r + 1])
    upd, res = dgc_allreduce(mesh, {"w": g}, {"w": torch.zeros_like(g)},
                             sparsity=case["sparsity"])
    small = torch.from_numpy(data["small"][r:r + 1])
    total, residual = torch.zeros(small.shape[1:]), torch.zeros_like(small)
    for _ in range(case["rounds"]):
        (u,), (residual,) = dgc_allreduce(mesh, [small], [residual],
                                          sparsity=case["small_sparsity"])
        total += u[0]
    return {"update": upd["w"].numpy(), "residual": res["w"].numpy(),
            "total": total.numpy()}, {}


def run_transformer(case, data, mesh):
    cfg = transformer.TransformerConfig(**case["cfg"])
    with unique_name.guard():
        main, startup, _, fetches = transformer.build_wmt_train(
            cfg, src_len=case["seq"], tgt_len=case["seq"],
            optimizer=pt.optimizer.DGCMomentumOptimizer(**case["dgc"]))
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    names = json.loads(str(data["names"]))
    load_params(scope, {n: data[f"s_{i}"] for i, n in enumerate(names)})
    prog = pt.CompiledProgram(main).with_parallel(
        mesh=mesh, loss_name=fetches[0].name)
    feed = {k: data[k] for k in ("src_ids", "tgt_ids", "labels")}
    # the dropout masks of the first step, with each op's __rng_id__
    op_def = get_op_def("dropout")
    inner, masks = op_def.lowering(), []

    def tapped(ins, attrs):
        outs = inner(ins, attrs)
        masks.append((attrs["__rng_id__"], outs["Mask"][0].numpy().copy()))
        return outs

    old = flags.pallas_dgc_topk
    flags.pallas_dgc_topk = True
    losses = []
    try:
        for step in range(case["steps"]):
            op_def.kernel = tapped if step == 0 else inner
            losses.append(float(exe.run(prog, feed=feed, fetch_list=fetches,
                                        scope=scope)[0].reshape(-1)[0]))
    finally:
        flags.pallas_dgc_topk = old
        op_def.kernel = inner
    arrays = {"losses": np.asarray(losses),
              "mask_ids": np.asarray([i for i, _ in masks])}
    arrays.update({f"mask_{j}": m for j, (_, m) in enumerate(masks)})
    for i, n in enumerate(names):
        arrays[f"s_{i}"] = scope.find_var(n).numpy()
    return arrays, {}


def run_gang(cases, inputs, tmp, meanwhile, n=2):
    """Start ``n`` ranks of this worker on ``cases`` (under ``tmp``, with a
    ``file://`` rendezvous there), call ``meanwhile()`` while they run, and
    return its result and each rank's (arrays, meta)."""
    from paddle_tpu_torch.distributed import launch

    tmp = Path(tmp)
    (tmp / "cases.json").write_text(json.dumps(cases))
    np.savez(tmp / "inputs.npz", **inputs)
    procs = launch.spawn_gang(
        [__file__, str(tmp / "cases.json"), str(tmp / "inputs.npz"),
         str(tmp)], nproc=n, init_method=f"file://{tmp / 'store'}",
        extra_env={"OMP_NUM_THREADS": "2"})
    try:
        result = meanwhile()
    finally:
        codes = launch.wait_gang(procs, timeout_s=180)
    assert codes == [0] * n, f"ranks exited {codes}"
    return result, [(dict(np.load(tmp / f"rank{r}.npz")),
                     json.loads((tmp / f"rank{r}.json").read_text()))
                    for r in range(n)]


RUNNERS = {"op": run_op, "train": run_train, "fresh": run_fresh,
           "errors": run_errors, "allreduce": run_allreduce,
           "transformer": run_transformer}


def main(cases_path, inputs_path, out_dir):
    torch.set_num_threads(2)
    mesh = penv.make_mesh()
    axis = mesh.axis("data")
    with open(cases_path) as f:
        cases = json.load(f)
    inputs = np.load(inputs_path)
    arrays, meta = {}, {"backend": axis.backend, "size": axis.size}
    for name, case in cases.items():
        prefix = name + "."
        data = {k[len(prefix):]: inputs[k] for k in inputs.files
                if k.startswith(prefix)}
        got, info = RUNNERS[case["kind"]](case, data,
                                          axis if case["kind"] == "op"
                                          else mesh)
        arrays.update({prefix + k: v for k, v in got.items()})
        meta[name] = info
    np.savez(os.path.join(out_dir, f"rank{axis.rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{axis.rank}.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
