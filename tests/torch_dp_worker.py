"""One rank of the dense data-parallel and collective-fleet tests of the
PyTorch port (``tests/test_torch_data_parallel.py``,
``tests/test_torch_fleet_collective.py``), on the CPU over gloo. Started
by the port's launcher (``paddle_tpu_torch.distributed.launch
.spawn_gang``), one process per rank:

    python tests/torch_dp_worker.py CASES.json INPUTS.npz OUT_DIR

It runs every case named in CASES.json on the inputs and writes what it
saw to ``OUT_DIR/rank<r>.npz`` (arrays) and ``OUT_DIR/rank<r>.json``
(everything else); the tests compare those with the JAX package, which
they compute while the ranks run (``run_gang``). Cases:

* ``regression``: the program of ``tests/test_data_parallel.py`` (or its
  loss summed over the batch, or a batch mean fed back into rows) from
  given parameters through ``CompiledProgram.with_parallel``: the loss,
  a rows fetch (the prediction) and the parameters after every step,
  the collectives of each step;
* ``bert``: tiny BERT pretraining from a given state: losses, the first
  dropout site's mask and the grad of the MLM loss's per-token terms
  (rows fetches), the whole state after the steps;
* ``unequal``: the ranks' startups drawn from different seeds, then one
  step: the initial and final parameters;
* ``errors``: a batch that does not divide;
* ``collective``: every ``c_*`` lowering inside a bound ring on this
  rank's input;
* ``dgc_dense``: a DGC program under ``FLAGS_dgc_sparse_exchange=0``, or
  with a ``c_allreduce_sum`` beside it (the warning and the dense fused
  form);
* ``fleet``: the loss-parity program of ``tests/test_fleet.py`` through
  ``fleet.distributed_optimizer(...).minimize`` and
  ``exe.run(fleet.main_program)``, with ``use_amp`` where asked;
* ``fleet_bert``: tiny BERT (hidden dropout 0.1) with LAMB and a
  global-norm clip through the fleet, with ``DistributedStrategy.recompute``
  at the encoder layers' outputs where asked
  (``tests/test_torch_recompute.py``): losses and the whole state.
"""

import hashlib
import json
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.layers import collective as C
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.utils import unique_name
from paddle_tpu_torch.utils.flags import flags


def digest(arrays):
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def build_regression(fluid, names, loss_kind="mean", opt=None, seed=0):
    """``tests/test_data_parallel.py``'s program in ``fluid`` (either
    package): fc(16, relu), fc(1), a squared error ``loss_kind``: its
    batch ``mean``, its ``sum`` over the batch, or ``feedback``: the mean
    of the squared distance of the prediction from its batch mean (a
    batch reduction whose value flows back into rows)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with names.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[-1, 8])
        y = fluid.data("y", shape=[-1, 1])
        h = fluid.layers.fc(x, size=16, act="relu")
        pred = fluid.layers.fc(h, size=1)
        err = fluid.layers.square_error_cost(pred, y)
        if loss_kind == "sum":
            loss = fluid.layers.reduce_sum(err)
        elif loss_kind == "feedback":
            centred = fluid.layers.elementwise_sub(
                pred, fluid.layers.mean(pred))
            loss = fluid.layers.elementwise_add(
                fluid.layers.mean(err),
                fluid.layers.mean(fluid.layers.square(centred)))
        else:
            loss = fluid.layers.mean(err)
        (opt or fluid.optimizer.SGD(learning_rate=0.1)).minimize(loss)
    return main, startup, loss, pred


def _params(scope, main):
    return [scope.find_var(p.name).numpy().copy()
            for p in main.all_parameters()]


def run_regression(case, data, mesh):
    main, startup, loss, pred = build_regression(pt, unique_name,
                                                 case["loss"])
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    load_params(scope, {p.name: data[f"init_{i}"]
                        for i, p in enumerate(main.all_parameters())})
    prog = pt.CompiledProgram(main).with_parallel(
        mesh=mesh, loss_name=loss.name)
    feed = {"x": data["x"], "y": data["y"]}
    losses, preds, digests, stats = [], [], [], []
    for _ in range(case["steps"]):
        penv.reset_collective_stats()
        lv, pv = exe.run(prog, feed=feed, fetch_list=[loss, pred],
                         scope=scope)
        stats.append(penv.collective_stats())
        losses.append(lv)
        preds.append(pv)
        digests.append(digest(_params(scope, main)))
    arrays = {"losses": np.stack(losses), "preds": np.stack(preds)}
    arrays.update({f"param_{i}": a
                   for i, a in enumerate(_params(scope, main))})
    return arrays, {"digests": digests, "collectives": stats}


def _bert_cfg(case):
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(**case["cfg"])
    cfg.use_flash_attention = True
    cfg.attention_probs_dropout_prob = 0.0
    return bert, cfg


def run_bert(case, data, mesh):
    bert, cfg = _bert_cfg(case)
    with unique_name.guard():
        main, startup, _, fetches = bert.build_bert_pretrain(
            cfg, seq_len=case["seq"], lr=case["lr"],
            max_predictions_per_seq=case["P"])
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    names = json.loads(str(data["names"]))
    load_params(scope, {n: data[f"s_{i}"] for i, n in enumerate(names)})
    prog = pt.CompiledProgram(main).with_parallel(
        mesh=mesh, loss_name=fetches[0].name)
    feed = {k[len("feed_"):]: data[k] for k in data if k.startswith("feed_")}
    fetch = [fetches[0], case["mask"], case["tok"] + "@GRAD"]
    outs, digests, stats = [], [], []
    for _ in range(case["steps"]):
        penv.reset_collective_stats()
        outs.append(exe.run(prog, feed=feed, fetch_list=fetch, scope=scope))
        stats.append(penv.collective_stats())
        digests.append(digest(_params(scope, main)))
    state = persistables_to_numpy(scope, main)
    arrays = {key: np.stack([o[j] for o in outs]) for j, key in enumerate(
        ("losses", "masks", "tok_grad"))}
    arrays.update({f"s_{i}": state[n] for i, n in enumerate(names)})
    return arrays, {"digests": digests, "collectives": stats}


def run_unequal(case, data, mesh):
    main, startup, loss, _ = build_regression(
        pt, unique_name, seed=case["seed"] + mesh.rank)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    init = _params(scope, main)
    prog = pt.CompiledProgram(main).with_parallel(mesh=mesh,
                                                  loss_name=loss.name)
    lv, = exe.run(prog, feed={"x": data["x"], "y": data["y"]},
                  fetch_list=[loss], scope=scope)
    arrays = {"loss": lv}
    arrays.update({f"init_{i}": a for i, a in enumerate(init)})
    arrays.update({f"param_{i}": a
                   for i, a in enumerate(_params(scope, main))})
    return arrays, {}


def run_errors(case, data, mesh):
    main, startup, loss, _ = build_regression(pt, unique_name)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    prog = pt.CompiledProgram(main).with_parallel(mesh=mesh,
                                                  loss_name=loss.name)
    try:
        exe.run(prog, feed={"x": data["x"][:7], "y": data["y"][:7]},
                fetch_list=[loss], scope=scope)
        return {}, {"indivisible": None}
    except pt.EnforceError as e:
        return {}, {"indivisible": str(e)}


def run_collective(case, data, mesh):
    axis = mesh.axis("data")
    x = torch.from_numpy(np.ascontiguousarray(data["x"][axis.rank]))
    out = {}
    with penv.collective_context({0: axis}):
        for op_type in case["ops"]:
            out[op_type] = get_op_def(op_type).lower(
                {"X": [x]}, {"ring_id": 0})["Out"][0].numpy()
    # ring 1 is not bound: an identity
    with penv.collective_context({0: axis}):
        out["unbound"] = get_op_def("c_allreduce_sum").lower(
            {"X": [x]}, {"ring_id": 1})["Out"][0].numpy()
    # through a program: the builder's op inside the bound ring
    main = pt.Program()
    with unique_name.guard(), pt.program_guard(main, pt.Program()):
        xv = pt.data("x", shape=[-1, x.shape[1]])
        summed = C._allreduce(xv)
    with penv.collective_context({0: axis}):
        out["program"], = pt.Executor(pt.CPUPlace()).run(
            main, feed={"x": x.numpy()}, fetch_list=[summed])
    return out, {}


def run_dgc_dense(case, data, mesh):
    opt = pt.optimizer.DGCMomentumOptimizer(
        learning_rate=0.1, momentum=0.9, rampup_begin_step=0,
        sparsity=[0.75])
    main, startup, loss, pred = build_regression(pt, unique_name, opt=opt)
    if case.get("manual"):
        # an identity c_allreduce_sum beside the loss: a manual-region op
        with pt.program_guard(main, startup):
            C._allreduce(pred)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    load_params(scope, {p.name: data[f"init_{i}"]
                        for i, p in enumerate(main.all_parameters())})
    prog = pt.CompiledProgram(main).with_parallel(mesh=mesh,
                                                  loss_name=loss.name)
    old = flags.dgc_sparse_exchange
    flags.dgc_sparse_exchange = case["sparse_flag"]
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            losses = [exe.run(prog, feed={"x": data["x"], "y": data["y"]},
                              fetch_list=[loss], scope=scope)[0]
                      for _ in range(case["steps"])]
    finally:
        flags.dgc_sparse_exchange = old
    arrays = {"losses": np.stack(losses)}
    arrays.update({f"param_{i}": a
                   for i, a in enumerate(_params(scope, main))})
    return arrays, {"warnings": [str(w.message) for w in caught
                                 if "DGCMomentumOptimizer" in str(w.message)]}


def run_fleet(case, data, mesh):
    from paddle_tpu_torch.fleet import (DistributedStrategy,
                                        PaddleCloudRoleMaker, fleet)

    main, startup = pt.Program(), pt.Program()
    with unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", shape=[-1, 8])
        y = pt.data("y", shape=[-1, 1])
        h = pt.layers.fc(x, size=16, act="relu", param_attr=pt.ParamAttr(
            initializer=pt.initializer.Constant(0.05)))
        pred = pt.layers.fc(h, size=1, param_attr=pt.ParamAttr(
            initializer=pt.initializer.Constant(0.1)))
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        fleet.init(PaddleCloudRoleMaker())
        strategy = DistributedStrategy()
        strategy.use_amp = case["amp"]
        fleet.distributed_optimizer(pt.optimizer.SGD(learning_rate=0.1),
                                    strategy).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(fleet.startup_program)
        losses = [exe.run(fleet.main_program, feed={"x": data["x"],
                                                    "y": data["y"]},
                          fetch_list=[loss])[0]
                  for _ in range(case["steps"])]
    return {"losses": np.stack(losses)}, {
        "worker_num": fleet.worker_num(), "index": fleet.worker_index(),
        "first": fleet.is_first_worker()}


def build_bert_lamb(seq, P, recompute=False, fleet=None):
    """``tests/test_torch_recompute.py``'s tiny BERT with LAMB, its
    warm-up into polynomial decay and a global-norm clip, minimized
    through ``fleet`` with ``DistributedStrategy.recompute`` (or, without
    a fleet, directly, under ``RecomputeOptimizer`` with ``recompute``)."""
    from paddle_tpu_torch.fleet import DistributedStrategy
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = 0.1
    cfg.attention_probs_dropout_prob = 0.0
    sched = pt.layers.learning_rate_scheduler
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 5
    with unique_name.guard(), pt.program_guard(main, startup):
        _, fetches = bert.bert_pretrain_net(cfg, seq, P)
        lr = sched.linear_lr_warmup(sched.polynomial_decay(1e-3, 1000, 0.0,
                                                           1.0),
                                    10, 0.0, 1e-3)
        opt = pt.optimizer.Lamb(
            learning_rate=lr, lamb_weight_decay=0.01,
            exclude_from_weight_decay_fn=lambda p: "ln" in p.name
            or p.name.endswith((".b", ".b_0")),
            grad_clip=pt.clip.GradientClipByGlobalNorm(1.0))
        if fleet is None:
            if recompute:
                opt = pt.optimizer.RecomputeOptimizer(opt)
                opt._set_checkpoints(bert.encoder_checkpoints(main))
            opt.minimize(fetches[0])
        else:
            strategy = DistributedStrategy()
            strategy.recompute = recompute
            strategy.recompute_checkpoints = bert.encoder_checkpoints(main)
            fleet.distributed_optimizer(opt, strategy).minimize(fetches[0])
    return main, startup, fetches


def run_fleet_bert(case, data, mesh):
    from paddle_tpu_torch.fleet import PaddleCloudRoleMaker, fleet

    fleet.init(PaddleCloudRoleMaker())
    main, startup, fetches = build_bert_lamb(case["seq"], case["P"],
                                             case["recompute"], fleet)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(fleet.startup_program, scope=scope)
    names = json.loads(str(data["names"]))
    load_params(scope, {n: data[f"s_{i}"] for i, n in enumerate(names)})
    feed = {k[len("feed_"):]: data[k] for k in data if k.startswith("feed_")}
    losses = [exe.run(fleet.main_program, feed=feed, fetch_list=[fetches[0]],
                      scope=scope)[0] for _ in range(case["steps"])]
    state = persistables_to_numpy(scope, main)
    arrays = {"losses": np.stack(losses)}
    arrays.update({f"s_{i}": state[n] for i, n in enumerate(names)})
    return arrays, {"segments": sum(op.type == "recompute_segment_grad"
                                    for op in main.global_block().ops)}


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


RUNNERS = {"regression": run_regression, "bert": run_bert,
           "unequal": run_unequal, "errors": run_errors,
           "collective": run_collective, "dgc_dense": run_dgc_dense,
           "fleet": run_fleet, "fleet_bert": run_fleet_bert}


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
        got, info = RUNNERS[case["kind"]](case, data, mesh)
        arrays.update({prefix + k: v for k, v in got.items()})
        meta[name] = info
    np.savez(os.path.join(out_dir, f"rank{axis.rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{axis.rank}.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
