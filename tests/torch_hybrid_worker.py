"""One rank of ``tests/test_torch_hybrid.py``'s gang of 4 (gloo over a
``file://`` rendezvous). Runs each case of ``cases.json`` on its mesh
through ``CompiledProgram.with_parallel``, from the global weights in
``inputs.npz``, and writes ``rank<r>.npz`` (per step the loss, every
parameter's grad and value as the JAX global values, the collectives by
axis; after the steps this rank's own shards) and ``rank<r>.json``.
Its stderr goes to ``rank<r>.err`` beside them, which the test shows if
the gang fails.

    python tests/torch_hybrid_worker.py CASES.json INPUTS.npz OUT_DIR
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import gpt_ir
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.utils import unique_name

STEPS = 3
# every wait of the gang, the test's and the ranks' own
TIMEOUT_S = 120


def stack_model(F, num_layers=4, num_microbatches=2, schedule="gpipe"):
    """``tests/test_pipeline_ir.py``'s stack model, built with ``F``'s
    layers (either package): a ``PipelinedStack`` of relu(h @ w + b)
    layers under a squared-error loss and SGD(0.05)."""
    B, S, H = 8, 4, 16
    main, startup = F.Program(), F.Program()
    with F.program_guard(main, startup):
        x = F.data("x", shape=[B, S, H])
        y = F.data("y", shape=[B, S, H])
        stack = F.layers.PipelinedStack(
            num_layers=num_layers, num_microbatches=num_microbatches,
            schedule=schedule)
        with stack.layer():
            h = stack.input(x)
            w = stack.layer_param([H, H])
            b = stack.layer_param([H], is_bias=True)
            hp = F.layers.relu(
                F.layers.elementwise_add(F.layers.matmul(h, w), b))
            stack.output(hp)
        out = stack()
        loss = F.layers.mean(
            F.layers.square(F.layers.elementwise_sub(out, y)))
        F.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss, stack


def gpt_ir_config(module, tp=2, flash=True):
    """The tiny gpt_ir of the tests, in ``module`` (either package's
    ``models.gpt_ir``)."""
    return module.GPTIRConfig(vocab_size=64, hidden_size=32, num_layers=4,
                              num_heads=4, tp=tp, max_seq_len=16,
                              use_flash_attention=flash)


GPT_SEQ, GPT_BATCH, GPT_MICROBATCHES = 16, 8, 2


def build(case):
    with unique_name.guard():
        if case["model"] == "stack":
            main, startup, loss, stack = stack_model(pt)
        else:
            main, startup, _, loss, stack = gpt_ir.build_gpt_ir(
                gpt_ir_config(gpt_ir, flash=case["flash"]), seq_len=GPT_SEQ,
                num_microbatches=GPT_MICROBATCHES)
    return main, startup, loss, stack


def run_case(case, data):
    """Steps of one case on its mesh; ``case["shards"]`` loads each
    rank's shards itself (``convert.shard_params``) where the others load
    the global weights."""
    mesh = penv.make_mesh(tuple(case["mesh"]), tuple(case["axes"]))
    main, startup, loss, stack = build(case)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    feeds = {k: data[k] for k in case["feeds"]}
    prog = pt.CompiledProgram(main).with_parallel(
        mesh=mesh, loss_name=loss.name,
        param_specs=stack.param_spec_overrides())
    weights = {n: data[n] for n in names}
    if case.get("shards"):
        # this rank's shards, cut from the global arrays by its
        # coordinates: the first run takes them as placed
        for n, a in convert.shard_params(weights, prog.specs(names),
                                         mesh).items():
            scope.set(n, torch.from_numpy(a))
    else:
        # the global arrays: the first run slices them
        convert.load_params(scope, weights)
    out, stats = {}, []
    t0 = time.perf_counter()
    for i in range(STEPS):
        penv.reset_collective_stats()
        got = exe.run(prog, feed=feeds, scope=scope,
                      fetch_list=[loss] + [n + "@GRAD" for n in names])
        stats.append({f"{k}|{a}": list(v[:2]) for (k, a), v in
                      penv.collective_stats(by_axis=True).items()})
        out[f"loss{i}"] = got[0]
        out.update({f"grad{i}.{n}": g for n, g in zip(names, got[1:])})
        out.update({f"param{i}.{n}": prog.global_value(scope, n).numpy()
                    for n in names})
    seconds = time.perf_counter() - t0
    specs = prog.specs(names)
    out.update({f"local.{n}": scope.find_var(n).numpy() for n in names})
    meta = {"coords": mesh.coords, "stats": stats, "seconds": seconds,
            "specs": {n: [list(e) if isinstance(e, tuple) else e
                          for e in specs[n]] for n in names},
            "names": names}
    return out, meta


def run_gang(cases, inputs, tmp, meanwhile, n=4):
    """Start ``n`` ranks on ``cases`` under ``tmp``, call ``meanwhile()``
    while they run, and return its result and each rank's (arrays, meta).
    A rank that fails or outlives ``TIMEOUT_S`` fails the gang with every
    rank's stderr."""
    from paddle_tpu_torch.distributed import launch

    tmp = Path(tmp)
    (tmp / "cases.json").write_text(json.dumps(cases))
    np.savez(tmp / "inputs.npz", **inputs)
    procs = launch.spawn_gang(
        [__file__, str(tmp / "cases.json"), str(tmp / "inputs.npz"),
         str(tmp)], nproc=n, init_method=f"file://{tmp / 'store'}",
        extra_env={"OMP_NUM_THREADS": "1"})
    try:
        result = meanwhile()
    finally:
        codes = launch.wait_gang(procs, timeout_s=TIMEOUT_S)
    if codes != [0] * n:
        errs = "\n".join(
            f"--- rank {r} (exit {c}) ---\n"
            + (tmp / f"rank{r}.err").read_text()[-4000:]
            for r, c in enumerate(codes) if (tmp / f"rank{r}.err").exists())
        raise AssertionError(f"ranks exited {codes}:\n{errs}")
    return result, [(dict(np.load(tmp / f"rank{r}.npz")),
                     json.loads((tmp / f"rank{r}.json").read_text()))
                    for r in range(n)]


def main(cases_path, inputs_path, out_dir):
    rank = os.environ.get("PADDLE_TRAINER_ID", "0")
    err = os.open(os.path.join(out_dir, f"rank{rank}.err"),
                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(err, 2)
    torch.set_num_threads(1)
    with open(cases_path) as f:
        cases = json.load(f)
    inputs = np.load(inputs_path)
    arrays, meta = {}, {}
    for name, case in cases.items():
        prefix = name + "."
        data = {k[len(prefix):]: inputs[k] for k in inputs.files
                if k.startswith(prefix)}
        got, info = run_case(case, data)
        arrays.update({prefix + k: v for k, v in got.items()})
        meta[name] = info
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
