#!/usr/bin/env python3
"""Where a data-parallel DGC training step of the PyTorch port spends its
time: Transformer-base on 2 ranks sharing one card over gloo.

    python3 tools/torch_dgc_profile.py [--trace PATH]

Launches 2 ranks of itself through ``paddle_tpu_torch.distributed.launch``
(each rank runs this script with ``--rank DIR``). Each builds the
configuration ``chip_smoke.py`` phase 8 trains (``build_wmt_train(
TransformerConfig.base())``, no dropout, seq 64, DGC momentum with
warm-up at step 0 and sparsity 0.996 then 0.999, global batch 128, 64
sentences a rank, ``FLAGS_pallas_dgc_topk`` on), runs its startup and two
warm-up steps (the dense one and the first sparse one), then, on sparse
steps at 0.999, with every rank doing the same:

1. A/B of K7 end to end: steps timed on the host clock (each ends in the
   loss's copy and a synchronize) with kernels ``auto`` and ``off``,
   ``TURNS`` turns of ``AB_STEPS`` steps in the order auto, off, off,
   auto.
2. The split of one step: every ``dgc_momentum`` call, and inside it the
   top-k selection and the (index, value) exchange (the host copies and
   gloo's all-gather), timed on the host clock with a synchronize before
   and after each (the synchronizes add to the step); the rest of the
   step is the forward, the backward and the loss.
3. A ``torch.profiler`` trace of ``STEPS`` steps on rank 0: device busy
   time (union of GPU activity) against the host wall time, the idle
   share, GPU time by kernel and K7's share.

Rank 0 prints a summary and, as its last line, one JSON object; with
``--trace PATH`` it also writes the profiler's Chrome trace there. Needs
a CUDA card; it does not run on the CPU.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from torch_decode_profile import _busy_us

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS, BATCH, SEQ, SEED = 2, 128, 64, 20261016
OPT = dict(learning_rate=0.01, momentum=0.9, rampup_begin_step=1,
           rampup_step=2, sparsity=[0.996, 0.999])
STEPS, TURNS, AB_STEPS = 2, 4, 2


def _timed(fn, totals, key):
    import torch

    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        totals[key] = totals.get(key, 0.0) + time.perf_counter() - t0
        return out
    return wrapped


def rank_main(trace):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.registry import get_op_def
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops import optimizers as O
    from paddle_tpu_torch.parallel import env as penv
    from paddle_tpu_torch.utils.flags import flags

    flags.pallas_dgc_topk = True
    mesh = penv.make_mesh()
    rank = mesh.rank
    cfg = T.TransformerConfig.base()
    cfg.dropout = 0.0
    main_prog, startup, _, (loss,) = T.build_wmt_train(
        cfg, src_len=SEQ, tgt_len=SEQ,
        optimizer=fluid.optimizer.DGCMomentumOptimizer(**OPT))
    n_ops = len(main_prog.global_block().ops)
    startup.random_seed = SEED
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = T.synthetic_batch(np.random.RandomState(SEED), BATCH, SEQ, SEQ, cfg)
    prog = fluid.CompiledProgram(main_prog).with_parallel(
        mesh=mesh, loss_name=loss.name)

    def steps(n):
        t0 = time.perf_counter()
        for _ in range(n):
            exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    steps(2)                                  # the dense step, one sparse
    ab = {"off": [], "auto": []}
    for mode in (["auto", "off", "off", "auto"] * TURNS)[:TURNS]:
        with kernels.scoped_mode(mode):
            ab[mode].append(steps(AB_STEPS))

    # the split of one step: patch the lowering and its two parts
    totals = {}
    op_def = get_op_def("dgc_momentum")
    saved = (op_def.lower, O._dgc_topk_idx, penv.all_gather_pairs)
    op_def.lower = _timed(op_def.lower, totals, "dgc_momentum")
    O._dgc_topk_idx = _timed(O._dgc_topk_idx, totals, "top-k")
    penv.all_gather_pairs = _timed(penv.all_gather_pairs, totals, "exchange")
    try:
        split_step_ms = steps(1)
    finally:
        op_def.lower, O._dgc_topk_idx, penv.all_gather_pairs = saved
    split = {k: v * 1e3 for k, v in totals.items()}

    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(STEPS)
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = {k: v for k, v in kernels.launches().items() if v}
    if rank != 0:
        return
    events = prof.events()
    busy_us = _busy_us(events, DeviceType.CUDA)
    per_name = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.end - e.time_range.start,
                                n + 1)
    by_kernel = sorted(((k, us, n) for k, (us, n) in per_name.items()),
                       key=lambda r: -r[1])
    kernel_us = sum(us for _, us, _ in by_kernel)
    k7_us = sum(us for k, us, _ in by_kernel if "block_topk_" in k)
    sort_us = sum(us for k, us, _ in by_kernel if "sort" in k.lower()
                  or "radix" in k.lower())
    gemm_us = sum(us for k, us, _ in by_kernel if "gemm" in k.lower())
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    per = STEPS
    print(f"[card] {card}")
    print(f"[ab] sparse step ms, kernels off: {ab['off']}")
    print(f"[ab] sparse step ms, kernels on:  {ab['auto']}")
    print(f"[split] one step {split_step_ms:.2f} ms with a synchronize "
          f"around each dgc_momentum: "
          f"{ {k: round(v, 2) for k, v in split.items()} } ms")
    print(f"[profile] {per} steps, {n_ops} ops per step program, launches "
          f"{launches}")
    print(f"[profile] wall {wall_us / per / 1e3:.3f} ms/step, device busy "
          f"{busy_us / per / 1e3:.3f} ms/step, idle share "
          f"{1 - busy_us / wall_us:.4f}; kernel time "
          f"{kernel_us / per / 1e3:.3f} ms/step, GEMMs "
          f"{gemm_us / per / 1e3:.3f}, K7 {k7_us / per / 1e3:.3f}, sorts "
          f"{sort_us / per / 1e3:.3f}")
    for key, us, count in by_kernel[:15]:
        print(f"[profile]   {us / per:10.1f} us/step  {count / per:6.1f}x  "
              f"{key[:90]}")
    print(json.dumps({
        "card": card, "ranks": RANKS, "backend": mesh.backend,
        "ops_per_step": n_ops, "steps": per,
        "step_ms_kernels_off": ab["off"], "step_ms_kernels_on": ab["auto"],
        "split_step_ms": split_step_ms, "split_ms": split,
        "profiled_wall_ms_per_step": wall_us / per / 1e3,
        "device_busy_ms_per_step": busy_us / per / 1e3,
        "device_idle_share": 1 - busy_us / wall_us,
        "kernel_ms_per_step": kernel_us / per / 1e3,
        "gemm_ms_per_step": gemm_us / per / 1e3,
        "k7_ms_per_step": k7_us / per / 1e3,
        "sort_ms_per_step": sort_us / per / 1e3,
        "launches": launches,
        "top_kernels_us_per_step": [[k, us / per] for k, us, _ in by_kernel[:15]],
    }), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default=None,
                    help="write rank 0's profiled steps' Chrome trace here")
    ap.add_argument("--rank", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_dgc_profile: no CUDA device")
    if args.rank is not None:
        rank_main(args.trace)
        return
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.kernels import build

    build.build("topk.cu")            # once, before the ranks load it
    rdzv = tempfile.mkdtemp(prefix="torch_dgc_profile_")
    try:
        argv = [os.path.abspath(__file__), "--rank", rdzv]
        if args.trace:
            argv += ["--trace", os.path.abspath(args.trace)]
        codes = launch.launch_procs(
            argv, nproc=RANKS, init_method="file://" + os.path.join(rdzv, "store"),
            timeout_s=900)
    finally:
        shutil.rmtree(rdzv, ignore_errors=True)
    if codes != [0] * RANKS:
        raise SystemExit(f"torch_dgc_profile: ranks exited {codes}")


if __name__ == "__main__":
    main()
