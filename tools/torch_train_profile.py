#!/usr/bin/env python3
"""Where a BERT-base training step of the PyTorch port spends its time, on
one card.

    python3 tools/torch_train_profile.py [--dropout P] [--trace PATH]

Builds ``build_bert_pretrain(BertConfig.base())`` with flash attention,
hidden dropout P (default 0.1, the JAX bench recipe; 0 for none), seq 128,
P=20, float32 (the slice ``chip_smoke.py`` trains), runs
its startup program and two warm-up steps at batch 32 on one synthetic
batch, then:

1. A/B of the flash-attention kernels end to end: steps timed on the host
   clock (each ends in the loss's copy to the host) with kernels ``off``
   (plain PyTorch attention) and ``auto`` (the CUDA kernels), ``TURNS``
   turns of ``AB_STEPS`` steps in the order auto, off, off, auto, ...
   within one process.
2. A ``torch.profiler`` trace of ``STEPS`` steps with the kernels on:
   device busy time (union of GPU activity) against the host wall time
   (the profiler's own host cost included), the device's idle share, GPU
   time by kernel, the three flash kernels' share of the device time and
   K8's dropout kernel's time a step.

Prints a summary and, as its last line, one JSON object; with
``--trace PATH`` it also writes the profiler's Chrome trace there. Needs
a CUDA card; it does not run on the CPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from torch_decode_profile import _busy_us

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SEQ, P, SEED = 32, 128, 20, 7
STEPS, TURNS, AB_STEPS = 3, 4, 3
FLASH = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default=None,
                    help="write the profiled steps' Chrome trace here")
    ap.add_argument("--dropout", type=float, default=0.1,
                    help="hidden dropout probability (0 for none)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: no CUDA device")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import bert

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cfg = bert.BertConfig.base()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = args.dropout
    cfg.attention_probs_dropout_prob = 0.0
    main_prog, startup, _, fetches = bert.build_bert_pretrain(
        cfg, seq_len=SEQ, lr=1e-4, max_predictions_per_seq=P)
    n_ops = len(main_prog.global_block().ops)
    batch = bert.synthetic_batch(np.random.RandomState(SEED), BATCH, SEQ, cfg, P)
    startup.random_seed = SEED
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)

    def steps(n):
        t0 = time.perf_counter()
        for _ in range(n):
            exe.run(main_prog, feed=batch, fetch_list=[fetches[0]], scope=scope)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    steps(2)                                        # warm-up
    ab = {"off": [], "auto": []}
    for mode in (["auto", "off", "off", "auto"] * TURNS)[:TURNS]:
        with kernels.scoped_mode(mode):
            ab[mode].append(steps(AB_STEPS))
    print(f"[ab] step ms, kernels off: {ab['off']}")
    print(f"[ab] step ms, kernels on:  {ab['auto']}")

    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            exe.run(main_prog, feed=batch, fetch_list=[fetches[0]], scope=scope)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = kernels.launches()
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
    flash_us = {f: sum(us for k, us, _ in by_kernel if f in k) for f in FLASH}
    gemm_us = sum(us for k, us, _ in by_kernel if "gemm" in k.lower()
                  or "sgemm" in k.lower())
    k8_us = sum(us for k, us, _ in by_kernel if "dropout_kernel" in k)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    per = STEPS
    print(f"[card] {card}")
    print(f"[profile] hidden dropout {args.dropout}: K8 dropout "
          f"{k8_us / per / 1e3:.4f} ms/step")
    print(f"[profile] {per} steps, {n_ops} ops per step program, launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    print(f"[profile] wall {wall_us / per / 1e3:.3f} ms/step, device busy "
          f"{busy_us / per / 1e3:.3f} ms/step, idle share "
          f"{1 - busy_us / wall_us:.4f}")
    print(f"[profile] kernel time {kernel_us / per / 1e3:.3f} ms/step, GEMMs "
          f"{gemm_us / per / 1e3:.3f}, flash "
          f"{ {k: round(v / per / 1e3, 4) for k, v in flash_us.items()} } ms/step, "
          f"flash share of kernel time {sum(flash_us.values()) / kernel_us:.4f}")
    for key, us, count in by_kernel[:15]:
        print(f"[profile]   {us / per:10.1f} us/step  {count / per:6.1f}x  {key[:90]}")
    print(json.dumps({
        "card": card, "dropout": args.dropout, "ops_per_step": n_ops,
        "steps": per, "k8_dropout_ms_per_step": k8_us / per / 1e3,
        "step_ms_kernels_off": ab["off"], "step_ms_kernels_on": ab["auto"],
        "profiled_wall_ms_per_step": wall_us / per / 1e3,
        "device_busy_ms_per_step": busy_us / per / 1e3,
        "device_idle_share": 1 - busy_us / wall_us,
        "kernel_ms_per_step": kernel_us / per / 1e3,
        "gemm_ms_per_step": gemm_us / per / 1e3,
        "flash_ms_per_step": {k: v / per / 1e3 for k, v in flash_us.items()},
        "flash_share_of_kernel_time": sum(flash_us.values()) / kernel_us,
        "launches": launches,
        "top_kernels_us_per_step": [[k, us / per] for k, us, _ in by_kernel[:15]],
    }))


if __name__ == "__main__":
    main()
