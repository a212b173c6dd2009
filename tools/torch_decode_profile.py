#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time, on one card.

    python3 tools/torch_decode_profile.py [--trace PATH]

Builds the decode engine at the slice's full width (GPT-base: vocab
32000, hidden 768, 12 layers, FFN 3072, 8 slots, context 1024, blocks of
16), fills all 8 slots with 256-token prompts, and hand-steps the decode
batch (no scheduler thread), so every step runs all 8 slots:

1. A/B of the paged-attention kernel end to end: decode steps timed on
   the host clock (each step ends in the argmax's device-to-host copy)
   with kernels ``off`` (plain PyTorch attention) and ``auto`` (the CUDA
   kernel), ``TURNS`` turns of ``AB_STEPS`` steps in the order off, auto,
   auto, off, ... within one process.
2. A ``torch.profiler`` trace of ``STEPS`` steps with the kernel on:
   device busy time (union of GPU activity) against the host wall time
   (the profiler's own host cost included), the device's idle share, GPU
   time by kernel, and the host-side synchronisations per step.

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(vocab_size=32000, hidden=768, num_layers=12, ffn_dim=3072,
             slots=8, max_len=1024, block_size=16)
PROMPT_LEN, SEED = 256, 7
STEPS, TURNS, AB_STEPS = 10, 8, 20


def _busy_us(events, device_type):
    """Union of the device-side event intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == device_type
                   and e.time_range.end > e.time_range.start)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default=None,
                    help="write the profiled steps' Chrome trace here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_decode_profile: no CUDA device")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import GenerationEngine, build_decoder_model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    model = build_decoder_model(**MODEL)
    n_ops = len(model.decode_program.global_block().ops)
    engine = GenerationEngine(seed=SEED)
    entry = engine.register_model(model)
    rng = np.random.RandomState(SEED)
    steps_needed = TURNS * AB_STEPS + STEPS + 16
    max_new = min(MODEL["max_len"] - PROMPT_LEN, steps_needed + 8)
    for _ in range(MODEL["slots"]):
        engine.submit(rng.randint(0, MODEL["vocab_size"], PROMPT_LEN).tolist(),
                      max_new_tokens=max_new)
    entry._admit_free_slots()
    assert entry.stats()["active_slots"] == MODEL["slots"]

    def steps(n):
        t0 = time.perf_counter()
        for _ in range(n):
            entry._step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    steps(5)                                        # warm-up
    ab = {"off": [], "auto": []}
    for mode in (["off", "auto", "auto", "off"] * TURNS)[:TURNS]:
        with kernels.scoped_mode(mode):
            ab[mode].append(steps(AB_STEPS))
    print(f"[ab] decode step ms, kernels off: {ab['off']}")
    print(f"[ab] decode step ms, kernels on:  {ab['auto']}")

    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            entry._step()
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
    sync_names = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaMemcpyAsync")
    host_calls = {n: sum(1 for e in events if e.name == n) for n in sync_names}
    host_calls["aten::nonzero"] = sum(1 for e in events
                                      if e.name == "aten::nonzero")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    per = STEPS
    print(f"[card] {card}")
    print(f"[profile] {per} steps, {n_ops} ops per step program, "
          f"paged_attention launches {launches['paged_attention']}")
    print(f"[profile] wall {wall_us / per / 1e3:.3f} ms/step, device busy "
          f"{busy_us / per / 1e3:.3f} ms/step, idle share "
          f"{1 - busy_us / wall_us:.4f}")
    for key, us, count in by_kernel[:12]:
        print(f"[profile]   {us / per:10.1f} us/step  {count / per:6.1f}x  {key[:90]}")
    print(f"[profile] host calls per step: "
          f"{ {k: v / per for k, v in host_calls.items()} }")
    print(json.dumps({
        "card": card, "ops_per_step": n_ops, "steps": per,
        "step_ms_kernels_off": ab["off"], "step_ms_kernels_on": ab["auto"],
        "profiled_wall_ms_per_step": wall_us / per / 1e3,
        "device_busy_ms_per_step": busy_us / per / 1e3,
        "device_idle_share": 1 - busy_us / wall_us,
        "paged_attention_launches": launches["paged_attention"],
        "host_calls_per_step": {k: v / per for k, v in host_calls.items()},
        "top_kernels_us_per_step": [[k, us / per] for k, us, _ in by_kernel[:12]],
    }))


if __name__ == "__main__":
    main()
