#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel from the sources in the checkout, holds each
kernel against its plain PyTorch version at the decode engine's shapes,
then serves requests through the port's entry points at the full width
of the slice's model and checks the tokens against the port's offline
reference. Any failure exits non-zero. It imports nothing of JAX or of
the JAX package, and it refuses to run without a CUDA device (or outside
a checkout of the repository).

Phases:

1. build — ``nvcc`` for the kernels' source, then load it.
2. parity — each kernel against its plain version on the same inputs
   (S=8 slots, L=1024 positions, H=768, R=8192 arena rows, random block
   row maps with rows shared between slots, random cursors, one retired
   slot), timed with CUDA events (median of 5 windows of 10 passes over
   12 layers' arenas) beside the plain version, one PyTorch
   library call (``scaled_dot_product_attention`` on the gathered views,
   a yardstick the port never calls) and the card's bound.
3. engine — ``GenerationEngine()`` on the default place serving 16
   requests of 8-512 prompt tokens (4 share a 256-token prefix), 32 new
   tokens each, at the GPT-base width (vocab 32000, hidden 768, 12
   layers, FFN 3072, 8 slots, context 1024, blocks of 16). Launch
   counters are zeroed just before and read just after; 4 requests are
   checked against ``offline_decode`` on the card.
4. dense — a program with one fused ``cached_attention`` op (the dense
   slotted-cache form, served by ``decode_attention``) through
   ``Executor.run``, counters zeroed before and read after.

The last lines are the card's name and power limit, one JSON line of
per-kernel results, and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
S, L, H, R, BLOCK = 8, 1024, 768, 8192, 16
LAYERS = 12
MODEL = dict(vocab_size=32000, hidden=768, num_layers=12, ffn_dim=3072,
             slots=8, max_len=1024, block_size=16)
N_REQUESTS, SHARED_PREFIX, MAX_NEW = 16, 256, 32
PROMPT_LEN = (8, 512)
NEG_INF = -1e9
# The kernel and its plain version both produce convex combinations of
# N(0, 1) value rows, summed in float32 over 1024 positions in different
# orders (chunked online softmax vs one softmax + matmul). Rounding of
# such sums stays near 1e-6; 1e-4 leaves two orders of margin and still
# catches any wrong row, weight or mask.
PARITY_ATOL = 1e-4
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (paddle_tpu_torch/ is missing)")
    sys.path.insert(0, here)
    # full float32 matrix products and convolutions: the references here
    # compare float32 sums, which TF32's 10-bit mantissa would blur
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)


# -- phase 1 ----------------------------------------------------------------
def phase_build():
    from paddle_tpu_torch.kernels import KERNELS, build

    for source in sorted({os.path.basename(k.source) for k in KERNELS.values()}):
        t0 = time.perf_counter()
        out = build.build(source)
        build.load(source)
        log(f"[build] {source}: {time.perf_counter() - t0:.2f}s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


# -- phase 2 ----------------------------------------------------------------
def make_inputs(gen, device):
    """Random slice-shaped inputs: per-layer arenas, q, a block row map
    whose slots share some blocks, random cursors and one retired slot."""
    import torch

    rng = np.random.RandomState(SEED)
    n_blocks = R // BLOCK
    per_slot = L // BLOCK
    tables = [rng.choice(n_blocks, per_slot, replace=False) for _ in range(S)]
    tables[1][:per_slot // 4] = tables[0][:per_slot // 4]   # shared prefix
    rows = np.concatenate([
        (t[:, None] * BLOCK + np.arange(BLOCK)[None]).reshape(-1)
        for t in tables]).astype(np.int64)
    cursors = rng.randint(0, L, size=S)
    bias = np.full((S, 1, L), NEG_INF, np.float32)
    for s in range(S - 1):                 # the last slot is retired
        bias[s, 0, :cursors[s] + 1] = 0.0

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    return {
        "q": randn(S, H),
        "k": [randn(R, H) for _ in range(LAYERS)],
        "v": [randn(R, H) for _ in range(LAYERS)],
        "rows": torch.from_numpy(rows).to(device),
        "bias": torch.from_numpy(bias).to(device),
        "rows_np": rows,
        "bias_np": bias,
    }


def needed_positions(bias_np):
    """Per slot, the positions this run's data needs: the unmasked ones,
    or all of them for a fully masked slot (its output is the uniform
    average of every row)."""
    out = []
    for s in range(bias_np.shape[0]):
        live = np.nonzero(bias_np[s, 0] > NEG_INF / 2)[0]
        out.append(live if live.size else np.arange(bias_np.shape[-1]))
    return out


def bound(n_rows_read, positions, extra_bytes):
    """Least time for the work: rows read once, inputs and outputs moved
    once, two multiply-adds per element of each needed row."""
    bytes_ = n_rows_read * H * 4 * 2 + extra_bytes
    flops = positions * H * 4
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps, windows=5):
    """Milliseconds per call of ``fn``: CUDA events around ``reps`` calls,
    the median of ``windows`` such windows, after three warm-up calls
    (clocks ramp up from idle)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return float(np.median(times))


def phase_parity():
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import attention as A

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = make_inputs(gen, dev)
    q, rows, bias = x["q"], x["rows"], x["bias"]
    scale = 1.0 / float(np.sqrt(H))
    need = needed_positions(x["bias_np"])
    n_pos = sum(len(p) for p in need)
    results = {}

    # paged: 12 layers' arenas, so one layer's 50 MB of rows is not all
    # sitting in the 50 MB L2 when the next launch reads it
    errs = []
    for i in range(LAYERS):
        got = A.paged_attention(q, x["k"][i], x["v"][i], rows, bias, S, L,
                                scale)
        ref = A.paged_attention_composite(q, x["k"][i], x["v"][i], rows,
                                          bias, S, L, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError("paged_attention kernel: non-finite output")
        errs.append(float((got - ref).abs().max()))
    err = max(errs)
    log(f"[parity] paged_attention max_abs_err={err:.3e} (atol {PARITY_ATOL})")
    if not err <= PARITY_ATOL:
        raise AssertionError(f"paged_attention kernel disagrees: {err}")

    def run_layers(fn):
        def go():
            for i in range(LAYERS):
                fn(i)
        return go

    kernel_ms = time_ms(run_layers(lambda i: A.paged_attention(
        q, x["k"][i], x["v"][i], rows, bias, S, L, scale)), 10) / LAYERS
    plain_ms = time_ms(run_layers(lambda i: A.paged_attention_composite(
        q, x["k"][i], x["v"][i], rows, bias, S, L, scale)), 10) / LAYERS
    gk = [x["k"][i].index_select(0, rows).reshape(S, 1, L, H)
          for i in range(LAYERS)]
    gv = [x["v"][i].index_select(0, rows).reshape(S, 1, L, H)
          for i in range(LAYERS)]
    q4, mask4 = q.reshape(S, 1, 1, H), bias.reshape(S, 1, 1, L)
    lib_ms = time_ms(run_layers(lambda i: F.scaled_dot_product_attention(
        q4, gk[i], gv[i], attn_mask=mask4, scale=scale)), 10) / LAYERS
    rows_needed = np.unique(np.concatenate(
        [x["rows_np"][s * L + p] for s, p in enumerate(need)])).size
    b_ms, b_by = bound(rows_needed, n_pos,
                       S * H * 4 * 2 + S * L * (8 + 4))
    results["paged_attention"] = dict(max_abs_err=err, ms=kernel_ms,
                                      plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=b_by, library_ms=lib_ms)
    del gk, gv

    # dense: the same kernel over [S, L, H] caches
    kc = [x["k"][i][:S * L].reshape(S, L, H) for i in range(LAYERS)]
    vc = [x["v"][i][:S * L].reshape(S, L, H) for i in range(LAYERS)]
    errs = []
    for i in range(LAYERS):
        got = A.decode_attention(q, kc[i], vc[i], bias, scale)
        ref = A.cached_attention_composite(q, kc[i], vc[i], bias, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError("decode_attention kernel: non-finite output")
        errs.append(float((got - ref).abs().max()))
    err = max(errs)
    log(f"[parity] decode_attention max_abs_err={err:.3e} (atol {PARITY_ATOL})")
    if not err <= PARITY_ATOL:
        raise AssertionError(f"decode_attention kernel disagrees: {err}")
    kernel_ms = time_ms(run_layers(lambda i: A.decode_attention(
        q, kc[i], vc[i], bias, scale)), 10) / LAYERS
    plain_ms = time_ms(run_layers(lambda i: A.cached_attention_composite(
        q, kc[i], vc[i], bias, scale)), 10) / LAYERS
    lib_ms = time_ms(run_layers(lambda i: F.scaled_dot_product_attention(
        q4, kc[i].unsqueeze(1), vc[i].unsqueeze(1), attn_mask=mask4,
        scale=scale)), 10) / LAYERS
    b_ms, b_by = bound(n_pos, n_pos, S * H * 4 * 2 + S * L * 4)
    results["decode_attention"] = dict(max_abs_err=err, ms=kernel_ms,
                                       plain_ms=plain_ms, bound_ms=b_ms,
                                       bound_by=b_by, library_ms=lib_ms)
    for name, r in results.items():
        log(f"[parity] {name}: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
    return results


# -- phase 3 ----------------------------------------------------------------
def make_prompts(vocab):
    rng = np.random.RandomState(SEED)
    prefix = rng.randint(0, vocab, SHARED_PREFIX).tolist()
    prompts = []
    for i in range(N_REQUESTS):
        if i % 4 == 0:          # 4 requests share the 256-token prefix
            extra = int(rng.randint(PROMPT_LEN[0],
                                    PROMPT_LEN[1] - SHARED_PREFIX + 1))
            prompts.append(prefix + rng.randint(0, vocab, extra).tolist())
        else:
            n = int(rng.randint(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
            prompts.append(rng.randint(0, vocab, n).tolist())
    return prompts


def check_against_offline(entry, prompt, got, want):
    """Equal tokens, or a first divergence where the offline top-2 logit
    gap is below 1e-4 of the largest |logit| (a near-tie that float32
    sums in another order may break either way)."""
    import torch

    for t, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        toks = list(prompt) + list(want[:t])
        row = entry.prefill_logits(toks)[len(toks) - 1]
        top2 = torch.topk(row, 2).values
        gap = float(top2[0] - top2[1])
        tol = 1e-4 * float(row.abs().max())
        log(f"[engine] divergence at step {t}: engine {a} offline {b}, "
            f"offline top-2 gap {gap:.3e} (tolerated below {tol:.3e})")
        if gap >= tol:
            raise AssertionError(
                f"engine tokens diverge from offline_decode at step {t} "
                f"with a clear top-2 gap {gap}")
        return "near-tie"
    if len(got) != len(want):
        raise AssertionError(f"engine produced {len(got)} tokens, "
                             f"offline {len(want)}")
    return "equal"


def phase_engine():
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import GenerationEngine, build_decoder_model

    t0 = time.perf_counter()
    engine = GenerationEngine(seed=SEED)          # CUDAPlace(0) by default
    entry = engine.register_model(build_decoder_model(**MODEL))
    torch.cuda.synchronize()
    log(f"[engine] place={engine.place} startup {time.perf_counter() - t0:.2f}s "
        f"arena {entry.model.arena_bytes() / 2**20:.0f} MiB")
    prompts = make_prompts(MODEL["vocab_size"])
    engine.start()
    kernels.reset_launches()
    t0 = time.perf_counter()
    resps = [engine.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    outs = [[int(t) for t in r.result(timeout=600)["tokens"]] for r in resps]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    engine.shutdown()
    st = entry.stats()
    steps = st["steps"]
    log(f"[engine] {len(outs)} requests in {wall:.2f}s, {steps} decode steps, "
        f"launches {launches}")
    if st.get("completed", 0) != N_REQUESTS or len(outs) != N_REQUESTS:
        raise AssertionError(f"not every request completed: {st}")
    for o in outs:
        if len(o) != MAX_NEW or not all(0 <= t < MODEL["vocab_size"] for t in o):
            raise AssertionError(f"bad token stream {o[:8]}...")
    if launches["paged_attention"] < MODEL["num_layers"] * steps or steps == 0:
        raise AssertionError(
            f"paged_attention launched {launches['paged_attention']} times "
            f"over {steps} decode steps of {MODEL['num_layers']} layers")
    verdicts = []
    for i in (0, 1, 4, 7):                      # two of them share the prefix
        want = entry.offline_decode(prompts[i], MAX_NEW)
        verdicts.append(check_against_offline(entry, prompts[i], outs[i], want))
    log(f"[engine] offline_decode checks: {verdicts}")
    row = entry.prefill_logits(prompts[2])
    if tuple(row.shape) != (MODEL["max_len"], MODEL["vocab_size"]) or \
            not bool(torch.isfinite(row).all()):
        raise AssertionError("prefill logits are not finite [L, V]")
    step_ms = np.asarray(st["step_seconds"]) * 1e3
    prefill_ms = np.asarray(st["prefill_seconds"]) * 1e3
    generated = sum(len(o) for o in outs)
    log(f"[engine] decode step p50 {np.median(step_ms):.3f} ms "
        f"(p90 {np.percentile(step_ms, 90):.3f}), prefill p50 "
        f"{np.median(prefill_ms):.3f} ms over {len(prefill_ms)}, "
        f"{generated / wall:.1f} tokens/s, radix hits "
        f"{st['block_pool']['radix_hits']}")
    return launches


# -- phase 4 ----------------------------------------------------------------
def phase_dense():
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        q = fluid.data("q", [S, H], dtype="float32")
        kc = fluid.data("kc", [S, L, H], dtype="float32")
        vc = fluid.data("vc", [S, L, H], dtype="float32")
        bias = fluid.data("bias", [S, 1, L], dtype="float32")
        out = fluid.layers.cached_attention(q, kc, vc, bias,
                                            sm_scale=1.0 / np.sqrt(H),
                                            fused=True)
    exe = fluid.Executor()                        # CUDAPlace(0) by default
    dev = exe.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    feeds = {
        "q": torch.randn(S, H, generator=gen, device=dev),
        "kc": torch.randn(S, L, H, generator=gen, device=dev),
        "vc": torch.randn(S, L, H, generator=gen, device=dev),
        "bias": torch.zeros(S, 1, L, device=dev),
    }
    kernels.reset_launches()
    for _ in range(LAYERS):
        res = exe.run(main, feed=feeds, fetch_list=[out])[0]
    torch.cuda.synchronize()
    launches = kernels.launches()
    if res.shape != (S, H) or not np.isfinite(res).all():
        raise AssertionError("dense path output is not finite [S, H]")
    log(f"[dense] launches {launches}")
    if launches["decode_attention"] < LAYERS:
        raise AssertionError("decode_attention was not launched")
    return launches


def main():
    check_environment()
    import torch

    from paddle_tpu_torch.kernels import KERNELS

    t_all = time.perf_counter()
    card = card_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    phase_build()
    parity = phase_parity()
    engine_launches = phase_engine()
    dense_launches = phase_dense()
    path_launches = {"paged_attention": engine_launches["paged_attention"],
                     "decode_attention": dense_launches["decode_attention"]}
    rows = []
    for name, info in KERNELS.items():
        r = parity[name]
        rows.append({"name": name, "route": "cuda", "source": info.source,
                     "replaces": info.replaces,
                     "launches": path_launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    log(f"[done] {time.perf_counter() - t_all:.1f}s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
