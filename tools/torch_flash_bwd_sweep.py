#!/usr/bin/env python3
"""K2a and K2b (the flash-attention backward) over design variants, on one
card.

    python3 tools/torch_flash_bwd_sweep.py [--only NAME ...] [--extra NAME=PATH ...]

Each variant is ``kernels/csrc/flash_attention.cu`` with a constant, a
launch bound or ``mma3_pair``'s body replaced (the streamed tile's rows,
the ring's depth, the registers a block may take, how two k steps' six
MMAs are summed, and, as a timing probe that fails the bars, the big x
big MMAs alone: plain TF32), built with the port's nvcc flags beside the
real library, all builds started together, and run through the port's
own wrappers and binding (``kernels/flash_attention.py``); ``--extra``
adds whole sources (an earlier design, a parent's copy) under a name.
For each it prints the registers and spills of the D <= 64
kernels (``-Xptxas -v``), the max abs error of dK, dV, dbias and dQ
against the plain versions at BERT-base's shape (B=32, H=12, S=128, D=64,
padding bias), at D=128, at S=512 causal and at S=1, D=64 (where dbias is zero in
exact arithmetic and only rounding is left), whether each is inside the
float32 bars (rtol 1e-4, atol 1e-5), and then the device ms a call of
K2a (no dbias, as BERT calls it) and K2b at BERT-base's shape and at
D=128 (``chip_smoke.device_ms``), the variants timed in turns, forward and
back, twice. Prints the card's name and power limit. Needs a CUDA card
and nvcc.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                      "flash_attention.cu")
OUT = os.path.join(ROOT, "paddle_tpu_torch", "kernels", "_build", "sweep")

# mma3_pair, from its signature to the closing brace of its body
_PAIR = re.compile(r"(void mma3_pair\([^{]*\{\n).*?\n\}\n", re.S)


def _pair_body(lines):
    """A replacement of mma3_pair's body by ``lines``."""
    return _PAIR, lambda m: m.group(1) + lines + "}\n"


_TWO_CHAINS = _pair_body("""  float d[4] = {0.f, 0.f, 0.f, 0.f}, f[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(f, a0.small, b0.big);
  mma_tf32(d, a0.big, b0.big);
  mma_tf32(f, a0.big, b0.small);
  mma_tf32(d, a1.big, b1.big);
  mma_tf32(f, a1.small, b1.big);
  mma_tf32(f, a1.big, b1.small);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e] + f[e];
""")
_THREE_CHAINS = _pair_body("""  float d[4] = {0.f, 0.f, 0.f, 0.f}, f[4] = {0.f, 0.f, 0.f, 0.f};
  float h[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(f, a0.small, b0.big);
  mma_tf32(h, a1.small, b1.big);
  mma_tf32(d, a0.big, b0.big);
  mma_tf32(f, a0.big, b0.small);
  mma_tf32(h, a1.big, b1.small);
  mma_tf32(d, a1.big, b1.big);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e] + (f[e] + h[e]);
""")
_ONE_ACCUMULATOR = _pair_body("""  mma_tf32(c, a0.small, b0.big);
  mma_tf32(c, a0.big, b0.small);
  mma_tf32(c, a1.small, b1.big);
  mma_tf32(c, a1.big, b1.small);
  mma_tf32(c, a0.big, b0.big);
  mma_tf32(c, a1.big, b1.big);
""")
_BIG_ONLY = _pair_body("""  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, a0.big, b0.big);
  mma_tf32(d, a1.big, b1.big);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
""")
_DKDV_TILE = re.compile(r"constexpr int kDkdvTile = \d+;")
_DQ_TILE = re.compile(r"constexpr int kDqTile = \d+;")
_STAGES = re.compile(r"constexpr int kBwdStages = \d+;")
_DKDV_BOUNDS = re.compile(r"__launch_bounds__\(kBwdThreads\)\nflash_bwd_dkdv_kernel")
_DQ_BOUNDS = re.compile(r"__launch_bounds__\(kBwdThreads, dq_blocks<NT>\(\)\)")

# name -> [(pattern, replacement)]; the first is the source as it is
VARIANTS = {
    "as built": [],
    "K2a tile 32": [(_DKDV_TILE, "constexpr int kDkdvTile = 32;")],
    "K2b tile 32": [(_DQ_TILE, "constexpr int kDqTile = 32;")],
    "3 stages": [(_STAGES, "constexpr int kBwdStages = 3;")],
    "K2a at 3 blocks an SM": [(_DKDV_BOUNDS,
                               "__launch_bounds__(kBwdThreads, 3)\nflash_bwd_dkdv_kernel")],
    "K2b with no register cap": [(_DQ_BOUNDS, "__launch_bounds__(kBwdThreads)")],
    "K2b capped for 3 blocks in every class": [(_DQ_BOUNDS,
                                                "__launch_bounds__(kBwdThreads, 3)")],
    "two chains a pair (small terms, big terms)": [_TWO_CHAINS],
    "three chains a pair": [_THREE_CHAINS],
    "K2a tile 32, two chains": [(_DKDV_TILE, "constexpr int kDkdvTile = 32;"),
                                _TWO_CHAINS],
    "one accumulator a product": [_ONE_ACCUMULATOR],
    # a timing probe only: plain TF32 fails the float32 bars
    "big x big only (1xTF32)": [_BIG_ONLY],
}
BAR = (1e-4, 1e-5)


def patched(replacements):
    if isinstance(replacements, str):  # a whole source
        return open(replacements).read()
    text = open(SOURCE).read()
    for pattern, new in replacements:
        text, n = pattern.subn(new, text)
        if n == 0:
            raise SystemExit(f"sweep: {pattern.pattern!r} not found in the source")
    return text


def build_variant(index, name, replacements):
    from paddle_tpu_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, f"variant{index}.cu")
    lib = os.path.join(OUT, f"libvariant{index}.so")
    with open(src, "w") as f:
        f.write(patched(replacements))
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise SystemExit(f"sweep: nvcc failed for {name}:\n{proc.stdout}")
    # ptxas's lines for the D <= 64 backward kernels (template argument 8)
    notes, current = [], None
    for line in proc.stdout.splitlines():
        if "Compiling entry function" in line:
            current = ("K2a" if "dkdv_kernelILi8E" in line else
                       "K2b" if "dq_kernelILi8E" in line else
                       "K2a" if "dkdv_kernelE" in line else
                       "K2b" if "dq_kernelE" in line else None)
        elif current and ("registers" in line or "spill" in line):
            notes.append(f"{current}: {line.split(':', 1)[-1].strip()}")
    return lib, notes


def main():
    import numpy as np
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--only", nargs="*", help="variant names to run")
    parser.add_argument("--extra", nargs="*", default=[], metavar="NAME=PATH",
                        help="whole sources (another design, a parent's "
                             "copy) built and timed beside the variants")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_bwd_sweep: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import flash_attention as FA

    cs.check_environment()
    variants = {n: r for n, r in VARIANTS.items() if not opts.only or n in opts.only}
    variants.update(e.split("=", 1) for e in opts.extra)
    names = list(variants)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(lambda a: build_variant(*a),
                              [(i, n, variants[n]) for i, n in enumerate(names)]))
    libs = {}
    for name, (path, notes) in zip(names, built):
        libs[name] = FA._declare(ctypes.CDLL(path))
        for note in notes:
            print(f"[sweep] {name}: {note}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)

    def inputs(B, H, S, D, causal):
        q, k, v, dout, bias = cs.flash_inputs(gen, dev, B, H, S, D)
        scale = 1.0 / float(np.sqrt(D))
        o, lse = FA.flash_attention_composite(q, k, v, bias, causal, scale)
        delta = (dout * o).sum(-1)
        return (q, k, v, bias, dout, lse, delta, causal, scale)

    def through(lib, fn, *args, **kwargs):
        """The port's wrapper ``fn`` (its checks, binding and launch) run
        on the variant's library ``lib``."""
        with mock.patch.object(FA, "_lib", lambda: lib):
            return fn(*args, **kwargs)

    cases = {"S=128": inputs(32, 12, 128, 64, False),
             "S=128 D=128": inputs(32, 12, 128, 128, False),
             "S=512 causal": inputs(32, 12, 512, 64, True),
             "S=1": inputs(32, 12, 1, 64, False)}
    for tag, args in cases.items():
        want = (*FA.flash_attention_bwd_dkdv_composite(*args),
                FA.flash_attention_bwd_dq_composite(*args))
        for name, lib in libs.items():
            got = (*through(lib, FA.flash_attention_bwd_dkdv, *args),
                   through(lib, FA.flash_attention_bwd_dq, *args))
            parts = []
            for label, g, w in zip(("dK", "dV", "dbias", "dQ"), got, want):
                diff = (g - w).abs()
                inside = bool((diff <= BAR[1] + BAR[0] * w.abs()).all())
                parts.append(f"{label} {float(diff.max()):.3e}"
                             f"{'' if inside else ' OUTSIDE'}")
            print(f"[sweep] {name}: {tag} max abs err " + ", ".join(parts),
                  flush=True)

    for tag in ("S=128", "S=128 D=128"):
        args = cases[tag]
        times = {n: {"K2a": [], "K2b": []} for n in names}
        for order in (names, names[::-1], names, names[::-1]):
            for name in order:
                lib = libs[name]
                times[name]["K2a"].append(cs.device_ms(lambda: through(
                    lib, FA.flash_attention_bwd_dkdv, *args, want_dbias=False), 10))
                times[name]["K2b"].append(cs.device_ms(lambda: through(
                    lib, FA.flash_attention_bwd_dq, *args), 10))
        for name in names:
            a, b = times[name]["K2a"], times[name]["K2b"]
            print(f"[sweep] {name}: device ms a call at {tag}, K2a (no dbias) "
                  f"{' '.join(f'{x:.4f}' for x in a)}, K2b "
                  f"{' '.join(f'{x:.4f}' for x in b)}; medians "
                  f"{float(np.median(a)):.4f} + {float(np.median(b)):.4f} = "
                  f"{float(np.median(a)) + float(np.median(b)):.4f}")
    print(cs.card_line())


if __name__ == "__main__":
    main()
