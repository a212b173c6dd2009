#!/usr/bin/env python3
"""Phase 3's decode step p50 in two checkouts, in turns on one card.

    python3 tools/torch_lockdep_cost.py ROOT_A ROOT_B [--rounds 2]

Runs ``chip_smoke.phase_engine`` (phase 3: ``GenerationEngine()`` serving
16 requests of 8-512 prompt tokens, 32 new each, at the GPT-base width)
in a fresh process from each checkout, in the order A, B, B, A per round,
and prints each run's decode step p50 and tokens/s, then each
checkout's median step p50. With A a checkout whose locks are plain
``threading`` locks and B one whose locks are lockdep-named (the witness
disabled, its default), the difference is what the named locks cost the
decode hot path. Each checkout builds its kernels once, in its first
run. Prints the card's name and power limit. Needs a CUDA card and
nvcc.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

_CHILD = """
import json
import chip_smoke as c
c.check_environment()
c.phase_build()
launches, tps, p50 = c.phase_engine()
print("RESULT " + json.dumps({"step_p50_ms": p50, "tokens_s": tps}))
"""


def run(root):
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=root,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{root}: exit {proc.returncode}\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    roots = {"A": os.path.abspath(args.root_a),
             "B": os.path.abspath(args.root_b)}
    p50s = {"A": [], "B": []}
    for r in range(args.rounds):
        for tag in ("A", "B", "B", "A"):
            res = run(roots[tag])
            p50s[tag].append(res["step_p50_ms"])
            print(f"round {r} {tag} ({roots[tag]}): decode step p50 "
                  f"{res['step_p50_ms']:.3f} ms, {res['tokens_s']:.1f} "
                  f"tokens/s", flush=True)
    for tag in ("A", "B"):
        print(f"{tag}: median step p50 {np.median(p50s[tag]):.3f} ms over "
              f"{len(p50s[tag])} runs: {[round(x, 3) for x in p50s[tag]]}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
