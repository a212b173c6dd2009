#!/usr/bin/env python3
"""Per-call costs of the CTR kernels K5 (embedding admission) and K6 (sparse
row update) and of their library calls, on one CUDA card, for the
``paddle_tpu_torch`` of any checkout:

    python3 tools/torch_ctr_kernel_cost.py [--root DIR] [--out FILE]
        [--legacy-api]

``--root`` is the checkout whose package is measured (default: this one),
so that another tree unpacked beside this one (``git archive``) is timed
by the same code on the same card. The shapes, the two clocks and the
numbers are ``chip_smoke.ctr_costs``'s (phase 2c): device ms per call with
the calls queued behind a sleep, host µs per call with no sync, for the
bare launch, the wrapper and ``index_copy_`` / ``index_add_``, and the
launch floor (the empty kernel of ``csrc/launch_floor.cu``). For a tree
from before the staging buffers (its K5 wrapper takes none, its bare K6
launch takes int32 ids only and it has no empty kernel), pass
``--legacy-api``: only what it has is timed. Prints the card's name and
power limit and one JSON line, and writes the JSON to ``--out`` when
given. Exits non-zero without a card.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose paddle_tpu_torch is measured")
    ap.add_argument("--out", help="also write the JSON result here")
    ap.add_argument("--legacy-api", action="store_true",
                    help="the tree's K5 wrapper takes no staging, its bare "
                    "K6 launch int32 ids only, and it has no launch floor")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "paddle_tpu_torch")):
        raise SystemExit(f"{root} holds no paddle_tpu_torch/")
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_ctr_kernel_cost: torch sees no CUDA device")
    torch.cuda.set_device(0)
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import embedding as KE

    if not KE.__file__.startswith(root):
        raise SystemExit(f"imported {KE.__file__}, not the tree at {root}")
    build.load("embedding_admission.cu")
    build.load("sparse_update.cu")
    costs = (smoke.ctr_costs(int64_ids=False, stagings=0)
             if args.legacy_api else
             smoke.ctr_costs(floor=smoke.launch_floors()))
    smoke.log_ctr_costs(costs)
    result = {"root": root, "card": smoke.card_line(),
              "torch": torch.__version__, "costs": costs}
    print(result["card"])
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
