#!/usr/bin/env python3
"""Device time of K8 (``kernels/csrc/threefry.cu``) on one CUDA card, for
the ``paddle_tpu_torch`` of any checkout:

    python3 tools/torch_k8_cost.py [--root DIR] [--out FILE]

``--root`` is the checkout whose package is measured (default: this one),
so that another tree unpacked beside this one (``git archive``) is timed
by the same code on the same card; run the two in turns (A B B A) in one
call. Times, with ``chip_smoke.device_ms`` (the calls queued behind a
sleep, median of 5 windows), the fused dropout forward at BERT-base's
hidden site ``[32, 128, 768]`` p = 0.1 and ``random_bits`` at the
word_embedding draw (23,440,896), both from counter 0 (the only counter a
tree from before the counter base has). Prints the card's name and power
limit and one JSON line, and writes the JSON to ``--out`` when given.
Exits non-zero without a card.
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
        raise SystemExit("torch_k8_cost: torch sees no CUDA device")
    torch.cuda.set_device(0)
    from paddle_tpu_torch.core import prng
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import random as KR

    if not KR.__file__.startswith(root):
        raise SystemExit(f"imported {KR.__file__}, not the tree at {root}")
    build.build("threefry.cu")
    build.load("threefry.cu")
    dev = torch.device("cuda", 0)
    key = prng.fold_in(prng.prng_key(smoke.SEED), 11)
    x = torch.randn((32, 128, 768), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    n = smoke.K8_TIMED_BITS
    result = {
        "root": root,
        "dropout_ms": smoke.device_ms(
            lambda: KR.dropout_fwd(x, key, 0.1, True)),
        "random_bits_ms": smoke.device_ms(
            lambda: KR.random_bits(key, n, dev)),
        "card": smoke.card_line(),
    }
    print(result["card"])
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main()
