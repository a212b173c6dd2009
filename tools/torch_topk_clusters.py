#!/usr/bin/env python3
"""K7 (the blocked top-k of |x|) over cluster sizes, on one card.

    python3 tools/torch_topk_clusters.py

At the (numel, k) pairs of a sparse Transformer-base DGC step (131072-
element blocks), times on the device (``chip_smoke.device_ms``) the stage
alone with clusters of 8, 10, 12 and 16 CTAs a block, and the whole
function (stage and folded selection, one C call) with the selection's
cluster from 1 to 16 CTAs, each whole call checked bit for bit against
the plain version. Cluster sizes over 8 run only where the card schedules
them (``blocked_topk_cluster_size``). Prints one line a measurement and
the card's name and power limit. Needs a CUDA card.
"""

import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 131072
PAIRS = ((262144, 1049), (1048576, 4194), (37000 * 512, 75776))
STAGE_CLUSTERS = (8, 10, 12, 16)
SELECT_CLUSTERS = (1, 2, 3, 4, 8, 12, 16)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_topk_clusters: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import topk as KT

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = build.function("topk.cu", "blocked_topk_abs_f32",
                            [i, p, p, p, p, p, ll, i, i, i, i, i, p])
    schedules = build.function("topk.cu", "blocked_topk_cluster_size",
                               [i, i, i, i])
    select_smem = build.function("topk.cu", "blocked_topk_select_smem",
                                 [ll, i, i], ll)
    stream = build.raw_stream_getter()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def run(x, k, cluster, select_cluster):
        n = x.shape[0]
        m = -(-n // BLOCK) * k
        cand = torch.empty(2 * m, dtype=torch.int32, device=dev)
        vals = torch.empty(k, dtype=torch.float32, device=dev)
        idx = torch.empty(k, dtype=torch.int32, device=dev)
        c = cand.data_ptr()
        out = ((vals.data_ptr(), idx.data_ptr()) if select_cluster
               else (None, None))
        err = launch(0, x.data_ptr(), c, c + 4 * m, *out, n, BLOCK, k, k,
                     cluster, select_cluster, stream(0))
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return vals, idx

    for n, k in PAIRS:
        x = torch.randn(n, generator=gen, device=dev)
        nb = -(-n // BLOCK)
        m = nb * k
        for cluster in STAGE_CLUSTERS:
            if schedules(0, BLOCK, 0, cluster) != cluster:
                print(f"[clusters] n={n}: a stage cluster of {cluster} does "
                      "not schedule")
                continue
            ms = cs.device_ms(lambda: run(x, k, cluster, 0), 10)
            print(f"[clusters] n={n} k={k} ({nb} blocks): stage, clusters "
                  f"of {cluster}: {ms * 1e3:.2f} us", flush=True)
        if select_smem(m, k, 1) < 0 and select_smem(m, k, 16) < 0:
            continue
        want_v, want_i = KT.blocked_topk_abs_plain(x, k, BLOCK)
        cluster = KT.scheduled_cluster(0, BLOCK, nb)
        for sc in SELECT_CLUSTERS:
            if sc > m or select_smem(m, k, sc) < 0 \
                    or schedules(0, m, k, sc) != sc:
                continue
            vals, idx = run(x, k, cluster, sc)
            torch.cuda.synchronize()
            if not (torch.equal(vals, want_v) and torch.equal(idx, want_i)):
                raise AssertionError(f"n={n} k={k}: selection cluster {sc} "
                                     "differs from the plain version")
            ms = cs.device_ms(lambda: run(x, k, cluster, sc), 10)
            print(f"[clusters] n={n} k={k}: whole function, stage clusters "
                  f"of {cluster}, selection clusters of {sc}: "
                  f"{ms * 1e3:.2f} us", flush=True)
    print(f"[card] {cs.card_line()}")


if __name__ == "__main__":
    main()
