"""One rank of ``tests/test_torch_dygraph_parallel.py``: the PyTorch
port's dygraph ``DataParallel`` on the CPU over gloo, the counterpart of
``tests/dist_worker_dygraph.py``. Started by the port's launcher
(``paddle_tpu_torch.distributed.launch.spawn_gang``), one process per
rank:

    python tests/torch_dygraph_worker.py OUT_DIR

Each rank trains ``Linear(6, 1)`` (constant initial weights) with SGD 0.1
on its rows of each global batch of 16, its loss scaled by
``scale_loss`` and its grads summed by ``apply_collective_grads``, and
writes its rows' losses, its parameters after every step and the
collectives it sent to ``OUT_DIR/rank<r>.json``.
"""

import json
import os
import sys

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.dygraph import Linear, to_variable
from paddle_tpu_torch.parallel import env as penv

STEPS, BATCH = 5, 16


def batches(steps=STEPS, batch=BATCH):
    """``tests/dist_worker_dygraph.py``'s batches."""
    rng = np.random.RandomState(7)
    w = rng.randn(6, 1).astype("float32")
    out = []
    for _ in range(steps):
        x = rng.randn(batch, 6).astype("float32")
        out.append((x, (x @ w).astype("float32")))
    return out


def train(rank, world, parallel):
    """Losses (this rank's rows' means) and the parameters after every
    step."""
    losses, params, stats = [], [], []
    with dygraph.guard(place=pt.CPUPlace()):
        model = Linear(6, 1)
        if parallel:
            model = dygraph.DataParallel(model)
        opt = pt.optimizer.SGD(learning_rate=0.1)
        for p, val in zip(model.parameters(), (0.05, 0.0)):
            p.set_value(np.full(p.shape, val, dtype="float32"))
        for x, y in batches():
            if parallel:
                rows = slice(rank * BATCH // world, (rank + 1) * BATCH // world)
                x, y = x[rows], y[rows]
            diff = model(to_variable(x)) - to_variable(y)
            loss = dygraph.trace_op("mean", {"X": [diff * diff]}, {})["Out"][0]
            if parallel:
                loss = model.scale_loss(loss)
            penv.reset_collective_stats()
            loss.backward()
            if parallel:
                model.apply_collective_grads()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            stats.append(penv.collective_stats())
            losses.append(float(loss.numpy().reshape(-1)[0]) * (world if parallel else 1))
            params.append([p.numpy().tolist() for p in model.parameters()])
    return losses, params, stats


def main(out_dir):
    torch.set_num_threads(1)
    env = penv.ParallelEnv()
    losses, params, stats = train(env.rank, env.nranks, parallel=True)
    with open(os.path.join(out_dir, f"rank{env.rank}.json"), "w") as f:
        json.dump({"losses": losses, "params": params, "stats": stats,
                   "backend": penv.make_mesh().backend}, f)


if __name__ == "__main__":
    main(sys.argv[1])
