"""Dygraph ``DataParallel`` in the PyTorch port on the CPU: 2 gloo ranks
(one process each, ``tests/torch_dygraph_worker.py``, launched by
``paddle_tpu_torch.distributed.launch`` with a ``file://`` rendezvous
under ``tmp_path``) against one rank on the whole batch and against the
JAX package's dygraph on the whole batch, the case of
``tests/dist_worker_dygraph.py``: 5 SGD steps of ``Linear(6, 1)``.

The ranks' losses (the mean of their rows' means) are within rtol 1e-4,
atol 1e-5 of one rank's (two partial sums against one) and of the JAX
dygraph's; their parameters are bit-equal after every step; each step
sends one fused all-reduce of the grads (7 float32 values).
"""

import json

import numpy as np

import paddle_tpu as fluid
from paddle_tpu import dygraph as jdg
from paddle_tpu_torch.distributed import launch
from torch_dygraph_worker import STEPS, batches, train

N = 2


def _jax_single():
    losses = []
    with jdg.guard():
        model = jdg.Linear(6, 1)
        opt = fluid.optimizer.SGD(learning_rate=0.1)
        for p, val in zip(model.parameters(), (0.05, 0.0)):
            p.set_value(np.full(p.shape, val, dtype="float32"))
        for x, y in batches():
            diff = model(jdg.to_variable(x)) - jdg.to_variable(y)
            loss = jdg.trace_op("mean", {"X": [diff * diff]}, {})["Out"][0]
            loss.backward()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            losses.append(float(loss.numpy().reshape(-1)[0]))
    return losses


def test_two_ranks_match_one_rank_and_jax(tmp_path):
    procs = launch.spawn_gang(
        [str(__import__("pathlib").Path(__file__).with_name(
            "torch_dygraph_worker.py")), str(tmp_path)],
        nproc=N, init_method=f"file://{tmp_path / 'store'}",
        extra_env={"OMP_NUM_THREADS": "1"})
    try:
        one, one_params, _ = train(0, 1, parallel=False)
        jax_losses = _jax_single()
    finally:
        codes = launch.wait_gang(procs, timeout_s=180)
    assert codes == [0] * N, f"ranks exited {codes}"
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(N)]
    assert all(r["backend"] == "gloo" for r in ranks)
    assert ranks[0]["params"] == ranks[1]["params"]
    assert len(ranks[0]["losses"]) == STEPS
    # each rank's loss is its rows' mean: the global mean is their average
    both = np.mean([r["losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(both, one, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(both, jax_losses, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(one, jax_losses, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate(
        [np.ravel(p) for p in ranks[1]["params"][-1]]), np.concatenate(
        [np.ravel(p) for p in one_params[-1]]), rtol=1e-4, atol=1e-5)
    for r in ranks:
        for s in r["stats"]:
            assert s.get("all_reduce_fused") == [1, 7 * 4], s
