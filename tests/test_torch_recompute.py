"""Remat in the PyTorch port (``RecomputeOptimizer``, ``ops/recompute.py``,
the executor's liveness for segment interiors) against the JAX package,
on the CPU at small sizes:

* ``tests/test_recompute.py``'s cases run through both packages: the
  3-layer MLP (with and without dropout) under no recompute and under the
  four policies. The port's losses are bit-equal across all five runs
  (float hex), which is the JAX test's own promise, and within rtol 1e-5,
  atol 1e-6 of the JAX package's (its own test's bar);
* the segmented programs equal the JAX ones: op types, names and attrs,
  the serialized segments, ``__in_names__``/``__out_names__``,
  ``__diff_*__``, ``__remat_policy__`` and the saved-name lists;
* liveness: at a segment's grad op the interior values are gone from the
  executor's env under ``full``, and the policy's names are there under
  ``dots`` and ``save_all``; fetched values stay;
* (tiny BERT with LAMB, a clip and recompute against the JAX package:
  ``tests/test_torch_recompute_bert.py``);
* ``DistributedStrategy.recompute`` on 2 gloo ranks
  (``tests/torch_dp_worker.py``): the ranks bit-equal, the run bit-equal
  to the same 2-rank run without recompute, and within the dense
  data-parallel bars (rtol 1e-4) of one rank on the whole batch. Two
  ranks sum each grad as two partial sums and an all-reduce, one rank in
  one sum, so they are not the same bits.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core.registry import OpRegistry
from paddle_tpu_torch.models import bert as torch_bert
from paddle_tpu_torch.utils import unique_name as torch_names
from paddle_tpu_torch.utils.enforce import EnforceError

from torch_dp_worker import run_gang

POLICIES = ("full", "dots", "dots_no_batch", "save_all")
COUNTER = "@LR_DECAY_COUNTER@"

# op type -> what exercises it here (test_torch_ops.py unions the keys)
CASES = {
    "recompute_segment": "test_forward_segment_op_replays_the_forward",
    "recompute_segment_grad": "test_policies_are_bit_equal_to_no_recompute",
}


def _mlp(mod, depth=3, with_dropout=False):
    """``tests/test_recompute.py``'s ``_mlp`` over either package."""
    x = mod.data("x", shape=[-1, 8])
    y = mod.data("y", shape=[-1, 1])
    h = x
    checkpoints = []
    for i in range(depth):
        h = mod.layers.fc(
            h, size=16, act="relu",
            param_attr=mod.ParamAttr(
                initializer=mod.initializer.Constant(0.03 + 0.01 * i)),
        )
        if with_dropout:
            h = mod.layers.dropout(h, dropout_prob=0.3)
        checkpoints.append(h)
    pred = mod.layers.fc(
        h, size=1,
        param_attr=mod.ParamAttr(initializer=mod.initializer.Constant(0.1)),
    )
    loss = mod.layers.mean(mod.layers.square_error_cost(pred, y))
    return loss, checkpoints


def _build_mlp(mod, names, recompute, with_dropout=False, policy=None,
               seed=7):
    main, startup = mod.Program(), mod.Program()
    main.random_seed = startup.random_seed = seed
    with names.guard(), mod.program_guard(main, startup):
        loss, ckpts = _mlp(mod, with_dropout=with_dropout)
        opt = mod.optimizer.SGD(learning_rate=0.1)
        if recompute:
            opt = mod.optimizer.RecomputeOptimizer(opt, policy=policy)
            opt._set_checkpoints(ckpts)
        opt.minimize(loss)
    return main, startup, loss


def _data():
    rng = np.random.RandomState(1234)
    x = rng.rand(16, 8).astype("float32")
    return x, x.sum(axis=1, keepdims=True).astype("float32")


def _train_torch(recompute, steps, with_dropout=False, policy=None):
    x, y = _data()
    main, startup, loss = _build_mlp(pt, torch_names, recompute,
                                     with_dropout, policy)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    return [float(exe.run(main, feed={"x": x, "y": y}, fetch_list=[loss],
                          scope=scope)[0].reshape(-1)[0])
            for _ in range(steps)]


def _train_jax(recompute, steps, with_dropout=False, policy=None):
    x, y = _data()
    main, startup, loss = _build_mlp(fluid, jax_names, recompute,
                                     with_dropout, policy)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        return [float(np.asarray(exe.run(main, feed={"x": x, "y": y},
                                         fetch_list=[loss])[0]).reshape(-1)[0])
                for _ in range(steps)]


@pytest.mark.parametrize("with_dropout", [False, True],
                         ids=["plain", "dropout"])
def test_policies_are_bit_equal_to_no_recompute(with_dropout):
    runs = {"plain": _train_torch(False, 4, with_dropout)}
    for policy in POLICIES:
        runs[policy] = _train_torch(True, 4, with_dropout, policy)
    hexes = {k: [v.hex() for v in vals] for k, vals in runs.items()}
    assert all(h == hexes["plain"] for h in hexes.values()), hexes
    # the losses move, and the JAX package's recompute runs agree
    assert runs["plain"][-1] < runs["plain"][0]
    want = _train_jax(True, 4, with_dropout)
    np.testing.assert_allclose(runs["full"], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("policy", [None] + list(POLICIES))
@pytest.mark.parametrize("with_dropout", [False, True],
                         ids=["plain", "dropout"])
def test_segmented_program_equals_the_jax_one(policy, with_dropout):
    want = _build_mlp(fluid, jax_names, True, with_dropout, policy)[0]
    got = _build_mlp(pt, torch_names, True, with_dropout, policy)[0]
    gops = [op.desc() for op in got.global_block().ops]
    assert gops == [op.desc() for op in want.global_block().ops]
    segs = [op for op in got.global_block().ops
            if op.type == "recompute_segment_grad"]
    assert len(segs) == 4
    for op in segs:
        assert op.attrs["__remat_policy__"] == (policy or "full")
        saved = op.attrs["__segment_saved_names__"]
        assert saved["full"] == []
        assert set(saved["dots"]) <= set(saved["save_all"])
    # the per-op grads of the segmented region are gone
    assert "mul_grad" not in [op.type for op in got.global_block().ops]


def test_unknown_policy_raises():
    with pytest.raises(EnforceError, match="remat policy"):
        pt.optimizer.RecomputeOptimizer(pt.optimizer.SGD(learning_rate=0.1),
                                        policy="sometimes")
    opt = pt.optimizer.RecomputeOptimizer(pt.optimizer.SGD(0.1))
    with pytest.raises(EnforceError, match="remat policy"):
        opt._set_checkpoints(["x"], policy="sometimes")


class _EnvTap:
    """What the executor's env holds when each segment grad op runs (the
    env of the ``_run_steps`` call that runs it), and the ``__saved__``
    it hands over."""

    def __init__(self, monkeypatch):
        self.seen = []
        op_def = OpRegistry.get("recompute_segment_grad")
        inner = op_def.lower

        def lower(ins, attrs):
            import sys

            frame = sys._getframe(1)
            while frame.f_code.co_name != "_run_steps":
                frame = frame.f_back
            self.seen.append((attrs, set(frame.f_locals["env"]),
                              set(ins.get("__saved__", [{}])[0])))
            return inner(ins, attrs)

        monkeypatch.setattr(op_def, "lower", lower)


@pytest.mark.parametrize("policy", POLICIES)
def test_interiors_leave_the_env_but_what_the_policy_keeps(policy,
                                                           monkeypatch):
    tap = _EnvTap(monkeypatch)
    x, y = _data()
    main, startup, loss = _build_mlp(pt, torch_names, True, True, policy)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    fetched = next(op.output("Out")[0] for op in main.global_block().ops
                   if op.type == "elementwise_add")
    exe.run(main, feed={"x": x, "y": y}, fetch_list=[loss, fetched],
            scope=scope)
    assert len(tap.seen) == 4
    n_interior = 0
    for attrs, env, saved in tap.seen:
        interior = set(attrs["__segment_saved_names__"]["save_all"])
        kept = set(attrs["__segment_saved_names__"][policy])
        n_interior += len(interior)
        assert saved == kept
        # the kept names are there, every other interior is gone, but a
        # fetched one
        assert kept <= env
        assert (interior - kept) & env <= {fetched}
        assert {n for n in attrs["__out_names__"]} <= env
    assert n_interior > 8
    if policy == "full":
        assert all(not saved for _, _, saved in tap.seen)
    # the fetch came back although it is an interior value
    assert fetched in {n for a, _, _ in tap.seen
                       for n in a["__segment_saved_names__"]["save_all"]}


def test_a_program_without_segments_keeps_every_value():
    main, _, _ = _build_mlp(pt, torch_names, False)
    block = main.global_block()
    steps = texecutor.block_plan(block)
    assert texecutor.segment_liveness(block, steps, []) == {}


def test_forward_segment_op_replays_the_forward():
    """``recompute_segment`` (the forward pseudo-op, never appended by
    ``append_backward``) replays a segment's ops from its inputs and the
    run key: the forward's values, dropout masks included, bit for
    bit."""
    from paddle_tpu_torch.core import prng

    x, y = _data()
    main, startup, loss = _build_mlp(pt, torch_names, True, True)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    # the first segment (its grad op comes last): a feed and parameters in
    seg = [op for op in main.global_block().ops
           if op.type == "recompute_segment_grad"][-1]
    feed = {"x": x, "y": y}
    # the segment's inputs as the run's forward reads them (before the
    # run's update)
    ins = {"X": [torch.from_numpy(feed[n]) if n in feed
                 else scope.find_var(n).clone()
                 for n in seg.attrs["__in_names__"]]}
    outs = exe.run(main, feed=feed, fetch_list=seg.attrs["__out_names__"],
                   scope=scope)
    # the run key of the executor's second run (the startup was its first)
    ins["__base_rng__"] = [prng.fold_in(prng.prng_key(main.random_seed), 2)]
    ins["__device__"] = [torch.device("cpu")]
    got = OpRegistry.get("recompute_segment").lower(ins, seg.attrs)["Out"]
    assert len(got) == len(outs) >= 1
    for g, o in zip(got, outs):
        np.testing.assert_array_equal(g.numpy(), o)


# -- DistributedStrategy.recompute on 2 gloo ranks ------------------------------

SEQ, BATCH, P, STEPS = 32, 4, 5, 3


def test_distributed_strategy_recompute_on_2_ranks(tmp_path):
    from torch_dp_worker import build_bert_lamb

    main, startup, fetches = build_bert_lamb(SEQ, P, recompute=True)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    load_params(scope, {COUNTER: np.full([1], 20.0, np.float32)})
    state = persistables_to_numpy(scope, main)
    cfg = torch_bert.BertConfig.tiny()
    batch = torch_bert.synthetic_batch(np.random.RandomState(9), BATCH, SEQ,
                                       cfg, P)
    names = sorted(state)
    inputs, cases = {}, {}
    for tag, recompute in (("rc", True), ("plain", False)):
        cases[tag] = {"kind": "fleet_bert", "recompute": recompute,
                      "steps": STEPS, "seq": SEQ, "P": P}
        inputs[f"{tag}.names"] = np.array(json.dumps(names))
        inputs.update({f"{tag}.s_{i}": state[n] for i, n in enumerate(names)})
        inputs.update({f"{tag}.feed_{k}": v for k, v in batch.items()})

    _, ranks = run_gang(cases, inputs, tmp_path, lambda: None)
    (a, ma), (b, mb) = ranks
    assert ma["rc"]["segments"] == 3 and ma["plain"]["segments"] == 0
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if k.startswith("rc."):
            np.testing.assert_array_equal(a[k], a["plain." + k[3:]],
                                          err_msg=k)
    # one rank on the whole batch, under recompute
    single = [exe.run(main, feed=batch, fetch_list=[fetches[0]],
                      scope=scope)[0] for _ in range(STEPS)]
    np.testing.assert_allclose(a["rc.losses"].reshape(-1),
                               np.concatenate(single).reshape(-1),
                               rtol=1e-4, atol=1e-5)
