"""Dense data parallelism in the PyTorch port against the JAX package, on
the CPU: the port on 2 ranks (one process each, launched by
``paddle_tpu_torch.distributed.launch``, gloo over a ``file://``
rendezvous under ``tmp_path``; ``tests/torch_dp_worker.py`` is one rank),
the JAX package's ``CompiledProgram`` on a 2-device mesh (GSPMD's global
step), from the same initial parameters and feeds.

* ``tests/test_data_parallel.py``'s regression, 5 steps: losses and
  parameters within that test's bar (rtol 1e-4, atol 1e-5); the
  prediction, a rows fetch, all-gathered on dim 0 and equal to the JAX
  global fetch (rtol 1e-5, atol 1e-6). The same program with its loss
  summed over the batch (not divided by the 2 ranks) and with a batch
  mean fed back into rows (``pred - mean(pred)``: the cotangent of the
  mean is all-reduced before its grad), 3 steps each.
* Tiny BERT pretraining (1 layer, hidden 32, vocab 128, seq 16, P 4,
  global batch 8, flash attention, hidden dropout 0.1) where rank 1's 4
  rows hold half as many masked tokens as rank 0's, 3 steps at the full lr
  1e-3: losses within rtol 1e-4, atol 1e-5 and every persistable after
  the steps within ``tests/test_torch_bert.py``'s bars (parameters atol
  1e-6; Adam's moments, beta powers, the step counter); the first
  dropout site's mask, gathered, bit-equal to the JAX global mask every
  step (the ranks draw their blocks of the global counters under the
  unfolded run key). The MLM loss is a ratio of sums over the batch, so
  this holds only if the sums are global: per-rank ratios averaged (the
  transpiler recipe) would weigh rank 1's tokens twice rank 0's, where
  the gathered grad of the token losses weighs each 1 / 12.
* The ranks hold bit-equal parameters after every step; each step sends
  one fused all-reduce of the grads (4 bytes a parameter value), the
  loss reductions' scalars, and, on the first run only, one broadcast of
  rank 0's persistables.
* Ranks whose startups drew different parameters hold rank 0's after the
  first run; a batch that does not divide raises the JAX package's
  "must divide" error.
* K8's counter base: the plain versions at base ``b`` are the slice
  ``[b, b + n)`` of the full draw, bit-equal to ``jax.random.bits``.
* Ops the plan does not know on rows, or that move the batch off dim 0,
  raise naming M11.

The two packages sum float32 in another order (2 partial sums against
one), hence bars rather than bits for the values.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import kernels as jax_kernels
from paddle_tpu.models import bert as jax_bert
from paddle_tpu.parallel.env import make_mesh as jax_make_mesh
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu.utils.flags import flags as jax_flags
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.executor import block_plan
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.kernels import random as KR
from paddle_tpu_torch.parallel import data_parallel as dp
from paddle_tpu_torch.utils import unique_name as torch_names
from torch_dp_worker import build_regression, run_gang

N = 2
STEPS = {"mean": 5, "sum": 3, "feedback": 3}
BERT_CFG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=16, hidden_dropout_prob=0.1)
SEQ, P, BATCH, BERT_STEPS, LR = 16, 4, 8, 3, 1e-3
WARMED_UP, COUNTER = 10000.0, "@LR_DECAY_COUNTER@"
UNEQUAL_SEED = 100
# test_torch_bert.py's bars on the state after the steps
STATE_BARS = {"moment1": (1e-4, 1e-7), "moment2": (2e-4, 1e-12),
              "pow_acc": (1e-6, 0.0), COUNTER: (0.0, 0.0)}


def _mesh():
    return jax_make_mesh((N,), ("data",), devices=jax.devices()[:N])


def regression_inputs(rng):
    x = rng.rand(16, 8).astype(np.float32)
    return {"x": x, "y": x.sum(axis=1, keepdims=True).astype(np.float32),
            "init_0": (rng.randn(8, 16) * 0.3).astype(np.float32),
            "init_1": (rng.randn(16) * 0.1).astype(np.float32),
            "init_2": (rng.randn(16, 1) * 0.3).astype(np.float32),
            "init_3": np.zeros([1], np.float32)}


def jax_regression(data, loss_kind, steps, opt=None, manual=False,
                   sparse_flag=True):
    main, startup, loss, pred = build_regression(fluid, jax_names, loss_kind,
                                                 opt=opt)
    if manual:
        with fluid.program_guard(main, startup):
            fluid.layers.collective._allreduce(pred)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    old = jax_flags.dgc_sparse_exchange
    jax_flags.dgc_sparse_exchange = sparse_flag
    try:
        with fluid.scope_guard(scope):
            exe.run(startup)
            for i, p in enumerate(main.all_parameters()):
                scope.set(p.name, jnp.asarray(data[f"init_{i}"]))
            prog = fluid.CompiledProgram(main).with_parallel(
                mesh=_mesh(), loss_name=loss.name)
            outs = [exe.run(prog, feed={"x": data["x"], "y": data["y"]},
                            fetch_list=[loss, pred]) for _ in range(steps)]
    finally:
        jax_flags.dgc_sparse_exchange = old
    return {"losses": np.stack([o[0] for o in outs]),
            "preds": np.stack([o[1] for o in outs]),
            "params": [np.asarray(scope.find_var(p.name))
                       for p in main.all_parameters()]}


def _bert(mod, names):
    cfg = mod.BertConfig(**BERT_CFG)
    cfg.use_flash_attention = True
    cfg.attention_probs_dropout_prob = 0.0
    with names.guard():
        main, startup, _, fetches = mod.build_bert_pretrain(
            cfg, seq_len=SEQ, lr=LR, max_predictions_per_seq=P)
    return cfg, main, startup, fetches


def _bert_feed(cfg):
    feed = jax_bert.synthetic_batch(np.random.RandomState(7), BATCH, SEQ, cfg,
                                    P)
    # rank 1's rows keep one masked token each, rank 0's two
    labels = feed["mlm_labels"]
    labels[BATCH // N:, 1:] = -1
    return feed


def _mask_name(main):
    return [op.output("Mask")[0] for op in main.global_block().ops
            if op.type == "dropout"][0]


def _jax_bert_start():
    """The JAX program after its startup run (the step counter past the
    warmup): what the ranks start from."""
    cfg, main, startup, fetches = _bert(jax_bert, jax_names)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    scope.set(COUNTER, jnp.full([1], WARMED_UP, jnp.float32))
    names = sorted(v.name for v in main.global_block().vars.values()
                   if v.persistable and scope.find_var(v.name) is not None)
    tok = [op.output("Loss")[0] for op in main.global_block().ops
           if op.type == "softmax_with_cross_entropy"][0]
    return dict(names=names, feed=_bert_feed(cfg), mask=_mask_name(main),
                tok=tok, state={n: np.asarray(scope.find_var(n))
                                for n in names},
                run=(main, fetches, exe, scope))


def _jax_bert_steps(jb):
    main, fetches, exe, scope = jb.pop("run")
    prog = fluid.CompiledProgram(main).with_parallel(
        mesh=_mesh(), loss_name=fetches[0].name)
    with fluid.scope_guard(scope), jax_kernels.scoped_mode("interpret"):
        outs = [exe.run(prog, feed=jb["feed"],
                        fetch_list=[fetches[0], jb["mask"]])
                for _ in range(BERT_STEPS)]
    jb.update(losses=np.stack([o[0] for o in outs]),
              masks=np.stack([o[1] for o in outs]),
              after={n: np.asarray(scope.find_var(n)) for n in jb["names"]})
    return jb


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    rng = np.random.RandomState(20261018)
    cases, inputs = {}, {}
    reg = regression_inputs(rng)
    for kind, steps in STEPS.items():
        cases[f"reg_{kind}"] = {"kind": "regression", "loss": kind,
                                "steps": steps}
        inputs.update({f"reg_{kind}.{k}": v for k, v in reg.items()})
    cases["unequal"] = {"kind": "unequal", "seed": UNEQUAL_SEED}
    cases["errors"] = {"kind": "errors"}
    for name in ("unequal", "errors"):
        inputs[f"{name}.x"], inputs[f"{name}.y"] = reg["x"], reg["y"]
    # tiny BERT: the JAX startup's state goes to the ranks
    jbert = _jax_bert_start()
    cases["bert"] = {"kind": "bert", "cfg": BERT_CFG, "seq": SEQ, "P": P,
                     "lr": LR, "steps": BERT_STEPS, "mask": jbert["mask"],
                     "tok": jbert["tok"]}
    inputs["bert.names"] = np.asarray(json.dumps(jbert["names"]))
    inputs.update({f"bert.s_{i}": jbert["state"][n]
                   for i, n in enumerate(jbert["names"])})
    inputs.update({f"bert.feed_{k}": v for k, v in jbert["feed"].items()})

    def jax_side():
        out = {f"reg_{kind}": jax_regression(reg, kind, steps)
               for kind, steps in STEPS.items()}
        out["bert"] = _jax_bert_steps(jbert)
        return out

    jax_out, ranks = run_gang(cases, inputs, tmp_path_factory.mktemp("dp"),
                              jax_side)
    # the JAX step from rank 0's startup draw
    rank0 = ranks[0][0]
    jax_out["unequal"] = jax_regression(
        dict(reg, **{f"init_{i}": rank0[f"unequal.init_{i}"]
                     for i in range(4)}), "mean", 1)
    return dict(ranks=ranks, jax=jax_out, inputs=inputs, reg=reg)


def test_ranks_ran_over_gloo(gang):
    for _, meta in gang["ranks"]:
        assert meta["backend"] == "gloo" and meta["size"] == N


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_regression_matches_the_jax_mesh(gang, kind):
    want = gang["jax"][f"reg_{kind}"]
    for arrays, _ in gang["ranks"]:
        np.testing.assert_allclose(arrays[f"reg_{kind}.losses"],
                                   want["losses"], rtol=1e-4, atol=1e-5)
        for i, w in enumerate(want["params"]):
            np.testing.assert_allclose(arrays[f"reg_{kind}.param_{i}"], w,
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_rows_fetch_is_the_jax_global_fetch(gang, kind):
    want = gang["jax"][f"reg_{kind}"]["preds"]
    for arrays, _ in gang["ranks"]:
        got = arrays[f"reg_{kind}.preds"]
        assert got.shape == want.shape == (STEPS[kind], 16, 1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_a_loss_summed_over_the_batch_is_not_divided_by_n(gang):
    want = gang["jax"]["reg_sum"]["losses"][0, 0]
    got = gang["ranks"][0][0]["reg_sum.losses"][0, 0]
    reg = gang["reg"]
    init = [reg[f"init_{i}"] for i in range(4)]
    h = np.maximum(reg["x"] @ init[0] + init[1], 0)
    whole = float((((h @ init[2] + init[3]) - reg["y"]) ** 2).sum())
    np.testing.assert_allclose([got, want], [whole, whole], rtol=1e-5)
    assert abs(got - whole / N) > 0.4 * whole


@pytest.mark.parametrize("case", ["reg_mean", "reg_sum", "reg_feedback",
                                  "bert"])
def test_ranks_hold_bit_equal_parameters(gang, case):
    (a, ma), (b, mb) = gang["ranks"]
    if "digests" in ma[case]:
        assert ma[case]["digests"] == mb[case]["digests"]
    for k in a:
        if k.startswith(case + ".") and ("param_" in k or ".s_" in k
                                         or k.endswith("losses")):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_one_fused_grad_all_reduce_a_step(gang):
    n_values = sum(gang["reg"][f"init_{i}"].size for i in range(4))
    for _, meta in gang["ranks"]:
        steps = meta["reg_mean"]["collectives"]
        for i, stats in enumerate(steps):
            assert stats["all_reduce_fused"] == [1, 4 * n_values], stats
            # the mean's sum, in the forward only: its grad's rerun keeps
            # the local sum
            assert stats["all_reduce"] == [1, 4], stats
            # the prediction, a rows fetch: 8 rows of 1 float
            assert stats["all_gather"] == [1, 32], stats
        assert "broadcast" not in steps[1]
    rank0 = gang["ranks"][0][1]["reg_mean"]["collectives"][0]
    # rank 0 sends its persistables once: the parameters and the lr
    assert rank0["broadcast"] == [1, 4 * (n_values + 1)]


def test_a_mean_fed_back_into_rows_all_reduces_its_cotangent(gang):
    for _, meta in gang["ranks"]:
        for stats in meta["reg_feedback"]["collectives"]:
            # 3 means in the forward (their grads' reruns keep the local
            # sums), and the cotangent of mean(pred), which flows back into
            # the rows of pred (1)
            assert stats["all_reduce"] == [4, 16], stats
            assert stats["all_reduce_fused"][0] == 1


def test_bert_losses_match_the_jax_mesh(gang):
    want = gang["jax"]["bert"]["losses"]
    for arrays, _ in gang["ranks"]:
        np.testing.assert_allclose(arrays["bert.losses"], want, rtol=1e-4,
                                   atol=1e-5)


def test_bert_dropout_masks_are_the_jax_global_mask(gang):
    want = gang["jax"]["bert"]["masks"]
    assert want.shape[1] == BATCH and 0 < want.mean() < 1
    for arrays, _ in gang["ranks"]:
        np.testing.assert_array_equal(arrays["bert.masks"], want)
    # the two ranks' halves differ: each draws its own block of counters
    assert not np.array_equal(want[0, :BATCH // N], want[0, BATCH // N:])


def test_bert_state_after_the_steps_matches_the_jax_mesh(gang):
    jb = gang["jax"]["bert"]
    for arrays, _ in gang["ranks"]:
        for i, n in enumerate(jb["names"]):
            rtol, atol = next((b for key, b in STATE_BARS.items()
                               if key in n), (0.0, 1e-6))
            np.testing.assert_allclose(arrays[f"bert.s_{i}"], jb["after"][n],
                                       rtol=rtol, atol=atol, err_msg=n)


def test_bert_ratio_loss_is_the_global_step_not_the_per_rank_average(gang):
    """The MLM loss is sum(token losses) / max(sum(masked), 1). In the
    global step every token's loss weighs 1 / (all masked tokens); the
    transpiler recipe (each rank's ratio, grads averaged) would weigh
    rank r's tokens 1 / (n * rank r's count): here 1/16 on rank 0's rows
    and 1/8 on rank 1's, where the global step gives 1/12 to both."""
    feed = gang["jax"]["bert"]["feed"]
    counts = (feed["mlm_labels"] != -1).reshape(N, -1).sum(axis=1)
    assert counts[0] == 2 * counts[1] > 0
    global_weight = 1.0 / counts.sum()
    per_rank = [1.0 / (N * c) for c in counts]
    for arrays, _ in gang["ranks"]:
        weights = arrays["bert.tok_grad"][0].reshape(N, -1)
        for r in range(N):
            np.testing.assert_allclose(
                weights[r], global_weight, rtol=1e-6,
                err_msg=f"rank {r}'s tokens: the global step weighs them "
                        f"{global_weight}, the per-rank average would "
                        f"{per_rank[r]}")
            assert abs(per_rank[r] - global_weight) > 0.2 * global_weight


def test_ranks_started_apart_hold_rank_0s_parameters(gang):
    (a, _), (b, _) = gang["ranks"]
    assert not np.array_equal(a["unequal.init_0"], b["unequal.init_0"])
    want = gang["jax"]["unequal"]
    for i, w in enumerate(want["params"]):
        np.testing.assert_array_equal(a[f"unequal.param_{i}"],
                                      b[f"unequal.param_{i}"])
        np.testing.assert_allclose(a[f"unequal.param_{i}"], w, rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(a["unequal.loss"], want["losses"][0],
                               rtol=1e-4, atol=1e-5)


def test_a_batch_that_does_not_divide_raises(gang):
    for _, meta in gang["ranks"]:
        assert "must divide its sharding ('data',) (total 2)" in \
            meta["errors"]["indivisible"]


@pytest.mark.parametrize("base", [0, 1, 4099, 2**32 - 3])
def test_k8_counter_base_is_a_slice_of_the_global_draw(base):
    key = prng.fold_in(prng.prng_key(20261018), 3)
    n = 1031
    full = np.asarray(jax.random.bits(jnp.asarray(key, jnp.uint32),
                                      (base + n,), jnp.uint32)) \
        if base < 10**6 else None
    got = KR.random_bits_plain(key, n, "cpu", base).numpy().view(np.uint32)
    host = prng.random_bits(key, (n,), base)
    np.testing.assert_array_equal(got, host)
    if full is not None:
        np.testing.assert_array_equal(got, full[base:])
    # the dropout forward at a base: the global mask's rows
    x = torch.from_numpy(np.random.RandomState(1).randn(2 * n)
                         .astype(np.float32))
    whole = KR.dropout_fwd_plain(x, key, 0.1, True, 0)
    half = KR.dropout_fwd_plain(x[n:], key, 0.1, True, n)
    assert torch.equal(half[1], whole[1][n:])
    assert torch.equal(half[0], whole[0][n:])


def _plan(build):
    main, startup = pt.Program(), pt.Program()
    with torch_names.guard(), pt.program_guard(main, startup):
        x = pt.data("x", shape=[-1, 4, 6])
        build(x)
    block = main.global_block()
    return dp.plan_dense(block_plan(block), block, {"x": dp.ROWS}, [], 0)


@pytest.mark.parametrize("what,build", [
    ("transpose2", lambda x: pt.layers.transpose(x, [1, 0, 2])),
    ("reshape2", lambda x: pt.layers.reshape(x, [8, 24])),
    ("slice", lambda x: pt.layers.slice(x, axes=[0], starts=[0], ends=[1])),
    ("softmax", lambda x: pt.layers.softmax(
        pt.layers.reshape(x, [0, -1]), axis=0)),
])
def test_ops_that_move_the_batch_raise_naming_m11(what, build):
    with pytest.raises(NotImplementedError, match=f"'{what}'.*M11"):
        _plan(build)


def test_batch_statistics_raise_naming_m11_before_any_collective():
    main = pt.Program()
    main.global_block().append_op("batch_norm", {}, {}, {"is_test": False})
    with pytest.raises(NotImplementedError, match="batch_norm.*M11"):
        dp.check_program(main.global_block())


def test_what_keeps_the_batch_on_dim_0_plans():
    plan = _plan(lambda x: pt.layers.mean(pt.layers.transpose(
        pt.layers.reshape(x, [0, -1, 2]), [0, 2, 1])))
    marked = [s.op.type for s in plan.steps if s.attrs.get("_dp_batch")]
    assert marked == ["mean"]
