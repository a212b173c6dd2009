"""A tiny Transformer trained data-parallel with DGC momentum: the PyTorch
port on 2 ranks (one process each, launched by
``paddle_tpu_torch.distributed.launch``, gloo over a ``file://``
rendezvous under ``tmp_path``; ``tests/torch_dgc_worker.py`` is one rank)
against the JAX package's ``CompiledProgram`` on a 2-device mesh, on the
CPU.

The model: vocab 8192 (so ``word_emb``, 262,144 values, exceeds one
131,072-element block of the top-k), d 32, 4 heads, FFN 64, 1+1 layers,
seq 8, global batch 8 (4 sentences per rank), dropout 0.1. The optimizer:
``DGCMomentumOptimizer(0.01, 0.9, rampup_begin_step=1, rampup_step=2,
sparsity=[0.996, 0.999])`` under ``FLAGS_pallas_dgc_topk`` (the port's
blocked top-k through its plain stage on the CPU; the JAX package's falls
back to ``lax.top_k`` inside ``shard_map`` off the TPU): step 0 is the
dense warm-up (``pmean``), step 1 sparse at 0.996, steps 2-3 at 0.999,
where the keep mask cuts ``k_dyn`` below ``k_max``. Both start from one
state: the JAX program's persistables made from a numpy seed; the port
loads them by name and U/V become each rank's ``[1, ...]`` slice. Both
run their startup program first, so the executors' run counters agree:
each rank's dropout masks of the first step equal ``jax.random``'s under
the JAX package's key for that shard (``fold_in(fold_in(fold_in(
PRNGKey(0), run), rank), __rng_id__)``, the JAX ``CompiledProgram``
folding ``axis_index``), and the two ranks' masks differ.

Over 4 steps: the loss streams agree within rtol 1e-5, atol 1e-6, and
every parameter and each rank's U/V (put back together by
``convert.gather_rank_state``) within rtol 1e-5, atol 1e-6 of the JAX
package's. The two packages sum float32 in another order (and XLA fuses
multiply-adds), about 1e-7 relative, so a top-k choice could flip where
two |v| tie to within rounding. A flipped element moves by its whole
update (lr times |v|, about 1e-4 here, with |v| near the k-th largest)
and U/V at it by |v| itself, both far past the bar, so the bar shows a
flip rather than hides it; none occurs on these inputs. The ranks hold
bit-identical parameters and losses.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import transformer as jax_tfm
from paddle_tpu.parallel.env import make_mesh as jax_make_mesh
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu.utils.flags import flags as jax_flags
from paddle_tpu_torch import convert
from torch_dgc_worker import run_gang

N = 2
CFG = dict(vocab_size=8192, d_model=32, n_heads=4, d_ffn=64,
           n_enc_layers=1, n_dec_layers=1, max_len=16, dropout=0.1)
DGC = dict(learning_rate=0.01, momentum=0.9, rampup_begin_step=1,
           rampup_step=2, sparsity=[0.996, 0.999])
SEQ, BATCH, STEPS = 8, 8, 4


def _state(main, rng):
    """Every persistable of the program from a numpy seed: parameters
    N(0, 0.05) (layer-norm scales 1 + that), the rest as the startup
    program makes them (U/V and the step counter zero, the lr 0.01)."""
    state = {}
    for v in main.global_block().vars.values():
        if not v.persistable or v.name in ("src_ids", "tgt_ids", "labels"):
            continue
        shape = [int(d) for d in v.shape]
        if "learning_rate" in v.name:
            state[v.name] = np.full(shape, DGC["learning_rate"], np.float32)
        elif "dgc_" in v.name:
            state[v.name] = np.zeros(shape, np.float32)
        else:
            a = rng.normal(0.0, 0.05, shape).astype(np.float32)
            state[v.name] = a + 1 if v.name.endswith(".scale") else a
    return state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with jax_names.guard():
        main, startup, _, fetches = jax_tfm.build_wmt_train(
            jax_tfm.TransformerConfig(**CFG), src_len=SEQ, tgt_len=SEQ,
            optimizer=fluid.optimizer.DGCMomentumOptimizer(**DGC))
    state = _state(main, np.random.RandomState(7))
    names = sorted(state)
    batch = jax_tfm.synthetic_batch(np.random.RandomState(11), BATCH, SEQ,
                                    SEQ, jax_tfm.TransformerConfig(**CFG))
    cases = {"tfm": {"kind": "transformer", "cfg": CFG, "dgc": DGC,
                     "seq": SEQ, "steps": STEPS}}
    inputs = {"tfm.names": np.asarray(json.dumps(names))}
    inputs.update({f"tfm.s_{i}": state[n] for i, n in enumerate(names)})
    inputs.update({f"tfm.{k}": v for k, v in batch.items()})

    def jax_side():
        mesh = jax_make_mesh((N,), ("data",), devices=jax.devices()[:N])
        prog = fluid.CompiledProgram(main).with_parallel(
            mesh=mesh, loss_name=fetches[0].name)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        old = jax_flags.pallas_dgc_topk
        jax_flags.pallas_dgc_topk = True
        try:
            with fluid.scope_guard(scope):
                exe.run(startup)     # the run counter, as the ranks' runs
                for name, a in state.items():    # every persistable
                    scope.set(name, jnp.asarray(a))
                losses = [float(np.asarray(exe.run(
                    prog, feed=batch, fetch_list=[fetches[0].name])[0]
                ).reshape(-1)[0]) for _ in range(STEPS)]
        finally:
            jax_flags.pallas_dgc_topk = old
        return losses, {n: np.asarray(scope.find_var(n)) for n in state}

    (jax_losses, jax_state), ranks = run_gang(
        cases, inputs, tmp_path_factory.mktemp("tfm"), jax_side)
    uv = sorted({n for op in main.global_block().ops
                 if op.type == "dgc_momentum" for s in ("U", "V")
                 for n in op.input(s)})
    per_rank = [{n: arrays[f"tfm.s_{i}"] for i, n in enumerate(names)}
                for arrays, _ in ranks]
    return dict(ranks=ranks, per_rank=per_rank, uv=uv, names=names,
                jax_losses=jax_losses, jax_state=jax_state)


def test_loss_streams_match_and_fall(runs):
    (a, _), (b, _) = runs["ranks"]
    np.testing.assert_array_equal(a["tfm.losses"], b["tfm.losses"])
    np.testing.assert_allclose(a["tfm.losses"], runs["jax_losses"],
                               rtol=1e-5, atol=1e-6)
    assert a["tfm.losses"][-1] < a["tfm.losses"][0]


def test_ranks_hold_bit_identical_parameters(runs):
    r0, r1 = runs["per_rank"]
    for n in runs["names"]:
        if n not in runs["uv"]:
            np.testing.assert_array_equal(r0[n], r1[n], n)


def test_state_matches_jax(runs):
    got = convert.gather_rank_state(runs["per_rank"], runs["uv"])
    for n in runs["names"]:
        assert got[n].shape == runs["jax_state"][n].shape, n
        np.testing.assert_allclose(got[n], runs["jax_state"][n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_per_rank_state_and_sparse_exchange(runs):
    got = convert.gather_rank_state(runs["per_rank"], runs["uv"])
    v = got[[n for n in runs["uv"] if n.startswith("word_emb_dgc_v")][0]]
    # each rank's own residual; word_emb was exchanged sparsely, so most
    # of V survives on every rank
    assert v.shape == (N, 8192, 32)
    assert not np.array_equal(v[0], v[1])
    assert (v != 0).mean() > 0.9


def test_each_ranks_masks_are_jax_masks_for_its_shard(runs):
    """The first compiled run is the executors' second (after startup)."""
    ranks = [arrays for arrays, _ in runs["ranks"]]
    ids = ranks[0]["tfm.mask_ids"]
    assert len(ids) == 10
    np.testing.assert_array_equal(ranks[1]["tfm.mask_ids"], ids)
    for r, arrays in enumerate(ranks):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 2),
                                 r)
        for j, rng_id in enumerate(ids):
            got = arrays[f"tfm.mask_{j}"]
            want = jax.random.bernoulli(jax.random.fold_in(key, int(rng_id)),
                                        0.9, got.shape)
            np.testing.assert_array_equal(got, np.asarray(want, np.float32),
                                          err_msg=f"rank {r}, op {rng_id}")
    assert not np.array_equal(ranks[0]["tfm.mask_0"], ranks[1]["tfm.mask_0"])
