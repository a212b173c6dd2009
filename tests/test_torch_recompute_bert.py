"""Tiny BERT pretraining (flash attention, hidden dropout 0.1) with LAMB
(weight decay 0.01 but for LayerNorm and bias), the learning rate
``linear_lr_warmup(polynomial_decay(...))``, ``GradientClipByGlobalNorm
(1.0)`` and ``RecomputeOptimizer`` at each encoder layer's output, in the
PyTorch port against the JAX package on the CPU:

* the programs equal the JAX ones (no recompute, ``full``, ``dots``), and
  the checkpoints are the ``layer_{i}.ln2`` outputs;
* from the JAX startup's state, the step counter past the warm-up, 3
  steps under ``full``: losses within ``tests/test_torch_bert.py``'s bars
  (rtol 1e-4, atol 1e-5) of the JAX package's (its Pallas flash kernels
  in interpret mode), parameters within atol 1e-6, LAMB's moments and
  beta powers within rtol 2e-4, atol 1e-7, the counter exact;
* in the port, the losses and the whole state after the steps are
  bit-equal across no recompute and the four policies.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import kernels as jax_kernels
from paddle_tpu.models import bert as jax_bert
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.convert import load_params, persistables_to_numpy
from paddle_tpu_torch.models import bert as torch_bert
from paddle_tpu_torch.utils import unique_name as torch_names

POLICIES = ("full", "dots", "dots_no_batch", "save_all")
COUNTER = "@LR_DECAY_COUNTER@"

SEQ, BATCH, P, STEPS = 32, 4, 5, 3


def _bert_cfg(mod):
    cfg = mod.BertConfig.tiny()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = 0.1
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _pretrain_net(mod, bmod, cfg):
    """The JAX ``build_bert_pretrain``'s network (the port's
    ``bert_pretrain_net``) over either package: (feeds, [loss, mlm_loss,
    nsp_loss])."""
    L = mod.layers
    ids = mod.data("input_ids", shape=[-1, SEQ], dtype="int64")
    types = mod.data("token_type_ids", shape=[-1, SEQ], dtype="int64")
    mask = mod.data("input_mask", shape=[-1, SEQ], dtype="int64")
    positions = mod.data("masked_positions", shape=[-1, P], dtype="int64")
    labels = mod.data("mlm_labels", shape=[-1, P], dtype="int64")
    nsp_labels = mod.data("nsp_labels", shape=[-1, 1], dtype="int64")
    seq_out, pooled = bmod.bert_encoder(ids, types, mask, cfg, SEQ)
    mlm_t = bmod._dense(L.batched_gather(seq_out, positions), cfg.hidden_size,
                        cfg, act="gelu", name="mlm_transform")
    mlm_t = L.layer_norm(mlm_t, begin_norm_axis=2, name="mlm_ln")
    logits = bmod._dense(mlm_t, cfg.vocab_size, cfg, name="mlm_out")
    tok = L.softmax_with_cross_entropy(logits, L.reshape(labels, [0, P, 1]),
                                       ignore_index=-1, axis=-1)
    is_masked = L.cast(L.tensor.not_equal(
        labels, L.tensor.fill_constant([1], "int64", -1)), "float32")
    denom = L.elementwise_max(L.reduce_sum(is_masked),
                              L.tensor.fill_constant([1], "float32", 1.0))
    mlm_loss = L.elementwise_div(L.reduce_sum(tok), denom)
    nsp_logits = bmod._dense(pooled, 2, cfg, name="nsp_out",
                             num_flatten_dims=1)
    nsp_loss = L.mean(L.softmax_with_cross_entropy(nsp_logits, nsp_labels))
    loss = L.elementwise_add(mlm_loss, nsp_loss)
    return [ids, types, mask, positions, labels, nsp_labels], \
        [loss, mlm_loss, nsp_loss]


def _exclude(p):
    """LayerNorm and bias parameters: no LAMB weight decay."""
    return "ln" in p.name or p.name.endswith((".b", ".b_0"))


def _bert_lamb(mod, names, policy, lr=1e-3):
    """Tiny BERT pretraining with LAMB (weight decay 0.01 but for LayerNorm
    and bias), lr ``linear_lr_warmup(polynomial_decay(...))`` and
    ``GradientClipByGlobalNorm(1.0)``, under ``RecomputeOptimizer`` at the
    encoder layers' outputs (``policy`` None: no recompute)."""
    cfg = _bert_cfg(mod_bert(mod))
    main, startup = mod.Program(), mod.Program()
    main.random_seed = startup.random_seed = 5
    sched_mod = mod.layers.learning_rate_scheduler
    with names.guard(), mod.program_guard(main, startup):
        feeds, fetches = _pretrain_net(mod, mod_bert(mod), cfg)
        lr_var = sched_mod.linear_lr_warmup(
            sched_mod.polynomial_decay(lr, 1000, 0.0, 1.0), 10, 0.0, lr)
        opt = mod.optimizer.Lamb(
            learning_rate=lr_var, lamb_weight_decay=0.01,
            exclude_from_weight_decay_fn=_exclude,
            grad_clip=mod.clip.GradientClipByGlobalNorm(1.0))
        if policy:
            opt = mod.optimizer.RecomputeOptimizer(opt, policy=policy)
            opt._set_checkpoints(torch_bert.encoder_checkpoints(main))
        opt.minimize(fetches[0])
    return cfg, main, startup, fetches


def mod_bert(mod):
    return torch_bert if mod is pt else jax_bert


def test_bert_checkpoints_are_the_encoder_layer_outputs():
    _, main, _, _ = _bert_lamb(pt, torch_names, None)
    # the port's own network builder emits the same program
    cfg = _bert_cfg(torch_bert)
    own = pt.Program()
    with torch_names.guard(), pt.program_guard(own, pt.Program()):
        torch_bert.bert_pretrain_net(cfg, SEQ, P)
    n = len(own.global_block().ops)

    def descs(ops):     # the loss op's role is set by append_backward
        return [dict(d, attrs={k: v for k, v in d["attrs"].items()
                               if k != "op_role"})
                for d in (op.desc() for op in ops)]

    assert descs(own.global_block().ops) == \
        descs(main.global_block().ops[:n])
    ckpts = torch_bert.encoder_checkpoints(main)
    assert len(ckpts) == _bert_cfg(torch_bert).num_hidden_layers == 2
    producers = {op.output("Y")[0]: op for op in main.global_block().ops
                 if op.type == "layer_norm"}
    assert all(producers[c].input("Scale")[0].startswith(f"layer_{i}.ln2")
               for i, c in enumerate(ckpts))


@pytest.mark.parametrize("policy", [None, "full", "dots"])
def test_bert_lamb_recompute_program_equals_the_jax_one(policy):
    want = _bert_lamb(fluid, jax_names, policy)[1].global_block()
    got = _bert_lamb(pt, torch_names, policy)[1].global_block()
    assert [op.desc() for op in got.ops] == [op.desc() for op in want.ops]


@pytest.fixture(scope="module")
def bert_runs():
    """The JAX program under ``full`` and the port's under no recompute
    and each policy, from the JAX startup's state with the step counter
    past the warmup; STEPS steps each on one batch."""
    _, jmain, jstartup, jfetch = _bert_lamb(fluid, jax_names, "full")
    batch = jax_bert.synthetic_batch(np.random.RandomState(5), BATCH, SEQ,
                                     _bert_cfg(jax_bert), P)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        jexe.run(jstartup)
    import jax.numpy as jnp

    jscope.set(COUNTER, jnp.full([1], 20.0, jnp.float32))
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None}
    with fluid.scope_guard(jscope), jax_kernels.scoped_mode("interpret"):
        jl = [float(np.asarray(jexe.run(jmain, feed=batch,
                                        fetch_list=[jfetch[0].name])[0])
                    .reshape(-1)[0]) for _ in range(STEPS)]
    jstate = {n: np.asarray(jscope.find_var(n)) for n in state}
    runs = {}
    for policy in (None,) + POLICIES:
        _, tmain, tstartup, tfetch = _bert_lamb(pt, torch_names, policy)
        texe, tscope = pt.Executor(pt.CPUPlace()), pt.Scope()
        texe.run(tstartup, scope=tscope)
        load_params(tscope, state)
        losses = [float(texe.run(tmain, feed=batch, fetch_list=[tfetch[0]],
                                 scope=tscope)[0].reshape(-1)[0])
                  for _ in range(STEPS)]
        runs[policy] = (losses, persistables_to_numpy(tscope, tmain))
    return dict(jl=jl, jstate=jstate, state=state, runs=runs)


def test_bert_lamb_recompute_matches_the_jax_package(bert_runs):
    losses, tstate = bert_runs["runs"]["full"]
    np.testing.assert_allclose(losses, bert_runs["jl"], rtol=1e-4, atol=1e-5)
    assert losses[-1] != losses[0]
    moved = 0
    for name, want in bert_runs["jstate"].items():
        got = tstate[name]
        if name == COUNTER:
            np.testing.assert_array_equal(got, want)
        elif "moment" in name or "pow_acc" in name:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-7,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
            moved += not np.array_equal(want, bert_runs["state"][name])
    assert moved > 30


def test_bert_losses_and_state_are_bit_equal_across_policies(bert_runs):
    ref_losses, ref_state = bert_runs["runs"][None]
    for policy in POLICIES:
        losses, state = bert_runs["runs"][policy]
        assert [v.hex() for v in losses] == [v.hex() for v in ref_losses], \
            policy
        for name, want in ref_state.items():
            np.testing.assert_array_equal(state[name], want,
                                          err_msg=f"{policy}: {name}")
