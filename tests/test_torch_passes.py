"""The analysis passes of the PyTorch port against the JAX package's, on
the CPU: the pass framework (registry, ``PassManager``,
``verify_each_pass``), and each pass alone (``dead_code_elimination``,
``fold_constants``, ``flip_test_mode``, ``fc_fuse``, ``conv_bn_fuse``,
``multihead_matmul_fuse``, ``bf16_cast``) on the same program giving the
JAX pass's ``ctx.stats`` and op-type sequence, the rewritten programs
computing the same values within ``TOL`` — the ports of
``test_inference.py``'s pass tests and ``test_fusion_passes.py``, the
while-body refusal included, with the control-flow-aware use-def maps
(``analysis/usedef.py``) it rests on.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.passes import PassContext as JaxPassContext
from paddle_tpu.passes import get_pass as jax_get_pass
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.passes import (PassContext, PassManager, get_pass,
                                     register_pass)
from paddle_tpu_torch.utils import unique_name as torch_names
from paddle_tpu_torch.utils.enforce import EnforceError
from test_torch_inference import (BF16_TOL, TOL, Pair, _close, _host, _types,
                                  fc_net)

INFERENCE_PASSES = ("strip_debug_ops", "flip_test_mode",
                    "dead_code_elimination", "fold_constants",
                    "conv_bn_fuse", "fc_fuse", "multihead_matmul_fuse",
                    "bf16_cast")


# ---------------------------------------------------------------------------
# the pass framework
# ---------------------------------------------------------------------------


def test_the_inference_passes_are_registered_under_the_jax_names():
    for name in INFERENCE_PASSES + ("sparse_weight_update",
                                    "sharded_embedding_update"):
        assert callable(get_pass(name)) and callable(jax_get_pass(name))
    with pytest.raises(EnforceError):
        get_pass("no_such_pass")


def test_pass_framework():
    calls = []

    @register_pass("_torch_test_probe_pass")
    def probe(program, ctx):
        calls.append(ctx.opt("tag"))
        return program

    PassManager(["_torch_test_probe_pass"]).run(pt.Program(),
                                                PassContext(tag="hello"))
    assert calls == ["hello"]
    with pytest.raises(EnforceError):  # duplicate registration fails fast
        register_pass("_torch_test_probe_pass")(lambda p, c: p)
    with pytest.raises(EnforceError):  # unknown names fail at construction
        PassManager(["_torch_test_probe_pass", "no_such_pass"])


def test_verify_each_pass_names_the_pass_that_broke_the_program():
    @register_pass("_torch_test_drop_producer")
    def drop_first_op(program, ctx):
        program.global_block().ops.pop(0)
        return program

    with torch_names.guard():
        main, _, feeds, fetch = fc_net(pt)
    ctx = PassContext(feed_names=feeds, fetch_names=[fetch[0].name])
    with pytest.raises(EnforceError, match="_torch_test_drop_producer"):
        PassManager(["fc_fuse", "_torch_test_drop_producer"],
                    verify_each_pass=True).run(main, ctx)
    assert ctx.stats["verify"]["fc_fuse"] == []


# ---------------------------------------------------------------------------
# each pass alone, against the JAX pass
# ---------------------------------------------------------------------------

# (case id, builder, pass, clone for test, JAX train steps first)
PASS_CASES = [
    ("dce", "dce_net", "dead_code_elimination", False, 0),
    ("fold_constants", "const_net", "fold_constants", False, 0),
    ("flip_test_mode", "fc_net", "flip_test_mode", False, 0),
    ("fc_fuse", "fc_net", "fc_fuse", True, 0),
    ("fc_fuse_shared_intermediate", "shared_fc", "fc_fuse", True, 0),
    ("conv_bn_fuse", "conv_bn", "conv_bn_fuse", True, 3),
    ("multihead_tiny_bert", "tiny_bert", "multihead_matmul_fuse", True, 0),
    ("multihead_unfusable_3d", "serve_transformer", "multihead_matmul_fuse",
     True, 0),
    ("bf16_cast", "fc_net", "bf16_cast", True, 0),
]


@pytest.mark.parametrize("builder,pass_name,for_test,steps",
                         [c[1:] for c in PASS_CASES],
                         ids=[c[0] for c in PASS_CASES])
def test_each_pass_matches_the_jax_pass(builder, pass_name, for_test, steps):
    pair = Pair(builder, train_steps=steps)
    jprog = pair.jmain.clone(for_test=for_test)
    tprog = pair.tmain.clone(for_test=for_test)
    before = pair.run_port(tprog)
    jctx = JaxPassContext(scope=pair.jscope, feed_names=pair.feeds,
                          fetch_names=pair.fetch)
    tctx = PassContext(scope=pair.tscope, feed_names=pair.feeds,
                       fetch_names=pair.fetch, device="cpu")
    jprog = jax_get_pass(pass_name)(jprog, jctx) or jprog
    tprog = get_pass(pass_name)(tprog, tctx) or tprog
    assert tctx.stats == jctx.stats
    assert _types(tprog) == _types(jprog)
    want = pair.run_jax(jprog)
    got = pair.run_port(tprog)
    if pass_name == "bf16_cast":
        _close(got, want, BF16_TOL)
    else:
        _close(got, want)
    if pass_name not in ("bf16_cast", "flip_test_mode"):
        # the rewrite computes what the program computed before it
        _close(got, before, 1e-4 if pass_name == "conv_bn_fuse" else TOL)
    expect = {"dead_code_elimination": {"removed_ops": 1},
              "flip_test_mode": {"flipped_ops": 1},
              "fc_fuse": {"fused": 2 if builder == "fc_net" else 1},
              "conv_bn_fuse": {"fused": 1},
              "multihead_matmul_fuse": {
                  "fused": 2 if builder == "tiny_bert" else 0}}
    if pass_name in expect:
        assert tctx.stats[pass_name] == expect[pass_name]
    if pass_name == "fold_constants":
        assert tctx.stats[pass_name]["folded_ops"] >= 2
        np.testing.assert_array_equal(
            _host(pair.tscope.find_var(tprog.global_block().ops[0]
                                       .inputs["Y"][0])),
            np.full((2, 2), 6.0, "float32"))
    if builder == "tiny_bert":
        assert "softmax" not in _types(tprog)
        assert _types(tprog).count("scaled_dot_product_attention") == 2


def test_fold_constants_without_a_device_asks_for_the_card(monkeypatch):
    """No CPU fallback: ``fold_constants`` called without ``device=``
    leaves its values on ``cuda:0``, and with no card it raises."""
    pair = Pair("const_net")
    prog = pair.tmain.clone(for_test=False)
    ctx = PassContext(scope=pair.tscope, feed_names=pair.feeds,
                      fetch_names=pair.fetch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EnforceError, match="CUDA"):
        get_pass("fold_constants")(prog, ctx)


def _while_program():
    """``test_fusion_passes.py``'s program: the fc pattern's mul output is
    also read inside a while body, which its ``while`` op lists only as
    its Condition. Built by the JAX package (the port has no While
    builder) and read by the port from its bytes."""
    from paddle_tpu.layer_helper import LayerHelper

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[-1, 8], dtype="float32")
        helper = LayerHelper("fcw")
        w = helper.create_parameter(
            fluid.ParamAttr(name="fcw_w"), shape=[8, 4], dtype="float32")
        b = helper.create_parameter(
            fluid.ParamAttr(name="fcw_b"), shape=[4], dtype="float32")
        m = fluid.layers.mul(x, w)
        h = fluid.layers.elementwise_add(m, b)
        i = fluid.layers.fill_constant([1], "float32", 0.0)
        limit = fluid.layers.fill_constant([1], "float32", 3.0)
        s = fluid.layers.fill_constant([1], "float32", 0.0)
        cond = fluid.layers.less_than(i, limit)
        with fluid.layers.While(cond):
            t = fluid.layers.reduce_sum(m)  # sub-block read of the mul out
            ns = fluid.layers.elementwise_add(s, t)
            fluid.layers.assign(ns, s)
            ni = fluid.layers.increment(i, value=1.0, in_place=False)
            fluid.layers.assign(ni, i)
            fluid.layers.less_than(i, limit, cond=cond)
        y = fluid.layers.elementwise_add(fluid.layers.reduce_sum(h), s)
    return main, y.name


def test_fc_fuse_refuses_an_intermediate_read_by_a_while_body():
    from paddle_tpu_torch.analysis.usedef import build_usedef
    from paddle_tpu_torch.analysis.verify import verify_program

    with jax_names.guard():
        jmain, y = _while_program()
    jprog = jmain.clone(for_test=True)
    tprog = pt.Program.from_bytes(jprog.to_bytes())
    assert tprog.num_blocks() == 2
    mul = next(op for op in tprog.global_block().ops if op.type == "mul")
    usedef = build_usedef(tprog.global_block(), [y])
    # the while op consumes the mul output through its body
    assert [c.type for c in usedef.consumers[mul.outputs["Out"][0]]] == [
        "elementwise_add", "while"]
    assert usedef.sole_consumer(mul.outputs["Out"][0]) is None
    jctx = JaxPassContext(fetch_names=[y])
    tctx = PassContext(fetch_names=[y])
    jax_get_pass("fc_fuse")(jprog, jctx)
    get_pass("fc_fuse")(tprog, tctx)
    assert tctx.stats == jctx.stats == {"fc_fuse": {"fused": 0}}
    assert _types(tprog) == _types(jprog)
    assert "mul" in _types(tprog) and "fc" not in _types(tprog)
    assert verify_program(tprog, feed_names=["x"], fetch_names=[y]) == []


def test_live_var_sets_count_sub_block_reads_through_their_op():
    from paddle_tpu.analysis.usedef import live_var_sets as jax_live
    from paddle_tpu_torch.analysis.usedef import live_ops, live_var_sets

    with jax_names.guard():
        jmain, y = _while_program()
    tprog = pt.Program.from_bytes(jmain.to_bytes())
    tblock, jblock = tprog.global_block(), jmain.global_block()
    assert live_var_sets(tblock, [y]) == jax_live(jblock, [y])
    assert len(live_ops(tblock, [y])) == len(tblock.ops)


def test_conv_bn_fuse_folds_every_resnet50_batch_norm_as_the_jax_pass():
    """ResNet-50's inference program (``build_resnet_infer``, the
    builder call ``chip_smoke.py`` phase 11d exports): both passes fold
    the same 53 conv + batch_norm pairs (the stem, 3 a bottleneck block x
    16, 4 projection shortcuts) and leave the same op types. The fold's
    arithmetic is held on the small nets above; here every persistable is
    a constant of its shape, so no startup runs."""
    from paddle_tpu.models import resnet as jax_resnet
    from paddle_tpu_torch.models import resnet as torch_resnet

    progs = []
    for mod, names, resnet in ((fluid, jax_names, jax_resnet),
                               (pt, torch_names, torch_resnet)):
        with names.guard():
            infer, _, _, (prob,) = resnet.build_resnet_infer(
                depth=50, class_dim=1000, image_shape=(3, 224, 224))
        scope = mod.Scope()
        for v in infer.global_block().vars.values():
            if v.persistable and not v.is_data:
                value = np.ones(v.shape, "float32")
                scope.set(v.name, value if mod is fluid
                          else torch.from_numpy(value))
        ctx = (JaxPassContext if mod is fluid else PassContext)(
            scope=scope, feed_names=["img"], fetch_names=[prob.name])
        get = jax_get_pass if mod is fluid else get_pass
        get("conv_bn_fuse")(infer, ctx)
        progs.append((infer, ctx.stats))
    (jprog, jstats), (tprog, tstats) = progs
    assert tstats == jstats == {"conv_bn_fuse": {"fused": 53}}
    assert _types(tprog) == _types(jprog)
    assert "batch_norm" not in _types(tprog)
