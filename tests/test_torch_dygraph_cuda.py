"""The dygraph and beam-translation slice on the card: the same runs on
the card and on the CPU. Marked ``cuda``: it skips without a card and
runs on one with

    python -m pytest --noconftest -m cuda tests/test_torch_dygraph_cuda.py -q

* ``examples/recognize_digits_dygraph.py``'s recipe: eager losses
  bit-equal to each step's ``to_static`` capture, and within 1e-5 of the
  same run on the CPU;
* eager parameter draws and ``Dropout`` masks through K8 bit-equal to
  the CPU's plain versions, K8 launched once a draw;
* a ``while``/``cond`` program on the card gives the CPU's fetches;
* the beam decoder's hypotheses on the card are the CPU's on tiny
  random weights (scores within rtol 1e-4).
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import dygraph, kernels
from paddle_tpu_torch.models import mnist
from paddle_tpu_torch.models import transformer as tfm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return pt.CUDAPlace(0)


def test_mnist_recipe_eager_equals_capture_on_the_card(card):
    eager, captured = mnist.dygraph_mnist_recipe(place=card)
    assert eager == captured
    cpu, _ = mnist.dygraph_mnist_recipe(place=pt.CPUPlace())
    np.testing.assert_allclose(eager, cpu, rtol=1e-5, atol=1e-6)
    assert eager[-1] < eager[0]


def _draws(place):
    with dygraph.guard(place=place, seed=5):
        lin = dygraph.Linear(33, 17)
        conv = dygraph.Conv2D(3, 4, 3)
        drop = dygraph.Dropout(0.5, dropout_implementation="upscale_in_train")
        x = dygraph.to_variable(np.ones((8, 100), np.float32))
        masks = [drop(x).numpy() for _ in range(2)]
        return [lin.weight.numpy(), conv.weight.numpy()] + masks


def test_k8_draws_equal_the_cpu(card):
    kernels.reset_launches()
    got = _draws(card)
    launches = kernels.launches()
    want = _draws(pt.CPUPlace())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert launches["threefry_random_bits"] == 2
    assert launches["threefry_dropout"] == 2


def _loop_program():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        L = pt.layers
        x = pt.data("x", [3], "float32")
        i = L.fill_constant([1], "float32", 0.0)
        acc = L.fill_constant([3], "float32", 0.0)
        n = L.fill_constant([1], "float32", 4.0)
        cond = L.less_than(i, n)
        with L.While(cond):
            big = L.greater_than(L.reduce_sum(acc),
                                 L.fill_constant([1], "float32", 2.0))
            step = L.cond(big, lambda: L.scale(x, 0.5), lambda: x)
            L.assign(L.elementwise_add(acc, step), acc)
            L.increment(i, value=1.0)
            L.less_than(i, n, cond=cond)
    return main, acc


def test_while_and_cond_on_the_card(card):
    main, acc = _loop_program()
    x = np.array([0.5, 1.0, -0.25], np.float32)
    outs = []
    for place in (card, pt.CPUPlace()):
        with pt.scope_guard(pt.Scope()):
            outs.append(pt.Executor(place).run(main, feed={"x": x},
                                               fetch_list=[acc])[0])
    np.testing.assert_array_equal(outs[0], outs[1])


def test_beam_decoder_on_the_card_matches_the_cpu(card):
    cfg = tfm.TransformerConfig.tiny()
    _, startup, _, _ = tfm.build_wmt_train(cfg, src_len=8, tgt_len=8)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(startup)
        params = tfm.params_from_scope(cfg, scope)
    src = np.random.RandomState(1).randint(3, cfg.vocab_size, (4, 7))
    out = []
    for place in (card, pt.CPUPlace()):
        toks, scores = tfm.make_beam_decoder(cfg, beam_size=4, max_len=10,
                                             place=place)(params, src)
        out.append((toks.cpu().numpy(), scores.cpu().numpy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-4)
