"""The port's flash-attention plain versions (``flash_attention_composite``
and ``flash_attention_bwd_composite``, the functions of the three CUDA
kernels K1, K2a and K2b) against the JAX package's Pallas kernels in
interpret mode, as tests/test_flash_attention.py runs them.

Inputs: {causal, not} x {bias with some masked keys, none} x {S = 32 with
blocks 16/8, S = 24 (ragged: the JAX wrapper halves its blocks to 8)}.
O and LSE agree within rtol = atol = 1e-5 (the JAX test's bar), the
grads dq, dk, dv and dbias of a random dO within rtol 1e-4, atol 1e-5
(float32 sums in another order). A bias without a grad (BERT's padding
mask) asks the dK/dV function for no dbias. The CUDA kernels run only on the card;
chip_smoke.py holds them against these plain versions there. Two tests
pin the kernels' numerics: every product in the 3xTF32 split (emulated
here) keeps the forward and the backward within the card's bars, and
plain TF32 does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import flash_attention as torch_flash
from paddle_tpu_torch.models import bert

B, H, D = 2, 2, 8
SCALE = 1.0 / np.sqrt(D)
# the card's bars for the kernels against their plain versions
# (chip_smoke.py FWD_TOL and BWD_TOL: rtol, atol)
FWD_TOL, BWD_TOL = (1e-5, 1e-5), (1e-4, 1e-5)


def _inputs(S, with_bias, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, dout = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    bias = (np.where(rng.rand(B, S) > 0.25, 0.0, -1e9).astype(np.float32)
            if with_bias else None)
    return q, k, v, bias, dout


def _t(a):
    return None if a is None else torch.from_numpy(a.copy())


def _j(a):
    return None if a is None else jnp.asarray(a)


def _halved(S, block):
    """The JAX wrapper's block: halved until it divides S."""
    block = min(block, S)
    while S % block:
        block //= 2
    return block


@pytest.fixture(autouse=True)
def _zero_counters():
    kernels.reset_launches()
    yield
    assert all(n == 0 for n in kernels.launches().values())


@pytest.mark.parametrize("S,block_q,block_k", [(32, 16, 8), (24, 16, 8)])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_versions_match_the_pallas_kernels(causal, with_bias, S, block_q,
                                                 block_k):
    q, k, v, bias, dout = _inputs(S, with_bias)
    jq, jk, jv, jb = _j(q), _j(k), _j(v), _j(bias)
    want_o, want_lse = jax_flash._fwd_impl(jq, jk, jv, jb, SCALE, causal,
                                           _halved(S, block_q),
                                           _halved(S, block_k), True)
    o, lse = torch_flash.flash_attention_composite(
        _t(q), _t(k), _t(v), _t(bias), causal, SCALE)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5,
                               atol=1e-5)

    def pallas(q_, k_, v_, b_):
        return jax_flash.flash_attention(q_, k_, v_, bias=b_, causal=causal,
                                         sm_scale=SCALE, block_q=block_q,
                                         block_k=block_k, interpret=True)

    _, vjp = jax.vjp(pallas, jq, jk, jv, jb)
    want = vjp(jnp.asarray(dout))
    got = torch_flash.flash_attention_bwd_composite(
        _t(q), _t(k), _t(v), _t(bias), o, lse, _t(dout), causal, SCALE)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if name == "dbias" and bias is None:
            assert g is None and w is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_dbias_matches_jax_grad_of_the_composite(causal):
    q, k, v, bias, dout = _inputs(24, True, seed=1)

    def loss(b_):
        out = jax_flash._jnp_attention(_j(q), _j(k), _j(v), b_, SCALE, causal)
        return jnp.sum(out * _j(dout))

    want = jax.grad(loss)(_j(bias))
    o, lse = torch_flash.flash_attention_composite(
        _t(q), _t(k), _t(v), _t(bias), causal, SCALE)
    dbias = torch_flash.flash_attention_bwd_composite(
        _t(q), _t(k), _t(v), _t(bias), o, lse, _t(dout), causal, SCALE)[3]
    np.testing.assert_allclose(dbias.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("masked", [-1e4, -1e9])
def test_a_row_whose_keys_are_all_masked_is_never_zero(masked):
    """Batch row 1 masks every key with a finite bias. Both packages give
    a finite LSE and the same O, and never the kernel's ``l == 0`` output
    (O = 0): with BERT's -10000 the scores keep their differences and O is
    the unmasked attention (softmax is shift-invariant); with -1e9 every
    score rounds to the same float and O is the uniform average of V."""
    q, k, v, _, _ = _inputs(16, False, seed=2)
    bias = np.zeros((B, 16), np.float32)
    bias[1] = masked
    want_o, want_lse = jax_flash._fwd_impl(_j(q), _j(k), _j(v), _j(bias), SCALE,
                                           False, 8, 8, True)
    o, lse = torch_flash.flash_attention_composite(
        _t(q), _t(k), _t(v), _t(bias), False, SCALE)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=1e-5, atol=1e-5)
    assert np.isfinite(np.asarray(want_lse)).all() and np.isfinite(lse.numpy()).all()
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5)
    if masked == -1e4:
        # each score rounds to the ulp of 1e4 (about 1e-3) first
        unmasked, _ = torch_flash.flash_attention_composite(
            _t(q), _t(k), _t(v), None, False, SCALE)
        np.testing.assert_allclose(o.numpy()[1], unmasked.numpy()[1], atol=2e-3)
    else:
        uniform = np.broadcast_to(v[1].mean(axis=1, keepdims=True), v[1].shape)
        np.testing.assert_allclose(o.numpy()[1], uniform, rtol=1e-5, atol=1e-5)
    assert np.abs(o.numpy()[1]).max() > 0.01


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_on_cpu_matches_autograd_of_the_plain_forward(
        causal, with_bias):
    q, k, v, bias, dout = _inputs(24, with_bias, seed=3)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    b = _t(bias).requires_grad_() if with_bias else None
    out = torch_flash.flash_attention(*leaves, bias=b, causal=causal,
                                      sm_scale=SCALE)
    got = torch.autograd.grad(out, leaves + ([b] if with_bias else []),
                              _t(dout))
    ref_leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    rb = _t(bias).requires_grad_() if with_bias else None
    ref, _ = torch_flash.flash_attention_composite(*ref_leaves, rb, causal, SCALE)
    want = torch.autograd.grad(ref, ref_leaves + ([rb] if with_bias else []),
                               _t(dout))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)


def test_a_bias_without_grad_gets_no_dbias(monkeypatch):
    """A bias nobody differentiates (BERT's padding mask) makes the backward
    ask K2a for no dbias, in the Function and through the executor's grad
    op, and the grads of q, k and v stay those of autograd."""
    q, k, v, bias, dout = _inputs(24, True, seed=4)
    asked = []
    dkdv = torch_flash.flash_attention_bwd_dkdv_composite

    def spy(*args):
        asked.append(args[-1])
        return dkdv(*args)

    monkeypatch.setattr(torch_flash, "flash_attention_bwd_dkdv_composite", spy)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = torch_flash.flash_attention(*leaves, bias=_t(bias), sm_scale=SCALE)
    got = torch.autograd.grad(out, leaves, _t(dout))
    ref_leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    ref, _ = torch_flash.flash_attention_composite(*ref_leaves, _t(bias),
                                                   False, SCALE)
    want = torch.autograd.grad(ref, ref_leaves, _t(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
    assert asked == [False]

    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.use_flash_attention = True
    main, startup, _, fetches = bert.build_bert_pretrain(
        cfg, seq_len=8, max_predictions_per_seq=2)
    exe, scope = pt.Executor(place=pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    asked.clear()
    exe.run(main, feed=bert.synthetic_batch(np.random.RandomState(0), 2, 8,
                                            cfg, 2),
            fetch_list=[fetches[0]], scope=scope)
    assert asked == [False] * cfg.num_hidden_layers


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        torch_flash.flash_attention_fwd(q, q, q, None, False, 1.0)
    with pytest.raises(ValueError, match="multiple of 4"):
        torch_flash.flash_attention_bwd_dq(*[torch.zeros(1, 1, 4, 6)] * 3, None,
                                           None, None, None, False, 1.0)
    with pytest.raises(TypeError, match="float32"):
        torch_flash._check("q", q.double(), q.shape, q.device)
    with pytest.raises(ValueError, match="contiguous"):
        torch_flash._check("q", q.transpose(2, 3), (1, 1, 8, 4), q.device)


def _tf32(x):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, half away
    from zero (add half of the dropped 13 bits' range to the magnitude's
    bits, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _matmul(a, b, route):
    """a @ b with f32 accumulation, the operands taken as the route takes
    them: "f32" as they are, "tf32" rounded once, "3xtf32" split into big =
    tf32(x) and small = tf32(x - big), three products summed."""
    if route == "f32":
        return a @ b
    a_big, b_big = _tf32(a), _tf32(b)
    if route == "tf32":
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _backward_by_route(route, q, k, v, bias, out, lse, dout, scale):
    """The composite backward (non-causal) with every product of K2a and
    K2b (S, dP, dV, dK, dQ) taken by ``route``."""
    s = _matmul(q, k.transpose(-1, -2), route) * scale + bias[:, None, None, :]
    lse = lse[..., None]
    p = torch.where(lse <= -5e29, torch.zeros(()), torch.exp(s - lse))
    delta = (dout * out).sum(-1)
    dv = _matmul(p.transpose(-1, -2), dout, route)
    ds = p * (_matmul(dout, v.transpose(-1, -2), route) - delta[..., None])
    dk = _matmul(ds.transpose(-1, -2), q, route) * scale
    dq = _matmul(ds, k, route) * scale
    return dq, dk, dv, ds.sum(dim=2).sum(dim=1)


def _within(got, want, tol):
    rtol, atol = tol
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def test_the_backward_needs_3xtf32_products_for_the_float32_bars():
    """BERT-base's head (S=128, D=64) with its padding bias: with every
    product in the 3xTF32 split, as the kernels take them, dq, dk, dv and
    dbias stay within the card's bars of the float32 composite; with plain
    TF32 products dq, dk and dv do not."""
    one = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    assert _tf32(one).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]

    rng = np.random.RandomState(7)
    b, h, s, d = 2, 4, 128, 64
    q, k, v, dout = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
                     for _ in range(4))
    keep = rng.randint(s // 2, s + 1, size=(b, 1))
    bias = torch.from_numpy(np.where(np.arange(s)[None] < keep, 0.0,
                                     -10000.0).astype(np.float32))
    scale = 1.0 / np.sqrt(d)
    out, lse = torch_flash.flash_attention_composite(q, k, v, bias, False, scale)
    want = torch_flash.flash_attention_bwd_composite(q, k, v, bias, out, lse,
                                                     dout, False, scale)
    args = (q, k, v, bias, out, lse, dout, scale)
    # the emulation itself: f32 products give the composite's numbers
    for g, w in zip(_backward_by_route("f32", *args), want):
        assert _within(g, w, (1e-6, 1e-6))
    for g, w in zip(_backward_by_route("3xtf32", *args), want):
        assert _within(g, w, BWD_TOL)
    plain = _backward_by_route("tf32", *args)
    for name, g, w in zip(("dq", "dk", "dv"), plain, want):
        assert not _within(g, w, BWD_TOL), name


def _pairs_product(a, b, route):
    """a @ b as the kernels sum it: each two MMA k steps (16 of the inner
    dim) into a fresh accumulator, the partial products added in f32 in
    order."""
    out = None
    for c0 in range(0, a.shape[-1], 16):
        part = _matmul(a[..., c0:c0 + 16], b[..., c0:c0 + 16, :], route)
        out = part if out is None else out + part
    return out


def _forward_by_route(route, q, k, v, bias, scale, tile=16):
    """K1's sums (non-causal): key tiles of ``tile``, each tile's scores
    and P V taken by ``route`` in fresh accumulators, the online softmax's
    running max and sum, O and LSE at the end."""
    rows = q.shape[:-1]
    m = torch.full(rows, -1e30)
    l = torch.zeros(rows)
    acc = torch.zeros(q.shape)
    for k0 in range(0, k.shape[-2], tile):
        kt, vt = k[..., k0:k0 + tile, :], v[..., k0:k0 + tile, :]
        s = (_pairs_product(q, kt.transpose(-1, -2), route) * scale
             + bias[:, None, None, k0:k0 + tile])
        m_new = torch.maximum(m, s.max(dim=-1).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _pairs_product(p, vt, route)
        m = m_new
    return acc / l[..., None], m + torch.log(l)


def test_the_forward_needs_3xtf32_products_for_the_float32_bars():
    """BERT-base's head (S=128, D=64) with its padding bias: with both
    products (S = Q K^T, O += P V) in the 3xTF32 split, as K1 takes them,
    O and the LSE stay within the card's bars of the float32 composite;
    with plain TF32 products they do not."""
    rng = np.random.RandomState(8)
    b, h, s, d = 2, 4, 128, 64
    q, k, v = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
               for _ in range(3))
    keep = rng.randint(s // 2, s + 1, size=(b, 1))
    bias = torch.from_numpy(np.where(np.arange(s)[None] < keep, 0.0,
                                     -10000.0).astype(np.float32))
    scale = 1.0 / np.sqrt(d)
    want = torch_flash.flash_attention_composite(q, k, v, bias, False, scale)
    # the emulation itself: f32 products give the composite's numbers
    for g, w in zip(_forward_by_route("f32", q, k, v, bias, scale), want):
        assert _within(g, w, (1e-6, 1e-6))
    for g, w in zip(_forward_by_route("3xtf32", q, k, v, bias, scale), want):
        assert _within(g, w, FWD_TOL)
    plain = _forward_by_route("tf32", q, k, v, bias, scale)
    for name, g, w in zip(("O", "LSE"), plain, want):
        assert not _within(g, w, FWD_TOL), name
