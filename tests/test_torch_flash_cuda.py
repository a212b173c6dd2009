"""The three flash-attention CUDA kernels against their plain versions on
the card, over the shapes the kernels claim beyond BERT-base's (ragged
S on both sides of the backward's 16-row warp tiles and 64-row block
tiles, up to 512; head widths 4 to 128, with and without a multiple of
8 (the backward's MMA step) and across its 32-column classes; one or
many heads; with and without bias; causal or not), two launches giving
the same bits, a batch row whose keys all carry a -inf bias (K1's
``l == 0`` branch) or -1e9 (the uniform average), dK and dV the same
with and without dbias, and the
``autograd.Function`` end to end. Marked ``cuda``: it skips without a
card and runs on one with

    python -m pytest -m cuda tests/test_torch_flash_cuda.py -q

Bars are the CPU tests' (O and LSE rtol = atol = 1e-5; grads rtol 1e-4,
atol 1e-5): the kernels and the plain versions compute the same float32
function with sums in another order (the backward's products in the
3xTF32 split, which keeps float32 accuracy).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import flash_attention as FA

pytestmark = pytest.mark.cuda

SHAPES = [  # B, H, S, D
    (2, 3, 100, 96),
    (1, 2, 37, 128),
    (3, 1, 200, 8),
    (2, 4, 64, 32),
    (1, 1, 1, 4),
    (2, 2, 1, 64),
    (2, 2, 15, 64),
    (2, 3, 16, 12),
    (1, 3, 17, 36),
    (2, 2, 63, 72),
    (2, 1, 64, 128),
    (1, 2, 65, 4),
    (2, 2, 129, 64),
    (1, 2, 512, 64),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, B, H, S, D, with_bias, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(B, H, S, D, generator=gen, device=dev)
                     for _ in range(4))
    bias = None
    if with_bias:
        keep = torch.randint(max(1, S // 2), S + 1, (B, 1), generator=gen,
                             device=dev)
        bias = torch.where(torch.arange(S, device=dev)[None] < keep, 0.0,
                           -10000.0).contiguous()
    return q, k, v, dout, bias


def _close(got, want, rtol, atol):
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_their_plain_versions(dev, shape, with_bias, causal):
    B, H, S, D = shape
    q, k, v, dout, bias = _inputs(dev, B, H, S, D, with_bias, seed=sum(shape))
    scale = 1.0 / D ** 0.5
    o, lse = FA.flash_attention_fwd(q, k, v, bias, causal, scale)
    o_p, lse_p = FA.flash_attention_composite(q, k, v, bias, causal, scale)
    _close(o, o_p, 1e-5, 1e-5)
    _close(lse, lse_p, 1e-5, 1e-5)
    delta = (dout * o_p).sum(-1)
    args = (q, k, v, bias, dout, lse_p, delta, causal, scale)
    for got, want in zip(FA.flash_attention_bwd_dkdv(*args),
                         FA.flash_attention_bwd_dkdv_composite(*args)):
        if want is None:
            assert got is None
        else:
            _close(got, want, 1e-4, 1e-5)
    _close(FA.flash_attention_bwd_dq(*args),
           FA.flash_attention_bwd_dq_composite(*args), 1e-4, 1e-5)


def test_autograd_function_launches_the_kernels(dev):
    q, k, v, dout, bias = _inputs(dev, 2, 3, 100, 64, True, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    kernels.reset_launches()
    out = FA.flash_attention(*leaves[:3], bias=leaves[3], causal=True)
    got = torch.autograd.grad(out, leaves, dout)
    counts = kernels.launches()
    assert (counts["flash_attention_fwd"], counts["flash_attention_bwd_dkdv"],
            counts["flash_attention_bwd_dq"]) == (1, 1, 1)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    ref, _ = FA.flash_attention_composite(*ref_leaves, True, 1.0 / 8.0)
    want = torch.autograd.grad(ref, ref_leaves, dout)
    _close(out, ref, 1e-5, 1e-5)
    for g, w in zip(got, want):
        _close(g, w, 1e-4, 1e-5)


def test_a_frozen_bias_gets_no_dbias(dev):
    q, k, v, dout, bias = _inputs(dev, 2, 3, 100, 64, True, seed=2)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kernels.reset_launches()
    out = FA.flash_attention(*leaves, bias=bias)
    got = torch.autograd.grad(out, leaves, dout)
    counts = kernels.launches()
    assert (counts["flash_attention_fwd"], counts["flash_attention_bwd_dkdv"],
            counts["flash_attention_bwd_dq"]) == (1, 1, 1)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref, _ = FA.flash_attention_composite(*ref_leaves, bias, False, 1.0 / 8.0)
    for g, w in zip(got, torch.autograd.grad(ref, ref_leaves, dout)):
        _close(g, w, 1e-4, 1e-5)
    o, lse = FA.flash_attention_fwd(q, k, v, bias, False, 1.0 / 8.0)
    delta = (dout * o).sum(-1)
    assert FA.flash_attention_bwd_dkdv(q, k, v, bias, dout, lse, delta, False,
                                       1.0 / 8.0, want_dbias=False)[2] is None


def _backward_args(dev, shape, causal, seed):
    B, H, S, D = shape
    q, k, v, dout, bias = _inputs(dev, B, H, S, D, True, seed=seed)
    scale = 1.0 / D ** 0.5
    o, lse = FA.flash_attention_composite(q, k, v, bias, causal, scale)
    delta = (dout * o).sum(-1)
    return q, k, v, bias, dout, lse, delta, causal, scale


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 100, 96), (2, 2, 129, 64), (4, 12, 128, 64),
                                   (2, 2, 129, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_two_launches_give_the_same_bits(dev, shape, causal):
    args = _backward_args(dev, shape, causal, seed=7)
    q, k, v, bias = args[:4]

    def launch():
        return (*FA.flash_attention_fwd(q, k, v, bias, causal, args[-1]),
                *FA.flash_attention_bwd_dkdv(*args), FA.flash_attention_bwd_dq(*args))

    for a, b in zip(launch(), launch()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(3, 2, 100, 64), (3, 2, 129, 128), (3, 1, 16, 12)],
                         ids=lambda s: "x".join(map(str, s)))
def test_a_row_whose_keys_are_all_masked(dev, shape):
    """Batch row 1 gives every key a -inf bias: K1 takes its ``l == 0``
    branch, O = 0 and LSE = -1e30 there (the plain version has NaN and
    -inf). Batch row 2 gives every key -1e9: every score rounds to the
    same float and O is the uniform average of V, as in the plain version.
    The other rows are the plain version's."""
    B, H, S, D = shape
    q, k, v, _, _ = _inputs(dev, B, H, S, D, False, seed=sum(shape))
    bias = torch.zeros(B, S, device=dev)
    bias[1] = -float("inf")
    bias[2] = -1e9
    scale = 1.0 / D ** 0.5
    o, lse = FA.flash_attention_fwd(q, k, v, bias, False, scale)
    o_p, lse_p = FA.flash_attention_composite(q, k, v, bias, False, scale)
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    assert torch.equal(lse[1], torch.full_like(lse[1], -1e30))
    keep = torch.arange(B, device=dev) != 1
    _close(o[keep], o_p[keep], 1e-5, 1e-5)
    _close(lse[keep], lse_p[keep], 1e-5, 1e-5)
    _close(o[2], v[2].mean(dim=1, keepdim=True).expand_as(v[2]), 1e-5, 1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 100, 96), (2, 2, 65, 36)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dk_dv_are_the_same_with_and_without_dbias(dev, shape):
    args = _backward_args(dev, shape, False, seed=8)
    dk, dv, dbias = FA.flash_attention_bwd_dkdv(*args)
    dk_n, dv_n, none = FA.flash_attention_bwd_dkdv(*args, want_dbias=False)
    assert dbias is not None and none is None
    assert torch.equal(dk, dk_n) and torch.equal(dv, dv_n)
