"""The port's ``conv2d`` on the card computes in full float32 whatever the
process's TF32 setting says. PyTorch's default runs float32 cuDNN
convolutions in TF32 (a 10-bit mantissa); the JAX package computes them
in float32. With TF32 switched on, through the legacy flag
(``torch.backends.cudnn.allow_tf32``) or, where torch has it, the newer
``torch.backends.cudnn.conv.fp32_precision``, a conv program through the
executor (forward and ``Filter@GRAD``/``Input@GRAD``) holds the float32
bar against a float64 reference on the CPU: each result within 1e-5 of
the reference in norm, ``||got - ref|| / ||ref||`` (float32 products and
sums leave about 1e-7 to 1e-6 of it; TF32's 10-bit operands about 7e-4,
whatever the length of the sums). The same convolution called directly
under TF32 misses that bar, so the bar tells the two apart, and the
setting is the caller's again after the run. Marked ``cuda``: it skips without a card
and runs on one with

    python -m pytest -m cuda tests/test_torch_conv_cuda.py -q
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.backward import append_backward
from paddle_tpu_torch.core.registry import OpRegistry

pytestmark = pytest.mark.cuda

BAR = 1e-5          # relative to the reference, in norm
N, C, HW, OC = 8, 64, 28, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _set_tf32(api, on):
    if api == "legacy":
        torch.backends.cudnn.allow_tf32 = on
    else:
        conv = getattr(torch.backends.cudnn, "conv", None)
        if not hasattr(conv, "fp32_precision"):
            pytest.skip("this torch has no cudnn.conv.fp32_precision")
        conv.fp32_precision = "tf32" if on else "ieee"


def _tf32(api):
    if api == "legacy":
        return torch.backends.cudnn.allow_tf32
    return torch.backends.cudnn.conv.fp32_precision == "tf32"


def _inputs():
    rng = np.random.RandomState(4)
    x = rng.randn(N, C, HW, HW).astype(np.float32)
    w = (rng.randn(OC, C, 3, 3) / np.sqrt(C * 9)).astype(np.float32)
    dy = rng.randn(N, OC, HW, HW).astype(np.float32)
    return x, w, dy


def _reference(x, w, dy):
    """Output, dW and dX in float64 on the CPU."""
    x64, w64 = (torch.from_numpy(a).double().requires_grad_() for a in (x, w))
    out = F.conv2d(x64, w64, padding=1)
    dx, dw = torch.autograd.grad(out, (x64, w64), torch.from_numpy(dy).double())
    return out.detach().numpy(), dw.numpy(), dx.numpy()


def _err(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _program():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.data("x", shape=[-1, C, HW, HW])
        x.stop_gradient = False
        dy = pt.data("dy", shape=[-1, OC, HW, HW])
        out = pt.layers.conv2d(x, OC, 3, padding=1, bias_attr=False,
                               param_attr=pt.ParamAttr(name="w"))
        # d(sum(out * dy))/d(out) = dy: the grads are the conv's VJP of dy
        loss = pt.layers.reduce_sum(pt.layers.elementwise_mul(out, dy))
        append_backward(loss)
    return main, startup, out


@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_conv_is_float32_under_tf32(dev, api):
    x, w, dy = _inputs()
    want = _reference(x, w, dy)
    main, startup, out = _program()
    saved = torch.backends.cudnn.allow_tf32
    try:
        _set_tf32(api, True)
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        scope.set("w", torch.from_numpy(w).to(dev))
        got = exe.run(main, feed={"x": x, "dy": dy},
                      fetch_list=[out.name, "w@GRAD", "x@GRAD"], scope=scope)
        assert _tf32(api), "the run left the caller's TF32 setting changed"
        # the control: the same convolution straight through torch, TF32 on
        xd, wd = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
        direct = F.conv2d(xd, wd, padding=1).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    errs = [_err(g, r) for g, r in zip(got, want)]
    control = _err(direct, want[0])
    assert max(errs) <= BAR < control, (errs, control)


def test_conv_lowering_restores_the_setting(dev):
    x, w, dy = _inputs()
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        out = OpRegistry.get("conv2d").lowering()(
            {"Input": [torch.from_numpy(x).to(dev)],
             "Filter": [torch.from_numpy(w).to(dev)]},
            {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1})["Output"][0]
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert _err(out.cpu().numpy(), _reference(x, w, dy)[0]) <= BAR
