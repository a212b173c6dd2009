"""Checkpoints between the host and the card: a checkpoint saved from a
``CPUPlace`` scope restores onto the card bit for bit, and one saved from
the card (pinned-memory snapshots, one synchronize) restores onto the
host bit for bit, bfloat16 included; an async save's snapshot of card
tensors is untouched by an in-place update right after ``save``.

Marked ``cuda``: it skips without a card and runs on one with

    python -m pytest --noconftest -m cuda tests/test_torch_checkpoint_cuda.py -q
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.incubate.checkpoint import AutoCheckpoint, load_checkpoint

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _program():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.data("x", shape=[-1, 8], dtype="float32")
        y = pt.data("y", shape=[-1, 1], dtype="float32")
        pred = pt.layers.fc(pt.layers.fc(x, size=32, act="relu"), size=1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    block = main.global_block()
    block.create_var(name="w_bf16", shape=[4, 6], dtype="bfloat16",
                     persistable=True)
    startup.random_seed = main.random_seed = 11
    return main, startup, loss


FEED = {"x": np.random.RandomState(0).randn(16, 8).astype("float32"),
        "y": np.random.RandomState(1).randn(16, 1).astype("float32")}


def _bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _trained(place):
    main, startup, loss = _program()
    exe, scope = pt.Executor(place=place), pt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):
        exe.run(main, feed=FEED, fetch_list=[loss], scope=scope)
    bf16 = torch.randn(4, 6, generator=torch.Generator().manual_seed(2))
    scope.set("w_bf16", bf16.to(torch.bfloat16).to(exe.device))
    names = [v.name for v in main.global_block().vars.values()
             if v.persistable]
    return main, exe, scope, names


@pytest.mark.parametrize("saver,restorer", [("cpu", "cuda"), ("cuda", "cpu")])
def test_a_checkpoint_crosses_between_host_and_card(card, tmp_path, saver,
                                                    restorer):
    places = {"cpu": pt.CPUPlace(), "cuda": pt.CUDAPlace(0)}
    main, exe, scope, names = _trained(places[saver])
    AutoCheckpoint(exe, main, str(tmp_path), scope=scope).save(
        1, blocking=True)
    back = pt.Scope()
    exe2 = pt.Executor(place=places[restorer])
    assert AutoCheckpoint(exe2, main, str(tmp_path), scope=back).resume() == 2
    for n in names:
        got = back.find_var(n)
        assert got.device.type == restorer, n
        assert got.dtype == scope.find_var(n).dtype, n
        assert _bits(got) == _bits(scope.find_var(n)), n


def test_an_async_card_snapshot_is_isolated(card, tmp_path):
    main, exe, scope, names = _trained(pt.CUDAPlace(0))
    want = {n: _bits(scope.find_var(n)) for n in names}
    ck = AutoCheckpoint(exe, main, str(tmp_path), scope=scope)
    ck.save(0)
    for n in names:
        scope.find_var(n).add_(1)           # in place, on the card
    ck.close()
    back = pt.Scope()
    assert load_checkpoint(str(tmp_path), scope=back) == 1
    for n in names:
        assert _bits(back.find_var(n)) == want[n], n
