"""The PyTorch port's eager Executor on the CPU: the in-place arena plan,
seeded startup weights, and its error paths; plus ``convert.load_params``
refusing what it cannot load."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import load_params
from paddle_tpu_torch.core.executor import block_plan
from paddle_tpu_torch.serving.decode import build_decoder_model

GEOM = dict(vocab_size=64, hidden=16, num_layers=2, slots=4, max_len=32,
            block_size=4)


@pytest.mark.parametrize("program", ["decode_program", "inject_program"])
def test_arena_scatters_are_planned_in_place(program):
    prog = getattr(build_decoder_model(**GEOM), program)
    scatters = [st for st in block_plan(prog.global_block())
                if st.op.type == "scatter"]
    assert len(scatters) == 2 * GEOM["num_layers"]
    assert all(st.attrs.get("_inplace") for st in scatters)


def _arena_program(extra_reader):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        arena = main.global_block().create_var(
            name="arena", shape=[6, 2], dtype="float32", persistable=True)
        ids = pt.data("ids", [2], dtype="int64")
        upd = pt.data("upd", [2, 2], dtype="float32")
        new = pt.layers.scatter(arena, ids, upd, overwrite=True, mode="drop")
        pt.layers.assign(new, output=arena)
        rd = pt.data("rd", [2], dtype="int64")
        read = pt.layers.gather(arena, rd) if extra_reader else None
    return main, read


@pytest.mark.parametrize("extra_reader", [False, True])
def test_scatter_writes_in_place_only_when_nothing_else_reads_the_arena(
        extra_reader):
    main, read = _arena_program(extra_reader)
    (step,) = [st for st in block_plan(main.global_block())
               if st.op.type == "scatter"]
    assert bool(step.attrs.get("_inplace")) is (not extra_reader)
    scope = pt.Scope()
    arena0 = torch.zeros(6, 2)
    scope.set("arena", arena0)
    exe = pt.Executor(place=pt.CPUPlace())
    feed = {"ids": np.array([1, 9], np.int64),        # row 9 is dropped
            "upd": np.ones((2, 2), np.float32),
            "rd": np.array([1, 2], np.int64)}
    out = exe.run(main, feed=feed, fetch_list=[read] if read else [],
                  scope=scope)
    got = scope.find_var("arena")
    np.testing.assert_array_equal(got.numpy()[:, 0], [0, 1, 0, 0, 0, 0])
    if extra_reader:
        # the reader (after the assign) sees the new rows; the scatter
        # wrote a copy and left the tensor it was given alone
        np.testing.assert_array_equal(out[0], [[1, 1], [0, 0]])
        assert got is not arena0 and float(arena0.sum()) == 0.0
    else:
        assert got is arena0


def test_startup_weights_follow_the_executor_seed():
    model = build_decoder_model(**GEOM)

    # the executor's key comes from the program's random_seed and its run
    # counter, as in the JAX executor: a fresh executor, one seed, one key
    def weights(seed):
        scope = pt.Scope()
        model.startup_program.random_seed = seed
        pt.Executor(place=pt.CPUPlace()).run(model.startup_program,
                                             scope=scope)
        return scope.find_var("decoder_v1.l0.q.w").clone()

    a, b, c = weights(5), weights(5), weights(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    limit = float(np.sqrt(6.0 / (GEOM["hidden"] * 2)))     # Xavier uniform
    assert float(a.abs().max()) <= limit


def test_running_before_startup_names_the_missing_variable():
    model = build_decoder_model(**GEOM)
    exe = pt.Executor(place=pt.CPUPlace())
    feeds = {"inj_rows": np.zeros(GEOM["max_len"], np.int64)}
    for kn, vn in model.inject_kv_feeds:
        feeds[kn] = feeds[vn] = np.zeros((1, GEOM["max_len"], GEOM["hidden"]),
                                         np.float32)
    with pytest.raises(pt.EnforceError, match="startup program"):
        exe.run(model.inject_program, feed=feeds, scope=pt.Scope())


def test_load_params_refuses_unknown_names_and_wrong_shapes():
    scope = pt.Scope()
    scope.set("w", torch.zeros(2, 3))
    with pytest.raises(KeyError, match="startup"):
        load_params(scope, {"nope": np.zeros((2, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_params(scope, {"w": np.zeros((3, 2), np.float32)})
    load_params(scope, {"w": np.ones((2, 3), np.float64)})
    assert scope.find_var("w").dtype == torch.float32
    assert float(scope.find_var("w").sum()) == 6.0
