"""Hybrid parallelism on the IR path in the PyTorch port against the JAX
package, on the CPU: the port's ``(data, stage, model)`` meshes on one
gang of 4 ranks (one process each, gloo over a ``file://`` rendezvous;
``tests/torch_hybrid_worker.py`` is one rank), the JAX package's
``CompiledProgram`` on the virtual CPU devices, from the same JAX startup
weights and feeds, 3 steps each.

* ``tests/test_pipeline_ir.py``'s stack model on ``(2, 2)`` data x stage:
  losses within that test's bar (rtol 2e-4, atol 1e-7), and every grad
  and parameter after each step.
* The tiny gpt_ir (vocab 64, hidden 32, 4 layers, 4 heads, tp 2, seq 16,
  batch 8, 2 microbatches: Megatron column/row weights, the
  ``c_allreduce_sum`` on ring 1 bound to ``model``, Adam) on ``(1, 2,
  2)`` against the JAX mesh of the same shape, and on ``(2, 1, 2)``
  against that same JAX run: the JAX package cannot run ``(2, 1, 2)``
  (off a stage axis its ``pipeline_stack`` takes the degenerate path over
  the global weights, whose per-shard head reshape then fails), and every
  mesh's step is the same global function. Losses within
  the JAX tp-parity bar (rtol 5e-4, atol 1e-6), grads within rtol 1e-4,
  atol ``GRAD_ATOL`` (float32 sums in another order; the key biases'
  grads are 0 up to rounding), parameters within ``PARAM_ATOL`` (Adam
  turns a grad of rounding noise into steps of up to lr * 0.01). With
  flash attention (the port's flash kernels' plain versions on the CPU)
  and unfused attention the port's ``(1, 2, 2)`` runs agree (the JAX
  flash-parity bar, rtol 2e-4).
* Every step's collectives on each axis are the plan's: ``4 * L/S * M``
  all-reduces on ``model`` (2 a layer forward, 2 backward), M sends and
  M receives a stage rank on ``stage``, one broadcast of the stack's
  output (last stage) or its input's grad (stage 0), the fused grads'
  all-reduce and the loss's on ``data``.
* Ranks that hold a replica of the same shard hold the same bits. The
  ``(1, 2, 2)`` ranks load their shards themselves (``convert.
  shard_params`` of the JAX package's global arrays, ``convert.
  gpt_ir_params``), the others the global arrays, which the first run
  slices.
* In process: ``pipeline_stack`` off a stage axis (the plain executor)
  against the JAX op: losses, grads and parameters over 3 SGD steps; its
  grad without the forward kept for it raises (a rerun would repeat every
  collective); a non-gpipe schedule raises naming M11.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import gpt_ir as jax_gpt_ir
from paddle_tpu.parallel.env import make_mesh as jax_make_mesh
from paddle_tpu.utils import unique_name as jax_names
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.utils import unique_name as torch_names
from torch_hybrid_worker import (
    GPT_BATCH, GPT_MICROBATCHES, GPT_SEQ, STEPS, gpt_ir_config, run_gang,
    stack_model)

GRAD_ATOL = 1e-6
PARAM_ATOL = 2e-5
AXES3 = ("data", "stage", "model")
#: case -> (model, port mesh, axes, the JAX mesh it is held to, flash)
MESHES = {
    "stack": ("stack", (2, 2), ("data", "stage"), (2, 2), True),
    "gpt_212": ("gpt_ir", (2, 1, 2), AXES3, (1, 2, 2), True),
    "gpt_122": ("gpt_ir", (1, 2, 2), AXES3, (1, 2, 2), True),
    "gpt_122_unfused": ("gpt_ir", (1, 2, 2), AXES3, None, False),
}

#: the op types this file holds against the JAX package (the op-coverage
#: guard of tests/test_torch_ops.py reads the keys): pipeline_stack and
#: its own grad lowering, pipeline_stack_grad
CASES = {"pipeline_stack": "stack model and gpt_ir, on and off a stage "
                           "axis, losses, grads and parameters"}


def _jax_stack():
    with jax_names.guard():
        return stack_model(fluid)


def _jax_gpt():
    with jax_names.guard():
        main, startup, _, loss, stack = jax_gpt_ir.build_gpt_ir(
            gpt_ir_config(jax_gpt_ir), seq_len=GPT_SEQ,
            num_microbatches=GPT_MICROBATCHES)
    return main, startup, loss, stack


def _jax_steps(built, weights, feed, mesh_shape, axes):
    """The JAX package's steps on ``mesh_shape`` from ``weights``: per
    step the loss, every parameter's grad and every parameter after it."""
    main, startup, loss, stack = built
    names = [p.name for p in main.all_parameters()]
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    out = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        for n, v in weights.items():
            scope.set(n, v)
        prog = fluid.CompiledProgram(main).with_parallel(
            mesh=jax_make_mesh(mesh_shape, axes), loss_name=loss.name,
            param_specs=stack.param_spec_overrides())
        for _ in range(STEPS):
            got = exe.run(prog, feed=feed,
                          fetch_list=[loss] + [n + "@GRAD" for n in names])
            out.append((np.asarray(got[0]).reshape(-1),
                        {n: np.asarray(g) for n, g in zip(names, got[1:])},
                        {n: np.asarray(scope.find_var(n)) for n in names}))
    return out


def _weights(built):
    """The JAX startup's global parameters, numpy, by the port's names."""
    main, startup = built[0], built[1]
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        return convert.gpt_ir_params(scope, main)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    rng = np.random.RandomState(20261018)
    stack, gpt = _jax_stack(), _jax_gpt()
    feeds = {
        "stack": {"x": rng.randn(8, 4, 16).astype("float32"),
                  "y": rng.randn(8, 4, 16).astype("float32")},
    }
    toks, labs = jax_gpt_ir.synthetic_batch(
        rng, GPT_BATCH, GPT_SEQ, gpt_ir_config(jax_gpt_ir))
    weights = {"stack": _weights(stack), "gpt_ir": _weights(gpt)}
    cases, inputs = {}, {}
    for name, (model, mesh, axes, _, flash) in MESHES.items():
        feed = feeds["stack"] if model == "stack" else {
            "tokens": toks, "labels": labs}
        feeds[name] = feed
        cases[name] = {"model": model, "mesh": list(mesh),
                       "axes": list(axes), "flash": flash,
                       "feeds": sorted(feed), "shards": name == "gpt_122"}
        inputs.update({f"{name}.{k}": v for k, v in
                       {**weights[model], **feed}.items()})

    def jax_side():
        # one JAX run a (model, mesh): the gpt cases share theirs
        runs, out = {}, {}
        for name, (model, _, axes, jmesh, _) in MESHES.items():
            if jmesh is None:
                continue
            if (model, jmesh) not in runs:
                runs[model, jmesh] = _jax_steps(
                    stack if model == "stack" else gpt, weights[model],
                    feeds[name], jmesh, axes)
            out[name] = runs[model, jmesh]
        return out

    want, ranks = run_gang(cases, inputs, tmp_path_factory.mktemp("hybrid"),
                           jax_side, n=4)
    return {"want": want, "ranks": ranks}


@pytest.mark.parametrize("case", ["stack", "gpt_212", "gpt_122"])
def test_losses_grads_and_parameters_match_the_jax_mesh(gang, case):
    loss_tol = (dict(rtol=2e-4, atol=1e-7) if case == "stack"
                else dict(rtol=5e-4, atol=1e-6))
    for arrays, meta in gang["ranks"]:
        for i, (loss, grads, params) in enumerate(gang["want"][case]):
            np.testing.assert_allclose(
                arrays[f"{case}.loss{i}"].reshape(-1), loss, **loss_tol)
            for n in meta[case]["names"]:
                np.testing.assert_allclose(
                    arrays[f"{case}.grad{i}.{n}"], grads[n], rtol=1e-4,
                    atol=GRAD_ATOL, err_msg=f"{case} step {i} {n}@GRAD")
                np.testing.assert_allclose(
                    arrays[f"{case}.param{i}.{n}"], params[n], rtol=1e-5,
                    atol=PARAM_ATOL, err_msg=f"{case} step {i} {n}")


def test_flash_and_unfused_attention_agree_on_the_mesh(gang):
    for arrays, _ in gang["ranks"]:
        flash = [arrays[f"gpt_122.loss{i}"] for i in range(STEPS)]
        unfused = [arrays[f"gpt_122_unfused.loss{i}"] for i in range(STEPS)]
        np.testing.assert_allclose(flash, unfused, rtol=2e-4, atol=1e-6)


def _planned(case):
    """{(kind, axis): calls} of one step of ``case`` on every rank."""
    model, mesh, axes, _, _ = MESHES[case]
    sizes = dict(zip(axes, mesh))
    m = GPT_MICROBATCHES  # the stack model runs 2 microbatches too
    stages = sizes.get("stage", 1)
    layers = 4 // stages
    want = {}
    if sizes.get("model", 1) > 1:
        want[("all_reduce", "model")] = 4 * layers * m
    if stages > 1:
        want[("send", "stage")] = m
        want[("recv", "stage")] = m
        want[("broadcast", "stage")] = 1
    if sizes.get("data", 1) > 1:
        want[("all_reduce_fused", "data")] = 1
        want[("all_reduce", "data")] = 1
    return want


@pytest.mark.parametrize("case", ["stack", "gpt_212", "gpt_122"])
def test_each_step_runs_the_planned_collectives(gang, case):
    want = _planned(case)
    for _, meta in gang["ranks"]:
        for i, step in enumerate(meta[case]["stats"]):
            # the fetches' gathers aside; the first run also places the
            # parameters (broadcasts along the axes they are replicated on)
            got = {tuple(k.split("|")): v[0] for k, v in step.items()
                   if not k.startswith("all_gather")}
            if i == 0:
                got = {k: v for k, v in got.items() if k[0] != "broadcast"}
                exp = {k: v for k, v in want.items() if k[0] != "broadcast"}
            else:
                exp = want
            assert got == exp, (case, i, meta[case]["coords"], got)


@pytest.mark.parametrize("case", ["stack", "gpt_212", "gpt_122"])
def test_ranks_holding_one_shard_hold_the_same_bits(gang, case):
    ranks = gang["ranks"]
    names = ranks[0][1][case]["names"]
    for n in names:
        by_shard = {}
        for arrays, meta in ranks:
            spec = meta[case]["specs"][n]
            used = {a for e in spec if e is not None
                    for a in (e if isinstance(e, list) else [e])}
            key = tuple(sorted((a, i) for a, i in meta[case]["coords"].items()
                               if a in used))
            by_shard.setdefault(key, []).append(arrays[f"{case}.local.{n}"])
        for shard, held in by_shard.items():
            for other in held[1:]:
                np.testing.assert_array_equal(other, held[0],
                                              err_msg=f"{case} {n} {shard}")
        # the shards put together are the global value
        assert len(by_shard) == int(np.prod([
            dict(zip(MESHES[case][2], MESHES[case][1]))[a]
            for a in {a for a, _ in next(iter(by_shard))}] or [1]))


def _port_stack(schedule="gpipe"):
    with torch_names.guard():
        return stack_model(pt, schedule=schedule)


def test_pipeline_stack_off_a_stage_axis_matches_the_jax_op():
    rng = np.random.RandomState(7)
    feed = {"x": rng.randn(8, 4, 16).astype("float32"),
            "y": rng.randn(8, 4, 16).astype("float32")}
    built = _jax_stack()
    weights = _weights(built)
    main, startup, loss, _ = built
    names = [p.name for p in main.all_parameters()]
    want = []
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        for n, v in weights.items():
            scope.set(n, v)
        for _ in range(STEPS):
            want.append([np.asarray(v) for v in exe.run(
                main, feed=feed,
                fetch_list=[loss] + [n + "@GRAD" for n in names] + names)])
    tmain, tstartup, tloss, _ = _port_stack()
    texe, tscope = pt.Executor(pt.CPUPlace()), pt.Scope()
    texe.run(tstartup, scope=tscope)
    convert.load_params(tscope, weights)
    types = [op.type for op in tmain.global_block().ops]
    assert "pipeline_stack" in types and "pipeline_stack_grad" in types
    for i in range(STEPS):
        got = texe.run(tmain, feed=feed, scope=tscope,
                       fetch_list=[tloss] + [n + "@GRAD" for n in names]
                       + names)
        np.testing.assert_allclose(got[0], want[i][0], rtol=1e-5, atol=1e-7)
        for g, w in zip(got[1:], want[i][1:]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=GRAD_ATOL)


def test_pipeline_stack_grad_without_its_kept_forward_raises():
    import torch

    from paddle_tpu_torch.core.registry import OpRegistry

    grad = OpRegistry.get("pipeline_stack").grad
    out = torch.zeros(8, 4, 16)
    with pytest.raises(pt.EnforceError, match="forward kept for the grad"):
        grad({"Out": [out], "Out@GRAD": [torch.ones_like(out)]}, {})


def test_a_schedule_other_than_gpipe_raises_naming_m11():
    main, startup, loss, _ = _port_stack(schedule="1f1b")
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.zeros((8, 4, 16), np.float32),
            "y": np.zeros((8, 4, 16), np.float32)}
    with pytest.raises(pt.EnforceError, match="1f1b.*M11") as err:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert isinstance(err.value.__cause__, NotImplementedError)
    with pytest.raises(NotImplementedError, match="pipeline_schedule.*M11"):
        pt.CompiledProgram(main).with_parallel(pipeline_schedule="gpipe")
