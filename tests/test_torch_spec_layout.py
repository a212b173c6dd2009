"""The port's placement layer against the JAX package's, entry for entry
(``tests/test_spec_layout.py:57-110`` is the JAX package's own): for
BERT, the Transformer and gpt_ir (its pipeline-stacked parameters too),
built in each package under its own name guard,

* ``spec_layout.infer_roles`` gives every parameter the JAX package's
  role;
* ``SpecLayout().derive_shardings`` gives every persistable (parameters
  and optimizer slots) the JAX package's spec on ``(2, 4)`` data x model,
  ``(2, 2, 2)`` data x fsdp x model and ``(1, 2, 2)`` data x stage x
  model meshes, with and without the stack's ``param_spec_overrides()``;
* ``sharding.derive_shardings`` (the Megatron pattern table under the
  overrides, the placement ``with_parallel(param_specs=)`` uses) gives
  the JAX package's specs on the same meshes;
* ``PipelinedStack.param_spec_overrides()`` equals the JAX package's;
* the layout fingerprint is the JAX package's hash of the same content,
  and ``shard_of`` cuts the shard a rank's coordinates name.

The port's meshes here are specs' only: axes without process groups.
"""

import numpy as np
import pytest

from paddle_tpu.models import bert as jax_bert
from paddle_tpu.models import gpt_ir as jax_gpt_ir
from paddle_tpu.models import transformer as jax_tfm
from paddle_tpu.parallel import sharding as jax_sharding
from paddle_tpu.parallel import spec_layout as jax_layout
from paddle_tpu.parallel.env import make_mesh as jax_make_mesh
from paddle_tpu.utils import unique_name as jax_names
from paddle_tpu_torch.models import bert, gpt_ir, transformer
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.parallel import sharding, spec_layout
from paddle_tpu_torch.utils import unique_name as torch_names

MESHES = {
    "data x model": ((2, 4), ("data", "model")),
    "data x fsdp x model": ((2, 2, 2), ("data", "fsdp", "model")),
    "data x stage x model": ((1, 2, 2), ("data", "stage", "model")),
}


def _build(name, bert_mod, tfm_mod, gpt_mod):
    """(main program, the stack or None) of model ``name``."""
    if name == "bert":
        main, *_ = bert_mod.build_bert_pretrain(bert_mod.BertConfig.tiny(),
                                                seq_len=16, lr=1e-3)
        return main, None
    if name == "transformer":
        main, *_ = tfm_mod.build_wmt_train(tfm_mod.TransformerConfig.tiny(),
                                           src_len=8, tgt_len=8)
        return main, None
    cfg = gpt_mod.GPTIRConfig(vocab_size=64, hidden_size=32, num_layers=4,
                              num_heads=4, tp=2)
    main, _s, _f, _loss, stack = gpt_mod.build_gpt_ir(cfg, seq_len=8,
                                                      num_microbatches=2)
    return main, stack


@pytest.fixture(scope="module", params=["bert", "transformer", "gpt_ir"])
def programs(request):
    with jax_names.guard():
        jax_main, jax_stack = _build(request.param, jax_bert, jax_tfm,
                                     jax_gpt_ir)
    with torch_names.guard():
        main, stack = _build(request.param, bert, transformer, gpt_ir)
    return request.param, (jax_main, jax_stack), (main, stack)


def _spec(s):
    """A spec as a plain tuple, trailing Nones dropped."""
    out = [tuple(e) if isinstance(e, (list, tuple)) else e for e in tuple(s)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _persistables(program):
    names = sorted(v.name for v in program.global_block().vars.values()
                   if v.persistable)
    return names, [tuple(program.global_block().vars[n].shape or ())
                   for n in names]


def _port_mesh(shape, axes):
    return penv.Mesh(*[penv.Axis(a, n, 0) for a, n in zip(axes, shape)])


def test_roles_equal_the_jax_packages(programs):
    _, (jax_main, _), (main, _) = programs
    want = jax_layout.infer_roles(jax_main)
    got = spec_layout.infer_roles(main)
    assert got == want
    assert set(got) >= {p.name for p in main.all_parameters()
                        if p.trainable} - {"@LR_DECAY_COUNTER@"}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_layout_and_rule_specs_equal_the_jax_packages(programs, mesh):
    name, (jax_main, jax_stack), (main, stack) = programs
    shape, axes = MESHES[mesh]
    jmesh, tmesh = jax_make_mesh(shape, axes), _port_mesh(shape, axes)
    names, shapes = _persistables(main)
    assert (names, shapes) == _persistables(jax_main)
    for overrides in (None, "stack"):
        jo = jax_stack.param_spec_overrides() if overrides and jax_stack \
            else None
        to = stack.param_spec_overrides() if overrides and stack else None
        want = jax_layout.SpecLayout().derive_shardings(
            jax_main, names, shapes, jmesh, overrides=jo)
        got = spec_layout.SpecLayout().derive_shardings(
            main, names, shapes, tmesh, overrides=to)
        assert {n: _spec(s) for n, s in got.items()} == \
            {n: _spec(s.spec) for n, s in want.items()}, (name, mesh)
        want = jax_sharding.derive_shardings(names, shapes, jmesh,
                                             overrides=jo)
        got = sharding.derive_shardings(names, shapes, tmesh, overrides=to)
        assert {n: _spec(s) for n, s in got.items()} == \
            {n: _spec(s.spec) for n, s in want.items()}, (name, mesh)


def test_stack_overrides_and_fingerprint_equal_the_jax_packages(programs):
    name, (_, jax_stack), (_, stack) = programs
    assert spec_layout.SpecLayout().fingerprint() == \
        jax_layout.SpecLayout().fingerprint()
    if stack is None:
        return
    want = {n: _spec(s) for n, s in jax_stack.param_spec_overrides().items()}
    got = {n: _spec(s) for n, s in stack.param_spec_overrides().items()}
    assert got == want and len(got) == 16
    # ln1's scale, w_q (column-parallel), w_ao (row-parallel)
    assert got["pipelined_stack_0.w_0"] == ("stage",)
    assert got["pipelined_stack_0.w_1"] == ("stage", None, "model")
    assert got["pipelined_stack_0.w_4"] == ("stage", "model")


def test_shard_of_cuts_the_shard_a_ranks_coordinates_name():
    mesh = _port_mesh((2, 2, 2), ("data", "stage", "model"))
    x = np.arange(4 * 6 * 8).reshape(4, 6, 8)
    spec = sharding.P("stage", None, ("data", "model"))
    assert sharding.shard_shape(x.shape, spec, mesh) == (2, 6, 2)
    shard = sharding.shard_of(x, spec, mesh,
                              {"data": 1, "stage": 0, "model": 1})
    # dim 2 splits in 4 over (data, model), row-major: data 1, model 1 is
    # the 4th quarter
    np.testing.assert_array_equal(shard, x[:2, :, 6:8])
    assert sharding.spec_axes(spec) == {"stage", "data", "model"}
