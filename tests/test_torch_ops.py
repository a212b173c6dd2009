"""Op lowerings of the PyTorch port against the JAX package's, one case per
op type the port lowers: the same numpy inputs go through
``paddle_tpu.core.registry.OpRegistry.get(t).lower`` and the port's
``paddle_tpu_torch.core.registry.OpRegistry.get(t).lower``.

The ``c_*`` collectives run outside a bound ring, where both are
identities. Float results agree within rtol=atol=1e-6 (float32 sums in another
order: torch's CPU matmul vs XLA's); integer results and every shape
agree exactly. A stateful op gets the same key in both (``PRNGKey(0)``),
so ``uniform_random`` gives ``jax.random``'s bits: it is held equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu_torch  # noqa: F401  (registers the port's lowerings)
from paddle_tpu.core.registry import OpRegistry as JaxOps
from paddle_tpu_torch.core.registry import OpRegistry as TorchOps

R = np.random.RandomState(7)


def f32(*shape):
    return R.randn(*shape).astype(np.float32)


def _bias(seqs, length, cursors):
    b = np.full((seqs, 1, length), -1e9, np.float32)
    for s, c in enumerate(cursors):
        if c is not None:
            b[s, 0, :c + 1] = 0.0
    return b


# op type -> (inputs {slot: [np arrays]}, attrs)
CASES = {
    "lookup_table_v2": ({"W": [f32(10, 4)],
                         "Ids": [np.array([[1, 2], [9, 2], [0, 5]], np.int64)]},
                        {"padding_idx": 2}),
    "elementwise_add": ({"X": [f32(2, 3, 4)], "Y": [f32(3)]}, {"axis": 1}),
    "mul": ({"X": [f32(2, 3, 4)], "Y": [f32(4, 5)]},
            {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "relu": ({"X": [f32(3, 4)]}, {}),
    "squeeze2": ({"X": [f32(3, 1, 4)]}, {"axes": [1]}),
    "unsqueeze2": ({"X": [f32(3, 4)]}, {"axes": [0, 2]}),
    # ids 6 and 9 are >= R (dropped); -1 counts from the end
    "scatter": ({"X": [f32(6, 3)],
                 "Ids": [np.array([1, 6, 4, 9, -1], np.int64)],
                 "Updates": [f32(5, 3)]},
                {"overwrite": True, "mode": "drop"}),
    "assign": ({"X": [f32(4, 2)]}, {}),
    "paged_attention": ({"Q": [f32(3, 8)], "KArena": [f32(12, 8)],
                         "VArena": [f32(12, 8)],
                         "Rows": [np.array([0, 1, 2, 3, 0, 1, 7, 9,
                                            11, 10, 4, 5], np.int64)],
                         "Bias": [_bias(3, 4, [1, 3, None])]},
                        {"sm_scale": 0.35, "seqs": 3, "length": 4}),
    "matmul": ({"X": [f32(2, 3, 4)], "Y": [f32(2, 5, 4)]},
               {"transpose_X": False, "transpose_Y": True, "alpha": 0.5}),
    "softmax": ({"X": [f32(2, 5) * 4]}, {"axis": -1}),
    "fill_constant": ({}, {"shape": [2, 3], "dtype": "float32",
                           "value": 1.5}),
    "uniform_random": ({}, {"shape": [64, 32], "dtype": "float32",
                            "min": -0.25, "max": 0.25, "seed": 0}),
    "gather": ({"X": [f32(6, 3)], "Index": [np.array([5, 0, 0, 2], np.int64)]},
               {"axis": 0}),
    "reshape2": ({"X": [f32(2, 6)]}, {"shape": [0, 3, -1]}),
    "cached_attention": ({"Q": [f32(3, 8)], "KCache": [f32(3, 4, 8)],
                          "VCache": [f32(3, 4, 8)],
                          "Bias": [_bias(3, 4, [0, 2, None])]},
                         {"sm_scale": 0.35}),
    # the inference fusions' targets (fc_fuse, multihead_matmul_fuse's
    # reshape of a [B, 1, 1, S] bias)
    "fc": ({"Input": [f32(2, 3, 4)], "W": [f32(4, 5)], "Bias": [f32(5)]},
           {"in_num_col_dims": 2, "activation_type": "gelu"}),
    "reshape": ({"X": [f32(2, 1, 1, 6)]}, {"shape": [0, 6]}),
    # packed q|k|v of 2 heads of width 4, no BiasQK: the flash path
    "multihead_matmul": ({"Input": [f32(2, 5, 24)], "Bias": [f32(24)]},
                         {"head_number": 2, "alpha": 0.5}),
}
# the c_* collectives outside a bound ring: identities in both (inside a
# ring: tests/test_torch_fleet_collective.py, on 2 ranks)
CASES.update({
    t: ({"X": [f32(4, 3)]}, {"ring_id": 0})
    for t in ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
              "c_allreduce_prod", "c_allgather", "c_broadcast",
              "c_reducescatter", "c_sync_calc_stream", "c_sync_comm_stream")
})


def _run_jax(op_type, ins, attrs):
    jins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}
    if JaxOps.get(op_type).stateful:
        jins["__rng_key__"] = [jax.random.PRNGKey(0)]
    out = JaxOps.get(op_type).lower(jins, dict(attrs))
    return {k: [np.asarray(a) for a in (v if isinstance(v, (list, tuple)) else [v])]
            for k, v in out.items()}


def _run_torch(op_type, ins, attrs):
    op_def = TorchOps.get(op_type)
    tins = {k: [torch.from_numpy(a.copy()) for a in v] for k, v in ins.items()}
    if op_def.stateful:
        tins["__rng_key__"] = [(0, 0)]       # jax.random.PRNGKey(0)
    if op_def.creates:
        tins["__device__"] = [torch.device("cpu")]
    out = op_def.lower(tins, dict(attrs))
    return {k: [t.numpy() for t in v] for k, v in out.items()}


def test_cases_cover_every_ported_op_type():
    from test_torch_amp import CASES as AMP_CASES
    from test_torch_control_flow import CASES as CONTROL_FLOW_CASES
    from test_torch_conv import CASES as CONV_CASES
    from test_torch_ctr import CASES as CTR_CASES
    from test_torch_hybrid import CASES as HYBRID_CASES
    from test_torch_ps_ctr import CASES as PS_CASES
    from test_torch_random import CASES as RANDOM_CASES
    from test_torch_train_ops import CASES as TRAIN_CASES
    from test_torch_transformer import CASES as DGC_CASES

    assert sorted(set(CASES) | set(TRAIN_CASES) | set(CTR_CASES)
                  | set(PS_CASES) | set(DGC_CASES) | set(RANDOM_CASES)
                  | set(CONV_CASES) | set(AMP_CASES) | set(HYBRID_CASES)
                  | {op for op, _, _ in CONTROL_FLOW_CASES.values()}
                  ) == TorchOps.all_types()


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_op_matches_jax_lowering(op_type):
    ins, attrs = CASES[op_type]
    want = _run_jax(op_type, ins, attrs)
    got = _run_torch(op_type, ins, attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        for w, g in zip(want[slot], got[slot]):
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            if slot == "XShape":
                continue            # a shape record: only its shape matters
            if op_type == "uniform_random":
                assert g.dtype == np.float32
                np.testing.assert_array_equal(g, w)
                continue
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("form", ["bias_qk", "kernel_lowering"])
def test_multihead_matmul_forms_match_jax(form):
    """The full ``[B, H, S, S]`` BiasQK form (the composite, in both
    packages), and the op's kernel lowering, which on CPU tensors runs
    K1's plain version."""
    ins, attrs = CASES["multihead_matmul"]
    if form == "bias_qk":
        ins = dict(ins, BiasQK=[f32(2, 2, 5, 5)])
    want = _run_jax("multihead_matmul", ins, attrs)["Out"][0]
    op_def = TorchOps.get("multihead_matmul")
    lower = op_def.lower if form == "bias_qk" else op_def.kernel
    tins = {k: [torch.from_numpy(a.copy()) for a in v] for k, v in ins.items()}
    got = lower(tins, dict(attrs))["Out"][0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_scatter_in_place_writes_into_x():
    """``_inplace`` (set by the executor's plan) updates X's own tensor and
    returns it; without it X is untouched."""
    x = torch.zeros(4, 2)
    ids = torch.tensor([0, 4, 2])
    upd = torch.ones(3, 2)
    scatter = TorchOps.get("scatter").lower
    out = scatter({"X": [x], "Ids": [ids], "Updates": [upd]},
                  {"overwrite": True, "mode": "drop"})["Out"][0]
    assert out is not x and float(x.sum()) == 0.0
    out = scatter({"X": [x], "Ids": [ids], "Updates": [upd]},
                  {"overwrite": True, "mode": "drop", "_inplace": True})["Out"][0]
    assert out is x
    np.testing.assert_array_equal(x.numpy()[:, 0], [1, 0, 1, 0])
