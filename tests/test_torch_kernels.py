"""The port's decode-attention wrappers on CPU tensors (their plain
PyTorch versions) against the JAX package's composites and its Pallas
kernels in interpret mode, as tests/test_kernels.py runs them.

Inputs cover masked tails, a fully masked (retired) slot, and arena rows
shared between slots. Agreement is within rtol=atol=1e-6 (float32 sums
in another order). The CUDA kernel itself runs only on the card; chip_smoke.py
holds it against the same plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import attention as jax_attention
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import attention as torch_attention

S, L, H, R = 4, 8, 16, 40
SCALE = 1.0 / np.sqrt(H)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H).astype(np.float32)
    ka = rng.randn(R, H).astype(np.float32)
    va = rng.randn(R, H).astype(np.float32)
    # slots 0 and 1 share their first four rows; slot 3 is retired
    rows = rng.randint(0, R, size=(S, L)).astype(np.int64)
    rows[1, :4] = rows[0, :4]
    bias = np.full((S, 1, L), -1e9, np.float32)
    for s, cursor in enumerate([2, 7, 0]):
        bias[s, 0, :cursor + 1] = 0.0
    kc = rng.randn(S, L, H).astype(np.float32)
    vc = rng.randn(S, L, H).astype(np.float32)
    return q, ka, va, rows.reshape(-1), bias, kc, vc


def _t(a):
    return torch.from_numpy(a.copy())


@pytest.fixture(autouse=True)
def _zero_counters():
    kernels.reset_launches()
    yield
    kernels.reset_launches()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("reference", ["composite", "pallas_interpret"])
def test_paged_attention_plain_matches_jax(seed, reference):
    q, ka, va, rows, bias, _, _ = _inputs(seed)
    args = (jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va),
            jnp.asarray(rows), jnp.asarray(bias), S, L, SCALE)
    if reference == "composite":
        want = jax_attention.paged_attention_composite(*args)
    else:
        want = jax_attention.paged_attention(*args, interpret=True)
    got = torch_attention.paged_attention(_t(q), _t(ka), _t(va), _t(rows),
                                          _t(bias), S, L, SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    assert kernels.launches("paged_attention") == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("reference", ["composite", "pallas_interpret"])
def test_decode_attention_plain_matches_jax(seed, reference):
    q, _, _, _, bias, kc, vc = _inputs(seed)
    args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(bias), SCALE)
    if reference == "composite":
        want = jax_attention.cached_attention_composite(*args)
    else:
        want = jax_attention.decode_attention(*args, interpret=True)
    got = torch_attention.decode_attention(_t(q), _t(kc), _t(vc), _t(bias),
                                           SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    assert kernels.launches("decode_attention") == 0


def test_retired_slot_is_uniform_average_and_masked_rows_vanish():
    q, ka, va, rows, bias, _, _ = _inputs(3)
    got = torch_attention.paged_attention(_t(q), _t(ka), _t(va), _t(rows),
                                          _t(bias), S, L, SCALE).numpy()
    r = rows.reshape(S, L)
    np.testing.assert_allclose(got[3], va[r[3]].mean(axis=0),
                               rtol=1e-5, atol=1e-6)
    # slot 0 sees positions 0..2 only: poisoning its masked rows changes
    # nothing
    va2 = va.copy()
    masked = [row for row in r[0, 3:] if row not in r[0, :3]]
    va2[masked] = 1e6
    got2 = torch_attention.paged_attention(_t(q), _t(ka), _t(va2), _t(rows),
                                           _t(bias), S, L, SCALE).numpy()
    np.testing.assert_array_equal(got2[0], got[0])


@pytest.mark.parametrize("length", [1, 17, 1024, 8192])
@pytest.mark.parametrize("seqs", [1, 8, 64])
def test_split_plan_covers_every_position_within_the_kernels_limits(seqs,
                                                                     length):
    """The plan is a host-side function of (slots, positions, SMs): its
    chunks cover every position with no chunk left empty, it stays within
    what the C entry point takes (an even chunk of at most 8192 positions,
    at most 65535 chunks a slot), gives the card's 132 SMs work, and the
    scratch the wrapper allocates holds a partial a chunk plus a counter a
    slot."""
    sms = 132
    chunk, n_split = torch_attention.split_plan(seqs, length, sms)
    assert chunk > 0 and chunk % 2 == 0 and chunk <= 8192
    assert 0 < n_split <= 65535
    assert n_split * chunk >= length > (n_split - 1) * chunk
    blocks = seqs * n_split
    assert blocks >= min(sms, seqs * -(-length // 16))
    assert blocks <= 4 * sms or chunk == 16
    assert torch_attention.split_plan(seqs, length, sms) == (chunk, n_split)
    acc, ml = torch_attention.scratch_sizes(seqs, n_split, H)
    assert (acc, ml) == (seqs * n_split * H, seqs * n_split * 2 + seqs)


@pytest.mark.parametrize("bad_row", [-1, R])
def test_plain_paged_attention_raises_on_a_row_outside_the_arena(bad_row):
    q, ka, va, rows, bias, _, _ = _inputs(5)
    rows = rows.copy()
    rows[3] = bad_row
    with pytest.raises(IndexError):
        torch_attention.paged_attention(_t(q), _t(ka), _t(va), _t(rows),
                                        _t(bias), S, L, SCALE)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    q, ka, va, rows, bias, kc, vc = _inputs(4)
    with kernels.scoped_mode("auto"):
        torch_attention.paged_attention(_t(q), _t(ka), _t(va), _t(rows),
                                        _t(bias), S, L, SCALE)
        torch_attention.decode_attention(_t(q), _t(kc), _t(vc), _t(bias),
                                         SCALE)
    assert kernels.launches() == {name: 0 for name in kernels.KERNELS}


def test_kernel_mode_rejects_unknown_values(monkeypatch):
    monkeypatch.setenv(kernels.registry.MODE_ENV, "interpret")
    with pytest.raises(ValueError, match="unknown mode"):
        kernels.mode()
    monkeypatch.setenv(kernels.registry.MODE_ENV, "off")
    assert kernels.mode() == "off"
    with kernels.scoped_mode("auto"):
        assert kernels.mode() == "auto"


def test_kernel_table_names_sources_in_the_repo():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    for name, info in kernels.KERNELS.items():
        assert (root / info.source).is_file(), name
        if name.startswith("threefry"):
            # K8 replaces the code XLA generates for jax.random
            assert info.replaces == ("XLA's threefry2x32 under jax.random "
                                     "(no Pallas kernel)"), name
            continue
        path, line = info.replaces.rsplit(":", 1)
        text = (root / path).read_text().splitlines()
        assert "pallas_call" in text[int(line) - 1], (name, info.replaces)
