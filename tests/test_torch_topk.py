"""The blocked top-k of |x| (K7's function, ``kernels/topk.py``) in the
PyTorch port against the JAX package on the CPU, bit for bit.

Inputs come from a numpy seed: vectors over and under the block (small
``block`` values, so the blocked path runs on small inputs), n not a
multiple of the block, planted ties (values drawn from a few levels, both
signs), zeros and -0.0, and k > block. Checks, values and indices equal:

* the port's function (through its plain per-block stage, the CPU path)
  against JAX ``blocked_topk_abs(..., interpret=True)``, called directly
  (outside ``shard_map``, so the Pallas kernel runs in interpret mode
  wherever the JAX function takes its blocked path); the Pallas body
  cannot take k > block, so those cases are held against ``lax.top_k``
  alone;
* the same against ``lax.top_k(|x|, k)``: descending value, ties by lower
  index;
* the plain per-block stage against a numpy reference: each block's top
  ``min(k, block)`` (pad lanes -1) in index order;
* at the DGC path's shapes scaled down: 2 and 8 blocks (a sparse
  Transformer-base step's [262144] and [1048576] over 131072-element
  blocks) at k/n about 0.004 and 0.001 (sparsity 0.996 and 0.999), with
  blocks of 512 and 1024.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.topk import blocked_topk_abs as jax_blocked
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import topk

# (n, k, block): blocked (n > 2k and n > block), with ragged last blocks;
# n <= block and n <= 2k take the exact path; k > block
CASES = [
    (1000, 10, 128), (1000, 40, 128), (1023, 7, 64), (4096, 100, 512),
    (100, 10, 128), (1000, 300, 128), (1000, 200, 64), (5000, 300, 256),
]


def _vector(n, kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "normal":
        return rng.randn(n).astype(np.float32)
    if kind == "ties":
        # few magnitudes, both signs: ties across and within blocks
        return (rng.randint(0, 5, n) * rng.choice([-1, 1], n) / 4.0).astype(
            np.float32)
    x = rng.randn(n).astype(np.float32)          # zeros and -0.0
    x[rng.rand(n) < 0.3] = 0.0
    x[rng.rand(n) < 0.3] = -0.0
    return x


def _port(x, k, block):
    vals, idx = topk.blocked_topk_abs(torch.from_numpy(x), k, block)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    return vals.numpy(), idx.numpy()


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("n,k,block", CASES)
def test_matches_jax_and_lax_top_k(n, k, block, kind):
    x = _vector(n, kind, n + k + block)
    vals, idx = _port(x, k, block)
    want_v, want_i = jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)
    np.testing.assert_array_equal(vals, np.asarray(want_v))
    np.testing.assert_array_equal(idx, np.asarray(want_i))
    np.testing.assert_array_equal(np.abs(x)[idx], vals)
    if k <= block:
        jv, ji = jax_blocked(jnp.asarray(x), k, block=block, interpret=True)
        np.testing.assert_array_equal(vals, np.asarray(jv))
        np.testing.assert_array_equal(idx, np.asarray(ji))


@pytest.mark.parametrize("n,k,block", [(1000, 10, 128), (1000, 200, 64),
                                       (300, 300, 64)])
def test_stage_is_each_blocks_top_k_in_index_order(n, k, block):
    x = _vector(n, "ties", 7)
    vals, idx = topk.blocked_topk_stage_plain(torch.from_numpy(x), k, block)
    nb, kk = -(-n // block), min(k, block)
    padded = np.full(nb * block, -1.0, np.float32)
    padded[:n] = np.abs(x)
    want_v, want_i = [], []
    for b in range(nb):
        row = padded[b * block:(b + 1) * block]
        chosen = np.sort(np.argsort(-row, kind="stable")[:kk])
        want_v.append(row[chosen])
        want_i.append(chosen + b * block)
    np.testing.assert_array_equal(vals.numpy(), np.concatenate(want_v))
    np.testing.assert_array_equal(idx.numpy(), np.concatenate(want_i))


# (blocks, block, k): n = blocks * block, k / n about 0.004 or 0.001
PATH_CASES = [(2, 512, 4), (2, 1024, 8), (8, 512, 16), (8, 1024, 33),
              (2, 1024, 2), (8, 1024, 8)]


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("blocks,block,k", PATH_CASES)
def test_path_ratios_match_jax(blocks, block, k, kind):
    n = blocks * block
    x = _vector(n, kind, 11 * n + k)
    vals, idx = _port(x, k, block)
    jv, ji = jax_blocked(jnp.asarray(x), k, block=block, interpret=True)
    np.testing.assert_array_equal(vals, np.asarray(jv))
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_array_equal(np.abs(x)[idx], vals)


@pytest.mark.parametrize("blocks,want", [
    (1, [1, 1, 1, 2, 5, 8, 16, 16]), (8, [1, 1, 1, 2, 5, 8, 16, 16]),
    (9, [1, 1, 1, 2, 5, 8, 8, 8]), (145, [1, 1, 1, 2, 5, 8, 8, 8])])
def test_cluster_size_follows_the_block_and_the_call(blocks, want):
    # one CTA per 1024 elements; at most 16 for a call over 8 blocks or
    # fewer, else at most the portable 8
    assert [topk.cluster_size(b, blocks) for b in (
        1, 64, 1000, 1025, 4099, 8192, topk.DEFAULT_BLOCK, 10**6)] == want


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x = torch.from_numpy(_vector(2000, "normal", 3))
    kernels.reset_launches()
    got = topk.blocked_topk_abs(x, 50, 256)
    want = topk.blocked_topk_abs_plain(x, 50, 256)
    assert kernels.launches("blocked_topk_abs") == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bad_arguments_raise():
    x = torch.zeros(10)
    with pytest.raises(ValueError, match="1-D"):
        topk.blocked_topk_abs(x.reshape(2, 5), 1)
    with pytest.raises(ValueError, match="outside"):
        topk.blocked_topk_abs(x, 11)
    with pytest.raises(ValueError, match="block"):
        topk.blocked_topk_abs(x, 1, block=0)
