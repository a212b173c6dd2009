"""The ``DevicePrefetcher`` on the card (``paddle_tpu_torch/dataio/
prefetch.py``): its copies run on a side stream from pinned buffers while
the consumer's step runs, so these check that overlap is safe:

* a step that overwrites its inputs in place, queued behind a long
  kernel: every batch the consumer gets holds its source's values (no
  batch is read before its copy is done, and no pinned buffer is
  refilled while its copy still reads it);
* a tensor the consumer drops while a queued kernel still reads it is
  not handed to the side stream's next copy (``record_stream``);
* placement: the host keys stay numpy arrays, the rest are CUDA tensors
  of the ``specs`` dtypes; a rank stages its rows.

Marked ``cuda``: it skips without a card and runs on one with

    python -m pytest --noconftest -m cuda tests/test_torch_data_cuda.py -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.dataio import DevicePrefetcher

pytestmark = pytest.mark.cuda

SHAPE = (1024, 1024)         # 4 MiB a batch: a copy takes visible time


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _batches(n):
    for i in range(n):
        yield {"x": np.full(SHAPE, float(i), np.float32),
               "ids": np.arange(4, dtype=np.int64) + i}


def test_a_step_that_overwrites_its_inputs_sees_every_batch_whole(card):
    n = 24
    seen = []
    for batch in DevicePrefetcher(_batches(n), depth=3, device=card,
                                  host_keys={"ids"}):
        x = batch["x"]
        # a long kernel ahead of the step: the producer stages the next
        # batches meanwhile
        torch.cuda._sleep(2_000_000)
        seen.append(x.sum())          # queued: reads x after the sleep
        x.mul_(-1.0)                  # the step overwrites its input
        assert isinstance(batch["ids"], np.ndarray)
    torch.cuda.synchronize()
    got = [float(s) for s in seen]
    assert got == [float(i) * SHAPE[0] * SHAPE[1] for i in range(n)]


def test_a_dropped_tensor_is_not_reused_by_the_next_copy(card):
    n = 16
    outs = []
    it = iter(DevicePrefetcher(_batches(n), depth=2, device=card))
    for i in range(n):
        batch = next(it)
        torch.cuda._sleep(3_000_000)
        outs.append(batch["x"] * 2.0)   # queued behind the sleep
        del batch                       # the host drops it at once
    torch.cuda.synchronize()
    for i, y in enumerate(outs):
        assert float(y.min()) == float(y.max()) == 2.0 * i, i


def test_placement_cast_and_a_ranks_rows(card):
    feeds = [{"x": np.arange(24, dtype=np.float64).reshape(8, 3),
              "y": np.arange(8, dtype=np.int32),
              "ids": np.arange(8, dtype=np.int64)}]
    specs = {"x": ("float32", [-1, 3]), "y": ("int64", [-1])}
    (whole,) = list(DevicePrefetcher(iter(feeds), device=card,
                                     host_keys={"ids"}, specs=specs))
    assert whole["x"].is_cuda and whole["x"].dtype == torch.float32
    assert whole["y"].is_cuda and whole["y"].dtype == torch.int64
    assert isinstance(whole["ids"], np.ndarray)
    (r1,) = list(DevicePrefetcher(iter(feeds), device=card, rank=1, world=2,
                                  specs=specs))
    np.testing.assert_array_equal(r1["x"].cpu().numpy(), feeds[0]["x"][4:])
    np.testing.assert_array_equal(r1["y"].cpu().numpy(), feeds[0]["y"][4:])
