"""The port's fleet on the card: two worker processes
(``python -m paddle_tpu_torch.serving.fleet.worker``, ``--device cuda``)
sharing one card at a small width, one of them killed mid-traffic by its
``replica.kill`` schedule:

* the victim exits with 43 and is latched dead; the survivor does not
  notice (its context is its own) and serves everything re-dispatched;
* every stream equals ``offline_decode`` of an in-process entry on the
  card, or parts from it only at a near-tie (a re-dispatched request
  decodes in another slot mix, and cuBLAS picks its GEMM by the row
  count): the offline top-2 gap at the first divergence below 1e-4 of
  the largest |logit|, ``chip_smoke.py``'s phase 3 rule;
* the survivor's ``stats`` RPC counts K3 (``paged_attention``) launches,
  one a layer a decode step, and K8 (``threefry_random_bits``) launches
  from its startup.

Marked ``cuda``: it skips without a card and runs on one with

    python -m pytest --noconftest -m cuda tests/test_torch_fleet_cuda.py -q
"""

import json
import random

import pytest
import torch

from paddle_tpu_torch.serving.decode import GenerationEngine, build_decoder_model
from paddle_tpu_torch.serving.fleet import FleetRouter, SubprocessReplica

pytestmark = pytest.mark.cuda

GEOM = dict(vocab_size=64, hidden=64, num_layers=2, slots=4, max_len=64,
            block_size=8)
NEAR_TIE = 1e-4
TIMEOUT = 300


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _near_tie_or_equal(entry, prompt, got, want):
    for t, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        toks = list(prompt) + list(want[:t])
        row = entry.prefill_logits(toks)[len(toks) - 1]
        top2 = torch.topk(row, 2).values
        gap = float(top2[0] - top2[1])
        assert gap < NEAR_TIE * float(row.abs().max()), (
            f"tokens part from offline_decode at step {t} with a clear "
            f"top-2 gap {gap}")
        return
    assert len(got) == len(want)


def test_two_workers_on_the_card_one_killed(card):
    spec = {**GEOM, "name": "fleet_cuda", "version": "1"}
    kill = json.dumps([{"site": "replica.kill", "action": "kill",
                        "at_call": 8, "rank": 1, "id": "cuda-kill"}])
    rng = random.Random(4)
    prompts = [[rng.randrange(GEOM["vocab_size"])
                for _ in range(rng.randrange(2, 30))] for _ in range(12)]
    entry = GenerationEngine().register_model(build_decoder_model(**spec))
    refs = [[int(t) for t in entry.offline_decode(p, 8)] for p in prompts]
    r0 = SubprocessReplica.spawn("r0", 0, spec, startup_timeout=TIMEOUT)
    r1 = None
    router = FleetRouter(health_interval_s=0.02)
    try:
        r1 = SubprocessReplica.spawn("r1", 1, spec, startup_timeout=TIMEOUT,
                                     extra_env={"PADDLE_TPU_FAULTS": kill})
        assert r0._meta["device"].startswith("cuda")
        router.add_replica(r0)
        router.add_replica(r1)
        router.start()
        resps = [router.submit(p, max_new_tokens=8) for p in prompts]
        outs = [[int(t) for t in r.result(timeout=TIMEOUT)["tokens"]]
                for r in resps]
        assert r1.proc.wait(timeout=60) == 43
        st = router.stats()
        assert st["accepted"] == st["completed"] == len(prompts)
        assert st["replica_deaths"] == 1
        assert st["replicas"]["r1"]["state"] == "dead"
        for p, got, want in zip(prompts, outs, refs):
            _near_tie_or_equal(entry, p, got, want)
        ws = r0.worker_stats()
        steps = ws["models"]["fleet_cuda@1"]["steps"]
        launches = ws["kernel_launches"]
        assert steps > 0
        assert launches["paged_attention"] == GEOM["num_layers"] * steps
        assert launches["threefry_random_bits"] > 0
    finally:
        router.shutdown()
        for h in (r0, r1):
            if h is not None:
                h.kill()
                h.close(30)
