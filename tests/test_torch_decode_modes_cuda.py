"""Speculative decoding with draft-KV proposals on the card: every
proposal is one ``[S, 1]`` decode step of the draft entry, whose
attention launches the paged-attention kernel (K3), and the output
equals the target's ``offline_decode`` bit for bit (the verify forward and
the offline reference run the same prefill program at the same shapes).
Marked ``cuda``: it skips without a card and runs on one with

    python -m pytest -m cuda tests/test_torch_decode_modes_cuda.py -q
"""

import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.serving.decode import GenerationEngine
from paddle_tpu_torch.serving.decode import build_decoder_model

pytestmark = pytest.mark.cuda

GEOM = dict(vocab_size=64, hidden=64, num_layers=2, slots=4, max_len=64,
            block_size=8)


@pytest.fixture
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = GenerationEngine(seed=3)            # CUDAPlace(0)
    yield eng
    eng.shutdown()


def test_draft_kv_proposals_launch_k3_on_the_draft(engine):
    tgt = engine.register_model(build_decoder_model(**GEOM, name="t"))
    engine.register_model(build_decoder_model(**dict(GEOM, num_layers=1),
                                              name="d"))
    prompt = [5, 17, 2, 40, 33, 8, 1, 60, 12]
    ref = tgt.offline_decode(prompt, 20)
    engine.start()
    kernels.reset_launches()
    out = engine.submit(prompt, model="t", max_new_tokens=20,
                        draft_model="d", spec_k=4).result(timeout=300)
    launches = kernels.launches("paged_attention")
    st = tgt.stats()
    assert [int(t) for t in out["tokens"]] == ref
    assert st["spec_draft_kv_prefills"] == 1
    assert st["spec_draft_kv_fallbacks"] == 0
    assert st["spec_draft_kv_steps"] > 0
    # the target ran no decode step: every launch is a draft step's, one
    # a step for the draft's one layer
    assert st.get("steps", 0) == 0
    assert launches == st["spec_draft_kv_steps"]
