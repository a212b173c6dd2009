"""Generation modes for the paged decode engine: host-side policy over
the fetched logits. The port serves committed-stream sampling
(``sampling``); beam search and grammar constraints are not ported yet
(ROADMAP.md, M4) and ``submit`` refuses them."""

from paddle_tpu_torch.serving.decode.generate.sampling import (
    SamplingParams,
    filtered_scores,
    gumbel_vector,
    sample_token,
)

__all__ = ["SamplingParams", "filtered_scores", "gumbel_vector",
           "sample_token"]
