"""Generation modes for the paged decode engine: host-side policy over
the fetched logits and the block tables. The programs stay the same
fixed-shape ones in every mode:

* ``sampling`` — temperature/top-k/top-p on a committed threefry stream
  keyed by (request seed, absolute token index);
* ``beam`` — beam search as copy-on-write forks over the paged block
  arena: beams are slots in the shared decode batch;
* ``grammar`` — regex / JSON schema compiled on the host to per-state
  ``[V]`` logits masks, fed as data through the ``DEC_MASK`` feed.
"""

from paddle_tpu_torch.serving.decode.generate.beam import (
    BeamParams,
    offline_beam_decode,
)
from paddle_tpu_torch.serving.decode.generate.grammar import (
    CompiledGrammar,
    GrammarConstraint,
    compile_regex,
    json_schema_regex,
)
from paddle_tpu_torch.serving.decode.generate.sampling import (
    SamplingParams,
    filtered_scores,
    gumbel_vector,
    sample_token,
)

__all__ = ["BeamParams", "CompiledGrammar", "GrammarConstraint",
           "SamplingParams", "compile_regex", "filtered_scores",
           "gumbel_vector", "json_schema_regex", "offline_beam_decode",
           "sample_token"]
