"""Input helpers: the ``sparse_batch`` transform (``sparse.py``) and the
checkpointable iterator state (``state.py``) that ``AutoCheckpoint``
records."""

from paddle_tpu_torch.dataio.sparse import make_sparse_batch_transform, pad_slot
from paddle_tpu_torch.dataio.state import (
    STATE_KEY,
    IteratorState,
    decode_state,
    elastic_resume,
    encode_state,
)

__all__ = ["make_sparse_batch_transform", "pad_slot", "STATE_KEY",
           "IteratorState", "decode_state", "elastic_resume", "encode_state"]
