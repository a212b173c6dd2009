"""Input helpers: the ``sparse_batch`` transform (``sparse.py``)."""

from paddle_tpu_torch.dataio.sparse import make_sparse_batch_transform, pad_slot

__all__ = ["make_sparse_batch_transform", "pad_slot"]
