"""DataFeeder: convert user samples into feed dicts of batched numpy arrays.

Reference: python/paddle/fluid/data_feeder.py — DataFeeder.feed converts a
list of samples (one tuple per sample, one entry per feed var) into
LoDTensors. Here the target is dense numpy arrays (the executor, or the
DataLoader's prefetcher, moves them to the card); ragged sequence data
should be pre-padded or fed with segment ids. The port's copy of the JAX
package's ``data_feeder.py``: the same arrays and the same
variable-named errors.

Mismatched feeds fail HERE, by name: a batch whose dtype cannot be
safely cast to the feed var's, or whose per-sample shape disagrees with
the declaration, raises a ValueError naming the variable and the
expected vs actual dtype/shape — instead of surfacing as an opaque
lowering error three layers down (the reference's check_feed_shape_type
plays the same role, data_feeder.py:109).
"""

import numpy as np

from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.utils.enforce import enforce

__all__ = ["DataFeeder", "check_feed_array"]


def to_numpy_dtype(dtype):
    return np.dtype(convert_dtype(dtype))


def _shape_str(shape):
    return "[" + ", ".join(str(d) for d in shape) + "]"


def check_feed_array(name, value, dtype, shape):
    """Validate one BATCHED array against its feed var declaration.

    Returns the (possibly cast/reshaped) array. Within-kind casts
    (float64 -> float32) and value-preserving promotions (int32 ->
    int64, int32 -> float64) happen silently; anything cross-kind lossy
    (int64 -> float32, float -> int, object/str -> number) raises naming
    the variable. (The per-sample DataFeeder.feed path is additionally
    lenient on int -> float of any width — python scalars and lists
    carry incidental int64.) Declared trailing dims that are fully known
    must match by element count — compatible flat feeds are reshaped,
    true mismatches raise."""
    want = np.dtype(to_numpy_dtype(dtype)) if dtype is not None else None
    arr = np.asarray(value)
    if want is not None and arr.dtype != want:
        # within-kind casts (float64->float32) and value-preserving
        # promotions (int32->int64, int32->float64) stay silent; a
        # cross-kind lossy cast (int64->float32, float->int, str->any)
        # is a feed bug and fails by name
        castable = arr.dtype.kind not in "OUS" and (
            (arr.dtype.kind == want.kind
             and np.can_cast(arr.dtype, want, casting="same_kind"))
            or np.can_cast(arr.dtype, want, casting="safe")
        )
        if not castable:
            raise ValueError(
                f"feed variable '{name}': dtype mismatch — expected "
                f"{want.name}, got {arr.dtype.name} "
                f"(batch shape {tuple(arr.shape)})"
            )
        arr = arr.astype(want)
    trailing = list(shape[1:]) if shape else []
    if trailing and all(isinstance(d, int) and d > 0 for d in trailing):
        declared_n = int(np.prod(trailing))
        got = list(arr.shape[1:])
        got_n = int(np.prod(got)) if got else 1
        if got_n != declared_n:
            raise ValueError(
                f"feed variable '{name}': shape mismatch — expected "
                f"{_shape_str(['batch'] + trailing)} "
                f"({declared_n} elements per sample), got "
                f"{_shape_str(list(arr.shape))} ({got_n} elements per "
                "sample)"
            )
        if got != trailing:
            arr = arr.reshape([arr.shape[0]] + trailing)
    return arr


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        from paddle_tpu_torch.core.ir import Variable, default_main_program

        program = program or default_main_program()
        self.feed_names = []
        self.feed_dtypes = []
        self.feed_shapes = []
        for v in feed_list:
            if isinstance(v, str):
                v = program.global_block().var(v)
            enforce(isinstance(v, Variable), f"feed_list entry {v!r} invalid")
            self.feed_names.append(v.name)
            self.feed_dtypes.append(v.dtype)
            self.feed_shapes.append(v.shape)
        self.place = place

    def feed(self, iterable):
        """iterable: list of samples; each sample is a tuple/list with one
        entry per feed var. Returns {name: batched ndarray}."""
        columns = [[] for _ in self.feed_names]
        for sample in iterable:
            enforce(
                len(sample) == len(self.feed_names),
                f"sample has {len(sample)} fields, expected "
                f"{len(self.feed_names)} ({self.feed_names})",
            )
            for c, v in zip(columns, sample):
                c.append(v)
        out = {}
        for name, dtype, shape, col in zip(
            self.feed_names, self.feed_dtypes, self.feed_shapes, columns
        ):
            want = np.dtype(to_numpy_dtype(dtype))
            converted = []
            for i, v in enumerate(col):
                try:
                    actual = np.asarray(v)
                except (ValueError, TypeError) as e:  # ragged nested list
                    raise ValueError(
                        f"feed variable '{name}': sample {i} is not a "
                        f"rectangular array ({e})"
                    ) from e
                # the per-sample path stays lenient on int->float (python
                # scalars/lists carry incidental int64), but float->int
                # TRUNCATES values — that is a feed bug, not a cast
                if actual.dtype.kind in "fc" and want.kind in "iub":
                    raise ValueError(
                        f"feed variable '{name}': dtype mismatch — "
                        f"expected {want.name}, sample {i} is "
                        f"{actual.dtype.name} (float->int feeds truncate; "
                        "cast explicitly if intended)"
                    )
                try:
                    converted.append(actual.astype(want, copy=False))
                except (ValueError, TypeError) as e:
                    raise ValueError(
                        f"feed variable '{name}': sample {i} cannot be "
                        f"converted to {want.name} (got dtype "
                        f"{actual.dtype.name}, shape "
                        f"{tuple(actual.shape)}): {e}"
                    ) from e
            try:
                arr = np.stack(converted)
            except ValueError as e:
                shapes = sorted({tuple(a.shape) for a in converted})
                raise ValueError(
                    f"feed variable '{name}': samples have inconsistent "
                    f"shapes {shapes[:4]} — pad ragged sequences before "
                    f"feeding ({e})"
                ) from e
            # validate + reshape flat samples to the declared trailing
            # shape; a true element-count mismatch raises by name
            out[name] = check_feed_array(name, arr, dtype, shape)
        return out
