"""Variable type taxonomy and dtype conversion.

Mirrors the surface of the reference's VarType proto
(reference: paddle/fluid/framework/framework.proto:104) mapped onto numpy
and torch dtypes. The IR keeps canonical dtype *names* ("float32",
"int64", ...); ``to_torch_dtype`` is the one place they become torch
dtypes.

Index tensors stay int64 here. The JAX package runs with 64-bit types
off, so its int64 feeds become int32 on the device; torch indexes with
int64 natively, so the port keeps the declared type and only the bytes
of index feeds differ between the two packages.
"""

import numpy as np
import torch


class VarType:
    # tensor element types
    BOOL = "bool"
    INT8 = "int8"
    UINT8 = "uint8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FP16 = "float16"
    BF16 = "bfloat16"
    FP32 = "float32"
    FP64 = "float64"
    # variable kinds (reference framework.proto:122-140)
    DENSE_TENSOR = "dense_tensor"
    SELECTED_ROWS = "selected_rows"
    READER = "reader"
    STEP_SCOPES = "step_scopes"
    RAW = "raw"


_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "bf16": "bfloat16",
    "int": "int32",
    "long": "int64",
}

_TORCH = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}
_TORCH_NAMES = {v: k for k, v in _TORCH.items()}


def convert_dtype(dtype):
    """Normalize any dtype spec (str / np.dtype / torch.dtype) to a
    canonical string name."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
    elif isinstance(dtype, torch.dtype):
        name = _TORCH_NAMES[dtype]
    else:
        name = np.dtype(dtype).name
    return _ALIASES.get(name, name)


_FLOAT_TYPES = {"float16", "bfloat16", "float32", "float64"}


def is_float_dtype(dtype):
    return convert_dtype(dtype) in _FLOAT_TYPES


def to_torch_dtype(dtype):
    return _TORCH[convert_dtype(dtype)]
