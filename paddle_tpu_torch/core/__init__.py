from paddle_tpu_torch.core.places import CPUPlace, CUDAPlace, Place, default_place
from paddle_tpu_torch.core.dtypes import VarType, convert_dtype
from paddle_tpu_torch.core.ir import (
    Program,
    Block,
    Operator,
    Variable,
    Parameter,
    program_guard,
    default_main_program,
    default_startup_program,
    switch_main_program,
    switch_startup_program,
    name_scope,
)
from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
from paddle_tpu_torch.core.registry import OpDef, register_op, get_op_def, has_op_def, OpRegistry
