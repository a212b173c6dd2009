"""Structured control-flow layers: ``While`` and ``cond``, copied from
the JAX package's ``layers/control_flow.py`` (reference:
python/paddle/fluid/layers/control_flow.py — While, cond), so both
packages build the same blocks and ops. The executor runs the ``while``
and ``conditional_block`` ops they append over their sub-blocks
(``ops/control_flow.py``). The TensorArray layers wait for their ops
(ROADMAP M12)."""

from paddle_tpu_torch.core.ir import default_main_program
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.utils.enforce import EnforceError

__all__ = ["While", "cond", "array_write", "array_read"]


class While:
    """
    with While(cond_var) as w:   # ops appended inside run in the loop body
        ...
    Variables written in the body that pre-exist outside are loop-carried.
    """

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.program = default_main_program()

    def __enter__(self):
        self.parent_idx = self.program.current_block_idx
        self.sub_block = self.program._create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.program._rollback()
        parent = self.program.block(self.parent_idx)
        parent.append_op(
            "while",
            inputs={"Condition": [self.cond_var.name]},
            outputs={},
            attrs={"sub_block": self.sub_block.idx},
        )
        return False

    def block(self):
        return self


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Two-branch conditional: both branches are built into sub-blocks;
    their return variables must match in structure."""
    helper = LayerHelper("cond", name=name)
    program = default_main_program()
    parent_idx = program.current_block_idx

    true_block = program._create_block()
    true_out = true_fn() if true_fn is not None else None
    program._rollback()

    false_idx = -1
    false_out = None
    if false_fn is not None:
        false_block = program._create_block()
        false_out = false_fn()
        program._rollback()
        false_idx = false_block.idx

    def _norm(o):
        if o is None:
            return []
        return list(o) if isinstance(o, (list, tuple)) else [o]

    t_outs, f_outs = _norm(true_out), _norm(false_out)
    if t_outs and (false_fn is None or len(f_outs) != len(t_outs)):
        raise EnforceError(
            f"cond: true_fn returns {len(t_outs)} value(s) but false_fn "
            f"returns {len(f_outs)} — both branches must produce the same "
            f"output structure"
        )
    parent = program.block(parent_idx)
    outs = []
    # unify branch outputs through fresh vars written by both branches
    for i, tv in enumerate(t_outs):
        out = parent.create_var(
            name=helper.name + f".out_{i}", dtype=tv.dtype, shape=tv.shape
        )
        program.block(true_block.idx).append_op(
            "assign", {"X": [tv.name]}, {"Out": [out.name]}
        )
        if false_idx >= 0 and i < len(f_outs):
            program.block(false_idx).append_op(
                "assign", {"X": [f_outs[i].name]}, {"Out": [out.name]}
            )
        outs.append(out)
    parent.append_op(
        "conditional_block",
        inputs={"Cond": [pred.name]},
        outputs={"Out": [o.name for o in outs]},
        attrs={"sub_block": true_block.idx, "sub_block_false": false_idx},
    )
    if not outs:
        return None
    return outs[0] if len(outs) == 1 else outs


def array_write(x, i, array=None):
    raise NotImplementedError(
        "array_write: the TensorArray ops (write_to_array, read_from_array) "
        "are not ported yet (ROADMAP M12)")


def array_read(array, i):
    raise NotImplementedError(
        "array_read: the TensorArray ops (write_to_array, read_from_array) "
        "are not ported yet (ROADMAP M12)")
