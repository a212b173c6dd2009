"""Operator registry.

Analog of the reference's OpInfoMap/OpRegistry (reference:
paddle/fluid/framework/op_registry.h:68). An op registers:

  * ``lower``  — a torch lowering rule ``(inputs, attrs) -> outputs`` on
                 tensors. The executor calls it eagerly, one op at a
                 time; shape inference calls it on ``meta`` tensors.
  * ``kernel`` — optional lowering that routes the op through a
                 hand-written CUDA kernel (``paddle_tpu_torch/kernels/``).
                 It takes the place of the JAX package's ``pallas`` slot.
  * ``grad``   — optional hand-written grad lowering for the op's
                 ``<type>_grad`` (``register_grad``); without one,
                 ``core/backward.py`` differentiates the forward lowering
                 with ``torch.autograd``.

Inputs/outputs are dicts: slot name -> list of tensors, mirroring the
reference's named variable lists on OpDesc. ``nondiff_inputs`` names the
input slots that never receive gradients (indices, labels, masks). Two
flags ask the executor for run-time context: ``stateful`` ops receive
their random key (``core/prng.py``: the run key folded with the op's
``__rng_id__``) as ``ins["__rng_key__"]``, and
``creates`` ops (which have no tensor input to take a device from)
receive the target ``torch.device`` as ``ins["__device__"]``. A third,
``reports_late``, marks ops whose kernel finds a bad input on the card
after the launch (``kernels.registry.report_late``): the executor raises
it at the end of the run, naming those ops. ``needs_block`` ops (and
their grads) run sub-blocks: they receive the block they sit in as
``ins["__block__"]`` and the executor's runner of plans as
``ins["__runner__"]`` (``runner.plan(block)``, ``runner.run(steps, env,
key, block)``). A ``saves_for_grad`` op gets ``_save_for_grad`` in its
attrs when its block holds its grad op, which then reads what the
forward kept.
"""

from paddle_tpu_torch.utils.enforce import EnforceError


class OpDef:
    def __init__(self, type, lower, kernel=None, grad=None,
                 nondiff_inputs=(), stateful=False, creates=False,
                 reports_late=False, needs_block=False, saves_for_grad=False):
        self.type = type
        self.lower = lower
        self.kernel = kernel
        self.grad = grad
        self.nondiff_inputs = frozenset(nondiff_inputs)
        self.stateful = stateful
        self.creates = creates
        self.reports_late = reports_late
        self.needs_block = needs_block
        self.saves_for_grad = saves_for_grad

    def lowering(self):
        """What the executor runs: the kernel lowering when the op has
        one, else the plain one."""
        return self.kernel if self.kernel is not None else self.lower


class OpRegistry:
    _ops = {}

    @classmethod
    def register(cls, op_def):
        if op_def.type in cls._ops:
            raise EnforceError(f"op {op_def.type} registered twice")
        cls._ops[op_def.type] = op_def

    @classmethod
    def get(cls, type):
        try:
            return cls._ops[type]
        except KeyError:
            raise EnforceError(f"op {type} is not registered") from None

    @classmethod
    def has(cls, type):
        return type in cls._ops

    @classmethod
    def all_types(cls):
        return sorted(cls._ops)


def register_op(type, kernel=None, nondiff_inputs=(), stateful=False,
                creates=False, reports_late=False, needs_block=False,
                saves_for_grad=False):
    """Decorator form:  @register_op("relu")  def _(ins, attrs): ..."""

    def deco(fn):
        OpRegistry.register(
            OpDef(type, fn, kernel=kernel, nondiff_inputs=nondiff_inputs,
                  stateful=stateful, creates=creates,
                  reports_late=reports_late, needs_block=needs_block,
                  saves_for_grad=saves_for_grad)
        )
        return fn

    return deco


def register_grad(fwd_type):
    """Attach a hand-written grad lowering to an already-registered op: it
    serves ``<fwd_type>_grad`` in place of the generic one (the calling
    convention is in ``core/backward.py``)."""

    def deco(fn):
        OpRegistry.get(fwd_type).grad = fn
        return fn

    return deco


def get_op_def(type):
    return OpRegistry.get(type)


def has_op_def(type):
    return OpRegistry.has(type)
