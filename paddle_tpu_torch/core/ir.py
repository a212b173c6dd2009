"""Program IR: Program / Block / Operator / Variable.

The framework's intermediate representation, with the same structural
surface as the reference's ProgramDesc protobuf + Python mirror
(reference: paddle/fluid/framework/framework.proto:211 — program = blocks;
block = vars + ops; reference: python/paddle/fluid/framework.py:3602 Program,
:2176 Block, :1706 Operator, :806 Variable).

This is the same IR as the JAX package's ``core/ir.py``: layer builders
append ops to it, and ``core/executor.py`` runs it op by op on torch
tensors. Programs built by the two packages from the same builder calls
carry the same op types, attributes and variable names.
"""

import contextlib
import copy
import itertools
import json
import operator

import numpy as np

from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.utils import unique_name
from paddle_tpu_torch.utils.enforce import EnforceError, enforce, user_callstack

IR_FORMAT_VERSION = 1

_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix):
    """Hierarchical name scoping for profiling/visualization
    (reference: python/paddle/fluid/framework.py name_scope)."""
    _name_scope_stack.append(prefix)
    try:
        yield
    finally:
        _name_scope_stack.pop()


def _current_name_scope():
    return "/".join(_name_scope_stack)


def parse_getitem_index(idx):
    """The tensor-index parser of the JAX package's ``core/ir.py``, for
    dygraph's ``VarBase.__getitem__``: idx -> (axes, starts, ends,
    squeeze_axes). Ints squeeze their axis and -1 selects from the end
    (int-max end sentinel); only step-1 slices are expressible as one
    slice op — anything else raises."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    axes, starts, ends, squeeze_axes = [], [], [], []
    for ax, s in enumerate(idx):
        if isinstance(s, slice):
            if s.step not in (None, 1):
                raise ValueError(
                    "tensor slicing supports step 1 only "
                    "(use layers.strided_slice)"
                )
            if s.start is None and s.stop is None:
                continue
            axes.append(ax)
            starts.append(s.start or 0)
            ends.append(s.stop if s.stop is not None else int(1e9))
        else:
            try:
                # accepts python/numpy ints; a SYMBOLIC tensor index routes
                # through __index__ and hits its loud capture guard
                i = operator.index(s)
            except TypeError:
                raise TypeError(
                    f"unsupported tensor index {type(s).__name__} "
                    "(tensor-valued indices: use layers.gather)"
                ) from None
            axes.append(ax)
            starts.append(i)
            ends.append(i + 1 if i != -1 else int(1e9))
            squeeze_axes.append(ax)
    return axes, starts, ends, squeeze_axes


class Variable:
    """A named tensor slot in a Block.

    Carries static metadata (shape may contain -1 for a dynamic dim, resolved
    at feed time).
    """

    def __init__(
        self,
        block,
        name=None,
        shape=None,
        dtype="float32",
        persistable=False,
        stop_gradient=False,
        is_data=False,
        type=None,
        lod_level=0,
        initializer=None,
        **kwargs,
    ):
        self.block = block
        self.name = name or unique_name.generate("_generated_var")
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype) if dtype is not None else None
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type or "dense_tensor"
        self.lod_level = lod_level
        if initializer is not None:
            initializer(self, block)

    @property
    def program(self):
        return self.block.program

    def desc(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "type": self.type,
            "lod_level": self.lod_level,
            "kind": "param" if isinstance(self, Parameter) else "var",
            "trainable": getattr(self, "trainable", None),
        }

    def numel(self):
        if self.shape is None:
            return None
        n = 1
        for d in self.shape:
            n *= max(d, 1)
        return n

    def __repr__(self):
        return f"Variable(name={self.name}, shape={self.shape}, dtype={self.dtype})"

    # arithmetic sugar (reference: python/paddle/fluid/layers/math_op_patch.py)
    def _binary(self, other, op, reverse=False):
        from paddle_tpu_torch import layers

        if not isinstance(other, Variable):
            other = layers.fill_constant(
                shape=[1], dtype=self.dtype, value=float(other)
            )
        a, b = (other, self) if reverse else (self, other)
        return layers.elementwise_op(op, a, b)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    def __radd__(self, other):
        return self._binary(other, "elementwise_add", reverse=True)

    def __matmul__(self, other):
        from paddle_tpu_torch import layers

        return layers.matmul(self, other)


class Parameter(Variable):
    """A persistable, trainable Variable
    (reference: python/paddle/fluid/framework.py:4631)."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        self.is_distributed = kwargs.pop("is_distributed", False)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)


class Operator:
    """One op node: type + named input/output variable lists + attributes
    (reference: paddle/fluid/framework/framework.proto:42 OpDesc)."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        if _current_name_scope():
            self.attrs.setdefault("op_namescope", _current_name_scope())
        self.attrs.setdefault("op_callstack", user_callstack())
        # stable per-op rng id: stateful ops fold the step key with this id,
        # so dropout masks are reproducible across pruning/replay (recompute)
        if "__rng_id__" not in self.attrs:
            self.attrs["__rng_id__"] = block.program._next_rng_id()

    def input_names(self):
        return [n for names in self.inputs.values() for n in names]

    def output_names(self):
        return [n for names in self.outputs.values() for n in names]

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def has_attr(self, name):
        return name in self.attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def set_attr(self, name, value):
        self.attrs[name] = value
        self.block.program._bump_version()

    def desc(self):
        attrs = {
            k: v
            for k, v in self.attrs.items()
            if k not in ("op_callstack",) and _json_safe(v)
        }
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": attrs,
        }

    def __repr__(self):
        return f"Operator({self.type}, in={self.inputs}, out={self.outputs})"


def _json_safe(v):
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return isinstance(v, np.ndarray)


class Block:
    """vars + ops, with parent-chain lookup for sub-blocks (control flow)
    (reference: paddle/fluid/framework/framework.proto:173 BlockDesc,
    reference: paddle/fluid/framework/scope.h:46 parent-chain semantics)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []
        self.forward_block_idx = -1

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, shape, dtype, name=None, **kwargs):
        # parameters live in the top-level (global) block, as in the reference
        global_block = self.program.global_block()
        param = Parameter(global_block, shape, dtype, name=name, **kwargs)
        global_block.vars[param.name] = param
        self.program._bump_version()
        return param

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise EnforceError(f"Variable {name} not found in block {self.idx}")
        return v

    def has_var(self, name):
        return name in self.vars

    def _find_var_recursive(self, name):
        block = self
        while block is not None:
            if name in block.vars:
                return block.vars[name]
            block = block.parent_block
        return None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def _prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        return op

    def _insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def _remove_op(self, index):
        self.ops.pop(index)
        self.program._bump_version()

    def desc(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": [v.desc() for v in self.vars.values()],
            "ops": [op.desc() for op in self.ops],
        }


class Program:
    """A list of blocks; block 0 is the global block
    (reference: paddle/fluid/framework/program_desc.h:30,
    reference: python/paddle/fluid/framework.py:3602)."""

    # monotonic per-process program ids: compile caches key on this instead
    # of id(program), which CPython reuses after GC
    _uid_counter = itertools.count()

    def __init__(self):
        self._rng_op_counter = 0
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0
        self._uid = next(Program._uid_counter)
        self._seed = 0
        self.random_seed = 0
        self._is_distributed = False
        self._attrs = {}

    # -- structure --------------------------------------------------------
    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def num_blocks(self):
        return len(self.blocks)

    def _create_block(self, parent_idx=None):
        new_idx = len(self.blocks)
        parent = self.current_block_idx if parent_idx is None else parent_idx
        self.blocks.append(Block(self, new_idx, parent))
        self.current_block_idx = new_idx
        self._bump_version()
        return self.current_block()

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    def _next_rng_id(self):
        self._rng_op_counter += 1
        return self._rng_op_counter

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for block in self.blocks:
            yield from block.vars.values()

    # -- transforms -------------------------------------------------------
    def clone(self, for_test=False):
        """Deep copy; with for_test=True, flip ops into inference mode
        (reference: python/paddle/fluid/framework.py Program.clone)."""
        p = Program.__new__(Program)
        p.__dict__.update(
            {
                k: copy.copy(v)
                for k, v in self.__dict__.items()
                if k not in ("blocks",)
            }
        )
        p._attrs = dict(self._attrs)
        p._uid = next(Program._uid_counter)
        p.blocks = []
        old_params = {
            v.name for v in self.global_block().vars.values() if isinstance(v, Parameter)
        }
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            nb.forward_block_idx = b.forward_block_idx
            for v in b.vars.values():
                if v.name in old_params and b.idx == 0:
                    nv = Parameter(
                        nb, v.shape, v.dtype, name=v.name, trainable=v.trainable
                    )
                    nv.optimize_attr = dict(v.optimize_attr)
                    nv.regularizer = v.regularizer
                else:
                    nv = Variable(
                        nb,
                        name=v.name,
                        shape=v.shape,
                        dtype=v.dtype,
                        persistable=v.persistable,
                        stop_gradient=v.stop_gradient,
                        is_data=v.is_data,
                        type=v.type,
                        lod_level=v.lod_level,
                    )
                nv.stop_gradient = v.stop_gradient
                nb.vars[nv.name] = nv
            for op in b.ops:
                nop = Operator(nb, op.type, op.inputs, op.outputs, dict(op.attrs))
                if for_test and "is_test" in _test_mode_attrs(op.type):
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        if for_test:
            p._prune_backward()
        return p

    def _prune_backward(self):
        """Drop backward/optimizer ops (everything after the last forward op
        marker, or any op whose outputs are all @GRAD)."""
        for block in self.blocks:
            block.ops = [
                op
                for op in block.ops
                if not (
                    op.attrs.get("op_role", 0) in (1, 2)  # backward / optimize
                    or all(n.endswith("@GRAD") for n in op.output_names())
                    and op.output_names()
                )
            ]
        self._bump_version()

    def _prune(self, targets):
        """Prune the global block to the ops that ``targets`` need
        (reference: paddle/fluid/framework/prune.cc), walking backward
        from the targets over each op's reads and writes (the JAX
        package's ``Program._prune``)."""
        from paddle_tpu_torch.analysis.usedef import build_usedef

        target_names = {t.name if isinstance(t, Variable) else t for t in targets}
        block = self.global_block()
        usedef = build_usedef(block)
        needed = set(target_names)
        kept = []
        for op in reversed(block.ops):
            if usedef.writes_of(op) & needed:
                kept.append(op)
                needed.update(usedef.reads_of(op))
        block.ops = list(reversed(kept))
        self._bump_version()
        return self

    # -- serialization ----------------------------------------------------
    def desc(self):
        return {
            "format_version": IR_FORMAT_VERSION,
            "random_seed": self.random_seed,
            "blocks": [b.desc() for b in self.blocks],
        }

    def to_bytes(self):
        return json.dumps(self.desc(), sort_keys=True).encode("utf-8")

    @staticmethod
    def from_bytes(data):
        desc = json.loads(data.decode("utf-8"))
        enforce(
            desc.get("format_version", 0) <= IR_FORMAT_VERSION,
            f"program format {desc.get('format_version')} is newer than this "
            f"framework supports ({IR_FORMAT_VERSION})",
        )
        p = Program()
        p.random_seed = desc.get("random_seed", 0)
        p.blocks = []
        for bdesc in desc["blocks"]:
            b = Block(p, bdesc["idx"], bdesc["parent_idx"])
            b.forward_block_idx = bdesc.get("forward_block_idx", -1)
            for vdesc in bdesc["vars"]:
                cls = Parameter if vdesc.get("kind") == "param" else Variable
                if cls is Parameter:
                    v = Parameter(
                        b,
                        vdesc["shape"],
                        vdesc["dtype"],
                        name=vdesc["name"],
                        trainable=vdesc.get("trainable", True),
                    )
                else:
                    v = Variable(
                        b,
                        name=vdesc["name"],
                        shape=vdesc["shape"],
                        dtype=vdesc["dtype"],
                        persistable=vdesc["persistable"],
                        stop_gradient=vdesc.get("stop_gradient", False),
                        is_data=vdesc.get("is_data", False),
                        type=vdesc.get("type", "dense_tensor"),
                        lod_level=vdesc.get("lod_level", 0),
                    )
                b.vars[v.name] = v
            for odesc in bdesc["ops"]:
                b.ops.append(
                    Operator(b, odesc["type"], odesc["inputs"], odesc["outputs"], odesc["attrs"])
                )
            p.blocks.append(b)
        # ops appended after deserialization must not collide with restored
        # __rng_id__s (correlated dropout masks/initializer streams)
        p._rng_op_counter = max(
            (op.attrs.get("__rng_id__", 0) for b in p.blocks for op in b.ops),
            default=0,
        )
        return p

    def to_string(self, throw_on_error=False):
        lines = []
        for b in self.blocks:
            lines.append(f"-- block {b.idx} (parent {b.parent_idx}) --")
            for v in b.vars.values():
                tag = "param" if isinstance(v, Parameter) else "var"
                lines.append(
                    f"  {tag} {v.name}: shape={v.shape} dtype={v.dtype}"
                    f"{' persistable' if v.persistable else ''}"
                )
            for op in b.ops:
                ins = {k: v for k, v in op.inputs.items()}
                outs = {k: v for k, v in op.outputs.items()}
                lines.append(f"  op {op.type}: {ins} -> {outs}")
        return "\n".join(lines)

    __str__ = to_string


def _test_mode_attrs(op_type):
    return {"is_test"} if op_type in _IS_TEST_OPS else set()


_IS_TEST_OPS = {"dropout", "batch_norm", "layer_norm", "data_norm"}


# ---------------------------------------------------------------------------
# process-global default programs
# (reference: python/paddle/fluid/framework.py:4845,4879)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    old = _main_program
    _main_program = program
    return old


def switch_startup_program(program):
    global _startup_program
    old = _startup_program
    _startup_program = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
