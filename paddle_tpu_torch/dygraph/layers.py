"""Layer: the dygraph module base class, as the JAX package's
``dygraph/layers.py`` has it (reference: python/paddle/fluid/dygraph/
layers.py Layer — parameter/sublayer registration via __setattr__,
train/eval mode, state_dict). Parameters are initialized EAGERLY by
running the initializer's op through the same registry lowering the
startup program would use, with the tracer's keys: the JAX dygraph's
initial weights, drawn on the card by K8 (``ops/tensor.py``)."""

import collections

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.dygraph.base import _dygraph_tracer, current_device
from paddle_tpu_torch.dygraph.varbase import ParamBase, VarBase
from paddle_tpu_torch.initializer import ConstantInitializer, XavierInitializer
from paddle_tpu_torch.param_attr import ParamAttr
from paddle_tpu_torch.utils import unique_name
from paddle_tpu_torch.utils.enforce import enforce


def eager_initialize(shape, dtype, initializer):
    """Run an initializer eagerly: let it append its op(s) to a scratch block,
    then execute those ops through their registry lowerings."""
    from paddle_tpu_torch.core.ir import Program

    prog = Program()
    block = prog.global_block()
    var = block.create_var(name="__init_target__", shape=list(shape), dtype=dtype)
    initializer(var, block)
    tracer = _dygraph_tracer()
    env = {}
    for op in block.ops:
        op_def = get_op_def(op.type)
        ins = {
            slot: [env[n] for n in names]
            for slot, names in op.inputs.items()
            if names and all(n in env for n in names)
        }
        if op_def.stateful:
            key = (tracer.next_rng_key() if tracer is not None
                   else prng.prng_key(0))
            ins["__rng_key__"] = [key]
        if op_def.creates:
            ins["__device__"] = [current_device()]
        outs = op_def.lowering()(ins, op.attrs)
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            for name, val in zip(names, vals):
                env[name] = val
    return env["__init_target__"]


def _to_device(value):
    if isinstance(value, torch.Tensor):
        return value.to(current_device())
    return torch.from_numpy(np.array(value)).to(current_device())


class Layer:
    """reference: python/paddle/fluid/dygraph/layers.py Layer."""

    def __init__(self, name_scope=None, dtype="float32"):
        base = name_scope or self.__class__.__name__.lower()
        self._full_name = unique_name.generate(base)
        self._dtype = dtype
        self.training = True
        self._parameters = collections.OrderedDict()
        self._sub_layers = collections.OrderedDict()
        self._buffers = collections.OrderedDict()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()

    def full_name(self):
        return self._full_name

    # -- parameter management -----------------------------------------
    def create_parameter(
        self,
        shape,
        attr=None,
        dtype=None,
        is_bias=False,
        default_initializer=None,
    ):
        attr = ParamAttr._to_attr(attr)
        dtype = dtype or self._dtype
        init = (
            attr.initializer
            or default_initializer
            or (ConstantInitializer(0.0) if is_bias else XavierInitializer())
        )
        value = eager_initialize(shape, dtype, init)
        name = attr.name or unique_name.generate(f"{self._full_name}.w")
        p = ParamBase(
            value,
            name=name,
            trainable=attr.trainable,
            optimize_attr={"learning_rate": attr.learning_rate},
            regularizer=attr.regularizer,
        )
        return p

    def create_variable(self, name=None, persistable=True, dtype=None, value=None):
        vb = VarBase(
            value if value is None else _to_device(value),
            name=name or unique_name.generate(f"{self._full_name}.b"),
            stop_gradient=True,
            persistable=persistable,
        )
        return vb

    def register_buffer(self, name, value, persistable=True):
        vb = (
            value
            if isinstance(value, VarBase)
            else VarBase(
                _to_device(value),
                name=f"{self._full_name}.{name}",
                stop_gradient=True,
                persistable=persistable,
            )
        )
        self._buffers[name] = vb
        return vb

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        return sublayer

    # -- traversal -----------------------------------------------------
    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(include_sublayers)]

    def named_parameters(self, include_sublayers=True, prefix=""):
        out = []
        seen = set()
        for name, p in self._parameters.items():
            if p is not None and id(p) not in seen:
                seen.add(id(p))
                out.append((f"{prefix}{name}" if prefix else name, p))
        if include_sublayers:
            for lname, layer in self._sub_layers.items():
                sub_prefix = f"{prefix}{lname}." if prefix else f"{lname}."
                for n, p in layer.named_parameters(True, sub_prefix):
                    if id(p) not in seen:
                        seen.add(id(p))
                        out.append((n, p))
        return out

    def sublayers(self, include_self=False):
        out = [self] if include_self else []
        for layer in self._sub_layers.values():
            out.extend(layer.sublayers(include_self=True))
        return out

    def named_buffers(self, prefix=""):
        out = []
        for name, b in self._buffers.items():
            out.append((f"{prefix}{name}" if prefix else name, b))
        for lname, layer in self._sub_layers.items():
            sub_prefix = f"{prefix}{lname}." if prefix else f"{lname}."
            out.extend(layer.named_buffers(sub_prefix))
        return out

    # -- modes ---------------------------------------------------------
    def train(self):
        self.training = True
        tracer = _dygraph_tracer()
        if tracer is not None:
            tracer._train_mode = True
        for layer in self.sublayers():
            layer.training = True
        return self

    def eval(self):
        self.training = False
        tracer = _dygraph_tracer()
        if tracer is not None:
            tracer._train_mode = False
        for layer in self.sublayers():
            layer.training = False
        return self

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # -- state dict -----------------------------------------------------
    def state_dict(self, include_sublayers=True):
        out = collections.OrderedDict()
        for _, p in self.named_parameters(include_sublayers):
            out[p.name] = p.numpy()
        for _, b in self.named_buffers():
            if b.persistable and b.value is not None:
                out[b.name] = b.numpy()
        return out

    def set_dict(self, state_dict, include_sublayers=True):
        missing = []
        for _, p in self.named_parameters(include_sublayers):
            if p.name in state_dict:
                p.set_value(np.asarray(state_dict[p.name]))
            else:
                missing.append(p.name)
        for _, b in self.named_buffers():
            if b.name in state_dict and b.value is not None:
                b.set_value(np.asarray(state_dict[b.name]))
        enforce(not missing, f"state_dict missing parameters: {missing[:5]}")

    set_state_dict = set_dict
    load_dict = set_dict

    # -- hooks + call ----------------------------------------------------
    def register_forward_pre_hook(self, hook):
        handle = len(self._forward_pre_hooks)
        self._forward_pre_hooks[handle] = hook
        return handle

    def register_forward_post_hook(self, hook):
        handle = len(self._forward_post_hooks)
        self._forward_post_hooks[handle] = hook
        return handle

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            result = hook(self, inputs)
            if result is not None:
                inputs = result if isinstance(result, tuple) else (result,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            result = hook(self, inputs, outputs)
            if result is not None:
                outputs = result
        return outputs

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    # -- attribute capture ----------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        if isinstance(value, ParamBase):
            enforce(params is not None, "call Layer.__init__ first")
            params[name] = value
        elif isinstance(value, Layer):
            enforce(layers is not None, "call Layer.__init__ first")
            layers[name] = value
        else:
            if params is not None and name in params:
                del params[name]
            if layers is not None and name in layers:
                del layers[name]
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'"
        )

    def __delattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)
