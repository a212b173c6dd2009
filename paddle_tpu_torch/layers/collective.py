"""Collective ops at the layer level: the ``c_*`` op types and their
builders, the counterpart of the JAX package's ``layers/collective.py``.

The reference inserts c_allreduce/c_allgather ops bound to NCCL rings
(reference: python/paddle/fluid/layers/collective.py:20,108;
paddle/fluid/operators/collective/c_allreduce_op.h:105). In the JAX
package a ring is a mesh axis name bound by ``collective_context``, and
the lowering emits ``lax.psum`` et al. over it. Here a ring is an ``Axis``
of the port's process group bound by ``parallel.env.collective_context``
(``{ring_id: axis}``), and the lowering is the eager collective over it;
every rank gets the JAX lowering's bits (``tests/test_torch_
fleet_collective.py``). Outside a bound ring (a single-trainer run, and
the dense data-parallel path, as under the JAX package's GSPMD path) each
op is an identity. Under ``torch.autograd`` (a ``pipeline_stack`` body,
``ops/pipeline.py``) ``c_allreduce_sum`` passes its cotangent through.
"""

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.ops.common import first
from paddle_tpu_torch.parallel import env as penv

__all__ = ["_allreduce", "_c_allgather", "_c_broadcast",
           "_c_reducescatter_layer"]


def _reduce_scatter(x, axis):
    """``lax.psum_scatter(x, axis, tiled=True)``: the sum over the ranks,
    this rank's chunk of dim 0."""
    total = penv.psum(x, axis)
    chunk = x.shape[0] // axis.size
    return total[axis.rank * chunk:(axis.rank + 1) * chunk]


_COLLECTIVES = {
    # under autograd (a pipeline_stack body) its cotangent passes through
    "c_allreduce_sum": penv.psum_diff,
    "c_allreduce_max": penv.pmax,
    "c_allreduce_min": penv.pmin,
    # lax.all_gather(x, ax).prod(axis=0): the product in rank order
    "c_allreduce_prod": lambda x, ax: penv.all_gather(x, ax).prod(dim=0),
    "c_allgather": penv.all_gather_rows,
    "c_broadcast": penv.broadcast,
    "c_reducescatter": _reduce_scatter,
}


def _make_collective(op_type, fn):
    @register_op(op_type)
    def _lower(ins, attrs, _fn=fn):
        x = first(ins, "X")
        axis = penv.current_mesh_axis(attrs.get("ring_id", 0))
        if axis is None or x.is_meta:
            return {"Out": [x]}
        return {"Out": [_fn(x, axis)]}


for _type, _fn in _COLLECTIVES.items():
    _make_collective(_type, _fn)


@register_op("c_sync_calc_stream")
def _c_sync_calc_stream(ins, attrs):
    # the eager port runs each rank's ops and collectives in program order
    # on one stream: there is nothing to wait for
    return {"Out": [first(ins, "X")]}


@register_op("c_sync_comm_stream")
def _c_sync_comm_stream(ins, attrs):
    return {"Out": [first(ins, "X")]}


def _collective_layer(op_type, x, ring_id=0, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        op_type, {"X": [x.name]}, {"Out": [out.name]}, {"ring_id": ring_id}
    )
    return out


def _allreduce(x, ring_id=0, use_calc_stream=False, name=None):
    return _collective_layer("c_allreduce_sum", x, ring_id, name)


def _c_allgather(x, nranks=1, ring_id=0, name=None):
    return _collective_layer("c_allgather", x, ring_id, name)


def _c_broadcast(x, root=0, ring_id=0, name=None):
    return _collective_layer("c_broadcast", x, ring_id, name)


def _c_reducescatter_layer(x, nranks=1, ring_id=0, name=None):
    return _collective_layer("c_reducescatter", x, ring_id, name)
