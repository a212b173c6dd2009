"""Dygraph data parallelism (reference: python/paddle/fluid/dygraph/
parallel.py:223 DataParallel + :54 ParallelEnv; C++ side paddle/fluid/
imperative/nccl_context.cc), one process a rank.

Each rank holds its rows of the batch; after ``loss.backward()``,
``apply_collective_grads`` sums every parameter's grad over the ranks in
one fused all-reduce (``parallel/env.py`` ``psum_fused``: one flat buffer
a dtype, the reference's coalesce_grad_tensor_pass), where the JAX
package runs one coalesced psum over its device mesh. The process group
is the one ``parallel.make_mesh`` joins from ``ParallelEnv`` (run under
``paddle_tpu_torch.distributed.launch``)."""

from paddle_tpu_torch.dygraph.layers import Layer
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.parallel.env import ParallelEnv


def prepare_context():
    """reference: dygraph/parallel.py prepare_context: joins the process
    group (``make_mesh``) and returns the environment."""
    penv.make_mesh()
    return ParallelEnv()


class DataParallel(Layer):
    def __init__(self, layers, strategy=None):
        super().__init__()
        self._layers = layers
        self._env = ParallelEnv()
        self._nranks = max(self._env.nranks, 1)
        self._axis = None

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """Divide by trainer count so the post-allreduce gradient is the
        global mean (reference: parallel.py scale_loss)."""
        if self._nranks <= 1:
            return loss
        return loss * (1.0 / self._nranks)

    def apply_collective_grads(self):
        """Sum gradients across the ranks (reference: parallel.py
        apply_collective_grads — coalesce + allreduce): one fused
        all-reduce a dtype; every rank gets the same bits."""
        if self._nranks <= 1:
            return
        params = [p for p in self._layers.parameters() if p.grad_value is not None]
        if not params:
            return
        if self._axis is None:
            self._axis = penv.make_mesh().axis("data")
        summed = penv.psum_fused([p.grad_value for p in params], self._axis)
        for p, g in zip(params, summed):
            p.grad_value = g

    def state_dict(self, include_sublayers=True):
        return self._layers.state_dict(include_sublayers)

    def set_dict(self, state_dict, include_sublayers=True):
        return self._layers.set_dict(state_dict, include_sublayers)

    load_dict = set_dict

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def clear_gradients(self):
        self._layers.clear_gradients()
