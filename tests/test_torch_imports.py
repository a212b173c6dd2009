"""The PyTorch port stands alone: it imports neither ``jax`` nor anything
of the JAX package ``paddle_tpu`` (it keeps its own copies), and
``chip_smoke.py`` imports neither either."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "paddle_tpu_torch"

_PROBE = """
import sys
import paddle_tpu_torch
import paddle_tpu_torch.amp
import paddle_tpu_torch.amp.decorator
import paddle_tpu_torch.compiler
import paddle_tpu_torch.convert
import paddle_tpu_torch.core.prng
import paddle_tpu_torch.analysis.signatures
import paddle_tpu_torch.analysis.usedef
import paddle_tpu_torch.analysis.verify
import paddle_tpu_torch.core.backward
import paddle_tpu_torch.dataio.sparse
import paddle_tpu_torch.dataio.state
import paddle_tpu_torch.distributed
import paddle_tpu_torch.dygraph
import paddle_tpu_torch.dygraph.ast_transform
import paddle_tpu_torch.dygraph.base
import paddle_tpu_torch.dygraph.checkpoint
import paddle_tpu_torch.dygraph.container
import paddle_tpu_torch.dygraph.jit
import paddle_tpu_torch.dygraph.layers
import paddle_tpu_torch.dygraph.nn
import paddle_tpu_torch.dygraph.parallel
import paddle_tpu_torch.dygraph.varbase
import paddle_tpu_torch.distributed.launch
import paddle_tpu_torch.distributed.ps
import paddle_tpu_torch.embedding
import paddle_tpu_torch.embedding.store
import paddle_tpu_torch.fleet
import paddle_tpu_torch.fleet.base
import paddle_tpu_torch.fleet.collective
import paddle_tpu_torch.fleet.role_maker
import paddle_tpu_torch.incubate
import paddle_tpu_torch.incubate.checkpoint
import paddle_tpu_torch.inference
import paddle_tpu_torch.inference.predictor
import paddle_tpu_torch.io
import paddle_tpu_torch.kernels.attention
import paddle_tpu_torch.kernels.build
import paddle_tpu_torch.kernels.embedding
import paddle_tpu_torch.kernels.flash_attention
import paddle_tpu_torch.kernels.random
import paddle_tpu_torch.kernels.sparse_update
import paddle_tpu_torch.kernels.topk
import paddle_tpu_torch.layers.collective
import paddle_tpu_torch.layers.control_flow
import paddle_tpu_torch.layers.pipeline
import paddle_tpu_torch.models.bert
import paddle_tpu_torch.models.ctr
import paddle_tpu_torch.models.gpt_ir
import paddle_tpu_torch.models.mnist
import paddle_tpu_torch.models.resnet
import paddle_tpu_torch.models.transformer
import paddle_tpu_torch.models.wide_deep
import paddle_tpu_torch.observability.lockdep
import paddle_tpu_torch.observability.metrics
import paddle_tpu_torch.ops.control_flow
import paddle_tpu_torch.ops.fused
import paddle_tpu_torch.ops.misc_extra
import paddle_tpu_torch.ops.pipeline
import paddle_tpu_torch.ops.sharded_embedding
import paddle_tpu_torch.optimizer
import paddle_tpu_torch.parallel
import paddle_tpu_torch.parallel.data_parallel
import paddle_tpu_torch.parallel.dgc
import paddle_tpu_torch.parallel.env
import paddle_tpu_torch.parallel.pipeline
import paddle_tpu_torch.parallel.sharding
import paddle_tpu_torch.parallel.spec_layout
import paddle_tpu_torch.passes
import paddle_tpu_torch.regularizer
import paddle_tpu_torch.resilience.faults
import paddle_tpu_torch.resilience.retry
import paddle_tpu_torch.resilience.supervisor
import paddle_tpu_torch.serving.batcher
import paddle_tpu_torch.serving.breaker
import paddle_tpu_torch.serving.brownout
import paddle_tpu_torch.serving.decode.engine
import paddle_tpu_torch.serving.decode.generate.beam
import paddle_tpu_torch.serving.decode.generate.grammar
import paddle_tpu_torch.serving.decode.generate.sampling
import paddle_tpu_torch.serving.decode.metrics
import paddle_tpu_torch.serving.decode.tier
import paddle_tpu_torch.serving.engine
import paddle_tpu_torch.serving.fleet
import paddle_tpu_torch.serving.fleet.health
import paddle_tpu_torch.serving.fleet.metrics
import paddle_tpu_torch.serving.fleet.replica
import paddle_tpu_torch.serving.fleet.router
import paddle_tpu_torch.serving.fleet.worker
import paddle_tpu_torch.serving.metrics
import paddle_tpu_torch.serving.request
import paddle_tpu_torch.utils.flags
import paddle_tpu_torch.data_feeder
import paddle_tpu_torch.dataio.engine
import paddle_tpu_torch.dataio.prefetch
import paddle_tpu_torch.dataio.source
import paddle_tpu_torch.dataset
import paddle_tpu_torch.device_worker
import paddle_tpu_torch.distributed.lookup
import paddle_tpu_torch.fleet.parameter_server
import paddle_tpu_torch.incubate.data_generator
import paddle_tpu_torch.incubate.fleet_utils
import paddle_tpu_torch.native
import paddle_tpu_torch.observability.fetcher
import paddle_tpu_torch.observability.logger
import paddle_tpu_torch.reader
import paddle_tpu_torch.reader.dataloader
import paddle_tpu_torch.reader.decorator
import paddle_tpu_torch.trainer_desc
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "paddle_tpu" or m.startswith("paddle_tpu."))
print(bad)
assert not bad, bad
"""

_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|paddle_tpu)(?![\w])", re.M)


def test_importing_the_port_loads_no_jax_and_no_reference_module():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py", "tools/torch_chaos_serve.py"])
def test_source_has_no_jax_or_reference_import(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.findall(text), path
