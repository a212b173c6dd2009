"""AnalysisPredictor analog: load -> analyze -> prepare buckets -> serve,
the port's copy of the JAX package's ``inference/predictor.py``.

reference: paddle/fluid/inference/api/analysis_predictor.h:47 (class
AnalysisPredictor), paddle_api.h (PaddlePredictor/ZeroCopyTensor),
paddle_analysis_config.h (AnalysisConfig).

The pipeline is: load ``__model__`` / ``__params__`` with the weights on
the predictor's device once; run the analysis passes (``passes.py``:
test mode, DCE, constant folding, conv-bn folding, fc fusion, attention
fusion onto ``scaled_dot_product_attention`` — the flash kernel K1 — and,
for bf16, the precision cast with the weights' casts folded); then serve
each input-shape bucket eagerly through the executor's per-op plan.

The port has no ahead-of-time compiler. A bucket's cache entry is what
the eager path can prepare: the executor plan of the analyzed program
plus a first run on zero feeds at that shape, which builds the kernels,
warms cuBLAS and fills the allocator. ``cache_stats`` keeps the JAX keys
(``persistent_hits`` stays 0: there is no on-disk tier). A run reads the
shared scope and writes nothing back into it, so clones serve
concurrently from one set of weights; each clone owns its own executor
and I/O handles. Runs happen under ``torch.inference_mode()``, entered on
every call, since grad mode is thread-local and serving workers are fresh
threads.

The predictor runs on ``cuda:<device_id>`` unless the config asks for the
CPU (``disable_gpu()`` / ``disable_tpu()``); with no card it raises.
"""

import json
import os
import threading
import time
import warnings

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.dtypes import to_torch_dtype
from paddle_tpu_torch.core.executor import Executor, _to_numpy, block_plan
from paddle_tpu_torch.core.ir import Program
from paddle_tpu_torch.core.places import CPUPlace, CUDAPlace
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.kernels import registry as kernel_registry
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.utils.enforce import enforce

__all__ = ["Config", "PrecisionType", "Predictor", "Tensor", "create_predictor"]

#: the default analysis pipeline. Pattern fusions run AFTER the test-mode
#: flip (multihead matching needs is_test dropout) and BEFORE the
#: precision cast (the fused fc/sdpa ops are AMP-white-listed)
DEFAULT_PASSES = ("strip_debug_ops", "flip_test_mode",
                  "dead_code_elimination", "fold_constants",
                  "conv_bn_fuse", "fc_fuse", "multihead_matmul_fuse")


class PrecisionType:
    """reference: paddle_api.h PaddleDType/Precision. Half maps to bf16,
    as in the JAX package."""

    Float32 = "float32"
    Bfloat16 = "bfloat16"
    Half = "bfloat16"
    Int8 = "int8"  # accepted; executed as bf16 (no int8 matmul path)


class Config:
    """reference: paddle/fluid/inference/api/paddle_analysis_config.h:61
    (AnalysisConfig). Config(model_dir) for the __model__/__params__
    layout, or Config(prog_file, params_file)."""

    def __init__(self, model_dir=None, params_file=None):
        self._model_dir = self._prog_file = self._params_file = None
        self.set_model(model_dir, params_file)
        self._use_gpu = True
        self._device_id = 0
        self._ir_optim = True
        self._memory_optim = True
        self._precision = PrecisionType.Float32
        self._passes = None  # None = default pipeline
        self._deleted_passes = set()
        self._verify_each_pass = False
        self._options = {}
        self._serving_buckets = None

    # -- model location (reference: AnalysisConfig::SetModel — updates only
    # the paths; previously configured options survive) ---------------------
    def set_model(self, model_dir_or_prog, params_file=None):
        if model_dir_or_prog is not None and params_file is not None:
            self._prog_file = model_dir_or_prog
            self._params_file = params_file
            self._model_dir = os.path.dirname(model_dir_or_prog)
        else:
            self._model_dir = model_dir_or_prog
            self._prog_file = None
            self._params_file = None

    def model_dir(self):
        return self._model_dir

    # -- device (reference: EnableUseGpu/DisableGpu); the JAX package's TPU
    # spellings name the same switch -----------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=0, device_id=0):
        self._use_gpu = True
        self._device_id = device_id

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def enable_tpu(self, device_id=0):
        self.enable_use_gpu(device_id=device_id)

    disable_tpu = disable_gpu
    use_tpu = use_gpu

    # -- analysis (reference: SwitchIrOptim / pass_builder) ----------------
    def switch_ir_optim(self, x=True):
        self._ir_optim = x

    def enable_program_verification(self, x=True):
        """Run the verifier after every analysis pass; a pass that breaks
        a program invariant raises naming the pass."""
        self._verify_each_pass = x

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self, x=True):
        """Accepted for parity: the caching allocator owns the memory
        plan (reference: EnableMemoryOptim)."""
        self._memory_optim = x

    def enable_bf16(self):
        """Serve the matrix-product regions in bfloat16 (fc, matmul, conv
        and the attention on K1's bf16 build)."""
        self._precision = PrecisionType.Bfloat16

    def set_precision(self, precision):
        if precision == PrecisionType.Int8:
            warnings.warn(
                "PrecisionType.Int8 requested but this build serves bf16: "
                "there is no int8 matmul path here (weights are not "
                "quantized). Set Bfloat16 to silence this warning.",
                stacklevel=2,
            )
        self._precision = precision

    def precision(self):
        return self._precision

    def delete_pass(self, name):
        """reference: pass_builder()->DeletePass."""
        self._deleted_passes.add(name)

    def set_passes(self, names):
        self._passes = list(names)

    def analysis_passes(self):
        names = list(self._passes if self._passes is not None
                     else DEFAULT_PASSES)
        if self._passes is None and self._precision != PrecisionType.Float32:
            names.append("bf16_cast")
        return [n for n in names if n not in self._deleted_passes]

    # -- serving (serving/: bucket lattice + warmup) -----------------------
    def set_serving_buckets(self, batch_sizes, seq_lens=None, pad_axis=1):
        """Declare the serving shape lattice: every served batch is one of
        (batch, seq) with batch from `batch_sizes` and seq from `seq_lens`
        (None = no variable-length axis). Predictor.warmup() prepares every
        lattice point, and ServingEngine batches only onto these shapes."""
        self._serving_buckets = {
            "batch_sizes": tuple(sorted(int(b) for b in batch_sizes)),
            "seq_lens": (tuple(sorted(int(s) for s in seq_lens))
                         if seq_lens else None),
            "pad_axis": int(pad_axis),
        }

    def serving_buckets(self):
        return self._serving_buckets

    # -- parity shims (accepted, no meaning here) --------------------------
    def set_cpu_math_library_num_threads(self, n):
        self._options["cpu_math_threads"] = n

    def switch_use_feed_fetch_ops(self, x=False):
        self._options["use_feed_fetch_ops"] = x

    def switch_specify_input_names(self, x=True):
        self._options["specify_input_names"] = x


class Tensor:
    """Zero-copy I/O handle (reference: paddle_api.h ZeroCopyTensor:
    copy_from_cpu/copy_to_cpu/Reshape). An input handle holds the next
    feed (a host array); an output handle holds the last run's tensor on
    the predictor's device until ``copy_to_cpu``."""

    def __init__(self, name, var, place):
        self.name = name
        self._var = var
        self._place = place
        self._value = None
        self._declared_shape = None  # set by reshape()

    def shape(self):
        if self._value is not None:
            return list(self._value.shape)
        return list(self._var.shape) if self._var is not None else []

    def reshape(self, shape):
        """Declare the upcoming feed's shape (reference: ZeroCopyTensor::
        Reshape): the next copy_from_cpu may pass a flat buffer, viewed
        through this shape."""
        self._declared_shape = list(shape)

    def copy_from_cpu(self, data):
        arr = np.ascontiguousarray(data)
        if self._declared_shape is not None and (
            list(arr.shape) != self._declared_shape
        ):
            arr = arr.reshape(self._declared_shape)
        self._value = arr

    def share_external_data(self, data):
        """Keep the caller's buffer (no copy here; the one host-to-device
        transfer happens inside run())."""
        self._value = np.asarray(data)

    def copy_to_cpu(self):
        enforce(self._value is not None, f"tensor '{self.name}' has no value")
        if isinstance(self._value, torch.Tensor):
            return _to_numpy(self._value)
        return np.asarray(self._value)

    def value(self):
        return self._value


class _Bucket:
    """One prepared input-shape bucket: the executor plan of the analyzed
    program and the names it reads. Read-only once built, so clones share
    it across threads."""

    __slots__ = ("steps", "read")

    def __init__(self, steps, read):
        self.steps = steps
        self.read = read


class Predictor:
    """reference: analysis_predictor.h:47. Loads the inference program,
    runs the analysis pipeline and serves through prepared buckets keyed
    on input shapes. clone() shares weights, the bucket cache and its
    counters (reference: AnalysisPredictor::Clone)."""

    def __init__(self, config, _shared=None):
        self._config = config
        place = CUDAPlace(config._device_id) if config._use_gpu else CPUPlace()
        # each clone owns its executor: its plan cache is no thread-safe
        # structure (the default place raises with no card)
        self._exe = Executor(place=place)
        self._place = self._exe.place
        self._device = self._exe.device
        if _shared is not None:
            (self._program, self._feed_names, self._fetch_names,
             self._scope, self._cache, self._analysis_stats,
             self._cache_stats, self._cache_lock) = _shared
        else:
            self._scope = Scope()
            self._program, self._feed_names, self._fetch_names = self._load()
            self._analysis_stats = {}
            if config.ir_optim():
                self._analyze()
            self._cache = {}
            self._cache_stats = {"hits": 0, "misses": 0, "compile_s": 0.0,
                                 "persistent_hits": 0}
            # clones run in concurrent serving workers: counter updates and
            # cache writes take the shared lock
            self._cache_lock = threading.Lock()
        # inference programs draw nothing (dropout is is_test): one fixed
        # key serves every run, as the JAX predictor's zero key does
        self._run_key = prng.prng_key(0)
        block = self._program.global_block()
        self._inputs = {n: Tensor(n, block._find_var_recursive(n), self._place)
                        for n in self._feed_names}
        self._outputs = {n: Tensor(n, block._find_var_recursive(n),
                                   self._place)
                         for n in self._fetch_names}

    # -- loading (reference: AnalysisPredictor::LoadProgramDesc/Parameters) -
    def _load(self):
        from paddle_tpu_torch.io import _read_combined, to_tensor

        cfg = self._config
        if cfg._prog_file:
            model_path, params_path = cfg._prog_file, cfg._params_file
        else:
            enforce(cfg._model_dir, "Config has no model location")
            model_path = os.path.join(cfg._model_dir, "__model__")
            params_path = os.path.join(cfg._model_dir, "__params__")
        enforce(os.path.exists(model_path), f"{model_path} not found")
        with open(model_path, "rb") as f:
            desc = json.loads(f.read().decode("utf-8"))
        program = Program.from_bytes(
            json.dumps(
                {k: v for k, v in desc.items()
                 if k not in ("feed_var_names", "fetch_var_names")}
            ).encode()
        )
        # weights go to the device ONCE; every run reuses them
        for name, arr in _read_combined(params_path).items():
            self._scope.set(name, to_tensor(arr, self._device))
        return (program, desc.get("feed_var_names", []),
                desc.get("fetch_var_names", []))

    # -- analysis (reference: AnalysisPredictor::OptimizeInferenceProgram) -
    def _analyze(self):
        from paddle_tpu_torch.passes import PassContext, PassManager

        ctx = PassContext(
            scope=self._scope,
            feed_names=self._feed_names,
            fetch_names=self._fetch_names,
            device=self._device,
            bf16_white_list=self._config._options.get("bf16_white_list"),
            bf16_black_list=self._config._options.get("bf16_black_list"),
        )
        pm = PassManager(
            self._config.analysis_passes(),
            verify_each_pass=self._config._verify_each_pass,
        )
        self._program = pm.run(self._program, ctx)
        if self._config.precision() != PrecisionType.Float32:
            self._fold_param_casts()
        self._analysis_stats = ctx.stats

    def _fold_param_casts(self):
        """Pre-cast the weights that flow through a leading cast op and
        delete the cast from the program: bf16 weights then live on the
        device at half the footprint and no per-call cast runs. A source
        weight that something else still reads (a tied embedding) keeps
        its float32 copy."""
        block = self._program.global_block()
        kept = []
        folded_srcs = []
        for op in block.ops:
            if op.type == "cast":
                src = op.inputs.get("X", [None])[0]
                dst = op.outputs.get("Out", [None])[0]
                var = block._find_var_recursive(src) if src else None
                if (
                    var is not None
                    and var.persistable
                    and self._scope.has_var(src)
                    and src not in self._feed_names
                ):
                    w = self._scope.find_var(src)
                    self._scope.set(dst, w.to(
                        to_torch_dtype(op.attrs.get("out_dtype"))))
                    dvar = block._find_var_recursive(dst)
                    if dvar is not None:
                        dvar.persistable = True
                    folded_srcs.append(src)
                    continue
            kept.append(op)
        if len(kept) != len(block.ops):
            block.ops = kept
            still_read = {
                n
                for b in self._program.blocks
                for op in b.ops
                for n in op.input_names()
            } | set(self._fetch_names)
            self._scope.erase([n for n in folded_srcs if n not in still_read])
            self._program._bump_version()

    # -- surface (reference: GetInputNames/GetOutputNames/GetInputTensor) --
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def get_input_handle(self, name):
        enforce(name in self._inputs, f"no input named '{name}'")
        return self._inputs[name]

    def get_output_handle(self, name):
        enforce(name in self._outputs, f"no output named '{name}'")
        return self._outputs[name]

    # reference spellings
    get_input_tensor = get_input_handle
    get_output_tensor = get_output_handle

    def get_input_tensor_shape(self):
        block = self._program.global_block()
        out = {}
        for n in self._feed_names:
            v = block._find_var_recursive(n)
            out[n] = list(v.shape) if v is not None else []
        return out

    # -- execution (reference: AnalysisPredictor::ZeroCopyRun) -------------
    def run(self, inputs=None):
        """Run one inference. Either set input handles first (zero-copy
        style) and call run(), or pass `inputs` as {name: np.ndarray} /
        [np.ndarray, ...] (reference: PaddlePredictor::Run). Fills the
        output handles (on the device) and returns the outputs as numpy
        arrays."""
        if inputs is not None:
            if isinstance(inputs, dict):
                for n, v in inputs.items():
                    self.get_input_handle(n).copy_from_cpu(v)
            else:
                enforce(
                    len(inputs) == len(self._feed_names),
                    f"expected {len(self._feed_names)} inputs, "
                    f"got {len(inputs)}",
                )
                for n, v in zip(self._feed_names, inputs):
                    self._inputs[n].copy_from_cpu(v)
        return [_to_numpy(o) for o in self._run_handles()]

    def _run_handles(self):
        """Run on the input handles' values; the outputs stay on the
        device, in the output handles and in the returned list."""
        feed_vals = []
        for n in self._feed_names:
            v = self._inputs[n].value()
            enforce(v is not None, f"input '{n}' was never set")
            feed_vals.append(np.asarray(v))
        outs = self._execute_feeds(feed_vals)
        for n, o in zip(self._fetch_names, outs):
            self._outputs[n]._value = o
        return outs

    # compatibility alias (reference: ZeroCopyRun)
    def zero_copy_run(self):
        self._run_handles()
        return True

    @staticmethod
    def _cache_key(sig):
        """The bucket key: the feed signature and the resolved kernel mode
        (a ``PADDLE_TPU_TORCH_KERNELS`` flip must not reuse a bucket
        prepared under the other mode)."""
        return (sig, kernel_registry.mode())

    def _signature(self, feed_vals):
        return tuple((tuple(int(d) for d in v.shape), str(v.dtype))
                     for v in feed_vals)

    def _compiled(self, sig):
        """The prepared bucket of one input signature: a hit returns the
        cached entry; a miss builds the plan and runs it once on zero
        feeds of that shape (the kernels' build, cuBLAS's first calls and
        the allocator's first blocks land here, not in a request)."""
        cache_key = self._cache_key(sig)
        reg = obs_metrics.registry()
        with self._cache_lock:
            hit = self._cache.get(cache_key)
            if hit is not None:
                self._cache_stats["hits"] += 1
                reg.counter("predictor_cache_hits_total",
                            "prepared-bucket cache hits").inc()
                return hit
            self._cache_stats["misses"] += 1
            reg.counter("predictor_cache_misses_total",
                        "prepared-bucket cache misses (bucket lookups that "
                        "prepared the bucket)").inc()
        t0 = time.perf_counter()
        block = self._program.global_block()
        entry = _Bucket(block_plan(block),
                        {n for op in block.ops for n in op.input_names()})
        self._run(entry, [np.zeros(s, dtype=d) for s, d in sig])
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        dt = time.perf_counter() - t0
        reg.histogram("predictor_compile_seconds",
                      "bucket preparation latency").observe(dt)
        with self._cache_lock:
            self._cache_stats["compile_s"] += dt
            self._cache[cache_key] = entry
        return entry

    def cache_stats(self):
        """Bucket-cache counters, shared across clones: {hits, misses,
        compile_s, persistent_hits}. A warmed serving engine holds misses
        constant while hits grow; persistent_hits is always 0 (no on-disk
        tier)."""
        with self._cache_lock:
            return dict(self._cache_stats)

    def _run(self, entry, feed_vals):
        """One eager run of the plan: feeds to the device, every op, the
        fetches as device tensors. Nothing is written back to the shared
        scope (batch_norm's MeanOut / VarianceOut and every other
        persistable output stay in the run's own env)."""
        exe, block = self._exe, self._program.global_block()
        with torch.inference_mode():
            env = {}
            for n, v in zip(self._feed_names, feed_vals):
                if n in entry.read or n in self._fetch_names:
                    env[n] = exe._to_device(v, block._find_var_recursive(n))
            exe._run_steps(entry.steps, env, self._scope, block,
                           self._run_key)
            return [env[n] if n in env
                    else exe._from_scope(self._scope, n, block)
                    for n in self._fetch_names]

    def _execute_feeds(self, feed_vals):
        """Shared execution tail of run()/run_batch(): signature, bucket
        lookup, run. ONE place defines the signature format the
        warmup/bucket machinery matches."""
        return self._run(self._compiled(self._signature(feed_vals)),
                         feed_vals)

    # -- batched serving (serving/ drives these) ---------------------------
    def run_batch(self, feeds):
        """Dict-in/dict-out single-shot run that bypasses the zero-copy
        handles — the serving hot path. Each engine worker owns a clone."""
        feed_vals = []
        for n in self._feed_names:
            enforce(n in feeds, f"run_batch feed missing input '{n}'")
            feed_vals.append(np.ascontiguousarray(feeds[n]))
        outs = self._execute_feeds(feed_vals)
        return {n: _to_numpy(o) for n, o in zip(self._fetch_names, outs)}

    def _bucket_signature(self, batch, seq):
        """Concrete feed signature for one lattice point: each feed var's
        first -1 dim takes the batch bucket, every later -1 takes the
        length bucket (a fixed-shape var serves as declared)."""
        block = self._program.global_block()
        sig = []
        for n in self._feed_names:
            v = block._find_var_recursive(n)
            enforce(v is not None, f"feed var '{n}' not in program")
            shape, saw_batch = [], False
            for d in v.shape:
                if int(d) != -1:
                    shape.append(int(d))
                elif not saw_batch:
                    shape.append(int(batch))
                    saw_batch = True
                else:
                    enforce(
                        seq is not None,
                        f"feed '{n}' has a variable non-batch dim "
                        f"{list(v.shape)}: set_serving_buckets needs "
                        "seq_lens to warm it",
                    )
                    shape.append(int(seq))
            sig.append((tuple(shape), str(v.dtype)))
        return tuple(sig)

    def warmup(self, buckets=None):
        """Prepare every serving bucket so no request pays the first run
        of a shape. `buckets` overrides Config.set_serving_buckets.
        Returns [(signature, seconds)] per newly prepared bucket."""
        spec = buckets if buckets is not None else \
            self._config.serving_buckets()
        enforce(
            spec is not None,
            "warmup needs buckets: call Config.set_serving_buckets first",
        )
        prepared = []
        for b in spec["batch_sizes"]:
            for s in spec["seq_lens"] or (None,):
                sig = self._bucket_signature(b, s)
                if self._cache_key(sig) in self._cache:
                    continue
                t0 = time.perf_counter()
                self._compiled(sig)
                prepared.append((sig, time.perf_counter() - t0))
        return prepared

    # -- management --------------------------------------------------------
    def clone(self):
        """Share weights, program and the bucket cache; own executor and
        I/O handles (reference: AnalysisPredictor::Clone —
        thread-per-predictor serving)."""
        return Predictor(
            self._config,
            _shared=(self._program, self._feed_names, self._fetch_names,
                     self._scope, self._cache, self._analysis_stats,
                     self._cache_stats, self._cache_lock),
        )

    def get_serialized_program(self):
        """reference: AnalysisPredictor::GetSerializedProgram."""
        return self._program.to_bytes()

    def save_optim_model(self, dirname):
        """Persist the analyzed program and the (possibly precision-cast)
        weights (reference: AnalysisPredictor::SaveOptimModel)."""
        from paddle_tpu_torch.io import _write_combined, to_host

        os.makedirs(dirname, exist_ok=True)
        desc = json.loads(self._program.to_bytes().decode("utf-8"))
        desc["feed_var_names"] = self._feed_names
        desc["fetch_var_names"] = self._fetch_names
        with open(os.path.join(dirname, "__model__"), "wb") as f:
            f.write(json.dumps(desc).encode("utf-8"))
        block = self._program.global_block()
        arrays = {}
        for n in sorted(self._scope.var_names()):
            v = block._find_var_recursive(n)
            if v is not None and v.persistable:
                arrays[n] = to_host(self._scope.find_var(n))
        _write_combined(os.path.join(dirname, "__params__"), arrays)

    def analysis_stats(self):
        """Per-pass statistics from the analysis pipeline."""
        return dict(self._analysis_stats)

    def clear_intermediate_tensor(self):
        """reference: AnalysisPredictor::ClearIntermediateTensor. A run's
        intermediates live in its own env and go when it returns."""

    def try_shrink_memory(self):
        """Drop the prepared buckets and the allocator's cached blocks."""
        with self._cache_lock:
            self._cache.clear()
        if self._device.type == "cuda":
            torch.cuda.empty_cache()
        return True


def create_predictor(config):
    """reference: CreatePaddlePredictor<AnalysisConfig> /
    paddle_infer::CreatePredictor."""
    return Predictor(config)
