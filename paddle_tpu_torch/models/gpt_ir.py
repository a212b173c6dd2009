"""GPT built on the Program/IR path with hybrid parallelism, the
counterpart of the JAX package's ``models/gpt_ir.py`` (the same op
types, attributes and parameter names).

The decoder stack is a ``layers.PipelinedStack`` (ONE ``pipeline_stack``
op running the GPipe schedule over the 'stage' mesh axis), tensor
parallelism is Megatron column/row-parallel weights declared with
per-layer specs plus an explicit ``c_allreduce_sum`` on ring 1, bound to
the 'model' axis, and data parallelism is the batch on 'data' under
``CompiledProgram.with_parallel``. A user drives it like any fluid
program: build, minimize, compile, ``exe.run``.
"""

import math

import paddle_tpu_torch as fluid
from paddle_tpu_torch.param_attr import ParamAttr


class GPTIRConfig:
    def __init__(self, vocab_size=256, hidden_size=64, num_layers=4,
                 num_heads=4, ffn_mult=4, max_seq_len=64, tp=1,
                 use_flash_attention=True):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_mult = ffn_mult
        self.max_seq_len = max_seq_len
        # tensor-parallel degree is a BUILD-time quantity (Megatron-style):
        # reshape attrs inside the layer body use per-shard head counts
        self.tp = tp
        # fused scaled_dot_product_attention op (the flash kernels K1, K2a
        # and K2b on the card): no [1,1,S,S] bias materialization, no S^2
        # probs buffer. False falls back to the unfused matmul/softmax
        # path (kept for parity testing).
        self.use_flash_attention = use_flash_attention


def _causal_bias(seq_len):
    """[1, 1, S, S] additive causal mask built IN-GRAPH from an O(S)
    position vector (an O(S^2) assign_value attr would bloat the program
    quadratically at long sequence lengths)."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("causal_pos")
    pos = helper.block.create_var(
        name=helper.name, shape=[seq_len], dtype="float32",
        stop_gradient=True,
    )
    helper.append_op(
        "assign_value",
        {},
        {"Out": [pos.name]},
        {"shape": [seq_len], "dtype": "float32",
         "values": [float(i) for i in range(seq_len)]},
    )
    rows = fluid.layers.reshape(pos, [seq_len, 1])
    cols = fluid.layers.reshape(pos, [1, seq_len])
    future = fluid.layers.cast(
        fluid.layers.greater_than(cols, rows), "float32"
    )  # 1 above the diagonal
    bias = fluid.layers.scale(future, scale=-1e9)
    out = fluid.layers.reshape(bias, [1, 1, seq_len, seq_len])
    out.stop_gradient = True
    return out


def build_gpt_ir(cfg, seq_len, num_microbatches=1, lr=1e-3):
    """Returns (main, startup, feeds, loss, stack). The batch size is a
    run-time property of the feed (dim 0 is dynamic)."""
    H = cfg.hidden_size
    n_local_heads = cfg.num_heads // cfg.tp
    d_head = H // cfg.num_heads
    h_local = n_local_heads * d_head            # attention width per shard
    init = fluid.initializer.TruncatedNormal(0.0, 0.02)

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        tokens = fluid.data("tokens", shape=[-1, seq_len], dtype="int64")
        labels = fluid.data("labels", shape=[-1, seq_len], dtype="int64")
        emb = fluid.layers.embedding(
            tokens, size=[cfg.vocab_size, H],
            param_attr=ParamAttr(name="wte", initializer=init),
        )
        pos = fluid.layers.embedding(
            _pos_ids(seq_len), size=[cfg.max_seq_len, H],
            param_attr=ParamAttr(name="wpe", initializer=init),
        )
        x = fluid.layers.elementwise_add(emb, pos)
        flash = getattr(cfg, "use_flash_attention", True)
        # unfused fallback needs the additive causal mask materialized;
        # the sdpa op handles causality inside the kernel (no S^2 buffer)
        bias = None if flash else _causal_bias(seq_len)

        stack = fluid.layers.PipelinedStack(
            num_layers=cfg.num_layers,
            num_microbatches=num_microbatches,
            ring_bindings={1: "model"},
        )
        with stack.layer():
            h = stack.input(x)
            ln1_s = stack.layer_param([H], attr=ParamAttr(
                initializer=fluid.initializer.Constant(1.0)))
            ln1_b = stack.layer_param([H], is_bias=True)
            # column-parallel q/k/v (separate weights: a fused [q|k|v]
            # concat cannot be contiguously sharded per head group); shapes
            # are GLOBAL — the ('model') spec splits them per shard
            w_q, w_k, w_v = (
                stack.layer_param([H, H], attr=ParamAttr(initializer=init),
                                  spec=(None, "model"))
                for _ in range(3)
            )
            b_q, b_k, b_v = (
                stack.layer_param([H], is_bias=True, spec=("model",))
                for _ in range(3)
            )
            # row-parallel attn out: global [H, H], dim 0 sharded
            w_ao = stack.layer_param(
                [H, H], attr=ParamAttr(initializer=init),
                spec=("model", None),
            )
            b_ao = stack.layer_param([H], is_bias=True)
            ln2_s = stack.layer_param([H], attr=ParamAttr(
                initializer=fluid.initializer.Constant(1.0)))
            ln2_b = stack.layer_param([H], is_bias=True)
            w_f1 = stack.layer_param(
                [H, cfg.ffn_mult * H], attr=ParamAttr(initializer=init),
                spec=(None, "model"),
            )
            b_f1 = stack.layer_param([cfg.ffn_mult * H], is_bias=True,
                                     spec=("model",))
            w_f2 = stack.layer_param(
                [cfg.ffn_mult * H, H], attr=ParamAttr(initializer=init),
                spec=("model", None),
            )
            b_f2 = stack.layer_param([H], is_bias=True)

            # -- attention ---------------------------------------------
            hn = _ln(h, ln1_s, ln1_b)
            q = fluid.layers.elementwise_add(fluid.layers.matmul(hn, w_q), b_q)
            k = fluid.layers.elementwise_add(fluid.layers.matmul(hn, w_k), b_k)
            v = fluid.layers.elementwise_add(fluid.layers.matmul(hn, w_v), b_v)

            def heads(t):
                t = fluid.layers.reshape(
                    t, [0, seq_len, n_local_heads, d_head]
                )
                return fluid.layers.transpose(t, [0, 2, 1, 3])

            qh, kh, vh = heads(q), heads(k), heads(v)
            if flash:
                ctx = fluid.layers.scaled_dot_product_attention(
                    qh, kh, vh, causal=True,
                    sm_scale=1.0 / math.sqrt(d_head),
                )
            else:
                scores = fluid.layers.matmul(
                    qh, kh, transpose_y=True, alpha=1.0 / math.sqrt(d_head)
                )
                scores = fluid.layers.elementwise_add(scores, bias)
                probs = fluid.layers.softmax(scores)
                ctx = fluid.layers.matmul(probs, vh)
            ctx = fluid.layers.transpose(ctx, [0, 2, 1, 3])
            ctx = fluid.layers.reshape(ctx, [0, seq_len, h_local])
            attn = fluid.layers.matmul(ctx, w_ao)  # partial over 'model'
            attn = fluid.layers.collective._allreduce(attn, ring_id=1)
            attn = fluid.layers.elementwise_add(attn, b_ao)
            h1 = fluid.layers.elementwise_add(h, attn)

            # -- mlp ----------------------------------------------------
            hm = _ln(h1, ln2_s, ln2_b)
            f = fluid.layers.gelu(
                fluid.layers.elementwise_add(
                    fluid.layers.matmul(hm, w_f1), b_f1
                )
            )
            f = fluid.layers.matmul(f, w_f2)  # partial over 'model'
            f = fluid.layers.collective._allreduce(f, ring_id=1)
            f = fluid.layers.elementwise_add(f, b_f2)
            h2 = fluid.layers.elementwise_add(h1, f)
            stack.output(h2)
        hs = stack()

        lnf_s = _vec_param("lnf_s", H, fluid.initializer.Constant(1.0))
        lnf_b = _vec_param("lnf_b", H, fluid.initializer.Constant(0.0))
        hs = _ln(hs, lnf_s, lnf_b)
        logits = fluid.layers.matmul(hs, _mat_param("head_w", [H, cfg.vocab_size], init))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(
                logits, fluid.layers.reshape(labels, [0, seq_len, 1])
            )
        )
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, [tokens, labels], loss, stack


def _pos_ids(seq_len):
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("pos_ids")
    out = helper.block.create_var(
        name=helper.name, shape=[1, seq_len], dtype="int64",
        stop_gradient=True,
    )
    helper.append_op(
        "assign_value",
        {},
        {"Out": [out.name]},
        {"shape": [1, seq_len], "dtype": "int64",
         "values": list(range(seq_len))},
    )
    return out


def _vec_param(name, size, initializer):
    return _mat_param(name, [size], initializer)


def _mat_param(name, shape, initializer):
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("gpt_ir_param")
    return helper.create_parameter(
        ParamAttr(name=name, initializer=initializer), shape=shape,
        dtype="float32",
    )


def _ln(x, scale, bias):
    """layer_norm op applied with EXPLICIT scale/bias vars (the layer fn
    creates its own params; the pipeline body needs per-layer stacked
    ones)."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("ln_apply")
    out = helper.create_variable_for_type_inference(x.dtype)
    mean = helper.create_variable_for_type_inference(x.dtype)
    var = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "layer_norm",
        {"X": [x.name], "Scale": [scale.name], "Bias": [bias.name]},
        {"Y": [out.name], "Mean": [mean.name], "Variance": [var.name]},
        {"begin_norm_axis": 2, "epsilon": 1e-5},
    )
    return out


def synthetic_batch(rng, batch, seq_len, cfg):
    toks = rng.randint(0, cfg.vocab_size, (batch, seq_len + 1))
    return (
        toks[:, :-1].astype("int64"),
        toks[:, 1:].astype("int64"),
    )
