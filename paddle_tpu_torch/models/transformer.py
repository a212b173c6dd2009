"""Transformer encoder-decoder for WMT en-de, training program: copied from
the JAX package's ``models/transformer.py`` (``TransformerConfig``,
``build_wmt_train``, ``synthetic_batch``) so both packages build the same
program (op types, attributes and var names).

Teacher-forced training with label smoothing, a tied output projection
and, by default, Adam over the Noam learning-rate schedule; any optimizer
may be passed instead (``DGCMomentumOptimizer`` for data-parallel training
with Deep Gradient Compression, through ``CompiledProgram``). With
``dropout > 0`` (0.1 in ``base()``, Vaswani et al.'s recipe) the
embeddings, the attention probabilities and each sublayer's output go
through ``dropout`` ops (``upscale_in_train``) whose masks are
``jax.random``'s, drawn from the executor's keys; a data-parallel run
folds the rank into its key, so the ranks' masks differ. The
functional beam decoder (``make_beam_decoder``, ``BucketedBeamTranslator``)
waits for a later slice (M4).
"""

import math

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["TransformerConfig", "build_wmt_train", "synthetic_batch"]


class TransformerConfig:
    def __init__(
        self,
        vocab_size=37000,
        d_model=1024,
        n_heads=16,
        d_ffn=4096,
        n_enc_layers=6,
        n_dec_layers=6,
        max_len=256,
        dropout=0.1,
        label_smooth=0.1,
        bos_id=0,
        eos_id=1,
        pad_id=2,
        pre_ln=True,
    ):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_heads = n_heads
        self.d_ffn = d_ffn
        self.n_enc_layers = n_enc_layers
        self.n_dec_layers = n_dec_layers
        self.max_len = max_len
        self.dropout = dropout
        self.label_smooth = label_smooth
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        # pre-LN ("normalize_before") trains stably without long warmup;
        # post-LN (pre_ln=False) matches the 2017 paper layout
        self.pre_ln = pre_ln

    @staticmethod
    def big():
        return TransformerConfig()

    @staticmethod
    def base():
        return TransformerConfig(d_model=512, n_heads=8, d_ffn=2048)

    @staticmethod
    def tiny():
        return TransformerConfig(
            vocab_size=64, d_model=32, n_heads=4, d_ffn=64,
            n_enc_layers=2, n_dec_layers=2, max_len=32, dropout=0.0,
        )


def _sinusoid(max_len, d_model):
    pos = np.arange(max_len)[:, None].astype("float64")
    i = np.arange(d_model)[None, :].astype("float64")
    angle = pos / np.power(10000.0, 2 * (i // 2) / d_model)
    enc = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return enc.astype("float32")


# ---------------------------------------------------------------------------
# IR training program
# ---------------------------------------------------------------------------


def _init(cfg):
    return fluid.initializer.Xavier()


def _dense(x, size, cfg, act=None, name=None, nfd=2):
    return fluid.layers.fc(
        x, size=size, num_flatten_dims=nfd, act=act,
        param_attr=ParamAttr(name=name + ".w", initializer=_init(cfg)),
        bias_attr=ParamAttr(name=name + ".b"),
        name=name,
    )


def _ln(x, cfg, name):
    return fluid.layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name=name + ".scale"),
        bias_attr=ParamAttr(name=name + ".bias"),
        name=name,
    )


def _mha(q_in, kv_in, bias, cfg, name):
    """Multi-head attention through IR ops; bias is additive, broadcastable
    to [B, heads, Sq, Sk]."""
    H, n, d = cfg.d_model, cfg.n_heads, cfg.d_model // cfg.n_heads
    q = _dense(q_in, H, cfg, name=name + ".q")
    k = _dense(kv_in, H, cfg, name=name + ".k")
    v = _dense(kv_in, H, cfg, name=name + ".v")

    def split(t):
        t = fluid.layers.reshape(t, [0, 0, n, d])
        return fluid.layers.transpose(t, [0, 2, 1, 3])

    q, k, v = split(q), split(k), split(v)
    scores = fluid.layers.matmul(q, k, transpose_y=True, alpha=1.0 / math.sqrt(d))
    scores = fluid.layers.elementwise_add(scores, bias)
    probs = fluid.layers.softmax(scores)
    if cfg.dropout:
        probs = fluid.layers.dropout(
            probs, cfg.dropout, dropout_implementation="upscale_in_train"
        )
    ctx = fluid.layers.matmul(probs, v)
    ctx = fluid.layers.transpose(ctx, [0, 2, 1, 3])
    ctx = fluid.layers.reshape(ctx, [0, 0, H])
    return _dense(ctx, H, cfg, name=name + ".out")


def _res_drop(x, y, cfg):
    if cfg.dropout:
        y = fluid.layers.dropout(
            y, cfg.dropout, dropout_implementation="upscale_in_train"
        )
    return fluid.layers.elementwise_add(x, y)


def _ffn(x, cfg, name):
    h = _dense(x, cfg.d_ffn, cfg, act="relu", name=name + "1")
    return _dense(h, cfg.d_model, cfg, name=name + "2")


def _embed(ids, cfg, pos_table, name_prefix=""):
    emb = fluid.layers.embedding(
        ids, size=[cfg.vocab_size, cfg.d_model],
        param_attr=ParamAttr(name="word_emb", initializer=_init(cfg)),
    )
    emb = fluid.layers.scale(emb, scale=math.sqrt(cfg.d_model))
    emb = fluid.layers.elementwise_add(emb, pos_table)
    if cfg.dropout:
        emb = fluid.layers.dropout(
            emb, cfg.dropout, dropout_implementation="upscale_in_train"
        )
    return emb


def _const(arr, name, dtype):
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("const_" + name)
    out = helper.block.create_var(
        name=helper.name, shape=list(arr.shape), dtype=dtype, stop_gradient=True
    )
    helper.append_op(
        "assign_value", {}, {"Out": [out.name]},
        {"shape": list(arr.shape), "dtype": dtype,
         "values": np.asarray(arr).reshape(-1).tolist()},
    )
    return out


def build_wmt_train(cfg=None, src_len=64, tgt_len=64, lr=2.0, warmup=4000,
                    optimizer=None):
    """Teacher-forced training program with label smoothing and Noam LR.
    Feeds: src_ids [B,S], tgt_ids [B,T] (decoder input, BOS-prefixed),
    labels [B,T] (gold, EOS-suffixed); pad_id positions are masked out.
    Returns (main, startup, feeds, fetches=[loss])."""
    cfg = cfg or TransformerConfig.base()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src_ids = fluid.data("src_ids", shape=[-1, src_len], dtype="int64")
        tgt_ids = fluid.data("tgt_ids", shape=[-1, tgt_len], dtype="int64")
        labels = fluid.data("labels", shape=[-1, tgt_len], dtype="int64")

        pos_src = _const(_sinusoid(src_len, cfg.d_model)[None], "pos_src", "float32")
        pos_tgt = _const(_sinusoid(tgt_len, cfg.d_model)[None], "pos_tgt", "float32")

        # masks -> additive biases
        src_pad = fluid.layers.cast(
            fluid.layers.tensor.not_equal(
                src_ids, fluid.layers.tensor.fill_constant([1], "int64", cfg.pad_id)
            ), "float32",
        )  # [B,S] 1=token
        src_bias = fluid.layers.reshape(
            fluid.layers.scale(src_pad, scale=1e4, bias=-1e4), [0, 1, 1, src_len]
        )
        causal = np.triu(np.full((tgt_len, tgt_len), -1e4, "float32"), k=1)
        tgt_bias = _const(causal[None, None], "causal", "float32")

        # encoder
        x = _embed(src_ids, cfg, pos_src)
        for i in range(cfg.n_enc_layers):
            nm = f"enc_{i}"
            if cfg.pre_ln:
                xn = _ln(x, cfg, nm + ".ln1")
                x = _res_drop(x, _mha(xn, xn, src_bias, cfg, nm + ".self"), cfg)
                x = _res_drop(x, _ffn(_ln(x, cfg, nm + ".ln2"), cfg, nm + ".ffn"), cfg)
            else:
                x = _ln(_res_drop(x, _mha(x, x, src_bias, cfg, nm + ".self"), cfg),
                        cfg, nm + ".ln1")
                x = _ln(_res_drop(x, _ffn(x, cfg, nm + ".ffn"), cfg), cfg, nm + ".ln2")
        if cfg.pre_ln:
            x = _ln(x, cfg, "enc_ln")
        enc_out = x

        # decoder
        y = _embed(tgt_ids, cfg, pos_tgt)
        for i in range(cfg.n_dec_layers):
            nm = f"dec_{i}"
            if cfg.pre_ln:
                yn = _ln(y, cfg, nm + ".ln1")
                y = _res_drop(y, _mha(yn, yn, tgt_bias, cfg, nm + ".self"), cfg)
                y = _res_drop(
                    y, _mha(_ln(y, cfg, nm + ".ln2"), enc_out, src_bias, cfg,
                            nm + ".cross"), cfg)
                y = _res_drop(y, _ffn(_ln(y, cfg, nm + ".ln3"), cfg, nm + ".ffn"), cfg)
            else:
                y = _ln(_res_drop(y, _mha(y, y, tgt_bias, cfg, nm + ".self"), cfg),
                        cfg, nm + ".ln1")
                y = _ln(_res_drop(y, _mha(y, enc_out, src_bias, cfg, nm + ".cross"), cfg),
                        cfg, nm + ".ln2")
                y = _ln(_res_drop(y, _ffn(y, cfg, nm + ".ffn"), cfg), cfg, nm + ".ln3")
        if cfg.pre_ln:
            y = _ln(y, cfg, "dec_ln")

        # tied output projection: logits = y @ word_emb^T
        word_emb = main.global_block().var("word_emb")
        logits = fluid.layers.matmul(y, word_emb, transpose_y=True)  # [B,T,V]

        # label-smoothed CE over non-pad positions
        labels3 = fluid.layers.reshape(labels, [0, tgt_len, 1])
        nll = fluid.layers.softmax_with_cross_entropy(logits, labels3, axis=-1)
        logp = fluid.layers.log_softmax(logits)  # [B,T,V]
        uniform = fluid.layers.scale(
            fluid.layers.reduce_sum(logp, dim=[-1], keep_dim=True),
            scale=-1.0 / cfg.vocab_size,
        )
        eps = cfg.label_smooth
        tok_loss = fluid.layers.elementwise_add(
            fluid.layers.scale(nll, scale=1.0 - eps),
            fluid.layers.scale(uniform, scale=eps),
        )  # [B,T,1]
        non_pad = fluid.layers.cast(
            fluid.layers.tensor.not_equal(
                labels, fluid.layers.tensor.fill_constant([1], "int64", cfg.pad_id)
            ), "float32",
        )
        non_pad3 = fluid.layers.reshape(non_pad, [0, tgt_len, 1])
        denom = fluid.layers.elementwise_max(
            fluid.layers.reduce_sum(non_pad3),
            fluid.layers.tensor.fill_constant([1], "float32", 1.0),
        )
        loss = fluid.layers.elementwise_div(
            fluid.layers.reduce_sum(
                fluid.layers.elementwise_mul(tok_loss, non_pad3)
            ),
            denom,
        )

        if optimizer is None:
            sched = fluid.layers.scale(
                fluid.layers.learning_rate_scheduler.noam_decay(
                    cfg.d_model, warmup_steps=warmup
                ),
                scale=lr,
            )
            optimizer = fluid.optimizer.Adam(
                learning_rate=sched, beta1=0.9, beta2=0.997, epsilon=1e-9
            )
        optimizer.minimize(loss)
    return main, startup, [src_ids, tgt_ids, labels], [loss]


def synthetic_batch(rng, batch, src_len, tgt_len, cfg):
    """Copy-task data: target = source (the model must learn identity),
    giving a real learnable signal for convergence tests."""
    body = rng.randint(3, cfg.vocab_size, (batch, src_len - 1)).astype("int64")
    src = np.concatenate(
        [body, np.full((batch, 1), cfg.pad_id, "int64")], axis=1
    )
    tgt_in = np.full((batch, tgt_len), cfg.pad_id, "int64")
    labels = np.full((batch, tgt_len), cfg.pad_id, "int64")
    L = min(tgt_len - 1, src_len - 1)
    tgt_in[:, 0] = cfg.bos_id
    tgt_in[:, 1:L + 1] = body[:, :L]
    labels[:, :L] = body[:, :L]
    labels[:, L] = cfg.eos_id
    return {"src_ids": src, "tgt_ids": tgt_in, "labels": labels}
