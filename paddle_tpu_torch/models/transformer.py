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
folds the rank into its key, so the ranks' masks differ.

Beam-search inference is the JAX package's functional decoder
(``params_from_scope``, ``make_beam_decoder``, ``BucketedBeamTranslator``):
the weights by name, an encoder, and a KV-cached decoder step over
static ``[batch, beam, max_len]`` state. The JAX package runs the whole
search as one jitted ``lax.while_loop``; here it is an eager loop on
tensors whose attention is plain products and a softmax over the cache
(there is no Pallas kernel on this path in the JAX package either). The
loop stops where the JAX loop does, at ``max_len`` or when every beam
has finished, which it reads on the host once a step (one device sync a
step, counted in the translator's ``stats``). The beams' top-k keeps
``lax.top_k``'s order among equal candidates, the lower flat index
first (a stable descending sort), and finished beams keep their frozen
lengths for the GNMT length penalty.
"""

import math
import time

import numpy as np
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.places import default_place
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["TransformerConfig", "build_wmt_train", "param_names",
           "params_from_scope", "make_beam_decoder", "decode_logits",
           "BucketedBeamTranslator", "synthetic_batch"]


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


# ---------------------------------------------------------------------------
# functional decoder (beam search)
# ---------------------------------------------------------------------------


def param_names(cfg):
    """The names of the weights the functional decoder reads, as
    ``build_wmt_train`` names them."""
    names = ["word_emb"]
    for i in range(cfg.n_enc_layers):
        nm = f"enc_{i}"
        for part in (".self.q", ".self.k", ".self.v", ".self.out",
                     ".ffn1", ".ffn2"):
            names += [nm + part + ".w", nm + part + ".b"]
        for part in (".ln1", ".ln2"):
            names += [nm + part + ".scale", nm + part + ".bias"]
    for i in range(cfg.n_dec_layers):
        nm = f"dec_{i}"
        for part in (".self.q", ".self.k", ".self.v", ".self.out",
                     ".cross.q", ".cross.k", ".cross.v", ".cross.out",
                     ".ffn1", ".ffn2"):
            names += [nm + part + ".w", nm + part + ".b"]
        for part in (".ln1", ".ln2", ".ln3"):
            names += [nm + part + ".scale", nm + part + ".bias"]
    if cfg.pre_ln:
        for nm in ("enc_ln", "dec_ln"):
            names += [nm + ".scale", nm + ".bias"]
    return names


def params_from_scope(cfg, scope=None):
    """Pull trained weights by name into a flat dict of tensors (on the
    device the scope holds them on)."""
    scope = scope or fluid.global_scope()
    out = {}
    for n in param_names(cfg):
        v = scope.find_var(n)
        if v is None:
            raise KeyError(f"parameter {n} not found in scope (train first?)")
        out[n] = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
    return out


def _scalar(v, like):
    """``v`` as a float32 0-d tensor beside ``like``: the JAX code's Python
    scalars are float32 operands, and a 0-d divisor divides (torch
    multiplies by the reciprocal of a Python scalar divisor on CUDA)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _f_ln(p, nm, x):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * p[nm + ".scale"] + p[nm + ".bias"]


def _f_dense(p, nm, x, act=None):
    y = x @ p[nm + ".w"] + p[nm + ".b"]
    return torch.relu(y) if act == "relu" else y


def _f_heads(cfg, t):
    B, S, _ = t.shape
    return t.reshape(B, S, cfg.n_heads, -1).permute(0, 2, 1, 3)


def _f_attend(q, k, v, bias, d_h):
    s = q @ k.transpose(-1, -2) / _scalar(math.sqrt(d_h), q) + bias
    return torch.softmax(s, dim=-1) @ v


def _f_mha(p, nm, cfg, q_in, kv_in, bias):
    d = cfg.d_model // cfg.n_heads
    q = _f_heads(cfg, _f_dense(p, nm + ".q", q_in))
    k = _f_heads(cfg, _f_dense(p, nm + ".k", kv_in))
    v = _f_heads(cfg, _f_dense(p, nm + ".v", kv_in))
    ctx = _f_attend(q, k, v, bias, d)
    B = ctx.shape[0]
    ctx = ctx.permute(0, 2, 1, 3).reshape(B, -1, cfg.d_model)
    return _f_dense(p, nm + ".out", ctx)


def _f_ffn(p, nm, x):
    return _f_dense(p, nm + ".ffn2", _f_dense(p, nm + ".ffn1", x, act="relu"))


def _f_embed(p, cfg, ids, pos):
    """``word_emb[ids] * sqrt(d_model) + pos`` (``pos`` broadcasts)."""
    return p["word_emb"][ids] * _scalar(math.sqrt(cfg.d_model),
                                        p["word_emb"]) + pos


def _f_encode(p, cfg, src_ids):
    """src_ids [B,S] -> (enc_out [B,S,H], src_bias [B,1,1,S])."""
    B, S = src_ids.shape
    dev = p["word_emb"].device
    x = _f_embed(p, cfg, src_ids,
                 torch.from_numpy(_sinusoid(S, cfg.d_model)).to(dev)[None])
    src_bias = torch.where(src_ids == cfg.pad_id,
                           _scalar(-1e4, x), _scalar(0.0, x))
    src_bias = src_bias[:, None, None, :]
    for i in range(cfg.n_enc_layers):
        nm = f"enc_{i}"
        if cfg.pre_ln:
            xn = _f_ln(p, nm + ".ln1", x)
            x = x + _f_mha(p, nm + ".self", cfg, xn, xn, src_bias)
            x = x + _f_ffn(p, nm, _f_ln(p, nm + ".ln2", x))
        else:
            x = _f_ln(p, nm + ".ln1",
                      x + _f_mha(p, nm + ".self", cfg, x, x, src_bias))
            x = _f_ln(p, nm + ".ln2", x + _f_ffn(p, nm, x))
    if cfg.pre_ln:
        x = _f_ln(p, "enc_ln", x)
    return x, src_bias


def _on(params, src_ids, device):
    """The weights and the source ids on ``device`` (no copy where they
    already are)."""
    p = {n: t.to(device) for n, t in params.items()}
    if not isinstance(src_ids, torch.Tensor):
        src_ids = torch.from_numpy(np.asarray(src_ids))
    return p, src_ids.to(device=device, dtype=torch.int64)


@torch.no_grad()
def decode_logits(params, cfg, src_ids, tgt_ids, place=None):
    """The decoder's logits ``[B, T, V]`` for teacher-forced inputs
    ``tgt_ids`` [B, T] (BOS first), in one pass with a causal mask and no
    KV cache: the reference a cached beam step is held to."""
    device = default_place(place).device
    p, src_ids = _on(params, src_ids, device)
    tgt_ids = torch.as_tensor(np.asarray(tgt_ids) if not isinstance(
        tgt_ids, torch.Tensor) else tgt_ids).to(device=device, dtype=torch.int64)
    enc_out, src_bias = _f_encode(p, cfg, src_ids)
    T = tgt_ids.shape[1]
    y = _f_embed(p, cfg, tgt_ids,
                 torch.from_numpy(_sinusoid(T, cfg.d_model)).to(device)[None])
    causal = torch.triu(torch.full((T, T), -1e9, device=device), diagonal=1)
    for i in range(cfg.n_dec_layers):
        nm = f"dec_{i}"
        if cfg.pre_ln:
            yn = _f_ln(p, nm + ".ln1", y)
            y = y + _f_mha(p, nm + ".self", cfg, yn, yn, causal)
            y = y + _f_mha(p, nm + ".cross", cfg, _f_ln(p, nm + ".ln2", y),
                           enc_out, src_bias)
            y = y + _f_ffn(p, nm, _f_ln(p, nm + ".ln3", y))
        else:
            y = _f_ln(p, nm + ".ln1", y + _f_mha(p, nm + ".self", cfg, y, y,
                                                causal))
            y = _f_ln(p, nm + ".ln2", y + _f_mha(p, nm + ".cross", cfg, y,
                                                enc_out, src_bias))
            y = _f_ln(p, nm + ".ln3", y + _f_ffn(p, nm, y))
    if cfg.pre_ln:
        y = _f_ln(p, "dec_ln", y)
    return y @ p["word_emb"].T


def stable_top_k(x, k):
    """``lax.top_k`` over the last axis: the ``k`` largest, in descending
    order, the lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def make_beam_decoder(cfg, beam_size=4, max_len=None, length_penalty=0.6,
                      place=None):
    """Returns fn: (params, src_ids [B,S], trace=None) -> (tokens [B,L]
    int64, scores [B] float32), tensors on ``place`` (default
    ``CUDAPlace(0)``; it raises without a card). Greedy = beam_size 1.
    ``fn.stats`` counts the decode steps and the host syncs of the last
    call. A ``trace`` list receives each step's selected scores and flat
    candidate indices ``[B, K]`` as numpy (a copy to the host a step), to
    find the step at which two runs part."""
    max_len = max_len or cfg.max_len
    K, V, H = beam_size, cfg.vocab_size, cfg.d_model
    n_h, d_h = cfg.n_heads, cfg.d_model // cfg.n_heads
    NEG = -1e9
    device = default_place(place).device
    pos_table = torch.from_numpy(_sinusoid(max_len, cfg.d_model)).to(device)
    stats = {"steps": 0, "syncs": 0}

    def step_logits(p, tok, t, self_caches, cross_kv, src_bias):
        """tok [N] current input token; the caches take position ``t`` in
        place. Returns logits [N,V]."""
        N = tok.shape[0]
        x = _f_embed(p, cfg, tok, pos_table[t:t + 1])[:, None, :]  # [N,1,H]
        # causal bias over cache positions: only <= t visible
        valid = (torch.arange(max_len, device=device) <= t).to(torch.float32)
        self_bias = (1.0 - valid) * _scalar(NEG, valid)  # [max_len]

        def self_attn(nm, xin, i):
            q = _f_heads(cfg, _f_dense(p, nm + ".self.q", xin))  # [N,h,1,d]
            k1 = _f_heads(cfg, _f_dense(p, nm + ".self.k", xin))
            v1 = _f_heads(cfg, _f_dense(p, nm + ".self.v", xin))
            ck, cv = self_caches[i]
            ck[:, :, t:t + 1] = k1
            cv[:, :, t:t + 1] = v1
            ctx = _f_attend(q, ck, cv, self_bias, d_h)  # [N,h,1,d]
            ctx = ctx.permute(0, 2, 1, 3).reshape(N, 1, H)
            return _f_dense(p, nm + ".self.out", ctx)

        def cross_attn(nm, xin, i):
            ek, ev = cross_kv[i]  # [N,h,S,d]
            q2 = _f_heads(cfg, _f_dense(p, nm + ".cross.q", xin))
            ctx2 = _f_attend(q2, ek, ev, src_bias, d_h)
            ctx2 = ctx2.permute(0, 2, 1, 3).reshape(N, 1, H)
            return _f_dense(p, nm + ".cross.out", ctx2)

        for i in range(cfg.n_dec_layers):
            nm = f"dec_{i}"
            if cfg.pre_ln:
                x = x + self_attn(nm, _f_ln(p, nm + ".ln1", x), i)
                x = x + cross_attn(nm, _f_ln(p, nm + ".ln2", x), i)
                x = x + _f_ffn(p, nm, _f_ln(p, nm + ".ln3", x))
            else:
                x = _f_ln(p, nm + ".ln1", x + self_attn(nm, x, i))
                x = _f_ln(p, nm + ".ln2", x + cross_attn(nm, x, i))
                x = _f_ln(p, nm + ".ln3", x + _f_ffn(p, nm, x))
        if cfg.pre_ln:
            x = _f_ln(p, "dec_ln", x)
        return x[:, 0, :] @ p["word_emb"].T  # [N,V]

    @torch.no_grad()
    def decode(params, src_ids, trace=None):
        p, src_ids = _on(params, src_ids, device)
        B, S = src_ids.shape
        N = B * K
        enc_out, src_bias = _f_encode(p, cfg, src_ids)
        # expand to beams
        enc_out = enc_out.repeat_interleave(K, dim=0)        # [N,S,H]
        src_bias_n = src_bias.repeat_interleave(K, dim=0)    # [N,1,1,S]
        cross_kv = []
        for i in range(cfg.n_dec_layers):
            nm = f"dec_{i}"
            ek = _f_heads(cfg, _f_dense(p, nm + ".cross.k", enc_out))
            ev = _f_heads(cfg, _f_dense(p, nm + ".cross.v", enc_out))
            cross_kv.append((ek, ev))

        ys = torch.full((B, K, max_len), cfg.pad_id, dtype=torch.int64,
                        device=device)
        scores = torch.tensor([0.0] + [NEG] * (K - 1), dtype=torch.float32,
                              device=device)[None].repeat(B, 1)
        finished = torch.zeros((B, K), dtype=torch.bool, device=device)
        lengths = torch.zeros((B, K), dtype=torch.int64, device=device)
        tok = torch.full((N,), cfg.bos_id, dtype=torch.int64, device=device)
        caches = [
            (torch.zeros((N, n_h, max_len, d_h), device=device),
             torch.zeros((N, n_h, max_len, d_h), device=device))
            for _ in range(cfg.n_dec_layers)
        ]
        # finished beams: only EOS continuation, at zero added cost
        eos_only = torch.full((V,), NEG, dtype=torch.float32, device=device)
        eos_only[cfg.eos_id] = 0.0
        beam_base = torch.arange(B, device=device)[:, None] * K
        stats.update(steps=0, syncs=0)
        t = 0
        while t < max_len:
            logits = step_logits(p, tok, t, caches, cross_kv, src_bias_n)
            logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
            logp = torch.where(finished[:, :, None], eos_only, logp)
            cand = scores[:, :, None] + logp              # [B,K,V]
            scores, top_idx = stable_top_k(cand.reshape(B, K * V), K)
            if trace is not None:
                trace.append((scores.cpu().numpy(), top_idx.cpu().numpy()))
            beam_idx = top_idx // V                        # [B,K]
            new_tok = top_idx % V
            # reorder beam state
            ys = torch.gather(ys, 1, beam_idx[:, :, None].expand(B, K, max_len))
            was_finished = torch.gather(finished, 1, beam_idx)
            lengths = torch.gather(lengths, 1, beam_idx)
            # already-finished beams write pad (not EOS spam), and their
            # length stays frozen so the GNMT penalty compares true lengths
            ys[:, :, t] = torch.where(was_finished, cfg.pad_id, new_tok)
            lengths = torch.where(was_finished, lengths, t + 1)
            finished = was_finished | (new_tok == cfg.eos_id)
            flat_idx = (beam_base + beam_idx).reshape(-1)
            caches = [(ck[flat_idx], cv[flat_idx]) for ck, cv in caches]
            tok = new_tok.reshape(-1)
            t += 1
            stats["steps"] += 1
            if t < max_len:
                stats["syncs"] += 1
                if bool(finished.all()):
                    break
        # length penalty (GNMT): score / ((5+len)/6)^alpha
        lp = ((5.0 + lengths.to(torch.float32)) / 6.0) ** length_penalty
        norm = scores / torch.where(lp == 0, torch.ones_like(lp), lp)
        best = norm.argmax(dim=1)
        return (ys[torch.arange(B, device=device), best],
                norm.gather(1, best[:, None])[:, 0])

    decode.stats = stats
    return decode


class BucketedBeamTranslator:
    """Bucketed-length beam-search serving — BASELINE workload 4's
    inference half ("dynamic-shape sequences, beam-search infer"), as the
    JAX package's translator serves it: an incoming batch pads
    (cfg.pad_id) to the smallest bucket >= its length and, once
    ``warmup`` has bound a batch size, to that many rows, so traffic only
    ever meets the warmed shapes. Pad keys are masked in encoder
    self-attention AND decoder cross-attention (src_bias), so a
    bucket-padded result is the exact-length one (bit for bit on the CPU;
    on the card a GEMM's algorithm may change with the row count).
    ``warmup`` runs each bucket once before serving. Throughput is
    generated (non-pad) tokens per wall-second; ``stats`` also counts
    decode steps and host syncs. ``place`` defaults to ``CUDAPlace(0)``
    and raises without a card."""

    def __init__(self, cfg, params, beam_size=4,
                 src_buckets=(16, 32, 64, 128, 256), batch_size=None,
                 max_len=None, length_penalty=0.6, place=None):
        self.cfg = cfg
        self.device = default_place(place).device
        self.params = {n: t.to(self.device) for n, t in params.items()}
        self.batch_size = batch_size
        self.buckets = tuple(sorted(src_buckets))
        self._decode = make_beam_decoder(
            cfg, beam_size=beam_size, max_len=max_len,
            length_penalty=length_penalty, place=place,
        )
        self.stats = {
            "tokens": 0, "seconds": 0.0, "sentences": 0, "steps": 0,
            "syncs": 0, "bucket_hits": {b: 0 for b in self.buckets},
        }

    def _bucket_for(self, length):
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(
            f"source length {length} exceeds the largest bucket "
            f"{self.buckets[-1]} — add a bucket or truncate"
        )

    def warmup(self, batch_size=None):
        """Run every bucket once before serving. Warming BINDS the
        serving batch size: translate() then row-pads every request to it,
        so real traffic only ever meets the warmed shapes."""
        bs = batch_size or self.batch_size or 1
        self.batch_size = bs
        for b in self.buckets:
            dummy = torch.full((bs, b), self.cfg.pad_id, dtype=torch.int64,
                               device=self.device)
            toks, _ = self._decode(self.params, dummy)
            toks.cpu()
        return self

    def translate(self, src_ids):
        """src_ids [B, L] int -> (tokens [B, max_len], scores [B]) as
        numpy. Routes to the length bucket, padding batch rows if a fixed
        batch_size was configured."""
        src = np.asarray(src_ids)
        B, L = src.shape
        bucket = self._bucket_for(L)
        padded = np.full((B, bucket), self.cfg.pad_id, np.int64)
        padded[:, :L] = src
        rows = B
        if self.batch_size is not None:
            if B > self.batch_size:
                raise ValueError(
                    f"batch {B} > configured batch_size {self.batch_size}"
                )
            if B < self.batch_size:
                pad_rows = np.full(
                    (self.batch_size - B, bucket), self.cfg.pad_id, np.int64)
                padded = np.concatenate([padded, pad_rows], axis=0)
        t0 = time.perf_counter()
        toks, scores = self._decode(self.params, padded)
        toks = toks.cpu().numpy()[:rows]
        scores = scores.cpu().numpy()[:rows]
        dt = time.perf_counter() - t0
        generated = int((toks != self.cfg.pad_id).sum())
        self.stats["tokens"] += generated
        self.stats["seconds"] += dt
        self.stats["sentences"] += rows
        self.stats["steps"] += self._decode.stats["steps"]
        self.stats["syncs"] += self._decode.stats["syncs"]
        self.stats["bucket_hits"][bucket] += 1
        return toks, scores

    def tokens_per_sec(self):
        s = self.stats["seconds"]
        return self.stats["tokens"] / s if s else 0.0


def copy_task_recipe(steps=300, batch=32, src_len=12, tgt_len=12, lr=2e-3,
                     seed=0, place=None):
    """``examples/machine_translation.py``'s recipe in the port: the tiny
    Transformer trained on the copy task with Adam, then served through
    bucketed beam search (buckets 12 and 16, beam 4, batch 8), the
    example's gate being that most of 8 sources come back copied. Returns
    ``(cfg, losses, translator, body, toks, scores, copied)``."""
    cfg = TransformerConfig.tiny()
    main, startup, _, fetches = build_wmt_train(
        cfg, src_len=src_len, tgt_len=tgt_len,
        optimizer=fluid.optimizer.Adam(lr))
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    rng = np.random.RandomState(seed)
    losses = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(steps):
            feed = synthetic_batch(rng, batch, src_len, tgt_len, cfg)
            (loss,) = exe.run(main, feed=feed, fetch_list=[fetches[0]])
            losses.append(float(loss.reshape(-1)[0]))
        params = params_from_scope(cfg)
    translator = BucketedBeamTranslator(
        cfg, params, beam_size=4, src_buckets=(12, 16), place=place
    ).warmup(8)
    body = rng.randint(3, cfg.vocab_size, (8, 11)).astype("int64")
    toks, scores = translator.translate(body)
    copied = sum(
        [t for t in toks[i].tolist() if t not in (cfg.pad_id, cfg.eos_id)]
        == body[i].tolist() for i in range(len(body)))
    return cfg, losses, translator, body, toks, scores, copied


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
