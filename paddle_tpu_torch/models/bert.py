"""BERT pretraining, copied from the JAX package's ``models/bert.py`` so both
packages build the same program (op types, attributes and var names).

Transformer encoder built from framework layers. With
``use_flash_attention=True`` each layer's attention is one
``scaled_dot_product_attention`` op, which the port runs on its
hand-written flash-attention kernels (``kernels/flash_attention.py``), and
its grad op on their backward kernels. Hidden dropout (after the
embeddings and after each attention and FFN block) and, on the unfused
path, attention-prob dropout are ``dropout`` ops (``upscale_in_train``)
drawing ``jax.random``'s masks from the executor's keys, on the card
through K8 (``kernels/random.py``). The flash path refuses
attention-prob dropout, as the JAX builder does: the fused kernel applies
none.
"""

import math

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch.param_attr import ParamAttr
from paddle_tpu_torch.utils.enforce import EnforceError


class BertConfig:
    def __init__(
        self,
        vocab_size=30522,
        hidden_size=768,
        num_hidden_layers=12,
        num_attention_heads=12,
        intermediate_size=3072,
        max_position_embeddings=512,
        type_vocab_size=2,
        hidden_dropout_prob=0.1,
        attention_probs_dropout_prob=0.1,
        initializer_range=0.02,
        use_flash_attention=False,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range
        self.use_flash_attention = use_flash_attention

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        """For tests and dry runs."""
        return BertConfig(
            vocab_size=1024,
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=128,
            max_position_embeddings=128,
        )


def _init(cfg):
    return fluid.initializer.TruncatedNormal(0.0, cfg.initializer_range)


def _dense(x, size, cfg, act=None, name=None, num_flatten_dims=2):
    return fluid.layers.fc(
        x,
        size=size,
        num_flatten_dims=num_flatten_dims,
        act=act,
        param_attr=ParamAttr(initializer=_init(cfg), name=name + ".w" if name else None),
        bias_attr=ParamAttr(name=name + ".b" if name else None),
        name=name,
    )


def multi_head_attention(x, attn_bias, cfg, name):
    """Self-attention over [B, S, H]; attn_bias is additive [B, 1, 1, S]."""
    B_H = cfg.hidden_size
    n_head = cfg.num_attention_heads
    d_head = B_H // n_head
    q = _dense(x, B_H, cfg, name=name + ".q")
    k = _dense(x, B_H, cfg, name=name + ".k")
    v = _dense(x, B_H, cfg, name=name + ".v")

    def split_heads(t):
        t = fluid.layers.reshape(t, [0, 0, n_head, d_head])
        return fluid.layers.transpose(t, [0, 2, 1, 3])  # [B, n, S, d]

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if cfg.use_flash_attention:
        # attn_bias here is [B,1,1,S]; the fused op takes [B,S]
        flat_bias = fluid.layers.reshape(attn_bias, [0, attn_bias.shape[-1]])
        ctx = fluid.layers.scaled_dot_product_attention(
            q, k, v, bias=flat_bias, sm_scale=1.0 / math.sqrt(d_head)
        )
    else:
        scores = fluid.layers.matmul(
            q, k, transpose_y=True, alpha=1.0 / math.sqrt(d_head)
        )  # [B, n, S, S]
        scores = fluid.layers.elementwise_add(scores, attn_bias)
        probs = fluid.layers.softmax(scores)
        if cfg.attention_probs_dropout_prob:
            probs = fluid.layers.dropout(
                probs,
                cfg.attention_probs_dropout_prob,
                dropout_implementation="upscale_in_train",
            )
        ctx = fluid.layers.matmul(probs, v)  # [B, n, S, d]
    ctx = fluid.layers.transpose(ctx, [0, 2, 1, 3])
    ctx = fluid.layers.reshape(ctx, [0, 0, B_H])
    return _dense(ctx, B_H, cfg, name=name + ".out")


def encoder_layer(x, attn_bias, cfg, name):
    attn = multi_head_attention(x, attn_bias, cfg, name + ".attn")
    if cfg.hidden_dropout_prob:
        attn = fluid.layers.dropout(
            attn, cfg.hidden_dropout_prob, dropout_implementation="upscale_in_train"
        )
    x = fluid.layers.layer_norm(
        fluid.layers.elementwise_add(x, attn), begin_norm_axis=2, name=name + ".ln1"
    )
    ffn = _dense(x, cfg.intermediate_size, cfg, act="gelu", name=name + ".ffn1")
    ffn = _dense(ffn, cfg.hidden_size, cfg, name=name + ".ffn2")
    if cfg.hidden_dropout_prob:
        ffn = fluid.layers.dropout(
            ffn, cfg.hidden_dropout_prob, dropout_implementation="upscale_in_train"
        )
    return fluid.layers.layer_norm(
        fluid.layers.elementwise_add(x, ffn), begin_norm_axis=2, name=name + ".ln2"
    )


def bert_encoder(input_ids, token_type_ids, input_mask, cfg, seq_len):
    """Returns (sequence_output [B,S,H], pooled_output [B,H])."""
    word_emb = fluid.layers.embedding(
        input_ids,
        size=[cfg.vocab_size, cfg.hidden_size],
        param_attr=ParamAttr(name="word_embedding", initializer=_init(cfg)),
    )
    pos_ids = _const_i64(np.arange(seq_len).reshape(1, seq_len), "pos_ids")
    pos_emb = fluid.layers.embedding(
        pos_ids,
        size=[cfg.max_position_embeddings, cfg.hidden_size],
        param_attr=ParamAttr(name="pos_embedding", initializer=_init(cfg)),
    )
    type_emb = fluid.layers.embedding(
        token_type_ids,
        size=[cfg.type_vocab_size, cfg.hidden_size],
        param_attr=ParamAttr(name="type_embedding", initializer=_init(cfg)),
    )
    emb = fluid.layers.elementwise_add(
        fluid.layers.elementwise_add(word_emb, pos_emb), type_emb
    )
    emb = fluid.layers.layer_norm(emb, begin_norm_axis=2, name="emb_ln")
    if cfg.hidden_dropout_prob:
        emb = fluid.layers.dropout(
            emb, cfg.hidden_dropout_prob, dropout_implementation="upscale_in_train"
        )
    # additive attention bias [B, 1, 1, S]: 0 keep, -10000 masked
    mask_f = fluid.layers.cast(input_mask, "float32")
    neg = fluid.layers.scale(mask_f, scale=10000.0, bias=-10000.0)
    attn_bias = fluid.layers.reshape(neg, [0, 1, 1, seq_len])
    x = emb
    for i in range(cfg.num_hidden_layers):
        x = encoder_layer(x, attn_bias, cfg, f"layer_{i}")
    first_tok = fluid.layers.slice(x, axes=[1], starts=[0], ends=[1])
    pooled = _dense(
        fluid.layers.reshape(first_tok, [0, cfg.hidden_size]),
        cfg.hidden_size,
        cfg,
        act="tanh",
        name="pooler",
        num_flatten_dims=1,
    )
    return x, pooled


def _const_i64(arr, name):
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("const_" + name)
    out = helper.block.create_var(
        name=helper.name, shape=list(arr.shape), dtype="int64", stop_gradient=True
    )
    helper.append_op(
        "assign_value",
        {},
        {"Out": [out.name]},
        {"shape": list(arr.shape), "dtype": "int64", "values": arr.reshape(-1).tolist()},
    )
    return out


def build_bert_pretrain(cfg=None, seq_len=128, lr=1e-4, use_amp=False,
                        max_predictions_per_seq=None):
    """BERT pretraining program: MLM + NSP losses.

    Default feeds: input_ids, token_type_ids, input_mask, mlm_labels
    [-1 = unmasked], nsp_labels. With ``max_predictions_per_seq=P`` the MLM
    head projects ONLY the gathered masked positions (feeds
    masked_positions [B, P] + mlm_labels [B, P], -1 padded).
    Returns (main, startup, feeds, fetches)."""
    cfg = cfg or BertConfig.base()
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        feeds, fetches = bert_pretrain_net(cfg, seq_len, max_predictions_per_seq)
        scheduler = fluid.layers.learning_rate_scheduler.linear_lr_warmup(
            lr, warmup_steps=10000, start_lr=0.0, end_lr=lr
        )
        opt = fluid.optimizer.Adam(learning_rate=scheduler)
        if use_amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(fetches[0])
    return main, startup, feeds, fetches


def bert_pretrain_net(cfg, seq_len=128, max_predictions_per_seq=None):
    """The pretraining network of ``build_bert_pretrain`` without its
    optimizer, in the current program: (feeds, [loss, mlm_loss,
    nsp_loss])."""
    if cfg.use_flash_attention and cfg.attention_probs_dropout_prob:
        raise EnforceError(
            "use_flash_attention=True cannot honor "
            f"attention_probs_dropout_prob="
            f"{cfg.attention_probs_dropout_prob}: the fused kernel "
            "applies no attention-prob dropout. Set it to 0 (the "
            "common large-model recipe) or disable the flash path."
        )
    P = max_predictions_per_seq
    input_ids = fluid.data("input_ids", shape=[-1, seq_len], dtype="int64")
    token_type_ids = fluid.data("token_type_ids", shape=[-1, seq_len], dtype="int64")
    input_mask = fluid.data("input_mask", shape=[-1, seq_len], dtype="int64")
    if P:
        masked_positions = fluid.data(
            "masked_positions", shape=[-1, P], dtype="int64"
        )
        mlm_labels = fluid.data("mlm_labels", shape=[-1, P], dtype="int64")
    else:
        mlm_labels = fluid.data(
            "mlm_labels", shape=[-1, seq_len], dtype="int64"
        )
    nsp_labels = fluid.data("nsp_labels", shape=[-1, 1], dtype="int64")

    seq_out, pooled = bert_encoder(input_ids, token_type_ids, input_mask, cfg, seq_len)

    # MLM head: transform + output projection (gathered positions only
    # when P is set)
    mlm_in = (
        fluid.layers.batched_gather(seq_out, masked_positions)
        if P
        else seq_out
    )
    n_pred = P or seq_len
    mlm_t = _dense(mlm_in, cfg.hidden_size, cfg, act="gelu", name="mlm_transform")
    mlm_t = fluid.layers.layer_norm(mlm_t, begin_norm_axis=2, name="mlm_ln")
    mlm_logits = _dense(mlm_t, cfg.vocab_size, cfg, name="mlm_out")
    mlm_loss_tok = fluid.layers.softmax_with_cross_entropy(
        mlm_logits, fluid.layers.reshape(mlm_labels, [0, n_pred, 1]),
        ignore_index=-1, axis=-1,
    )  # [B, n_pred, 1], zeros at ignored
    is_masked = fluid.layers.cast(
        fluid.layers.tensor.not_equal(
            mlm_labels, fluid.layers.tensor.fill_constant([1], "int64", -1)
        ),
        "float32",
    )
    denom = fluid.layers.elementwise_max(
        fluid.layers.reduce_sum(is_masked),
        fluid.layers.tensor.fill_constant([1], "float32", 1.0),
    )
    mlm_loss = fluid.layers.elementwise_div(
        fluid.layers.reduce_sum(mlm_loss_tok), denom
    )

    nsp_logits = _dense(pooled, 2, cfg, name="nsp_out", num_flatten_dims=1)
    nsp_loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(nsp_logits, nsp_labels)
    )
    loss = fluid.layers.elementwise_add(mlm_loss, nsp_loss)
    feeds = [input_ids, token_type_ids, input_mask, mlm_labels, nsp_labels]
    if P:
        feeds.insert(3, masked_positions)
    return feeds, [loss, mlm_loss, nsp_loss]


def encoder_checkpoints(program):
    """The encoder layers' outputs (each ``layer_{i}.ln2`` LayerNorm's
    ``Y``) of a program ``bert_encoder`` built, in layer order: the
    checkpoints of ``RecomputeOptimizer`` at each encoder layer. Found by
    their parameters' names, so the JAX package's programs answer too."""
    outs = {}
    for op in program.global_block().ops:
        if op.type != "layer_norm":
            continue
        scale = op.input("Scale")[0] if op.input("Scale") else ""
        head, _, rest = scale.partition(".ln2")
        if head.startswith("layer_") and rest and head[6:].isdigit():
            outs[int(head[6:])] = op.output("Y")[0]
    return [outs[i] for i in sorted(outs)]


def synthetic_batch(rng, batch, seq_len, cfg, max_predictions_per_seq=None):
    ids = rng.randint(0, cfg.vocab_size, (batch, seq_len)).astype("int64")
    types = np.zeros((batch, seq_len), dtype="int64")
    mask = np.ones((batch, seq_len), dtype="int64")
    nsp = rng.randint(0, 2, (batch, 1)).astype("int64")
    P = max_predictions_per_seq
    if P:
        positions = np.zeros((batch, P), dtype="int64")
        labels = np.full((batch, P), -1, dtype="int64")
        n_mask = min(P, max(1, seq_len // 7))
        for b in range(batch):
            pos = rng.choice(seq_len, n_mask, replace=False)
            positions[b, :n_mask] = pos
            labels[b, :n_mask] = ids[b, pos]
            ids[b, pos] = 103  # [MASK]
        return {
            "input_ids": ids,
            "token_type_ids": types,
            "input_mask": mask,
            "masked_positions": positions,
            "mlm_labels": labels,
            "nsp_labels": nsp,
        }
    mlm = np.full((batch, seq_len), -1, dtype="int64")
    n_mask = max(1, seq_len // 7)
    for b in range(batch):
        pos = rng.choice(seq_len, n_mask, replace=False)
        mlm[b, pos] = ids[b, pos]
        ids[b, pos] = 103  # [MASK]
    return {
        "input_ids": ids,
        "token_type_ids": types,
        "input_mask": mask,
        "mlm_labels": mlm,
        "nsp_labels": nsp,
    }
