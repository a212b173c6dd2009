"""ResNet for ImageNet (BASELINE workload 2: ResNet-50), copied from the
JAX package's ``models/resnet.py`` so both packages build the same
program: op types, attributes, var and parameter names.

Built from framework layers only (``conv2d``/``batch_norm``/``pool2d``),
trained with momentum 0.9 and ``L2Decay(1e-4)`` (the reference recipe).
The port runs every op eagerly, one at a time (``core/executor.py``):
the convolutions on cuDNN in full float32, the batch-norm statistics as
plain torch ops, and each ``*_grad`` op reruns its forward (ROADMAP M1b).
``use_amp=True`` wraps the optimizer in ``amp.decorate`` as the JAX
package does: the convolutions and the fc product run in bf16 (cuDNN and
cuBLAS, float32 accumulation), batch norm and the loss on float32 casts,
and the parameters stay float32.
"""

import math

import paddle_tpu_torch as fluid
from paddle_tpu_torch.param_attr import ParamAttr

DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1, act=None, name=None):
    conv = fluid.layers.conv2d(
        input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=(filter_size - 1) // 2,
        groups=groups,
        bias_attr=False,
        param_attr=ParamAttr(name=name + "_weights" if name else None),
        name=name,
    )
    return fluid.layers.batch_norm(
        conv,
        act=act,
        param_attr=ParamAttr(name=name + "_bn_scale" if name else None),
        bias_attr=ParamAttr(name=name + "_bn_offset" if name else None),
        moving_mean_name=name + "_bn_mean" if name else None,
        moving_variance_name=name + "_bn_variance" if name else None,
    )


def shortcut(input, ch_out, stride, name):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, name=name)
    return input


def bottleneck_block(input, num_filters, stride, name):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu", name=name + "_branch2a")
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride, act="relu", name=name + "_branch2b")
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, name=name + "_branch2c")
    short = shortcut(input, num_filters * 4, stride, name=name + "_branch1")
    return fluid.layers.elementwise_add(short, conv2, act="relu")


def basic_block(input, num_filters, stride, name):
    conv0 = conv_bn_layer(input, num_filters, 3, stride, act="relu", name=name + "_branch2a")
    conv1 = conv_bn_layer(conv0, num_filters, 3, name=name + "_branch2b")
    short = shortcut(input, num_filters, stride, name=name + "_branch1")
    return fluid.layers.elementwise_add(short, conv1, act="relu")


def resnet(input, class_dim=1000, depth=50):
    block_kind, counts = DEPTH_CFG[depth]
    block_fn = bottleneck_block if block_kind == "bottleneck" else basic_block
    conv = conv_bn_layer(input, 64, 7, 2, act="relu", name="res_conv1")
    pool = fluid.layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1)
    filters = [64, 128, 256, 512]
    for stage, count in enumerate(counts):
        for i in range(count):
            stride = 2 if i == 0 and stage > 0 else 1
            pool = block_fn(
                pool, filters[stage], stride, name=f"res{stage + 2}{chr(97 + i)}"
            )
    pool = fluid.layers.pool2d(pool, global_pooling=True)
    stdv = 1.0 / math.sqrt(pool.shape[1] * 1.0)
    logits = fluid.layers.fc(
        pool,
        size=class_dim,
        param_attr=ParamAttr(
            initializer=fluid.initializer.Uniform(-stdv, stdv), name="fc_0.w"
        ),
    )
    return logits


def build_resnet_train(depth=50, class_dim=1000, image_shape=(3, 224, 224),
                       lr=0.1, use_amp=False):
    """Returns (main, startup, feeds, fetches) for ResNet training with
    momentum + L2 decay (the reference recipe); use_amp runs convs/matmuls
    in bf16 (amp white list)."""
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("img", shape=[-1] + list(image_shape))
        label = fluid.data("label", shape=[-1, 1], dtype="int64")
        logits = resnet(img, class_dim, depth)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label)
        )
        acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
        opt = fluid.optimizer.Momentum(
            learning_rate=lr,
            momentum=0.9,
            regularization=fluid.regularizer.L2Decay(1e-4),
        )
        if use_amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
    return main, startup, [img, label], [loss, acc]


def build_resnet_infer(depth=50, class_dim=1000, image_shape=(3, 224, 224)):
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("img", shape=[-1] + list(image_shape))
        logits = resnet(img, class_dim, depth)
        prob = fluid.layers.softmax(logits)
    return main.clone(for_test=True), startup, [img], [prob]
