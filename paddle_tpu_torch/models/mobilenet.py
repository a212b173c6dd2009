"""MobileNet V1/V2 for ImageNet (reference model zoo: PaddleCV
image_classification mobilenet.py / mobilenet_v2.py), copied from the
JAX package's ``models/mobilenet.py`` so both packages build the same
program: op types, attributes, var and parameter names.

The depthwise convolutions are grouped ``conv2d`` ops (``groups`` =
channels), which run on cuDNN in full float32 (``ops/nn.py``
``FLOAT32_CONVS``); ``adaptive_pool2d`` to 1x1 is the global average
pool, ``flatten2`` feeds the classifier. The program runs eagerly, one op
at a time (``core/executor.py``), and each ``*_grad`` op reruns its
forward. ``use_amp=True`` wraps the optimizer in ``amp.decorate`` as the
JAX package does.
"""

import paddle_tpu_torch as fluid
from paddle_tpu_torch.param_attr import ParamAttr


def _conv_bn(x, filters, ksize, stride=1, groups=1, act="relu", name=None):
    conv = fluid.layers.conv2d(
        x, num_filters=filters, filter_size=ksize, stride=stride,
        padding=(ksize - 1) // 2, groups=groups, bias_attr=False,
        param_attr=ParamAttr(name=name + "_w" if name else None),
    )
    return fluid.layers.batch_norm(conv, act=act)


def _depthwise_separable(x, out_c, stride, scale=1.0, name=None):
    """MobileNetV1 block: depthwise 3x3 + pointwise 1x1."""
    in_c = x.shape[1]
    dw = _conv_bn(x, in_c, 3, stride=stride, groups=in_c,
                  name=f"{name}_dw" if name else None)
    return _conv_bn(dw, int(out_c * scale), 1,
                    name=f"{name}_pw" if name else None)


def _inverted_residual(x, out_c, stride, expansion, name=None):
    """MobileNetV2 block: 1x1 expand, depthwise 3x3, 1x1 project (linear),
    residual when shapes allow."""
    in_c = x.shape[1]
    mid = in_c * expansion
    h = _conv_bn(x, mid, 1, name=f"{name}_exp" if name else None)
    h = _conv_bn(h, mid, 3, stride=stride, groups=mid,
                 name=f"{name}_dw" if name else None)
    h = _conv_bn(h, out_c, 1, act=None,
                 name=f"{name}_proj" if name else None)
    if stride == 1 and in_c == out_c:
        h = fluid.layers.elementwise_add(x, h)
    return h


def mobilenet_v1(img, class_dim=1000, scale=1.0):
    cfg = [
        # (out_c, stride)
        (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
        (1024, 1),
    ]
    h = _conv_bn(img, int(32 * scale), 3, stride=2, name="conv1")
    for i, (c, s) in enumerate(cfg):
        h = _depthwise_separable(h, c, s, scale, name=f"dws{i}")
    h = fluid.layers.adaptive_pool2d(h, 1, pool_type="avg")
    h = fluid.layers.flatten(h)
    return fluid.layers.fc(h, size=class_dim, act="softmax")


def mobilenet_v2(img, class_dim=1000):
    cfg = [
        # (expansion, out_c, repeats, stride)
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    ]
    h = _conv_bn(img, 32, 3, stride=2, name="conv1")
    i = 0
    for t, c, n, s in cfg:
        for r in range(n):
            h = _inverted_residual(h, c, s if r == 0 else 1, t,
                                   name=f"ir{i}")
            i += 1
    h = _conv_bn(h, 1280, 1, name="conv_last")
    h = fluid.layers.adaptive_pool2d(h, 1, pool_type="avg")
    h = fluid.layers.flatten(h)
    return fluid.layers.fc(h, size=class_dim, act="softmax")


def build_mobilenet_train(version=1, class_dim=1000, lr=0.1, use_amp=False,
                          image_shape=(3, 224, 224)):
    """Returns (main, startup, feeds, fetches) — the contract of
    ``resnet.build_resnet_train``; fetches are the mean cross entropy of
    the softmax and the top-1 accuracy."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("img", [-1] + list(image_shape))
        label = fluid.data("label", [-1, 1], dtype="int64")
        net = mobilenet_v1 if version == 1 else mobilenet_v2
        prob = net(img, class_dim=class_dim)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(prob, label)
        )
        acc = fluid.layers.accuracy(prob, label)
        opt = fluid.optimizer.MomentumOptimizer(lr, 0.9)
        if use_amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
    return main, startup, [img, label], [loss, acc]
