"""MNIST models — the reference's "recognize_digits" book workloads
(reference: python/paddle/fluid/tests/book/test_recognize_digits.py),
copied from the JAX package's ``models/mnist.py`` so both packages build
the same programs: an MLP and a LeNet-style conv net, softmax cross
entropy, accuracy and Adam."""

import paddle_tpu_torch as fluid


def mlp(img, label, hidden=(200, 200)):
    h = img
    for size in hidden:
        h = fluid.layers.fc(h, size=size, act="relu")
    logits = fluid.layers.fc(h, size=10)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label)
    )
    acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
    return loss, acc, logits


def conv_net(img, label):
    """LeNet-style conv net; img is [N, 1, 28, 28]."""
    c1 = fluid.layers.conv2d(img, num_filters=20, filter_size=5, act="relu")
    p1 = fluid.layers.pool2d(c1, pool_size=2, pool_stride=2)
    c2 = fluid.layers.conv2d(p1, num_filters=50, filter_size=5, act="relu")
    p2 = fluid.layers.pool2d(c2, pool_size=2, pool_stride=2)
    logits = fluid.layers.fc(p2, size=10)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label)
    )
    acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
    return loss, acc, logits


def build_mnist_train(use_conv=False):
    """Returns (main_program, startup_program, feeds, fetches)."""
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        if use_conv:
            img = fluid.data("img", shape=[-1, 1, 28, 28])
        else:
            img = fluid.data("img", shape=[-1, 784])
        label = fluid.data("label", shape=[-1, 1], dtype="int64")
        build = conv_net if use_conv else mlp
        loss, acc, logits = build(img, label)
        opt = fluid.optimizer.Adam(learning_rate=1e-3)
        opt.minimize(loss)
    return main, startup, [img, label], [loss, acc]
