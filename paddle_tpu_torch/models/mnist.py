"""MNIST models — the reference's "recognize_digits" book workloads
(reference: python/paddle/fluid/tests/book/test_recognize_digits.py),
copied from the JAX package's ``models/mnist.py`` so both packages build
the same programs: an MLP and a LeNet-style conv net, softmax cross
entropy, accuracy and Adam.

BASELINE workload 1, the MNIST MLP in fluid's imperative mode, is
``dygraph_mnist_recipe``: ``examples/recognize_digits_dygraph.py``'s
``main`` in the port's dygraph, on blob-per-class digits made from the
seed."""

import numpy as np

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


# -- imperative mode (BASELINE workload 1) -----------------------------------


def synthetic_digits(rng, n):
    """Blob-per-class images (``examples/recognize_digits_dygraph.py``):
    learnable without a dataset download."""
    labels = rng.randint(0, 10, n).astype("int64")
    imgs = rng.randn(n, 784).astype("float32") * 0.1
    for i, c in enumerate(labels):
        r, col = divmod(int(c), 4)
        block = np.zeros((28, 28), "float32")
        block[4 + r * 7:10 + r * 7, 2 + col * 6:8 + col * 6] = 1.5
        imgs[i] += block.reshape(-1)
    return imgs, labels.reshape(-1, 1)


def dygraph_mlp(hidden=64):
    """The 784-``hidden``-10 dygraph MLP."""
    from paddle_tpu_torch.dygraph import Linear, Sequential

    return Sequential(Linear(784, hidden, act="relu"), Linear(hidden, 10))


def dygraph_loss(model, x, y):
    """Softmax cross-entropy mean: eager on the tape, or recorded into a
    Program under capture, by the same code."""
    from paddle_tpu_torch import dygraph

    logits = model(x)
    ce = dygraph.trace_op(
        "softmax_with_cross_entropy",
        {"Logits": [logits], "Label": [y]},
        {},
        out_slots=("Softmax", "Loss"),
    )["Loss"][0]
    return dygraph.trace_op("mean", {"X": [ce]}, {})["Out"][0]


def dygraph_mnist_recipe(steps=8, batch=32, lr=0.1, seed=0, place=None,
                         step_hook=None):
    """``examples/recognize_digits_dygraph.py``'s ``main`` in the port:
    the MLP trained with SGD under ``dygraph.guard(place, seed)`` (default
    the card), and at every step the same forward captured with
    ``to_static`` at the current weights. Returns (eager losses, captured
    losses), which the example holds bit-equal. ``model`` (a function
    giving the layer to train, default ``dygraph_mlp``) and
    ``step_hook(step, seconds)`` (called after each step with its host
    seconds, the loss's copy included) serve the card's smoke run."""
    import time

    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.dygraph import to_variable
    from paddle_tpu_torch.dygraph.jit import to_static

    rng = np.random.RandomState(seed)
    imgs, labels = synthetic_digits(rng, steps * batch)
    eager, captured = [], []
    with dygraph.guard(place=place, seed=seed):
        net = dygraph_mlp()
        opt = fluid.optimizer.SGD(learning_rate=lr)
        for step in range(steps):
            xb = imgs[step * batch:(step + 1) * batch]
            yb = labels[step * batch:(step + 1) * batch]
            # to_static freezes the current weights into the captured
            # program, so a fresh capture each step tracks training
            cap = to_static(lambda x, y: dygraph_loss(net, x, y))(xb, yb)
            captured.append(float(cap.numpy().reshape(-1)[0]))
            t0 = time.perf_counter()
            loss = dygraph_loss(net, to_variable(xb), to_variable(yb))
            loss.backward()
            opt.minimize(loss, parameter_list=net.parameters())
            net.clear_gradients()
            eager.append(float(loss.numpy().reshape(-1)[0]))
            if step_hook is not None:
                step_hook(step, time.perf_counter() - t0)
    return eager, captured
