"""The port's ``DataFeeder`` and ``check_feed_array``
(``paddle_tpu_torch/data_feeder.py``) against the JAX package's on the
same samples: the same arrays (dtype, shape and bytes), and the same
``ValueError``s naming the variable for a shape, a dtype, ragged samples
and a float feed that an int var would truncate — the messages equal
word for word."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.data_feeder import check_feed_array as jax_check
from paddle_tpu_torch.data_feeder import check_feed_array


def _feeders(*specs):
    """A DataFeeder over ``specs`` ((name, shape, dtype) each) in both
    packages, each on a fresh program."""
    out = []
    for mod in (fluid, pt):
        main = mod.Program()
        with mod.program_guard(main, mod.Program()):
            vars_ = [mod.data(n, shape=s, dtype=d) for n, s, d in specs]
            out.append(mod.DataFeeder(vars_, program=main))
    return out


def _same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("samples", [
    [(np.ones(4), 3), (np.zeros(4), 1)],
    [(np.arange(4, dtype=np.float64).reshape(2, 2), np.int32(7)),
     ([[0.5, 1.5], [2.5, 3.5]], 2)],
    [([1, 2, 3, 4], 0)] * 5,
])
def test_feed_gives_the_jax_arrays(samples):
    jf, tf = _feeders(("img", [-1, 2, 2], "float32"),
                      ("label", [-1, 1], "int64"))
    want, got = jf.feed(samples), tf.feed(samples)
    _same_arrays(got, want)
    assert got["img"].shape == (len(samples), 2, 2)
    assert got["label"].dtype == np.int64


def _same_error(fn_jax, fn_torch, match):
    with pytest.raises(ValueError, match=match) as want:
        fn_jax()
    with pytest.raises(ValueError, match=match) as got:
        fn_torch()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec,samples,match", [
    (("img", [-1, 2, 3], "float32"), [(np.ones(5, np.float32),)],
     "'img'.*shape mismatch"),
    (("vec", [-1, 2], "float32"), [(np.array(["a", "b"]),)], "'vec'"),
    (("seq", [-1, -1], "int64"), [([1, 2, 3],), ([1],)],
     "'seq'.*inconsistent shapes"),
    (("cnt", [-1, 2], "int64"), [(np.array([1.7, 2.9]),)],
     "'cnt'.*truncate"),
])
def test_feed_errors_name_the_variable_as_in_jax(spec, samples, match):
    jf, tf = _feeders(spec)
    _same_error(lambda: jf.feed(samples), lambda: tf.feed(samples), match)


def test_a_sample_with_the_wrong_field_count_raises_in_both():
    jf, tf = _feeders(("a", [-1, 1], "float32"), ("b", [-1, 1], "float32"))
    for f in (jf, tf):
        with pytest.raises(Exception, match="expected 2"):
            f.feed([(1.0,)])


def test_int_to_float_samples_stay_lenient():
    jf, tf = _feeders(("feat", [-1, 2], "float32"))
    _same_arrays(tf.feed([([1, 2],), ([3, 4],)]), jf.feed([([1, 2],), ([3, 4],)]))


@pytest.mark.parametrize("value,dtype,shape", [
    (np.zeros((3, 4), np.float64), "float32", [-1, 4]),
    (np.arange(6, dtype=np.int32).reshape(3, 2), "int64", [-1, 2]),
    (np.arange(6, dtype=np.int32).reshape(3, 2), "float64", [-1, 2]),
    (np.arange(12, dtype=np.float32), "float32", [-1, 2, 2]),   # flat: reshaped
    (np.ones((2, 7), np.float32), "float32", [-1, -1]),
])
def test_check_feed_array_casts_and_reshapes_as_jax(value, dtype, shape):
    want = jax_check("x", value.reshape(-1, 4) if shape == [-1, 2, 2] else value,
                     dtype, shape)
    got = check_feed_array("x", value.reshape(-1, 4) if shape == [-1, 2, 2]
                           else value, dtype, shape)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("value,dtype,shape,match", [
    (np.zeros((2, 5), np.float32), "float32", [-1, 4], "shape mismatch"),
    (np.zeros((2, 4), np.int64), "float32", [-1, 4], "dtype mismatch"),
    (np.zeros((2, 4), np.float32), "int64", [-1, 4], "dtype mismatch"),
    (np.array([["a", "b"]]), "float32", [-1, 2], "dtype mismatch"),
])
def test_check_feed_array_errors_equal_the_jax_ones(value, dtype, shape, match):
    _same_error(lambda: jax_check("x", value, dtype, shape),
                lambda: check_feed_array("x", value, dtype, shape), match)
