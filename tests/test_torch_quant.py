"""The port's int8 engine (tpuseg_torch/infer/quant.py) against the JAX
package's (tpuseg/infer/quant.py) on the CPU, from the same weights
(through the bridge) and the same numpy inputs.

- Folding and weight quantization run the same numpy code on the same
  float32 weights: bit-equal.
- Calibration ranges: relative 1e-4 (f32 conv sums in another order).
- Labels: at least 0.999 of pixels. The int8 convs are exact in both, but
  an activation that lands within an f32 rounding of a requantization
  boundary can take the neighbouring code, and the fp blocks sum in
  another order; each test reports whether its labels were bit-equal."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.infer import quant as jq
from tpuseg_torch.infer import head_kernel, int8_conv
from tpuseg_torch.infer import quant as tq
from tpuseg_torch.utils.jax_bridge import unet_from_flax

from test_torch_unet import jax_model_and_vars
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


def _pair(impl="conv_transpose"):
    _, variables = jax_model_and_vars(impl)
    port = unet_from_flax(variables, 2, 1, 4, torch.float32, impl)
    return variables, port


def _x(seed, shape=(2, 48, 32, 1)):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("impl", ["conv_transpose", "pixel_shuffle"])
def test_fold_and_quantize_bit_equal(impl):
    variables, port = _pair(impl)
    want = jq.fold_variables(variables)
    got = tq.fold_variables(port)
    assert set(got) == set(want)
    rng = np.random.default_rng(0)
    for name in want:
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k], np.asarray(want[name][k]),
                                          err_msg=f"{name}.{k}")
        sv = rng.uniform(0.01, 0.2, want[name]["w"].shape[-2]).astype(np.float32)
        for a, b in zip(tq.quantize_weight(got[name]["w"], sv),
                        jq.quantize_weight(np.asarray(want[name]["w"]), sv)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["conv_transpose", "pixel_shuffle"])
def test_folded_walk_matches_model(impl):
    """BN fold + walk == the port's model in f32 (both deconv forms)."""
    _, port = _pair(impl)
    x = torch.from_numpy(_x(1))
    with torch.no_grad():
        want = port(x)
    got = tq.make_folded_logits_fn(tq.fold_variables(port), deconv_impl=impl)(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("percentile", [99.9, 100.0])
def test_calibrate_ranges_match(percentile):
    variables, port = _pair()
    imgs = [np.random.default_rng(2).normal(0, 1, (48, 32)),
            np.random.default_rng(3).normal(0, 1, (64, 40))]
    want = jq.calibrate(jq.fold_variables(variables), imgs, percentile=percentile)
    got = tq.calibrate(tq.fold_variables(port), imgs, percentile=percentile, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k


def test_percentile_matches_jnp():
    a = np.random.default_rng(4).standard_normal(10_001).astype(np.float32)
    for q in (50.0, 99.9, 100.0, 0.1):
        want = float(jnp.percentile(jnp.asarray(a), q))
        assert float(tq._percentile(torch.from_numpy(a), q)) == pytest.approx(want, rel=1e-6)


def test_load_act_ranges_reads_tpuseg_file(tmp_path):
    """A scales file written by tpuseg loads in the port unchanged, and the
    port's own file is byte-compatible the other way round."""
    variables, _ = _pair()
    ranges = jq.calibrate(jq.fold_variables(variables), [_x(5, (48, 48))])
    p = str(tmp_path / "cal.json")
    jq.save_act_ranges(p, ranges, percentile=99.9)
    assert tq.load_act_ranges(p, expect_percentile=99.9) == ranges
    q = str(tmp_path / "port.json")
    tq.save_act_ranges(q, ranges, percentile=99.9)
    assert jq.load_act_ranges(q) == ranges
    with open(p) as f, open(q) as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("fp_blocks", [(), tq.DEFAULT_FP_BLOCKS])
def test_quantized_labels_match_jax(blocked, fp_blocks):
    variables, port = _pair()
    x = _x(6)
    ranges = jq.calibrate(jq.fold_variables(variables), [x[0, ..., 0]])
    want = np.asarray(jq.make_quantized_predict_fn(
        jq.fold_variables(variables), ranges, fp_blocks=fp_blocks,
        dtype=jnp.float32, blocked_edges=blocked)(jnp.asarray(x)))
    got = tq.make_quantized_predict_fn(
        tq.fold_variables(port), ranges, fp_blocks=fp_blocks,
        dtype=torch.float32, blocked_edges=blocked)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 48, 32) and got.dtype == np.int32
    agree = (got == want).mean()
    print(f"blocked={blocked} fp_blocks={fp_blocks}: agreement {agree:.6f}, "
          f"bit-equal {bool(agree == 1.0)}")
    assert agree >= 0.999


@pytest.mark.parametrize("fp_blocks", [(), tq.DEFAULT_FP_BLOCKS])
def test_dense_head_kernel_labels_match_jax(fp_blocks, monkeypatch):
    """At base 16 the dense head's 16 input channels take K6 (base 4's 4 do
    not): the dense predict on the CPU runs K6's plain version once a call,
    launches no kernel, and labels like the JAX package (>= 0.999, as
    test_quantized_labels_match_jax)."""
    _, variables = jax_model_and_vars(feats=16)
    port = unet_from_flax(variables, 2, 1, 16, torch.float32)
    x = _x(11)
    ranges = jq.calibrate(jq.fold_variables(variables), [x[0, ..., 0]])
    want = np.asarray(jq.make_quantized_predict_fn(
        jq.fold_variables(variables), ranges, fp_blocks=fp_blocks,
        dtype=jnp.float32)(jnp.asarray(x)))
    calls = []
    plain = head_kernel._dense_head_argmax_plain
    monkeypatch.setattr(head_kernel, "_dense_head_argmax_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    before = head_kernel.DENSE_LAUNCHES, head_kernel.LAUNCHES, int8_conv.LAUNCHES
    got = tq.make_quantized_predict_fn(
        tq.fold_variables(port), ranges, fp_blocks=fp_blocks,
        dtype=torch.float32)(torch.from_numpy(x)).numpy()
    assert calls == [(2, 48, 32, 16)]
    assert (head_kernel.DENSE_LAUNCHES, head_kernel.LAUNCHES, int8_conv.LAUNCHES) == before
    assert got.shape == want.shape == (2, 48, 32) and got.dtype == np.int32
    agree = (got == want).mean()
    print(f"fp_blocks={fp_blocks}: agreement {agree:.6f}, bit-equal {bool(agree == 1.0)}")
    assert agree >= 0.999


@pytest.mark.parametrize("impl", ["conv_transpose", "pixel_shuffle"])
def test_blocked_fully_quantized_equals_dense(impl):
    """As in the JAX package: with every block quantized the blocked walk is
    the dense int8 network, label for label."""
    _, port = _pair(impl)
    x = torch.from_numpy(_x(7))
    folded = tq.fold_variables(port)
    ranges = tq.calibrate(folded, [x[0, ..., 0].numpy()], deconv_impl=impl, device="cpu")
    kw = dict(fp_blocks=(), deconv_impl=impl, dtype=torch.float32)
    dense = tq.make_quantized_predict_fn(folded, ranges, **kw)(x)
    blocked = tq.make_quantized_predict_fn(folded, ranges, blocked_edges=True, **kw)(x)
    assert torch.equal(blocked, dense)


def test_many_classes_take_the_conv_head():
    """ncls > 8 keeps the JAX package's rule: conv head + per-phase argmax;
    labels still equal the dense engine's with every block quantized."""
    _, variables = jax_model_and_vars(ncls=9)
    port = unet_from_flax(variables, 9, 1, 4, torch.float32)
    x = torch.from_numpy(_x(8, (1, 32, 32, 1)))
    folded = tq.fold_variables(port)
    ranges = tq.calibrate(folded, [x[0, ..., 0].numpy()], device="cpu")
    kw = dict(fp_blocks=(), dtype=torch.float32)
    dense = tq.make_quantized_predict_fn(folded, ranges, **kw)(x)
    blocked = tq.make_quantized_predict_fn(folded, ranges, blocked_edges=True, **kw)(x)
    assert blocked.shape == (1, 32, 32)
    assert torch.equal(blocked, dense)


def test_int8_conv_matches_exact_conv():
    """The im2col + _int_mm conv, chunked over rows and with K/N padding,
    equals an exact float64 conv of the int8 codes."""
    rng = np.random.default_rng(9)
    x = rng.integers(-127, 128, (2, 9, 7, 3)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, 3, 5)).astype(np.int8)
    op = int8_conv.Int8ConvWeights(wq)
    old = int8_conv._IM2COL_BYTES
    # two output rows a chunk
    int8_conv._IM2COL_BYTES = 2 * 7 * op.plain(torch.device("cpu")).shape[1] * 2
    try:
        got = int8_conv._int8_conv_plain(torch.from_numpy(x), op, None)
    finally:
        int8_conv._IM2COL_BYTES = old
    want = torch.nn.functional.conv2d(
        torch.from_numpy(x).double().permute(0, 3, 1, 2),
        torch.from_numpy(wq).double().permute(3, 2, 0, 1), padding=1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.permute(0, 2, 3, 1).numpy())


def test_fp_blocks_typo_fails_fast():
    _, port = _pair()
    folded = tq.fold_variables(port)
    ranges = {k: 1.0 for k in tq.CONV_BLOCKS + tq.DECONV_BLOCKS + (tq.INPUT_TAP,)}
    with pytest.raises(ValueError, match="enc1A"):
        tq.make_quantized_predict_fn(folded, ranges, fp_blocks=("enc1A", "head"))
