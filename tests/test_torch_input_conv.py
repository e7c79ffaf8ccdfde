"""K5, the fp input conv with its epilogue fused (tpuseg_torch/infer/input_conv.py).

On the CPU the wrapper runs its plain version: 9*C broadcast products and
sums in (ky, kx, c) order, then the block's ReLU, folded BN and requantize.
It is held here against the JAX package's ``_conv_fp`` followed by the
walk's epilogue (``jnp.maximum(y + b, 0) * s + t``, then ``emit``'s
requantize), on the same numpy inputs:

- the f32 values before the requantize within 1e-6 of the largest |value|
  (the conv sums in another order than XLA's: bit-equal at bf16 operands,
  whose products are exact, about 1e-7 apart at f32);
- the int8 codes equal on >= 0.999 of elements and never more than one
  code apart (a value within an f32 rounding of a code boundary can take
  the neighbour). Each case reports whether it was bit-equal;
- at C 100 (900 products a sum) each sum within the error bound of
  recursive summation in any order, on both sides.

The blocked layout is ``quant._s2d`` of the dense output, bit for bit; the
epilogue is numpy's float32 operations in the same order, bit for bit, half-
way ties included. The whole quantized walk at base 4 calls the wrapper once
a predict call in both walks (never with ``enc1a`` quantized), launches no
kernel on the CPU, and labels like the JAX package on >= 0.999
(tests/test_torch_quant.py's tolerance). The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py and by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.infer import quant as jq
from tpuseg_torch.infer import input_conv as k5
from tpuseg_torch.infer import quant as tq

from test_torch_quant import _pair, _x
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}


def _case(c, f, seed, shape=(2, 40, 24)):
    """A z-scored batch, a folded-looking kernel and epilogue vectors, and an
    output scale that puts the codes across the int8 range."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape + (c,)).astype(np.float32)
    w = (rng.normal(0, 1, (3, 3, c, f)) / np.sqrt(9 * c)).astype(np.float32)
    b = rng.normal(0, 0.3, f).astype(np.float32)
    s = rng.uniform(0.5, 1.5, f).astype(np.float32)
    t = rng.normal(0, 0.3, f).astype(np.float32)
    return x, w, b, s, t, np.float32(2.5 / 127.0)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c", [1, 3])
def test_plain_matches_tpuseg_conv_fp_and_epilogue(c, dtype):
    tdt, jdt = DTYPES[dtype]
    x, w, b, s, t, so = _case(c, 16, 10 + c)
    yj = jnp.maximum(jq._conv_fp(jnp.asarray(x), jnp.asarray(w), jdt) + b, 0.0) * s + t
    want_q = np.asarray(jnp.clip(jnp.round(yj / so), -127, 127).astype(jnp.int8))
    yj = np.asarray(yj)
    xt, wt, bt, st, tt, sot = _t(x, w, b, s, t, so)
    y = k5.affine(k5.conv_sums(xt, wt, tdt), bt, st, tt).numpy()
    got_q = k5.input_conv(xt, wt, bt, st, tt, sot, tdt).numpy()
    rel = np.abs(y - yj).max() / np.abs(yj).max()
    agree = (got_q == want_q).mean()
    print(f"C={c} {dtype}: values {rel:.2e} of the largest apart, bit-equal "
          f"{bool(np.array_equal(y, yj))}; codes agree on {agree:.6f}, bit-equal "
          f"{bool(np.array_equal(got_q, want_q))}")
    assert got_q.shape == x.shape[:3] + (16,) and got_q.dtype == np.int8
    assert rel <= 1e-6
    assert agree >= 0.999
    assert np.abs(got_q.astype(np.int32) - want_q).max() <= 1
    assert len(np.unique(want_q)) >= 64 and np.mean(np.abs(want_q) == 127) < 0.1


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_tpuseg_at_100_channels(dtype):
    """C 100, where the kernel takes chunks of 16 output channels with one
    halo buffer: 900 products a sum, so the two summation orders may differ
    by more than at C 1 or 3. Each sum is held within the error bound of
    recursive summation in any order, ``(9C - 1) * 2^-24`` times the sum of
    the |products|, twice (both sides); the codes as in the test above."""
    tdt, jdt = DTYPES[dtype]
    x, w, b, s, t, so = _case(100, 16, 7)
    sj = np.asarray(jq._conv_fp(jnp.asarray(x), jnp.asarray(w), jdt))
    yj = np.maximum(sj + b, np.float32(0.0)) * s + t
    want_q = np.clip(np.rint(yj / so), -127, 127).astype(np.int8)
    xt, wt, bt, st, tt, sot = _t(x, w, b, s, t, so)
    got = k5.conv_sums(xt, wt, tdt).numpy()
    absx = xt.to(tdt).double().abs().permute(0, 3, 1, 2)
    absw = wt.to(tdt).double().abs().permute(3, 2, 0, 1)
    mass = torch.nn.functional.conv2d(absx, absw, padding=1).permute(0, 2, 3, 1).numpy()
    bound = 2 * (9 * 100 - 1) * 2.0 ** -24 * mass
    got_q = k5.input_conv(xt, wt, bt, st, tt, sot, tdt).numpy()
    over = np.abs(got.astype(np.float64) - sj) / bound
    print(f"C=100 {dtype}: sums at most {over.max():.3f} of the bound apart; codes agree on "
          f"{(got_q == want_q).mean():.6f}")
    assert (over <= 1).all()
    assert (got_q == want_q).mean() >= 0.999
    assert np.abs(got_q.astype(np.int32) - want_q).max() <= 1
    assert len(np.unique(want_q)) >= 64 and np.mean(np.abs(want_q) == 127) < 0.1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c,f", [(1, 4), (1, 64), (3, 20), (100, 16)])
def test_blocked_layout_is_s2d_of_dense(c, f, dtype):
    tdt = DTYPES[dtype][0]
    args = _t(*_case(c, f, 20 + f, (3, 10, 14)))
    dense = k5.input_conv(*args, tdt)
    blocked = k5.input_conv(*args, tdt, blocked=True)
    assert tuple(blocked.shape) == (3, 5, 7, 4 * f)
    assert torch.equal(blocked, tq._s2d(dense))


def test_epilogue_bit_equal_to_numpy_float32():
    """ReLU, folded BN and the requantize against numpy float32 in the same
    order, on sums that include every half-way tie of the requantize (a
    power-of-two ``so`` and ``s`` 1, ``t`` 0 put ``v / so`` on k + 0.5
    exactly): round half to even, as ``torch.round`` and ``np.rint``."""
    rng = np.random.default_rng(3)
    f = 8
    so = np.float32(2.0 ** -5)
    ties = ((np.arange(-20, 126) + 0.5) * so).astype(np.float32)
    y = rng.normal(0, 2, (500, f)).astype(np.float32)
    y[:len(ties), 0] = ties
    b = np.concatenate([[0.0], rng.normal(0, 0.3, f - 1)]).astype(np.float32)
    s = np.concatenate([[1.0], rng.uniform(0.5, 1.5, f - 1)]).astype(np.float32)
    t = np.concatenate([[0.0], rng.normal(0, 0.3, f - 1)]).astype(np.float32)
    v = np.maximum(y + b, np.float32(0.0)) * s + t
    want = np.clip(np.rint(v / so), -127, 127).astype(np.int8)
    yt, bt, st, tt, sot = _t(y, b, s, t, so)
    got = k5.requant(k5.affine(yt, bt, st, tt), sot).numpy()
    np.testing.assert_array_equal(got, want)
    # the eager form the walk ran before K5, on the same sums
    eager = torch.clamp(torch.round((torch.clamp_min(yt + bt, 0.0) * st + tt) / sot),
                        -127, 127).to(torch.int8)
    assert torch.equal(torch.from_numpy(got), eager)
    assert (want[:len(ties), 0] % 2 == 0).all()  # every tie went to the even code
    assert np.isin(np.arange(0, 127, 2), want[:len(ties), 0]).all()


@pytest.mark.parametrize("blocked", [False, True])
def test_walk_runs_k5_once_a_predict_call(blocked, monkeypatch):
    """The base-4 int8 walk hands enc1a to the wrapper once a predict call
    (dense batch, dense kernel; phase-major out when blocked), launches no
    kernel on the CPU, and labels like the JAX package on >= 0.999; with
    enc1a quantized it never calls it."""
    variables, port = _pair()
    x = _x(6)
    ranges = jq.calibrate(jq.fold_variables(variables), [x[0, ..., 0]])
    want = np.asarray(jq.make_quantized_predict_fn(
        jq.fold_variables(variables), ranges, dtype=jnp.bfloat16,
        blocked_edges=blocked)(jnp.asarray(x)))
    calls = []
    plain = k5._input_conv_plain

    def counted(x, w, b, s, t, so, dtype, blocked):
        calls.append((tuple(x.shape), tuple(w.shape), dtype, blocked))
        return plain(x, w, b, s, t, so, dtype, blocked)

    monkeypatch.setattr(k5, "_input_conv_plain", counted)
    launches = k5.LAUNCHES
    folded = tq.fold_variables(port)
    fn = tq.make_quantized_predict_fn(folded, ranges, dtype=torch.bfloat16,
                                      blocked_edges=blocked)
    got = fn(torch.from_numpy(x)).numpy()
    assert calls == [((2, 48, 32, 1), (3, 3, 1, 4), torch.bfloat16, blocked)]
    assert k5.LAUNCHES == launches
    agree = (got == want).mean()
    print(f"blocked={blocked}: agreement {agree:.6f}, bit-equal {bool(agree == 1.0)}")
    assert got.shape == want.shape and agree >= 0.999
    fn(torch.from_numpy(x))
    assert len(calls) == 2
    tq.make_quantized_predict_fn(folded, ranges, fp_blocks=("head",), dtype=torch.bfloat16,
                                 blocked_edges=blocked)(torch.from_numpy(x))
    assert len(calls) == 2


def test_trace_groups_name_k5_first():
    from tpuseg_torch.utils import trace_analysis

    name = ("void (anonymous namespace)::input_conv_kernel<true, true, true>"
            "((anonymous namespace)::Params)")
    assert trace_analysis.kernel_group(name) == "K5 input_conv"
    order = [g for g, _ in trace_analysis.KERNEL_GROUPS]
    assert order.index("K5 input_conv") < order.index("cuDNN / GEMM") < order.index("elementwise")


def test_bad_inputs_refused():
    x, w, b, s, t, so = _t(*_case(1, 4, 0, (1, 6, 5)))
    with pytest.raises(ValueError, match="HWIO"):
        k5.input_conv(x, w[:1], b, s, t, so, torch.float32)
    with pytest.raises(ValueError, match="want \\(4,\\)"):
        k5.input_conv(x, w, b[:3], s, t, so, torch.float32)
    with pytest.raises(ValueError, match="scalar"):
        k5.input_conv(x, w, b, s, t, b, torch.float32)
    with pytest.raises(ValueError, match="even H and W"):
        k5.input_conv(x, w, b, s, t, so, torch.float32, blocked=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k5.input_conv(x.to("meta"), w, b, s, t, so, torch.float32)
