"""K3, the int8 conv with its epilogue fused (tpuseg_torch/infer/int8_conv.py).

On the CPU the wrapper runs its plain version (im2col + ``torch._int_mm``
+ the epilogue in PyTorch). It is held here against an exact conv of the
int8 codes (float64 ``F.conv2d``: the sums stay below 2^53) followed by the
epilogue in numpy float32 in the same order of operations, and against the
JAX package's ``_conv_s8``: int32 sums and epilogue outputs bit-equal. The
kernel's weight layout and K-step addressing are held by a numpy model of
its loop. The CUDA kernel itself is held against the plain version on the
card by tests/test_torch_cuda.py and by chip_smoke.py.

The whole quantized walk at base 4 goes through the wrapper 21 times a
predict call with the default fp_blocks, and its labels agree with the JAX
package's on >= 0.999 of pixels (tests/test_torch_quant.py's tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.infer import quant as jq
from tpuseg_torch.infer import int8_conv as k3
from tpuseg_torch.infer import quant as tq

from test_torch_quant import _pair, _x

MODES = ["relu_requant", "relu_f32", "affine_requant"]


def _codes(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _epilogue_arrays(rng, cout, k):
    """Per-channel vectors that put the requantized codes across the int8
    range: f(acc) * ws is about N(0, 1) for uniform codes."""
    ws = (rng.uniform(0.5, 1.5, cout) / (np.sqrt(k) * 5461.0)).astype(np.float32)
    return {"ws": ws, "b": rng.normal(0, 0.3, cout).astype(np.float32),
            "s": rng.uniform(0.5, 1.5, cout).astype(np.float32),
            "t": rng.normal(0, 0.3, cout).astype(np.float32),
            "so": np.float32(2.0 / 127.0)}


def _epilogue(mode, arrs, dev="cpu"):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return k3.Epilogue(mode, t(arrs["ws"]), None if mode == "affine_requant" else t(arrs["b"]),
                       t(arrs["s"]), t(arrs["t"]),
                       None if mode == "relu_f32" else t(np.asarray(arrs["so"])))


def _exact_conv(x, wq):
    """int64 SAME conv of int8 codes through float64 (exact)."""
    kh = wq.shape[0]
    y = torch.nn.functional.conv2d(
        torch.from_numpy(x).double().permute(0, 3, 1, 2),
        torch.from_numpy(wq).double().permute(3, 2, 0, 1), padding=kh // 2)
    return y.permute(0, 2, 3, 1).numpy().astype(np.int64)


def _numpy_epilogue(acc, mode, arrs):
    f = acc.astype(np.float32)
    ws, b, s, t, so = (arrs[k] for k in ("ws", "b", "s", "t", "so"))
    if mode == "affine_requant":
        y = (f * ws) * s + t
    else:
        y = np.maximum(f * ws + b, np.float32(0.0)) * s + t
        if mode == "relu_f32":
            return y
    return np.clip(np.rint(y / so), -127, 127).astype(np.int8)


def _case(cin, cout, k, seed):
    rng = np.random.default_rng(seed)
    b = 1 + seed % 3
    h, w = (5, 7) if seed % 2 else (7, 3)
    x = _codes(rng, (b, h, w, cin))
    wq = _codes(rng, (k, k, cin, cout))
    return rng, x, wq


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("cout", [2, 5, 64])
@pytest.mark.parametrize("cin", [1, 3, 4, 64])
def test_cpu_route_bit_equal_to_exact_conv_and_epilogue(cin, cout, k, mode):
    seed = cin * 7 + cout * 3 + k
    rng, x, wq = _case(cin, cout, k, seed)
    arrs = _epilogue_arrays(rng, cout, k * k * cin)
    got = k3.int8_conv(torch.from_numpy(x), k3.Int8ConvWeights(wq), _epilogue(mode, arrs))
    want = _numpy_epilogue(_exact_conv(x, wq), mode, arrs)
    assert got.dtype == (torch.float32 if mode == "relu_f32" else torch.int8)
    assert tuple(got.shape) == x.shape[:3] + (cout,)
    np.testing.assert_array_equal(got.numpy(), want)
    if mode != "relu_f32" and cin >= 3:  # the codes are not degenerate
        assert len(np.unique(want)) >= 8 and np.mean(np.abs(want) == 127) < 0.5


@pytest.mark.parametrize("mode", MODES)
def test_chunked_cpu_route_bit_equal(mode, monkeypatch):
    """Two output rows an im2col chunk: the stitched chunks are the whole."""
    rng, x, wq = _case(16, 5, 3, 4)
    op = k3.Int8ConvWeights(wq)
    b, _, w, _ = x.shape
    monkeypatch.setattr(k3, "_IM2COL_BYTES", 2 * b * w * op.plain(torch.device("cpu")).shape[1])
    arrs = _epilogue_arrays(rng, 5, 9 * 16)
    calls = []
    epi = _epilogue(mode, arrs)
    call = k3.Epilogue.__call__
    monkeypatch.setattr(k3.Epilogue, "__call__",
                        lambda self, y: calls.append(y.shape[1]) or call(self, y))
    got = k3.int8_conv(torch.from_numpy(x), op, epi)
    assert calls == [2] * (x.shape[1] // 2) + [1] * (x.shape[1] % 2)
    np.testing.assert_array_equal(got.numpy(), _numpy_epilogue(_exact_conv(x, wq), mode, arrs))


@pytest.mark.parametrize("shape", [(2, 9, 7, 3, 3, 5), (1, 6, 10, 64, 3, 32),
                                   (3, 5, 5, 48, 1, 24), (1, 4, 6, 4, 3, 16)])
def test_int32_sums_equal_tpuseg_conv_s8(shape):
    b, h, w, cin, k, cout = shape
    rng = np.random.default_rng(sum(shape))
    x, wq = _codes(rng, (b, h, w, cin)), _codes(rng, (k, k, cin, cout))
    got = k3._int8_conv_plain(torch.from_numpy(x), k3.Int8ConvWeights(wq), None)
    want = np.asarray(jq._conv_s8(jnp.asarray(x), jnp.asarray(wq)))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _kernel_model(x, wm, kh, kw, cin, kstep=64):
    """The CUDA kernel's K loop in numpy: K-steps of ``kstep`` bytes; each
    A row is a pixel's run of channels of one tap (cin % 16 == 0) or a run
    of the packed taps, zero where a tap leaves the image or past K."""
    b, h, w, _ = x.shape
    m = b * h * w
    pix = x.reshape(m, cin).astype(np.int64)
    img, rem = np.divmod(np.arange(m), h * w)
    py, px = np.divmod(rem, w)
    acc = np.zeros((m, wm.shape[0]), np.int64)
    aligned = cin % 16 == 0
    steps_per_tap = -(-cin // kstep)
    for step in range(wm.shape[1] // kstep):
        a = np.zeros((m, kstep), np.int64)
        for j in range(kstep):
            if aligned:
                tap, c = divmod(step, steps_per_tap)
                c = c * kstep + j
                valid_k = c < cin
            else:
                kg = step * kstep + j
                tap, c = divmod(kg, cin)
                valid_k = kg < kh * kw * cin
            if not valid_k:
                continue
            dy, dx = tap // kw - kh // 2, tap % kw - kw // 2
            iy, ix = py + dy, px + dx
            ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            src = (img * h + np.clip(iy, 0, h - 1)) * w + np.clip(ix, 0, w - 1)
            a[:, j] = np.where(ok, pix[src, c], 0)
        acc += a @ wm[:, step * kstep:(step + 1) * kstep].astype(np.int64).T
    return acc.reshape(b, h, w, -1)


@pytest.mark.parametrize("cin, k", [(1, 3), (4, 3), (16, 3), (48, 1), (64, 3), (80, 3),
                                    (3, 1)])
def test_kernel_layout_and_k_steps(cin, k):
    """The weight layout the kernel reads, walked as the kernel walks it,
    gives the exact conv: per-tap padding to the K-step for cin % 16 == 0,
    packed taps otherwise."""
    rng = np.random.default_rng(cin + k)
    x, wq = _codes(rng, (2, 5, 6, cin)), _codes(rng, (k, k, cin, 7))
    wm = k3._kernel_layout(wq)
    taps = k * k
    kp = taps * -(-cin // 64) * 64 if cin % 16 == 0 else -(-taps * cin // 64) * 64
    assert wm.shape == (7, kp) and wm.dtype == np.int8
    np.testing.assert_array_equal(_kernel_model(x, wm, k, k, cin), _exact_conv(x, wq))


def test_epilogue_spec_rejects_mismatched_vectors():
    v = torch.ones(3)
    so = torch.tensor(0.1)
    with pytest.raises(ValueError, match="mode"):
        k3.Epilogue("relu", v, v, v, v, so)
    with pytest.raises(ValueError, match="b must be None"):
        k3.Epilogue("affine_requant", v, v, v, v, so)
    with pytest.raises(ValueError, match="so must be given"):
        k3.Epilogue("relu_requant", v, v, v, v, None)
    with pytest.raises(ValueError, match="so must be None"):
        k3.Epilogue("relu_f32", v, v, v, v, so)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k3.int8_conv(torch.zeros((1, 2, 2, 3), dtype=torch.int8, device="meta"),
                     k3.Int8ConvWeights(np.zeros((1, 1, 3, 3), np.int8)),
                     k3.Epilogue("relu_f32", v, v, v, v, None))


@pytest.mark.parametrize("blocked", [False, True])
def test_quantized_walk_through_the_wrapper_matches_jax(blocked, monkeypatch):
    """The base-4 int8 walk calls the wrapper once per int8 block (21 with
    the default fp_blocks, the head through K2 or fp), launches no kernel
    on the CPU, and labels like the JAX package on >= 0.999."""
    variables, port = _pair()
    x = _x(6)
    ranges = jq.calibrate(jq.fold_variables(variables), [x[0, ..., 0]])
    want = np.asarray(jq.make_quantized_predict_fn(
        jq.fold_variables(variables), ranges, dtype=jnp.float32,
        blocked_edges=blocked)(jnp.asarray(x)))
    calls = []
    plain = k3._int8_conv_plain

    def counted(x, weights, epilogue):
        calls.append(epilogue.mode)
        return plain(x, weights, epilogue)

    monkeypatch.setattr(k3, "_int8_conv_plain", counted)
    launches = k3.LAUNCHES
    fn = tq.make_quantized_predict_fn(tq.fold_variables(port), ranges,
                                      dtype=torch.float32, blocked_edges=blocked)
    got = fn(torch.from_numpy(x)).numpy()
    assert len(calls) == 21 and calls.count("affine_requant") == 4
    assert set(calls) == {"relu_requant", "affine_requant"}
    assert k3.LAUNCHES == launches
    agree = (got == want).mean()
    print(f"blocked={blocked}: agreement {agree:.6f}")
    assert got.shape == want.shape and agree >= 0.999
    calls.clear()
    fn(torch.from_numpy(x))
    assert len(calls) == 21


def test_int8_head_takes_the_f32_mode(monkeypatch):
    """With every block quantized the dense walk's head is the wrapper's
    ``relu_f32`` mode (23 calls: enc1a from the quantized input too)."""
    _, port = _pair()
    x = torch.from_numpy(_x(7))
    folded = tq.fold_variables(port)
    ranges = tq.calibrate(folded, [x[0, ..., 0].numpy()], device="cpu")
    calls = []
    plain = k3._int8_conv_plain
    monkeypatch.setattr(k3, "_int8_conv_plain",
                        lambda x, w, e: calls.append((e.mode, w.cin)) or plain(x, w, e))
    tq.make_quantized_predict_fn(folded, ranges, fp_blocks=(), dtype=torch.float32)(x)
    assert len(calls) == 23 and calls[0] == ("relu_requant", 1)
    assert calls[-1][0] == "relu_f32"


def test_trace_groups_name_k3():
    from tpuseg_torch.utils import trace_analysis

    name = "void (anonymous namespace)::int8_conv_kernel<0, true>((anonymous namespace)::Params)"
    assert trace_analysis.kernel_group(name) == "K3 int8_conv"
