"""K3, the int8 conv with its epilogue fused (tpuseg_torch/infer/int8_conv.py).

On the CPU the wrapper runs its plain version (im2col + ``torch._int_mm``
+ the epilogue in PyTorch). It is held here against an exact conv of the
int8 codes (float64 ``F.conv2d``: the sums stay below 2^53) followed by the
epilogue in numpy float32 in the same order of operations, and against the
JAX package's ``_conv_s8``: int32 sums and epilogue outputs bit-equal. The
kernel's weight layout and K-step addressing are held by a numpy model of
its loop. The skip lists (the K-steps each N tile runs) are counted on
weights blocked by the JAX package's ``_block_weight``, and a numpy model
of the ``"wgmma"`` route's schedule (listed K-steps over ``bh x bw``
patches, TMA's zero fill as out-of-range reads of 0) is held bit-equal to
``_conv_s8``. The route, N-tile and patch rules are plain functions of
shapes and counts, tested here. The CUDA kernel itself is held against the
plain version on the card by tests/test_torch_cuda.py and by
chip_smoke.py.

The whole quantized walk at base 4 goes through the wrapper 21 times a
predict call with the default fp_blocks, and its labels agree with the JAX
package's on >= 0.999 of pixels (tests/test_torch_quant.py's tolerance).

The store forms (``out=``, ``d2s=``, ``pool=``: the walk's concats,
depth-to-space and pools) are held two ways: the plain version's forms
bit-equal to the eager composition the walk ran before them
(``quant._d2s``, ``quant._maxpool``, the phase max, ``torch.cat``), and a
numpy model of the kernel's store stage (its 16-byte segments, their
addresses and masks, the pooled reads of the shared tile) bit-equal to
the same composition at every N-tile and patch width the rules allow.
Both int8 walks run no eager edge op on an int8 edge, and label bit-equal
to their unfused composition."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.infer import quant as jq
from tpuseg_torch.infer import int8_conv as k3
from tpuseg_torch.infer import quant as tq

from test_torch_quant import _pair, _x
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

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
    """The "mma" route's K loop in numpy: each 128-wide N tile runs the
    K-steps of its skip list (``kstep`` bytes each); each A row is a pixel's
    run of channels of one tap (cin % 16 == 0) or a run of the packed taps,
    zero where a tap leaves the image or past K."""
    b, h, w, _ = x.shape
    m = b * h * w
    pix = x.reshape(m, cin).astype(np.int64)
    img, rem = np.divmod(np.arange(m), h * w)
    py, px = np.divmod(rem, w)
    acc = np.zeros((m, wm.shape[0]), np.int64)
    aligned = cin % 16 == 0
    steps_per_tap = -(-cin // kstep)
    steps, counts = k3._skip_lists(wm, 128)
    for nt, count in enumerate(counts):
        n = slice(nt * 128, (nt + 1) * 128)
        for step in steps[nt, :count]:
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
            acc[:, n] += a @ wm[n, step * kstep:(step + 1) * kstep].astype(np.int64).T
    return acc.reshape(b, h, w, -1)


@pytest.mark.parametrize("cin, k", [(1, 3), (4, 3), (16, 3), (48, 1), (64, 3), (80, 3),
                                    (3, 1)])
def test_kernel_layout_and_k_steps(cin, k):
    """The weight layout the kernel reads, walked as the "mma" route walks
    it (each N tile's skip list), gives the exact conv: per-tap padding to
    the K-step for cin % 16 == 0, packed taps otherwise. Tap 0 of output
    channels 0..129 is zeroed, so the two N tiles list different steps."""
    rng = np.random.default_rng(cin + k)
    x, wq = _codes(rng, (2, 5, 6, cin)), _codes(rng, (k, k, cin, 135))
    wq[0, 0, :, :130] = 0
    wm = k3._kernel_layout(wq)
    taps = k * k
    kp = taps * -(-cin // 64) * 64 if cin % 16 == 0 else -(-taps * cin // 64) * 64
    assert wm.shape == (135, kp) and wm.dtype == np.int8
    np.testing.assert_array_equal(_kernel_model(x, wm, k, k, cin), _exact_conv(x, wq))


def _blocked_codes(rng, groups, cout0):
    """A 3x3 conv's codes blocked as the int8_blocked walk blocks its edge
    convs: float weights through the JAX package's ``_block_weight``, then
    ``quantize_weight``, as quant.py does (structural zeros stay zero)."""
    w = rng.normal(0, 1, (3, 3, sum(groups), cout0)).astype(np.float32)
    wb = jq._block_weight(w, groups)
    wq, _ = jq.quantize_weight(wb, np.ones(wb.shape[2], np.float32))
    return np.asarray(wq)


@pytest.mark.parametrize("groups, counts", [((64,), (9, 12, 16)), ((64, 64), (18, 24, 32))])
def test_skip_lists_count_blocked_zero_k_steps(groups, counts):
    """enc1b/dec1b (cin_groups (64,)) and dec1a ((64, 64)) at base 64: 36
    and 72 K-steps, of which each N tile runs 9/12/16 and 18/24/32 at
    widths 64/128/256, found from the codes alone."""
    wq = _blocked_codes(np.random.default_rng(len(groups)), groups, 64)
    assert wq.shape == (3, 3, 4 * sum(groups), 256)
    wm = k3._kernel_layout(wq)
    ksteps = wm.shape[1] // 64
    assert ksteps == 36 * len(groups)
    for bn, want in zip(k3.N_TILES, counts):
        steps, n = k3._skip_lists(wm, bn)
        assert steps.shape == (256 // bn, ksteps) and steps.dtype == n.dtype == np.int32
        assert (n == want).all(), (bn, n)
        for row, c in zip(steps, n):
            assert (np.diff(row[:c]) > 0).all() and (row[c:] == -1).all()
        for t in range(256 // bn):
            nz = (wm[t * bn:(t + 1) * bn].reshape(bn, ksteps, 64) != 0).any(axis=(0, 2))
            np.testing.assert_array_equal(steps[t, :n[t]], np.flatnonzero(nz))
    assert k3.n_tile_width("wgmma", 256, {bn: k3._skip_lists(wm, bn)[1]
                                          for bn in k3.N_TILES}) == 64


def test_empty_skip_list_for_an_all_zero_tile():
    wq = _codes(np.random.default_rng(3), (3, 3, 16, 200))
    wq[..., 64:192] = 0
    steps, counts = k3._skip_lists(k3._kernel_layout(wq), 64)
    np.testing.assert_array_equal(counts, [9, 0, 0, 9])
    assert (steps[1:3] == -1).all()


@pytest.mark.parametrize("wq_kind, want", [
    ("dense", 9 * 64 * 32), ("packed", 9 * 3 * 32), ("tail48", 9 * 48 * 32),
    ("blocked", 9 * 64 * 256), ("blocked2", 9 * 128 * 256)])
def test_needed_macs(wq_kind, want):
    """Multiply-adds per output pixel the weights need: every tap of dense
    codes (the layout's zero padding of Cin 48 not counted), a quarter of
    the blocked convs' (4*64 -> 4*64: 9*64 of 9*256 per output channel)."""
    rng = np.random.default_rng(7)
    wq = {"dense": lambda: _codes(rng, (3, 3, 64, 32)),
          "packed": lambda: _codes(rng, (3, 3, 3, 32)),
          "tail48": lambda: _codes(rng, (3, 3, 48, 32)),
          "blocked": lambda: _blocked_codes(rng, (64,), 64),
          "blocked2": lambda: _blocked_codes(rng, (64, 64), 64)}[wq_kind]()
    wq[wq == 0] = 1 if wq_kind in ("dense", "packed", "tail48") else 0
    assert k3.needed_macs(wq) == want


def _wgmma_model(x, wm, kh, kw, cin, bn, bw):
    """The "wgmma" route's schedule in numpy: the output in ``bh x bw``
    patches of one image (128 pixels, row ``ly * bw + lx`` of the tile), each
    N tile summing only the K-steps of its skip list; TMA's zero fill is a
    read of 0 at any coordinate outside the tensor (rows, columns, the Cin
    tail); patch rows past H or W are dropped as the epilogue's stores
    mask them."""
    b, h, w, _ = x.shape
    bh = 128 // bw
    ty, tx = -(-h // bh), -(-w // bw)
    steps, counts = k3._skip_lists(wm, bn)
    spt = -(-cin // 64)
    cout = wm.shape[0]
    wpad = np.zeros((len(counts) * bn, wm.shape[1]), np.int64)
    wpad[:cout] = wm

    # x inside a frame of zeros wide enough for every coordinate a box reads
    xz = np.zeros((b, ty * bh + 2, tx * bw + 2, spt * 64), np.int64)
    xz[:, 1:h + 1, 1:w + 1, :cin] = x

    def box(c0, dy, dx):  # the {64, bw, bh, 1} box of every patch at once
        a = xz[:, 1 + dy:1 + dy + ty * bh, 1 + dx:1 + dx + tx * bw, c0:c0 + 64]
        return a.reshape(b, ty, bh, tx, bw, 64).transpose(0, 1, 3, 2, 4, 5).reshape(
            b, ty, tx, 128, 64)

    acc = np.zeros((b, ty, tx, 128, len(counts) * bn), np.int64)
    for nt, count in enumerate(counts):
        for step in steps[nt, :count]:
            tap, c = divmod(int(step), spt)
            dy, dx = tap // kw - kh // 2, tap % kw - kw // 2
            a = box(c * 64, dy, dx)
            bt = wpad[nt * bn:(nt + 1) * bn, step * 64:(step + 1) * 64]
            # float64 products and sums of int8 codes are exact (< 2^53)
            acc[..., nt * bn:(nt + 1) * bn] += (a.astype(np.float64) @ bt.T.astype(
                np.float64)).astype(np.int64)
    y = acc.reshape(b, ty, tx, bh, bw, -1).transpose(0, 1, 3, 2, 4, 5)
    return y.reshape(b, ty * bh, tx * bw, -1)[:, :h, :w, :cout]


@pytest.mark.parametrize("cin, groups, w", [(16, (4,), 16), (48, (12,), 100),
                                            (80, (8, 12), 512), (48, None, 16),
                                            (80, None, 100), (16, None, 512)])
def test_wgmma_schedule_bit_equal_to_tpuseg(cin, groups, w):
    """The wgmma route's schedule at every patch and N-tile width, on
    blocked codes (``groups``) and dense ones, H = 13 (no multiple of bh for
    bw < 128): int32 sums bit-equal to ``tpuseg``'s ``_conv_s8`` and to the
    plain version."""
    rng = np.random.default_rng(cin + w)
    x = _codes(rng, (2, 13, w, cin))
    wq = _blocked_codes(rng, groups, 6) if groups else _codes(rng, (3, 3, cin, 70))
    wm = k3._kernel_layout(wq)
    want = np.asarray(jq._conv_s8(jnp.asarray(x), jnp.asarray(wq)))
    plain = k3._int8_conv_plain(torch.from_numpy(x), k3.Int8ConvWeights(wq), None).numpy()
    np.testing.assert_array_equal(plain, want)
    for bw in k3.PATCH_WIDTHS:
        for bn in k3.N_TILES:
            got = _wgmma_model(x, wm, 3, 3, cin, bn, bw)
            np.testing.assert_array_equal(got, want, err_msg=f"bw {bw} bn {bn}")


@pytest.mark.parametrize("cin, route", [(1, "mma"), (3, "mma"), (4, "mma"), (8, "mma"),
                                        (16, "wgmma"), (48, "wgmma"), (64, "wgmma"),
                                        (80, "wgmma"), (1024, "wgmma")])
def test_route_rule(cin, route):
    """TMA needs the pixel stride (Cin bytes) a multiple of 16."""
    assert k3.kernel_route(cin) == route


def test_n_tile_and_patch_rules():
    """The "mma" route's tile is 128 wide; "wgmma" picks by the K-steps run
    and the tiles: 64 for a dense Cout = 64 (the int8 walk's full-resolution
    blocks) and for the blocked convs, 128 for Cout = 128, the fitted
    costs' choice for wide deep layers; the patch width covers H x W with
    the fewest pixels, the wider on a tie."""
    def counts(cout, ksteps):
        return {bn: np.full(-(-cout // bn), ksteps, np.int32) for bn in k3.N_TILES}

    assert k3.n_tile_width("mma", 64, counts(64, 9)) == 128
    assert k3.n_tile_width("wgmma", 64, counts(64, 9)) == 64
    assert k3.n_tile_width("wgmma", 64, counts(64, 18)) == 64
    assert k3.n_tile_width("wgmma", 128, counts(128, 18)) == 128
    assert k3.n_tile_width("wgmma", 1024, counts(1024, 144)) == 256
    assert k3.n_tile_width("wgmma", 512, counts(512, 72)) == 128
    blocked = {64: np.full(4, 9), 128: np.full(2, 12), 256: np.full(1, 16)}
    assert k3.n_tile_width("wgmma", 256, blocked) == 64
    empty = {bn: np.zeros(-(-300 // bn), np.int32) for bn in k3.N_TILES}
    assert k3.n_tile_width("wgmma", 300, empty) == 64  # tiles of epilogue alone
    with pytest.raises(ValueError, match="route"):
        k3.n_tile_width("dense", 64, counts(64, 9))
    assert k3.patch_width(512, 512) == 128
    assert k3.patch_width(64, 64) == 64
    assert k3.patch_width(13, 16) == 16  # bh 8: H = 13 leaves a ragged patch row
    assert k3.patch_width(13, 64) == 64
    assert k3.patch_width(13, 100) == 128  # 13 rows of 128 waste less than 2 of 8 x 112
    assert k3.patch_width(13, 512) == 128
    assert k3.patch_width(2, 40) == 64  # one 64 x 2 patch covers 2 x 40
    assert k3.patch_width(1, 40) == 128  # 128 x 1 and 64 x 2 tie: the wider


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
    calls, forms = [], []
    plain = k3._int8_conv_plain

    def counted(x, weights, epilogue, out=None, d2s=False, pool=None):
        calls.append(epilogue.mode)
        forms.append((out is not None, d2s, pool))
        return plain(x, weights, epilogue, out, d2s, pool)

    monkeypatch.setattr(k3, "_int8_conv_plain", counted)
    launches = k3.LAUNCHES
    fn = tq.make_quantized_predict_fn(tq.fold_variables(port), ranges,
                                      dtype=torch.float32, blocked_edges=blocked)
    got = fn(torch.from_numpy(x)).numpy()
    assert len(calls) == 21 and calls.count("affine_requant") == 4
    assert set(calls) == {"relu_requant", "affine_requant"}
    # the store forms: 4 skips into their concat buffers with their pools
    # (enc1b's a phase max in the blocked walk), 4 deconvs into the other
    # halves (the blocked dec1up without depth-to-space)
    pools = ["phase"] + ["spatial"] * 3 if blocked else ["spatial"] * 4
    assert [f for f in forms if f[2]] == [(True, False, p) for p in pools]
    assert [f for f in forms if f[0] and not f[2]] == \
        [(True, True, None)] * 3 + [(True, not blocked, None)]
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
                        lambda x, w, e, *forms: calls.append((e.mode, w.cin)) or plain(x, w, e,
                                                                                      *forms))
    tq.make_quantized_predict_fn(folded, ranges, fp_blocks=(), dtype=torch.float32)(x)
    assert len(calls) == 23 and calls[0] == ("relu_requant", 1)
    assert calls[-1][0] == "relu_f32"


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::int8_conv_kernel<0, true>((anonymous namespace)::Params)",
    "void (anonymous namespace)::int8_conv_wgmma_kernel<2, 128>(CUtensorMap_st, "
    "CUtensorMap_st, (anonymous namespace)::WParams)"])
def test_trace_groups_name_k3(name):
    from tpuseg_torch.utils import trace_analysis

    assert trace_analysis.kernel_group(name) == "K3 int8_conv"


# --- the store forms: the walk's concats, depth-to-space and pools ---------

def _phase_max(y):
    """quant.py's blocked-walk phase max (a closure there), as it ran."""
    c = y.shape[-1] // 4
    return torch.maximum(torch.maximum(y[..., :c], y[..., c:2 * c]),
                         torch.maximum(y[..., 2 * c:3 * c], y[..., 3 * c:]))


def _form_inputs(seed, b, h, w, cin, cout, kind, impl="conv_transpose"):
    """Codes, weights and an int8 epilogue of a conv block (``kind``
    "conv", 3x3) or a deconv (``kind`` "deconv": a 2x2 deconv's codes laid
    out by ``quant._block_weight_deconv`` as a 1x1 conv to phase-major
    ``cout = 4C``, per ``impl``)."""
    rng = np.random.default_rng(seed)
    x = _codes(rng, (b, h, w, cin))
    if kind == "deconv":
        wd = _codes(rng, (2, 2, cin, cout // 4) if impl == "conv_transpose"
                    else (1, 1, cin, cout))
        wq = tq._block_weight_deconv(wd, impl)
        mode, k = "affine_requant", 1
    else:
        wq, mode, k = _codes(rng, (3, 3, cin, cout)), "relu_requant", 9
    arrs = _epilogue_arrays(rng, cout, k * cin)
    return rng, torch.from_numpy(x), k3.Int8ConvWeights(np.asarray(wq)), _epilogue(mode, arrs)


# (name, kind, impl, h, w, cin, cout, buffer channels before/after the
# output's, d2s, pool): small shapes, H and W no multiple of most patches
FORM_CASES = [
    ("skip_pool", "conv", None, 14, 22, 16, 16, (0, 16), False, "spatial"),
    ("skip_pool_base4", "conv", None, 16, 12, 4, 4, (0, 4), False, "spatial"),
    ("skip_pool_64", "conv", None, 64, 64, 16, 32, (0, 32), False, "spatial"),
    ("blocked_skip_phase", "conv", None, 10, 18, 16, 64, (0, 64), False, "phase"),
    ("blocked_skip_phase_base4", "conv", None, 12, 8, 16, 16, (0, 16), False, "phase"),
    ("blocked_skip_phase_f64", "conv", None, 6, 10, 16, 256, (0, 256), False, "phase"),
    ("phase_f64_alone", "conv", None, 3, 5, 16, 256, None, False, "phase"),
    ("pool_alone", "conv", None, 6, 34, 16, 32, None, False, "spatial"),
    ("phase_alone", "conv", None, 7, 9, 16, 64, None, False, "phase"),
    ("up_d2s", "deconv", "conv_transpose", 7, 11, 32, 64, (16, 0), True, None),
    ("up_d2s_pixel_shuffle", "deconv", "pixel_shuffle", 5, 9, 32, 64, (16, 0), True, None),
    ("up_d2s_base4", "deconv", "conv_transpose", 6, 4, 8, 16, (4, 0), True, None),
    ("d2s_alone", "deconv", "pixel_shuffle", 3, 13, 16, 128, None, True, None),
    ("blocked_up", "deconv", "conv_transpose", 9, 10, 32, 64, (64, 0), False, None),
    ("concat_middle", "conv", None, 5, 7, 16, 16, (16, 32), False, None),
]


def _form_call(case, seed=0):
    """The plain version's store form and the eager composition it
    replaces, on the same inputs: ``(got, want)``, each ``(buffer or
    output, pooled or None)``."""
    _, kind, impl, h, w, cin, cout, around, d2s, pool = case
    rng, x, op, epi = _form_inputs(seed, 2, h, w, cin, cout, kind, impl or "conv_transpose")
    y = k3._int8_conv_plain(x, op, epi)
    if d2s:
        y = tq._d2s(y)
    want_pool = None if pool is None else (tq._maxpool(y) if pool == "spatial" else
                                           _phase_max(y))
    out = None
    if around is None:
        want = y
    else:  # the other branch of the concat, filled by another block
        before = torch.from_numpy(_codes(rng, y.shape[:3] + (around[0],)))
        after = torch.from_numpy(_codes(rng, y.shape[:3] + (around[1],)))
        want = torch.cat([before, y, after], dim=-1)
        buf = torch.cat([before, torch.full_like(y, 99), after], dim=-1)
        out = buf[..., around[0]:around[0] + y.shape[-1]]
    got = k3.int8_conv(x, op, epi, out=out, d2s=d2s, pool=pool)
    got, got_pool = got if pool else (got, None)
    if out is not None:
        assert got.data_ptr() == out.data_ptr()
        got = buf
    return (got, got_pool), (want, want_pool)


@pytest.mark.parametrize("case", FORM_CASES, ids=[c[0] for c in FORM_CASES])
def test_plain_store_forms_equal_the_eager_composition(case):
    """``out=`` (a channel slice of the concat buffer: the other channels
    untouched), ``d2s=`` (both deconv layouts) and ``pool=`` (spatial and
    phase) on the plain version: bit-equal to the walk's former eager ops,
    ``torch.cat``, ``quant._d2s``, ``quant._maxpool`` and the phase max."""
    (got, got_pool), (want, want_pool) = _form_call(case)
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(got, want)
    if want_pool is None:
        assert got_pool is None
    else:
        assert got_pool.shape == want_pool.shape and torch.equal(got_pool, want_pool)
        assert len(torch.unique(want_pool)) >= 8  # the codes are not degenerate


def _store_model(y, bn, bw, ostride, d2s, pool, rng):
    """The ``"wgmma"`` route's int8 store stage (csrc/int8_conv.cu) in
    numpy, on the full-resolution codes ``y`` ``(B, H, W, cout)``: each
    128-pixel ``bh x bw`` patch and N tile of ``bn`` channels as a shared
    tile (rows and columns past the image or Cout filled with noise, as the
    kernel's tile holds codes of zero-filled inputs there), then the
    kernel's loops over 16-byte segments with its index arithmetic and
    masks: the full-resolution store (row stride ``ostride``, depth-to-space
    with ``d2s``) into a buffer of sentinels (int16 999), and the pooled
    store from the same tile; a phase max over 4 N tiles of one phase each
    (``cout == 4 * bn``) as the running max of the block's 4 tiles.
    Returns ``(out, pooled)``."""
    b, h, w, cout = y.shape
    bh = 128 // bw
    lg = bw.bit_length() - 1
    chunks = bn // 16
    oh, ow = (2 * h, 2 * w) if d2s else (h, w)
    out = np.full((b, oh, ow, ostride), 999, np.int16)
    f = cout // 4
    pooled = None if pool is None else np.full(
        (b, h // 2, w // 2, cout) if pool == "spatial" else (b, h, w, f), 999, np.int16)
    yn = y.numpy().astype(np.int16)
    looped = pool == "phase" and cout == 4 * bn
    for img in range(b):
        for y0 in range(0, -(-h // bh) * bh, bh):
            for x0 in range(0, -(-w // bw) * bw, bw):
                running = np.full((128, bn), -128, np.int16)
                for n0 in range(0, cout, bn):
                    tile = rng.integers(-127, 128, (128, bn)).astype(np.int16)
                    r = np.arange(128)
                    py, px = y0 + (r >> lg), x0 + (r & (bw - 1))
                    ok = (py < h) & (px < w)
                    nc = min(bn, cout - n0)
                    tile[ok, :nc] = yn[img, py[ok], px[ok], n0:n0 + nc]
                    c = np.arange(128 * chunks)
                    rr, col = c // chunks, (c % chunks) * 16
                    py, px, n = y0 + (rr >> lg), x0 + (rr & (bw - 1)), n0 + col
                    m = (py < h) & (px < w) & (n < cout)
                    rr, col, py, px, n = (a[m] for a in (rr, col, py, px, n))
                    if d2s:
                        ph = n // f
                        oy, ox, ch = 2 * py + (ph >> 1), 2 * px + (ph & 1), n - ph * f
                    else:
                        oy, ox, ch = py, px, n
                    for k in range(16):
                        out[img, oy, ox, ch + k] = tile[rr, col + k]
                    if pool == "spatial":
                        c = np.arange(32 * chunks)
                        q, col = c // chunks, (c % chunks) * 16
                        pr, pc = q >> (lg - 1), q & ((bw >> 1) - 1)
                        yy, xx, n = y0 // 2 + pr, x0 // 2 + pc, n0 + col
                        m = (yy < h // 2) & (xx < w // 2) & (n < cout)
                        pr, pc, col, yy, xx, n = (a[m] for a in (pr, pc, col, yy, xx, n))
                        r00 = ((2 * pr) << lg) + 2 * pc
                        for k in range(16):
                            pooled[img, yy, xx, n + k] = np.maximum.reduce([
                                tile[r00, col + k], tile[r00 + 1, col + k],
                                tile[r00 + bw, col + k], tile[r00 + bw + 1, col + k]])
                    elif looped:
                        running = np.maximum(running, tile)
                        if n0 + bn == cout:
                            c = np.arange(128 * chunks)
                            rr, col = c // chunks, (c % chunks) * 16
                            py, px = y0 + (rr >> lg), x0 + (rr & (bw - 1))
                            m = (py < h) & (px < w)
                            rr, col, py, px = (a[m] for a in (rr, col, py, px))
                            for k in range(16):
                                pooled[img, py, px, col + k] = running[rr, col + k]
                    elif pool == "phase":
                        assert n0 == 0 and cout <= bn
                        c = np.arange(128 * (f // 16))
                        rr, col = c // (f // 16), (c % (f // 16)) * 16
                        py, px = y0 + (rr >> lg), x0 + (rr & (bw - 1))
                        m = (py < h) & (px < w)
                        rr, col, py, px = (a[m] for a in (rr, col, py, px))
                        for k in range(16):
                            pooled[img, py, px, col + k] = np.maximum.reduce(
                                [tile[rr, col + k + p * f] for p in range(4)])
    return out, pooled


@pytest.mark.parametrize("case", [c for c in FORM_CASES if "base4" not in c[0]],
                         ids=[c[0] for c in FORM_CASES if "base4" not in c[0]])
def test_kernel_store_model_equals_the_eager_composition(case):
    """The kernel's store stage, modelled in numpy, at every N-tile width
    and patch width the rules allow for the form (a spatial pool: bw <=
    64; a phase max: an N tile covering Cout, or 4 N tiles of one phase
    each): the buffer's other channels
    keep their sentinel, every written code and pooled code bit-equal to
    the composition. The forms' channel counts are multiples of 16, as
    :func:`form_problem` asks on a card (the base-4 cases' are not)."""
    name, kind, impl, h, w, cin, cout, around, d2s, pool = case
    assert k3.form_problem(torch.empty((2, h, w, cin), dtype=torch.int8, device="meta"),
                           cout, "relu_requant", None if around is None else
                           cout // (4 if d2s else 1) + sum(around), d2s, pool) is None
    (_, _), (want, want_pool) = _form_call(case)
    y = k3._int8_conv_plain(*_form_inputs(0, 2, h, w, cin, cout, kind,
                                          impl or "conv_transpose")[1:])
    before = 0 if around is None else around[0]
    ostride = want.shape[-1]
    rng = np.random.default_rng(1)
    bws = k3._POOL_PATCH_WIDTHS if pool == "spatial" else k3.PATCH_WIDTHS
    bns = [bn for bn in k3.N_TILES if pool != "phase" or k3._phase_width(bn, cout)]
    assert bws and bns
    for bw in bws:
        for bn in bns:
            out, pooled = _store_model(y, bn, bw, ostride, d2s, pool, rng)
            c = y.shape[-1] // (4 if d2s else 1)
            np.testing.assert_array_equal(out[..., :c], want[..., before:before + c].numpy(),
                                          err_msg=f"bw {bw} bn {bn}")
            assert (out[..., c:] == 999).all(), f"bw {bw} bn {bn}: stores past the output"
            if pool:
                np.testing.assert_array_equal(pooled, want_pool.numpy(),
                                              err_msg=f"pooled, bw {bw} bn {bn}")


def test_form_rules():
    """What the wrapper takes: the contract's rules on any device, the
    kernel's on a card (modelled by ``meta`` tensors, which take the
    card's rules and hold no data); the N-tile and patch rules of the
    pool-emitting blocks."""
    def x(cin, h=8, w=8, dev="meta"):
        return torch.empty((2, h, w, cin), dtype=torch.int8, device=dev)

    fp = k3.form_problem
    for dev in ("cpu", "meta"):
        assert fp(x(16, dev=dev), 64, "relu_f32", ctot=128) is not None
        assert "combine" in fp(x(16, dev=dev), 64, "affine_requant", d2s=True, pool="spatial")
        assert "even" in fp(x(16, h=7, dev=dev), 64, "relu_requant", pool="spatial")
        assert "4 phases" in fp(x(16, dev=dev), 66, "relu_requant", pool="phase")
        assert "fewer" in fp(x(16, dev=dev), 64, "relu_requant", ctot=48)
        assert "not in" in fp(x(16, dev=dev), 64, "relu_requant", pool="avg")
        assert fp(x(16, dev=dev), 64, "relu_requant") is None  # no form
        assert fp(x(16, dev=dev), 64, "relu_requant", ctot=128, pool="spatial") is None
        assert fp(x(64, dev=dev), 256, "affine_requant", ctot=128, d2s=True) is None
        assert fp(x(256, dev=dev), 256, "relu_requant", ctot=512, pool="phase") is None
    # the plain version takes any width; the kernel 16-byte segments of its route
    assert fp(x(4, dev="cpu"), 4, "relu_requant", ctot=8, pool="spatial") is None
    assert fp(x(8, dev="cpu"), 16, "affine_requant", ctot=8, d2s=True) is None
    assert "wgmma" in fp(x(4), 16, "relu_requant", ctot=32)
    assert "Cout 24" in fp(x(16), 24, "relu_requant", pool="spatial")
    assert "buffer width 40" in fp(x(16), 16, "relu_requant", ctot=40)
    assert "phase's width 24" in fp(x(16), 96, "affine_requant", d2s=True)
    assert "phase's width 8" in fp(x(16), 32, "relu_requant", pool="phase")
    assert "N tile" in fp(x(16), 1024, "relu_requant", pool="phase")
    assert "N tile" in fp(x(16), 256, "relu_requant", pool="phase", bn=128)
    assert fp(x(16), 256, "relu_requant", pool="phase", bn=256) is None
    assert fp(x(16), 256, "relu_requant", pool="phase", bn=64) is None  # a phase a tile
    assert "N tile" in fp(x(16), 512, "relu_requant", pool="phase")  # F 128
    assert "even row count" in fp(x(16), 64, "relu_requant", pool="spatial", bw=128)
    assert "wgmma" in fp(x(64), 64, "relu_requant", pool="spatial", route="mma")
    # the served pool blocks: 512^2 .. 128^2 levels take 64-wide patches
    # (bh 2), not the 128 x 1 rows a plain call takes there
    for side in (1024, 512, 256, 128):
        assert k3.patch_width(side, side) == 128
        assert k3.patch_width(side, side, "spatial") == 64
    assert k3.patch_width(14, 22, "spatial") == 32
    assert k3.patch_width(13, 100, "phase") == 128
    blocked = {64: np.full(4, 9), 128: np.full(2, 12), 256: np.full(1, 16)}
    assert k3.n_tile_width("wgmma", 256, blocked) == 64
    # the blocked enc1b: 4 tiles of one phase each, which skip 3/4 of their
    # K-steps, cost less than one 256-wide tile
    assert k3.n_tile_width("wgmma", 256, blocked, "phase") == 64
    assert [bn for bn in k3.N_TILES if k3._phase_width(bn, 256)] == [64, 256]
    assert [bn for bn in k3.N_TILES if k3._phase_width(bn, 64)] == [64, 128, 256]
    assert k3.n_tile_width("wgmma", 64, blocked, "phase") == 64
    assert k3.n_tile_width("wgmma", 256, blocked, "spatial") == 64
    assert k3.n_tile_width("mma", 256, blocked, "phase") == 128


def test_wrapper_refuses_what_it_does_not_take():
    """On CPU tensors the wrapper raises on the contract's refusals before
    the plain version runs: a form in the f32 mode, an odd H with a 2x2
    pool, an ``out`` of another shape or dtype, not a channel slice of a
    contiguous buffer, or overlapping ``x``."""
    _, x, op, epi = _form_inputs(3, 1, 6, 8, 16, 16, "conv")
    buf = torch.zeros((1, 6, 8, 32), dtype=torch.int8)
    f32 = k3.Epilogue("relu_f32", epi.ws, epi.b, epi.s, epi.t, None)
    with pytest.raises(ValueError, match="int8 modes"):
        k3.int8_conv(x, op, f32, pool="spatial")
    with pytest.raises(ValueError, match="even H"):
        k3.int8_conv(x[:, :5].contiguous(), op, epi, pool="spatial")
    with pytest.raises(ValueError, match="shape"):
        k3.int8_conv(x, op, epi, out=buf[:, :5, :, :16])
    with pytest.raises(ValueError, match="int8"):
        k3.int8_conv(x, op, epi, out=buf.float()[..., :16])
    with pytest.raises(ValueError, match="channel slice"):
        k3.int8_conv(x, op, epi, out=torch.zeros((1, 8, 6, 16), dtype=torch.int8).transpose(1, 2))
    with pytest.raises(ValueError, match="overlaps"):
        k3.int8_conv(x, op, epi, out=x)
    assert torch.equal(buf, torch.zeros_like(buf))
    y, pooled = k3.int8_conv(x, op, epi, out=buf[..., 16:], pool="spatial")
    assert y.data_ptr() == buf[..., 16:].data_ptr() and (buf[..., :16] == 0).all()
    assert pooled.shape == (1, 3, 4, 16)


def _frame_guard(monkeypatch):
    """Make ``quant._maxpool``, ``quant._d2s`` and ``torch.cat`` /
    ``torch.maximum`` called from ``quant.py`` (the concat and the phase
    max) raise on int8 tensors: the walk's eager edge ops on int8 edges."""
    import sys

    def guard(name, fn, from_quant_only):
        def wrapped(*args, **kwargs):
            ts = args[0] if isinstance(args[0], (list, tuple)) else args
            caller = sys._getframe(1).f_globals.get("__name__")
            if (not from_quant_only or caller == tq.__name__) and any(
                    isinstance(t, torch.Tensor) and t.dtype == torch.int8 for t in ts):
                raise AssertionError(f"the int8 walk ran {name} on an int8 edge")
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tq, "_maxpool", guard("_maxpool", tq._maxpool, False))
    monkeypatch.setattr(tq, "_d2s", guard("_d2s", tq._d2s, False))
    monkeypatch.setattr(torch, "cat", guard("torch.cat", torch.cat, True))
    monkeypatch.setattr(torch, "maximum", guard("torch.maximum", torch.maximum, True))


@pytest.mark.parametrize("impl", ["conv_transpose", "pixel_shuffle"])
@pytest.mark.parametrize("blocked", [False, True])
def test_int8_walks_fused_like_jax_and_the_unfused_walk(blocked, impl, monkeypatch):
    """Both base-4 int8 walks (default fp_blocks, both deconv layouts) run
    no ``_maxpool``, ``_d2s``, concat or phase max on an int8 edge; their
    labels are bit-equal to the same walk with every edge op eager (the
    store forms refused), and agree with the JAX package's on >= 0.999."""
    variables, port = _pair(impl)
    x = _x(12)
    ranges = jq.calibrate(jq.fold_variables(variables), [x[0, ..., 0]], deconv_impl=impl)
    want = np.asarray(jq.make_quantized_predict_fn(
        jq.fold_variables(variables), ranges, deconv_impl=impl, dtype=jnp.float32,
        blocked_edges=blocked)(jnp.asarray(x)))
    folded = tq.fold_variables(port)
    kw = dict(deconv_impl=impl, dtype=torch.float32, blocked_edges=blocked)
    with monkeypatch.context() as m:
        m.setattr(tq, "form_problem", lambda *a, **k: "the eager composition")
        unfused = tq.make_quantized_predict_fn(folded, ranges, **kw)(torch.from_numpy(x))
    with monkeypatch.context() as m:
        _frame_guard(m)
        got = tq.make_quantized_predict_fn(folded, ranges, **kw)(torch.from_numpy(x))
    assert torch.equal(got, unfused)
    agree = (got.numpy() == want).mean()
    print(f"blocked={blocked} impl={impl}: agreement with JAX {agree:.6f}")
    assert got.shape == want.shape and agree >= 0.999


def test_the_eager_edge_guard_catches_the_unfused_walk(monkeypatch):
    """The guard of the test above fails the walk with its edge ops eager."""
    _, port = _pair()
    x = torch.from_numpy(_x(13))
    folded = tq.fold_variables(port)
    ranges = tq.calibrate(folded, [x[0, ..., 0].numpy()], device="cpu")
    monkeypatch.setattr(tq, "form_problem", lambda *a, **k: "the eager composition")
    _frame_guard(monkeypatch)
    for blocked in (False, True):
        with pytest.raises(AssertionError, match="on an int8 edge"):
            tq.make_quantized_predict_fn(folded, ranges, dtype=torch.float32,
                                         blocked_edges=blocked)(x)
