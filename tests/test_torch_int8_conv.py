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
package's on >= 0.999 of pixels (tests/test_torch_quant.py's tolerance)."""

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


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::int8_conv_kernel<0, true>((anonymous namespace)::Params)",
    "void (anonymous namespace)::int8_conv_wgmma_kernel<2, 128>(CUtensorMap_st, "
    "CUtensorMap_st, (anonymous namespace)::WParams)"])
def test_trace_groups_name_k3(name):
    from tpuseg_torch.utils import trace_analysis

    assert trace_analysis.kernel_group(name) == "K3 int8_conv"
