"""K4, the blocks' bias + ReLU + BatchNorm (tpuseg_torch/ops/batchnorm.py).

On the CPU each wrapper runs its plain version and the autograd Functions
run the hand backward on them, so these tests hold that algebra:

- the port's ``ConvBlock`` (conv, bias, ReLU, BN) and ``DeconvBlock``
  (deconv, BN) against ``tpuseg.models.unet``'s, the same numpy weights and
  input through the weight bridge: train mode (batch statistics,
  ``mutable=["batch_stats"]``) and eval mode (running statistics); the
  output, the running statistics and ``jax.grad`` of ``sum(y * r)`` for the
  input, the kernel, the conv bias and BN's scale and bias. float32: every
  value within 2e-5 of its tensor's largest |value| (the conv sums and the
  batch sums run in another order in XLA; the BN backward cancels terms of
  the size of the gradient). bfloat16: the output within 2^-6 of its
  largest (one bf16 rounding either side of a bf16 conv output or bias
  sum), the statistics within 2e-3 relative, and each gradient no more
  than twice as far (plus 2^-7 of the largest) from flax's float32
  gradient as flax's own bfloat16 gradient is: both round every
  activation to 8 bits, which moves a gradient summed over the batch by
  2-6% from the float32 one on either side (flax also sums the bias
  cotangent in bf16, K4 in f32), so the two bf16 gradients cannot be held
  closer to each other than that; C 2 (the head's narrow path) and C 16;
- the plain versions of (a)-(d) against a float64 numpy reference that
  rounds x + bias as the dtype does: (a) and (c) within the f32 recursive
  summation bound ``gamma_n * sum |t|``, (b) and (d) within one rounding of
  the dtype;
- the hand backward against autograd of the formula it replaces, also
  where the variance clips (a constant channel);
- layouts: rows of channels with a stride (a concat's channel slice) taken
  as they are, anything else refused, a gradient that is not rows copied
  and counted.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.models.unet import ConvBlock as JaxConvBlock
from tpuseg.models.unet import DeconvBlock as JaxDeconvBlock
from tpuseg_torch.models.unet import ConvBlock, DeconvBlock
from tpuseg_torch.ops import batchnorm as k4
from tpuseg_torch.utils.jax_bridge import flax_to_state_dict
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (output, statistics, gradients): see the module docstring; bf16
# gradients are held to flax's float32 ones, relative to flax's own bf16 error
TOLS = {"float32": (2e-5, 1e-5, 2e-5), "bfloat16": (2 ** -6, 2e-3, 2 ** -7)}


def _blocks(kind, c, dtype, impl, seed):
    """The flax block with random numpy variables, its port with the same
    ones, and an NHWC input."""
    rng = np.random.default_rng(seed)
    jdt = DTYPES[dtype][1]
    if kind == "conv":
        cin, hw = 3, 16
        jblock = JaxConvBlock(features=c, kernel=3, dtype=jdt)
        port = ConvBlock(cin, c)
    else:
        cin, hw = 8, 8
        jblock = JaxDeconvBlock(features=c, dtype=jdt, impl=impl)
        port = DeconvBlock(cin, c, impl)
    x = rng.normal(0.5, 1.0, (2, hw, hw, cin)).astype(np.float32)
    shapes = jax.tree_util.tree_map(np.shape, jblock.init(jax.random.PRNGKey(0), x, train=False))

    def draw(path, shape):
        name = "/".join(str(p.key) for p in path)
        if name.endswith("kernel"):
            return rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape).astype(np.float32)
        if name.endswith("scale") or name.endswith("var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.3, shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes,
                                                 is_leaf=lambda s: isinstance(s, tuple))
    sd = flax_to_state_dict({"params": {"b": variables["params"]},
                             "batch_stats": {"b": variables["batch_stats"]}}, impl)
    port.load_state_dict({k[2:]: v for k, v in sd.items()})
    return jblock, variables, port, x


def _to_flax_kernel(kind, impl, w):
    w = w.detach().numpy()
    if kind == "deconv" and impl == "conv_transpose":
        return np.flip(w.transpose(2, 3, 0, 1), (0, 1))
    return w.transpose(2, 3, 1, 0)


def _close(name, got, want, tol, flax_bf16=None):
    """|got - want| within ``tol`` of want's largest |value|; with
    ``flax_bf16``, within twice its distance from ``want`` plus ``tol``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    if flax_bf16 is not None:
        tol += 2 * np.abs(np.asarray(flax_bf16, np.float64) - want).max() / scale
    assert err <= tol, f"{name}: max error {err:.3g} of the largest |value| > {tol:.3g}"


def _flax_grads(jblock, variables, x, r, train):
    def loss(params, xin):
        out = jblock.apply({"params": params, "batch_stats": variables["batch_stats"]}, xin,
                           train=train, mutable=["batch_stats"] if train else False)
        y = out[0] if train else out
        return jnp.sum(y.astype(jnp.float32) * r), out

    (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    key = "conv" if "conv" in gp else "deconv"
    grads = {"dx": gx, "dkernel": gp[key]["kernel"], "dscale": gp["bn"]["scale"],
             "dbeta": gp["bn"]["bias"]}
    if key == "conv":
        grads["dbias"] = gp["conv"]["bias"]
    return out, grads


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind, c, impl", [
    ("conv", 2, None), ("conv", 16, None),
    ("deconv", 2, "conv_transpose"), ("deconv", 16, "pixel_shuffle")])
def test_block_matches_flax(kind, c, impl, train, dtype):
    tdt = DTYPES[dtype][0]
    impl = impl or "conv_transpose"
    seed = c + 10 * train
    jblock, variables, port, x = _blocks(kind, c, dtype, impl, seed)
    r = np.random.default_rng(7).normal(0, 1, x.shape[:1] + (
        x.shape[1] * (1 if kind == "conv" else 2),) * 2 + (c,)).astype(np.float32)
    out, want = _flax_grads(jblock, variables, x, r, train)
    want_y = np.asarray((out[0] if train else out).astype(jnp.float32))
    flax_bf16 = {}
    if dtype == "bfloat16":  # the gradients' yardstick is flax's float32 one
        flax_bf16 = want
        want = _flax_grads(_blocks(kind, c, "float32", impl, seed)[0], variables, x, r, train)[1]

    port.train(train)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port(xt.to(tdt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last), tdt)
    assert k4.row_stride(y) == c  # channels-last out
    got_y = y.permute(0, 2, 3, 1).float()
    (got_y * torch.from_numpy(r)).sum().backward()
    tol_y, tol_s, tol_g = TOLS[dtype]
    _close("y", got_y.detach(), want_y, tol_y)
    if train:
        stats = out[1]["batch_stats"]["bn"]
        np.testing.assert_allclose(port.bn.running_mean.numpy(), np.asarray(stats["mean"]),
                                   rtol=tol_s, atol=tol_s)
        np.testing.assert_allclose(port.bn.running_var.numpy(), np.asarray(stats["var"]),
                                   rtol=tol_s, atol=tol_s)
    else:  # eval leaves them alone
        np.testing.assert_array_equal(port.bn.running_mean.numpy(),
                                      variables["batch_stats"]["bn"]["mean"])
    layer = port.conv if kind == "conv" else port.deconv
    got = {"dx": xt.grad, "dkernel": _to_flax_kernel(kind, impl, layer.weight.grad),
           "dscale": port.bn.weight.grad, "dbeta": port.bn.bias.grad}
    if kind == "conv":
        got["dbias"] = layer.bias.grad
    assert set(got) == set(want)
    for name, g in got.items():
        _close(name, g, want[name], tol_g, flax_bf16.get(name))


# ---------------------------------------------------------------------------
# the plain versions against float64 numpy
# ---------------------------------------------------------------------------

def _round(v, dtype):
    """float64 -> the dtype's value (bf16: round to nearest even on the f32
    bits), as float64."""
    f = np.asarray(v, np.float32)
    if dtype == "bfloat16":
        u = f.view(np.uint32).astype(np.uint64)
        u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
        f = u.astype(np.uint32).view(np.float32)
    return f.astype(np.float64)


def _inputs(c, dtype, seed, relu=True, bias=True):
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype][0]
    x = torch.from_numpy(rng.normal(0.3, 1.0, (3, c, 5, 7)).astype(np.float32)).to(tdt)
    x = x.contiguous(memory_format=torch.channels_last)
    b = torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32)) if bias else None
    g = torch.from_numpy(rng.normal(0, 1, (3, c, 5, 7)).astype(np.float32)).to(tdt)
    g = g.contiguous(memory_format=torch.channels_last)
    vec = {k: torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32))
           for k, lo, hi in (("mean", -0.5, 0.5), ("rstd", 0.5, 2.0), ("mul", -2.0, 2.0),
                             ("beta", -0.5, 0.5), ("k1", -0.3, 0.3), ("k2", -0.3, 0.3))}
    # numpy [M, C] float64 of the activation, rounded as the dtype rounds
    x64 = x.float().permute(0, 2, 3, 1).reshape(-1, c).double().numpy()
    a = x64 if b is None else _round(x64 + _round(b.double().numpy(), dtype), dtype)
    if relu:
        a = np.maximum(a, 0.0)
    g64 = g.float().permute(0, 2, 3, 1).reshape(-1, c).double().numpy()
    return x, b, g, vec, a, g64


def _rows(t):
    return t.float().permute(0, 2, 3, 1).reshape(-1, t.shape[1]).double().numpy()


def _sum_bound(terms):
    n = terms.shape[0]
    u = 2.0 ** -24
    return n * u / (1 - n * u) * np.abs(terms).sum(0) + 1e-30


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c, relu, bias", [(2, True, True), (16, True, True), (16, False, False)])
def test_plain_versions_match_float64(c, relu, bias, dtype):
    x, b, g, v, a, g64 = _inputs(c, dtype, seed=c + relu, relu=relu, bias=bias)
    ulp = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -23

    # (a) within the recursive-summation bound of its terms
    stats = k4.batch_stats(x, b, relu)
    got = stats.double().numpy()
    for k, terms in enumerate((a, a * a)):
        assert np.all(np.abs(got[k] - terms.sum(0)) <= _sum_bound(terms)), k

    # (b) within one rounding of the dtype (plus the f32 steps before it), on
    # the mean and mul it derives from (a)'s sums (gamma: v's mul)
    y, vec = k4.bn_apply_train(x, b, relu, stats, v["mul"], v["beta"], 1e-3)
    mean, mul = vec[0].double().numpy(), vec[3].double().numpy()
    want = (a - mean) * mul + v["beta"].double().numpy()
    assert np.all(np.abs(_rows(y) - want) <= ulp * np.abs(want) + 1e-6)

    # (c) within the summation bound
    mean, rstd = v["mean"].double().numpy(), v["rstd"].double().numpy()
    ah = (a - mean) * rstd
    got = k4.backward_reduce(x, b, relu, g, v["mean"], v["rstd"]).double().numpy()
    m = (a > 0) if relu else np.ones_like(a, bool)
    terms = [g64, g64 * ah] + ([g64 * m, m.astype(np.float64), ah * m] if bias else [])
    assert got.shape == (len(terms), c)
    for k, t in enumerate(terms):
        assert np.all(np.abs(got[k] - t.sum(0)) <= _sum_bound(t) + 1e-6 * np.abs(t).max()), k

    # (d) within one rounding of the dtype
    dx = _rows(k4.backward_apply(x, b, relu, g, v["mean"], v["rstd"], v["mul"], v["k1"],
                                 v["k2"]))
    want = ((g64 - v["k1"].double().numpy()) - ah * v["k2"].double().numpy()) \
        * v["mul"].double().numpy()
    want = np.where(m, want, 0.0)
    assert np.all(np.abs(dx - want) <= ulp * np.abs(want) + 1e-6)


# ---------------------------------------------------------------------------
# the hand backward against autograd of the formula
# ---------------------------------------------------------------------------

def _formula(x, bias, gamma, beta, eps):
    """Train-mode bias + ReLU + BatchNorm as formulas through autograd
    (float64 here, so the comparison sees the algebra)."""
    a = torch.relu(x + bias[:, None, None])
    n = a.shape[0] * a.shape[2] * a.shape[3]
    mean = a.sum((0, 2, 3)) / n
    var = torch.clamp_min((a * a).sum((0, 2, 3)) / n - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps) * gamma
    return (a - mean[:, None, None]) * mul[:, None, None] + beta[:, None, None]


@pytest.mark.parametrize("clip", [False, True], ids=["random", "constant-channel"])
def test_hand_backward_matches_autograd_of_the_formula(clip):
    rng = np.random.default_rng(5 + clip)
    c = 8
    x = rng.normal(0.2, 1.0, (2, c, 6, 5))
    if clip:
        x[:, 3] = 0.7  # a constant channel: its variance is 0 or clips
        x[:, 5] = -1.0  # a dead channel after the ReLU
    params = [rng.normal(0, 0.3, c), rng.uniform(0.5, 1.5, c), rng.normal(0, 0.3, c)]
    r = torch.from_numpy(rng.normal(0, 1, x.shape))
    grads = []
    for hand in (True, False):
        xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last).requires_grad_()
        bias, gamma, beta = [torch.from_numpy(p).requires_grad_() for p in params]
        if hand:
            y, _, _ = k4.TrainBatchNorm.apply(xt, bias, gamma, beta, True, 1e-3, None)
        else:
            y = _formula(xt, bias, gamma, beta, 1e-3)
        (y * r).sum().backward()
        grads.append([t.grad.numpy() for t in (xt, bias, gamma, beta)])
    for name, got, want in zip(("dx", "dbias", "dgamma", "dbeta"), *grads):
        # the batch sums are float32 in K4 (as before K4, as in flax)
        _close(name, got, want, 1e-5)


def test_eval_backward_gives_the_input_and_parameter_gradients():
    """Eval mode: dx = relu' * g * mul, and the parameter gradients of the
    affine map on the running statistics, against autograd."""
    rng = np.random.default_rng(3)
    c = 16
    x = torch.from_numpy(rng.normal(0, 1, (2, c, 4, 4)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    p = [torch.from_numpy(rng.normal(0, s, c).astype(np.float32)) for s in (0.3, 0.3, 0.3)]
    rm = torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32))
    rv = torch.from_numpy(rng.uniform(0.5, 2, c).astype(np.float32))
    r = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32))
    grads = []
    for hand in (True, False):
        xt = x.clone().requires_grad_()
        bias, gamma, beta = [t.clone().requires_grad_() for t in p]
        if hand:
            y = k4.EvalBatchNorm.apply(xt, bias, gamma, beta, rm, rv, True, 1e-3)
        else:
            a = torch.relu(xt + bias[:, None, None])
            mul = torch.rsqrt(rv + 1e-3) * gamma
            y = (a - rm[:, None, None]) * mul[:, None, None] + beta[:, None, None]
        (y * r).sum().backward()
        grads.append([t.grad for t in (xt, bias, gamma, beta)])
    for name, got, want in zip(("dx", "dbias", "dgamma", "dbeta"), *grads):
        _close(name, got, want, 1e-6)


# ---------------------------------------------------------------------------
# layouts and counts
# ---------------------------------------------------------------------------

def test_layouts_rows_strided_and_refused():
    x = torch.randn(2, 8, 3, 5).contiguous(memory_format=torch.channels_last)
    assert k4.row_stride(x) == 8
    wide = torch.randn(2, 24, 3, 5).contiguous(memory_format=torch.channels_last)
    part = wide[:, 8:16]  # a concat's channel slice: rows of stride 24
    assert k4.row_stride(part) == 24
    assert k4.row_stride(torch.randn(2, 8, 3, 5)) is None  # NCHW
    assert k4.row_stride(torch.randn(2, 1, 3, 5)) == 1  # one channel: both layouts
    mean, var, gamma, beta = torch.zeros(8), torch.ones(8), torch.ones(8), torch.zeros(8)
    want = k4.bn_apply_eval(part.contiguous(memory_format=torch.channels_last), None, False,
                            mean, var, gamma, beta, 1e-3)
    assert torch.equal(k4.bn_apply_eval(part, None, False, mean, var, gamma, beta, 1e-3), want)
    with pytest.raises(ValueError, match="not rows of channels"):
        k4.bn_apply_eval(torch.randn(2, 8, 3, 5), None, False, mean, var, gamma, beta, 1e-3)
    with pytest.raises(ValueError, match="float32"):
        k4.bn_apply_eval(x, None, False, mean[:4], var, gamma, beta, 1e-3)


def test_gradient_copies_counted_and_launches_zero_on_cpu():
    """A gradient summed straight off the output (expanded, not rows) is
    copied once and counted; CPU calls launch no kernel."""
    k4.reset_counts()
    block = ConvBlock(3, 8).train()
    x = torch.randn(2, 3, 8, 8).contiguous(memory_format=torch.channels_last)
    block(x, torch.float32).sum().backward()
    assert k4.GRAD_COPIES == 1
    assert all(n == 0 for n in k4.LAUNCHES.values())
    assert block.bn.running_mean.abs().sum().item() > 0  # updated


def test_profile_groups_split_k4_from_reductions_and_elementwise():
    from tpuseg_torch.utils.trace_analysis import kernel_group

    for name in ("void (anonymous namespace)::bn_reduce_kernel<__nv_bfloat16, 8, 2, false>"
                 "(__nv_bfloat16 const*, long long, ...)",
                 "void (anonymous namespace)::bn_apply_kernel<float, 1, true>(float const*)"):
        assert kernel_group(name) == "K4 batchnorm"
    assert kernel_group("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>"
                        ) == "reductions"
    assert kernel_group("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"


# ---------------------------------------------------------------------------
# the train contract: raw sums in, vectors and running statistics out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c", [2, 16])
def test_train_apply_derives_finalize_and_the_running_update(c, dtype):
    """(b) in train mode on (a)'s ``[sum a, sum a^2, n]``: its vectors are
    :func:`finalize`'s, bit for bit, its output (b)'s on them, and the
    running statistics it updates in place are bit-equal to the two-line
    update ``conv_bn`` made before (``momentum * running + (1 - momentum) *
    batch``); a constant channel clips, and its mask says so."""
    x, b, _, _, _, _ = _inputs(c, dtype, seed=40 + c)
    x[:, 1] = 0.25  # after the bias, a constant channel: its fast variance clips or is 0
    rng = np.random.default_rng(c)
    gamma, beta = (torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
                   torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)))
    rm0, rv0 = (torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)),
                torch.from_numpy(rng.uniform(0.5, 2, c).astype(np.float32)))
    stats = k4.batch_stats(x, b, True)
    n = x.shape[0] * x.shape[2] * x.shape[3]
    assert stats.shape == (3, c) and (stats[2] == n).all()
    assert torch.equal(stats[:2], k4._stats_plain(x, b, True))
    rm, rv = rm0.clone(), rv0.clone()
    y, vec = k4.bn_apply_train(x, b, True, stats, gamma, beta, 1e-3, rm, rv, 0.99)
    mean, var, unclipped, rstd, mul = k4.finalize(stats, 1e-3, gamma)
    for row, want in zip(vec, (mean, var, rstd, mul, unclipped.float())):
        assert torch.equal(row, want)
    assert torch.equal(y, k4._apply_plain(x, b, True, mean, mul, beta))
    assert torch.equal(rm, 0.99 * rm0 + (1 - 0.99) * mean)
    assert torch.equal(rv, 0.99 * rv0 + (1 - 0.99) * var)
    assert var[1] == 0
    # without running statistics nothing else changes
    y2, vec2 = k4.bn_apply_train(x, b, True, stats, gamma, beta, 1e-3)
    assert torch.equal(y2, y) and torch.equal(vec2, vec)
    # eval mode: mul from the running variance
    ye = k4.bn_apply_eval(x, b, True, rm0, rv0, gamma, beta, 1e-3)
    assert torch.equal(ye, k4._apply_plain(x, b, True, rm0, torch.rsqrt(rv0 + 1e-3) * gamma,
                                           beta))


def test_train_backward_derives_k1_k2_and_the_bias_gradient():
    """(d) in train mode: ``k1``, ``k2`` (0 where the variance clipped) and
    the bias gradient from (c)'s sums, as ``TrainBatchNorm``'s backward
    computed them eagerly before; ``totals`` stand in for the sums' first
    two rows (their all-reduce across a group)."""
    x, b, g, _, _, _ = _inputs(8, "float32", seed=50)
    x[:, 3] = -2.0  # a dead channel after the ReLU: variance 0
    rng = np.random.default_rng(5)
    gamma, beta = (torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32)),
                   torch.from_numpy(rng.normal(0, 0.3, 8).astype(np.float32)))
    stats = k4.batch_stats(x, b, True)
    _, vec = k4.bn_apply_train(x, b, True, stats, gamma, beta, 1e-3)
    sums = k4.backward_reduce(x, b, True, g, vec[0], vec[2])
    for totals in (sums, 3 * sums[:2]):
        dx, dbias = k4.backward_apply_train(x, b, True, g, stats, vec, sums, totals)
        n = stats[2]
        k1 = totals[0] / n
        k2 = torch.where(vec[4] != 0, totals[1] / n, 0.0)
        assert torch.equal(dx, k4.backward_apply(x, b, True, g, vec[0], vec[2], vec[3], k1, k2))
        assert torch.equal(dbias, vec[3] * ((sums[2] - k1 * sums[3]) - k2 * sums[4]))
    _, none = k4.backward_apply_train(x, None, True, g, stats, vec, sums[:2], sums[:2])
    assert none is None
    with pytest.raises(ValueError, match=r"\[5, 8\]"):
        k4.backward_apply_train(x, b, True, g, stats, vec, sums[:2], sums[:2])


# ---------------------------------------------------------------------------
# the packed narrow path's index arithmetic, modelled in numpy
# ---------------------------------------------------------------------------

THREADS, TILE_C, UNROLL, REDUCE_BLOCKS, MIN_ROWS, APPLY_BLOCKS = 256, 64, 4, 264, 64, 528


def _path(esize, c, lds, aligned=True):
    """batchnorm.cu's ``path_of``: 0 one element a thread, 1 a 16-byte
    vector of one row, P > 1 a 16-byte load of P whole contiguous rows."""
    vec = 16 // esize
    if not aligned:
        return 0
    if c % vec == 0:
        return 1 if all(ld % vec == 0 for ld in lds) else 0
    if c > vec or vec % c:
        return 0
    return vec // c if all(ld == c for ld in lds) else 0


def _loads(m, c, ld, esize, path, kind):
    """Every (block, thread, load, slot) of a pass over one channel tile
    (c <= 64), in each thread's order, as the kernels walk them: the
    element each slot reads (row, channel; None where the last packed load
    is masked) and the channel the kernel sums or normalizes it as."""
    vec = 16 // esize if path else 1
    pack = path if path > 1 else 1
    rows = -(-m // pack)
    tpr = -(-(vec if pack > 1 else c) // vec)
    rpi = THREADS // tpr
    if kind == "reduce":
        gx = min(max(-(-rows // MIN_ROWS), 1), REDUCE_BLOCKS)
        rpb = -(-rows // gx)
        spans = [(bx, range(bx * rpb, min(rows, (bx + 1) * rpb))) for bx in range(gx)]
    else:
        gx = max(min(-(-rows // (rpi * UNROLL)), APPLY_BLOCKS), 1)
        step = gx * UNROLL * rpi
        spans = [(bx, [r for r0 in range(bx * UNROLL * rpi, rows, step)
                       for r in range(r0, min(r0 + UNROLL * rpi, rows))]) for bx in range(gx)]
    out = []
    for bx, span in spans:
        for t in range(THREADS):
            lr, c0 = t // tpr, (0 if pack > 1 else (t % tpr) * vec)
            if lr >= rpi or c0 >= c:
                continue
            for r in span:
                if (r - span[0]) % rpi != lr:
                    continue
                valid = min(vec, (m - r * pack) * c) if pack > 1 else vec
                for j in range(vec):
                    if pack > 1:
                        e = r * vec + j  # contiguous rows: element e is row e // c
                        elt = (e // c, e % c) if j < valid else None
                        out.append((bx, t, r, j, elt, j % (vec // pack)))
                    else:
                        out.append((bx, t, r, j, (r, c0 + j), c0 + j))
    return out, pack


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("c", [1, 2, 3, 5])
@pytest.mark.parametrize("m", [1, 7, 1001, 33331])
def test_packed_narrow_path_model(m, c, dtype):
    """At C 1, 2, 3, 5 and odd M: contiguous rows narrower than 16 bytes
    take the packed path where they divide 16 bytes (bf16 C 1, 2; f32 C 1,
    2), 16 / (c * esize) rows a load; C 3 and 5, and any strided row, one
    element a thread. Every element is read once by the reductions and
    once by the elementwise passes, as its own channel, the last packed
    load masked past the tensor's end; with integer data (sums exact in any
    order) the model's per-channel sums equal (a)'s plain version, and its
    elementwise output (b)'s, bit for bit."""
    tdt = DTYPES[dtype][0]
    esize = torch.empty((), dtype=tdt).element_size()
    path = _path(esize, c, [c])
    assert (path > 1) == (c in (1, 2) or (dtype == "bfloat16" and c == 4))
    assert _path(esize, c, [c + 8]) in (0, 1) and _path(esize, c, [c], aligned=False) == 0
    rng = np.random.default_rng(m + c)
    xi = rng.integers(-6, 7, (m, c)).astype(np.float32)  # exact in bf16, sums exact in f32
    x = torch.from_numpy(xi).to(tdt).reshape(1, 1, m, c).permute(0, 3, 1, 2)
    assert k4.row_stride(x) == c
    bias = torch.from_numpy(rng.integers(-2, 3, c).astype(np.float32))
    a = np.maximum(xi + bias.numpy(), 0)
    for kind in ("reduce", "apply"):
        loads, pack = _loads(m, c, c, esize, path, kind)
        seen = np.zeros((m, c), np.int64)
        sums = np.zeros((2, c))
        for _, _, _, _, elt, ch in loads:
            if elt is None:
                continue
            assert elt[1] == ch  # the slot's channel is the element's
            seen[elt] += 1
            sums[:, ch] += (a[elt], a[elt] ** 2)
        assert (seen == 1).all(), kind
        if kind == "reduce":
            np.testing.assert_array_equal(sums, k4.batch_stats(x, bias, True)[:2].numpy())
        else:
            mean, gamma, beta = (torch.from_numpy(rng.normal(0, 1, c).astype(np.float32))
                                 for _ in range(3))
            var = torch.from_numpy(rng.uniform(0.5, 2, c).astype(np.float32))
            mul = torch.rsqrt(var + 1e-3) * gamma  # as (b) in eval mode derives it
            y = np.zeros((m, c), np.float32)
            af = a.astype(np.float32)
            for _, _, _, _, elt, ch in loads:
                if elt is not None:
                    v = (af[elt] - mean.numpy()[ch]) * mul.numpy()[ch] + beta.numpy()[ch]
                    y[elt] = _round(np.float32(v), dtype)
            want = k4.bn_apply_eval(x, bias, True, mean, var, gamma, beta, 1e-3).float()
            np.testing.assert_array_equal(y, want.permute(0, 2, 3, 1).reshape(m, c).numpy())
    masked = sum(elt is None for *_, elt, _ in _loads(m, c, c, esize, path, "apply")[0])
    vec = 16 // esize
    assert masked == ((-m * c) % vec if path > 1 else 0)


# ---------------------------------------------------------------------------
# what a train-mode conv_bn runs besides K4
# ---------------------------------------------------------------------------

PLAIN_BODIES = ("_stats_count_plain", "_apply_train_plain", "_backward_reduce_plain",
                "_backward_apply_train_plain")
# no computation: allocations and views
NO_WORK = {"empty", "empty_like", "empty_strided", "select", "slice", "alias", "view",
           "as_strided", "detach"}


def test_train_conv_bn_issues_no_op_outside_the_kernels(monkeypatch):
    """A train-mode ``conv_bn`` without a group, forward and backward, with
    every aten op recorded by a dispatch mode except those inside the plain
    versions of the four kernels (what the kernels do on the card): only
    allocations and views, no per-channel arithmetic and no copy of the
    running statistics between the launches; the running statistics move
    all the same."""
    from torch.utils._python_dispatch import TorchDispatchMode

    depth = [0]
    for name in PLAIN_BODIES:
        fn = getattr(k4, name)

        def inside(*args, _fn=fn, **kwargs):
            depth[0] += 1
            try:
                return _fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(k4, name, inside)

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not depth[0]:
                ops.append(func.__name__.split(".")[0])
            return func(*args, **(kwargs or {}))

    block = ConvBlock(3, 8).train()
    x = torch.randn(2, 3, 8, 8).contiguous(memory_format=torch.channels_last)
    h = block.conv(x).detach().requires_grad_()  # the conv output, as conv_bn takes it
    gy = torch.randn(2, 8, 8, 8).contiguous(memory_format=torch.channels_last)
    before = block.bn.running_mean.clone()
    with Record():
        y = k4.conv_bn(h, block.conv.bias, True, block.bn, 0.99)
        y.backward(gy)
    assert set(ops) <= NO_WORK, sorted(set(ops) - NO_WORK)
    assert not torch.equal(block.bn.running_mean, before)
    assert h.grad is not None and block.conv.bias.grad is not None
    assert block.bn.weight.grad is not None and block.bn.bias.grad is not None
    print("ops outside the kernels:", {op: ops.count(op) for op in sorted(set(ops))})


# ---------------------------------------------------------------------------
# (b)'s store forms for the eval walk: y into a concat buffer's channel
# slice, and the 2x2/2 max of y from the same pass
# ---------------------------------------------------------------------------

def _bits(t: torch.Tensor) -> torch.Tensor:
    """t's bit patterns, every NaN as one pattern (its payload aside)."""
    t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def _eval_case(shape, dtype, seed, nan):
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape

    def rows():
        return torch.randn(n, h, w, c, generator=g).to(dtype).permute(0, 3, 1, 2)

    x, up = rows(), rows()
    if nan:
        x[0, 0, 0, 1] = float("nan")
        x[-1, -1, -1, -1] = float("nan")
    stats = (torch.randn(c, generator=g) * 0.3, torch.rand(c, generator=g) + 0.5,
             torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.3)
    return x, up, torch.randn(c, generator=g) * 0.3, stats


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_eval_store_forms_equal_cat_and_max_pool(dtype, nan):
    """The plain versions of both forms against today's eager chain, (b),
    then ``torch.cat`` of (skip, up) and ``F.max_pool2d`` of the skip: the
    concat buffer and the pooled output bit-equal (a NaN in a window
    included), nothing written outside each slice, both outputs
    channels-last; ``FORMS`` counts them and ``LAUNCHES`` nothing (CPU)."""
    import torch.nn.functional as F

    dt = DTYPES[dtype][0]
    x, up, b, stats = _eval_case((2, 8, 6, 10), dt, 3, nan)
    y_old = k4.bn_apply_eval(x, b, True, *stats, 1e-3)
    up_old = k4.bn_apply_eval(up, None, False, *stats, 1e-3)
    want_cat, want_pool = torch.cat([y_old, up_old], 1), F.max_pool2d(y_old, 2)
    buf = torch.full((2, 16, 6, 10), 7.0, dtype=dt).contiguous(memory_format=torch.channels_last)
    k4.reset_counts()
    y, pooled = k4.bn_apply_eval(x, b, True, *stats, 1e-3, out=buf[:, :8], pool=True)
    assert (buf[:, 8:] == 7.0).all()
    got_up = k4.bn_apply_eval(up, None, False, *stats, 1e-3, out=buf[:, 8:])
    assert y.data_ptr() == buf.data_ptr() and got_up.data_ptr() == buf[:, 8:].data_ptr()
    assert k4.FORMS == {"slice": 2, "pool": 1}
    assert all(n == 0 for n in k4.LAUNCHES.values())
    assert torch.equal(_bits(buf), _bits(want_cat))
    assert torch.equal(_bits(pooled), _bits(want_pool)) and k4.row_stride(pooled) == 8
    assert bool(torch.isnan(pooled).any()) == nan
    k4.reset_counts()
    assert all(v == 0 for v in k4.FORMS.values())


def test_eval_store_forms_refused():
    x, _, b, stats = _eval_case((2, 8, 6, 10), torch.float32, 1, False)
    odd = _eval_case((2, 8, 5, 10), torch.float32, 1, False)[0]
    with pytest.raises(ValueError, match="even H and W"):
        k4.bn_apply_eval(odd, b, True, *stats, 1e-3, pool=True)
    buf = torch.empty(2, 16, 6, 10)  # NCHW: its channel slices are not rows
    with pytest.raises(ValueError, match="not rows of channels"):
        k4.bn_apply_eval(x, b, True, *stats, 1e-3, out=buf[:, :8])
    wide = buf.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="does not match"):
        k4.bn_apply_eval(x, b, True, *stats, 1e-3, out=wide[:, :4])
    with pytest.raises(ValueError, match="does not match"):
        k4.bn_apply_eval(x, b, True, *stats, 1e-3, out=wide[:, :8].to(torch.bfloat16))


@pytest.mark.parametrize("train, grad", [(False, True), (True, False)], ids=["grad", "train"])
def test_conv_bn_store_forms_only_in_eval_without_grad(train, grad):
    """The eval forms record no graph: ``conv_bn_into`` refuses them in eval
    mode with grad enabled. Train mode takes its own forms, with or without
    grad. Either way the skip and its pool equal the block's output without
    forms, and train mode updates the running statistics alike."""
    block = ConvBlock(3, 8).train(train)
    twin = copy.deepcopy(block)
    x = torch.randn(2, 3, 8, 8).contiguous(memory_format=torch.channels_last)
    buf = torch.empty(2, 16, 8, 8).contiguous(memory_format=torch.channels_last)

    def forms():
        h = torch.nn.functional.conv2d(x, block.conv.weight, padding=1)
        return k4.conv_bn_into(h, block.conv.bias, True, block.bn, 0.99, None, buf, skip=True)

    if grad:
        with pytest.raises(ValueError, match="eval applies"):
            forms()
    with torch.no_grad():
        cat, pooled = forms()
        want = twin(x, torch.float32)
    assert cat is buf
    assert torch.equal(buf[:, :8], want) and torch.equal(pooled, torch.max_pool2d(want, 2))
    assert torch.equal(block.bn.running_mean, twin.bn.running_mean)
    assert torch.equal(block.bn.running_var, twin.bn.running_var)


def _pooled_walk(y: torch.Tensor, w: int) -> torch.Tensor:
    """The kernel's pooled walk over y's rows ``[M = N*H*W, C]``: pooled pixel
    p takes rows ``top = 2 * ((p // (w/2)) * w + p % (w/2))``, ``top + 1``,
    ``top + w``, ``top + w + 1`` in that order, and keeps ``v`` where ``v >
    max`` or ``v`` is NaN, from ``-inf`` (csrc/batchnorm.cu, ``window_row``)."""
    p = torch.arange(y.shape[0] // 4)
    top = 2 * ((p // (w // 2)) * w + p % (w // 2))
    mx = torch.full((p.numel(), y.shape[1]), float("-inf"), dtype=y.dtype)
    for r in (top, top + 1, top + w, top + w + 1):
        v = y[r]
        mx = torch.where((v > mx) | torch.isnan(v), v, mx)
    return mx


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 3, 2, 2), (2, 5, 6, 10), (3, 2, 16, 4), (1, 1, 8, 32)])
def test_pooled_walk_model_equals_max_pool(shape, dtype):
    """A model of the pooled form's window walk and max rule equals
    ``F.max_pool2d`` bit for bit, with NaN, infinities and ties in the
    windows, and each row is read by exactly one window."""
    import torch.nn.functional as F

    n, c, h, w = shape
    dt = DTYPES[dtype][0]
    g = torch.Generator().manual_seed(sum(shape))
    y = torch.randn(n, h, w, c, generator=g).round().to(dt)  # ties
    flat = y.view(-1)
    picks = torch.randperm(flat.numel(), generator=g)[:4]
    flat[picks[0]], flat[picks[1]] = float("nan"), float("inf")
    flat[picks[2]], flat[picks[3]] = float("-inf"), float("nan")
    rows = y.reshape(-1, c)
    got = _pooled_walk(rows, w)
    want = F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).reshape(-1, c)
    assert torch.equal(_bits(got), _bits(want))
    p = torch.arange(rows.shape[0] // 4)
    top = 2 * ((p // (w // 2)) * w + p % (w // 2))
    read = torch.cat([top, top + 1, top + w, top + w + 1]).sort().values
    assert torch.equal(read, torch.arange(rows.shape[0]))


# ---------------------------------------------------------------------------
# the train forms: (b)'s store forms in train mode, and the pooled (c) and
# (d), which take the pool's gradient inside K4's backward
# ---------------------------------------------------------------------------

def _train_case(shape, dtype, seed, nan):
    """x (with NaNs in a few windows if ``nan``, after the statistics), a
    deconv half, (a)'s sums and (b)'s train vectors, gamma and beta, the
    concat buffer's gradient (rows of stride 2C, some -0) and the pooled
    output's gradient."""
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape

    def rows(ch=c, hh=h, ww=w):
        return torch.randn(n, hh, ww, ch, generator=g).to(dtype).permute(0, 3, 1, 2)

    x, up, b = rows(), rows(), torch.randn(c, generator=g) * 0.3
    gamma, beta = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.3
    stats = k4.batch_stats(x, b, True)
    y, vec = k4.bn_apply_train(x, b, True, stats, gamma, beta, 1e-3)
    if nan:
        x[0, 0, 0, 1] = float("nan")
        x[-1, -1, -1, -1] = float("nan")
        x[0, 1, 2, 2] = x[0, 1, 3, 3] = float("nan")  # two NaNs in one window
    gcat, gp = rows(2 * c), rows(c, h // 2, w // 2)
    gcat[gcat.abs() < 0.05] = -0.0
    return x, up, b, gamma, beta, stats, vec, gcat, gp


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pooled_backward_equals_max_pool_and_cat_autograd(dtype, nan):
    """The plain pooled (c) and (d), on the concat gradient's first half and
    the pooled gradient, against autograd through ``torch.cat`` of (skip,
    up) and ``F.max_pool2d`` of the skip, whose two gradients autograd adds:
    the sums and ``(dx, dbias)`` bit-equal, with ties in the windows (the
    ReLU clamps to 0), -0 in the gradient and NaN windows (one NaN among
    finite values, and two); ``TRAIN_FORMS`` counts the pooled backward."""
    import torch.nn.functional as F

    dt = DTYPES[dtype][0]
    x, up, b, gamma, beta, stats, vec, gcat, gp = _train_case((2, 8, 6, 10), dt, 4, nan)
    c = x.shape[1]
    y = k4._apply_plain(x, b, True, vec[0], vec[3], beta).requires_grad_()
    torch.autograd.backward([torch.cat([y, up], 1), F.max_pool2d(y, 2)], [gcat, gp])
    want_sums = k4.backward_reduce(x, b, True, y.grad, vec[0], vec[2])
    want = k4.backward_apply_train(x, b, True, y.grad, stats, vec, want_sums, want_sums)
    k4.reset_counts()
    sums = k4.backward_reduce(x, b, True, gcat[:, :c], vec[0], vec[2], vec[3], beta, gp=gp)
    got = k4.backward_apply_train(x, b, True, gcat[:, :c], stats, vec, sums, sums, beta, gp=gp)
    assert k4.TRAIN_FORMS == {"slice": 0, "pool": 0, "pooled_backward": 1}
    for a, b in ((sums, want_sums), *zip(got, want)):
        assert torch.equal(_bits(a), _bits(b))
    windows = y.detach().unfold(2, 2, 2).unfold(3, 2, 2).flatten(-2)
    assert ((windows == windows.amax(-1, keepdim=True)).sum(-1) > 1).any()
    assert torch.isnan(windows).any(-1).sum() == (3 if nan else 0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_train_level_forms_equal_cat_and_pool(dtype):
    """One U-Net level in train mode through ``conv_bn_into`` (the skip's
    block into the first half of the concat buffer with its pool, the
    deconv's into the second half) against ``conv_bn`` + ``torch.cat`` +
    ``F.max_pool2d``: both outputs, every input and parameter gradient and
    the running statistics bit-equal; 2 slices, 1 pool and 1 pooled
    backward; the buffer comes back as it went in."""
    import torch.nn.functional as F

    dt = DTYPES[dtype][0]
    g = torch.Generator().manual_seed(6)
    skip_bn, up_bn = torch.nn.BatchNorm2d(8), torch.nn.BatchNorm2d(8)

    def run(forms):
        torch.manual_seed(0)
        s_bn, u_bn = copy.deepcopy(skip_bn), copy.deepcopy(up_bn)
        h = torch.randn(2, 6, 10, 8, generator=torch.Generator().manual_seed(1)).to(dt)
        h = h.permute(0, 3, 1, 2).requires_grad_()
        u = (torch.randn(2, 6, 10, 8, generator=torch.Generator().manual_seed(2)).to(dt)
             .permute(0, 3, 1, 2).requires_grad_())
        bias = torch.zeros(8, requires_grad=True)
        if forms:
            buf = torch.empty(2, 16, 6, 10, dtype=dt).contiguous(memory_format=torch.channels_last)
            cat, pooled = k4.conv_bn_into(h, bias, True, s_bn, 0.99, None, buf, skip=True)
            out = k4.conv_bn_into(u, None, False, u_bn, 0.99, None, cat, skip=False)
            assert cat is buf and out is buf
        else:
            y = k4.conv_bn(h, bias, True, s_bn, 0.99)
            out = torch.cat([y, k4.conv_bn(u, None, False, u_bn, 0.99)], 1)
            pooled = F.max_pool2d(y, 2)
        r = torch.Generator().manual_seed(3)
        torch.autograd.backward([out, pooled], [torch.randn(out.shape, generator=r).to(dt),
                                                torch.randn(pooled.shape, generator=r).to(dt)])
        return [out.detach(), pooled.detach(), h.grad, u.grad, bias.grad,
                *(p.grad for m in (s_bn, u_bn) for p in m.parameters()),
                *(t for m in (s_bn, u_bn) for t in (m.running_mean, m.running_var))]

    for t in (skip_bn, up_bn):
        t.weight.data.uniform_(0.5, 1.5, generator=g)
        t.bias.data.normal_(0, 0.3, generator=g)
    k4.reset_counts()
    got = run(True)
    assert k4.TRAIN_FORMS == {"slice": 2, "pool": 1, "pooled_backward": 1}
    want = run(False)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


def test_train_forms_refused():
    x, _, b, gamma, beta, stats, vec, gcat, gp = _train_case((2, 8, 6, 10), torch.float32, 1,
                                                            False)
    g, sums = gcat[:, :8], k4.backward_reduce(x, b, True, gcat[:, :8], vec[0], vec[2])
    with pytest.raises(ValueError, match="needs \\['mul', 'beta'\\]"):
        k4.backward_reduce(x, b, True, g, vec[0], vec[2], gp=gp)
    with pytest.raises(ValueError, match="needs \\['beta'\\]"):
        k4.backward_apply_train(x, b, True, g, stats, vec, sums, sums, gp=gp)
    with pytest.raises(ValueError, match="not the pooled output's gradient"):
        k4.backward_apply_train(x, b, True, g, stats, vec, sums, sums, beta, gp=gp[:, :4])
    with pytest.raises(ValueError, match="not rows of channels"):
        k4.backward_apply_train(x, b, True, g, stats, vec, sums, sums, beta,
                                gp=gp.contiguous())
    odd = x[:, :, :5].contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="even H and W"):
        k4.bn_apply_train(odd, b, True, stats, gamma, beta, 1e-3, pool=True)
    with pytest.raises(ValueError, match="no store forms"):
        k4.bn_apply_train(x, None, k4.RELU_AFTER, stats, gamma, beta, 1e-3, pool=True)
    with pytest.raises(ValueError, match="no store forms"):
        k4.backward_reduce(x, None, k4.RELU_AFTER, g, vec[0], vec[2], vec[3], beta, gp=gp)
    with pytest.raises(ValueError, match="takes a bias"):
        k4.backward_reduce(x, None, k4.RELU_BEFORE, g, vec[0], vec[2], vec[3], beta, gp=gp)
