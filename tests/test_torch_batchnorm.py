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
    got = k4.batch_stats(x, b, relu).double().numpy()
    for k, terms in enumerate((a, a * a)):
        assert np.all(np.abs(got[k] - terms.sum(0)) <= _sum_bound(terms)), k

    # (b) within one rounding of the dtype (plus the f32 steps before it)
    y = _rows(k4.bn_apply(x, b, relu, v["mean"], v["mul"], v["beta"]))
    want = (a - v["mean"].double().numpy()) * v["mul"].double().numpy() + v["beta"].double().numpy()
    assert np.all(np.abs(y - want) <= ulp * np.abs(want) + 1e-6)

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
    mean, mul, beta = torch.zeros(8), torch.ones(8), torch.zeros(8)
    want = k4.bn_apply(part.contiguous(memory_format=torch.channels_last), None, False, mean,
                       mul, beta)
    assert torch.equal(k4.bn_apply(part, None, False, mean, mul, beta), want)
    with pytest.raises(ValueError, match="not rows of channels"):
        k4.bn_apply(torch.randn(2, 8, 3, 5), None, False, mean, mul, beta)
    with pytest.raises(ValueError, match="float32"):
        k4.bn_apply(x, None, False, mean[:4], mul, beta)


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
