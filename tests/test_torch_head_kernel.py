"""K2, the blocked head + per-phase argmax + depth-to-space, and K6, the
dense head + argmax.

On the CPU the port's ``blocked_head_argmax`` runs its plain PyTorch
version; it is held against the JAX package's Pallas kernel
(``_head_pallas``, interpret mode on the CPU) and against a numpy
evaluation (tests/test_quant.py's). ``dense_head_argmax`` runs its plain
version, held against a numpy evaluation of the JAX package's dense head
(``tpuseg/infer/quant.py:548-559``) and ``predict``'s argmax. The CUDA kernel itself is held against
the plain version on the card by tests/test_torch_cuda.py and by
chip_smoke.py.

Tolerances: the int8 head sums int8 x int8 products exactly, so its labels
must be bit-equal. The fp head computes the same f32 products but sums
them in another order than XLA, so a genuine argmax near-tie may flip:
labels must agree on at least 0.999 of pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.infer import head_kernel as jax_head
from tpuseg_torch.infer import head_kernel
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


def _inputs(ncls, fp, seed, b=2, h=6, w=10, c4=16):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, h, w, c4)).astype(np.int8)
    sv = rng.uniform(0.01, 0.1, (c4,)).astype(np.float32)
    if fp:
        wt = rng.normal(0, 0.3, (4 * ncls, c4)).astype(np.float32)
        epi = rng.normal(0, 1, (4, 4 * ncls)).astype(np.float32)
        epi[3] = 1.0
    else:
        wt = rng.integers(-127, 128, (4 * ncls, c4)).astype(np.int8)
        epi = rng.normal(0, 1, (4, 4 * ncls)).astype(np.float32)
        epi[3] = rng.uniform(1e-4, 1e-3, 4 * ncls)
    return x, sv, wt, epi


def _numpy_head(x, sv, wt, epi, ncls, fp):
    b, h, w, _ = x.shape
    if fp:
        y = (x.astype(np.float32) * sv) @ wt.T.astype(np.float32)
    else:
        y = (x.astype(np.int64) @ wt.T.astype(np.int64)).astype(np.float32) * epi[3]
    y = np.maximum(y + epi[0], 0.0) * epi[1] + epi[2]
    lbl = np.argmax(y.reshape(b, h, w, 4, ncls), axis=-1)  # [b,h,w,4]
    dense = lbl.reshape(b, h, w, 2, 2).transpose(0, 1, 3, 2, 4)
    return dense.reshape(b, 2 * h, 2 * w).astype(np.int32)


def _port(x, sv, wt, epi, ncls, fp):
    return head_kernel.blocked_head_argmax(
        torch.from_numpy(x), sv, torch.from_numpy(wt), epi, ncls, fp=fp).numpy()


@pytest.mark.parametrize("fp", [True, False])
@pytest.mark.parametrize("ncls", [2, 3, 5])
def test_plain_matches_pallas_kernel(ncls, fp):
    x, sv, wt, epi = _inputs(ncls, fp, seed=ncls)
    want = np.asarray(jax_head._head_pallas(
        jnp.asarray(x), sv, jnp.asarray(wt), epi, ncls, fp))
    got = _port(x, sv, wt, epi, ncls, fp)
    assert got.shape == want.shape == (2, 12, 20) and got.dtype == np.int32
    if fp:
        assert (got == want).mean() >= 0.999
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fp", [True, False])
@pytest.mark.parametrize("ncls", [2, 3, 5])
def test_plain_matches_numpy(ncls, fp):
    x, sv, wt, epi = _inputs(ncls, fp, seed=10 + ncls)
    got = _port(x, sv, wt, epi, ncls, fp)
    want = _numpy_head(x, sv, wt, epi, ncls, fp)
    if fp:
        assert (got == want).mean() >= 0.999
    else:
        np.testing.assert_array_equal(got, want)


def test_cpu_path_launches_no_kernel():
    """A CPU tensor takes the plain version and leaves the launch count."""
    before = head_kernel.LAUNCHES
    x, sv, wt, epi = _inputs(2, True, seed=0)
    _port(x, sv, wt, epi, 2, True)
    assert head_kernel.LAUNCHES == before


def test_sv_none_means_ones():
    """An fp edge into the head (sv=None) dequantizes with unit scales."""
    x, _, wt, epi = _inputs(2, True, seed=4)
    xf = torch.from_numpy(x.astype(np.float32))
    got = head_kernel.blocked_head_argmax(xf, None, torch.from_numpy(wt), epi, 2, fp=True)
    want = _numpy_head(x, np.ones(16, np.float32), wt, epi, 2, True)
    assert (got.numpy() == want).mean() >= 0.999


@pytest.mark.parametrize("xdtype, wtdtype, fp, route", [
    (torch.int8, torch.bfloat16, True, "mma"),      # the served fp head
    (torch.int8, torch.int8, False, "mma"),         # the int8 head
    (torch.bfloat16, torch.bfloat16, True, "general"),  # fp edge into the head
    (torch.float32, torch.bfloat16, True, "general"),
    (torch.int8, torch.float32, True, "general"),   # f32 weight
    (torch.float32, torch.float32, True, "general"),
])
def test_kernel_route_choice(xdtype, wtdtype, fp, route):
    assert head_kernel.kernel_route(xdtype, wtdtype, fp) == route


def test_other_devices_raise():
    x, sv, wt, epi = _inputs(2, True, seed=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        head_kernel.blocked_head_argmax(torch.from_numpy(x).to("meta"), sv,
                                        torch.from_numpy(wt), epi, 2, fp=True)


# --- K6: the dense head + argmax ---------------------------------------------

def _dense_inputs(ncls, fp, seed, b=2, h=7, w=9, c=32):
    """int8 codes, scales, a [ncls, C] weight (bf16-valued for the fp head,
    as served) and epilogue rows; B*H*W is odd."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, h, w, c)).astype(np.int8)
    sv = rng.uniform(0.01, 0.1, (c,)).astype(np.float32)
    epi = rng.normal(0, 1, (4, ncls)).astype(np.float32)
    if fp:
        wt = _bf16(rng.normal(0, 0.3, (ncls, c)).astype(np.float32))
        epi[3] = 1.0
    else:
        wt = rng.integers(-127, 128, (ncls, c)).astype(np.int8)
        epi[3] = rng.uniform(1e-4, 1e-3, ncls)
    return x, sv, wt, epi


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _numpy_dense_head(x, sv, wt, epi, fp):
    """tpuseg/infer/quant.py:548-559 for the head, then argmax: the fp head
    dequantizes to bf16 and sums bf16 x bf16 products in f32; the int8 head
    sums int8 x int8 exactly and scales by wscale."""
    if fp:
        y = _bf16(x.astype(np.float32) * sv) @ wt.T.astype(np.float32)
    else:
        y = (x.astype(np.int64) @ wt.T.astype(np.int64)).astype(np.float32) * epi[3]
    y = np.maximum(y + epi[0], 0.0) * epi[1] + epi[2]
    return np.argmax(y, axis=-1).astype(np.int32)


def _port_dense(x, sv, wt, epi, ncls, fp):
    wt_t = torch.from_numpy(wt)
    return head_kernel.dense_head_argmax(
        torch.from_numpy(x), torch.from_numpy(sv), wt_t.to(torch.bfloat16) if fp else wt_t,
        torch.from_numpy(epi), ncls, fp=fp).numpy()


@pytest.mark.parametrize("fp", [True, False])
@pytest.mark.parametrize("ncls", [1, 2, 3, 5])
def test_dense_plain_matches_numpy(ncls, fp):
    x, sv, wt, epi = _dense_inputs(ncls, fp, seed=30 + ncls)
    got = _port_dense(x, sv, wt, epi, ncls, fp)
    want = _numpy_dense_head(x, sv, wt, epi, fp)
    assert got.shape == want.shape == (2, 7, 9) and got.dtype == np.int32
    if fp:
        assert (got == want).mean() >= 0.999
    else:
        np.testing.assert_array_equal(got, want)


def test_dense_cpu_path_launches_no_kernel():
    before = head_kernel.DENSE_LAUNCHES, head_kernel.LAUNCHES
    x, sv, wt, epi = _dense_inputs(2, True, seed=0)
    _port_dense(x, sv, wt, epi, 2, True)
    assert (head_kernel.DENSE_LAUNCHES, head_kernel.LAUNCHES) == before


@pytest.mark.parametrize("ncls, c, eligible", [(2, 64, True), (8, 16, True), (9, 64, False),
                                                (2, 4, False), (2, 24, False)])
def test_dense_head_eligible(ncls, c, eligible):
    assert head_kernel.dense_head_eligible(ncls, c) == eligible


@pytest.mark.parametrize("change, match", [
    (dict(c=24), "C % 16"),
    (dict(ncls=9), "1..8 classes"),
    (dict(wt_dtype=torch.float32, fp=False), "int8 dense head"),
    (dict(wt_shape=(3, 32)), "shapes"),
    (dict(device="meta"), "cuda or cpu"),
])
def test_dense_contract_raises(change, match):
    """The contract holds on the CPU too, so a wiring fault shows here."""
    ncls, fp, c = change.get("ncls", 2), change.get("fp", True), change.get("c", 32)
    x, sv, wt, epi = (torch.from_numpy(a) for a in
                      _dense_inputs(min(ncls, 8), True, seed=1, c=c))
    if ncls > 8:
        wt, epi = wt.repeat(2, 1)[:ncls], epi.repeat(1, 2)[:, :ncls]
    wt = wt.to(change.get("wt_dtype", torch.bfloat16))
    if "wt_shape" in change:
        wt = torch.zeros(change["wt_shape"], dtype=wt.dtype)
    if "device" in change:
        x, sv, wt, epi = (t.to(change["device"]) for t in (x, sv, wt, epi))
    with pytest.raises((ValueError, TypeError), match=match):
        head_kernel.dense_head_argmax(x, sv, wt, epi, ncls, fp=fp)


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::dense_head_mma_kernel<true, 1, true>(signed char const*)",
     "K6 dense_head_argmax"),
    ("void (anonymous namespace)::dense_head_fp_kernel<2>(signed char const*)",
     "K6 dense_head_argmax"),
    ("void (anonymous namespace)::head_mma_kernel<true, 1, true>(signed char const*)",
     "K2 head_argmax"),
    ("void (anonymous namespace)::head_fp_kernel<float, 4>(float const*)", "K2 head_argmax"),
])
def test_trace_groups_tell_k6_from_k2(name, group):
    """K6's device kernels have names of their own, so a profile groups them
    apart from K2's (whose names they contain)."""
    from tpuseg_torch.utils.trace_analysis import kernel_group

    assert kernel_group(name) == group
