"""The port's U-Net against the flax U-Net, through the weight bridge.

Same random weights and inputs (numpy seeds; BN statistics jittered through
crc32 as tests/test_quant.py does) go through ``tpuseg.models.unet.UNet``
and ``tpuseg_torch.models.unet.UNet`` in float32 on the CPU; eval-mode
logits must agree to 2e-4 (the f32 conv sum order differs between XLA and
PyTorch's CPU kernels)."""

import copy
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.models.unet import UNet as JaxUNet
from tpuseg.models.unet import init_variables
from tpuseg_torch.models.unet import UNet, init_unet
from tpuseg_torch.utils.jax_bridge import flax_to_state_dict, unet_from_flax
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


def jax_model_and_vars(impl="conv_transpose", feats=4, ncls=2, channels=1):
    """A flax U-Net in f32 with numpy variables and jittered BN stats."""
    model = JaxUNet(num_classes=ncls, base_features=feats, dtype=jnp.float32,
                    deconv_impl=impl)
    variables = init_variables(model, jax.random.PRNGKey(0), num_channels=channels)

    def jitter(path, x):
        name = "/".join(str(p.key) for p in path)
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        if name.endswith("mean"):
            return rng.normal(0, 0.3, x.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(jitter, variables["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return model, {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("impl", ["conv_transpose", "pixel_shuffle"])
def test_eval_logits_match_flax(impl):
    model, variables = jax_model_and_vars(impl)
    x = np.random.default_rng(1).normal(0, 1, (2, 48, 32, 1)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    port = unet_from_flax(variables, 2, 1, 4, torch.float32, impl)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 48, 32, 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_bridge_covers_every_parameter():
    """The bridge fills every entry of the port's state_dict with the shape
    the port expects (nothing left at its init value)."""
    _, variables = jax_model_and_vars(feats=4, ncls=3, channels=2)
    sd = flax_to_state_dict(variables)
    ref = UNet(3, 2, 4).state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_bf16_forward_tracks_f32():
    """dtype=bfloat16 runs the same network: bf16 logits stay close to the
    f32 ones (bf16 keeps ~3 significant digits per layer)."""
    torch.manual_seed(0)
    model = init_unet(UNet(2, 1, 4, torch.float32), torch.Generator().manual_seed(3)).eval()
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (1, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        f32 = model(x)
        model.dtype = torch.bfloat16
        bf16 = model(x)
    assert bf16.dtype == torch.float32
    assert torch.corrcoef(torch.stack([f32.flatten(), bf16.flatten()]))[0, 1] > 0.99


def test_rejects_non_multiple_of_16():
    with pytest.raises(ValueError, match="multiples of 16"):
        UNet(2, 1, 4)(torch.zeros(1, 40, 32, 1))


def test_probabilities_and_apply_nchw_match_flax():
    """The reference-contract softmax outputs: ``UNet.probabilities`` (NHWC)
    and ``apply_nchw`` (NCHW in, NHWC out), against tpuseg's, within the
    logits' tolerance."""
    from tpuseg.models.unet import apply_nchw as jax_apply_nchw
    from tpuseg_torch.models.unet import apply_nchw

    model, variables = jax_model_and_vars(feats=4, ncls=3, channels=2)
    port = unet_from_flax(variables, 3, 2, 4, torch.float32)
    x = np.random.default_rng(3).normal(0, 1, (2, 32, 48, 2)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False,
                                  method=JaxUNet.probabilities))
    nchw = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    want_nchw = np.asarray(jax_apply_nchw(model, variables, jnp.asarray(nchw), train=False))
    with torch.no_grad():
        got = port.probabilities(torch.from_numpy(x)).numpy()
        got_nchw = apply_nchw(port, torch.from_numpy(nchw)).numpy()
    assert got.shape == got_nchw.shape == want.shape == (2, 32, 48, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_nchw, want_nchw, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


def _eval_model(dtype, impl="conv_transpose"):
    """A base-4 U-Net in eval mode with jittered running statistics."""
    g = torch.Generator().manual_seed(5)
    model = init_unet(UNet(2, 1, 4, dtype, impl), g).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.3, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.bias.normal_(0, 0.3, generator=g)
    return model


@pytest.mark.parametrize("impl", ["conv_transpose", "pixel_shuffle"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_eval_store_forms_logits_bit_equal(dtype, impl):
    """An eval forward without grad takes K4's store forms (8 slices: each
    skip and each deconv half into its concat buffer; 4 pooled: the
    encoder's skips) and gives the same logits, bit for bit, as the
    forward with grad enabled, which keeps ``torch.cat`` and the pool."""
    from tpuseg_torch.ops import batchnorm as k4

    model = _eval_model(dtype, impl)
    x = torch.randn(2, 48, 32, 1, generator=torch.Generator().manual_seed(6))
    k4.reset_counts()
    with torch.inference_mode():
        inference = model(x)
    assert k4.FORMS == {"slice": 8, "pool": 4}
    k4.reset_counts()
    with torch.no_grad():
        no_grad = model(x)
    assert k4.FORMS == {"slice": 8, "pool": 4}
    k4.reset_counts()
    grad = model(x)
    assert k4.FORMS == {"slice": 0, "pool": 0} and grad.requires_grad
    assert torch.equal(inference, grad.detach()) and torch.equal(no_grad, grad.detach())


class _OneRankHalo:
    """A spatial group of one rank: zero rows above and below, no gather."""
    size, rank = 1, 0

    def __call__(self, x):
        return torch.nn.functional.pad(x, (0, 0, 1, 1))

    def gather(self, x):
        return x


@pytest.mark.parametrize("path", ["train", "halo", "avg_pool"])
def test_store_forms_off_in_train_mode_and_the_spatial_walk(path, monkeypatch):
    """Train mode takes the train forms at levels 1-3 (``TRAIN_FORMS``: 6
    slices and 3 pools a forward, 3 pooled backwards a backward), never the
    eval ones (``FORMS`` stays at 0); the spatial walk and a model whose pool
    was swapped for another keep today's concat and pool, also without
    grad, and take no form; the one-rank spatial walk gives the plain walk's
    logits."""
    from tpuseg_torch.models import unet
    from tpuseg_torch.ops import batchnorm as k4

    model = _eval_model(torch.float32)
    x = torch.randn(2, 32, 32, 1, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want = model(x)
        if path == "train":
            model.train()
            model.dropout_rate = 0.0
        elif path == "halo":
            model.halo = _OneRankHalo()
        else:
            monkeypatch.setattr(unet, "_pool", lambda t: torch.nn.functional.avg_pool2d(t, 2))
        k4.reset_counts()
        got = model(x)
    if path == "train":  # and a train step's forward and backward
        model(x).sum().backward()
        assert k4.TRAIN_FORMS == {"slice": 12, "pool": 6, "pooled_backward": 3}
    else:
        assert all(v == 0 for v in k4.TRAIN_FORMS.values())
    assert k4.FORMS == {"slice": 0, "pool": 0}
    if path == "halo":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    else:
        assert got.shape == want.shape and torch.isfinite(got).all()


def _bits(t: torch.Tensor) -> torch.Tensor:
    """t's bit patterns, every NaN as one pattern (its payload aside)."""
    t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t).reshape(-1)
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("impl", ["conv_transpose", "pixel_shuffle"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_train_store_forms_step_bit_equal(dtype, impl, monkeypatch):
    """A train step with dropout on through K4's train store forms (levels
    1-3: 6 slices and 3 pooled applies forward, 3 pooled backwards) equals,
    bit for bit, the same step of a copy of the model whose pool is swapped
    for a wrapper of ``F.max_pool2d``, which turns the forms off (the
    concat, the pool and autograd's add of each skip's two gradients):
    logits, loss, every parameter's gradient and the running statistics.
    Many of enc1b's pool windows hold ties (the ReLU clamps to 0, so their
    y are equal), which the argmax must break as the pool does."""
    import torch.nn.functional as F

    from tpuseg_torch.models import unet
    from tpuseg_torch.ops import batchnorm as k4
    from tpuseg_torch.ops.losses import cce_from_logits, reference_scalar_loss

    forms = _eval_model(dtype, impl).train()
    swapped = copy.deepcopy(forms)
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 32, 48, 1, generator=g)
    labels = F.one_hot((torch.rand(2, 32, 48, generator=g) > 0.5).long(), 2).float()

    def step(model):
        k4.reset_counts()
        logits = model(x, generator=torch.Generator().manual_seed(9))
        loss = reference_scalar_loss(cce_from_logits(logits, labels), x.shape[0])
        loss.backward()
        return logits.detach(), loss.detach()

    got = step(forms)
    assert k4.TRAIN_FORMS == {"slice": 6, "pool": 3, "pooled_backward": 3}
    assert k4.FORMS == {"slice": 0, "pool": 0}
    skip = []
    swapped.enc1b.register_forward_hook(lambda mod, args, out: skip.append(out.detach()))
    monkeypatch.setattr(unet, "_pool", lambda t: F.max_pool2d(t, 2))
    want = step(swapped)
    assert all(v == 0 for v in k4.TRAIN_FORMS.values())
    windows = skip[0].unfold(2, 2, 2).unfold(3, 2, 2).flatten(-2)
    ties = (windows == windows.amax(-1, keepdim=True)).sum(-1) > 1
    assert ties.float().mean() > 0.05
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    for (name, p), q in zip(forms.named_parameters(), swapped.parameters()):
        assert torch.equal(_bits(p.grad), _bits(q.grad)), name
    for (name, b), c in zip(forms.named_buffers(), swapped.buffers()):
        assert torch.equal(b, c), name
