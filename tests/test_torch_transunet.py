"""TransUNet R50-ViT-B/16 (tpuseg_torch/models/transunet.py) on the CPU, at a
tiny size that keeps every part of the graph: width 32, one unit a block,
hidden 64, 2 layers of 4 heads, MLP 128, 64^2 tiles (block 1's 15^2 output
still takes the source's pad to 16^2).

- the program against the plain float32 reference of the benchmark
  (``benchmark/reference/transunet.py``, which imports nothing of the
  program): the eval forward's logits, and one train step's loss and every
  leaf's gradient, with the augmentation and dropout masks drawn alike;
- K4's order after (BatchNorm, then ReLU): its plain versions through
  ``conv_bn`` against autograd through ``F.batch_norm`` and ``relu``, train
  and eval;
- the training path: ``train_model`` with ``model="transunet_r50_b16"``
  writes a checkpoint that reloads as a TransUNet and resumes; a U-Net
  checkpoint without the kind still loads; ``--spatial 2`` is refused; the
  CLI takes ``--model``;
- the model's spans and counters.

The card's checks (K4's order after bit for bit, the flash path) are in
``tests/test_torch_cuda_transunet.py``."""

import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuseg_torch.models import transunet as tu
from tpuseg_torch.models.transunet import TransUNet
from tpuseg_torch.ops import batchnorm as k4
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import transunet_weights  # noqa: E402
from reference import train_transunet as ref_train  # noqa: E402
from reference import transunet as ref  # noqa: E402
from work import transunet as work  # noqa: E402

TINY = dict(width=32, block_units=(1, 1, 1), hidden=64, num_layers=2, num_heads=4, mlp_dim=128)
AUGMENT = {"reflection": True, "rotation": True, "jitter_severity": 0.1, "noise_severity": 0.02,
           "scale_severity": 0.1, "blur_max_sigma": 2.0, "intensity_severity": 0.0}


def tiny_cfg():
    """The configuration file's TransUNet cut to the tiny size."""
    with open(os.path.join(BENCH, "configs", "transunet-r50-b16.json")) as f:
        cfg = json.load(f)
    cfg.update(img_size=64, hidden_size=64)
    cfg["resnet"] = {"num_layers": [1, 1, 1], "width_factor": 0.5}
    cfg["transformer"] = dict(cfg["transformer"], num_layers=2, num_heads=4, mlp_dim=128)
    return cfg


def model_and_weights(seed=5, dtype="float32"):
    cfg = tiny_cfg()
    w = transunet_weights.make(cfg, seed, torch.device("cpu"))
    g = torch.Generator().manual_seed(seed + 1)
    for k in w:  # running statistics away from 0 and 1, so eval BatchNorm does something
        if k.endswith("running_mean"):
            w[k] = torch.randn(w[k].shape, generator=g) * 0.3
        elif k.endswith("running_var"):
            w[k] = torch.rand(w[k].shape, generator=g) + 0.5
    model = tu.TransUNet(**work.widths(cfg), dtype=dtype)
    missing, unexpected = model.load_state_dict(w, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return cfg, model, w


def test_the_inventory_is_the_models_state_dict():
    cfg, model, w = model_and_weights()
    sd = {k: tuple(v.shape) for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    assert sd == {p["name"]: tuple(p["shape"]) for p in work.params(cfg)}
    assert sd == {k: tuple(v.shape) for k, v in w.items()}
    full = tu.TransUNet()
    assert sum(p.numel() for p in full.parameters()) == 105911970


def test_eval_forward_matches_the_reference():
    """Logits within 1e-5 of their largest: float32 round-off of the convs'
    and GEMMs' other summation orders (the program sums the root conv's
    weight over the repeated channel, casts its parameters in one tensor
    and fuses q, k and v; measured ~3e-7)."""
    cfg, model, w = model_and_weights()
    x = torch.randn(3, 64, 64, 1, generator=torch.Generator().manual_seed(0))
    model.eval()
    with torch.no_grad():
        got = model(x)
    want = ref.forward(w, x, cfg)
    assert got.shape == (3, 64, 64, 2) and got.dtype == torch.float32
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _raw_batch():
    g = torch.Generator().manual_seed(3)
    img = (torch.rand((4, 64, 64, 1), generator=g) * 3000 + 500).to(torch.int32)
    msk = (torch.rand((4, 64, 64), generator=g) > 0.5).to(torch.uint8)
    return img, msk


def _program_step(model, img, msk):
    """One raw train step of ``model`` (augmentation from seed 11, dropout
    from seed 12): its loss and each leaf's gradient."""
    from tpuseg_torch.aug.device import DeviceAugmentParams
    from tpuseg_torch.train.steps import KerasAdam, TrainState, make_raw_steps

    state = TrainState(model, KerasAdam(model.parameters(), lr=3e-4),
                       torch.Generator().manual_seed(11), torch.Generator().manual_seed(12))
    step, _ = make_raw_steps(2, DeviceAugmentParams(**AUGMENT))
    loss = float(step(state, img, msk)["loss"])
    return loss, {n: p.grad.double() for n, p in model.named_parameters()}


def _reference64(cfg, w, img, msk):
    """The reference's step in float64 throughout (its augmentation in
    float32, as the program's): the loss and each leaf's gradient."""
    from reference import augment
    from reference.train import loss_fn

    x, y = augment.augment(torch.Generator().manual_seed(11), img, msk, AUGMENT, 2)
    leaves = {k: v.double().requires_grad_(True) for k, v in w.items() if "running" not in k}
    params = dict({k: v.double() for k, v in w.items()}, **leaves)
    logits = ref.forward(params, x.double(), cfg, train=True,
                         g_drop=torch.Generator().manual_seed(12), dtype=torch.float64)
    loss = torch.mean(torch.sum(-torch.sum(y.double() * torch.log_softmax(logits, -1), -1), 0)
                      / x.shape[0])
    assert abs(float(loss) - float(loss_fn(logits.float(), y))) <= 1e-6
    return float(loss), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _leaf_gaps(got, want):
    """Each leaf's norm of the gradient's gap over the larger of its norm and
    the median leaf's (a leaf whose gradient is zero in exact arithmetic,
    the attention's key biases, reads round-off at the median's scale)."""
    median = float(np.median([float(g.norm()) for g in want.values()]))
    assert set(got) == set(want)
    return {k: float((got[k] - want[k].double()).norm()) / max(float(want[k].norm()), median)
            for k in want}


def test_one_train_step_matches_the_reference():
    """The raw train step (augmentation, z-score, forward with dropout,
    loss, backward) against the plain reference's on the same batch, the
    generators seeded alike.

    In float32, the loss within 1e-5 (measured equal) and each leaf's
    gradient within 3e-2 (:func:`_leaf_gaps`): at this tiny size a change
    in the last bit flips ReLU sides and pool routes, which moves float32
    gradients by up to ~1% from the float64 ones (measured: the program
    1.05e-2 at most, the float32 reference 1.3e-3). In float64 the program
    (K4's plain versions still normalize in float32) against the float64
    reference: the loss within 1e-6 and every leaf within 1e-5 (measured
    3.7e-7), which holds the mathematics."""
    cfg, model, w = model_and_weights(seed=7)
    img, msk = _raw_batch()
    loss, grads = _program_step(model, img, msk)
    want = ref_train.run_steps(w, [(img, msk)], 11, 12, 3e-4, AUGMENT, 2, cfg,
                               torch.device("cpu"))
    assert abs(loss - want["losses"][0]) <= 1e-5 * abs(want["losses"][0])
    assert max(_leaf_gaps(grads, want["grads"]).values()) <= 3e-2

    model64 = tu.TransUNet(**work.widths(cfg), dtype=torch.float64).double()
    model64.load_state_dict(w, strict=False)
    loss64, grads64 = _program_step(model64, img, msk)
    want_loss, want_grads = _reference64(cfg, w, img, msk)
    assert abs(loss64 - want_loss) <= 1e-6 * want_loss
    assert max(_leaf_gaps(grads64, want_grads).values()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_k4_after_matches_autograd_of_batch_norm_then_relu(train, dtype):
    """``conv_bn`` in the order after against ``relu(F.batch_norm(x))`` on the
    same input (bf16: ``F.batch_norm`` on it in float32): y, the running
    statistics and the gradients of x, the scale and the shift within 2e-5
    of their largest in float32 (K4's fast variance and the sums' order), or
    2^-7 in bfloat16 (one rounding of y and of dx to 8 bits); the running
    mean as ``F.batch_norm``'s, the running variance from the batch's biased
    variance (K4's rule)."""
    tol = 2e-5 if dtype == torch.float32 else 2 ** -7
    g = torch.Generator().manual_seed(4)
    x = (torch.randn((4, 16, 9, 7), generator=g) + 0.2).to(dtype).contiguous(
        memory_format=torch.channels_last)
    r = torch.randn(x.shape, generator=g).to(dtype)
    bn = torch.nn.BatchNorm2d(16, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0.0, 0.3, generator=g)
        bn.running_mean.normal_(0.0, 0.3, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
    bn.train(train)
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    xa, xb = x.clone().requires_grad_(), x.float().requires_grad_()
    k4.reset_counts()
    y = k4.conv_bn(xa, None, k4.RELU_AFTER, bn, 0.9)
    assert k4.AFTER == {"launches": 0, "applies": 1} and y.dtype == dtype
    want = torch.relu(F.batch_norm(xb, rm.clone(), rv.clone(), bn.weight, bn.bias, train, 0.1,
                                   1e-5))

    def close(a, b):
        assert (a.float() - b).abs().max() <= tol * b.abs().max()

    close(y, want)
    got_g = torch.autograd.grad(y, (xa, bn.weight, bn.bias), r)
    want_g = torch.autograd.grad(want, (xb, bn.weight, bn.bias), r.float())
    for a, b in zip(got_g, want_g):
        close(a, b)
    if train:
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        close(bn.running_mean, 0.9 * rm + 0.1 * mean)
        close(bn.running_var, 0.9 * rv + 0.1 * var)


def test_k4_after_refuses_a_bias_the_store_forms_and_unknown_orders():
    x = torch.randn(2, 4, 4, 4).contiguous(memory_format=torch.channels_last)
    v = torch.ones(4)
    with pytest.raises(ValueError, match="no bias"):
        k4.batch_stats(x, v, k4.RELU_AFTER)
    with pytest.raises(ValueError, match="store forms"):
        k4.bn_apply_eval(x, None, k4.RELU_AFTER, v, v, v, v, 1e-5, pool=True)
    with pytest.raises(ValueError, match="recompute y"):
        k4.backward_reduce(x, None, k4.RELU_AFTER, x, v, v)
    with pytest.raises(ValueError, match="RELU_NONE"):
        k4.batch_stats(x, None, 3)


def test_spans_and_counters():
    """The forward's three spans reach the profiler inside
    ``profiling.spans()``; a train forward counts one attention call a
    layer, 13 GroupNorms (the root's, three a unit, a projection a block)
    and nine applies of K4's order after."""
    from torch.profiler import profile

    from tpuseg_torch.utils import profiling

    model = tu.TransUNet(dtype="float32", img_size=64, **TINY)
    tu.init_transunet(model, torch.Generator().manual_seed(0))
    tu.reset_counts()
    k4.reset_counts()
    x = torch.randn(2, 64, 64, 1)
    with profile() as prof, profiling.spans():
        model(x, generator=torch.Generator().manual_seed(1))
    names = {e.name for e in prof.events()}
    assert {"model.resnet", "model.vit", "model.decoder"} <= names
    assert tu.COUNTS == {"attention": 2, "group_norm": 13}
    assert k4.AFTER["applies"] == 9
    with profile() as prof:
        model(x, generator=torch.Generator().manual_seed(1))
    assert not {"model.resnet", "model.vit", "model.decoder"} & {e.name for e in prof.events()}


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    from test_torch_trainer import write_db

    root = tmp_path_factory.mktemp("dbs")
    train, test = str(root / "train.lmdb"), str(root / "test.lmdb")
    write_db(train, 6, 64, 0)
    write_db(test, 2, 64, 1)
    return train, test


def _config(dbs, out, **kw):
    from tpuseg_torch.train.trainer import TrainConfig

    return TrainConfig(train_database=dbs[0], test_database=dbs[1], output_folder=out,
                       batch_size=2, test_every_n_steps=1, max_epochs=1, seed=3,
                       device="cpu", dtype="float32", model="transunet_r50_b16", **kw)


def test_train_model_trains_and_checkpoints_a_transunet(dbs, tmp_path, monkeypatch):
    """Two steps (the warm-up epoch's 1 + 1), a test epoch, a checkpoint
    that reloads as a TransUNet at the database's tile and resumes. The
    published widths are cut to the tiny ones (the trainer builds the
    module's ``TransUNet``)."""
    import functools

    from tpuseg_torch.train.steps import create_train_state
    from tpuseg_torch.train.trainer import train_model
    from tpuseg_torch.utils.checkpoint import load_model, restore_train_state

    monkeypatch.setattr(tu, "TransUNet", functools.partial(TransUNet, **TINY))
    res = train_model(_config(dbs, str(tmp_path / "out")))
    assert res.steps == 2 and np.isfinite(res.test_loss).all()
    model = load_model(res.checkpoint_path, dtype="float32")
    assert isinstance(model, TransUNet) and not model.training
    assert model.config() == TransUNet(img_size=64, **TINY).config()
    state = create_train_state(TransUNet(dtype="float32", img_size=64, **TINY), 0, 1e-3, "cpu")
    restore_train_state(res.checkpoint_path, state)
    assert state.step == 2
    other = create_train_state(TransUNet(dtype="float32", img_size=64, **dict(TINY, hidden=32)),
                               0, 1e-3, "cpu")
    with pytest.raises(ValueError, match="transunet_r50_b16"):
        restore_train_state(res.checkpoint_path, other)


def test_a_unet_checkpoint_without_the_kind_loads_as_a_unet(tmp_path):
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.utils.checkpoint import load_model, save_model

    unet = UNet(2, 1, 4, "float32")
    path = str(tmp_path / "old.pt")
    torch.save({"config": unet.config(), "state_dict": unet.state_dict()}, path)
    assert isinstance(load_model(path, dtype="float32"), UNet)
    save_model(path, unet)
    assert torch.load(path, weights_only=True)["model"] == "unet"


def test_spatial_partitioning_is_refused(dbs, tmp_path):
    from tpuseg_torch.cli.train import main
    from tpuseg_torch.train.trainer import train_model

    with pytest.raises(ValueError, match="cannot be spatially partitioned"):
        train_model(_config(dbs, str(tmp_path / "out"), spatial_partitions=2))
    with pytest.raises(SystemExit):
        main(["--train_database", dbs[0], "--test_database", dbs[1], "--output_dir",
              str(tmp_path / "cli"), "--device", "cpu", "--model", "transunet_r50_b16",
              "--spatial", "2"])
    model = tu.TransUNet(dtype="float32", img_size=64, **TINY)
    model.halo = object()
    with pytest.raises(ValueError, match="spatially partitioned"):
        model(torch.zeros(1, 64, 64, 1))


def test_the_train_cli_takes_the_model(monkeypatch, dbs, tmp_path):
    from tpuseg_torch.cli import train as cli

    seen = []
    monkeypatch.setattr(cli, "train_model", lambda cfg: seen.append(cfg))
    args = ["--train_database", dbs[0], "--test_database", dbs[1], "--output_dir",
            str(tmp_path), "--device", "cpu"]
    cli.main(args)
    cli.main(args + ["--model", "transunet_r50_b16"])
    assert [c.model for c in seen] == ["unet", "transunet_r50_b16"]
    with pytest.raises(SystemExit):
        cli.main(args + ["--model", "vit"])
