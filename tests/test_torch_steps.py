"""The port's training step (tpuseg_torch/train/steps.py) and train-mode
U-Net against the JAX package, on the CPU at base 4.

The same flax weights go to both through the bridge; dropout is off in both
(flax's ``Dropout.__call__`` patched to the identity within the test, the
port model's ``dropout_rate`` set to 0). Tolerances, float32 throughout:

- Keras Adam alone: rtol 1e-6 (the same elementwise ops; only the host-side
  bias correction may round its last bit differently);
- per-step loss rtol 1e-5 (conv sums run in another order in XLA and in
  PyTorch's CPU kernels);
- first-step gradients within 1e-3 of each tensor's largest gradient: JAX
  disagrees with itself by ~2e-4 on this model (the same step eager and
  under jit), and the port lands at the same level;
- parameters after 3 steps: at least 99.5% of all elements within atol
  1e-6 + rtol 1e-4, and every element within lr/4. The stated tolerance
  cannot hold for every element: Keras Adam moves each weight by about
  lr * g/(|g| + eps'), so where |g| is near eps' = eps/sqrt(1 - b2^t) (3e-6
  at t = 1) the gradients' last-bit differences become a visible fraction
  of lr (measured: up to 0.13 lr here, and JAX eager and jit differ alike);
- BatchNorm running statistics: at least 98% of entries within rtol 1e-5,
  every entry within rtol 1e-3 + atol 1e-6 (they sum the batch statistics
  of forwards on those slightly different weights).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuseg.models.unet import UNet as JaxUNet
from tpuseg.models.unet import init_variables
from tpuseg.ops import losses as jlosses
from tpuseg.train import steps as jsteps
from tpuseg_torch.train.steps import KerasAdam, TrainState, eval_step, train_step
from tpuseg_torch.utils.jax_bridge import flax_to_state_dict, unet_from_flax

LR = 1e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tensors are tiny: one intra-op thread is fastest, and it keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_keras_adam_matches_tpuseg():
    """5 updates on random params and grads, with the lr changed after the
    second (as the trainer's warmup does)."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (7,), (2, 3, 5)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 1e-2, s).astype(np.float32) for s in shapes] for _ in range(5)]
    lrs = [3e-5, 3e-5, 3e-4, 3e-4, 3e-4]

    tx = jsteps.make_optimizer()
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    for g, lr in zip(grads, lrs):
        hp = dict(opt_state.hyperparams)
        hp["learning_rate"] = jnp.asarray(lr, jnp.float32)
        opt_state = opt_state._replace(hyperparams=hp)
        upd, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = KerasAdam(tp, lr=lrs[0])
    for g, lr in zip(grads, lrs):
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.param_groups[0]["lr"] = lr
        opt.step()
    assert opt.param_groups[0]["step"] == 5
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_keras_adam_differs_from_torch_adam():
    """The eps placement matters: torch's Adam takes another first step
    where |grad| is small."""
    p1 = torch.nn.Parameter(torch.zeros(4))
    p2 = torch.nn.Parameter(torch.zeros(4))
    g = torch.tensor([1e-7, 1e-6, 1e-5, 1.0])
    p1.grad, p2.grad = g.clone(), g.clone()
    KerasAdam([p1], lr=1.0).step()
    torch.optim.Adam([p2], lr=1.0, eps=1e-7).step()
    assert not torch.allclose(p1, p2)
    # a large gradient moves by lr; 1e-5 off from the float32 bias correction
    np.testing.assert_allclose(p1[3].item(), -1.0, rtol=1e-4)


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(0, 1, (2, 32, 32, 1)).astype(np.float32)
        lbl = (x[..., 0] + rng.normal(0, 0.5, x.shape[:3]) > 0).astype(np.int32)
        out.append((x, np.eye(2, dtype=np.float32)[lbl]))
    return out


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)


def test_three_train_steps_match_tpuseg(no_flax_dropout):
    model = JaxUNet(num_classes=2, base_features=4, dtype=jnp.float32)
    variables = init_variables(model, jax.random.PRNGKey(0), num_channels=1)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    jstate = jsteps.create_train_state(model, jax.random.PRNGKey(0), 1, LR)
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    tx = jsteps.make_optimizer()

    port = unet_from_flax(variables, 2, 1, 4, torch.float32)
    port.dropout_rate = 0.0
    state = TrainState(port, KerasAdam(port.parameters(), lr=LR),
                       torch.Generator(), torch.Generator())

    def as_state_dict(params, stats):
        return flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, params),
                                   "batch_stats": jax.tree_util.tree_map(np.asarray, stats)})

    for step, (x, y) in enumerate(_batches(3)):
        if step == 0:
            def loss_fn(params, x=x, y=y):
                logits, _ = model.apply({"params": params, "batch_stats": jstate.batch_stats},
                                        jnp.asarray(x), train=True, mutable=["batch_stats"])
                per_pixel = jlosses.cce_from_logits(logits, jnp.asarray(y))
                return jlosses.reference_scalar_loss(per_pixel, x.shape[0])
            jgrads = as_state_dict(jax.grad(loss_fn)(jstate.params), jstate.batch_stats)
        jstate, jm = jsteps.train_step(model, tx, jstate, jnp.asarray(x), jnp.asarray(y))
        m = train_step(state, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5,
                                   err_msg=f"loss, step {step}")
        np.testing.assert_allclose(m["accuracy"].item(), float(jm["accuracy"]), atol=1e-6)
        if step == 0:
            for name, p in port.named_parameters():
                want = jgrads[name].numpy()
                err = np.abs(p.grad.numpy() - want).max() / np.abs(want).max()
                assert err < 1e-3, (name, err)
    assert state.step == 3 and state.optimizer.param_groups[0]["step"] == 3

    want = as_state_dict(jstate.params, jstate.batch_stats)
    got = port.state_dict()
    n_par = n_par_ok = n_stat = n_stat_ok = 0
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        a, b = got[k].numpy(), v.numpy()
        d = np.abs(a - b)
        if "running" in k:
            n_stat += d.size
            n_stat_ok += int((d <= 1e-7 + 1e-5 * np.abs(b)).sum())
            assert (d <= 1e-6 + 1e-3 * np.abs(b)).all(), (k, d.max())
        else:
            n_par += d.size
            n_par_ok += int((d <= 1e-6 + 1e-4 * np.abs(b)).sum())
            assert d.max() <= LR / 4, (k, d.max())
    print(f"params within tolerance {n_par_ok / n_par:.5f}, "
          f"running stats {n_stat_ok / n_stat:.5f}")
    assert n_par_ok / n_par >= 0.995
    assert n_stat_ok / n_stat >= 0.98

    # eval after training: the updated running statistics in use
    x, y = _batches(1, seed=9)[0]
    jm = jsteps.eval_step(model, jstate, jnp.asarray(x), jnp.asarray(y))
    m = eval_step(state, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)


def test_train_mode_batchnorm_matches_flax(no_flax_dropout):
    """One train-mode forward: logits and the running-statistics update
    (biased variance, momentum 0.99) against flax."""
    model = JaxUNet(num_classes=2, base_features=4, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, init_variables(model, jax.random.PRNGKey(1), num_channels=1))
    x = np.random.default_rng(4).normal(2.0, 3.0, (2, 32, 48, 1)).astype(np.float32)
    want, upd = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = unet_from_flax(variables, 2, 1, 4, torch.float32).train()
    port.dropout_rate = 0.0
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    # the eval-mode logits test's tolerance (test_torch_unet.py): f32 conv
    # sums run in another order in XLA and in PyTorch's CPU kernels
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    stats = flax_to_state_dict({"params": variables["params"],
                                "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                      upd["batch_stats"])})
    for k, v in stats.items():
        if "running" in k:
            np.testing.assert_allclose(port.state_dict()[k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    # nn.BatchNorm2d's own train mode stores the unbiased variance instead
    h = torch.from_numpy(x).permute(0, 3, 1, 2)
    ref = torch.nn.BatchNorm2d(1, eps=1e-3, momentum=0.01).train()
    ref(h)
    n = h.numel()
    np.testing.assert_allclose(ref.running_var.item(), 0.99 + 0.01 * h.var().item(), rtol=1e-5)
    assert abs(h.var(correction=0).item() * n / (n - 1) - h.var().item()) < 1e-4


def test_dropout_active_in_train_inactive_in_eval():
    from tpuseg_torch.models.unet import UNet, init_unet

    model = init_unet(UNet(2, 1, 4, torch.float32), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (2, 32, 32, 1)).astype(np.float32))
    model.eval()
    with torch.no_grad():
        e1, e2 = model(x), model(x)
        assert torch.equal(e1, e2)
        model.train()
        t1 = model(x, generator=torch.Generator().manual_seed(1))
        t2 = model(x, generator=torch.Generator().manual_seed(2))
        t1b = model(x, generator=torch.Generator().manual_seed(1))
        model.dropout_rate = 0.0
        n1 = model(x, generator=torch.Generator().manual_seed(1))
        n2 = model(x, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(t1, t2)  # masks differ with the generator
    assert torch.equal(t1, t1b)  # and repeat with it
    assert torch.equal(n1, n2)  # rate 0: no dropout in train mode


def test_dropout_mask_rate_and_scale():
    from tpuseg_torch.models.unet import _dropout

    x = torch.ones(200_000)
    y = _dropout(x, 0.5, torch.Generator().manual_seed(0))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.01
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
