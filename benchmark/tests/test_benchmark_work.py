"""The work counts of ``benchmark/work/`` against values worked out by hand."""

import pytest

from work import k3, k4, unet

CFG = dict(base_features=64, levels=4, num_channels=1, num_classes=2)
HBM, INT8 = 3.35e12, 1979e12


def test_unet_has_23_batchnorm_layers_and_31m_parameters():
    layers = unet.layers(CFG)
    assert len(layers) == 23
    params = sum(l["k"] ** 2 * l["cin"] * l["cout"] + (l["cout"] if l["kind"] == "conv" else 0)
                 + 2 * l["cout"] for l in layers)
    assert params == 31_043_398


@pytest.mark.parametrize("size,want", [(512, 384.77e9), (1024, 1539.07e9), (256, 96.19e9)])
def test_forward_ops(size, want):
    # 384.8 GFLOP at 512^2: the deconvs one tap per output pixel
    assert unet.forward_ops(CFG, size, size) == pytest.approx(want, rel=2e-4)


def test_deconv_counts_one_tap_an_output_pixel():
    up = [l for l in unet.layers(CFG) if l["name"] == "dec1up"][0]
    assert unet.macs(up, 512, 512) == 512 * 512 * 128 * 64


def test_train_ops_are_three_forwards():
    assert unet.train_ops(CFG, 512, 512) == 3 * unet.forward_ops(CFG, 512, 512)


def test_k3_call_of_8_tiles():
    # 12.30 TOP in K3's 21 layers, 12.31 TOP in the whole forward of 8 tiles of 1024^2
    assert len(k3.blocks(CFG)) == 21
    assert k3.call_ops(CFG, 8, 1024) == pytest.approx(12.3008e12, rel=1e-4)
    assert 8 * unet.forward_ops(CFG, 1024, 1024) == pytest.approx(12.3126e12, rel=1e-4)
    assert k3.call_bound_s(CFG, 8, 1024, INT8, HBM) * 1e3 == pytest.approx(6.4935, rel=1e-3)


@pytest.mark.parametrize("kernels,tensors", [(("stats",), 1), (("apply",), 2),
                                             (("backward_reduce",), 2),
                                             (("backward_apply",), 3)])
def test_k4_byte_bound_at_enc1(kernels, tensors):
    # enc1 at [8, 64, 512, 512] bf16: x; x and y; x and g; x, g and dx
    enc1b = [l for l in unet.layers(CFG) if l["name"] == "enc1b"][0]
    got = k4.layer_bytes(enc1b, 8, 512, 512, kernels)
    assert got == tensors * 8 * 64 * 512 * 512 * 2 + k4.VECTOR_BYTES * 64
    assert got / HBM * 1e3 == pytest.approx(0.08013 * tensors, rel=1e-3)


def test_k4_serve_and_train_bytes():
    # 23 eval applies of a call of 8 tiles of 1024^2, and 4 kernels a layer a step
    assert k4.serve_bytes(CFG, 8, 1024) / HBM * 1e3 == pytest.approx(6.110, rel=1e-3)
    assert k4.train_bytes(CFG, 16, 512) == pytest.approx(4 * k4.serve_bytes(CFG, 16, 512),
                                                         rel=1e-3)
