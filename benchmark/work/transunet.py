"""TransUNet R50-ViT-B/16's parameters, and the work of a forward pass and
of a train step, from the sizes in its configuration file.

The graph is github.com/Beckschen/TransUNet (``networks/vit_seg_configs.py::
get_r50_b16_config``, ``vit_seg_modeling.py``, ``vit_seg_modeling_resnet_skip
.py``): a ResNet (a 7x7/2 root conv, a 3x3/2 max pool without padding, then
bottleneck units of 1x1, 3x3 (the stride) and 1x1 convs, a 1x1 projection
where the stride or width changes), a 1x1 patch embedding, pre-LN ViT layers
over the ``(S/16)^2`` tokens, and a decoder of ``conv_more`` and four blocks
of two 3x3 convs after a bilinear x2 (with the concat of a skip), then a
3x3 head.

Operations count 2 a multiply-add: convs ``out_pixels * k^2 * cin * cout``
(the root conv with the input's channels: a one-channel input's weight is
summed over the three it stands for), linears ``tokens * in * out``, and
attention's two products ``2 * L^2 * hidden`` multiply-adds a layer
(``QK^T`` and ``PV`` over all heads). Norms, activations, the softmax, the
weight standardization, pools, upsamplings and concats are left out. A
train step is three forwards (the backward's input and weight gradients);
attention's backward counts its four products, ``8 * L^2 * hidden``
operations a layer, against the forward's ``4 * L^2 * hidden``: the flash
backward's recompute of ``QK^T`` is not counted.
"""

from __future__ import annotations

import math
from typing import Dict, List

from work import k4


def widths(cfg: dict) -> Dict:
    """The architecture's numbers, by the names the program takes."""
    t = cfg["transformer"]
    return {"img_size": cfg["img_size"], "num_channels": cfg["num_channels"],
            "num_classes": cfg["num_classes"],
            "width": int(64 * cfg["resnet"]["width_factor"]),
            "block_units": list(cfg["resnet"]["num_layers"]), "hidden": cfg["hidden_size"],
            "num_layers": t["num_layers"], "num_heads": t["num_heads"], "mlp_dim": t["mlp_dim"],
            "head_channels": cfg["head_channels"],
            "decoder_channels": list(cfg["decoder_channels"]), "n_skip": cfg["n_skip"]}


def _conv_side(side: int, k: int, stride: int, pad: int) -> int:
    return (side + 2 * pad - k) // stride + 1


def sides(cfg: dict) -> List[int]:
    """The ResNet's sides: the root's output, block 1's (after the pool),
    block 2's and block 3's (the tokens' grid)."""
    root = _conv_side(cfg["img_size"], 7, 2, 3)
    s1 = _conv_side(root, 3, 2, 0)
    s2 = _conv_side(s1, 3, 2, 1)
    return [root, s1, s2, _conv_side(s2, 3, 2, 1)]


def convs(cfg: dict) -> List[dict]:
    """Every conv: ``name`` (its weight's, without ``.weight``), ``k``,
    ``cin``, ``cout``, ``side`` (its output's), ``std`` (weight-standardized)
    and ``norm`` (``gn`` with the GroupNorm's name and groups, ``bn``, or
    None)."""
    w = widths(cfg)
    f = w["width"]
    root, s1, s2, s3 = sides(cfg)
    cin0 = 1 if w["num_channels"] == 1 else 3
    out = [dict(name="resnet.root.conv", k=7, cin=cin0, cout=f, side=root, std=True,
                norm=("resnet.root.gn", 32))]
    blocks = [(f, 4 * f, f, s1), (4 * f, 8 * f, 2 * f, s2), (8 * f, 16 * f, 4 * f, s3)]
    for b, ((cin, cout, cmid, side), units) in enumerate(zip(blocks, w["block_units"])):
        for u in range(1, units + 1):
            p = f"resnet.block{b + 1}.unit{u}"
            c = cin if u == 1 else cout
            # a unit's first 1x1 conv runs at the block's input side
            out += [dict(name=f"{p}.conv1", k=1, cin=c, cout=cmid,
                         side=[s1, s1, s2][b] if u == 1 else side, std=True,
                         norm=(f"{p}.gn1", 32)),
                    dict(name=f"{p}.conv2", k=3, cin=cmid, cout=cmid, side=side, std=True,
                         norm=(f"{p}.gn2", 32)),
                    dict(name=f"{p}.conv3", k=1, cin=cmid, cout=cout, side=side, std=True,
                         norm=(f"{p}.gn3", 32))]
            if u == 1:
                out.append(dict(name=f"{p}.downsample", k=1, cin=c, cout=cout, side=side,
                                std=True, norm=(f"{p}.gn_proj", cout)))
    out.append(dict(name="embed.patch", k=1, cin=16 * f, cout=w["hidden"], side=s3, std=False,
                    norm=None))
    out += [dict(name=layer["name"] + ".conv", k=3, cin=layer["cin"], cout=layer["cout"],
                 side=layer["side"], std=False, norm="bn") for layer in k4_layers(cfg)]
    out.append(dict(name="head", k=3, cin=w["decoder_channels"][-1], cout=w["num_classes"],
                    side=cfg["img_size"], std=False, norm=None))
    return out


def k4_layers(cfg: dict) -> List[dict]:
    """The decoder's nine ``Conv2dReLU`` layers (K4's order after):
    ``name``, ``cin``, ``cout`` and ``side``."""
    w = widths(cfg)
    f, s3 = w["width"], sides(cfg)[3]
    skips = ([8 * f, 4 * f, f, 0][:w["n_skip"]] + [0] * 4)[:4]
    out = [dict(name="decoder.conv_more", cin=w["hidden"], cout=w["head_channels"], side=s3)]
    cin = w["head_channels"]
    for i, (cout, skip) in enumerate(zip(w["decoder_channels"], skips)):
        side = s3 << (i + 1)
        out += [dict(name=f"decoder.blocks.{i}.conv1", cin=cin + skip, cout=cout, side=side),
                dict(name=f"decoder.blocks.{i}.conv2", cin=cout, cout=cout, side=side)]
        cin = cout
    return out


def tokens(cfg: dict) -> int:
    return sides(cfg)[3] ** 2


def linears(cfg: dict) -> List[dict]:
    """Every linear of the ViT: ``name``, ``cin``, ``cout``."""
    w = widths(cfg)
    h, m = w["hidden"], w["mlp_dim"]
    out = []
    for i in range(w["num_layers"]):
        p = f"layers.{i}"
        out += [dict(name=f"{p}.attn.{n}", cin=h, cout=h) for n in ("query", "key", "value",
                                                                      "out")]
        out += [dict(name=f"{p}.ffn.fc1", cin=h, cout=m), dict(name=f"{p}.ffn.fc2", cin=m, cout=h)]
    return out


def conv_macs(conv: dict) -> int:
    return conv["side"] ** 2 * conv["k"] ** 2 * conv["cin"] * conv["cout"]


def attention_macs(cfg: dict) -> int:
    """``QK^T`` and ``PV`` of every layer, one image."""
    w = widths(cfg)
    return 2 * tokens(cfg) ** 2 * w["hidden"] * w["num_layers"]


def forward_macs_by_part(cfg: dict) -> Dict[str, int]:
    """One image's forward multiply-adds: ``resnet``, ``vit_linear``,
    ``attention``, ``patch`` and ``decoder`` (with the head)."""
    parts = {"resnet": 0, "patch": 0, "decoder": 0}
    for c in convs(cfg):
        part = ("resnet" if c["name"].startswith("resnet") else
                "patch" if c["name"] == "embed.patch" else "decoder")
        parts[part] += conv_macs(c)
    parts["vit_linear"] = tokens(cfg) * sum(lin["cin"] * lin["cout"] for lin in linears(cfg))
    parts["attention"] = attention_macs(cfg)
    return parts


def forward_ops(cfg: dict) -> int:
    """Operations of one image's forward pass at the configuration's tile."""
    return 2 * sum(forward_macs_by_part(cfg).values())


def train_ops(cfg: dict) -> int:
    """Operations of one image's train step: the forward, and a backward of
    twice its work."""
    return 3 * forward_ops(cfg)


def attention_train_ops(cfg: dict) -> int:
    """Attention's operations in one image's train step: ``4 * L^2 *
    hidden`` forward and ``8 * L^2 * hidden`` backward, a layer."""
    return 3 * 2 * attention_macs(cfg)


def k4_train_bytes(cfg: dict, batch: int, elem: int = 2) -> int:
    """Bytes of one train step's nine decoder layers' four K4 kernels, as
    ``work/k4.py`` counts the U-Net's."""
    total = 0
    for layer in k4_layers(cfg):
        n = batch * layer["side"] ** 2 * layer["cout"]
        total += sum(k4.TENSORS[k] * n * elem + k4.VECTOR_BYTES * layer["cout"]
                     for k in k4.TENSORS)
    return total


def params(cfg: dict) -> List[dict]:
    """Every tensor of the model's state dict but BatchNorm's
    ``num_batches_tracked``: ``name``, ``shape`` and ``init``, the source's
    initialization (``kaiming``: PyTorch's default for convs and linears,
    uniform in ``+-1/sqrt(fan_in)``; ``bias``: uniform in ``+-bound``;
    ``xavier``: uniform in ``+-sqrt(6 / (fan_in + fan_out))``; ``normal``:
    N(0, std^2); ``ones``, ``zeros``)."""
    w = widths(cfg)
    out = []

    def kaiming(name, shape, bias=True):
        fan_in = math.prod(shape[1:])
        out.append(dict(name=f"{name}.weight", shape=shape, init="kaiming",
                        bound=1.0 / math.sqrt(fan_in)))
        if bias:
            out.append(dict(name=f"{name}.bias", shape=(shape[0],), init="bias",
                            bound=1.0 / math.sqrt(fan_in)))

    def norm(name, c, running=False):
        out.append(dict(name=f"{name}.weight", shape=(c,), init="ones"))
        out.append(dict(name=f"{name}.bias", shape=(c,), init="zeros"))
        if running:
            out.append(dict(name=f"{name}.running_mean", shape=(c,), init="zeros"))
            out.append(dict(name=f"{name}.running_var", shape=(c,), init="ones"))

    for c in convs(cfg):
        cin = 3 if c["name"] == "resnet.root.conv" else c["cin"]
        shape = (c["cout"], cin, c["k"], c["k"])
        if c["name"] == "embed.patch":
            kaiming(c["name"], shape)
            out.append(dict(name="embed.position", shape=(1, tokens(cfg), w["hidden"]),
                            init="normal", std=0.02))
            continue
        kaiming(c["name"], shape, bias=c["name"] == "head")
        if c["norm"] == "bn":
            norm(c["name"][:-len(".conv")] + ".bn", c["cout"], running=True)
        elif c["norm"] is not None:
            norm(c["norm"][0], c["cout"])
    for i in range(w["num_layers"]):
        p = f"layers.{i}"
        norm(f"{p}.attention_norm", w["hidden"])
        for n in ("query", "key", "value", "out"):
            kaiming(f"{p}.attn.{n}", (w["hidden"], w["hidden"]))
        norm(f"{p}.ffn_norm", w["hidden"])
        for n, shape in (("fc1", (w["mlp_dim"], w["hidden"])),
                         ("fc2", (w["hidden"], w["mlp_dim"]))):
            out.append(dict(name=f"{p}.ffn.{n}.weight", shape=shape, init="xavier",
                            bound=math.sqrt(6.0 / (shape[0] + shape[1]))))
            out.append(dict(name=f"{p}.ffn.{n}.bias", shape=(shape[0],), init="normal",
                            std=1e-6))
    norm("encoder_norm", w["hidden"])
    return out
