"""Convert checkpoints between the JAX package (orbax) and its PyTorch port.

    python scripts/convert_orbax_checkpoint.py --to port \\
        --orbax_checkpoint OUT/checkpoint/ckpt --port_checkpoint model.pt \\
        --number_classes 2 --number_channels 1 [--base_features 64]
    python scripts/convert_orbax_checkpoint.py --to orbax \\
        --port_checkpoint model.pt --orbax_checkpoint OUT/checkpoint/ckpt

``--to port`` restores the model variables of a ``tpuseg`` checkpoint
(``tpuseg.utils.checkpoint.restore_model_variables``; the geometry flags
build its template, as ``tpuseg.cli.inference`` takes them) and writes
them with ``tpuseg_torch.utils.checkpoint.save_model``, which
``tpuseg_torch.cli.inference`` serves. ``--to orbax`` reads a port
checkpoint of either kind (its geometry from its ``config``) and writes a
``tpuseg`` train state with those weights and a fresh optimizer, as
``tpuseg.cli.import_checkpoint`` does, which ``tpuseg.cli.inference``
serves and ``tpuseg.cli.train --resume_checkpoint`` resumes. The weights
map exactly both ways (``tpuseg_torch.utils.jax_bridge``).

Needs jax, flax and orbax beside PyTorch: it runs where the JAX package
runs, not on a machine that has only the port.
"""

import argparse
import os
import sys


def to_port(args) -> str:
    import jax

    from tpuseg.models.unet import UNet as JaxUNet
    from tpuseg.train.steps import create_train_state
    from tpuseg.utils.checkpoint import restore_model_variables
    from tpuseg_torch.utils.checkpoint import save_model
    from tpuseg_torch.utils.jax_bridge import unet_from_flax

    model = JaxUNet(num_classes=args.number_classes, base_features=args.base_features,
                    deconv_impl=args.deconv_impl)
    template = create_train_state(model, jax.random.PRNGKey(0), args.number_channels,
                                  args.learning_rate)
    variables = jax.device_get(restore_model_variables(args.orbax_checkpoint, template))
    port = unet_from_flax(variables, args.number_classes, args.number_channels,
                          args.base_features, deconv_impl=args.deconv_impl)
    save_model(args.port_checkpoint, port)
    return args.port_checkpoint


def to_orbax(args) -> str:
    import jax
    import jax.numpy as jnp
    import torch

    from tpuseg.models.unet import UNet as JaxUNet
    from tpuseg.train.steps import create_train_state
    from tpuseg.utils.checkpoint import save_checkpoint
    from tpuseg_torch.utils.jax_bridge import state_dict_to_flax

    doc = torch.load(args.port_checkpoint, map_location="cpu", weights_only=True)
    cfg = doc["config"]
    model = JaxUNet(num_classes=cfg["num_classes"], base_features=cfg["base_features"],
                    deconv_impl=cfg["deconv_impl"])
    state = create_train_state(model, jax.random.PRNGKey(0), cfg["num_channels"],
                               args.learning_rate)
    variables = state_dict_to_flax(doc["state_dict"], cfg["deconv_impl"])
    as_jnp = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    shapes = lambda tree: jax.tree.map(lambda x: tuple(x.shape), tree)  # noqa: E731
    for key, template in (("params", state.params), ("batch_stats", state.batch_stats)):
        if shapes(template) != shapes(variables[key]):
            raise ValueError(f"{args.port_checkpoint}: {key} do not match the tpuseg U-Net "
                             f"{cfg}")
    state = state.replace(params=as_jnp(variables["params"]),
                          batch_stats=as_jnp(variables["batch_stats"]))
    save_checkpoint(args.orbax_checkpoint, state)
    return args.orbax_checkpoint


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description="Convert a tpuseg orbax checkpoint to a tpuseg_torch checkpoint "
                    "(--to port) or back (--to orbax)")
    parser.add_argument("--to", choices=["port", "orbax"], required=True)
    parser.add_argument("--orbax_checkpoint", type=str, required=True,
                        help="tpuseg checkpoint directory: read (--to port) or "
                             "written (--to orbax)")
    parser.add_argument("--port_checkpoint", type=str, required=True,
                        help="tpuseg_torch checkpoint file: written (--to port) or "
                             "read (--to orbax)")
    parser.add_argument("--number_classes", type=int, default=None,
                        help="geometry of the orbax checkpoint (--to port; required)")
    parser.add_argument("--number_channels", type=int, default=None,
                        help="geometry of the orbax checkpoint (--to port; required)")
    parser.add_argument("--base_features", type=int, default=64,
                        help="geometry of the orbax checkpoint (--to port)")
    parser.add_argument("--deconv_impl", choices=["conv_transpose", "pixel_shuffle"],
                        default="conv_transpose",
                        help="the tpuseg U-Net's deconv form (--to port)")
    parser.add_argument("--learning_rate", type=float, default=3e-4,
                        help="learning rate of the train state template / written state")
    args = parser.parse_args(argv)
    if args.to == "port":
        if args.number_classes is None or args.number_channels is None:
            parser.error("--to port needs --number_classes and --number_channels")
        out = to_port(args)
    else:
        out = to_orbax(args)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tpuseg.utils.compile_cache import honor_platform_env

    honor_platform_env()  # JAX_PLATFORMS=cpu works as it does for tpuseg's CLIs
    main()
