"""What a run loads: no JAX and nothing of the JAX package, by whole
top-level names, in a fresh interpreter; and a reference that loads
nothing of the program."""

import json
import os
import subprocess
import sys

from harness import isolation

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_top_level_names_are_compared_whole():
    names = ["tpuseg_torch", "tpuseg_torch.infer.tiled", "jaxtyping", "flaxen", "torch"]
    assert isolation.forbidden_modules(names) == []
    assert isolation.forbidden_modules(["tpuseg.infer", "jax._src", "jaxlib", "flax.linen",
                                        "orbax.checkpoint"]) == [
        "flax", "jax", "jaxlib", "orbax", "tpuseg"]


def fresh(code: str) -> dict:
    prelude = (f"import json, sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}, "
               f"{os.path.join(BENCH, 'tests')!r}]\n")
    out = subprocess.run([sys.executable, "-c", prelude + code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_cells_set_up_loads_no_jax():
    got = fresh(
        "import torch\n"
        "import tiny\n"
        "from drivers import serve_tiled, train_steps\n"
        "from harness import isolation\n"
        "dev = torch.device('cpu')\n"
        "for name in ('int8b-4096-tiled', 'bf16-4096-tiled'):\n"
        "    serve_tiled.setup(tiny.cell(name), 5, dev)\n"
        "c = tiny.cell('train-512-b16')\n"
        "from harness import weights\n"
        "w = weights.make(c.config, 5, dev)\n"
        "train_steps.build_step(c.config, c.traffic, w, (1, 2), dev)\n"
        "print(json.dumps({'found': isolation.forbidden_modules(),"
        " 'torch_port': 'tpuseg_torch' in sys.modules}))\n")
    assert got == {"found": [], "torch_port": True}


def test_the_reference_loads_nothing_of_the_program():
    got = fresh(
        "from reference import augment, check, tiled, train, unet\n"
        "from harness import isolation\n"
        "print(json.dumps({'found': isolation.forbidden_modules(sys.modules,"
        " isolation.FORBIDDEN + ('tpuseg_torch',))}))\n")
    assert got == {"found": []}
