"""Build and load the port's CUDA kernels.

Each source in ``tpuseg_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds. Libraries
go to ``build/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source and flags, so an edited source rebuilds and
an unchanged one loads at once. Nothing builds at import: the first
:func:`load` builds what it needs, and :func:`build` starts one ``nvcc``
per missing source, all in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# library name -> (source, {C function: (restype, argtypes)})
_P, _I = ctypes.c_void_p, ctypes.c_int
SOURCES = {
    "head_argmax": ("head_argmax.cu", {
        "tpuseg_head_argmax": (_I, [_P, _I, _P, _P, _I, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _P]),
        "tpuseg_cuda_error_string": (ctypes.c_char_p, [_I]),
    }),
    "shear_rows": ("shear_rows.cu", {
        "tpuseg_shear_rows": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
        "tpuseg_cuda_error_string": (ctypes.c_char_p, [_I]),
    }),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each library built by this process
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH); the "
                           "CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name][0]).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every library in ``names`` (default: all) that is not built
    yet, one ``nvcc`` per source, all started together. Raises with the
    compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n][0])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, paths[n])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its C signatures declared, built
    first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, (restype, argtypes) in SOURCES[name][1].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib
