"""Build and load the port's CUDA kernels.

Each source in ``tpuseg_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds. Libraries
go to ``build/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source and flags, so an edited source rebuilds and
an unchanged one loads at once. Nothing builds at import: the first
:func:`load` builds what it needs, and :func:`build` starts one ``nvcc``
per missing source, all in parallel.

Every launch goes through :func:`launch`: the C entries take the stream's
handle (:func:`current_stream`) last and return 0 or a ``cudaError_t``,
which :func:`check` turns into a ``RuntimeError`` with the library's own
message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# library name -> (source, {C function: (restype, argtypes)}); every library
# also exports ``ERROR_STRING``
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SOURCES = {
    "batchnorm": ("batchnorm.cu", {
        "tpuseg_bn_reduce_plan": (_I, [_P, _L, _P, _L, _P, _L, _L, _I, _L, _I, _I, _P]),
        "tpuseg_bn_stats": (_I, [_P, _L, _I, _P, _I, _L, _I, _P, _P, _P, _P]),
        "tpuseg_bn_apply": (_I, [_P, _L, _I, _P, _I, _I, _P, _P, _F, _P, _P, _P, _F, _F, _P,
                                 _L, _I, _P, _L, _P, _L, _P]),
        "tpuseg_bn_backward_reduce": (_I, [_P, _L, _P, _L, _P, _L, _L, _I, _P, _I, _P, _P, _P,
                                           _P, _L, _I, _I, _P, _P, _P, _P]),
        "tpuseg_bn_backward_apply": (_I, [_P, _L, _P, _L, _P, _L, _L, _I, _P, _I, _P, _P, _P,
                                          _P, _I, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P, _L,
                                          _P]),
    }),
    "head_argmax": ("head_argmax.cu", {
        "tpuseg_head_argmax": (_I, [_P, _I, _P, _P, _I, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _P]),
        "tpuseg_dense_head_argmax": (_I, [_P, _P, _P, _I, _P, _P, _L, _I, _I, _I, _I, _P]),
    }),
    "input_conv": ("input_conv.cu", {
        "tpuseg_input_conv": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _P]),
        "tpuseg_input_conv_plan": (_I, [_I, _I, _I, _I, _I, _I, _I, _P]),
        "tpuseg_input_conv_check_requant": (_I, [_P, _I, ctypes.c_longlong, _I,
                                                 ctypes.c_ulonglong, _P, _P]),
    }),
    "int8_conv": ("int8_conv.cu", {
        "tpuseg_int8_conv": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
        "tpuseg_int8_conv_smem_bytes": (_I, [_I, _I]),
    }),
    "shear_rows": ("shear_rows.cu", {
        "tpuseg_shear_rows": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    }),
}

ERROR_STRING = ("tpuseg_cuda_error_string", (ctypes.c_char_p, [_I]))

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
        for fn, (restype, argtypes) in [*SOURCES[name][1].items(), ERROR_STRING]:
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib


def current_stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream."""
    return torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, err: int, what: str, note: str = "") -> None:
    """Raise ``RuntimeError("<what>: <message> (<err><note>)")`` if ``err``,
    the return of one of ``lib``'s C functions, is not 0; the message is
    the library's ``tpuseg_cuda_error_string`` of it."""
    if err:
        raise RuntimeError(f"{what}: {lib.tpuseg_cuda_error_string(err).decode()} "
                           f"({err}{note})")


def launch(name: str, fn: str, device: torch.device, stream: int, *args, what: str,
           note: str = "") -> None:
    """Call the C function ``fn`` of library ``name`` with ``args`` and the
    stream handle ``stream`` last, with ``device`` current: a device guard
    is entered only where another device is current. A non-zero return
    raises as :func:`check` does, after ``what``."""
    lib = load(name)
    if device.index is None or device.index == torch.cuda.current_device():
        err = getattr(lib, fn)(*args, stream)
    else:
        with torch.cuda.device(device):
            err = getattr(lib, fn)(*args, stream)
    check(lib, err, what, note)
