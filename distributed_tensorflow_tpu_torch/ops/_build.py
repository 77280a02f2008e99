"""Build the CUDA kernels under ``ops/csrc`` and load them with ctypes.

Each kernel source (``csrc/<name>.cu``) compiles with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, under
``ops/_build/``.  The library name carries a hash of every source and the
flags, so a changed source rebuilds and a checkout builds from nothing at
its first use.  Sources build in parallel, one ``nvcc`` each.  Nothing is
compiled at import time: this module is imported on machines without a
CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("flash_fwd", "flash_bwd_delta", "flash_bwd_keep", "flash_bwd_dq", "flash_bwd_dkv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the flash-"
        "attention kernels are compiled from ops/csrc at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest()}.so"


def build(names: Iterable[str] = KERNELS, *, verbose: bool = False) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all at once.

    Returns ``{name: compiler output}`` for the sources compiled (with
    ``verbose`` the output holds ptxas' register and spill report).  Raises
    ``RuntimeError`` with the compiler's message when a build fails.
    """
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, argtypes: list) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed), its
    entry ``dtt_<name>`` declared with ``argtypes`` and an int result."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, f"dtt_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _libs[name] = lib
    return lib


def build_all(verbose: bool = False) -> Tuple[float, Dict[str, str]]:
    """Build every kernel in parallel; returns the seconds it took and the
    compiler output of each source built (``build``'s)."""
    t0 = time.perf_counter()
    logs = build(KERNELS, verbose=verbose)
    return time.perf_counter() - t0, logs
