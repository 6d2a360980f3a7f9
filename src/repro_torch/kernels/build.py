"""Build the CUDA kernels with ``nvcc`` on first use and load them with
``ctypes``.

Each ``csrc/*.cu`` compiles on its own into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds, not minutes).
All sources compile in parallel, one ``nvcc`` each.  Libraries land in
``build/repro_torch_kernels/`` at the repository root, named by a hash
of their sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing is compiled at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["build_all", "load", "build_dir", "KERNEL_SOURCES", "NVCC_FLAGS",
           "ARGTYPES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO_ROOT = Path(__file__).resolve().parents[3]
_HEADERS = ("wilson_plane.cuh", "wilson_site_tile.cuh")

#: library name -> its source file under csrc/
KERNEL_SOURCES = {
    "wilson_hop": "wilson_hop.cu",
    "wilson_dhat_fused": "wilson_dhat_fused.cu",
    "wilson_dhat_stream": "wilson_dhat_stream.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
#: entry point -> ctypes argtypes of every kernel library's C interface
ARGTYPES = {
    # u_out, u_in, src, psi0, out, T, Z, Y, Xh, nrhs, gc, itemsize, halo,
    # out_parity, tz_par, coeff, D, G, S, groups, tiles, threads, smem,
    # device, stream
    "wilson_hop_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _D, *[_I] * 7, _I, _P],
    # u_e, u_o, psi, tmp, out, T, Z, Y, Xh, nrhs, gc, itemsize, tz_par,
    # kappa2, D, G, S, groups, tiles, threads, grid, smem, device, stream
    "wilson_dhat_fused_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _D, *[_I] * 8, _I, _P],
    # u_e, u_o, psi, ring, out, flags, T, Z, Y, Xh, nrhs, window, gc,
    # itemsize, tz_par, kappa2, D, G, S, groups, tiles, threads, grid,
    # smem, device, stream
    "wilson_dhat_stream_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _D, *[_I] * 8, _I,
                                  _P],
    # gc, itemsize, D, threads, smem, device, int* blocks per SM
    "wilson_dhat_fused_occupancy": [_I] * 6 + [ctypes.POINTER(_I)],
    "wilson_dhat_stream_occupancy": [_I] * 6 + [ctypes.POINTER(_I)],
}

_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return _REPO_ROOT / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels are "
        "built on the machine with the GPU")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for fn in (KERNEL_SOURCES[name],) + _HEADERS:
        h.update((_CSRC / fn).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> Dict[str, dict]:
    """Compile every stale kernel library, all ``nvcc`` runs at once.

    Returns ``{name: {"path", "seconds", "log"}}`` (``seconds`` 0 for a
    library that was already built); raises ``RuntimeError`` with the
    compiler's output if any build fails.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    result = {}
    for name, src in KERNEL_SOURCES.items():
        lib = _lib_path(name)
        if lib.exists():
            result[name] = {"path": str(lib), "seconds": 0.0,
                            "log": (lib.with_suffix(".log").read_text()
                                    if lib.with_suffix(".log").exists()
                                    else "")}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), lib, tmp, time.time())
    failures = []
    for name, (proc, lib, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.time() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        lib.with_suffix(".log").write_text(log)
        result[name] = {"path": str(lib), "seconds": seconds, "log": log}
        if verbose:
            print(f"built {lib.name} in {seconds:.1f}s", flush=True)
    if failures:
        raise RuntimeError("\n".join(failures))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed), with
    ``argtypes``/``restype`` declared for its entry points."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in ARGTYPES.items():
        if fn_name.startswith(f"{name}_"):
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    _loaded[name] = lib
    return lib
