"""Build the CUDA sources of ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled at first use by one ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, under
``plonky2_goldibear_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the sources so an edit rebuilds.  ``build_all`` starts one ``nvcc``
per source, all at once.  Nothing here runs at import: the CPU path never
needs ``nvcc``.

``host_lib`` builds a host C source of ``csrc/`` (``witgen.c``, the
witness-replay VM) with the system C compiler ``cc -O2 -shared -fPIC``,
under the same directory and named by the hash of its source.  It needs no
``nvcc``, so the CPU path builds it too; without a working compiler it
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("ntt_gl", "poseidon_gl", "ntt_bb", "poseidon2_bb", "keccak",
           "transcript", "probes")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
HOST_CC = "cc"

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: Dict[str, str] = {}      # ptxas report per source


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def _command(name: str, out: str) -> List[str]:
    return [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
            "-fPIC", "-Xptxas", "-v", "-I", CSRC, "-o", out,
            os.path.join(CSRC, name + ".cu")]


def build_all(names=SOURCES) -> Dict[str, float]:
    """Compile every missing library, one nvcc per source in parallel.
    Returns the seconds each build took (0 where it was already built)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if not os.path.exists(out):
            tmp = out + f".{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
    secs = {name: 0.0 for name in names}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        secs[name] = time.perf_counter() - t0
    return secs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all((name,))
            _LIBS[name] = ctypes.CDLL(path)
        return _LIBS[name]


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` (a device or its index) as an
    address (PyTorch's raw stream query where the build has it: the
    cheaper call)."""
    import torch

    index = device if isinstance(device, int) else device.index
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and index is not None:
        return raw(index)
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with error {err}")


def _host_lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".c"), "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build_host(name: str) -> str:
    """Compile ``csrc/<name>.c`` with ``HOST_CC`` unless it is built;
    returns the library's path.  Raises ``RuntimeError`` naming the
    compiler when it is missing or fails."""
    out = _host_lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = out + f".{os.getpid()}.tmp"
    cmd = [HOST_CC, "-O2", "-shared", "-fPIC", "-o", tmp,
           os.path.join(CSRC, name + ".c")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the C compiler {HOST_CC!r} could not run for "
                           f"{name}.c: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"the C compiler {HOST_CC!r} failed for "
                           f"{name}.c:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def host_lib(name: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.c``, built on
    first use."""
    key = name + ".c"
    with _LOCK:
        if key not in _LIBS:
            _LIBS[key] = ctypes.CDLL(build_host(name))
        return _LIBS[key]
