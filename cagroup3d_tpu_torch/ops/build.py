"""Build and load the port's CUDA kernels and its host C++ library.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface.  At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``.kernel_build/`` at the repository root, named by the
hash of its source and of the ``csrc/`` headers it includes, so that an
edited source or header is rebuilt, and bound with ``ctypes``.  Nothing
is compiled at import time.  ``ptxas -v`` reports each kernel's
registers, shared memory and spills; the report is kept beside the
library (``ptxas_report``).  A ``csrc/<name>.cpp`` (the KITTI
evaluator's matcher) is built the same way with the host compiler
(``build_host`` / ``load_host``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), ".kernel_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# no -fopenmp: a toolchain may lack libgomp, and the matcher's loop over
# thresholds runs fast enough in one thread (its pragma is then ignored)
_HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on the machine with the GPU")
    return path


def _sources(path: str, seen: list) -> list:
    """``path`` and every ``csrc/`` header it includes (``#include "..."``),
    recursively, each once, in include order."""
    if path in seen:
        return seen
    seen.append(path)
    with open(path) as f:
        for m in _INCLUDE.finditer(f.read()):
            dep = os.path.join(os.path.dirname(path), m.group(1))
            if os.path.exists(dep):
                _sources(os.path.normpath(dep), seen)
    return seen


def library_path(name: str) -> str:
    """The library's path, named by the hash of the source, of every header
    of ``csrc/`` it includes and of the nvcc flags."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in _sources(os.path.join(_CSRC, name + ".cu"), []):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its hashed library exists; returns
    the library path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp,
           os.path.join(_CSRC, name + ".cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    with open(out[:-3] + ".ptxas.txt", "w") as f:
        f.write(res.stderr)
    os.replace(tmp, out)
    return out


def build_host(name: str) -> str:
    """Compile csrc/<name>.cpp with the host C++ compiler (``CXX``, else
    c++ or g++) unless its hashed library exists; returns the path."""
    src = os.path.join(_CSRC, name + ".cpp")
    with open(src, "rb") as f:
        h = hashlib.sha256(" ".join(_HOST_FLAGS).encode() + f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"no host C++ compiler to build {name}.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *_HOST_FLAGS, "-o", tmp, src],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {name}.cpp:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load_host(name: str) -> ctypes.CDLL:
    """The bound library of csrc/<name>.cpp, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_host(name))
            _libs[name] = lib
        return lib


def ptxas_report(name: str) -> list:
    """Per kernel of csrc/<name>.cu as built: (mangled kernel name,
    registers, static shared memory bytes, spill stores + loads bytes),
    from nvcc's ptxas -v (dynamic shared memory is set at launch)."""
    path = library_path(name)[:-3] + ".ptxas.txt"
    rows, kernel = [], None
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                kernel, spill = m.group(1), 0
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and kernel:
                spill = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                          line)
            if m and kernel:
                rows.append((kernel, int(m.group(1)), int(m.group(2) or 0),
                             spill))
                kernel = None
    return rows


def load(name: str) -> ctypes.CDLL:
    """The bound library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaGetLastError() code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
