"""Build the hand-written CUDA kernels from the package's sources.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` into a shared library that ``ctypes`` loads (no PyTorch headers,
so a build takes seconds).  Builds happen at first use, never at import,
into ``orbslam2_tpu_torch/_build/`` (git-ignored), keyed by a hash of the
source and flags so that an edit rebuilds.  ``defines`` (``-DNAME=V``
flags) build a variant beside the default one, for a development sweep.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Sequence, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str, defines: Sequence[str] = ()) -> str:
    """Where the build of ``csrc/<name>.cu`` lands (hash of source+flags)."""
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        src = f.read()
    flags = " ".join((*NVCC_FLAGS, *defines))
    key = hashlib.sha256(src + flags.encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{key}.so")


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, load it once per
    process.  A failed build raises with nvcc's stderr."""
    defines = tuple(defines)
    with _lock:
        lib = _loaded.get((name, defines))
        if lib is not None:
            return lib
        out = library_path(name, defines)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", tmp,
                   os.path.join(CSRC_DIR, name + ".cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(tmp, out)       # atomic: concurrent builders agree
        lib = ctypes.CDLL(out)
        _loaded[name, defines] = lib
        return lib
