"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled at first use with `nvcc` for `sm_90a`
into a shared library with a plain C interface, loaded with `ctypes`. The
library goes into the package's git-ignored `_build/` directory, named by
a hash of its source and of every header in `csrc/`, so an edited source
or header is rebuilt and an unchanged one is reused. Several sources build
in parallel, one `nvcc` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("flash_fwd", "flash_bwd", "keep_bits_dump", "gelu", "layer_norm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the dtype argument of every kernel's C interface
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the sources include them
        h.update(header.name.encode() + header.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named source that has no current library, all `nvcc`s
    started together. Returns the compiler's output (`-Xptxas -v`: registers
    and shared memory per kernel) by name; raises if any build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in jobs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib
