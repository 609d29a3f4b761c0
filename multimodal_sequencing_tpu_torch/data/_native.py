"""ctypes binding of the native story packer (counterpart of
`data/_native.py`: `pack_story`, `pack_all_pairs` and `pack_berson`).

`csrc/packer.cc` is a byte-for-byte copy of the JAX package's
`native/packer.cc` (a test holds the two equal). At first use it is built
with the host C++ compiler (`$CXX`, else `g++`, with the flags of
`native/Makefile`) into the port's git-ignored `_build/` directory, named by
a hash of the source, and loaded with `ctypes`. Without a compiler, or when
the build fails, `pack_story` returns None and `StoryPacker` packs with
numpy, which gives the same arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "csrc" / "packer.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_lock = threading.Lock()
_state = {"lib": None, "tried": False, "error": None}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()
    return BUILD_DIR / f"libpacker-{digest[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE)]
    subprocess.run(cmd, check=True, capture_output=True, text=True,
                   timeout=120)
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        out = library_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None) or e
            _state["error"] = f"{type(e).__name__}: {detail}"
            logger.info("native packer unavailable (%s); using numpy",
                        _state["error"])
            return None
        lib.pack_story.restype = ctypes.c_int32
        lib.pack_story.argtypes = [_I32P, _I32P, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_int32, _I32P,
                                   _I32P]
        lib.pack_all_pairs.restype = None
        lib.pack_all_pairs.argtypes = [_I32P, _I32P, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.c_int32,
                                       _I32P, _I32P, _I32P]
        lib.pack_berson.restype = None
        lib.pack_berson.argtypes = [_I32P, _I32P, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_int32, _I32P,
                                    _I32P, _I32P, _I32P, _I32P]
        _state["lib"] = lib
        return lib


def available() -> bool:
    """Whether the native packer is built and loaded (building it now if
    it was not tried yet)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the native packer is not available; None when it is or was not
    tried."""
    return _state["error"]


def _flatten(step_ids: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(step_ids) + 1, np.int32)
    for k, s in enumerate(step_ids):
        offsets[k + 1] = offsets[k] + len(s)
    flat = (np.concatenate(step_ids).astype(np.int32) if step_ids
            else np.zeros(0, np.int32))
    return np.ascontiguousarray(flat), offsets


def pack_story(step_ids: Sequence[np.ndarray], L: int, pad_id: int
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(input_ids, token_type_ids) of length L from the native packer, or
    None when it is not available."""
    lib = _load()
    if lib is None:
        return None
    flat, offsets = _flatten(step_ids)
    out_ids = np.empty(L, np.int32)
    out_types = np.empty(L, np.int32)
    lib.pack_story(flat, offsets, len(step_ids), L, pad_id, out_ids,
                   out_types)
    return out_ids, out_types


def pack_all_pairs(step_ids: Sequence[np.ndarray], L: int, pad_id: int
                   ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Every ordered pair (i, j), i != j, of the steps, i-major, packed to
    length L: (input_ids (P, L), token_type_ids (P, L), pairs (P, 2)) with
    P = n (n - 1), step i typed 0 and step j 1; None when the packer is not
    available."""
    lib = _load()
    if lib is None:
        return None
    n = len(step_ids)
    P = n * (n - 1)
    flat, offsets = _flatten(step_ids)
    out_ids = np.empty((P, L), np.int32)
    out_types = np.empty((P, L), np.int32)
    out_idx = np.empty((P, 2), np.int32)
    lib.pack_all_pairs(flat, offsets, n, L, pad_id, out_ids.reshape(-1),
                       out_types.reshape(-1), out_idx.reshape(-1))
    return out_ids, out_types, out_idx


def pack_berson(step_ids: Sequence[np.ndarray], label: Sequence[int], L: int,
                pad_id: int
                ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]]:
    """A whole story's BERSON pairs from the native packer: (input_ids
    (P, L), sep_positions (P, 2), pairwise_labels (P,), pairs (P, 2)) with
    P = n (n - 1), `label` the chain (the step at each time); None when the
    packer is not available or the story has more than 64 steps (its
    position table's size)."""
    lib = _load()
    if lib is None or len(step_ids) > 64:
        return None
    n = len(step_ids)
    P = n * (n - 1)
    flat, offsets = _flatten(step_ids)
    out_ids = np.empty((P, L), np.int32)
    out_sep = np.empty((P, 2), np.int32)
    out_plabels = np.empty(P, np.int32)
    out_pairs = np.empty((P, 2), np.int32)
    lib.pack_berson(flat, offsets, n, L, pad_id,
                    np.ascontiguousarray(np.asarray(label, np.int32)),
                    out_ids.reshape(-1), out_sep.reshape(-1), out_plabels,
                    out_pairs.reshape(-1))
    return out_ids, out_sep, out_plabels, out_pairs
