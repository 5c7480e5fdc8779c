"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` in its own process, all
started together, and the objects link into one shared library with a
plain C interface that ``ctypes`` loads. The library lives under
``build/kernels-<hash of the sources and flags>/`` in the checkout, so a
changed source rebuilds and an unchanged one is reused. Nothing here runs at import time: the first CUDA launch
builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("cosine_sim.cu", "segment_aggregate.cu", "decode_attention.cu", "sketch_project.cu")
HEADERS = ("common.cuh",)
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libauxo_kernels.so"

_lib: Optional[ctypes.CDLL] = None
# what the last build printed (ptxas register / shared-memory report);
# None when the library was reused
build_log: Optional[str] = None


BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for s in SOURCES + HEADERS:
        h.update(s.encode())
        h.update((CSRC / s).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global build_log
    out_dir = BUILD_ROOT / f"kernels-{_digest()}"
    so = out_dir / LIB_NAME
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs: List[Path] = []
    procs = []
    for s in SOURCES:
        obj = out_dir / f"{Path(s).stem}.{os.getpid()}.o"
        objs.append(obj)
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(CSRC / s), "-o", str(obj)]
        procs.append(
            (s, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        )
    logs = []
    failed = []
    for s, p in procs:
        out, _ = p.communicate()
        logs.append(f"--- {s}\n{out}")
        if p.returncode != 0:
            failed.append(s)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent builder sees all or nothing
    for o in objs:
        o.unlink(missing_ok=True)
    build_log = "\n".join(logs)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.auxo_cosine_similarity.argtypes = [vp, vp, vp] + [ci] * 5 + [cf, ci, ci, vp]
        lib.auxo_cosine_similarity.restype = ci
        lib.auxo_segment_aggregate.argtypes = [vp] * 4 + [ci] * 11 + [vp]
        lib.auxo_segment_aggregate.restype = ci
        lib.auxo_decode_attention.argtypes = [vp] * 6 + [ci] * 5 + [cl] * 4 + [ci, ci, ci, vp]
        lib.auxo_decode_attention.restype = ci
        lib.auxo_sketch_project.argtypes = [vp, ci, cl, ci, cl, ci, ci, ctypes.c_uint, ci, vp, cf, vp, vp]
        lib.auxo_sketch_project.restype = ci
        lib.auxo_decode_blocks_per_sm.argtypes = [ci, ci, ci]
        lib.auxo_decode_blocks_per_sm.restype = ci
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def function(name: str):
    """One C entry point of the library, with its argtypes, resolved once."""
    return getattr(library(), name)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device ``index``, read once."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(fn, device, *args) -> int:
    """Call C entry ``fn`` with ``args`` and PyTorch's current stream of
    ``device`` last; the ``torch.cuda.device`` context is entered only when
    ``device`` is not the current device."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
