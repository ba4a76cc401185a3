"""Build the CUDA kernels in `csrc/` with nvcc, and the host C++ in
`csrc/` with g++, and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes); each `csrc/<name>.cpp` (the native graph matcher, the PNG
row unfilter, the JPEG decoder and writer, the record cache, the zstd
decoder) compiles with the
host compiler, `g++ -O3 -shared -fPIC -std=c++17`. Libraries go into
`build/cvpce_tpu_torch/` at the repository root (listed in .gitignore;
`CVPCE_TORCH_BUILD_DIR` overrides it), named by a hash of the source
and the flags, so a library is rebuilt only when either changes.
Pointers and the stream pass as `ctypes.c_void_p`; every C launch entry
point returns `cudaGetLastError()`, and the op modules raise on a
non-zero code with the library's `*_error_string`.

Nothing here runs at import time: the first call of `load(name)` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("nms_hard", "knn_fused", "soft_nms", "pool_int8_conv")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
# per-source extra flags: the NMS IoUs and Soft-NMS decays must round
# exactly as the plain torch versions do, so no multiply-add contraction;
# the record cache's reader runs a thread pool
EXTRA_FLAGS: Dict[str, List[str]] = {"nms_hard": ["-fmad=false"],
                                     "soft_nms": ["-fmad=false"],
                                     "record_cache": ["-pthread"]}

_LIBS: Dict[str, ctypes.CDLL] = {}
# one build at a time in a process: loader threads decode images at once
_LOCK = threading.Lock()
# name -> {"seconds": build time (0.0 when cached), "log": nvcc output}
BUILD_INFO: Dict[str, Dict] = {}


def build_dir() -> Path:
    env = os.environ.get("CVPCE_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "cvpce_tpu_torch"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")


def gxx_path() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found on PATH")


def _source(name: str) -> Path:
    """`csrc/<name>.cu` for a kernel, else `csrc/<name>.cpp`."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(name: str) -> List[str]:
    if _source(name).suffix == ".cpp":
        return HOST_FLAGS + EXTRA_FLAGS.get(name, [])
    return ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS.get(name, [])


def _compiler(name: str) -> str:
    return gxx_path() if _source(name).suffix == ".cpp" else nvcc_path()


def _lib_path(name: str) -> Path:
    src = _source(name).read_bytes()
    digest = hashlib.sha256(
        src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{digest}.so"


def _build(name: str) -> Path:
    out = _lib_path(name)
    if out.exists():
        BUILD_INFO[name] = {"seconds": 0.0, "log": "cached"}
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_compiler(name), *_flags(name), "-o", str(tmp),
           str(_source(name))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed for {name} "
                           f"(rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": seconds, "log": log}
    return out


def build_all() -> Dict[str, Dict]:
    """Build every kernel library, one nvcc process per source, all
    started together. Returns BUILD_INFO."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build, KERNELS))
    return BUILD_INFO


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name` (a kernel, or one of the host
    sources: `graph_match`, `png_unfilter`, `jpeg_decode`,
    `jpeg_encode`, `record_cache`, `zstd_decode`), built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_build(name)))
                _LIBS[name] = lib
    return lib


def stream_ptr(tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device, as a pointer."""
    import torch

    return ctypes.c_void_p(
        torch.cuda.current_stream(tensor.device).cuda_stream)
