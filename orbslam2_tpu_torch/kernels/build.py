"""Build and load the port's CUDA kernels (`orbslam2_tpu_torch/csrc/*.cu`).

Route: nvcc by hand into one shared library with a plain C interface,
loaded with ctypes. No PyTorch headers are compiled, so a cold build takes
seconds: one nvcc process per source, all started together, then one
link. The library lands in `build/kernels/` at the repository root, keyed
by a hash of the sources and flags, and is built at first use; a failed
build raises with nvcc's output.

Every exported launcher has the signature `int fn(<pointers>, <ints>,
void* stream)` and returns `cudaGetLastError()` right after its launch;
`launch` below raises on a non-zero code. A launcher that takes its
arguments as one struct gets a pointer to a `ctypes.Structure` that
mirrors it; the launcher builds the kernel's parameter struct from it
(the grid layout included) and writes the number of blocks it launched
back into the struct's `n_blocks`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "kernels",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

#: C signatures of the exported launchers: name -> (pointer count, int count)
SIGNATURES = {
    "orb_patch_desc_levels_launch": (1, 0),
    "fast_nms_levels_launch": (1, 0),
    "hamming_best2_launch": (1, 0),
    "bow_transform_launch": (1, 0),
    "pose_lm_launch": (1, 0),
    "select_keypoints_launch": (1, 0),
}

_lock = threading.Lock()
_lib = None
#: seconds the last build (or cache hit) took; read by chip_smoke.py
build_seconds = None
#: ptxas's report of a fresh build (registers, stack frame and spills of
#: every kernel), one line each; empty after a cache hit
ptxas_report: list = []


def _sources():
    return sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(_BUILD_DIR, f"orbslam2_kernels_{h.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cu = [s for s in _sources() if s.endswith(".cu")]
            objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
            compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-Xptxas", "-v"]
            procs = [
                subprocess.Popen([_nvcc(), *compile_flags, "-I", _CSRC, "-c", "-o", o, s],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for s, o in zip(cu, objs)
            ]
            report = []
            try:
                for p in procs:
                    out, err = p.communicate()
                    if p.returncode != 0:
                        raise RuntimeError(f"nvcc failed ({p.returncode}) on {p.args[-1]}:\n{out}\n{err}")
                    report += [f"{os.path.basename(p.args[-1])}: {line.strip()}" for line in err.splitlines()
                               if "entry function" in line or "stack frame" in line or "Used" in line]
                link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs], capture_output=True, text=True)
                if link.returncode != 0:
                    raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                for o in objs:
                    if os.path.exists(o):
                        os.remove(o)
            os.replace(tmp, so)
            ptxas_report[:] = report
        lib = ctypes.CDLL(so)
        for name, (n_ptr, n_int) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = (
                [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
        _lib = lib
        build_seconds = time.perf_counter() - t0
        return lib


def _arg(a):
    import torch

    if isinstance(a, torch.Tensor):
        return a.data_ptr()
    if isinstance(a, ctypes.Structure):
        return ctypes.addressof(a)
    return int(a)


def launch(name: str, *args) -> None:
    """Call launcher `name` with tensors, structs or ints on the current
    CUDA stream; raise if the launch was refused (`cudaGetLastError` != 0)."""
    import torch

    lib = load()
    conv = [_arg(a) for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(*conv, stream)
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}")
