"""Build ``csrc/*.cu`` into one shared library at first use and load it.

The kernels have a plain C interface (no PyTorch headers), so ``nvcc``
builds each file in seconds.  Every source is compiled by an ``nvcc`` of its
own, all started together, and the objects are linked into one library in
``<repo>/build/torch_kernels/<hash>/``, keyed by a hash of the sources and
the flags, which is loaded with ``ctypes``.  Each C entry returns the
``cudaError_t`` of its launches, which the wrappers in ``ops/kernels.py``
and ``probes/kernels.py`` turn into an exception.

No ``--use_fast_math``: the LR check needs IEEE f32 subtraction and
``truncf``, and the speckle test IEEE ``fabsf(a - b) <= diff``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libsgm_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argtypes (pointers and the stream as c_void_p, ints as c_int)
SIGNATURES = {
    "sgm_census_cost": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "sgm_census_cost_plan": (_I, _I, _I, _P),
    "sgm_scan_direction": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _P),
    "sgm_scan_group": (_P,) * 7 + (_I,) * 15 + (_P,),
    "sgm_scan_group_capacity": (_P, _P, _I, _I, _I, _I, _I, _P),
    "sgm_scan_group_plan": (_P, _P) + (_I,) * 7 + (_P,),
    "sgm_wta_reduce": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "sgm_lr_check": (_P, _P, _P, _I, _I, _I, _F, _I, _P),
    "sgm_remove_speckles": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    "sgm_speckle_union_labels": (_P, _P, _I, _I, _I, _F, _P),
    "sgm_speckle_count_verdict": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "sgm_probe_chain": (_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P),
    "sgm_probe_chainio": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I,
                          _I, _P),
    "sgm_volume_transpose": (_P, _P) + (_I,) * 7 + (_P,),
    "sgm_path_scan": (_P, _P, _P) + (_I,) * 6 + (_P,),
    "sgm_path_scan_plan": (_I,) * 3 + (_P,),
    "sgm_probe_rung": (_P, _P, _I, _I, _I, _I, _P),
    "sgm_probe_scan16": (_P, _P, _P) + (_I,) * 13 + (_P,),
    "sgm_probe_scan16_capacity": (_I, _I, _I, _P),
    "sgm_probe_speckle_labels": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    "sgm_probe_speckle_hist": (_P, _P, _I, _I, _I, _I, _P),
    "sgm_probe_speckle_verdict": (_P, _P, _P, _I, _I, _I, _P),
    "sgm_probe_speckle_fused": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "sgm_probe_speckle_fused_plan": (_I, _I, _I, _P),
}

_lib = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA kernels "
            "of soc_project_stereo_matching_tpu_torch cannot be built")
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / digest.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels unless this exact build exists; return its path."""
    target = library_path()
    if target.exists():
        return target
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        jobs = []
        for src in (s for s in sources() if s.suffix == ".cu"):
            obj = str(Path(tmp) / (src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, _, proc in jobs]          # waits for every nvcc
        for cmd, log, code in logs:
            if code != 0:
                raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{log}")
        lib = str(Path(tmp) / LIB_NAME)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
               *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(lib, target)
    return target


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
