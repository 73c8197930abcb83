"""Build and binding of the CUDA kernels in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>-<hash>.so``
at the repository root, then loaded with ``ctypes``.  The hash covers the
source and the flags, so an edited source is never served from a stale
library.  Nothing is built at import: the first launch on a CUDA tensor
builds (``load``), and ``build`` starts one ``nvcc`` per source, all at
once, for callers that want every kernel ready up front.
``check_operand`` and ``launch`` are the binding side every kernel
wrapper shares: operand validation before a pointer crosses into C, and
the launch on PyTorch's current stream with its CUDA error checked.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

#: --fmad=false keeps every multiply and add separately rounded, as the
#: plain PyTorch versions compute them (parity); -Xptxas -v reports
#: registers, shared memory and spills on stderr
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED: dict = {}


def nvcc() -> str:
    """Path of ``nvcc``; raises when the CUDA toolkit is missing."""
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names) -> dict:
    """Compile every named source that has no current library, one
    ``nvcc`` process each, all started together.  Returns {name: the
    compiler's report} (empty for a library already built); raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    reports, failed = {name: "" for name in names}, []
    for name, (proc, tmp, lib) in procs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{reports[name]}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed
    (once per process: later calls return the loaded library)."""
    if name not in _LOADED:
        lib = library_path(name)
        if not lib.exists():
            build([name])
        _LOADED[name] = ctypes.CDLL(str(lib))
    return _LOADED[name]


def check_operand(t, name, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``; on CUDA it must also be 16-byte aligned (the kernels load
    operands with 16-byte vector loads)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}; the operands are on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned on the card")


def launch(fn, name: str, device, *args) -> None:
    """Call the C launcher ``fn`` on the current stream of ``device`` and
    raise if it reports a CUDA error (a refused launch never runs, and no
    later synchronise would say so)."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
