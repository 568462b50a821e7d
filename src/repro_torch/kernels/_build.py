"""Build and load the port's CUDA kernels.

Each kernel source under ``repro_torch/csrc/`` exposes a plain C
interface.  At first use it is compiled by ``nvcc`` for ``sm_90a`` into
``build/repro_torch_kernels/`` at the root of the checkout, under a name
keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, and loaded with ``ctypes``.
Nothing is built when a module is imported.  A missing ``nvcc`` raises.

``-fmad=false`` is the default: most kernels are held bitwise against
their plain PyTorch versions, which round every product and sum
separately.  The sources in ``FMA_SOURCES`` are held to a stated
tolerance instead and are built without it, so nvcc contracts their
products and sums into FMAs, which halves the instruction count of an
FP32-bound loop.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: sources held to a tolerance, built with nvcc's default FMA contraction.
FMA_SOURCES = frozenset({"flash_attention.cu", "decode_attention.cu",
                         "mlstm_scan.cu"})


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def flags(source: str) -> tuple:
    """The nvcc flags of ``csrc/<source>``."""
    if source in FMA_SOURCES:
        return tuple(f for f in NVCC_FLAGS if f != "-fmad=false")
    return NVCC_FLAGS


def library_path(source: str) -> Path:
    """Where the shared library of ``csrc/<source>`` lives once built,
    keyed by the source, every header of ``csrc/`` (a source may include
    any of them) and its flags."""
    src = CSRC / source
    headers = b"".join(h.name.encode() + h.read_bytes()
                       for h in sorted(CSRC.glob("*.cuh")))
    key = src.read_bytes() + headers + " ".join(flags(source)).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its keyed library exists; returns
    the library path.  The compiler's report (``-Xptxas -v``: registers,
    spills) is kept beside it as ``<name>.log``."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *flags(source), "-o", tmp,
                               str(CSRC / source)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} "
                               f"({proc.returncode}):\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_log(source: str) -> str:
    """The compiler report of the built library of ``csrc/<source>``."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def aligned(x: torch.Tensor, align: int = 16) -> torch.Tensor:
    """``x`` contiguous and ``align``-byte aligned for vector loads (a
    copy only when it is not)."""
    x = x.contiguous()
    return x if x.data_ptr() % align == 0 else x.clone()


def launch(fn, *args, device, name: str) -> None:
    """Call the C entry point ``fn`` with ``args`` and the current stream
    of ``device`` appended; raise if it returns a CUDA error code (a
    refused launch is reported only there)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
