"""Flash attention: CUDA wrapper and plain PyTorch version.

Replaces the reference's Pallas kernel
``repro/kernels/flash_attention.py::_flash_kernel`` (oracle
``repro/kernels/ref.py::attention_ref``): online-softmax attention over
the flat-head layout ``(BH, S, Dh)`` with a causal, sliding-window
(``window``), chunked-local (``chunk``) or bidirectional mask, in f32
with the output in ``q``'s dtype.  Row ``i`` may attend to key ``j`` when

* ``bidir``: always;
* ``causal``: ``j <= i``;
* ``sliding``: ``i - window < j <= i``;
* ``chunked``: ``j <= i`` and ``j // chunk == i // chunk``.

``q`` is scaled by ``float32(Dh ** -0.5)`` before the dot, as on the TPU;
a masked score is ``-1e30`` and its weight exactly 0, and the sum of
weights is floored at 1e-30 (a row with no allowed key gives zeros).

* :func:`flash_attention` is the wrapper.  For CUDA tensors it launches
  a kernel of ``repro_torch/csrc/flash_attention.cu`` on the current
  stream, or raises; for CPU tensors it runs
  :func:`flash_attention_plain`.  The dtype picks the kernel: bf16 runs
  both products on the tensor cores (wgmma fed by TMA; the scores are
  scaled in f32 after an unscaled bf16 Q K^T, and P is rounded to bf16
  for P V), f32 runs them on the CUDA cores in f32.
  ``flash_attention.launches`` counts kernel launches.
* :func:`flash_attention_plain` computes the same function with the
  scores materialized (one block of the online softmax).  The kernel is
  held to it within 2e-5 in f32 (the reference's kernel-vs-oracle
  tolerance; its sums run in another order) and, in bf16, within
  4e-3 + 1e-2 relative and a relative Frobenius error of 4e-3: the bf16
  weights of P V put it about 2e-3 (Frobenius) from the plain version.
  ``.calls`` counts its calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

NEG_INF = -1.0e30
MODES = ("causal", "sliding", "chunked", "bidir")
DTYPES = (torch.float32, torch.bfloat16)
#: head widths the kernel is compiled for.
HEAD_DIMS = (64, 128, 256)

_SOURCE = "flash_attention.cu"


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(str(_build.build(_SOURCE)))
    fn = lib.repro_flash_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int64] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, mode: str, chunk: int) -> None:
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"q must be (BH, Sq, Dh) and k, v (BH, Skv, Dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in BH or Dh")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share a dtype among {DTYPES}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "chunked" and chunk <= 0:
        raise ValueError(f"chunked attention needs chunk > 0, got {chunk}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not "
                         f"{q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mode: str = "causal", window: int = 0,
                    chunk: int = 0) -> torch.Tensor:
    """q: (BH, Sq, Dh), k/v: (BH, Skv, Dh).  Returns (BH, Sq, Dh) in
    ``q``'s dtype."""
    _check(q, k, v, mode, chunk)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mode=mode, window=window,
                                     chunk=chunk)
    return _kernel(q, k, v, mode, window, chunk)


def _kernel(q, k, v, mode: str, window: int, chunk: int) -> torch.Tensor:
    """Allocate the output and launch the kernel on the inputs' device."""
    BH, Sq, Dh = q.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"the kernel takes Dh in {HEAD_DIMS}, got {Dh}")
    q, k, v = (_build.aligned(x) for x in (q, k, v))
    out = torch.empty_like(q)
    bf16 = int(q.dtype == torch.bfloat16)   # 1: the wgmma kernel
    _build.launch(load_library().repro_flash_attention,
                  bf16, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), BH, Sq, k.shape[1], Dh,
                  MODES.index(mode), int(window), int(chunk), Dh ** -0.5,
                  device=q.device, name="flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def allowed(mode: str, Sq: int, Skv: int, window: int, chunk: int,
            device) -> torch.Tensor:
    """The (Sq, Skv) boolean mask of ``mode``."""
    jq = torch.arange(Sq, device=device)[:, None]
    jk = torch.arange(Skv, device=device)[None, :]
    if mode == "bidir":
        return torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    m = jk <= jq
    if mode == "sliding":
        m &= jk > jq - window
    elif mode == "chunked":
        m &= (jk // chunk) == (jq // chunk)
    return m


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, mode: str = "causal", window: int = 0,
                          chunk: int = 0) -> torch.Tensor:
    """The kernel's function in PyTorch (any device), scores materialized."""
    flash_attention_plain.calls += 1
    _check(q, k, v, mode, chunk)
    Sq, Dh = q.shape[1], q.shape[2]
    f32 = torch.float32
    allow = allowed(mode, Sq, k.shape[1], window, chunk, q.device)
    scale = torch.tensor(Dh ** -0.5, dtype=f32)
    s = torch.matmul(q.to(f32) * scale.to(q.device), k.to(f32).transpose(1, 2))
    s = torch.where(allow, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(allow, torch.exp(s - m), 0.0)
    l = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    return (torch.matmul(p, v.to(f32)) / l).to(q.dtype)


flash_attention_plain.calls = 0
