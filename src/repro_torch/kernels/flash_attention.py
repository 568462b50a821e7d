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
* :class:`FlashAttention` is attention with a gradient: its forward is
  :func:`flash_attention` (the kernel on CUDA, the plain version on the
  CPU), its backward a blocked one in PyTorch (:func:`flash_backward`),
  the same code on both devices.  The reference has no backward kernel:
  its gradient is XLA's autodiff of attention written in jnp.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, cost

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
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors (or "
                         f"meta ones, for shapes), not {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mode: str = "causal", window: int = 0,
                    chunk: int = 0) -> torch.Tensor:
    """q: (BH, Sq, Dh), k/v: (BH, Skv, Dh).  Returns (BH, Sq, Dh) in
    ``q``'s dtype."""
    _check(q, k, v, mode, chunk)
    work = lambda: cost.flash_work(q.shape[0], q.shape[1], k.shape[1],
                                   q.shape[2], q.dtype, mode, window, chunk)
    with cost.unit("flash_attention", work, (q, k, v)):
        if cost.shape_only(q):
            return torch.empty_like(q)
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
            device, q0: int = 0, k0: int = 0) -> torch.Tensor:
    """The (Sq, Skv) boolean mask of ``mode`` over query rows ``q0 ..
    q0 + Sq - 1`` and keys ``k0 .. k0 + Skv - 1``."""
    jq = torch.arange(q0, q0 + Sq, device=device)[:, None]
    jk = torch.arange(k0, k0 + Skv, device=device)[None, :]
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


#: f32 elements of one (BH, rows, keys) tensor of a backward block: the
#: block takes as many query rows (a power of two, at least
#: ``MIN_BLOCK_ROWS``) as keep it within this; a block holds about five
#: such tensors at once (scores, weights, their gradient, masks), ~0.7 GB.
BWD_BLOCK_ELEMS = 2 ** 25
MIN_BLOCK_ROWS = 16


def key_range(mode: str, i0: int, i1: int, Skv: int, window: int,
              chunk: int) -> tuple:
    """The keys ``[k0, k1)`` that query rows ``[i0, i1)`` may attend: all
    for ``bidir``, up to the last row for ``causal``, the band of
    ``window`` keys for ``sliding``, from the first row's chunk for
    ``chunked``."""
    k1 = Skv if mode == "bidir" else min(i1, Skv)
    if mode == "sliding":
        k0 = max(0, i0 - window + 1)
    elif mode == "chunked":
        k0 = (i0 // chunk) * chunk
    else:
        k0 = 0
    return k0, max(k0, k1)


def block_rows(BH: int, Sq: int, band: int) -> int:
    """Query rows a backward block takes (see ``BWD_BLOCK_ELEMS``)."""
    rows = max(1, BWD_BLOCK_ELEMS // max(1, BH * band))
    rows = max(MIN_BLOCK_ROWS, 1 << (rows.bit_length() - 1))
    return min(rows, Sq)


def flash_backward(q, k, v, dout, *, mode: str, window: int = 0,
                   chunk: int = 0) -> tuple:
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention_plain`'s
    function, in the inputs' dtype, computed in f32 one block of
    :func:`block_rows` query rows at a time, so that no (Sq, Skv) tensor
    exists.  A block recomputes its masked scores against the keys
    its rows may attend (:func:`key_range`, masked by :func:`allowed`) and
    the normalised weights P, then ``dV += P^T dO``, ``dP = dO V^T``,
    ``D = rowsum(dO * O)``, ``dS = P * (dP - D)``, ``dQ = dS K * scale``
    and ``dK += dS^T Q * scale``.  D is summed as ``rowsum(P * dP)``, the
    same sum with the block's f32 output (O = P V) in place of the
    forward's, which bf16 rounds."""
    _check(q, k, v, mode, chunk)
    f32 = torch.float32
    BH, Sq, Dh = q.shape
    Skv = k.shape[1]
    scale = torch.tensor(Dh ** -0.5, dtype=f32).to(q.device)
    kf, vf, dof = k.to(f32), v.to(f32), dout.to(f32)
    dq = torch.zeros((BH, Sq, Dh), dtype=f32, device=q.device)
    dk = torch.zeros((BH, Skv, Dh), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    band = {"sliding": window, "chunked": chunk}.get(mode, Skv)
    rows = block_rows(BH, Sq, min(Skv, band))
    for i0 in range(0, Sq, rows):
        i1 = min(Sq, i0 + rows)
        k0, k1 = key_range(mode, i0, i1, Skv, window, chunk)
        if k0 == k1:
            continue
        allow = allowed(mode, i1 - i0, k1 - k0, window, chunk, q.device,
                        q0=i0, k0=k0)
        qs = q[:, i0:i1].to(f32) * scale
        kb, vb, do = kf[:, k0:k1], vf[:, k0:k1], dof[:, i0:i1]
        s = torch.where(allow, torch.matmul(qs, kb.transpose(1, 2)),
                        NEG_INF)
        p = torch.where(allow, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        del s
        p = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
        dv[:, k0:k1] += torch.matmul(p.transpose(1, 2), do)
        dp = torch.matmul(do, vb.transpose(1, 2))
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        del p, dp
        dq[:, i0:i1] = torch.matmul(ds, kb) * scale
        dk[:, k0:k1] += torch.matmul(ds.transpose(1, 2), qs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient over the flat-head layout: q ``(BH, Sq,
    Dh)``, k, v ``(BH, Skv, Dh)``.  Forward: :func:`flash_attention` (the
    kernel on CUDA, counted in ``flash_attention.launches``; the plain
    version on the CPU).  Backward: :func:`flash_backward` from the saved
    q, k and v, on either device; it launches no kernel of this module."""

    @staticmethod
    def forward(ctx, q, k, v, mode: str = "causal", window: int = 0,
                chunk: int = 0):
        out = flash_attention(q, k, v, mode=mode, window=window,
                              chunk=chunk)
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(mode=mode, window=window, chunk=chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*flash_backward(q, k, v, dout, **ctx.args), None, None,
                None)
