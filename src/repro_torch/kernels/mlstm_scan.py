"""Chunkwise-parallel mLSTM (xLSTM's matrix memory): CUDA wrapper and plain
PyTorch version.

Replaces the reference's Pallas kernel
``repro/kernels/mlstm_scan.py::_mlstm_kernel`` (oracle: the stepwise
``repro/kernels/ref.py::mlstm_ref``).  ``q``, ``k``, ``v``: ``(BH, S,
Dh)`` (q and k pre-scaled), ``li``, ``lf``: ``(BH, S)`` log input and log
forget gates, ``S % L == 0`` for the chunk length ``L = min(chunk, S)``.
Inside a chunk, with ``b`` the cumulative sum of ``lf`` over the chunk
and ``(C0, n0, m0)`` the carried state (zeros at the start, ``m0 = 0``):

    m_t     = max(m0 + b_t, max_{j<=t} (b_t - b_j + li_j))
    scores  = (q k^T)_{tj} * exp(b_t - b_j + li_j - m_t)      (j <= t)
    h_t     = (exp(m0 + b_t - m_t) q_t C0 + sum_j scores_tj v_j)
              / max(|exp(m0 + b_t - m_t) q_t.n0 + sum_j scores_tj|,
                    exp(-m_t))

and the state moves to the chunk's end with ``F = b_{L-1}``,
``m' = max(m0 + F, max_j (F - b_j + li_j))``, weights
``w_j = exp(F - b_j + li_j - m')``, ``C' = exp(m0 + F - m') C0 +
sum_j w_j k_j^T v_j`` and ``n'`` alike.  All math in f32; the output has
``q``'s dtype.

* :func:`mlstm_scan` is the wrapper.  For CUDA tensors it launches the
  kernels of ``repro_torch/csrc/mlstm_scan.cu`` on the current stream (a
  gate pass, a state pass that writes every chunk's starting state into
  scratch the wrapper allocates, and an output pass of two kernels, the
  gated scores and then h; the last two passes run their products on the
  tensor cores in 3xTF32), or raises; for CPU tensors it runs
  :func:`mlstm_scan_plain`.  ``mlstm_scan.launches`` counts calls that
  launched the kernels.  :func:`launch_plan` gives the kernels' grids,
  which cover every row, column and chunk.
* :func:`mlstm_scan_plain` is the chunkwise algorithm above in PyTorch,
  batched over ``BH``.  The kernels are held to it within 1e-4 absolute
  plus 1e-3 relative (the reference's kernel-vs-oracle tolerance).
  ``.calls`` counts its calls.  With ``states=True`` it also returns
  every chunk's starting (C, n, m), what the state pass leaves in the
  kernel's scratch.
* :class:`MLSTMScan` is the models' mLSTM with a gradient: the kernel
  forward (or the plain one on the CPU), keeping those starting states,
  and a backward that replays the model's ``_mlstm_chunk`` chunk by
  chunk in reverse.  The reference has no backward kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, cost

NEG_INF = -1.0e30
DTYPES = (torch.float32, torch.bfloat16)
#: head widths the kernels are compiled for, and the longest chunk.
HEAD_DIMS = (128, 256, 384)
MAX_CHUNK = 256
#: a block's output rows (and rows d of C), keys per score tile, and
#: columns (output or C's e).
ROWS, KEYS, COLS = 64, 64, 128
#: the largest grid y and z of a launch.
MAX_GRID_YZ = 65535

_SOURCE = "mlstm_scan.cu"


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = ctypes.CDLL(str(_build.build(_SOURCE)))
    fn = lib.repro_mlstm_scan
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_void_p] * len(SCRATCH) + [ctypes.c_int64] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, li, lf, chunk: int) -> int:
    """Validate; returns the chunk length L."""
    if q.ndim != 3 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v must all be (BH, S, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if li.shape != q.shape[:2] or lf.shape != q.shape[:2]:
        raise ValueError(f"li and lf must be {tuple(q.shape[:2])}, got "
                         f"{tuple(li.shape)} and {tuple(lf.shape)}")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share a dtype among {DTYPES}")
    if li.dtype not in DTYPES or lf.dtype != li.dtype:
        raise TypeError(f"li and lf must share a dtype among {DTYPES}")
    if len({x.device for x in (q, k, v, li, lf)}) != 1:
        raise ValueError("q, k, v, li and lf must lie on one device")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"mlstm_scan runs on cuda or cpu tensors (or meta "
                         f"ones, for shapes), not {q.device}")
    S = q.shape[1]
    L = min(int(chunk), S)
    if L <= 0 or S % L:
        raise ValueError(f"S = {S} must be a multiple of the chunk {L}")
    return L


def gate_runs(L: int) -> list:
    """The run ``[lo, hi)`` of a chunk's L rows that each of the 32 lanes
    of a gates warp sums serially before the warp scan."""
    per = -(-L // 32)
    return [(min(lane * per, L), min(lane * per + per, L))
            for lane in range(32)]


def launch_plan(BH: int, S: int, Dh: int, L: int) -> dict:
    """The grids (x, y, z) of the passes' kernels.  gates: a block per
    bh, a warp per chunk.  state: a block per (``ROWS`` rows d, ``COLS``
    columns e, bh).  The output pass: scores, a block per (row tile of
    ``ROWS``, heaviest first), chunk, bh, walking the key tiles of ``KEYS``
    up to its last row; output, a block per (row tile, ``COLS`` columns;
    x), chunk, bh, walking the scores in slabs of 32 keys."""
    nc = S // L
    row_tiles = -(-L // ROWS)
    return {"gates": (BH, 1, 1), "state": (Dh // ROWS, Dh // COLS, BH),
            "scores": (row_tiles, nc, BH),
            "output": (row_tiles * (Dh // COLS), nc, BH),
            "row_tiles": row_tiles, "slices": Dh // COLS}


def output_tile(plan: dict, x: int) -> tuple:
    """(first row, first column) of the output block ``x`` of ``plan``."""
    slices = plan["slices"]
    return ((plan["row_tiles"] - 1 - x // slices) * ROWS,
            (x % slices) * COLS)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               li: torch.Tensor, lf: torch.Tensor, *,
               chunk: int = 256) -> torch.Tensor:
    """Returns ``h`` of shape ``(BH, S, Dh)`` in ``q``'s dtype."""
    L = _check(q, k, v, li, lf, chunk)
    work = lambda: cost.mlstm_work(*q.shape, L, q.dtype, li.dtype)
    with cost.unit("mlstm_scan", work, (q, k, v, li, lf)):
        if cost.shape_only(q):
            return torch.empty_like(q)
        if q.device.type == "cpu":
            return mlstm_scan_plain(q, k, v, li, lf, chunk=chunk)
        return _kernel(q, k, v, li, lf, L)


#: the scratch tensors of the C entry, in its order.
SCRATCH = ("C", "n", "m", "decay", "b", "w", "li32", "Sg", "mt")
#: the passes of the C entry, as its bit mask.
GATES, STATE, OUTPUT = 1, 2, 4
ALL_PASSES = GATES | STATE | OUTPUT


def _kernel(q, k, v, li, lf, L: int) -> torch.Tensor:
    """Allocate the output and scratch and launch the three passes on the
    inputs' device."""
    out, _ = launch_passes(q, k, v, li, lf, L, ALL_PASSES)
    mlstm_scan.launches += 1
    return out


def launch_passes(q, k, v, li, lf, L: int, passes: int, scratch=None):
    """Launch the passes in the bit mask ``passes`` (``GATES``, ``STATE``,
    ``OUTPUT``) on CUDA tensors; returns ``(out, scratch)``.  A pass
    alone reads what the passes before it left in ``scratch`` (a dict
    from an earlier call): this is for timing one pass, and counts no
    launch."""
    BH, S, Dh = q.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"the kernels take Dh in {HEAD_DIMS}, got {Dh}")
    if L > MAX_CHUNK:
        raise ValueError(f"the kernels take chunks of at most {MAX_CHUNK}, "
                         f"got {L}")
    plan = launch_plan(BH, S, Dh, L)
    if max(max(plan[p][1:]) for p in ("state", "scores", "output")) \
            > MAX_GRID_YZ:
        raise ValueError(f"the kernels take BH and S / L of at most "
                         f"{MAX_GRID_YZ}, got {BH} and {S // L}")
    q, k, v = (_build.aligned(x) for x in (q, k, v))
    li, lf = li.contiguous(), lf.contiguous()
    nc = S // L
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    if scratch is None:
        # every chunk's starting C (as C^T), n and m (and the last chunk's
        # m'); the chunk's decay; the cumulative forget gates b, the
        # state-update weights w, li in f32; the gated scores of every
        # chunk (rows of L rounded up to 4) and every row's m_t.
        LP = -(-L // 4) * 4
        shapes = {"C": (BH, nc, Dh, Dh), "n": (BH, nc, Dh), "m": (BH, nc + 1),
                  "decay": (BH, nc), "b": (BH, S), "w": (BH, S),
                  "li32": (BH, S), "Sg": (BH, nc, L, LP), "mt": (BH, S)}
        scratch = {x: torch.empty(shapes[x], **f32) for x in SCRATCH}
    _build.launch(load_library().repro_mlstm_scan,
                  int(q.dtype == torch.bfloat16),
                  int(li.dtype == torch.bfloat16),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
                  lf.data_ptr(), out.data_ptr(),
                  *(scratch[x].data_ptr() for x in SCRATCH),
                  BH, S, Dh, L, passes, device=q.device, name="mlstm_scan")
    return out, scratch


mlstm_scan.launches = 0


def mlstm_scan_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     li: torch.Tensor, lf: torch.Tensor, *,
                     chunk: int = 256, states: bool = False):
    """The chunkwise algorithm in PyTorch (any device).  With ``states``
    it returns ``(h, (C, n, m))`` with every chunk's starting state, f32:
    C ``(BH, S/L, Dh, Dh)``, n ``(BH, S/L, Dh)``, m ``(BH, S/L)`` (what the
    kernel's state pass leaves in its scratch, C there as C^T)."""
    mlstm_scan_plain.calls += 1
    L = _check(q, k, v, li, lf, chunk)
    BH, S, Dh = q.shape
    f32, dtype = torch.float32, q.dtype
    q, k, v, li, lf = (x.to(f32) for x in (q, k, v, li, lf))
    C = q.new_zeros((BH, Dh, Dh))
    n = q.new_zeros((BH, Dh))
    m = q.new_zeros((BH,))
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    out = torch.empty((BH, S, Dh), dtype=f32, device=q.device)
    starts = []
    for c0 in range(0, S, L):
        if states:
            starts.append((C, n, m))
        sl = slice(c0, c0 + L)
        qc, kc, vc, lic = q[:, sl], k[:, sl], v[:, sl], li[:, sl]
        b = torch.cumsum(lf[:, sl], dim=1)                  # (BH, L)
        F = b[:, -1]
        intra = b[:, :, None] - b[:, None, :] + lic[:, None, :]
        intra = torch.where(causal, intra, NEG_INF)
        m_inter = m[:, None] + b
        m_t = torch.clamp_min(torch.maximum(m_inter, intra.amax(-1)),
                              NEG_INF)
        g = torch.exp(m_inter - m_t)                        # (BH, L)
        w_intra = torch.where(causal, torch.exp(intra - m_t[..., None]), 0.0)
        scores = torch.matmul(qc, kc.transpose(1, 2)) * w_intra
        h_num = (g[..., None] * torch.matmul(qc, C)
                 + torch.matmul(scores, vc))
        n_t = g * torch.matmul(qc, n[:, :, None])[..., 0] + scores.sum(-1)
        denom = torch.maximum(n_t.abs(), torch.exp(-m_t))
        out[:, sl] = h_num / denom[..., None]

        s_exp = F[:, None] - b + lic
        m_next = torch.maximum(m + F, s_exp.amax(-1))
        decay = torch.exp(m + F - m_next)
        kw = kc * torch.exp(s_exp - m_next[:, None])[..., None]
        C = decay[:, None, None] * C + torch.matmul(kw.transpose(1, 2), vc)
        n = decay[:, None] * n + kw.sum(1)
        m = m_next
    if states:
        return out.to(dtype), tuple(torch.stack(x, dim=1)
                                    for x in zip(*starts))
    return out.to(dtype)


mlstm_scan_plain.calls = 0


class MLSTMScan(torch.autograd.Function):
    """The mLSTM from zero state with a gradient, in the model layout: q,
    k, v ``(B, H, S, Dh)``, li, lf ``(B, H, S)``, all f32.

    Forward: on CUDA the kernel's three passes (``launch_passes``, counted
    in ``mlstm_scan.launches``), keeping from its scratch every chunk's
    starting C (stored as C^T; transposed back as a view), n and m; on the
    CPU :func:`mlstm_scan_plain` with ``states=True``.  Returns ``h`` and,
    as outputs without a gradient, the last chunk's starting ``(C, n,
    m)``.

    Backward: a reverse loop over chunks.  At chunk c it replays the
    model's ``_mlstm_chunk`` from the saved state_c and takes its
    vector-Jacobian product with the cotangents (dh_c, dstate_{c+1}); the
    last chunk's dstate is zero.  That yields the chunk's input gradients
    and dstate_c: the recompute of the reference's
    ``jax.checkpoint(_mlstm_chunk)`` under ``lax.scan``, started from the
    forward's states instead of a rerun of the scan.  The reference has no
    backward kernel, and neither does this (ROADMAP Queue B)."""

    @staticmethod
    def forward(ctx, q, k, v, li, lf, chunk: int):
        B, H, S, Dh = q.shape
        fold = lambda t: t.reshape(B * H, *t.shape[2:])
        L = _check(fold(q), fold(k), fold(v), fold(li), fold(lf), chunk)
        nc = S // L
        work = lambda: cost.mlstm_work(B * H, S, Dh, L, q.dtype, li.dtype)
        with cost.unit("mlstm_scan", work, (q, k, v, li, lf)):
            if cost.shape_only(q):
                f32 = dict(dtype=torch.float32, device=q.device)
                h = torch.empty((B * H, S, Dh), dtype=q.dtype,
                                device=q.device)
                C = torch.empty((B * H, nc, Dh, Dh), **f32)
                n = torch.empty((B * H, nc, Dh), **f32)
                m = torch.empty((B * H, nc), **f32)
            elif q.device.type == "cpu":
                h, (C, n, m) = mlstm_scan_plain(fold(q), fold(k), fold(v),
                                                fold(li), fold(lf), chunk=L,
                                                states=True)
            else:
                h, scratch = launch_passes(fold(q), fold(k), fold(v),
                                           fold(li), fold(lf), L, ALL_PASSES)
                mlstm_scan.launches += 1
                C = scratch["C"].transpose(-1, -2)
                n, m = scratch["n"], scratch["m"][:, :nc]
        C, n, m = (C.reshape(B, H, nc, Dh, Dh), n.reshape(B, H, nc, Dh),
                   m.reshape(B, H, nc))
        ctx.save_for_backward(q, k, v, li, lf, C, n, m)
        ctx.L = L
        last = (C[:, :, -1], n[:, :, -1], m[:, :, -1])
        ctx.mark_non_differentiable(*last)
        return (h.reshape(B, H, S, Dh),) + last

    @staticmethod
    def backward(ctx, dh, *_):
        from ..models.recurrent import MLSTMState, _mlstm_chunk
        q, k, v, li, lf, C, n, m = ctx.saved_tensors
        L = ctx.L
        grads = [torch.zeros_like(x) for x in (q, k, v, li, lf)]
        dstate = None
        for c in reversed(range(q.shape[2] // L)):
            sl = slice(c * L, (c + 1) * L)
            with torch.enable_grad():
                ins = [x[:, :, sl].detach().requires_grad_()
                       for x in (q, k, v, li, lf)]
                st = [x[:, :, c].detach().requires_grad_(c > 0)
                      for x in (C, n, m)]
                h, new = _mlstm_chunk(*ins, MLSTMState(*st))
                outs, cots = [h], [dh[:, :, sl]]
                if dstate is not None:
                    outs += list(new)
                    cots += dstate
                wrt = ins + (st if c > 0 else [])
                got = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
            got = [torch.zeros_like(w) if g is None else g
                   for g, w in zip(got, wrt)]
            for g_all, g in zip(grads, got[:5]):
                g_all[:, :, sl] = g
            dstate = got[5:]
        return (*grads, None)
