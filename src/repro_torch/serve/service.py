"""The advisor: fingerprint cache in front of micro-batched grid solves.

:class:`AdvisorService` is the in-process query engine.  One
``advise_many`` call is one admission window: every request is
fingerprinted (``serve.fingerprint``), hits are answered from the cache,
and ALL misses collapse into one ``evaluate_grid`` call (plus at most one
``evaluate_multilevel_grid`` call when the window contains two-tier
requests) on the service's device — the solve cost of a window is
bounded by the number of DISTINCT platforms in it, not the number of
requests.  Each solve's results come back to the host in one copy, and
the answers are built from numpy (one device sync a solve, not one a
field a lane).

Answer semantics (what the tests pin down):

* Every cache entry is the exact solve of its cell's lattice
  representative, so all requests sharing a fingerprint get bit-identical
  numbers — hit or miss, batched or sequential, any batch composition
  (the sweep and the certificate are elementwise, so batch shape is a
  bit-exact no-op).
* An entry is only served if its certified degradation bound (the
  sandwich lemma of ``serve.fingerprint``) is within ``quant.tol``;
  otherwise the request is solved on its EXACT parameters (one more
  batched call per window, shared by all fallback requests) and cached
  under a zero-width key.  Degenerate/uncertifiable cells therefore
  always get exact-parameter answers.

:class:`ThreadedAdvisor` wraps a service with a submission queue and a
worker thread that admission-batches concurrent callers behind a small
batch window — the serving shape the open-loop load generator
(``serve.loadgen``) drives.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from time import monotonic
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import F64, resolve_device
from ..sim import dispatch as _dispatch
from ..sim import sweep as _sweep
from . import batcher as _batcher
from .fingerprint import (Quantization, certified_bound_multilevel,
                          certified_bound_single, exact_fingerprint,
                          quantize_request, quantized_key)
from .schema import Advice, AdviceRequest, store_recommendation

#: default fingerprint-cache capacity (entries are a few hundred bytes).
FINGERPRINT_CACHE_SIZE = 4096


@dataclasses.dataclass(frozen=True)
class _Entry:
    """One cached answer (always at ``T_base = 1``)."""

    valid: bool
    certified: bool
    exact: bool
    cert_bound: float
    T_time: float
    T_energy: float
    m_time: int
    m_energy: int
    Tf_time: float
    Tf_energy: float
    E_time: float
    E_energy: float
    vs_single_time: float
    vs_single_energy: float


class AdvisorService:
    """In-process checkpoint advisor (see module docstring).

    ``quantization`` sets the cache lattice and tolerance
    (:class:`~repro_torch.serve.fingerprint.Quantization`); ``dispatch``
    is the execution config threaded to the sweep layer (None =
    environment defaults); ``precision`` is the sweep precision policy
    (None resolves via the dispatch config / ``$REPRO_PRECISION`` / the
    device's default: the f64 oracle on the CPU, compensated f32 on CUDA)
    — a non-exact policy's ``objective_tol`` is folded into every
    certified bound; ``cache_name`` registers the fingerprint cache with
    ``sim.cache_stats`` (one registry slot per name — the last service
    created under a name owns the slot).  ``device`` is where the grids
    live and the solves and certificates run (default ``"cuda"``; raises
    without a GPU); every call names it, so a worker thread needs no
    ``torch.cuda.set_device``.

    ``timings``: None, or a dict to which every window adds the host-clock
    seconds of its parts (``fingerprint``, ``grids``, ``solve_single``,
    ``solve_ml``, ``certificate``, ``readback``, ``advice``), the device
    synchronised at each boundary; None costs nothing.

    Thread-safe: ``advise_many`` holds an internal lock, so concurrent
    direct callers serialize.  For concurrency WITH admission batching,
    front it with :class:`ThreadedAdvisor`.
    """

    def __init__(self, quantization: Optional[Quantization] = None,
                 cache_size: int = FINGERPRINT_CACHE_SIZE,
                 dispatch=None, precision=None,
                 cache_name: Optional[str] = "serve.fingerprints",
                 device="cuda"):
        self.quant = quantization if quantization is not None \
            else Quantization()
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # pin the index here: a worker thread's current device is its
            # own, not the constructing thread's
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.cache = _dispatch.LRUCache(cache_size, name=cache_name)
        self.dispatch = dispatch
        # Resolved once at construction so every solve this service issues
        # runs under ONE policy (entries cache objective values; mixing
        # policies across windows would mix tolerances in the cache).
        self.precision = _dispatch.resolve_precision(dispatch, precision,
                                                     dev)
        self.timings: Optional[Dict[str, float]] = None
        self._lock = threading.Lock()
        self._counters = {
            "requests": 0,          # requests answered
            "batches": 0,           # advise_many admission windows
            "dispatched_solves": 0,  # batched sweep calls issued
            "solved_lanes": 0,      # grid lanes across those calls
            "fallback_requests": 0,  # requests served via the exact path
        }

    # -- public API ----------------------------------------------------------
    def advise(self, req: AdviceRequest) -> Advice:
        """Answer one request (a batch of one)."""
        return self.advise_many([req])[0]

    def advise_many(self, reqs: Sequence[AdviceRequest]) -> List[Advice]:
        """Answer a whole admission window; one batched solve per shape."""
        with self._lock:
            return self._advise_many(list(reqs))

    def metrics(self) -> Dict:
        """Service counters + fingerprint/runner cache statistics."""
        with self._lock:
            out = dict(self._counters)
        out["fingerprint_cache"] = dict(self.cache.stats.snapshot(),
                                        size=len(self.cache),
                                        maxsize=self.cache.maxsize)
        out["caches"] = _dispatch.cache_stats()
        out["precision_policy"] = self.precision.name
        return out

    # -- pipeline ------------------------------------------------------------
    def _lap(self, part: str, t0: float) -> float:
        """Charge the host-clock seconds since ``t0`` to ``part`` of
        :attr:`timings` (the device synchronised first); returns now."""
        if self.timings is None:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.timings[part] = self.timings.get(part, 0.0) + (t - t0)
        return t

    def _advise_many(self, reqs: List[AdviceRequest]) -> List[Advice]:
        self._counters["requests"] += len(reqs)
        self._counters["batches"] += 1
        quant = self.quant
        t0 = time.perf_counter()

        # Phase 1 — fingerprint + cache lookup.  resolution[i] is either
        # (entry, cache_hit) or None (pending a solve this window).
        resolution: List[Optional[Tuple[_Entry, bool]]] = [None] * len(reqs)
        miss: Dict[Tuple, AdviceRequest] = {}   # fp -> quantized rep
        miss_of: List[Optional[Tuple]] = [None] * len(reqs)
        exact_idx: List[int] = []
        for i, r in enumerate(reqs):
            qr = quantize_request(r, quant)
            fp = quantized_key(qr)
            if fp in miss:                  # same cell, earlier this window
                miss_of[i] = fp
                continue
            e = self.cache.get(fp)
            if e is None:
                miss[fp] = qr
                miss_of[i] = fp
            elif e.certified:
                resolution[i] = (e, True)
            else:                           # known-uncertifiable cell
                exact_idx.append(i)
        self._lap("fingerprint", t0)

        # Phase 2 — ONE batched solve per request shape for all misses.
        if miss:
            solved = self._solve(list(miss.items()), exact=False)
            for i, fp in enumerate(miss_of):
                if fp is None or resolution[i] is not None:
                    continue
                e = solved[fp]
                if e.certified:
                    resolution[i] = (e, False)
                else:
                    exact_idx.append(i)

        # Phase 3 — exact-parameter path for uncertifiable cells.
        if exact_idx:
            self._counters["fallback_requests"] += len(exact_idx)
            need: Dict[Tuple, AdviceRequest] = {}
            t0 = time.perf_counter()
            for i in exact_idx:
                efp = exact_fingerprint(reqs[i])
                e = self.cache.get(efp)
                if e is not None:
                    resolution[i] = (e, True)
                elif efp not in need:
                    need[efp] = dataclasses.replace(reqs[i], T_base=1.0)
            self._lap("fingerprint", t0)
            if need:
                solved = self._solve(list(need.items()), exact=True)
                for i in exact_idx:
                    if resolution[i] is None:
                        resolution[i] = (solved[exact_fingerprint(reqs[i])],
                                         False)

        t0 = time.perf_counter()
        out = [self._advice(r, *resolution[i]) for i, r in enumerate(reqs)]
        self._lap("advice", t0)
        return out

    def _solve(self, keyed: List[Tuple[Tuple, AdviceRequest]],
               exact: bool) -> Dict[Tuple, _Entry]:
        """Solve deduped (key, request) pairs; insert + return entries."""
        t0 = time.perf_counter()
        plan = _batcher.plan_batch(keyed)
        pg, mg, m_values, m_max = plan.grids(self.device)
        self._counters["solved_lanes"] += plan.n_lanes
        out: Dict[Tuple, _Entry] = {}
        t0 = self._lap("grids", t0)

        if pg is not None:
            res = _sweep.evaluate_grid(pg, T_base=1.0,
                                       dispatch=self.dispatch,
                                       precision=self.precision,
                                       device=self.device)
            self._counters["dispatched_solves"] += 1
            t0 = self._lap("solve_single", t0)
            cert = self._certify(exact, pg.size, certified_bound_single,
                                 pg.fields(), res.T_time, res.T_energy,
                                 self.quant)
            t0 = self._lap("certificate", t0)
            cols = _host_columns(res, _SINGLE_OUT)
            for fp, lane in plan.single_lanes.items():
                out[fp] = self._entry(cols, lane, float(cert[lane]), exact)
            t0 = self._lap("readback", t0)
        if mg is not None:
            res = _sweep.evaluate_multilevel_grid(
                mg, m_values=m_values, T_base=1.0,
                dispatch=self.dispatch, m_max=m_max,
                precision=self.precision, device=self.device)
            self._counters["dispatched_solves"] += 1
            t0 = self._lap("solve_ml", t0)
            cert = self._certify(exact, mg.size, certified_bound_multilevel,
                                 mg.fields(), res.T_time, res.m_time,
                                 res.T_energy, res.m_energy, self.quant)
            t0 = self._lap("certificate", t0)
            cols = _host_columns(res, _ML_OUT)
            for fp, lane in plan.ml_lanes.items():
                out[fp] = self._entry(cols, lane, float(cert[lane]), exact)
            self._lap("readback", t0)
        for fp, e in out.items():
            self.cache.put(fp, e)
        return out

    def _certify(self, exact: bool, n: int, bound, *args) -> np.ndarray:
        """Per-lane certified bounds (zeros on the exact path)."""
        if exact:
            return np.zeros(n)
        # A reduced-precision solve can misplace the optimum by up to
        # objective_tol (relative); fold that into the certified bound so
        # certification TIGHTENS under f32 instead of silently eroding.
        return bound(*args) + self.precision.objective_tol

    def _entry(self, cols: Dict[str, list], i: int, cert: float,
               exact: bool) -> _Entry:
        """The cached entry of lane ``i`` from the host columns."""
        valid = cols["valid"][i] > 0.5
        ml = "m_time" in cols
        nan = float("nan")
        return _Entry(
            valid=valid,
            certified=exact or (valid and cert <= self.quant.tol),
            exact=exact, cert_bound=0.0 if exact else cert,
            T_time=cols["T_time"][i], T_energy=cols["T_energy"][i],
            m_time=int(cols["m_time"][i]) if ml else 1,
            m_energy=int(cols["m_energy"][i]) if ml else 1,
            Tf_time=cols["Tf_time"][i], Tf_energy=cols["Tf_energy"][i],
            E_time=cols["E_time"][i], E_energy=cols["E_energy"][i],
            vs_single_time=cols["time_vs_single"][i] if ml else nan,
            vs_single_energy=cols["energy_vs_single"][i] if ml else nan)

    def _advice(self, req: AdviceRequest, e: _Entry,
                cache_hit: bool) -> Advice:
        if req.objective == "time":
            T, m, vs = e.T_time, e.m_time, e.vs_single_time
        else:
            T, m, vs = e.T_energy, e.m_energy, e.vs_single_energy
        return Advice(
            objective=req.objective, period=T, deep_every=m,
            store=store_recommendation(req, m),
            predicted_wall=e.Tf_time * req.T_base
            if req.objective == "time" else e.Tf_energy * req.T_base,
            predicted_energy=e.E_time * req.T_base
            if req.objective == "time" else e.E_energy * req.T_base,
            T_time=e.T_time, T_energy=e.T_energy,
            m_time=e.m_time, m_energy=e.m_energy,
            vs_single=vs, valid=e.valid, cache_hit=cache_hit,
            cert_bound=e.cert_bound, exact=e.exact,
            closed_form_exact=(req.process == "exponential"),
            process=req.process)


_SINGLE_OUT = ("T_time", "T_energy", "Tf_time", "Tf_energy", "E_time",
               "E_energy", "valid")
_ML_OUT = _SINGLE_OUT + ("m_time", "m_energy", "time_vs_single",
                         "energy_vs_single")


def _host_columns(res, names) -> Dict[str, list]:
    """``{name: list of Python floats}`` of a solve's result fields, copied
    to the host in ONE transfer (the flags and cadences as exact f64)."""
    host = torch.stack([getattr(res, k).to(F64) for k in names]).cpu()
    return dict(zip(names, host.tolist()))


_SENTINEL = object()


class ThreadedAdvisor:
    """Queue + worker front-end adding admission batching to a service.

    Callers :meth:`submit` requests and get ``Future``s; the worker
    drains the queue for up to ``batch_window_s`` after the first request
    arrives (or until ``max_batch`` requests are pending) and answers the
    whole window with one ``advise_many`` call.  The window trades a
    bounded latency floor for solve sharing — the load generator measures
    exactly this trade.
    """

    def __init__(self, service: AdvisorService,
                 batch_window_s: float = 0.002, max_batch: int = 512):
        if batch_window_s < 0.0:
            raise ValueError("batch_window_s must be >= 0")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.service = service
        self.batch_window_s = float(batch_window_s)
        self.max_batch = int(max_batch)
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._windows = 0
        self._windowed_requests = 0
        self._closed = False
        self._thread = threading.Thread(target=self._worker,
                                        name="advisor-worker", daemon=True)
        self._thread.start()

    # -- public API ----------------------------------------------------------
    def submit(self, req: AdviceRequest) -> "Future[Advice]":
        """Enqueue one request; resolves to its :class:`Advice`."""
        if self._closed:
            raise RuntimeError("advisor is closed")
        fut: "Future[Advice]" = Future()
        self._q.put((req, fut))
        return fut

    def advise(self, req: AdviceRequest) -> Advice:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(req).result()

    def metrics(self) -> Dict:
        out = self.service.metrics()
        out["windows"] = self._windows
        out["mean_window"] = (self._windowed_requests / self._windows
                              if self._windows else 0.0)
        return out

    def close(self):
        """Drain outstanding work and stop the worker thread."""
        if not self._closed:
            self._closed = True
            self._q.put(_SENTINEL)
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker --------------------------------------------------------------
    def _worker(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            batch = [item]
            stop = False
            deadline = monotonic() + self.batch_window_s
            while len(batch) < self.max_batch:
                remaining = deadline - monotonic()
                if remaining <= 0.0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    stop = True
                    break
                batch.append(nxt)
            self._windows += 1
            self._windowed_requests += len(batch)
            try:
                advices = self.service.advise_many([r for r, _ in batch])
            except BaseException as err:  # propagate to every caller
                for _, fut in batch:
                    fut.set_exception(err)
                if not isinstance(err, Exception):
                    raise                   # interrupt / exit end the worker
            else:
                for (_, fut), adv in zip(batch, advices):
                    fut.set_result(adv)
            if stop:
                return
