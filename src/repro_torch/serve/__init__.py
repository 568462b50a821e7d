"""Checkpoint-advisor serving subsystem.

Turns the batched solver stack into a query-serving path: running jobs
ask "what period / how many levels / which store" and get the paper's
AlgoT/AlgoE answer (single- or two-level) from an in-process service
that admission-batches concurrent requests into ONE dispatched grid
solve and fronts it with a fingerprint cache whose quantization error is
certified against a documented tolerance.

    schema      — AdviceRequest / Advice / StoreTier dataclasses.
    fingerprint — quantized cache keys + the sandwich-lemma certificate.
    batcher     — heterogeneous requests -> ParamGrid/MultilevelParamGrid.
    service     — AdvisorService (sync) and ThreadedAdvisor (batching).
    loadgen     — synthetic open-loop load generator + LoadReport.

The same names and contract as the reference's ``repro.serve``; the
service takes ``device=`` (default ``"cuda"``) and the load generator the
caller's numpy generator.
"""
from .schema import (DEFAULT_MAX_DEEP_EVERY, Advice, AdviceRequest,
                     StoreTier, store_recommendation)
from .fingerprint import (Quantization, certified_bound_multilevel,
                          certified_bound_single, exact_fingerprint,
                          fingerprint, quantize_request, quantized_key)
from .batcher import BatchPlan, multilevel_grid, plan_batch, single_grid
from .service import (FINGERPRINT_CACHE_SIZE, AdvisorService,
                      ThreadedAdvisor)
from .loadgen import LoadReport, run_open_loop, synthetic_requests
