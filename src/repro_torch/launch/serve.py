"""Serving entry points.

Model path (default): prefill a batch of prompts, then greedy-decode, on
the card (``--device cuda``, the default; it raises without a GPU) or on
the host (``--device cpu``).  Prompts and the random init come from
``torch.Generator``s seeded by ``--seed``.

    python -m repro_torch.launch.serve --arch starcoder2-3b \\
        --reduce --batch 4 --prompt-len 64 --new-tokens 16 --kv-cache int8
    python -m repro_torch.launch.serve --arch starcoder2-3b --no-reduce \\
        --batch 8 --prompt-len 8192 --new-tokens 32 --waves 2

``--reduce`` (the default) gives the reference's ``reduced(cfg)`` on the
CPU; on CUDA it gives ``reduced(cfg, d_model=128, n_heads=1)``, heads of
128, since the attention kernels take head widths of 64, 128 and 256 only
(the reference's reduced heads are 16 wide).  All ten archs are served:
the attention archs (starcoder2-3b, codeqwen1.5-7b, deepseek-coder-33b,
granite-20b), the MoE archs (dbrx-132b, llama4-scout-17b-a16e), the
hybrid recurrentgemma-9b, xlstm-125m, whisper-tiny (random stub frames
through its encoder) and internvl2-1b (random stub prefix embeddings
before the prompt).

Advisor path: drive the checkpoint-advisor service (``repro_torch.serve``)
with a synthetic open-loop workload and print throughput/latency/cache
statistics.  ``--smoke`` runs the short self-checking workload.

    python -m repro_torch.launch.serve advisor --requests 512 \\
        --rate 2000 --repeat-frac 0.5 --batch-window-ms 2
    python -m repro_torch.launch.serve advisor --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def generator(seed: int) -> np.random.Generator:
    """The numpy generator a ``--seed`` flag stands for; the library takes
    generators from its callers, and this CLI is one."""
    return np.random.default_rng(seed)  # reprolint: disable=RPL001 (the CLI entry point turns its --seed flag into the generator the library takes; the reference seeds at its approved loadgen site, the port's library never does)


#: ``--reduce`` on CUDA: one head of 128 (the kernels' narrowest width).
CUDA_REDUCE = dict(d_model=128, n_heads=1)
#: the archs the model path serves.
SERVED = ("starcoder2-3b", "codeqwen1.5-7b", "deepseek-coder-33b",
          "granite-20b", "dbrx-132b", "llama4-scout-17b-a16e",
          "recurrentgemma-9b", "xlstm-125m", "whisper-tiny", "internvl2-1b")


def build_parser() -> argparse.ArgumentParser:
    """Model-serving CLI (kept separate so tests can parse without building
    a model)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduce", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced same-family config: the reference's "
                         "reduced(cfg) on the CPU, reduced(cfg, d_model=128, "
                         "n_heads=1) on CUDA (heads of 128, which the "
                         "kernels take)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--kv-cache", default="bfloat16",
                    choices=["bfloat16", "int8"])
    ap.add_argument("--waves", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda or cpu)")
    return ap


def serving_config(args, device: "torch.device", cut=None):
    """The architecture ``args`` name, cut by ``--reduce`` for ``device``
    and set to ``--kv-cache`` and ``--waves``; ``cut`` (a dict of
    config fields, e.g. ``n_layers``) is applied last."""
    from ..configs import get_config, reduced
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = (reduced(cfg) if device.type == "cpu"
               else reduced(cfg, **CUDA_REDUCE))
    return dataclasses.replace(cfg, kv_cache_dtype=args.kv_cache,
                               prefill_waves=args.waves, **(cut or {}))


@dataclasses.dataclass
class ServeRun:
    """What one model-path run made: the generated ids (B, new_tokens), the
    last logits (B, 1, V), the cache after the last step, the model, its
    params and config, and the host seconds of the prefill and of the
    decode loop."""
    tokens: "torch.Tensor"
    logits: "torch.Tensor"
    cache: dict
    model: object
    params: object
    cfg: object
    prefill_s: float
    decode_s: float


def model_main(args, *, sync_debug=None, cut=None) -> ServeRun:
    """Prefill ``--batch`` random prompts of ``--prompt-len`` tokens (with
    random stub frames for an encoder-decoder and a random stub prefix for
    a VLM, ``0.02`` times a normal draw, as the reference's), then
    greedy-decode ``--new-tokens``; prints the reference's lines.  Times
    are taken after ``torch.cuda.synchronize`` on the card.  On CUDA,
    ``sync_debug`` (``"warn"`` or ``"error"``) is the
    ``torch.cuda.set_sync_debug_mode`` the decode loop runs under: a step
    that reads the device then warns or raises.  ``cut`` changes config
    fields after the flags (``serving_config``): a full-width MoE arch at
    a few of its layers, say, or another ``moe_impl``."""
    import torch

    from .._device import resolve_device
    from ..models import build

    dev = resolve_device(args.device)
    cfg = serving_config(args, dev, cut)
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    batch = {"tokens": prompts}
    if cfg.is_encoder_decoder:
        batch["frames"] = 0.02 * torch.randn(
            (args.batch, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=dev)
    if cfg.n_prefix_tokens:
        batch["prefix"] = 0.02 * torch.randn(
            (args.batch, cfg.n_prefix_tokens, cfg.d_model), generator=gen,
            device=dev)
    total = args.prompt_len + (cfg.n_prefix_tokens or 0) + args.new_tokens
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, max_cache_seq=total)
        sync()
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(logits[:, -1:], dim=-1)
        out_tokens = [tok]
        t0 = time.perf_counter()
        if cuda and sync_debug:
            torch.cuda.set_sync_debug_mode(sync_debug)
        try:
            for _ in range(args.new_tokens - 1):
                logits, cache = model.decode_step(params, cache, tok)
                tok = torch.argmax(logits[:, -1:], dim=-1)
                out_tokens.append(tok)
        finally:
            if cuda and sync_debug:
                torch.cuda.set_sync_debug_mode(0)
        sync()
        t_decode = time.perf_counter() - t0

    gen_ids = torch.cat(out_tokens, dim=1)
    print(f"arch={cfg.name} kv_cache={args.kv_cache} waves={args.waves}")
    print(f"prefill: {args.batch}x{args.prompt_len} tokens in "
          f"{t_prefill*1e3:.1f} ms")
    print(f"decode : {args.new_tokens} steps x {args.batch} seqs in "
          f"{t_decode*1e3:.1f} ms "
          f"({t_decode/max(args.new_tokens-1,1)*1e3:.1f} ms/step)")
    print("generated token ids (first sequence):",
          [int(t) for t in gen_ids[0][:16]])
    return ServeRun(gen_ids, logits, cache, model, params, cfg, t_prefill,
                    t_decode)


def build_advisor_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve advisor",
        description="Open-loop load run against the checkpoint advisor.")
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="open-loop arrival rate (requests/s)")
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=512)
    ap.add_argument("--two-tier-frac", type=float, default=0.5)
    ap.add_argument("--repeat-frac", type=float, default=0.0)
    ap.add_argument("--warmup", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="short self-checking run")
    ap.add_argument("--device", default="cuda",
                    help="where the service solves (cuda or cpu)")
    return ap


def advisor_main(argv=None):
    from ..serve import (AdvisorService, ThreadedAdvisor, run_open_loop,
                         synthetic_requests)

    args = build_advisor_parser().parse_args(argv)
    if args.smoke:
        return _advisor_smoke(args.device)

    reqs = synthetic_requests(args.requests, generator(args.seed),
                              two_tier_frac=args.two_tier_frac,
                              repeat_frac=args.repeat_frac)
    warm = synthetic_requests(args.warmup, generator(args.seed + 1),
                              two_tier_frac=args.two_tier_frac)
    with ThreadedAdvisor(AdvisorService(device=args.device),
                         batch_window_s=args.batch_window_ms * 1e-3,
                         max_batch=args.max_batch) as advisor:
        rep = run_open_loop(advisor, reqs, rate_hz=args.rate, warmup=warm)
        metrics = advisor.metrics()
    print(f"served {rep.n} requests in {rep.duration_s:.3f}s "
          f"-> {rep.rps:.0f} rps")
    print(f"latency p50={rep.p50_ms:.2f}ms p99={rep.p99_ms:.2f}ms "
          f"max={rep.max_ms:.2f}ms")
    print(f"cache hit rate {rep.hit_rate:.1%}; "
          f"{rep.windows} windows, mean size {rep.mean_window:.1f}")
    print(f"dispatched solves: {metrics['dispatched_solves']} "
          f"({metrics['solved_lanes']} lanes), "
          f"exact fallbacks: {metrics['fallback_requests']}")
    return rep


def _advisor_smoke(device="cuda"):
    """Self-check: throughput > 0, hits on repeats, batched == unbatched."""
    from ..serve import (AdvisorService, ThreadedAdvisor, run_open_loop,
                         synthetic_requests)

    reqs = synthetic_requests(48, generator(7), two_tier_frac=0.5,
                              repeat_frac=0.5)

    # batched answers == unbatched single-request answers, bit for bit
    batched = AdvisorService(cache_name=None,
                             device=device).advise_many(reqs)
    solo_svc = AdvisorService(cache_name=None, device=device)
    for req, a in zip(reqs, batched):
        b = solo_svc.advise(req)
        same = (a.period == b.period and a.deep_every == b.deep_every
                and (a.predicted_energy == b.predicted_energy
                     or (a.predicted_energy != a.predicted_energy
                         and b.predicted_energy != b.predicted_energy)))
        if not same:
            raise SystemExit(f"FAIL: batched != unbatched for {req}")
    print("PASS batched == unbatched (48 requests, bit-identical)")

    with ThreadedAdvisor(AdvisorService(cache_name=None, device=device),
                         batch_window_s=2e-3) as advisor:
        rep = run_open_loop(advisor, reqs, rate_hz=2000.0,
                            warmup=synthetic_requests(8, generator(8)))
    if not rep.rps > 0.0:
        raise SystemExit("FAIL: zero throughput")
    print(f"PASS open loop: {rep.rps:.0f} rps, p50={rep.p50_ms:.2f}ms, "
          f"p99={rep.p99_ms:.2f}ms")
    if not rep.hit_rate > 0.0:
        raise SystemExit("FAIL: no cache hits on repeated workload")
    print(f"PASS cache hit rate {rep.hit_rate:.1%} on repeated workload")
    return rep


def main(argv=None):
    import sys
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "advisor":
        return advisor_main(argv[1:])
    return model_main(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
