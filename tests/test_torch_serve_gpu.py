"""The serving path on CUDA tensors (run on the card; skipped without
one).  This file imports no JAX, so that it runs where the card is: the
model's prefill and decode launch the flash, decode and RG-LRU kernels and
never a plain version, and training through them raises instead of
falling back.

    python -m pytest -q -m gpu tests/test_torch_serve_gpu.py
"""
import dataclasses

import pytest
import torch

from repro_torch.ckpt.tree import tree_map
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import decode_attention as PD
from repro_torch.kernels import flash_attention as PF
from repro_torch.kernels import rglru_scan as PR
from repro_torch.models import attention as attn
from repro_torch.models import build


@pytest.mark.gpu
def test_prefill_and_decode_on_cuda_tensors_launch_the_kernels():
    """``Model.prefill`` and ``decode_step`` on CUDA tensors launch the
    flash, decode and RG-LRU kernels and never a plain version; an
    attention layer under grad raises instead of falling back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py phase 14 runs this "
                    "on the card)")
    cfg = dataclasses.replace(
        reduced(get_config("recurrentgemma-9b"), d_model=128, n_heads=1),
        n_layers=3)
    m = build(cfg)
    params = m.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 96), device="cuda")
    counts = lambda: (PF.flash_attention.launches,
                      PD.decode_attention.launches,
                      PR.rglru_scan.launches,
                      PF.flash_attention_plain.calls
                      + PD.decode_attention_plain.calls
                      + PR.rglru_scan_plain.calls)
    before = counts()
    with torch.no_grad():
        logits, cache = m.prefill(params, {"tokens": toks},
                                  max_cache_seq=100)
        _, cache = m.decode_step(params, cache, logits.argmax(-1))
    after = counts()
    assert [a - b for a, b in zip(after, before)] == [1, 1, 4, 0]
    trainable = tree_map(lambda t: t.detach().requires_grad_(), params)
    with pytest.raises(NotImplementedError, match="RG-LRU"):
        m.loss(trainable, {"tokens": toks, "labels": toks})
    q = torch.randn(1, 96, 1, 128, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="attention"):
        attn.attention(q, q, q, mode="causal")
