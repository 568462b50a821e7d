"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), each
beside its plain PyTorch version, one for every Pallas kernel of the
reference:

  event_sweep      — the MC engine's per-failure event loop over
                     (points x trials), f64 or compensated f32
  quant_blockwise  — int8 absmax per 128-lane group (checkpoint
                     compression): ``quantize_leaves`` and
                     ``dequantize_leaves`` over all of a checkpoint's
                     leaves in one launch, ``quantize`` and
                     ``dequantize`` over one array
  flash_attention  — online-softmax attention, causal / sliding /
                     chunked / bidirectional masks
  decode_attention — one query token against a KV cache (flash-decoding)
  rglru_scan       — the RG-LRU linear recurrence (RecurrentGemma)
  mlstm_scan       — the chunkwise mLSTM matrix memory (xLSTM)

``ref`` holds the oracles and ``ops`` the public wrappers in the models'
layouts.  Kernels are built at first use (``_build``), never at import.
"""
