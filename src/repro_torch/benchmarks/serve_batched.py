"""Batched serving example: prefill a batch of prompts and greedy-decode,
with the int8 KV cache and wave-prefill options.

Counterpart of the reference's ``examples/serve_batched.py``: the serving
launcher's model path with its flags (``--device`` included; default
``cuda``, ``--device cpu`` on the host).

    python -m repro_torch.benchmarks.serve_batched --device cpu
    python -m repro_torch.benchmarks.serve_batched --kv-cache int8 --waves 2
"""
from __future__ import annotations

from ..launch import serve


def main(argv=None):
    return serve.main(argv)


if __name__ == "__main__":
    main()
