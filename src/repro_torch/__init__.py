"""PyTorch/CUDA port of the checkpoint time-vs-energy system.

Laid out like the JAX reference package: ``core`` (parameters, failure
processes, closed forms, single- and multilevel solvers, the runtime
policy, scalar simulator), ``sim`` (scenarios, grid sweeps, the
event-level Monte-Carlo engine, dispatch and precision), ``energy``
(phase-based energy accounting), ``ckpt`` (the compressed sharded store
and the checkpoint manager), ``kernels`` (hand-written CUDA kernels for
Hopper, each beside its plain PyTorch version, built at first use from
``csrc/``, with the oracles and the models' layouts), ``configs`` (the
ten arch configs), ``models`` (parameter trees, the xLSTM model and its
train step), ``optim`` (AdamW, int8 gradient compression), ``data`` (the
synthetic token stream), ``benchmarks`` (the figures, tables and
benches) and ``interop`` (carries the reference's state and weights
across).  Entry points take ``device=`` and default to ``"cuda"``.
"""
from . import ckpt, core, energy, sim  # noqa: F401
