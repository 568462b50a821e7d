"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``event_sweep``, ``quant_blockwise``), and their public wrappers
(``ops``).  Kernels are built at first use (``_build``), never at
import."""
