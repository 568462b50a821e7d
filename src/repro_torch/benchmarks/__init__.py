"""Entry points that time the port's kernels (``bench_kernels``)."""
