"""The port's benchmarks: the paper's figures and tables (``run.run_figures``;
fig1-3, fig5, both tables, ``quickstart``) and the kernel microbenchmarks
(``bench_kernels``)."""
