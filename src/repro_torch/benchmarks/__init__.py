"""The port's benchmarks (``benchmarks/`` of the JAX package, one module
each as it is ported): ``bench_merge``, the replica-sync strategies and the
``delta_apply`` kernel."""
