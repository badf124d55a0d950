"""The benchmark's yardstick: manifest, traffic, clocks, counts and checks.

Nothing here imports ``jax`` or the JAX package; the port (``repro_torch``)
is imported only by :mod:`port_bench.harness.serve`, the module that drives
it.
"""
