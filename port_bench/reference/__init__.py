"""Plain PyTorch references for the benchmark's models.

Imports ``torch`` alone: neither ``jax``, the JAX package, nor anything of
the port.  See :mod:`port_bench.reference.model`.
"""
