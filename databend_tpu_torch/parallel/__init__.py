"""Mesh and exchanges: not ported yet (ROADMAP.md, "Modules to port").

The reference's modules here are JAX sharding programs. This package does
not extend ``__path__``, so ``from ..parallel import ...`` fails with an
ImportError instead of loading them. The port sets
``enable_distributed`` only with more than one CUDA device, so a one-card
query never comes here.
"""
