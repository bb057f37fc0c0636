"""Mesh and exchanges: not ported yet (ROADMAP.md item 11).

The reference's modules here are JAX sharding programs. The port has none
of them, so ``from ..parallel import ...`` fails with ImportError. The
binder keeps ``enable_distributed`` off, so a host with several cards
answers a query on one and never comes here.
"""
