"""Mesh and exchanges of the port: the one-device decline.

The reference's modules here are JAX sharding programs over a device mesh.
The port has no mesh yet (ROADMAP.md item 11b), so ``mesh.get_default_mesh``
answers None on any machine, as the reference does on one device, and every
distributed operator of the executor hands its input back to the host
operator. ``SET enable_distributed_execution = 1`` does bring the executor
here: it imports ``mesh``, the host halves of ``fragmenter`` (plan matching
and the aggregate layout, which run before any mesh check) and the names of
``exchange``, whose functions raise if they are ever called with a mesh.
"""
