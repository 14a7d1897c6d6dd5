"""Kernels (K1 ``sdf_mlp``, K2 ``importance_sampler``), their build, and
the plain-torch occupancy-grid traversal."""
