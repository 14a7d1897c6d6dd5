"""The plain reference of the NeuS-W field, renderer, loss and optimiser in
PyTorch: float32 with TF32 off, or, for the control, with the products'
operands rounded to a lower precision. It imports nothing of the port and
nothing of JAX, and takes only what the benchmark made (weights, rays,
grids, the sampler's jitter); what the port derives from them in set-up
(the pool's band cache, the grids' queries) it works out again.

Frozen, simplified copies of the port's plain paths at the benchmark's
configurations (``rendering/renderer.py``, ``rendering/sampling.py``,
``ops/ray_voxel.py``'s plain DDA and sampled query, ``models/*``,
``training/losses.py``, ``training/schedule.py``'s clip and torch's Adam),
which the port's CPU tests hold to the JAX package. Kernels, tensor
parallelism and CUDA-graph workarounds are left out; every concatenation
is made, where the port splits products into row blocks."""
