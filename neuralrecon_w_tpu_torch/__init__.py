"""neuralrecon_w_tpu_torch — the PyTorch / CUDA port of neuralrecon_w_tpu.

The JAX package beside this one is the reference; this package keeps its
module layout and names so every function has a findable counterpart.
It imports torch and never jax. Today it serves ``render_rays`` (the
novel-view rendering path of ``tools/render_cli.py``) with two
hand-written Hopper kernels: the fused SDF MLP (``ops/sdf_mlp.py``) and
the per-ray up-sampling round of the importance sampler
(``ops/importance_sampler.py``). Serving imports nothing of the JAX
package either: the port carries the cfg sections it reads
(``config.py``), the label names (``datasets/mask_utils.py``) and the
grid from SFM points (``ops/voxel_grid.py``), each held equal to the
JAX package's by a test. Only ``tools/convert.params_from_jax``, which
takes JAX parameters, calls into it.
"""

__version__ = "0.1.0"
