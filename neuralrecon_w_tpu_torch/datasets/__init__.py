"""Host-side dataset code the port reads: label names, the training
``RayPool``, the scene's ``config.yaml`` and COLMAP's ``points3D.bin``."""
