"""Host-side dataset code the port reads: label names and the training
``RayPool``."""
