"""Host-side dataset metadata the port reads."""
