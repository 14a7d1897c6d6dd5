"""Traffic kinds (``<kind>.py``: ``run(ctx)``) and the traffic mixes that
name them (``<mix>.json``: ``{"kind": ..., parameters}``)."""
