"""Training and serving entry points: the train step, its losses, metrics
and optimiser, and the chunked render of ``make_render_fn``."""
