"""Serving entry points: the chunked render of ``make_render_fn``."""
