"""Chunked field sweeps over large point sets, on one card."""
