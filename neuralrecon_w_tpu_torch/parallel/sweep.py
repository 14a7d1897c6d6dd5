"""Chunked field sweeps over large host point sets
(``neuralrecon_w_tpu/parallel/sweep.py:31-217``).

The point set streams to the card in host-side macro batches of 2^22
points (a level-10 extraction sweeps millions of candidates); each macro
batch is padded to a whole number of fixed-size chunks, evaluated chunk
by chunk, and brought back. The SDF sweep runs the SDF net's ``sdf_fn``
in float32 (K1; a hash-grid net's own evaluation); the colour sweep runs
K6 (``ops/field_forward.fused_field_forward``) in the field's activation
dtype where ``models/neuconw.colours_by_k6``, and ``models/neuconw.
field_rgb`` otherwise, as the JAX package does. On CPU tensors each runs
its plain version.

With a data group (``parallel/mesh.py``) of W ranks the sweep follows
``_sweep_multihost`` (``sweep.py:79-106``): every rank holds the same host
point set, evaluates the contiguous block of ceil(n / W) points that is its
own on its card, and the blocks, padded to one length, are gathered on
every rank and trimmed to n. Every rank ends with the whole result.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..device import default_device
from .mesh import all_gather_rows, rank_block, split_for_devices

MACRO = 1 << 22


def sweep(fn, chunk: int, *host_arrays, device=None, macro: int = MACRO,
          group=None) -> np.ndarray:
    """fn(*chunks) -> (chunk, ...) tensor, over the arrays' leading axis in
    chunks of ``chunk`` rows on ``device`` (default: the card, or the
    group's); the result as one host array of the arrays' length. With a
    ``group``, each rank sweeps its block and every rank gets the whole."""
    if group is not None:
        n = host_arrays[0].shape[0]
        lo, per = rank_block(group, n)
        blocks = [split_for_devices(np.asarray(a[lo:lo + per]), per)[0] for a in host_arrays]
        out = sweep(fn, chunk, *blocks, device=group.device, macro=macro)
        with torch.no_grad():
            got = all_gather_rows(group, torch.from_numpy(out).to(group.device), n)
        return got.cpu().numpy()
    device = default_device(device)
    macro = max(chunk, (macro // chunk) * chunk)
    n = host_arrays[0].shape[0]
    arrays = [np.asarray(a) for a in host_arrays]
    outs = []
    with torch.no_grad():
        for s in range(0, max(n, 1), macro):
            piece_n = min(macro, n - s) if n else 0
            padded = [torch.from_numpy(split_for_devices(a[s:s + macro], chunk)[0]).to(device)
                      for a in arrays]
            out = torch.cat([fn(*(p[c:c + chunk] for p in padded))
                             for c in range(0, padded[0].shape[0], chunk)])
            outs.append(out.cpu().numpy()[:piece_n])
    return np.concatenate(outs) if len(outs) > 1 else outs[0]


def sharded_sdf_sweep(model, fc, pts: np.ndarray, chunk: int = 65536, device=None,
                      macro: int = MACRO, group=None) -> np.ndarray:
    """SDF at every point, float32 (N,), through the SDF net's ``sdf_fn`` in
    float32; split over the ranks of ``group`` where given."""
    return sweep(model.neuconw.sdf_net.sdf_fn("float32"), chunk, np.asarray(pts, np.float32),
                 device=device, macro=macro, group=group)


def sharded_rgb_sweep(model, fc, pts: np.ndarray, view_dir, a_index: int,
                      chunk: int = 65536, device=None, macro: int = MACRO,
                      group=None) -> np.ndarray:
    """Vertex colours (N, 3) at one view direction and appearance index
    (reference utils/visualization.py:124-156). An index past the
    vocabulary is clamped to its last entry, as ``sweep.py:201-209`` does."""
    from ..models.neuconw import colours_by_k6, field_rgb
    from ..ops.field_forward import fused_field_forward, pack_field

    device = default_device(device)
    pts = np.asarray(pts, np.float32)
    dirs = np.broadcast_to(np.asarray(view_dir, np.float32), pts.shape).copy()
    n_vocab = model.embedding_a.weight.shape[0]
    if a_index >= n_vocab:
        # the reference CLI hardcodes index 1123, which small vocabularies
        # cannot cover
        logging.getLogger(__name__).warning(
            "appearance index %d >= N_VOCAB %d; clamping", a_index, n_vocab)
        a_index = n_vocab - 1
    a_vec = model.embedding_a.weight[a_index].detach().float().cpu().numpy()
    a = np.broadcast_to(a_vec, (pts.shape[0], a_vec.shape[-1])).copy()
    if colours_by_k6(model, fc):
        pack = pack_field(model, fc)

        def fn(p, d, e):
            return fused_field_forward(model, fc, p, d, e, pack)[0]
    else:
        def fn(p, d, e):
            return field_rgb(model, fc, p, d, e)
    return sweep(fn, chunk, pts, dirs, a, device=device, macro=macro, group=group)
