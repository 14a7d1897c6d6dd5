"""Validation and whole-image rendering (``neuralrecon_w_tpu/training/
validation.py``; reference lightning_modules/neuconw_system.py:404-546): a
frame rendered as a host chunk loop or, with ``scan_render``, as one
dispatch of ``training/step.make_scan_render_fn``, or split over the ranks
of a data group (``validation.py:73-85``, the JAX package's render over its
mesh); a held-out image's PSNR, and a GT / prediction / depth / normal PNG.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..parallel.mesh import all_gather_rows
from ..tracing import span
from ..utils.colormap import jet_uint8


def visualize_depth(depth: np.ndarray, near_p: float = 1.0, far_p: float = 99.0):
    """Percentile-normalised jet colouring of a depth image, uint8
    (reference utils/visualization.py:13-25)."""
    d = np.asarray(depth, np.float64)
    finite = d[np.isfinite(d) & (d > 0)]
    lo, hi = np.percentile(finite, [near_p, far_p]) if finite.size else (0.0, 1.0)
    return jet_uint8(np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1))


def render_image(render_chunk, model, scene, rays: np.ndarray, ts: np.ndarray,
                 labels: np.ndarray, img_wh: tuple, chunk: int = 512,
                 fine_grid=None, sfm_grid=None, rng=None, device=None,
                 scan_render=None, group=None) -> dict:
    """Render (H*W) rays in chunks of ``chunk`` on ``device`` (default:
    the model's). The last chunk is padded by repeating the last ray. With
    ``scan_render`` (``make_scan_render_fn``'s run, of the same chunk) the
    padded frame goes to the device in one copy, renders in one call and
    comes back in one fetch (``validation.py:87-96``); without it, a host
    loop of ``render_chunk`` calls. With a ``group`` of W > 1 data shards
    each chunk is split over them (W must divide it) and gathered on every
    rank; ``scan_render`` is then not used. The model ranks of a data shard
    (a group with a model axis) render the same rays, from a whole field or
    from one split over them. Returns (H, W, ...) numpy images: color, depth
    and the weight-averaged normal. Spans: ``serve.frame_in`` (the padding
    and, with ``scan_render``, the copy to the device) and
    ``serve.frame_out`` (the fetch, which waits for the render)."""
    if device is None:
        device = next(model.parameters()).device
    w, h = img_wh
    n = len(rays)
    pad = (-n) % chunk

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, non_blocking=True)

    n_data, data_rank = (1, 0) if group is None else (group.n_data, group.data_rank)
    split = n_data > 1
    scan = scan_render is not None and not split
    with span("serve.frame_in"):
        if pad:
            rays = np.concatenate([rays, np.repeat(rays[-1:], pad, 0)], 0)
            ts = np.concatenate([ts, np.repeat(ts[-1:], pad, 0)])
            labels = np.concatenate([labels, np.repeat(labels[-1:], pad, 0)])
        if scan:
            frame = put(rays), put(ts), put(labels)
    if scan:
        out = scan_render(model, scene, *frame, rng, fine_grid, sfm_grid)
        packed = torch.cat([out["color"], out["depth"][:, None], out["normal"]], 1)
    else:
        per, lo = chunk, 0
        if split:
            # data shard r renders rows [r * chunk / W, (r + 1) * chunk / W) of every chunk
            if chunk % n_data:
                raise ValueError(f"chunk {chunk} must divide over {n_data} ranks")
            per = chunk // n_data
            lo = data_rank * per
        parts = []
        for i in range(lo, len(rays), chunk):
            out = render_chunk(model, scene, put(rays[i:i + per]), put(ts[i:i + per]),
                               put(labels[i:i + per]), rng, fine_grid, sfm_grid)
            g = out["gradients"]
            wgt = out["weights"][:, : g.shape[1], None]
            part = torch.cat([out["color"], out["depth"][:, None], (g * wgt).sum(dim=1)], 1)
            parts.append(all_gather_rows(group, part) if split else part)
        packed = torch.cat(parts)
    with span("serve.frame_out"):
        packed = packed.cpu().numpy()
    return {"color": packed[:n, :3].reshape(h, w, 3), "depth": packed[:n, 3].reshape(h, w),
            "normal": packed[:n, 4:].reshape(h, w, 3)}


def validation_report(render_chunk, model, scene, meta, id_: int, chunk: int = 512,
                      fine_grid=None, sfm_grid=None, out_dir: str | None = None,
                      step: int = 0, group=None) -> dict:
    """Render the validation image (split over ``group``'s ranks where
    given), its PSNR, and (with ``out_dir``) the PNG ``val_{step}.png``.
    Returns {"val/psnr": float}."""
    from ..datasets.phototourism import build_image_rays, load_image
    from .metrics import psnr

    img = load_image(meta, id_)
    h, w = img.shape[:2]
    rays, _ = build_image_rays(meta, id_, with_semantics=False)
    ts = rays[:, 8].astype(np.int32)
    labels = np.zeros((len(rays),), np.int32)
    rays10 = np.concatenate([rays[:, :8], rays[:, 9:11]], axis=1)

    out = render_image(render_chunk, model, scene, rays10, ts, labels, (w, h), chunk,
                       fine_grid, sfm_grid, group=group)
    val_psnr = float(psnr(torch.from_numpy(out["color"]), torch.from_numpy(img)))
    if out_dir is not None:
        from PIL import Image as PILImage

        os.makedirs(out_dir, exist_ok=True)
        nrm = out["normal"]
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-6)
        nrm_vis = ((nrm * 0.5 + 0.5) * 255).astype(np.uint8)
        pred_vis = (np.clip(out["color"], 0, 1) * 255).astype(np.uint8)
        gt_vis = (img * 255).astype(np.uint8)
        grid = np.concatenate(
            [np.concatenate([gt_vis, pred_vis], axis=1),
             np.concatenate([visualize_depth(out["depth"]), nrm_vis], axis=1)], axis=0)
        PILImage.fromarray(grid).save(os.path.join(out_dir, f"val_{step}.png"))
    return {"val/psnr": val_psnr}
