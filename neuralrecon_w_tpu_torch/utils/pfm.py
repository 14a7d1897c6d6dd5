"""PFM depth-map I/O, the port's copy of ``neuralrecon_w_tpu/utils/pfm.py``
(reference datasets/depth_utils.py:1-69): grey ('Pf') and colour ('PF')
float32 maps, rows stored bottom to top, the byte order in the scale's
sign (negative: little endian)."""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path: str):
    """Returns (data, scale); data is (H, W) or (H, W, 3) float32."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("not a PFM file")
        m = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not m:
            raise ValueError("malformed PFM header")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.frombuffer(f.read(), endian + "f")
        shape = (height, width, 3) if color else (height, width)
        return np.flipud(data.reshape(shape)), scale


def save_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write an (H, W), (H, W, 1) or (H, W, 3) map as float32 PFM in the
    host's byte order."""
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("image must be HxW, HxWx1 or HxWx3")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).astype(np.float32).tofile(f)
