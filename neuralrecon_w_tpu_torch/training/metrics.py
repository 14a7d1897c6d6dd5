"""Image metrics (``neuralrecon_w_tpu/training/metrics.py``): mse and psnr,
which training logs (reference lightning_modules/neuconw_system.py:364-369),
and SSIM and LPIPS for offline image evaluation; neither the reference's
training loop nor the Trainer uses those two.

SSIM's window and LPIPS's trunk are convolutions (cuDNN on the card), so
on the card they run in TF32 wherever ``torch.backends.cudnn.allow_tf32``
is set, torch's default: the metrics follow that global flag.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mse(pred: torch.Tensor, gt: torch.Tensor, mask=None) -> torch.Tensor:
    err = (pred - gt) ** 2
    if mask is not None:
        return torch.sum(err * mask) / (torch.sum(mask) * err.shape[-1] + 1e-8)
    return torch.mean(err)


def psnr(pred: torch.Tensor, gt: torch.Tensor, mask=None) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse(pred, gt, mask), min=1e-10))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / torch.sum(g)
    return g[:, None] * g[None, :]


def ssim(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """SSIM of two (H, W, C) images: an 11x11 Gaussian window (sigma 1.5)
    over each channel, VALID, constants (0.01, 0.03) x max_val
    (``metrics.py:39-60``); in the images' dtype, on their device."""
    k = _gaussian_kernel(dtype=pred.dtype, device=pred.device)[None, None]
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    def filt(img):
        x = img.permute(2, 0, 1)[:, None]  # (C, 1, H, W): depthwise as a batch
        return F.conv2d(x, k)[:, 0].permute(1, 2, 0)

    mu_p, mu_g = filt(pred), filt(gt)
    sigma_p = filt(pred * pred) - mu_p**2
    sigma_g = filt(gt * gt) - mu_g**2
    sigma_pg = filt(pred * gt) - mu_p * mu_g
    num = (2 * mu_p * mu_g + c1) * (2 * sigma_pg + c2)
    den = (mu_p**2 + mu_g**2 + c1) * (sigma_p + sigma_g + c2)
    return torch.mean(num / den)


def lpips_loss(pred, gt, net: str = "vgg", weights: str | None = None, device=None) -> float:
    """LPIPS distance of (H, W, 3) images in [0, 1] (``metrics.py:63-75``),
    with the weights of a saved ``lpips.LPIPS(net=...).state_dict()`` file
    (``training/lpips.py``), on ``device`` (default: the card)."""
    from .lpips import load_torch_state_dict, lpips

    if weights is None:
        raise RuntimeError(
            "LPIPS needs pretrained conv weights; vendor a "
            "lpips.LPIPS state_dict file and pass weights=<path> "
            "(zero-egress environments cannot download them)"
        )
    model = load_torch_state_dict(weights, net=net, device=device)
    return float(lpips(model, pred, gt))
