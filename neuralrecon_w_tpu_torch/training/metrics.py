"""Image metrics used by training (``neuralrecon_w_tpu/training/metrics.py:17-26``).
SSIM and LPIPS come with validation."""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, gt: torch.Tensor, mask=None) -> torch.Tensor:
    err = (pred - gt) ** 2
    if mask is not None:
        return torch.sum(err * mask) / (torch.sum(mask) * err.shape[-1] + 1e-8)
    return torch.mean(err)


def psnr(pred: torch.Tensor, gt: torch.Tensor, mask=None) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse(pred, gt, mask), min=1e-10))
