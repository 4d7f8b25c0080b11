"""SSIM (Wang et al. 2004), the paper's image-quality metric.

The port's own copy of the reference's ``core/ssim.py``: an 11-tap
Gaussian window (sigma 1.5), VALID, per channel, averaged over every
position, channel and sample of two NHWC batches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(img_a: torch.Tensor, img_b: torch.Tensor, data_range: float = 2.0,
         window: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM between two NHWC images (per-channel windows,
    averaged).  ``data_range`` defaults to 2.0: generator outputs are
    tanh in [-1, 1]."""
    a = img_a.float().permute(0, 3, 1, 2)
    b = img_b.float().permute(0, 3, 1, 2)
    c = a.shape[1]
    kern = _gaussian_kernel(window, sigma).to(a.device)
    kern = kern[None, None].expand(c, 1, window, window).contiguous()

    def filt(x):
        return F.conv2d(x, kern, groups=c)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = filt(a * a) - mu_aa
    var_b = filt(b * b) - mu_bb
    cov = filt(a * b) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * cov + c2)) / (
        (mu_aa + mu_bb + c1) * (var_a + var_b + c2))
    return s.mean()
