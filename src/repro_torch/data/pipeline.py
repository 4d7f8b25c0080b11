"""Synthetic latent and image batches for GAN training.

The port of the reference's ``GANLatentPipeline``: numpy ``RandomState``
seeding, so :meth:`GANLatentPipeline.batch` is bit-identical across the
two frameworks, and :meth:`GANLatentPipeline.images` restates
``jax.image.resize(..., "cubic")`` — the Keys cubic (a = -0.5) at
half-pixel centres, with each output's weights renormalised over the
input samples that exist (JAX's edge handling).  ``F.interpolate(mode=
"bicubic")`` uses another coefficient and clamps at the edges, and
differs from it by up to 0.28 on these images, so it is not used.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, at ``|x|``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 resampling matrix of ``jax.image.resize``'s
    cubic method along one axis (antialiased: the kernel widens by the
    scale when shrinking)."""
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) / scale - 0.5
    dist = np.abs(sample[None, :]
                  - np.arange(n_in, dtype=np.float32)[:, None])
    w = _keys_cubic(dist / kernel_scale).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


@dataclasses.dataclass
class GANLatentPipeline:
    """Latent-vector batches for generator training and serving, and
    synthetic 'real' images (smooth random fields) for the
    discriminator.  Tensors come back on the CPU."""
    z_dim: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> torch.Tensor:
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % (2 ** 31))
        return torch.from_numpy(
            rng.randn(self.global_batch, self.z_dim).astype(np.float32))

    def images(self, step: int, hw=(64, 64)) -> torch.Tensor:
        rng = np.random.RandomState(
            (self.seed * 999_983 + step) % (2 ** 31))
        low = torch.from_numpy(
            rng.randn(self.global_batch, 8, 8, 3).astype(np.float32))
        wh = torch.from_numpy(cubic_weights(8, hw[0]))
        ww = torch.from_numpy(cubic_weights(8, hw[1]))
        return torch.tanh(torch.einsum("bhwc,hy,wx->byxc", low, wh, ww))
