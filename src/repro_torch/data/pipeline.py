"""Deterministic, restart-safe synthetic batches: tokens for LM
training, latents and images for GAN training.

Batches are a pure function of ``(seed, step, proc_index)``, so a job
restarted from step N sees exactly the batches the crashed job would
have seen, with no loader state to checkpoint.  The port of the
reference's ``data/pipeline.py``: numpy ``RandomState`` seeding, so
:meth:`SyntheticTokenPipeline.batch` and :meth:`GANLatentPipeline.batch`
are bit-identical across the two frameworks, and :meth:`GANLatentPipeline.images` restates
``jax.image.resize(..., "cubic")`` — the Keys cubic (a = -0.5) at
half-pixel centres, with each output's weights renormalised over the
input samples that exist (JAX's edge handling).  ``F.interpolate(mode=
"bicubic")`` uses another coefficient and clamps at the edges, and
differs from it by up to 0.28 on these images, so it is not used.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticTokenPipeline:
    """Token batches from an order-2 synthetic corpus (cheap, and
    learnable: losses fall when a model trains on it), ``{"inputs",
    "targets"}`` int32 ``(local_batch, seq_len)``, targets the next
    token, plus one f32 array per ``extra`` entry (``name -> per-sample
    shape``).  Tensors come back on the CPU.  Process ``proc_index`` of
    ``n_procs`` draws its own ``global_batch // n_procs`` rows."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_procs: int = 1
    proc_index: int = 0
    extra: Optional[Dict[str, tuple]] = None   # name -> shape (per sample)

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_procs == 0
        return self.global_batch // self.n_procs

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Pure function of (seed, step, proc_index)."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) % (2 ** 31)
            + self.proc_index * 7919)
        b, s = self.local_batch, self.seq_len
        # order-2 structure so the loss is learnable
        base = rng.randint(0, self.vocab_size, size=(b, s + 1), dtype=np.int64)
        drift = np.cumsum(rng.randint(0, 3, size=(b, s + 1)), axis=1)
        toks = (base // 7 + drift) % self.vocab_size
        out = {"inputs": torch.from_numpy(toks[:, :-1].astype(np.int32)),
               "targets": torch.from_numpy(toks[:, 1:].astype(np.int32))}
        for name, shape in (self.extra or {}).items():
            out[name] = torch.from_numpy(
                rng.randn(b, *shape).astype(np.float32) * np.float32(0.1))
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


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
    discriminator.  Tensors come back on the CPU.

    ``n_procs``/``proc_index``: process ``proc_index`` of ``n_procs``
    draws its own ``global_batch // n_procs`` rows, a pure function of
    ``(seed, step, proc_index)`` (the reference's seed arithmetic, bit
    for bit); the images' seed leaves ``proc_index`` out, as the
    reference's does."""
    z_dim: int
    global_batch: int
    seed: int = 0
    n_procs: int = 1
    proc_index: int = 0

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.n_procs

    def batch(self, step: int) -> torch.Tensor:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) % (2 ** 31)
            + self.proc_index * 7919)
        return torch.from_numpy(
            rng.randn(self.local_batch, self.z_dim).astype(np.float32))

    def images(self, step: int, hw=(64, 64)) -> torch.Tensor:
        rng = np.random.RandomState(
            (self.seed * 999_983 + step) % (2 ** 31))
        low = torch.from_numpy(
            rng.randn(self.local_batch, 8, 8, 3).astype(np.float32))
        wh = torch.from_numpy(cubic_weights(8, hw[0]))
        ww = torch.from_numpy(cubic_weights(8, hw[1]))
        return torch.tanh(torch.einsum("bhwc,hy,wx->byxc", low, wh, ww))


def make_pipeline(kind: str, **kw):
    """``"tokens"`` -> :class:`SyntheticTokenPipeline`, ``"latents"`` ->
    :class:`GANLatentPipeline`, built with ``kw``."""
    if kind == "tokens":
        return SyntheticTokenPipeline(**kw)
    if kind == "latents":
        return GANLatentPipeline(**kw)
    raise ValueError(kind)
