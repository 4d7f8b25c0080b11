"""Synthetic data pipelines of the port."""

from repro_torch.data.pipeline import GANLatentPipeline

__all__ = ["GANLatentPipeline"]
