"""Synthetic data pipelines of the port."""

from repro_torch.data.pipeline import (GANLatentPipeline,
                                       SyntheticTokenPipeline, make_pipeline)

__all__ = ["SyntheticTokenPipeline", "GANLatentPipeline", "make_pipeline"]
