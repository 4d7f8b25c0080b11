"""Presplit-once split-deconvolution inference engine."""

from repro_torch.engine.planner import SDEngine, fold_scale_ocmajor

__all__ = ["SDEngine", "fold_scale_ocmajor"]
