"""PyTorch/CUDA port of the split-deconvolution system.

``repro_torch`` mirrors the JAX package ``repro`` module for module and
keeps its layouts at every public function: NHWC activations, ``(*K,
Cin, Cout)`` filters, fc weights ``(in, out)``, and the n-major / oc-major
split-filter layouts.  It imports ``torch`` and numpy only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`).  The split-deconv kernel (the fused
split conv + pixel shuffle + epilogue) is hand-written CUDA C++ for
Hopper, in ``kernels/csrc/sd_fused.cu``; so are the backward, Winograd
and int8 kernels beside it, and flash attention (``flash_attn.cu``) for
the dense LM's long-prompt prefill (:mod:`repro_torch.launch.serve`).
"""

from repro_torch.device import default_device, describe_device, resolve_device

__all__ = ["default_device", "describe_device", "resolve_device"]
