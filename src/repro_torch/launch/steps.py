"""Step functions of LM serving: prefill and greedy decode.

The port of ``make_prefill_step`` and ``make_decode_step`` of the JAX
package's ``launch/steps.py``.  PyTorch runs eagerly, so a step is the
plain callable the reference would ``jax.jit``.
"""

from __future__ import annotations

import torch

from repro_torch.models.lm import LM


def make_prefill_step(lm: LM):
    def prefill_step(params, batch, cache):
        return lm.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(lm: LM):
    def decode_step(params, batch, cache):
        logits, cache = lm.decode_step(params, batch, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        return tok, logits, cache
    return decode_step
