"""Architecture configs of the LM scaffolding (a copy, as data, of the
JAX package's ``configs``; the port imports nothing of that package).

``get(name)`` returns the full ArchConfig; ``get(name).reduced()`` the
CPU smoke-test version.  The port serves the dense decoders
(:mod:`repro_torch.models.lm`); the other families are listed so that
``build_lm`` can name what it refuses.
"""

from .base import ArchConfig, LONG_CONTEXT_OK, SHAPES, ShapeCell

from . import (dbrx_132b, internlm2_20b, internvl2_76b, jamba_1_5_large,
               mixtral_8x7b, qwen1_5_32b, stablelm_12b, whisper_small,
               xlstm_350m, yi_34b)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (xlstm_350m, jamba_1_5_large, stablelm_12b, internlm2_20b,
              qwen1_5_32b, yi_34b, mixtral_8x7b, dbrx_132b, internvl2_76b,
              whisper_small)
}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
