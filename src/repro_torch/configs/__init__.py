"""Config registry: one module per assigned architecture (the reference's
ten configurations, copied; the port imports nothing of ``repro``)."""
from .base import (ArchConfig, ShapeConfig, SHAPES, get_config, list_configs,
                   reduced, register)

from . import (dbrx_132b, llama4_scout_17b_a16e, whisper_tiny, xlstm_125m,
               starcoder2_3b, codeqwen1_5_7b, deepseek_coder_33b, granite_20b,
               internvl2_1b, recurrentgemma_9b)

ALL_ARCHS = [
    dbrx_132b.CONFIG,
    llama4_scout_17b_a16e.CONFIG,
    whisper_tiny.CONFIG,
    xlstm_125m.CONFIG,
    starcoder2_3b.CONFIG,
    codeqwen1_5_7b.CONFIG,
    deepseek_coder_33b.CONFIG,
    granite_20b.CONFIG,
    internvl2_1b.CONFIG,
    recurrentgemma_9b.CONFIG,
]
