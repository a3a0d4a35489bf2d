"""The sampler suite (``pdae_tpu.sampling``'s port): ``SamplerContext`` and
the nine samplers, by name in ``SAMPLERS``."""

from .context import SamplerContext
from .samplers import (SAMPLERS, AutoencodingEval, AutoencodingExample, BaseSampler,
                       DenoiseOneStep, GapMeasure, InferLatents, Interpolation,
                       Manipulation, TestDPMs, UnconditionalSample)

__all__ = ["SamplerContext", "SAMPLERS", "AutoencodingEval", "AutoencodingExample",
           "BaseSampler", "DenoiseOneStep", "GapMeasure", "InferLatents", "Interpolation",
           "Manipulation", "TestDPMs", "UnconditionalSample"]
