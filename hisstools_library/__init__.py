"""hisstools_library — an accelerator audio-DSP framework in JAX.

Built from scratch in JAX/XLA with the capabilities of
AlexHarker/HISSTools_Library (see SURVEY.md for the reference analysis):

- :mod:`.fft`      — split-complex real/complex FFT engine, vDSP-compatible packing
- :mod:`.ops`      — windows, spectral IR functions, spectral processor, smoothing,
                     table reading, interpolation, statistics
- :mod:`.models`   — convolution engines (time-domain, partitioned, non-uniform
                     zero-latency schemes, N x M multichannel), partial tracking
- :mod:`.parallel` — device-mesh sharding of channels/time with XLA collectives
- :mod:`.io`       — WAVE/AIFF/AIFC audio file reading and writing
- :mod:`.utils`    — RNG, hot-swap buffers, profiling helpers
"""

__version__ = "0.1.0"

from .core.types import Split  # noqa: F401
from .core.errors import ConvolveError, ConvolveException  # noqa: F401
