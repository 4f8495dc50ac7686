from .rng import CMWC, RandomGenerator, ltqnorm, device_uniform, device_gaussian  # noqa: F401
from .memory_swap import MemorySwap, SpinLock, Handle  # noqa: F401
from .profiling import Timer, trace, Roofline, convolve_roofline  # noqa: F401
from . import checkpoint  # noqa: F401
