"""Structured error codes for the convolution engine.

JAX counterpart of the reference's error enum
(/root/reference/HIRT_Multichannel_Convolution/ConvolveErrors.h:4-19). The reference
returns codes without throwing on the audio path; here host-side configuration errors
raise :class:`ConvolveException` carrying the code, while traced code never raises.
"""

from __future__ import annotations

import enum


class ConvolveError(enum.Enum):
    NONE = 0
    IN_CHAN_OUT_OF_RANGE = 1
    OUT_CHAN_OUT_OF_RANGE = 2
    MEM_UNAVAILABLE = 3
    MEM_ALLOC_TOO_SMALL = 4
    TIME_IMPULSE_TOO_LONG = 5
    TIME_LENGTH_OUT_OF_RANGE = 6
    PARTITION_LENGTH_TOO_LARGE = 7
    FFT_SIZE_MAX_TOO_LARGE = 8
    FFT_SIZE_MAX_TOO_SMALL = 9
    FFT_SIZE_MAX_NON_POWER_OF_TWO = 10
    FFT_SIZE_OUT_OF_RANGE = 11
    FFT_SIZE_NON_POWER_OF_TWO = 12
    UNKNOWN = 13


class ConvolveException(Exception):
    """Raised for host-side configuration errors; carries a :class:`ConvolveError`."""

    def __init__(self, code: ConvolveError, message: str = ""):
        self.code = code
        super().__init__(f"{code.name}: {message}" if message else code.name)
