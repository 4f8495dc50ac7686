"""Device-mesh construction for the audio-DSP workload.

The reference library is single-process (SURVEY.md §2, "Parallelism status"): its
only concurrency is SIMD lanes plus an audio/loader thread pair. The scaling
model here replaces that with a 2-D logical mesh:

- ``channel`` axis — convolution channels shard like data parallelism (the N-to-mono
  reduction of NToMonoConvolve.cpp:35-43 becomes a ``psum`` over this axis),
- ``block`` axis — the time/sequence axis shards into contiguous overlap-save hop
  ranges (sequence parallelism); block boundaries and partition-tail spectra are
  exchanged with ``ppermute`` ring steps (see halo.py).

Collectives are XLA's (NCCL on GPUs); no custom transport exists or is needed
(SURVEY.md §5, "Distributed communication backend"). The cards of one host are
joined all to all (NVLink), so the mesh's shape follows the algorithm only: any
(channel, block) factorisation of the devices is equally well connected.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

CHANNEL_AXIS = "channel"
BLOCK_AXIS = "block"


def make_mesh(devices: Optional[Sequence] = None,
              channel: Optional[int] = None,
              block: Optional[int] = None) -> Mesh:
    """Build a (channel, block) mesh over the given devices.

    With only one of the factors given the other is inferred; with neither, the
    device count goes to the channel axis (pure channel parallelism).
    """
    devices = list(devices) if devices is not None else list(jax.devices())
    n = len(devices)
    if channel is None and block is None:
        channel, block = n, 1
    elif channel is None:
        if n % block:
            # Inferring channel = n // block would silently idle n % block
            # devices (e.g. block=3 on 8 devices -> a 2x3 mesh, 25% of the
            # machine unused with nothing printed).
            raise ValueError(f"block={block} does not divide {n} devices; "
                             f"pass channel explicitly to use a subset")
        channel = n // block
    elif block is None:
        if n % channel:
            raise ValueError(f"channel={channel} does not divide {n} devices; "
                             f"pass block explicitly to use a subset")
        block = n // channel
    if channel * block > n:
        raise ValueError(f"mesh {channel}x{block} needs more than {n} devices")
    arr = np.asarray(devices[: channel * block]).reshape(channel, block)
    return Mesh(arr, (CHANNEL_AXIS, BLOCK_AXIS))


def channel_sharding(mesh: Mesh) -> NamedSharding:
    """(C, L) arrays: channels split over the channel axis, time replicated."""
    return NamedSharding(mesh, PartitionSpec(CHANNEL_AXIS, None))


def channel_time_sharding(mesh: Mesh) -> NamedSharding:
    """(C, L) arrays: channels over channel axis, time over block axis."""
    return NamedSharding(mesh, PartitionSpec(CHANNEL_AXIS, BLOCK_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
