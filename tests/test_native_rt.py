"""Native real-time runtime (native/rt_runtime.cpp via utils/native_rt.py).

The reference's serving-host machinery is C++ (ThreadLocks.hpp spinlock,
MemorySwap.h hot-swap cell, PartitionedConvolve.cpp:304-307 staging buffers);
these tests drive the framework's native counterparts: lock discipline,
swap-cell consistency under two-thread hammering, SPSC ring integrity, and a
full duplex audio-callback host loop with underrun accounting.
"""

import threading
import time

import numpy as np
import pytest

from hisstools_library.utils import native_rt as rt
from hisstools_library.utils.memory_swap import MemorySwap

pytestmark = pytest.mark.skipif(not rt.available(),
                                reason="native runtime unavailable (no g++)")


def test_spinlock_attempt_and_release():
    lk = rt.NativeSpinLock()
    assert lk.attempt()
    assert not lk.attempt()          # held
    lk.release()
    assert lk.attempt()              # reacquirable
    lk.release()


def test_spinlock_blocking_acquire_across_threads():
    lk = rt.NativeSpinLock()
    lk.acquire()
    acquired = threading.Event()

    def waiter():
        lk.acquire()                 # must block until the release below
        acquired.set()
        lk.release()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.02)
    assert not acquired.is_set()     # still blocked
    lk.release()
    t.join(timeout=5)
    assert acquired.is_set()


@pytest.mark.parametrize("cls", [MemorySwap, rt.NativeMemorySwap])
def test_swap_interface_parity(cls):
    """The native cell honours the exact MemorySwap interface semantics."""
    sw = cls()
    with sw.attempt() as h:
        assert h.get() is None and h.get_size() == 0
    sw.swap("first", 5).release()
    with sw.attempt() as h:
        assert h.get() == "first" and h.get_size() == 5
    # equal(): exact-size (std::not_equal_to, MemorySwap.h:209-212) — a
    # matching size is untouched, any mismatch (including shrink) reallocs
    h = sw.equal(lambda n: f"alloc{n}", 5)
    assert h.get() == "first"
    h.release()
    h = sw.equal(lambda n: f"alloc{n}", 3)
    assert h.get() == "alloc3" and h.get_size() == 3
    h.release()
    h = sw.equal(lambda n: f"alloc{n}", 9)
    assert h.get() == "alloc9" and h.get_size() == 9
    h.release()
    # grow(): only grows (std::greater, MemorySwap.h:204-207)
    h = sw.grow(lambda n: f"grown{n}", 4)
    assert h.get() == "alloc9" and h.get_size() == 9
    h.release()
    h = sw.grow(lambda n: f"grown{n}", 12)
    assert h.get() == "grown12" and h.get_size() == 12
    h.release()
    sw.clear()
    with sw.attempt() as h:
        assert h.get() is None


def test_swap_attempt_fails_while_loader_holds():
    sw = rt.NativeMemorySwap("ir", 1)
    h = sw.access()                  # loader side holds the cell
    audio = sw.attempt()
    assert not audio.valid() and audio.get() is None   # silence path
    h.release()
    with sw.attempt() as h2:
        assert h2.get() == "ir"


def test_swap_two_thread_hammer():
    """Audio thread attempt()s while the loader swaps stamped pairs; every
    observed payload must be internally consistent (value == size stamp)."""
    sw = rt.NativeMemorySwap()
    stop = threading.Event()
    bad = []

    def audio():
        while not stop.is_set():
            with sw.attempt() as h:
                v = h.get()
                if v is not None and (v[0] != v[1] or h.get_size() != v[0]):
                    bad.append((v, h.get_size()))

    t = threading.Thread(target=audio)
    t.start()
    for i in range(1, 3001):
        sw.swap((i, i), i).release()
    stop.set()
    t.join(timeout=10)
    assert not bad


def test_ring_sequence_integrity_across_threads():
    """SPSC ring: a produced counter sequence arrives intact through random
    partial writes/reads from two threads."""
    ring = rt.Ring(1 << 12)
    n = 200_000
    seq = np.arange(n, dtype=np.float32)
    rng = np.random.RandomState(7)

    def producer():
        pos = 0
        while pos < n:
            k = int(rng.randint(1, 4096))
            pos += ring.write(seq[pos:pos + k])

    out = np.empty(n, np.float32)
    t = threading.Thread(target=producer)
    t.start()
    got = 0
    deadline = time.time() + 30
    rng2 = np.random.RandomState(8)
    while got < n and time.time() < deadline:
        chunk = ring.read(int(rng2.randint(1, 4096)))
        out[got:got + chunk.size] = chunk
        got += chunk.size
    t.join(timeout=10)
    assert got == n
    np.testing.assert_array_equal(out, seq)


def test_ring_capacity_and_backpressure():
    ring = rt.Ring(100)              # rounds up to 128
    assert ring.capacity() == 128
    data = np.ones(200, np.float32)
    assert ring.write(data) == 128   # partial write at capacity
    assert ring.writable() == 0
    assert ring.discard(28) == 28
    assert ring.write(data) == 28


def test_audio_host_duplex_loop():
    """Full serving shape: native host produces capture blocks and drains
    playback blocks at 48 kHz cadence; a Python worker applies a gain. The
    played audio must be the gained source, and no underruns after warmup."""
    # 512 frames @ 48 kHz = 10.7 ms/block: enough deadline slack that a
    # CPython worker thread only misses on real scheduler stalls (at 256 the
    # test flaked ~1/3 of runs even on an idle machine).
    fpb, ch, nblocks, warmup = 512, 2, 48, 3
    bf = fpb * ch
    in_ring, out_ring = rt.Ring(1 << 16), rt.Ring(1 << 16)
    src = np.random.RandomState(0).randn(bf * 8).astype(np.float32)
    host = rt.AudioHost(in_ring, out_ring, src, fpb, ch, 48000.0,
                        nblocks, warmup_blocks=warmup)
    done = 0
    t0 = time.time()
    while done < nblocks and time.time() - t0 < 20:
        blk = in_ring.read(bf)
        if blk.size < bf:
            time.sleep(0.0002)
            continue
        out_ring.write(blk * 0.5)
        done += 1
    stats = host.join()
    assert stats["blocks"] == nblocks
    assert stats["overruns"] == 0
    assert stats["underruns"] <= 3   # scheduler-jitter tolerance
    if stats["underruns"]:
        return  # a mid-stream zero-fill shifts alignment; content check n/a
    # Content check: once the pipeline is primed, played block b equals
    # 0.5 * capture block (b - d) for a constant pipeline delay d >= 0.
    played = host.played.ravel()
    exp = np.concatenate([src] * ((nblocks * bf) // src.size + 2))
    for delay in range(4):
        cand = 0.5 * exp[:nblocks * bf]
        seg_p = played[(warmup + delay) * bf:(warmup + delay + 4) * bf]
        seg_e = cand[warmup * bf:(warmup + 4) * bf]
        if seg_p.size == seg_e.size and np.allclose(seg_p, seg_e, atol=1e-6):
            break
    else:
        raise AssertionError("played stream never aligned with gained source")


def test_audio_host_counts_underruns_when_worker_stalls():
    """No worker at all: every post-warmup playback block underruns."""
    fpb, ch, nblocks, warmup = 128, 1, 10, 2
    in_ring, out_ring = rt.Ring(1 << 14), rt.Ring(1 << 14)
    src = np.zeros(fpb * 4, np.float32)
    host = rt.AudioHost(in_ring, out_ring, src, fpb, ch, 48000.0,
                        nblocks, warmup_blocks=warmup, capture=False)
    while not host.done():
        time.sleep(0.005)
    stats = host.join()
    assert stats["blocks"] == nblocks
    assert stats["underruns"] == nblocks - warmup
