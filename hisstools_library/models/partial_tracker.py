"""Sinusoidal-model partial tracking.

JAX counterpart of ``partial_tracker`` (/root/reference/PartialTracker.hpp).
The reference builds the (peak x track) cost list, sorts ascending, and assigns
greedily skipping already-assigned peaks/tracks (:224-289). Sorting-then-scanning is
equivalent to repeatedly extracting the global minimum of the masked cost matrix —
which is how it runs here: a fixed-trip ``fori_loop`` of masked argmins, fully
jittable with static (max_peaks, max_tracks) shapes. Ties resolve to the lowest
flattened (peak-major) index, matching the reference's stable sort over its
peak-major cost generation order.

Cost model (:344-413): freq distance in Hz or MIDI pitch, amp distance linear or dB,
absolute or squared, each scaled by 1/unit (squared costs square the scale), gated
by ``max_cost``. Defaults: squared, pitch, dB, 0.5 st / 6 dB units, max cost 1
(:325-326).

Track states Off/Start/Continue/Switch mirror ``track::set_peak``
(PartialTracker.hpp:56-73); change statistics mirror ``change_tracker`` (:75-156).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Track states
OFF, START, CONTINUE, SWITCH = 0, 1, 2, 3

_BIG = jnp.inf


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    max_peaks: int
    max_tracks: int
    square_cost: bool = True
    use_pitch: bool = True
    use_db: bool = True
    freq_scale: float = 1.0 / 0.5   # 1 / freq_unit (default 0.5 semitones)
    amp_scale: float = 1.0 / 6.0    # 1 / amp_unit (default 6 dB)
    max_cost: float = 1.0
    track_changes: bool = False

    def with_cost_calculation(self, square_cost, use_pitch, use_db):
        return dataclasses.replace(self, square_cost=square_cost,
                                   use_pitch=use_pitch, use_db=use_db)

    def with_cost_scaling(self, freq_unit, amp_unit, max_cost):
        return dataclasses.replace(self, freq_scale=1.0 / freq_unit,
                                   amp_scale=1.0 / amp_unit, max_cost=max_cost)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TrackerState:
    freq: jax.Array    # (T,)
    amp: jax.Array     # (T,)
    state: jax.Array   # (T,) int32

    def tree_flatten(self):
        return (self.freq, self.amp, self.state), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @staticmethod
    def init(max_tracks: int, dtype=jnp.float32) -> "TrackerState":
        return TrackerState(jnp.zeros((max_tracks,), dtype),
                            jnp.zeros((max_tracks,), dtype),
                            jnp.zeros((max_tracks,), jnp.int32))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Changes:
    """Per-frame assignment change statistics (change_tracker, :75-156)."""
    freq_sum: jax.Array
    freq_abs: jax.Array
    amp_sum: jax.Array
    amp_abs: jax.Array
    count: jax.Array

    def tree_flatten(self):
        return (self.freq_sum, self.freq_abs, self.amp_sum, self.amp_abs, self.count), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _pitch(freq):
    return jnp.log2(jnp.maximum(freq, 1e-30) / 440.0) * 12.0 + 69.0


def _db(amp):
    return jnp.log10(jnp.maximum(amp, 1e-300)) * 20.0


@partial(jax.jit, static_argnums=(0,))
def process(config: TrackerConfig, state: TrackerState,
            peak_freq: jax.Array, peak_amp: jax.Array,
            n_peaks, start_threshold) -> Tuple[TrackerState, Changes]:
    """One tracking frame (reference partial_tracker::process, :224-289).

    ``peak_freq/amp``: (max_peaks,) with the first ``n_peaks`` valid.
    Returns the new track state and the frame's change statistics.
    """
    pk = config.max_peaks
    tr = config.max_tracks
    dtype = peak_freq.dtype

    valid = jnp.arange(pk) < n_peaks
    active = state.state != OFF

    pf = _pitch(peak_freq) if config.use_pitch else peak_freq
    tf = _pitch(state.freq) if config.use_pitch else state.freq
    pa = _db(peak_amp) if config.use_db else peak_amp
    ta = _db(state.amp) if config.use_db else state.amp

    fs = config.freq_scale ** 2 if config.square_cost else config.freq_scale
    as_ = config.amp_scale ** 2 if config.square_cost else config.amp_scale

    df = pf[:, None] - tf[None, :]
    da = pa[:, None] - ta[None, :]
    if config.square_cost:
        cost = df * df * fs + da * da * as_
    else:
        cost = jnp.abs(df) * fs + jnp.abs(da) * as_

    mask = valid[:, None] & active[None, :] & (cost < config.max_cost)
    cost = jnp.where(mask, cost, _BIG)

    # Greedy global-min assignment via PARALLEL local-dominant rounds.
    #
    # The sequential form (repeat: global argmin, mask row+col) is a chain of
    # min(pk, tr) data-dependent extractions — driven per frame from a
    # lax.scan (models/pipeline.py) it dominated the config-5 pass (~40 of
    # 45 ms at 511 frames). Equivalent reformulation: under the strict total
    # order key (cost, peak-major flat index), an entry that is the minimum of
    # BOTH its row and its column is certainly extracted by the sequential
    # greedy before either its row or column is consumed — so ALL such "local
    # dominants" can be assigned in one parallel round, rows/columns masked,
    # and the round repeated until no finite entry remains. Every round
    # assigns at least the global minimum, so it terminates in <= min(pk, tr)
    # rounds (typically ~log: 3-5 for 16x16). `jnp.argmin` picks the first
    # minimum along its axis, which implements the flat-index tie-break
    # exactly (within a row lower j = lower flat index; within a column lower
    # i = lower flat index) — the same deterministic order as this module's
    # prior sequential-greedy form. (The reference sorts with std::sort,
    # PartialTracker.hpp:224-289, so ITS tie order is implementation-defined;
    # only the strict-inequality behavior is parity-checked.)
    rows_i = jax.lax.broadcasted_iota(jnp.int32, (pk, tr), 0)
    cols_i = jax.lax.broadcasted_iota(jnp.int32, (pk, tr), 1)

    def cond(carry):
        cost = carry[0]
        return jnp.isfinite(jnp.min(cost))

    def body(carry):
        cost, p_asn, t_asn, new_f, new_a, new_s, chg = carry
        row_min_j = jnp.argmin(cost, axis=1)          # (pk,) ties -> lowest j
        col_min_i = jnp.argmin(cost, axis=0)          # (tr,) ties -> lowest i
        sel = ((cols_i == row_min_j[:, None]) & (rows_i == col_min_i[None, :])
               & jnp.isfinite(cost))                  # local dominants
        sel_p = jnp.any(sel, axis=1)
        sel_t = jnp.any(sel, axis=0)
        peak_for_track = jnp.argmax(sel, axis=0)      # selected i per column

        cost = jnp.where(sel_p[:, None] | sel_t[None, :], _BIG, cost)
        p_asn = p_asn | sel_p
        t_asn = t_asn | sel_t
        new_f = jnp.where(sel_t, peak_freq[peak_for_track], new_f)
        new_a = jnp.where(sel_t, peak_amp[peak_for_track], new_a)
        new_s = jnp.where(sel_t, CONTINUE, new_s)

        # change statistics for Continue assignments (add_change, :85-108).
        # config.track_changes is static, so the disabled branch traces to the
        # reference's change_tracker<T, false> no-op (PartialTracker.hpp:122-156).
        if config.track_changes:
            # df/da already hold the configured units (pitch-or-Hz, dB-or-
            # linear) — the same values the cost was built from.
            chg = Changes(
                chg.freq_sum + jnp.sum(jnp.where(sel, df, 0.0)),
                chg.freq_abs + jnp.sum(jnp.where(sel, jnp.abs(df), 0.0)),
                chg.amp_sum + jnp.sum(jnp.where(sel, da, 0.0)),
                chg.amp_abs + jnp.sum(jnp.where(sel, jnp.abs(da), 0.0)),
                chg.count + jnp.sum(sel).astype(jnp.int32))
        return cost, p_asn, t_asn, new_f, new_a, new_s, chg

    zero = jnp.zeros((), dtype)
    chg0 = Changes(zero, zero, zero, zero, jnp.zeros((), jnp.int32))
    carry = (cost,
             jnp.zeros((pk,), bool), jnp.zeros((tr,), bool),
             state.freq, state.amp, jnp.full((tr,), OFF, jnp.int32),
             chg0)
    carry = jax.lax.while_loop(cond, body, carry)
    cost, p_asn, t_asn, new_f, new_a, new_s, chg = carry

    # Average the change statistics (change_tracker::complete, :110-120).
    if config.track_changes:
        recip = jnp.where(chg.count > 0,
                          1.0 / jnp.maximum(chg.count, 1).astype(dtype), 1.0)
        chg = Changes(chg.freq_sum * recip, chg.freq_abs * recip,
                      chg.amp_sum * recip, chg.amp_abs * recip, chg.count)

    # Start new tracks: unassigned peaks (input order) with amp >= threshold fill
    # free tracks in index order (:264-280).
    eligible = valid & ~p_asn & (peak_amp >= start_threshold)
    free = ~t_asn
    e_rank = jnp.cumsum(eligible.astype(jnp.int32)) * eligible.astype(jnp.int32)  # 1-based
    f_rank = jnp.cumsum(free.astype(jnp.int32)) * free.astype(jnp.int32)
    # match[i, j] = eligible i with rank r goes to free track j with the same rank
    match = (e_rank[:, None] == f_rank[None, :]) & eligible[:, None] & free[None, :]
    peak_for_track = jnp.argmax(match, axis=0)          # (T,)
    has_new = jnp.any(match, axis=0)
    was_active = state.state != OFF
    start_state = jnp.where(was_active, SWITCH, START)
    new_f = jnp.where(has_new, peak_freq[peak_for_track], new_f)
    new_a = jnp.where(has_new, peak_amp[peak_for_track], new_a)
    new_s = jnp.where(has_new, start_state, new_s)

    # Unassigned tracks go inactive with a zeroed peak (:282-289).
    assigned_any = t_asn | has_new
    new_f = jnp.where(assigned_any, new_f, 0.0)
    new_a = jnp.where(assigned_any, new_a, 0.0)

    return TrackerState(new_f, new_a, new_s), chg


class PartialTracker:
    """Object-style wrapper mirroring the reference class API."""

    def __init__(self, n_peaks: int, n_tracks: int, track_changes: bool = False,
                 dtype=jnp.float32):
        self.config = TrackerConfig(max_peaks=n_peaks, max_tracks=n_tracks,
                                    track_changes=track_changes)
        self.dtype = dtype
        self.state = TrackerState.init(n_tracks, dtype)
        self.changes: Optional[Changes] = None

    def set_cost_calculation(self, square_cost: bool, use_pitch: bool, use_db: bool):
        self.config = self.config.with_cost_calculation(square_cost, use_pitch, use_db)

    def set_cost_scaling(self, freq_unit: float, amp_unit: float, max_cost: float):
        self.config = self.config.with_cost_scaling(freq_unit, amp_unit, max_cost)

    def reset(self):
        self.state = TrackerState.init(self.config.max_tracks, self.dtype)
        self.changes = None

    def process(self, freqs, amps, start_threshold: float = 0.0):
        """Track one frame of peaks. freqs/amps: up to max_peaks values."""
        freqs = np.asarray(freqs, np.float64)
        amps = np.asarray(amps, np.float64)
        n = min(len(freqs), self.config.max_peaks)
        pf = np.zeros(self.config.max_peaks)
        pa = np.zeros(self.config.max_peaks)
        pf[:n] = freqs[:n]
        pa[:n] = amps[:n]
        self.state, self.changes = process(
            self.config, self.state,
            jnp.asarray(pf, self.dtype), jnp.asarray(pa, self.dtype),
            n, start_threshold)
        return self.state

    def get_track(self, idx: int):
        return (float(self.state.freq[idx]), float(self.state.amp[idx]),
                int(self.state.state[idx]))

    # change_tracker accessors (reference :296-309) — 0 before the first
    # frame and after reset(), like the reference change_tracker's
    # zero-initialised members.
    def freq_change_sum(self):
        return float(self.changes.freq_sum) if self.changes is not None else 0.0

    def freq_change_abs(self):
        return float(self.changes.freq_abs) if self.changes is not None else 0.0

    def amp_change_sum(self):
        return float(self.changes.amp_sum) if self.changes is not None else 0.0

    def amp_change_abs(self):
        return float(self.changes.amp_abs) if self.changes is not None else 0.0
