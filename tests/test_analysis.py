"""Tests for table reading, interpolation, statistics, smoothing, partial tracking."""

import numpy as np
import pytest
import scipy.signal

import jax.numpy as jnp

from hisstools_library.ops import statistics as st
from hisstools_library.ops import smoothing
from hisstools_library.ops.interpolation import InterpType
from hisstools_library.ops.table_reader import EdgeMode, table_read
from hisstools_library.models.partial_tracker import (
    CONTINUE, OFF, START, SWITCH, PartialTracker)


# -- table reader -----------------------------------------------------------------

def test_table_read_linear_matches_interp(rng):
    table = rng.standard_normal(64)
    pos = rng.uniform(0, 63, 100)
    y = np.asarray(table_read(jnp.asarray(table), jnp.asarray(pos),
                              interp=InterpType.Linear, edges=EdgeMode.ZeroPad))
    ref = np.interp(pos, np.arange(64), table)
    assert np.abs(y - ref).max() < 1e-12


def test_table_read_none_is_floor_gather(rng):
    table = rng.standard_normal(32)
    pos = rng.uniform(0, 31, 50)
    y = np.asarray(table_read(jnp.asarray(table), jnp.asarray(pos),
                              interp=InterpType.None_))
    assert np.array_equal(y, table[np.floor(pos).astype(int)])


@pytest.mark.parametrize("edges,expect", [
    (EdgeMode.ZeroPad, [0.0, 0.0]),
    (EdgeMode.Extend, [10.0, 13.0]),
    (EdgeMode.Wrap, [13.0, 10.0]),      # idx -1 -> last, idx 4 -> first
    (EdgeMode.Fold, [11.0, 12.0]),      # reflect without edge repeat
    (EdgeMode.Mirror, [10.0, 13.0]),    # reflect with edge repeat
])
def test_edge_modes_integer_positions(edges, expect):
    table = jnp.asarray([10.0, 11.0, 12.0, 13.0])
    pos = jnp.asarray([-1.0, 4.0])
    y = np.asarray(table_read(table, pos, interp=InterpType.None_, edges=edges))
    assert np.allclose(y, expect), (edges, y)


def test_extrapolate_linear():
    table = jnp.asarray([0.0, 1.0, 2.0, 3.0])
    # beyond the end, linear extrapolation continues the slope
    y = np.asarray(table_read(table, jnp.asarray([4.0]), interp=InterpType.Linear,
                              edges=EdgeMode.Extrapolate))
    assert abs(y[0] - 4.0) < 1e-9


def test_bound_clamps_positions():
    table = jnp.asarray([1.0, 2.0, 3.0])
    y = np.asarray(table_read(table, jnp.asarray([-5.0, 10.0]),
                              interp=InterpType.Linear, edges=EdgeMode.ZeroPad,
                              bound=True))
    assert np.allclose(y, [1.0, 3.0])


def test_cubic_interpolators_reproduce_polynomials():
    # Hermite and Lagrange interpolate cubics exactly on uniform grids
    from hisstools_library.ops.interpolation import (
        cubic_hermite_interp, cubic_lagrange_interp)
    f = lambda t: 0.3 * t ** 2 - t + 2
    y = [f(-1), f(0), f(1), f(2)]
    for x in (0.25, 0.5, 0.9):
        assert abs(cubic_lagrange_interp(x, *y) - f(x)) < 1e-12
        assert abs(cubic_hermite_interp(x, *y) - f(x)) < 1e-12


def test_table_read_mul_scale(rng):
    table = rng.standard_normal(16)
    pos = jnp.asarray([3.0])
    y = np.asarray(table_read(jnp.asarray(table), pos, mul=2.0, scale=3.0,
                              interp=InterpType.None_))
    assert abs(y[0] - 6.0 * table[3]) < 1e-12


# -- statistics --------------------------------------------------------------------

def test_statistics_against_numpy(rng):
    x = np.abs(rng.standard_normal(256)) + 0.1
    xj = jnp.asarray(x)
    assert abs(float(st.stat_mean(xj)) - x.mean()) < 1e-12
    assert abs(float(st.stat_sum_abs(xj)) - np.abs(x).sum()) < 1e-9
    assert abs(float(st.stat_sum_squares(xj)) - (x * x).sum()) < 1e-9
    assert abs(float(st.stat_variance(xj)) - x.var()) < 1e-9
    assert abs(float(st.stat_standard_deviation(xj)) - x.std()) < 1e-9
    assert abs(float(st.stat_rms(xj)) - np.sqrt((x * x).mean())) < 1e-12
    assert abs(float(st.stat_crest(xj)) - x.max() / np.sqrt((x * x).mean())) < 1e-12
    assert abs(float(st.stat_geometric_mean(xj)) -
               np.exp(np.log(x).sum() / len(x))) < 1e-9
    assert abs(float(st.stat_flatness(xj)) -
               np.exp(np.log(x).mean()) / x.mean()) < 1e-12
    assert float(st.stat_min(xj)) == x.min()
    assert float(st.stat_max_position(xj)) == float(np.argmax(x))
    assert float(st.stat_count_above(xj, 0.5)) == float((x > 0.5).sum())
    assert abs(float(st.stat_ratio_below(xj, 0.5)) - (x < 0.5).mean()) < 1e-12
    assert abs(float(st.stat_product(jnp.asarray(x[:10]))) - np.prod(x[:10])) < 1e-9


def test_position_empty_input_integer_dtype():
    # Round-2 weakness: empty input returned float -inf while non-empty returned
    # an integer index. Now both are the same integer dtype (-1 when empty).
    empty = jnp.zeros((0,))
    full = jnp.asarray([3.0, 1.0, 2.0])
    for fn in (st.stat_min_position, st.stat_max_position):
        e, f = fn(empty), fn(full)
        assert jnp.issubdtype(e.dtype, jnp.integer)
        assert e.dtype == f.dtype
        assert int(e) == -1
    assert int(st.stat_min_position(full)) == 1
    assert int(st.stat_max_position(full)) == 0


def test_shape_statistics(rng):
    x = np.abs(rng.standard_normal(128)) + 0.01
    xj = jnp.asarray(x)
    idx = np.arange(128.0)
    centroid = (idx * x).sum() / x.sum()
    assert abs(float(st.stat_centroid(xj)) - centroid) < 1e-9
    spread = np.sqrt((((idx - centroid) ** 2) * x).sum() / x.sum())
    assert abs(float(st.stat_spread(xj)) - spread) < 1e-9
    skew = (((idx - centroid) ** 3) * x).sum() / (spread ** 3 * x.sum())
    assert abs(float(st.stat_skewness(xj)) - skew) < 1e-9
    kurt = (((idx - centroid) ** 4) * x).sum() / (spread ** 4 * x.sum())
    assert abs(float(st.stat_kurtosis(xj)) - kurt) < 1e-9


def test_pdf_percentile():
    x = jnp.asarray([1.0, 1.0, 1.0, 1.0])
    # 50% of total (=2.0) reached at index 1 exactly
    assert abs(float(st.stat_pdf_percentile(x, 50.0)) - 1.0) < 1e-12
    assert abs(float(st.stat_pdf_percentile(x, 100.0)) - 3.0) < 1e-12


def test_log_shape_statistics(rng):
    x = np.abs(rng.standard_normal(64)) + 0.1
    li = np.array([0.0] + [np.log2(i) for i in range(1, 64)])
    lc = 2 ** ((li * x).sum() / x.sum())
    assert abs(float(st.stat_log_centroid(jnp.asarray(x))) - lc) < 1e-9


# -- kernel smoother ----------------------------------------------------------------

def test_smooth_constant_width_uniform_kernel(rng):
    # A rect kernel with constant width is a moving average.
    x = rng.standard_normal(200)
    kern = np.ones(8)
    y = np.asarray(smoothing.smooth(jnp.asarray(x), kern, 9.0, 9.0,
                                    symmetric=False, edges=smoothing.EdgeMode.ZeroPad))
    # width 9 non-symmetric, NonZero ends -> filter length 9 of ones, gain 1/9,
    # centred window: out[k] = mean(x[k-4 .. k+4])
    pad = np.concatenate([np.zeros(4), x, np.zeros(4)])
    ref = np.array([pad[k: k + 9].mean() for k in range(200)])
    assert np.abs(y - ref).max() < 1e-9


def test_smooth_preserves_dc_extend(rng):
    x = np.ones(150)
    kern = scipy.signal.windows.hann(32)[16:]  # decaying half-window
    y = np.asarray(smoothing.smooth(jnp.asarray(x), kern, 5.0, 40.0,
                                    symmetric=True, edges=smoothing.EdgeMode.Extend))
    assert np.abs(y - 1.0).max() < 1e-6  # unit-sum normalisation keeps DC


def test_smooth_variable_width_no_nans(rng):
    x = rng.standard_normal(300)
    kern = scipy.signal.windows.hann(64)
    for edges in smoothing.EdgeMode:
        y = np.asarray(smoothing.smooth(jnp.asarray(x), kern, 1.0, 80.0,
                                        symmetric=False, edges=edges))
        assert y.shape == (300,)
        assert np.all(np.isfinite(y)), edges


def test_smooth_wide_uses_fft_same_result(rng):
    # Straddle the FFT heuristic: same input smoothed with widths just below and
    # above the switch must agree with a direct computation.
    x = rng.standard_normal(400)
    kern = scipy.signal.windows.hann(128)
    y = np.asarray(smoothing.smooth(jnp.asarray(x), kern, 80.0, 80.0,
                                    symmetric=False, edges=smoothing.EdgeMode.ZeroPad))
    # direct oracle
    from hisstools_library.ops.smoothing import _Ends, _resample_kernel
    filt = _resample_kernel(kern, 79, _Ends.Zero)  # width 2*40-1, ends Zero (hann)
    gain = 1.0 / filt.sum()
    pad = np.concatenate([np.zeros(40), x, np.zeros(40)])
    ref = np.convolve(pad, filt)[79: 79 + 400] * gain
    assert np.abs(y - ref).max() < 1e-6


# -- partial tracker ----------------------------------------------------------------

def test_tracker_basic_assignment():
    pt = PartialTracker(10, 10, dtype=jnp.float64)
    freqs = [100.0 * (i + 1) for i in range(10)]
    amps = [0.1 * (i + 1) for i in range(10)]
    pt.process(freqs, amps, start_threshold=0.0)
    states = [pt.get_track(i)[2] for i in range(10)]
    assert all(s == START for s in states)
    # Same peaks again: everything continues
    pt.process(freqs, amps)
    states = [pt.get_track(i)[2] for i in range(10)]
    assert all(s == CONTINUE for s in states)
    # Tracks hold the peaks in input order
    assert [pt.get_track(i)[0] for i in range(10)] == freqs


def test_tracker_nearest_assignment():
    pt = PartialTracker(4, 4, dtype=jnp.float64)
    pt.set_cost_calculation(True, False, False)  # raw freq/amp distance
    pt.set_cost_scaling(10.0, 1.0, 10.0)
    pt.process([100.0, 200.0], [1.0, 1.0])
    # slightly moved peaks keep their tracks
    pt.process([103.0, 196.0], [1.0, 1.0])
    assert abs(pt.get_track(0)[0] - 103.0) < 1e-9
    assert abs(pt.get_track(1)[0] - 196.0) < 1e-9
    assert pt.get_track(0)[2] == CONTINUE


def test_tracker_kill_and_switch():
    pt = PartialTracker(4, 2, dtype=jnp.float64)
    pt.set_cost_calculation(True, False, False)
    pt.set_cost_scaling(1.0, 1.0, 4.0)
    pt.process([100.0, 200.0], [1.0, 1.0])
    # peak far from both tracks: lowest-index track gets switched, other dies
    pt.process([500.0], [1.0])
    s0 = pt.get_track(0)
    s1 = pt.get_track(1)
    assert s0[2] == SWITCH and abs(s0[0] - 500.0) < 1e-9
    assert s1[2] == OFF


def test_tracker_start_threshold():
    pt = PartialTracker(4, 4, dtype=jnp.float64)
    pt.process([100.0, 200.0], [0.5, 0.05], start_threshold=0.1)
    assert pt.get_track(0)[2] == START
    assert pt.get_track(1)[2] == OFF  # below threshold never starts


def test_tracker_max_cost_gate():
    pt = PartialTracker(2, 2, dtype=jnp.float64)
    pt.set_cost_calculation(False, False, False)
    pt.set_cost_scaling(1.0, 1.0, 0.5)  # max cost 0.5
    pt.process([100.0], [1.0])
    pt.process([100.4], [1.0])  # cost 0.4 < 0.5: continue
    assert pt.get_track(0)[2] == CONTINUE
    pt.process([101.0], [1.0])  # cost 0.6 > 0.5: switch (new track start on track 0)
    assert pt.get_track(0)[2] == SWITCH


def test_tracker_change_stats():
    pt = PartialTracker(4, 4, track_changes=True, dtype=jnp.float64)
    pt.set_cost_calculation(False, False, False)
    pt.set_cost_scaling(10.0, 10.0, 10.0)
    pt.process([100.0, 200.0], [1.0, 2.0])
    pt.process([101.0, 198.0], [1.5, 1.0])
    assert abs(pt.freq_change_sum() - (1.0 - 2.0) / 2) < 1e-9
    assert abs(pt.freq_change_abs() - (1.0 + 2.0) / 2) < 1e-9
    assert abs(pt.amp_change_sum() - (0.5 - 1.0) / 2) < 1e-9
    assert abs(pt.amp_change_abs() - (0.5 + 1.0) / 2) < 1e-9


def test_smooth_vectorised_matches_group_path(rng):
    """The single-graph filter-bank path == the per-width-group path (the
    latter forced by a batch large enough to exceed the materialisation
    budget)."""
    import jax.numpy as jnp
    from hisstools_library.ops import smoothing, windows

    L = 4096
    k = np.asarray(windows.hann(63, dtype=jnp.float64))[31:]
    # 64 * 4096 * W(=255) = 67M elements > 2^25: forces the group path.
    big = rng.standard_normal((64, L)).astype(np.float32)
    small = big[:3]
    y_group = smoothing.smooth(jnp.asarray(big), k, 2.0, 256.0, symmetric=True,
                               edges=smoothing.EdgeMode.Extend)
    y_vec = smoothing.smooth(jnp.asarray(small), k, 2.0, 256.0, symmetric=True,
                             edges=smoothing.EdgeMode.Extend)
    ref = np.asarray(y_group[:3], np.float64)
    d = np.asarray(y_vec, np.float64) - ref
    snr = 10 * np.log10((ref * ref).sum() / max((d * d).sum(), 1e-300))
    assert snr > 100.0


def test_tracker_change_accessors_before_process():
    """change accessors are 0 before any frame and after reset() (the
    reference change_tracker's zero-initialised members, PartialTracker.hpp),
    not an AttributeError on the None changes."""
    tr = PartialTracker(8, 8, track_changes=True, dtype=jnp.float64)
    assert tr.freq_change_sum() == 0.0
    assert tr.freq_change_abs() == 0.0
    assert tr.amp_change_sum() == 0.0
    assert tr.amp_change_abs() == 0.0
    tr.process([100.0, 200.0], [1.0, 0.5], start_threshold=0.1)
    tr.process([101.0, 201.0], [1.1, 0.6], start_threshold=0.1)
    assert tr.freq_change_abs() > 0.0
    tr.reset()
    assert tr.freq_change_abs() == 0.0


def test_statistics_count_dtype_matches_input():
    """Counts return in the input's float width (f64 under x64) — an f32
    count loses integer exactness above 2^24 elements."""
    x = jnp.asarray(np.ones(100), jnp.float64)
    assert st.stat_count_above(x, 0.5).dtype == jnp.float64
    assert st.stat_count_below(x, 0.5).dtype == jnp.float64


def test_statistics_count_exact_for_bf16_input():
    """Counts from half-width inputs are exact: bf16 integers round above
    2^8, so counts promote to f32 rather than inheriting the input dtype."""
    x = jnp.ones(301, jnp.bfloat16)
    c = st.stat_count_above(x, 0.5)
    assert float(c) == 301.0 and c.dtype == jnp.float32


def test_statistics_remaining_surface(rng):
    """Direct oracle checks for the stat_* functions not covered above
    (reference Statistics.hpp:67-382)."""
    x = np.abs(rng.standard_normal(100)) + 0.01
    w = np.abs(rng.standard_normal(100))
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    idx = np.arange(100.0)
    assert float(st.stat_length(xj)) == 100
    assert float(st.stat_max(xj)) == x.max()
    assert float(st.stat_min(xj)) == x.min()
    assert float(st.stat_min_position(xj)) == float(np.argmin(x))
    assert abs(float(st.stat_sum(xj)) - x.sum()) < 1e-9
    assert abs(float(st.stat_sum_logs(xj)) - np.log(x).sum()) < 1e-9
    assert abs(float(st.stat_ratio_above(xj, 0.5)) - (x > 0.5).mean()) < 1e-12
    assert abs(float(st.stat_weighted_sum(xj)) - (idx * x).sum()) < 1e-8
    assert abs(float(st.stat_weighted_sum(xj, wj)) - (w * x).sum()) < 1e-9
    assert abs(float(st.stat_weighted_sum_abs(xj, wj)) - (w * np.abs(x)).sum()) < 1e-9
    assert abs(float(st.stat_weighted_sum_squares(xj, wj)) - (w * x * x).sum()) < 1e-9
    assert abs(float(st.stat_weighted_sum_logs(xj, wj)) - (w * np.log(x)).sum()) < 1e-9
    assert abs(float(st.stat_mean_squares(xj)) - (x * x).mean()) < 1e-9
    # log-domain shape family vs direct formulas (reference :330-360)
    li = np.array([0.0] + [np.log2(i) for i in range(1, 100)])
    lc = (li * x).sum() / x.sum()
    spread = np.sqrt((((li - lc) ** 2) * x).sum() / x.sum())
    assert abs(float(st.stat_log_spread(xj)) - spread) < 1e-9
    skew = (((li - lc) ** 3) * x).sum() / (spread ** 3 * x.sum())
    assert abs(float(st.stat_log_skewness(xj)) - skew) < 1e-8
    kurt = (((li - lc) ** 4) * x).sum() / (spread ** 4 * x.sum())
    assert abs(float(st.stat_log_kurtosis(xj)) - kurt) < 1e-8


def test_device_rng_helpers():
    """device_uniform/device_gaussian: jax-native RNG conveniences."""
    from hisstools_library.utils import device_uniform, device_gaussian
    import jax
    k = jax.random.PRNGKey(0)
    u = np.asarray(device_uniform(k, (4096,)))
    assert u.shape == (4096,) and 0.0 <= u.min() and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.03
    g = np.asarray(device_gaussian(k, (4096,)))
    assert abs(g.mean()) < 0.06 and abs(g.std() - 1.0) < 0.06


def test_tracker_parallel_rounds_match_sequential_greedy():
    """The parallel local-dominant extraction (round 3) is EXACTLY the
    sequential greedy: randomized frames, including deliberate cost ties,
    against a numpy sort+scan oracle of the reference algorithm
    (PartialTracker.hpp:224-289: sort costs ascending, assign skipping used
    peaks/tracks, stable in peak-major generation order)."""
    import jax.numpy as jnp
    from hisstools_library.models import partial_tracker as pt

    rng = np.random.default_rng(42)
    pk = tr = 8
    cfg = pt.TrackerConfig(max_peaks=pk, max_tracks=tr, square_cost=False,
                           use_pitch=False, use_db=False,
                           freq_scale=1.0, amp_scale=0.0, max_cost=1e9)

    for trial in range(40):
        tf = rng.uniform(0, 100, tr)
        pf = rng.uniform(0, 100, pk)
        if trial % 3 == 0:
            # Force ties: quantize costs coarsely.
            tf = np.round(tf / 10) * 10
            pf = np.round(pf / 10) * 10
        ta = np.ones(tr)
        pa = np.ones(pk)

        # numpy oracle: cost = |pf_i - tf_j|; stable ascending sort over
        # peak-major order, greedy skip-used scan.
        cost = np.abs(pf[:, None] - tf[None, :])
        order = np.argsort(cost.reshape(-1), kind="stable")
        used_p = np.zeros(pk, bool)
        used_t = np.zeros(tr, bool)
        assign = {}
        for k in order:
            i, j = divmod(k, tr)
            if not used_p[i] and not used_t[j]:
                used_p[i] = used_t[j] = True
                assign[j] = i

        st = pt.TrackerState(jnp.asarray(tf, jnp.float32),
                             jnp.asarray(ta, jnp.float32),
                             jnp.full((tr,), pt.CONTINUE, jnp.int32))
        new_st, _ = pt.process(cfg, st, jnp.asarray(pf, jnp.float32),
                               jnp.asarray(pa, jnp.float32), pk, 1e9)
        got = np.asarray(new_st.freq)
        for j in range(tr):
            if j in assign and np.asarray(new_st.state)[j] == pt.CONTINUE:
                assert got[j] == np.float32(pf[assign[j]]), (trial, j)
