"""sort_compress_rows (ops/rowsort.py) against a per-row numpy loop:
keys exact, values to the dtype's tolerance."""

import numpy as np
import pytest

from ia_spgemm_tpu.ops.rowsort import SENTINEL, sort_compress_rows


def _reference(key, val):
    """Per-row loop: sorted unique keys (SENTINEL excluded), float64 sums
    and sums of magnitudes, left-justified."""
    R, W = key.shape
    col = np.full((R, W), -1, np.int64)
    s = np.zeros((R, W))
    mag = np.zeros((R, W))
    nnz = np.zeros(R, np.int64)
    for r in range(R):
        sums, mags = {}, {}
        for k, v in zip(key[r], val[r]):
            if k == SENTINEL:
                continue
            sums[int(k)] = sums.get(int(k), 0.0) + float(v)
            mags[int(k)] = mags.get(int(k), 0.0) + abs(float(v))
        for t, k in enumerate(sorted(sums)):
            col[r, t], s[r, t], mag[r, t] = k, sums[k], mags[k]
        nnz[r] = len(sums)
    return col, s, mag, nnz


def _case(case, rows, width, dtype, rng):
    """sentinel: 30% empty slots; duplicates: keys drawn from width/8
    values (long runs); empty_rows: every third row all SENTINEL."""
    hi = max(width // 8, 1) if case == "duplicates" else 4 * width
    key = rng.integers(0, hi, (rows, width)).astype(np.int32)
    if case == "sentinel":
        key[rng.random((rows, width)) < 0.3] = SENTINEL
    if case == "empty_rows":
        key[::3] = SENTINEL
    val = rng.standard_normal((rows, width)).astype(dtype)
    return key, val


@pytest.mark.parametrize("width", [128, 512, 4096])
@pytest.mark.parametrize("case", ["sentinel", "duplicates", "empty_rows"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sort_compress_rows_matches_numpy(dtype, case, width):
    rng = np.random.default_rng(width + 7 * len(case))
    rows = 4 if width == 4096 else 12
    key, val = _case(case, rows, width, dtype, rng)
    col, v, nnz = sort_compress_rows(key, val, out_width=width)
    want_col, want_v, mag, want_nnz = _reference(key, val)
    np.testing.assert_array_equal(np.asarray(nnz), want_nnz)
    np.testing.assert_array_equal(np.asarray(col), want_col)
    got = np.asarray(v, np.float64)
    # f32 sums: a few ulps of the run's magnitude; f64: exact to 1e-12
    rtol = 1e-6 if dtype == np.float32 else 1e-12
    assert (np.abs(got - want_v) <= rtol * np.maximum(mag, 1e-300)).all()
    assert (got[want_col < 0] == 0).all()


def test_sort_compress_rows_out_width_clamps():
    """A narrower output keeps each row's first out_width survivors and
    clamps the count."""
    rng = np.random.default_rng(3)
    key, val = _case("sentinel", 6, 256, np.float32, rng)
    col, v, nnz = sort_compress_rows(key, val, out_width=32)
    full_col, full_v, full_nnz = sort_compress_rows(key, val, out_width=256)
    np.testing.assert_array_equal(np.asarray(nnz),
                                  np.minimum(np.asarray(full_nnz), 32))
    np.testing.assert_array_equal(np.asarray(col),
                                  np.asarray(full_col)[:, :32])
    np.testing.assert_array_equal(np.asarray(v), np.asarray(full_v)[:, :32])
