"""Tap/LUT design vs the reference's inline goldens and generated tables."""

import re

import numpy as np
import pytest

from sdrmodem.dsp import taps as T

# Golden from reference test/test_lpf_taps.c (Fs=8000, cutoff=1750, tw=500).
LPF_GOLDEN = np.array(
    [
        0.00111410965, -0.000583702058, -0.00192639488, 2.30933896e-18,
        0.00368289859, 0.00198723329, -0.0058701504, -0.00666110823,
        0.0068643163, 0.0147596458, -0.00398709066, -0.0259727165,
        -0.0064281947, 0.0387893915, 0.0301109217, -0.0507995859,
        -0.0833103433, 0.0593735874, 0.310160041, 0.437394291,
    ],
    np.float32,
)

# Golden from reference test/test_gaussian_taps.c (gain=1.5, sps=10, bt=0.5, n=12).
GAUSS_GOLDEN = np.array(
    [
        0.039070457, 0.07415177, 0.12205514, 0.17424175, 0.21572968,
        0.23164831, 0.21572968, 0.17424175, 0.12205514, 0.07415177,
        0.039070457, 0.017854061,
    ],
    np.float32,
)


def test_low_pass_taps_golden():
    taps = T.low_pass_taps(1.0, 8000, 1750, 500)
    assert len(taps) == 39
    np.testing.assert_allclose(taps[:20], LPF_GOLDEN, atol=1e-7)
    # symmetric
    np.testing.assert_array_equal(taps, taps[::-1])


@pytest.mark.parametrize(
    "fs,cutoff,tw",
    [(0, 1750, 500), (8000, 5000, 500), (8000, 1750, 0), (8000, 0, 500)],
)
def test_low_pass_taps_bounds(fs, cutoff, tw):
    with pytest.raises(ValueError):
        T.low_pass_taps(1.0, fs, cutoff, tw)


def test_gaussian_taps_golden():
    taps = T.gaussian_taps(1.5, 2 * (48000.0 / 9600), 0.5, 12)
    np.testing.assert_allclose(taps, GAUSS_GOLDEN, atol=1e-7)


def test_convolve():
    # reference test/test_gfsk_mod.c test_convolve
    out = T.convolve_full(np.array([0, 1, 0.5], np.float32), np.array([1, 2, 3], np.float32))
    np.testing.assert_allclose(out, [0, 1, 2.5, 4, 1.5], atol=1e-6)


def _parse_c_float_table(text: str, pattern: str) -> np.ndarray:
    m = re.search(pattern, text, re.S)
    assert m, "table not found in reference source"
    vals = re.findall(r"[-+0-9.eE]+(?=[fF])", m.group(1))
    return np.array([float(v) for v in vals], np.float32)


def test_mmse_table_matches_reference(fixtures_dir):
    """The generated 129x8 bank must equal the C table (reversed rows)."""
    c_rows = np.load(fixtures_dir / "mmse_interp_table.npy")
    assert c_rows.shape == (129, 8)
    mine = T.mmse_interp_taps()
    # our rows are window-ordered = reference rows reversed; the solver
    # reproduces the printed table exactly for >99% of entries, with the
    # rest off by one unit in the 6th significant digit
    ref = c_rows[:, ::-1]
    np.testing.assert_allclose(mine, ref, atol=1.1e-6)
    assert (mine == ref).mean() > 0.99


def test_atan_table_matches_reference(fixtures_dir):
    table = np.load(fixtures_dir / "atan_table.npy")
    assert table.size == 257
    np.testing.assert_allclose(T.atan_table(), table, atol=6e-7)


def test_vendored_tables_match_reference_sources(reference_dir, fixtures_dir):
    """The vendored .npy tables are verbatim extractions of the reference
    C sources (re-parsed here when the checkout is available)."""
    src = (reference_dir / "src/dsp/mmse_fir_interpolator.c").read_text()
    table = _parse_c_float_table(src, r"float taps\[129\]\[8\] = \{(.*?)\};")
    np.testing.assert_array_equal(
        table.reshape(129, 8), np.load(fixtures_dir / "mmse_interp_table.npy")
    )
    src = (reference_dir / "src/math/fast_atan2f.c").read_text()
    table = _parse_c_float_table(src, r"fast_atan_table\[257\] = \{(.*?)\};")
    np.testing.assert_array_equal(table, np.load(fixtures_dir / "atan_table.npy"))


def test_polyphase_roundtrip():
    taps = np.arange(10, dtype=np.float32)
    bank = T.polyphase_taps(taps, 4)  # padded to 12
    assert bank.shape == (4, 3)
    np.testing.assert_array_equal(bank[1], [1, 5, 9])
    np.testing.assert_array_equal(bank[3], [3, 7, 0])
