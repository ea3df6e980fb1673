"""SGP4/SDP4 propagator tests against the classic NORAD datasets
(reference test/test_sgp4_001.c, test_sgp4_002.c, src/sgpsdp/TR/*.res)."""

import datetime as dt

import numpy as np
import pytest

from sdrmodem.orbit.sdp4 import Sdp4
from sdrmodem.orbit.sgp4 import Sgp4
from sdrmodem.orbit.timeutil import calendar_date, julian_date, theta_g_jd
from sdrmodem.orbit.tle import TleError, parse_tle

SGP4_EXPECTED = [
    (0.0, 2328.97048951, -5995.22076416, 1719.97067261, 2.91207230, -0.98341546, -7.09081703),
    (360.0, 2456.10705566, -6071.93853760, 1222.89727783, 2.67938992, -0.44829041, -7.22879231),
    (720.0, 2567.56195068, -6112.50384522, 713.96397400, 2.44024599, 0.09810869, -7.31995916),
    (1080.0, 2663.09078980, -6115.48229980, 196.39640427, 2.19611958, 0.65241995, -7.36282432),
    (1440.0, 2742.55133057, -6079.67144775, -326.38095856, 1.94850229, 1.21106251, -7.35619372),
]

SDP4_EXPECTED = [
    (0.0, 7473.37066650, 428.95261765, 5828.74786377, 5.10715130, 6.44468284, -0.18613096),
    (360.0, -3305.22537232, 32410.86328125, -24697.17675781, -1.30113538, -1.15131518, -0.28333528),
    (720.0, 14271.28759766, 24110.46411133, -4725.76837158, -0.32050445, 2.67984074, -2.08405289),
    (1080.0, -9990.05883789, 22717.35522461, -23616.89066250, -1.01667246, -2.29026759, 0.72892364),
    (1440.0, 9787.86975097, 33753.34667969, -15030.81176758, -1.09425966, 0.92358845, -1.52230928),
]


def _tle(resources_dir, name):
    return parse_tle((resources_dir / name).read_text().splitlines())


def test_sgp4_test_case_001(resources_dir):
    tle = _tle(resources_dir, "test-001.tle")
    assert not tle.deep_space
    model = Sgp4(tle)
    for t, x, y, z, vx, vy, vz in SGP4_EXPECTED:
        st = model.propagate(t)
        assert max(abs(a - b) for a, b in zip(st.pos, (x, y, z))) < 0.02
        assert max(abs(a - b) for a, b in zip(st.vel, (vx, vy, vz))) < 2e-5


def test_sdp4_test_case_002(resources_dir):
    tle = _tle(resources_dir, "test-002.tle")
    assert tle.deep_space
    model = Sdp4(tle)
    for t, x, y, z, vx, vy, vz in SDP4_EXPECTED:
        st = model.propagate(t)
        assert max(abs(a - b) for a, b in zip(st.pos, (x, y, z))) < 0.05
        assert max(abs(a - b) for a, b in zip(st.vel, (vx, vy, vz))) < 5e-5


def test_tle_checksum_rejected():
    bad = [
        "TEST",
        "1 88888U          80275.98708465  .00073094  13844-3  66816-4 0     8",
        "2 88888  72.8435 115.9689 0086731  52.6988 110.5714 16.05824518   103",
    ]
    with pytest.raises(TleError):
        parse_tle(bad)


def test_julian_date_roundtrip():
    # reference test_sgp4_001.c test_time: 2020-03-10 11:40:49 UTC
    t = 1583840449
    jd = julian_date(t)
    back = calendar_date(jd)
    want = dt.datetime.fromtimestamp(t, dt.timezone.utc)
    assert abs((back - want).total_seconds()) < 1.0


def test_theta_g_jd_range():
    jd = julian_date(1583840449)
    th = theta_g_jd(jd)
    assert 0.0 <= th < 2 * np.pi


def test_solar_position_and_eclipse():
    # reference test_sgp4_001.c test_solar / test_eclipse
    from sdrmodem.orbit.solar import sat_eclipsed, solar_position

    x, y, z, w = solar_position(2458918.986678)
    assert abs(x - 146496240.579853) < 5.0  # km, low-precision ephemeris
    assert abs(y - -22805185.677903) < 5.0
    assert abs(z - -9885914.456200) < 5.0
    assert abs(w - 148589893.002415) < 5.0
    eclipsed, depth = sat_eclipsed(
        (2328.970688, -5995.220856, 1719.970681), 6657.708068, (x, y, z, w)
    )
    assert not eclipsed
    assert abs(depth - -0.780165) < 1e-5


def test_checkpoint_resume_demod(resources_dir):
    """A demod stream restored from a snapshot continues identically
    (SURVEY §5: block-index + DSP-state snapshot makes streams resumable)."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from sdrmodem.dsp.fsk_demod import FskDemodConfig
    from sdrmodem.dsp.pipeline import DemodPipeline
    from sdrmodem.utils.checkpoint import load_state, save_state

    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:24576]
    pipe = DemodPipeline(FskDemodConfig(48000, 4800, 5000, 2, 2000, True), 8192, exact=False)

    s = pipe.streamer()
    a1 = s.process(iq[:8192])
    a2 = s.process(iq[8192:16384])
    with tempfile.NamedTemporaryFile(suffix=".npz") as f:
        save_state(s.state, f.name, meta={"blocks": 2})
        # continue the original
        a3 = s.process(iq[16384:])

        # resume a fresh streamer from the snapshot
        r = pipe.streamer()
        r.state, meta = load_state(r.state, f.name)
        assert meta["blocks"] == 2
        b3 = r.process(iq[16384:])
    np.testing.assert_array_equal(a3, b3)


def test_calculate_ra_dec_range():
    from sdrmodem.orbit.observer import Geodetic, calculate_ra_dec
    from sdrmodem.orbit.sgp4 import Sgp4
    from sdrmodem.orbit.timeutil import julian_date
    from sdrmodem.orbit.tle import parse_tle

    tle = parse_tle([
        "LUCKY-7",
        "1 44406U 19038W   20069.88080907  .00000505  00000-0  32890-4 0  9992",
        "2 44406  97.5270  32.5584 0026284 107.4758 252.9348 15.12089395 37524",
    ])
    st = Sgp4(tle).propagate(0.0)
    geo = Geodetic(lat=np.deg2rad(53.72), lon=np.deg2rad(47.57), alt=0.0)
    ra, dec = calculate_ra_dec(julian_date(1583840449), st.pos, st.vel, geo)
    assert 0.0 <= ra < 2 * np.pi
    assert -np.pi / 2 <= dec <= np.pi / 2
