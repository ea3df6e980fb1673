"""Plain-numpy emulation of the reference C stream blocks.

Executable specification used as the test oracle: each function implements
the *stateful, chunked* semantics of the corresponding C block (history
buffers, carried scalars) so the JAX whole-stream kernels can be checked
for both numerics and chunk-size invariance against it.

These are behavioural re-implementations written from the survey of
src/dsp/*.c — NOT ports of the C code (no volk, no buffers); they serve
the same role as the reference's own big/small-buffer unit tests.
"""

from __future__ import annotations

import numpy as np

from sdrmodem.dsp import taps as taps_mod


class RefFir:
    """src/dsp/fir_filter.c: decimating FIR with carried history."""

    def __init__(self, taps, decimation, complex_input=False):
        self.taps = np.asarray(taps, np.float32)
        self.d = decimation
        dtype = np.complex64 if complex_input else np.float32
        self.hist = np.zeros(len(self.taps) - 1, dtype)

    def process(self, x):
        work = np.concatenate([self.hist, x])
        t = len(self.taps)
        outs = []
        i = 0
        while i + t <= len(work):
            seg = work[i : i + t]
            # C accumulates the dot product sequentially in float32
            acc = np.complex64(0) if np.iscomplexobj(work) else np.float32(0)
            for j in range(t):
                acc = (acc + seg[j] * self.taps[t - 1 - j]).astype(acc.dtype)
            outs.append(acc)
            i += self.d
        self.hist = work[i:]
        return np.array(outs, work.dtype)


class RefQuadDemod:
    """src/dsp/quadrature_demod.c: y = gain * atan2(x[n] * conj(x[n-1]))."""

    def __init__(self, gain):
        self.gain = np.float32(gain)
        self.prev = np.complex64(0)

    def process(self, x):
        out = np.empty(len(x), np.float32)
        for i, v in enumerate(x):
            p = np.complex64(v) * np.conj(self.prev)
            # fast_atan2f returns 0 unless |y|>0 or |x|>0 (handles ±0 and NaN)
            if not (abs(p.imag) > 0 or abs(p.real) > 0):
                out[i] = 0.0
            else:
                out[i] = self.gain * np.float32(np.arctan2(p.imag, p.real))
            self.prev = np.complex64(v)
        return out


class RefMovingAverage:
    """src/dsp/dc_blocker.c moving_average_process (running-sum recurrence)."""

    def __init__(self, length):
        self.delay = np.zeros(length - 1, np.float32)
        self.in_delayed = np.float32(0)
        self.out_d1 = np.float32(0)
        self.length = length

    def step(self, x):
        in_old = self.in_delayed
        self.in_delayed = self.delay[0]
        self.delay[:-1] = self.delay[1:]
        self.delay[-1] = x
        y = np.float32(np.float32(x) - in_old + self.out_d1)
        self.out_d1 = y
        return np.float32(y / np.float32(self.length))


class RefDcBlocker:
    """src/dsp/dc_blocker.c: delayed input minus 4-stage moving average."""

    def __init__(self, length):
        self.mas = [RefMovingAverage(length) for _ in range(4)]
        self.delay = np.zeros(length - 1, np.float32)

    def process(self, x):
        out = np.empty(len(x), np.float32)
        for i, v in enumerate(x):
            y = np.float32(v)
            for ma in self.mas:
                y = ma.step(y)
            d = self.delay[0]
            self.delay[:-1] = self.delay[1:]
            self.delay[-1] = self.mas[0].in_delayed
            out[i] = np.float32(d - y)
        return out


class RefClockMM:
    """src/dsp/clock_recovery_mm.c Mueller & Müller loop."""

    def __init__(self, omega, gain_omega, mu, gain_mu, omega_relative_limit):
        self.omega = np.float32(omega)
        self.omega_mid = np.float32(omega)
        self.omega_lim = np.float32(self.omega_mid * np.float32(omega_relative_limit))
        self.gain_omega = np.float32(gain_omega)
        self.mu = np.float32(mu)
        self.gain_mu = np.float32(gain_mu)
        self.last = np.float32(0)
        self.hist = np.zeros(0, np.float32)
        self.banks = taps_mod.mmse_interp_taps()

    def process(self, x):
        work = np.concatenate([self.hist, np.asarray(x, np.float32)])
        n = len(work)
        if n < 8:
            self.hist = work
            return np.zeros(0, np.float32)
        outs = []
        ii = 0
        previous = 0
        while ii <= n - 8:
            imu = int(np.round(self.mu * 128))
            window = work[ii : ii + 8]
            y = np.float32(0)
            for j in range(8):
                y = np.float32(y + window[j] * self.banks[imu][j])
            if np.isnan(y):
                outs.append(np.float32(0))
                previous = ii
                ii += int(np.floor(self.omega))
                continue
            sl = lambda v: np.float32(-1.0) if v < 0 else np.float32(1.0)
            mm = np.float32(sl(self.last) * y - sl(y) * self.last)
            self.last = y
            previous = ii
            om = np.float32(self.omega + self.gain_omega * mm)
            dev = np.float32(om - self.omega_mid)
            clipped = np.float32(
                np.float32(0.5) * (np.abs(dev + self.omega_lim) - np.abs(dev - self.omega_lim))
            )
            self.omega = np.float32(self.omega_mid + clipped)
            self.mu = np.float32(self.mu + self.omega + self.gain_mu * mm)
            stride = int(np.floor(self.mu))
            self.mu = np.float32(self.mu - np.floor(self.mu))
            ii += stride
            outs.append(y)
        last_index = previous if ii > n else ii
        self.hist = work[last_index:]
        return np.array(outs, np.float32)


class RefFreqModulator:
    """src/dsp/frequency_modulator.c VCO with float32 phase accumulation."""

    def __init__(self, sensitivity):
        self.sens = np.float32(sensitivity)
        self.phase = np.float32(0)

    def process(self, x):
        out = np.empty(len(x), np.complex64)
        two_pi = np.float32(2 * np.pi)
        for i, v in enumerate(x):
            self.phase = np.float32(self.phase + self.sens * np.float32(v))
            if self.phase < -two_pi:
                self.phase = np.float32(self.phase + two_pi)
            if self.phase > two_pi:
                self.phase = np.float32(self.phase - two_pi)
            out[i] = np.cos(np.float64(self.phase)) + 1j * np.sin(np.float64(self.phase))
        return out


class RefSigSource:
    """src/dsp/sig_source.c NCO with float32 phase accumulation."""

    def __init__(self, sampling_freq, amplitude=1.0):
        self.fs = sampling_freq
        self.amp = np.float32(amplitude)
        self.phase = np.float32(0)

    def process(self, freq, n):
        adj = np.float32(np.float32(2 * np.pi) * np.float32(freq) / np.float32(self.fs))
        out = np.empty(n, np.complex64)
        two_pi = np.float32(2 * np.pi)
        for i in range(n):
            out[i] = self.amp * (np.cos(np.float64(self.phase)) + 1j * np.sin(np.float64(self.phase)))
            self.phase = np.float32(self.phase + adj)
            if self.phase < -two_pi:
                self.phase = np.float32(self.phase + two_pi)
            if self.phase > two_pi:
                self.phase = np.float32(self.phase - two_pi)
        return out

    def multiply(self, freq, x):
        return (np.asarray(x, np.complex64) * self.process(freq, len(x))).astype(np.complex64)
