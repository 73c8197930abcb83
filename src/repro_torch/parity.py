"""The rule every kernel and backend of the port is held to, against its
plain version on the card and against the JAX package on the CPU.

* ADC codes are equal.  A code may differ (by one) only where the plain
  volts lie within ``VOLTS_ATOL`` of an ADC decision boundary — there a
  last-ulp difference in the column sums legitimately flips the
  rounding; the count of such codes is reported.
* Volts agree to ``VOLTS_ATOL`` = 1e-7 V, the tolerance the JAX package
  holds its own Pallas kernels to (about three f32 ulps of the DP full
  scale; the two sides sum 128 columns in different orders).
* ``trimmed`` agrees to ``TRIM_RTOL`` = 1e-6 of the score scale wherever
  the codes agree (the f32 epilogue may round an ulp differently).
"""
from __future__ import annotations

import numpy as np
import torch

VOLTS_ATOL = 1e-7
TRIM_RTOL = 1e-6


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def boundary_distance(volts, v_range, adc_bits: int = 8) -> np.ndarray:
    """Distance in volts from each value to the nearest ADC decision
    boundary ``lo + (k + ½)·(hi − lo)/full``; ``v_range`` is a (lo, hi)
    pair or a (..., 2) array whose leading dims broadcast against
    ``volts``."""
    vr = _np(v_range)
    lo, hi = vr[..., 0:1], vr[..., 1:2]
    if vr.ndim == 1:
        lo, hi = lo[0], hi[0]
    full = 2 ** adc_bits - 1
    step = np.maximum(hi - lo, 1e-9) / full
    x = (_np(volts) - lo) / step
    return np.abs(x - (np.floor(x) + 0.5)) * step


def check_outputs(ref, test, v_range, *, adc_bits: int = 8,
                  volts_atol: float = VOLTS_ATOL,
                  trim_rtol: float = TRIM_RTOL, label: str = "") -> int:
    """Hold ``test`` = (codes, volts[, trimmed]) to the plain ``ref``
    under the rule above.  Raises AssertionError on a violation; returns
    the number of codes that differ at a boundary."""
    tag = f" [{label}]" if label else ""
    c_r, c_t = _np(ref[0]), _np(test[0])
    v_r, v_t = _np(ref[1]), _np(test[1])
    if c_r.shape != c_t.shape or v_r.shape != v_t.shape:
        raise AssertionError(f"shapes differ{tag}: {c_r.shape} vs "
                             f"{c_t.shape}")
    dv = np.abs(v_r - v_t)
    if not (dv <= volts_atol).all():
        i = np.unravel_index(np.argmax(dv), dv.shape)
        raise AssertionError(f"volts differ by {dv[i]:.3e} V > "
                             f"{volts_atol} at {i}{tag}")
    diff = c_r != c_t
    near = boundary_distance(v_r, v_range, adc_bits) <= volts_atol
    bad = diff & ~(near & (np.abs(c_r - c_t) <= 1))
    if bad.any():
        i = tuple(int(j) for j in np.argwhere(bad)[0])
        raise AssertionError(f"ADC codes differ away from a boundary at "
                             f"{i}: {c_r[i]} vs {c_t[i]}{tag}")
    if len(ref) > 2 or len(test) > 2:
        if len(ref) != len(test):
            raise AssertionError(f"one side has no trimmed output{tag}")
        t_r, t_t = _np(ref[2]), _np(test[2])
        scale = max(float(np.abs(t_r).max()), 1e-30)
        dt = np.where(diff, 0.0, np.abs(t_r - t_t))
        if not (dt <= trim_rtol * scale).all():
            i = np.unravel_index(np.argmax(dt), dt.shape)
            raise AssertionError(f"trimmed differs by {dt[i]:.3e} > "
                                 f"{trim_rtol} x {scale:.3e} at {i}{tag}")
    return int(diff.sum())
