"""Shared mixed-signal calibration for the unified backend API.

1. **ADC range**: push calibration data through the *ideal* chain
   (no mismatch, no noise) and program (v_min, v_max) from the observed
   swing with headroom — the paper's per-application auto-ranging.
2. **Affine trim** (signed apps): a least-squares affine map from the
   analog features ``[decoded dot, Σquery]`` onto the digital score,
   fitted once on calibration data, removes the systematic part of the
   BLP multiplier's compression.

``calibrate(backend, stored, cal_queries, ...) -> Calibration`` packages
both; ``trimmed_scores`` applies the trim at query time.  The fit and the
float64 oracle ``apply_trim`` are numpy, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import adc as adc_mod
from repro_torch.core import api as api_mod
from repro_torch.core import noise as noise_mod


class Calibration(NamedTuple):
    mode: str                              # "dp" | "md"
    v_range: Tuple[float, float]           # programmed ADC range
    coef: Optional[np.ndarray] = None      # affine trim (None = range only)


def affine_trim(feats_cal, target_cal) -> np.ndarray:
    """Least-squares affine trim: feats (B, k) -> target (B,) coefficient
    vector (k+1, incl. intercept) — the standard mixed-signal trim."""
    A = np.concatenate([feats_cal, np.ones((len(feats_cal), 1))], axis=1)
    coef, *_ = np.linalg.lstsq(A.astype(np.float64),
                               np.asarray(target_cal, np.float64), rcond=None)
    return coef


def apply_trim(coef, feats) -> np.ndarray:
    A = np.concatenate([feats, np.ones((len(feats), 1))], axis=1)
    return A.astype(np.float64) @ coef


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def analog_feats(backend: api_mod.DimaBackend, stored, queries, *,
                 mode="dp", gen=None, v_range=None) -> np.ndarray:
    """The controller-known feature pair per query: the decoded (chunked)
    analog result and Σquery (needed to remove the offset-binary cross
    term digitally)."""
    dot_hat = _numpy(api_mod.chunked_dot(backend, stored, queries,
                                         mode=mode, gen=gen,
                                         v_range=v_range))
    q_sum = _numpy(queries).astype(np.float64).sum(-1)
    return np.stack([dot_hat, np.broadcast_to(q_sum, dot_hat.shape)], axis=1)


def calibrate_range(backend: api_mod.DimaBackend, stored, cal_queries, *,
                    mode="dp", margin=0.05) -> Tuple[float, float]:
    """Program (v_min, v_max) from a zero-noise ideal-chip pass over the
    calibration set, one conversion per 256-dim chunk."""
    ideal = backend.ideal()
    stored = ideal._t(stored)
    cal_queries = ideal._t(cal_queries)
    n = max(stored.shape[-1], cal_queries.shape[-1])
    volts = []
    for a, b in api_mod.iter_chunks(n, ideal.p.dims_per_conversion):
        out = ideal.dot(stored[..., a:b], cal_queries[..., a:b], mode=mode)
        volts.append(out.volts.reshape(-1))
    return adc_mod.calibrate_range(torch.cat(volts), margin)


def calibrate(backend: api_mod.DimaBackend, stored, cal_queries, *,
              mode="dp", target=None, gen=None, margin=0.05) -> Calibration:
    """Full calibration: ADC range (ideal-chip pass) + optional affine
    trim fitted on this backend's actual chip/noise (``gen``) against the
    digital ``target`` scores."""
    v_range = calibrate_range(backend, stored, cal_queries, mode=mode,
                              margin=margin)
    coef = None
    if target is not None:
        feats = analog_feats(backend, stored, cal_queries, mode=mode,
                             gen=gen, v_range=v_range)
        coef = affine_trim(feats, target)
    return Calibration(mode, v_range, coef)


def trimmed_scores(cal: Calibration, backend: api_mod.DimaBackend, stored,
                   queries, *, gen=None, fused=None) -> np.ndarray:
    """Analog scores through the fitted trim (query-time path of the
    signed applications).

    When the operand fits one conversion, ``fused=None`` (auto) runs the
    whole chain as ONE backend op with the fused epilogue
    (``trim=cal.coef`` -> ``DimaOut.trimmed``) under the chunked path's
    single-chunk generator ``fold_in(gen, 0)``, so the ADC codes are the
    chunked path's and the scores agree to f32 (``apply_trim`` is the
    float64 oracle).  Multi-chunk operands take the chunked path (the
    trim is fitted on the *summed* decoded chunks, which no single launch
    sees)."""
    if cal.coef is None:
        raise ValueError("calibration was fitted without a target")
    stored = backend._t(stored)
    queries = backend._t(queries)
    n = max(stored.shape[-1], queries.shape[-1])
    one_chunk = n <= backend.p.dims_per_conversion
    if fused is None:
        fused = one_chunk
    if fused:
        if not one_chunk:
            raise ValueError(
                f"fused trimmed_scores needs a single-conversion operand "
                f"(n={n} > {backend.p.dims_per_conversion}); the chunked "
                "path decodes per chunk before the trim — pass "
                "fused=False")
        g0 = None if gen is None else noise_mod.fold_in(gen, 0)
        out = backend.dot(stored, queries, mode=cal.mode, gen=g0,
                          v_range=cal.v_range,
                          trim=np.asarray(cal.coef, np.float32))
        return _numpy(out.trimmed).astype(np.float64)
    feats = analog_feats(backend, stored, queries, mode=cal.mode, gen=gen,
                         v_range=cal.v_range)
    return apply_trim(cal.coef, feats)
