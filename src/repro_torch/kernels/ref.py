"""Plain PyTorch versions of the DIMA kernels (the targets every CUDA
kernel is held to).

The refs take *explicit* noise arrays (kernels must be bitwise-
reproducible); with zero noise they match ``core.pipeline``.  They keep
the kernels' operation order, so on the CPU they also agree with the JAX
package's ``repro.kernels.ref`` fed the same arrays.

Shapes generalise the JAX refs with leading batch dims: ``d`` is
(..., M, 256) and ``q`` (..., 256), broadcast as ``d`` against
``q[..., None, :]``; noise is (..., M, ...); ``v_range`` is a (lo, hi)
pair or a (..., 2) tensor whose leading dims broadcast against the
output's leading dims.  The kernel wrappers (kernels/dima_dp.py,
dima_md.py) call these for CPU tensors with the bank/query axes laid out
so.
"""
from __future__ import annotations

import torch

from repro_torch.core import adc as adc_mod
from repro_torch.core.params import DimaParams


def _transfer(c, p: DimaParams, replica: bool):
    beta = p.md_inl_beta if replica else p.inl_beta
    return p.delta_v_lsb * c * (1.0 - beta * c)


def _mr_fr(words, p, col_gain, cap_eps, read_noise, rep_words=None):
    """words: (..., 128) int32; returns volts (..., 128)."""
    m = ((words >> 4) & 0xF).to(torch.float32)
    l = (words & 0xF).to(torch.float32)
    replica = rep_words is not None
    if replica:
        m = m + ((rep_words >> 4) & 0xF).to(torch.float32)
        l = l + (rep_words & 0xF).to(torch.float32)
    vm = _transfer(m, p, replica)
    vl = _transfer(l, p, replica)
    r = 16.0 * (1.0 + cap_eps)
    v = (r * vm + vl) / (r + 1.0)
    return v * col_gain + read_noise


def _split(d, q):
    """(..., M, 256) rows and (..., 256) queries as int32 (.., 2, 128)
    access cycles, the query broadcast over M."""
    d2 = d.to(torch.int32).reshape(d.shape[:-1] + (2, 128))
    q2 = q.to(torch.int32).reshape(q.shape[:-1] + (1, 2, 128))
    return d2, q2


def _window(v_range, like):
    vr = adc_mod.window(v_range, like.device)
    return vr[..., 0:1], vr[..., 1:2]


def _adc(v, v_range, p: DimaParams):
    lo, hi = _window(v_range, v)
    full = 2 ** p.adc_bits - 1
    x = (v - lo) / torch.clamp_min(hi - lo, 1e-9)
    return torch.clamp(torch.round(x * full), 0, full).to(torch.int32)


def dima_dp_ref(d, q, p: DimaParams, col_gain, cap_eps, mult_gain, mult_off,
                read_noise, cblp_noise, v_range):
    """d: (..., M, 256) uint8; q: (..., 256) uint8; noise: read
    (..., M, 2, 128), cblp (..., M, 2, 2) [row, cycle, rail]; returns
    (codes (..., M) int32, volts (..., M) f32)."""
    d2, q2 = _split(d, q)
    v_word = _mr_fr(d2, p, col_gain, cap_eps, read_noise)      # (..,M,2,128)
    pm = ((q2 >> 4) & 0xF).to(torch.float32)
    pl = (q2 & 0xF).to(torch.float32)
    nl_m = 1.0 - p.mult_beta * pm
    nl_l = 1.0 - p.mult_beta * pl
    rail_m = v_word * (pm / 16.0) * nl_m * mult_gain[0] \
        + mult_off[0] * (pm > 0)
    rail_l = v_word * (pl / 16.0) * nl_l * mult_gain[1] \
        + mult_off[1] * (pl > 0)
    vm = rail_m.mean(-1) + cblp_noise[..., 0]                  # (..., M, 2)
    vl = rail_l.mean(-1) + cblp_noise[..., 1]
    v = adc_mod.div(16.0 * vm.mean(-1) + vl.mean(-1), 17.0)     # (..., M)
    return _adc(v, v_range, p), v


def dima_md_ref(d, q, p: DimaParams, col_gain, cap_eps, cmp_noise,
                read_noise, read_noise_b, cblp_noise, v_range):
    """MD mode with the dual-rail (BL/BLB) comparator; shapes as dp_ref,
    cmp_noise (..., M, 2, 128), read_noise_b (..., M, 2, 128), cblp
    (..., M, 2)."""
    d2, q2 = _split(d, q)
    v_bl = _mr_fr(d2, p, col_gain, cap_eps, read_noise, rep_words=255 - q2)
    v_blb = _mr_fr(255 - d2, p, col_gain, cap_eps, read_noise_b,
                   rep_words=q2)
    m15 = torch.tensor(15.0, device=d2.device)
    vref = adc_mod.div(16.0 * _transfer(m15, p, True)
                       + _transfer(m15, p, True), 17.0)
    pick = (v_bl + cmp_noise) >= v_blb
    v_abs = torch.clamp_min(torch.where(pick, v_bl, v_blb) - vref, 0.0)
    v = v_abs.mean(-1) + cblp_noise                            # (..., M, 2)
    v = v.mean(-1)
    return _adc(v, v_range, p), v


def trim_ref(code, v_range, ep, gain: float, p: DimaParams):
    """The kernels' fused calibration epilogue: ``ep`` (..., 4) rows
    ``[c0, c1, c2, Σq]`` broadcast over M; the same operation order as
    ``pipeline.trim_epilogue`` (dac -> dot units -> affine trim)."""
    lo, hi = _window(v_range, code)
    full = float(2 ** p.adc_bits - 1)
    vd = lo + adc_mod.div(code.to(torch.float32), full) * (hi - lo)
    dot_hat = adc_mod.div(vd, gain) * p.dims_per_conversion
    return (ep[..., 0:1] * dot_hat + ep[..., 1:2] * ep[..., 3:4]) \
        + ep[..., 2:3]
