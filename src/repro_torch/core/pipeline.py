"""The full 4-stage deep in-memory pipeline (Fig. 1/2):

    MR-FR  →  BLP  →  CBLP  →  ADC & slice

``dima_dot`` / ``dima_manhattan`` process one ≤256-dim operation per ADC
conversion (two access cycles of 128 words charge-shared, exactly the
prototype's dataflow).  Everything broadcasts over leading batch dims
(queries × stored vectors × banks): the per-cycle work runs on a
(..., n_cycles, 128) view in one pass, and noise is drawn at the full
broadcast shape, so every (query, row) read has its own noise.

A parallel exact *digital reference* implements the conventional
architecture's arithmetic for the ≤1 %-accuracy-gap experiments.

Noise order (the port's rule in place of the JAX key splits): DP draws
read noise, then BLP MSB-rail and LSB-rail noise, then CBLP MSB-rail and
LSB-rail noise; MD draws BL read, BLB read, comparator offset, CBLP — all
from ``gen`` in that order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import adc as adc_mod
from repro_torch.core import blp as blp_mod
from repro_torch.core import cblp as cblp_mod
from repro_torch.core import functional_read as fr
from repro_torch.core.params import DimaParams


class DimaOut(NamedTuple):
    code: torch.Tensor       # ADC output (int32)
    volts: torch.Tensor      # pre-ADC analog value
    n_cycles: int            # access cycles consumed (energy/timing model)
    n_conversions: int
    # trimmed scores when the op ran with a fused calibration epilogue
    # (``trim=coef``); None on the plain code/volts path
    trimmed: Optional[torch.Tensor] = None


def _pad_to_conversion(x, p: DimaParams):
    n = x.shape[-1]
    full = p.dims_per_conversion
    if n < full:
        x = F.pad(x, (0, full - n))
    return x


def dp_gain(p: DimaParams) -> float:
    """Ideal volts per unit of mean(D·P):  V = mean_j(D_j P_j) · G.

    Two 17s: D's sub-range merge and P's rail merge; 16: the 4-b
    capacitive multiplier's charge division."""
    return fr.word_gain(p) / (16.0 * 17.0)


def md_gain(p: DimaParams) -> float:
    """Ideal volts per unit of mean(|D−P|)."""
    return fr.word_gain(p)


def _cycle_split(x, n_cycles, w):
    """(..., n_cycles·w) -> (..., n_cycles, w)."""
    return x.reshape(x.shape[:-1] + (n_cycles, w))


def _operands(d_words, p_words, p: DimaParams):
    """int32, padded to one conversion, broadcast to a common shape and
    split into (..., n_cycles, 128) access cycles."""
    d = _pad_to_conversion(torch.as_tensor(d_words).to(torch.int32), p)
    q = _pad_to_conversion(torch.as_tensor(p_words).to(torch.int32), p)
    d, q = torch.broadcast_tensors(d, q)
    w = p.words_per_access
    n_cycles = d.shape[-1] // w
    return _cycle_split(d, n_cycles, w), _cycle_split(q, n_cycles, w), \
        n_cycles


def dima_dot(d_words, p_words, p: DimaParams, chip=None, gen=None,
             v_range=None) -> DimaOut:
    """Dot product mode. d_words/p_words: (..., n≤256) ints in [0,255].

    Returns ADC code ≈ mean_j(D_j·P_j)·G mapped onto (v_min, v_max).
    """
    d_c, q_c, n_cycles = _operands(d_words, p_words, p)
    msb, lsb = fr.split_words(d_c)
    v_word = fr.mr_fr(msb, lsb, p, chip, gen)
    rm, rl = blp_mod.blp_dp(v_word, q_c, p, chip, gen)
    rails_m = cblp_mod.column_share(rm, p, gen)
    rails_l = cblp_mod.column_share(rl, p, gen)

    v_m = cblp_mod.cycle_share(rails_m, p)
    v_l = cblp_mod.cycle_share(rails_l, p)
    v = cblp_mod.rail_merge(v_m, v_l, p)

    if v_range is None:
        v_range = (0.0, 255.0 * 255.0 * dp_gain(p))
    code = adc_mod.adc(v, v_range[0], v_range[1], p)
    return DimaOut(code, v, n_cycles, 1)


def dima_manhattan(d_words, p_words, p: DimaParams, chip=None, gen=None,
                   v_range=None) -> DimaOut:
    """Manhattan-distance mode: replica read develops D + (255−P); the
    comparator/mux takes |·−ref|; CBLP averages."""
    d_c, q_c, n_cycles = _operands(d_words, p_words, p)
    dev = d_c.device

    # the comparator reference: both rails at D = P (word value 255 summed)
    fifteen = torch.full((1,), 15, device=dev)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    v_ref = fr.mr_fr(fifteen, fifteen, p, None, None, rep_msb=zero,
                     rep_lsb=zero)[0]

    msb, lsb = fr.split_words(d_c)
    pm, plw = fr.split_words(255 - q_c)          # replica stores P̄
    v_bl = fr.mr_fr(msb, lsb, p, chip, gen, rep_msb=pm, rep_lsb=plw)
    dm, dl = fr.split_words(255 - d_c)           # BLB: complementary cell
    qm, ql = fr.split_words(q_c)
    v_blb = fr.mr_fr(dm, dl, p, chip, gen, rep_msb=qm, rep_lsb=ql)
    v_abs = blp_mod.blp_md(v_bl, v_blb, v_ref, p, chip, gen)
    outs = cblp_mod.column_share(v_abs, p, gen)

    v = cblp_mod.cycle_share(outs, p)
    if v_range is None:
        v_range = (0.0, 255.0 * md_gain(p))
    code = adc_mod.adc(v, v_range[0], v_range[1], p)
    return DimaOut(code, v, n_cycles, 1)


def _cycles_per_op(n, p: DimaParams) -> int:
    return max(n, p.dims_per_conversion) // p.words_per_access


def dima_matvec(d_mat, p_vec, p: DimaParams, chip=None, gen=None,
                mode="dp", v_range=None) -> DimaOut:
    """All stored vectors against one query: d_mat (m, n), p_vec (n,).
    Physically: m×(n/128) access cycles on one bank, or m/32 of that in
    the 32-bank scenario — accounted by energy.py, computed in one
    broadcast pass."""
    d_mat = torch.as_tensor(d_mat)
    m = d_mat.shape[0]
    f = dima_dot if mode == "dp" else dima_manhattan
    out = f(d_mat, p_vec, p, chip, gen, v_range)
    return DimaOut(out.code, out.volts,
                   m * _cycles_per_op(d_mat.shape[-1], p), m)


def dima_matmat(d_mat, p_mat, p: DimaParams, chip=None, gen=None,
                mode="dp", v_range=None):
    """All stored vectors against a query batch: d_mat (m, n), p_mat
    (b, n) -> (code (b, m), volts (b, m))."""
    f = dima_dot if mode == "dp" else dima_manhattan
    d_mat = torch.as_tensor(d_mat)
    p_mat = torch.as_tensor(p_mat)
    return f(d_mat[None, :, :], p_mat[:, None, :], p, chip, gen,
             v_range)[:2]


# ---------------------------------------------------------------------------
# conventional-architecture digital reference (exact 8-b arithmetic)
# ---------------------------------------------------------------------------

def digital_dot(d_words, p_words):
    d = torch.as_tensor(d_words).to(torch.int32)
    q = torch.as_tensor(p_words).to(torch.int32)
    return torch.sum(d * q, dim=-1).to(torch.int32)   # ≤ 256·255² < 2³¹


def digital_manhattan(d_words, p_words):
    d = torch.as_tensor(d_words).to(torch.int32)
    q = torch.as_tensor(p_words).to(torch.int32)
    return torch.sum(torch.abs(d - q), dim=-1).to(torch.int32)


def code_to_dot(code, p: DimaParams, v_range=None):
    """Decode an ADC code back to dot-product units (for comparisons).
    The CBLP mean is over dims_per_conversion (zero-padded), so the sum
    rescales by that fixed count."""
    if v_range is None:
        v_range = (0.0, 255.0 * 255.0 * dp_gain(p))
    v = adc_mod.dac(code, v_range[0], v_range[1], p)
    return v / dp_gain(p) * p.dims_per_conversion


def code_to_md(code, p: DimaParams, v_range=None):
    if v_range is None:
        v_range = (0.0, 255.0 * md_gain(p))
    v = adc_mod.dac(code, v_range[0], v_range[1], p)
    return v / md_gain(p) * p.dims_per_conversion


def trim_epilogue(code, q_sum, coef, p: DimaParams, v_range=None,
                  mode="dp"):
    """The calibration epilogue as ONE float32 expression: decode the ADC
    code to dot units and apply the affine trim ``c₀·d̂ + c₁·Σq + c₂``
    (``calibration.affine_trim``'s feature order).

    The CUDA kernels (csrc/dima_{dp,md}.cu) inline this operation order.
    ``v_range`` is cast to float32 up front — the kernels carry it as a
    f32 operand, and a float64 window here would break code parity.
    Cross-substrate comparisons of ``trimmed`` use a ~1e-6 relative
    tolerance (the f32 chain may round differently by an ulp)."""
    gain = dp_gain(p) if mode == "dp" else md_gain(p)
    if v_range is None:
        full_val = 255.0 * 255.0 if mode == "dp" else 255.0
        v_range = (0.0, full_val * gain)
    dev = code.device
    vr = adc_mod.window(v_range, dev)
    v = adc_mod.dac(code, vr[0], vr[1], p)
    dot_hat = adc_mod.div(v, gain) * p.dims_per_conversion
    c = torch.as_tensor(coef, dtype=torch.float32).to(dev).reshape(3)
    q_sum = torch.as_tensor(q_sum, dtype=torch.float32).to(dev)
    return (c[0] * dot_hat + c[1] * q_sum) + c[2]
