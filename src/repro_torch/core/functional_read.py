"""MR-FR: multi-row functional read with PWM word-lines (Fig. 3).

One access reads 4 rows per column in a single precharge; pulse widths
T_i ∝ 2^i make the BL swing proportional to the 4-b sub-word.  The cell
pulls a saturated (≈constant) current while the longest pulse stays under
40 % of the BL RC constant, so the transfer is linear with a small
quadratic residue — modeled as ΔV = δ·c·(1 − β·c).

Sub-ranged merge: V_word = (16·V_MSB + V_LSB) / 17 ∝ the 8-b word, in ONE
precharge.  MD mode adds the *replica-cell read*: the streamed word P is
read as P̄ = 15 − P per sub-word, so the BL develops D + (255 − P).
"""
from __future__ import annotations

import torch

from repro_torch.core import noise as noise_mod
from repro_torch.core.params import DimaParams


def pwm_transfer(code, p: DimaParams, replica: bool = False):
    """BL swing [V] for a summed PWM code (0..15 normal, 0..30 replica)."""
    c = code.to(torch.float32)
    beta = p.md_inl_beta if replica else p.inl_beta
    return p.delta_v_lsb * c * (1.0 - beta * c)


def subrange_merge(v_msb, v_lsb, p: DimaParams, chip=None):
    """(16·V_MSB + V_LSB)/17 with per-column-pair cap-ratio error."""
    eps = 0.0 if chip is None else chip["cap_ratio_err"]
    r = 16.0 * (1.0 + eps)
    return (r * v_msb + v_lsb) / (r + 1.0)


def mr_fr(msb, lsb, p: DimaParams, chip=None, gen=None,
          rep_msb=None, rep_lsb=None):
    """Functional read of one word-row.

    msb/lsb: (..., n_words) int sub-word codes in [0, 15].
    rep_*:   optional replica-array codes (MD mode) added on the same BLs.
    Returns V_word (..., n_words) in volts; read noise is one draw of the
    output's shape from ``gen``.
    """
    m = msb.to(torch.float32)
    l = lsb.to(torch.float32)
    replica = rep_msb is not None
    if replica:
        m = m + rep_msb.to(torch.float32)
        l = l + rep_lsb.to(torch.float32)
    v_m = pwm_transfer(m, p, replica)
    v_l = pwm_transfer(l, p, replica)
    v = subrange_merge(v_m, v_l, p, chip)
    if chip is not None:
        v = v * chip["col_gain"]
    if gen is not None:
        v = v + noise_mod.normal(gen, v.shape, p.sigma_read_mv * 1e-3,
                                 v.device)
    return v


def split_words(words):
    """8-b word -> (msb, lsb) 4-b sub-words (the column-pair layout)."""
    w = torch.as_tensor(words).to(torch.int32)
    return (w >> 4) & 0xF, w & 0xF


def word_gain(p: DimaParams) -> float:
    """Ideal volts per unit of 8-b word value: V = word · δ/17."""
    return p.delta_v_lsb / 17.0
