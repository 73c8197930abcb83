"""BLP: column-pitch-matched bit-line processing (Fig. 4).

DP mode — the mixed-signal capacitive multiplier: an 8-b P is
*sub-ranged* into two 4-b multipliers running in parallel on separate
rails (P_MSB, P_LSB); each computes V·p4/16 by binary charge
redistribution.  Gain/offset mismatch per column from the chip record.

MD mode — the multiplier is reconfigured as a BL sampler; an analog
comparator + mux select BL or BLB, producing |V − V_ref| where the
functional read already developed V ∝ D + (255−P).
"""
from __future__ import annotations

import torch

from repro_torch.core import noise as noise_mod
from repro_torch.core.params import DimaParams


def blp_dp(v_word, p_words, p: DimaParams, chip=None, gen=None):
    """Capacitive multiply: returns (rail_msb, rail_lsb) volts,
    rail_x = V_word · p4 / 16 per column.  Noise: one draw per rail from
    ``gen``, MSB rail first.

    v_word: (..., n) volts; p_words: (..., n) ints in [0, 255].
    """
    pw = torch.as_tensor(p_words).to(torch.int32)
    p_m = ((pw >> 4) & 0xF).to(torch.float32)
    p_l = (pw & 0xF).to(torch.float32)
    g_m = 1.0 if chip is None else chip["mult_gain"][0]
    g_l = 1.0 if chip is None else chip["mult_gain"][1]
    o_m = 0.0 if chip is None else chip["mult_off"][0]
    o_l = 0.0 if chip is None else chip["mult_off"][1]
    # serial charge redistribution leaves a code-dependent residual
    nl_m = 1.0 - p.mult_beta * p_m
    nl_l = 1.0 - p.mult_beta * p_l
    rail_m = v_word * (p_m / 16.0) * nl_m * g_m + o_m * (p_m > 0)
    rail_l = v_word * (p_l / 16.0) * nl_l * g_l + o_l * (p_l > 0)
    if gen is not None:
        sigma = p.sigma_mult_off_mv * 0.3e-3
        rail_m = rail_m + noise_mod.normal(gen, rail_m.shape, sigma,
                                           rail_m.device)
        rail_l = rail_l + noise_mod.normal(gen, rail_l.shape, sigma,
                                           rail_l.device)
    return rail_m, rail_l


def blp_md(v_bl, v_blb, v_ref, p: DimaParams, chip=None, gen=None):
    """Absolute value via the comparator + mux over the BL/BLB pair.

    BL develops f(D + P̄) and BLB the complementary f(D̄ + P); the mux picks
    the larger swing, so the output is f(255 + |D−P|) − f(255).
    Comparator offset noise matters only near D≈P, where the two rails
    are nearly equal — exactly the silicon failure mode.
    """
    off = 0.0
    if gen is not None:
        off = noise_mod.normal(gen, v_bl.shape, p.sigma_cmp_off_mv * 1e-3,
                               v_bl.device)
    pick_bl = (v_bl + off) >= v_blb
    v = torch.where(pick_bl, v_bl, v_blb)
    return torch.clamp_min(v - v_ref, 0.0)
