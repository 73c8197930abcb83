"""CBLP: cross-BL charge-share aggregation (Fig. 4).

Shorting N identical rail caps computes their *mean* — a scaled sum for
free.  Two consecutive access cycles land on two sampling caps and are
charge-shared (mean again); the P_MSB/P_LSB rails merge 16:1 like the
sub-ranged read.
"""
from __future__ import annotations

import torch

from repro_torch.core import adc as adc_mod
from repro_torch.core import noise as noise_mod
from repro_torch.core.params import DimaParams


def column_share(v_cols, p: DimaParams, gen=None):
    """Mean over the active columns: (..., n) -> (...)."""
    v = torch.mean(v_cols, dim=-1)
    if gen is not None:
        v = v + noise_mod.normal(gen, v.shape, p.sigma_cblp_mv * 1e-3,
                                 v.device)
    return v


def cycle_share(v_cycles, p: DimaParams):
    """Mean over the per-cycle sampling caps: (..., n_cycles) -> (...)."""
    return torch.mean(v_cycles, dim=-1)


def rail_merge(v_msb_rail, v_lsb_rail, p: DimaParams):
    """(16·msb + lsb)/17 — same ratio network as the sub-ranged read."""
    return adc_mod.div(16.0 * v_msb_rail + v_lsb_rail, 17.0)
