"""Circuit/timing/energy constants of the prototype chip (Fig. 7) plus the
behavioral-model knobs.  All defaults are either stated in the paper or
calibrated so the model reproduces the paper's measured tables — each
calibrated constant says so.  See DESIGN.md §2 and benchmarks/bench_dima.py.

The port's copy of ``repro.core.params``, field for field: both packages
must compute with the same constants (``convert.params_from_jax``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class DimaParams:
    # ---- array geometry (Fig. 7) ------------------------------------------
    n_rows: int = 512              # bit-cell rows
    n_cols: int = 256              # bit-cell columns
    bits_per_word: int = 8         # 8-b data D and stream P
    sub_bits: int = 4              # sub-ranged: 4 MSBs + 4 LSBs in a column pair
    # derived: 128 word-rows × 128 words/access; 256-dim vector = 2 accesses

    # ---- voltages / analog transfer ---------------------------------------
    vdd_core: float = 1.0          # V (Fig. 7)
    vdd_ctrl: float = 0.85         # V (Fig. 7)
    v_pre: float = 1.0             # BL precharge voltage
    delta_v_lsb: float = 0.025     # V per LSB of a 4-b sub-word (Fig. 5 sweep)
    # quadratic INL of the functional read; calibrated so best-fit-line
    # residual = 0.03 LSB (8-b) max at full scale (Fig. 3 measured INL).
    # The PWM pulse widths + trim caps are calibrated for single-word codes
    # (≤15 per sub-word); replica *addition* (MD mode) drives the BL to
    # double the calibrated range where curvature is much larger —
    # md_inl_beta captures that, calibrated to Fig. 4's 8.6 % MD envelope.
    inl_beta: float = 5.0e-5       # relative curvature per code (calibrated)
    md_inl_beta: float = 1.9e-3    # replica-add regime curvature (calibrated)
    # BLP capacitive-multiplier code-dependent compression (residual charge
    # of the serial bit evaluation); calibrated to Fig. 4's 5.8 % DP envelope
    mult_beta: float = 4.0e-3

    # ---- mismatch / noise (calibrated to Fig. 4 error envelopes; the
    # envelopes are dominated by the systematic betas above — the random
    # budget is set so app-level accuracy degradation stays ≤1 %, Fig. 6) --
    sigma_read_mv: float = 0.25    # additive BL noise per functional read [mV]
    sigma_gain_col: float = 0.004  # per-column-pair gain mismatch (1σ)
    sigma_cap_ratio: float = 0.002 # 16:1 merge cap ratio error (1σ, tuned caps)
    sigma_mult_gain: float = 0.008 # BLP capacitive-multiplier gain mismatch
    sigma_mult_off_mv: float = 0.5 # BLP multiplier offset [mV]
    sigma_cmp_off_mv: float = 1.0  # MD comparator offset [mV]
    sigma_cblp_mv: float = 0.15    # CBLP rail noise [mV]
    adc_bits: int = 8

    # ---- timing (calibrated to Fig. 6/7 throughput; see energy.py) --------
    t_cycle_ns: float = 23.06      # MR-FR + BLP + CBLP pipelined access cycle
    t_adc_ns: float = 247.9        # 8-b single-slope conversion (≈256 @1GHz)
    t_cycle_conv_ns: float = 53.0  # conventional full-swing read cycle

    # ---- energy (calibrated; derivation in energy.py doc) -----------------
    e_cycle_dp_pj: float = 96.5    # per access cycle, DP mode (128 col pairs)
    e_cycle_md_pj: float = 105.3   # per access cycle, MD mode (replica read)
    e_adc_pj: float = 30.0         # per 8-b single-slope conversion
    e_fixed_conv_pj: float = 258.4 # CTRL/clock per conversion (multi-bank amortized)
    e_digital_overhead_pj: float = 0.0   # slicer etc. (absorbed in e_fixed)
    e_sort_pj: float = 26.0        # per-candidate digital sort/vote (TM/KNN)
    # conventional (65 nm, paper-quoted): 5 pJ / 8-b SRAM read, 1 pJ / 8-b MAC
    e_read_8b_pj: float = 5.0
    e_mac_8b_pj: float = 1.0
    e_absdiff_8b_pj: float = 0.5
    # memory->processor transfer + ctrl per 256-dim block; calibrated so the
    # DP-mode baseline matches the paper's digital table (SVM 4.5 nJ,
    # MF 2.25≈2.2 nJ -> 9.7x multi-bank savings) and the MD-mode baseline
    # reproduces the quoted 3.7x measured MD savings.
    e_fixed_digital_pj: float = 714.0
    e_fixed_digital_md_pj: float = 508.0

    # MR-FR linearity constraint: longest PWM pulse < 40 % of BL RC constant
    pwm_max_frac_rc: float = 0.4

    n_banks_multibank: int = 32    # the paper's multi-bank scenario

    # ---- derived ----------------------------------------------------------
    @property
    def words_per_access(self) -> int:     # 128 8-b words per precharge
        return self.n_cols // 2

    @property
    def word_rows(self) -> int:            # 128
        return self.n_rows // self.sub_bits

    @property
    def dims_per_conversion(self) -> int:  # 2 cycles charge-shared per ADC
        return 2 * self.words_per_access

    @property
    def v_fs_subword(self) -> float:       # full-scale 4-b sub-word swing
        return self.delta_v_lsb * (2 ** self.sub_bits - 1)

    def with_delta_v(self, delta_v_lsb: float) -> "DimaParams":
        """Fig. 5 sweep: scaling ΔV_BL trades energy against SNR (the
        additive noise floors stay fixed, so lower swing = lower SNR)."""
        return replace(self, delta_v_lsb=delta_v_lsb)


@dataclass(frozen=True)
class BankVariation:
    """Fleet-scale chip-to-chip variation + temporal drift of a bank
    population (all off by default — a ``BankVariation()`` is inert and
    every execution path stays bitwise-identical to the single-chip
    model).

    The prototype's ≤1 % accuracy claim is one 65 nm die; a fleet runs
    thousands of banks that are *not* identical and that drift (the PCM
    in-memory chip, arXiv:2212.02872, shows per-core variation and
    conductance drift dominate accuracy at scale).  This record is the
    behavioral model of both effects:

    * **chip-to-chip** (``sigma_scale``): bank ``b`` samples its own
      fixed-pattern mismatch record with every ``sigma_*`` field scaled
      by a per-bank severity ``s_b = max(0, 1 + sigma_scale·N(0,1))``
      drawn from ``fold_in(key, b)`` — some banks are golden, some are
      outliers (noise.sample_bank_chips).
    * **temporal drift** (``drift_*``): per epoch (a wall-clock or
      per-token tick the owner defines), every bank's BL gain takes a
      multiplicative random-walk step of 1σ ``drift_gain_sigma`` on top
      of a deterministic fractional loss ``drift_gain_decay`` (the
      PCM-style monotone conductance decay), and its analog offset
      takes an additive walk of 1σ ``drift_offset_sigma_mv`` mV
      (noise.step_drift / apply_drift).

    In the port only the record exists so far: the bank population, the
    drift walk and the robust multibank path that consume it are still
    to be ported (``MultiBankBackend`` refuses a ``variation``).
    """
    sigma_scale: float = 0.0          # 1σ of per-bank sigma_* scaling
    drift_gain_sigma: float = 0.0     # per-epoch gain random-walk step (1σ)
    drift_gain_decay: float = 0.0     # per-epoch deterministic gain loss
    drift_offset_sigma_mv: float = 0.0  # per-epoch offset walk step [mV]

    @property
    def varies(self) -> bool:
        """True when banks differ chip-to-chip."""
        return self.sigma_scale != 0.0

    @property
    def drifts(self) -> bool:
        """True when the drift process has any non-zero step."""
        return (self.drift_gain_sigma != 0.0 or self.drift_gain_decay != 0.0
                or self.drift_offset_sigma_mv != 0.0)

    @property
    def enabled(self) -> bool:
        return self.varies or self.drifts
