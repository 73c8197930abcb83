"""The port's constants, ADC, energy model, noise and behavioral pipeline
held against the JAX package on the CPU.

The same numpy inputs and the chip record carried over from JAX's
``sample_chip(PRNGKey(7))`` go through both packages at zero noise
(``key=None`` / ``gen=None``).  Tolerance (``repro_torch.parity``):
codes equal except at an ADC boundary, volts to 1e-7 V.  Digital
arithmetic and the energy model are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import energy as jenergy
from repro.core import noise as jnoise
from repro.core import pipeline as jpl
from repro.core.params import BankVariation as JaxVariation
from repro.core.params import DimaParams as JaxParams
from repro_torch import convert, parity
from repro_torch.configs.dima_paper import CONFIG
from repro_torch.core import adc as tadc
from repro_torch.core import energy as tenergy
from repro_torch.core import noise as tnoise
from repro_torch.core import pipeline as tpl
from repro_torch.core.params import BankVariation, DimaParams

P = DimaParams()
JP = JaxParams()
CHIP_J = jnoise.sample_chip(jax.random.PRNGKey(7), JP)
CHIP_T = convert.chip_from_jax({k: np.asarray(v) for k, v in CHIP_J.items()},
                               device="cpu")


def _words(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


def test_params_field_for_field():
    assert dataclasses.asdict(P) == dataclasses.asdict(JP)
    assert convert.params_from_jax(dataclasses.asdict(JP)) == P == CONFIG
    assert dataclasses.asdict(BankVariation()) == dataclasses.asdict(
        JaxVariation())
    for name in ("words_per_access", "word_rows", "dims_per_conversion",
                 "v_fs_subword"):
        assert getattr(P, name) == getattr(JP, name), name
    assert P.with_delta_v(0.02) == convert.params_from_jax(
        dataclasses.asdict(JP.with_delta_v(0.02)))
    with pytest.raises(TypeError):
        convert.params_from_jax({"no_such_field": 1})


def test_energy_equal_floats():
    for app in tenergy.APP_ARGS:
        for arch in ("dima", "conv"):
            for mb in (False, True):
                a = jenergy.app_cost(JP, app, arch=arch, multi_bank=mb)
                b = tenergy.app_cost(P, app, arch=arch, multi_bank=mb)
                assert dataclasses.astuple(a) == dataclasses.astuple(b)
                assert (a.throughput_dec_s, a.edp_fj_s) == (
                    b.throughput_dec_s, b.edp_fj_s)
    for kw in (dict(n_dims=512), dict(n_dims=300, mode="md", n_ops=7,
                                       n_sort=3, delta_v_scale=0.6),
               dict(n_dims=256, multi_bank=True, n_banks=8)):
        assert tenergy.dima_decision(P, **kw) == \
            tenergy.Cost(*dataclasses.astuple(jenergy.dima_decision(JP,
                                                                   **kw)))
    assert tenergy.PAPER_TABLE == jenergy.PAPER_TABLE
    assert tenergy.PAPER_DIGITAL == jenergy.PAPER_DIGITAL
    assert tenergy.access_reduction(P) == jenergy.access_reduction(JP)
    assert tenergy.PAPER_TABLE["mf"][0] == 481.5
    assert abs(tenergy.app_cost(P, "mf").energy_pj - 481.5) < 5


def test_adc_dac_and_calibrate_range():
    v = np.random.default_rng(0).uniform(-0.01, 0.4, 4096).astype(np.float32)
    for lo, hi in ((0.0, 0.35), (0.013, 0.27)):
        a = jadc.adc(jnp.asarray(v), lo, hi, JP)
        b = tadc.adc(torch.from_numpy(v), lo, hi, P)
        parity.check_outputs((a, v), (b, v), (lo, hi))
        codes = np.arange(256, dtype=np.int32)
        np.testing.assert_array_equal(
            np.asarray(jadc.dac(jnp.asarray(codes), lo, hi, JP)),
            tadc.dac(torch.from_numpy(codes), lo, hi, P).numpy())
    assert jadc.calibrate_range(jnp.asarray(v)) == \
        tadc.calibrate_range(torch.from_numpy(v))
    c = torch.tensor([3, 200, 7])
    assert tadc.slice_binary(c, 100).tolist() == [0, 1, 0]
    assert int(tadc.slice_argmin(c)) == 0 and int(tadc.slice_argmax(c)) == 1


@pytest.mark.parametrize("mode", ["dp", "md"])
@pytest.mark.parametrize("n", [256, 200])
def test_pipeline_ops_match_jax_at_zero_noise(mode, n):
    """dima_dot/dima_manhattan with broadcasting, dima_matvec and
    dima_matmat, with the JAX chip record, default and programmed
    windows."""
    d, qs = _words(n, 64, n), _words(n + 1, 3, n)
    f_j = jpl.dima_dot if mode == "dp" else jpl.dima_manhattan
    f_t = tpl.dima_dot if mode == "dp" else tpl.dima_manhattan
    full = (255.0 * 255.0 * jpl.dp_gain(JP) if mode == "dp"
            else 255.0 * jpl.md_gain(JP))
    for vr in (None, (0.02 * full, 0.7 * full)):
        window = vr or (0.0, full)
        a = f_j(jnp.asarray(d)[None], jnp.asarray(qs)[:, None], JP, CHIP_J,
                None, vr)
        b = f_t(torch.from_numpy(d)[None], torch.from_numpy(qs)[:, None], P,
                CHIP_T, None, vr)
        assert a.n_cycles == b.n_cycles and tuple(b.code.shape) == (3, 64)
        parity.check_outputs(a[:2], b[:2], window, label="dot")
        a = jpl.dima_matvec(jnp.asarray(d), jnp.asarray(qs[0]), JP, CHIP_J,
                            None, mode, vr)
        b = tpl.dima_matvec(torch.from_numpy(d), torch.from_numpy(qs[0]), P,
                            CHIP_T, None, mode, vr)
        assert (a.n_cycles, a.n_conversions) == (b.n_cycles, b.n_conversions)
        parity.check_outputs(a[:2], b[:2], window, label="matvec")
        a = jpl.dima_matmat(jnp.asarray(d), jnp.asarray(qs), JP, None, None,
                            mode, vr)
        b = tpl.dima_matmat(torch.from_numpy(d), torch.from_numpy(qs), P,
                            None, None, mode, vr)
        parity.check_outputs(a, b, window, label="matmat")


def test_digital_decode_and_trim_epilogue():
    d, qs = _words(1, 16, 256), _words(2, 3, 256)
    dj, qj = jnp.asarray(d)[None], jnp.asarray(qs)[:, None]
    dt, qt = torch.from_numpy(d)[None], torch.from_numpy(qs)[:, None]
    np.testing.assert_array_equal(np.asarray(jpl.digital_dot(dj, qj)),
                                  tpl.digital_dot(dt, qt).numpy())
    np.testing.assert_array_equal(np.asarray(jpl.digital_manhattan(dj, qj)),
                                  tpl.digital_manhattan(dt, qt).numpy())
    assert tpl.digital_dot(dt, qt).dtype == torch.int32
    codes = np.arange(256, dtype=np.int32)
    for mode, f_j, f_t in (("dp", jpl.code_to_dot, tpl.code_to_dot),
                           ("md", jpl.code_to_md, tpl.code_to_md)):
        np.testing.assert_array_equal(
            np.asarray(f_j(jnp.asarray(codes), JP)),
            f_t(torch.from_numpy(codes), P).numpy())
        qsum = np.float32(qs[0].sum())
        for vr in (None, (0.001, 0.2)):
            a = np.asarray(jpl.trim_epilogue(jnp.asarray(codes), qsum,
                                             (0.9, -0.3, 4.0), JP, vr, mode))
            b = tpl.trim_epilogue(torch.from_numpy(codes), qsum,
                                  (0.9, -0.3, 4.0), P, vr, mode).numpy()
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-6 * np.abs(a).max())
    assert tpl.dp_gain(P) == jpl.dp_gain(JP)
    assert tpl.md_gain(P) == jpl.md_gain(JP)
    assert tpl._cycles_per_op(100, P) == jpl._cycles_per_op(100, JP)
    x = torch.ones(3, 100, dtype=torch.int32)
    assert tuple(tpl._pad_to_conversion(x, P).shape) == (3, 256)


def test_noise_generators():
    gen = torch.Generator().manual_seed(7)
    chip = tnoise.sample_chip(gen, P, device="cpu")
    ideal = tnoise.ideal_chip(P, device="cpu")
    for k in tnoise.CHIP_KEYS:
        assert chip[k].shape == CHIP_T[k].shape == ideal[k].shape
        assert chip[k].dtype == torch.float32
    assert abs(float(chip["col_gain"].std()) - P.sigma_gain_col) < 0.002
    # a CPU generator gives the same chip again
    again = tnoise.sample_chip(torch.Generator().manual_seed(7), P, "cpu")
    assert all(torch.equal(chip[k], again[k]) for k in tnoise.CHIP_KEYS)
    # fold_in: deterministic in the parent's state, does not advance it,
    # and distinct children draw distinct streams
    state = gen.get_state()
    a0 = torch.randn(4, generator=tnoise.fold_in(gen, 0))
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(a0, torch.randn(4, generator=tnoise.fold_in(gen, 0)))
    kids = tnoise.split(gen, 3)
    draws = [torch.randn(4, generator=k) for k in kids]
    assert torch.equal(draws[0], a0)
    assert not torch.equal(draws[1], draws[2])
    assert torch.equal(tnoise.normal(None, (2, 3), 0.1, "cpu"),
                       torch.zeros(2, 3))


@pytest.mark.parametrize("mode", ["dp", "md"])
def test_pipeline_noise_is_centred(mode):
    """Noisy reads scatter around the zero-noise value with about the
    per-op spread the noise budget implies (statistical: the generators
    differ from JAX's)."""
    d, q = _words(21, 512, 256), _words(22, 256)
    f = tpl.dima_dot if mode == "dp" else tpl.dima_manhattan
    quiet = f(torch.from_numpy(d), torch.from_numpy(q), P, CHIP_T, None)
    noisy = f(torch.from_numpy(d), torch.from_numpy(q), P, CHIP_T,
              torch.Generator().manual_seed(3))
    dv = (noisy.volts - quiet.volts).double()
    sigma = P.sigma_cblp_mv * 1e-3 / 2 ** 0.5     # the smallest term alone
    assert abs(float(dv.mean())) < 0.5 * float(dv.std()) + 1e-7
    assert sigma * 0.5 < float(dv.std()) < 1e-3
