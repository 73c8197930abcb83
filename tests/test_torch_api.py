"""The port's backend API held against the JAX package's backends.

The port's own ``PARITY_CASES`` matrix: each port backend against the JAX
backend of the same name (the port's ``kernel`` against JAX's ``pallas``,
Pallas in interpret mode), at zero noise, with the chip record carried
over from JAX's ``sample_chip(PRNGKey(7))``.  Every op — dot in each
supported layout, manhattan, matvec and matmat over a ragged row count,
with and without the fused trim — must agree under ``repro_torch.parity``
(codes equal except at an ADC boundary, volts to 1e-7 V, trimmed to 1e-6
of the score scale) with equal cycle/conversion accounting.
"""
import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import calibration as jcal
from repro.core import noise as jnoise
from repro.core import pipeline as jpl
from repro.core.params import DimaParams as JaxParams
from repro_torch import convert, parity
from repro_torch.core import api as tapi
from repro_torch.core import calibration as tcal
from repro_torch.core import noise as tnoise
from repro_torch.core.params import BankVariation, DimaParams
from repro_torch.kernels import dima_dp

P = DimaParams()
JP = JaxParams()
CHIP_J = jnoise.sample_chip(jax.random.PRNGKey(7), JP)
CHIP_T = convert.chip_from_jax({k: np.asarray(v) for k, v in CHIP_J.items()},
                               device="cpu")
TRIM = (0.97, -0.4, 12.5)
rng = np.random.default_rng(0)
D = rng.integers(0, 256, (70, 200)).astype(np.uint8)     # ragged m and n
QS = rng.integers(0, 256, (2, 200)).astype(np.uint8)


class Case(NamedTuple):
    name: str
    kwargs: dict
    jax_name: str
    jax_kwargs: dict

    @property
    def id(self):
        kw = ",".join(f"{k}={v}" for k, v in sorted(self.kwargs.items()))
        return f"{self.name}({kw})~{self.jax_name}"


#: the port's parity matrix: (port backend, JAX backend of the same name)
PARITY_CASES = (
    Case("digital", {}, "digital", {}),
    Case("reference", {}, "reference", {}),
    Case("kernel", {}, "pallas", {}),
    Case("multibank", {"n_banks": 1, "inner": "reference"}, "multibank",
         {"n_banks": 1}),
    Case("multibank", {"n_banks": 32, "inner": "reference"}, "multibank",
         {"n_banks": 32}),
    Case("multibank", {"n_banks": 8, "inner": "kernel"}, "multibank",
         {"n_banks": 8, "inner": "pallas"}),
    Case("multibank", {"n_banks": 32, "inner": "kernel"}, "multibank",
         {"n_banks": 32, "inner": "pallas"}),
)


def _pair(case):
    chip = case.name != "digital"
    j = japi.get_backend(case.jax_name, JP, CHIP_J if chip else None,
                         **case.jax_kwargs)
    t = tapi.get_backend(case.name, P, CHIP_T if chip else None,
                         device="cpu", **case.kwargs)
    return j, t


def _assert_same(a, b, window, label):
    parity.check_outputs(a[:2] if a.trimmed is None else
                         (a.code, a.volts, a.trimmed),
                         b[:2] if b.trimmed is None else
                         (b.code, b.volts, b.trimmed), window, label=label)
    assert (a.n_cycles, a.n_conversions) == (b.n_cycles, b.n_conversions), \
        label


@pytest.mark.parametrize("mode", ["dp", "md"])
@pytest.mark.parametrize("case", PARITY_CASES, ids=[c.id for c in
                                                    PARITY_CASES])
def test_backend_matches_jax_backend(case, mode):
    j, t = _pair(case)
    full = (255.0 * 255.0 * jpl.dp_gain(JP) if mode == "dp"
            else 255.0 * jpl.md_gain(JP))
    vr = (0.02 * full, 0.8 * full)
    Dj, Qj = jnp.asarray(D), jnp.asarray(QS)
    Dt, Qt = torch.from_numpy(D), torch.from_numpy(QS)
    for trim in (None, TRIM):
        kw = dict(mode=mode, v_range=vr, trim=trim)
        _assert_same(j.matvec(Dj, Qj[0], **kw), t.matvec(Dt, Qt[0], **kw),
                     vr, f"matvec/trim={trim}")
        _assert_same(j.matmat(Dj, Qj, **kw), t.matmat(Dt, Qt, **kw), vr,
                     f"matmat/trim={trim}")
    for sj, qj, st, qt in ((Dj[0], Qj[0], Dt[0], Qt[0]),
                           (Dj[:1], Qj, Dt[:1], Qt),
                           (Dj[None], Qj[:, None], Dt[None], Qt[:, None])):
        _assert_same(j.dot(sj, qj, mode=mode), t.dot(st, qt, mode=mode),
                     (0.0, full), f"dot{tuple(st.shape)}")
    if mode == "md":
        _assert_same(j.manhattan(Dj[None], Qj[:, None], v_range=vr),
                     t.manhattan(Dt[None], Qt[:, None], v_range=vr), vr,
                     "manhattan")
    assert dataclasses.astuple(j.decision_cost(256, mode=mode, n_ops=4)) \
        == dataclasses.astuple(t.decision_cost(256, mode=mode, n_ops=4))


def test_registry_and_guards():
    assert sorted(tapi.BACKENDS) == ["digital", "kernel", "multibank",
                                     "reference"]
    with pytest.raises(KeyError, match="kernel"):
        tapi.get_backend("kernal", device="cpu")
    be = tapi.get_backend("reference", device="cpu")
    assert tapi.get_backend(be) is be
    with pytest.raises(ValueError):
        tapi.get_backend("kernel", device="cpu").dot(D, QS, mode="xx")
    with pytest.raises(ValueError):
        tapi.get_backend("reference", device="cpu").dot(
            np.zeros((1, 300), np.uint8), np.zeros(300, np.uint8))
    with pytest.raises(ValueError, match="supports"):
        tapi.get_backend("kernel", device="cpu").dot(D[None, None],
                                                     QS[0])
    for kw in ({"variation": BankVariation()}, {"faults": [object()]},
               {"redundancy": 3}, {"mesh": object()}):
        with pytest.raises(NotImplementedError):
            tapi.get_backend("multibank", device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        tapi.get_backend("multibank", device="cpu", inner="digital")
    with pytest.raises(ValueError):
        tapi.get_backend("multibank", device="cpu", n_banks=0)
    mb = tapi.get_backend("multibank", device="cpu", n_banks=32)
    assert isinstance(mb.inner, tapi.KernelBackend)    # kernels by default
    assert isinstance(mb.ideal().inner, tapi.KernelBackend)
    jm = japi.get_backend("multibank", n_banks=32)
    assert mb.bank_slices(70) == jm.bank_slices(70)
    assert mb.bank_fixed_pj == jm.bank_fixed_pj
    assert mb.ideal().chip is None and mb.ideal().n_banks == 32


def test_multibank_kernel_inner_noise_rule():
    """With noise, bank b of the fused launch draws what a single-bank
    kernel op under ``fold_in(gen, b)`` draws — the ragged last bank
    included, since here every bank pads to the same 128-row block."""
    mb = tapi.get_backend("multibank", P, CHIP_T, device="cpu",
                          inner="kernel", n_banks=8)
    single = tapi.get_backend("kernel", P, CHIP_T, device="cpu")
    gen = torch.Generator().manual_seed(5)
    out = mb.matvec(D, QS[0], gen=gen)
    slices = mb.bank_slices(D.shape[0])
    assert slices[-1][1] - slices[-1][0] < slices[0][1] - slices[0][0]
    for b, (a, z) in enumerate(slices):
        ob = single.matvec(D[a:z], QS[0], gen=tnoise.fold_in(gen, b))
        assert torch.equal(out.volts[a:z], ob.volts), b
    assert dima_dp.launches["dima_dp_bank_batch"] == 0     # CPU: no launch


@pytest.mark.parametrize("mode", ["dp", "md"])
def test_chunked_dot_and_calibration_match_jax(mode):
    """chunked_dot over a 506-dim operand (two conversions), the ideal
    range calibration and the affine trim agree with the JAX package."""
    X = rng.integers(0, 256, (6, 506)).astype(np.uint8)
    w = rng.integers(0, 256, (1, 506)).astype(np.uint8)
    for jname, tname in (("reference", "reference"), ("pallas", "kernel")):
        j = japi.get_backend(jname, JP, CHIP_J)
        t = tapi.get_backend(tname, P, CHIP_T, device="cpu")
        a = np.asarray(japi.chunked_dot(j, jnp.asarray(w), jnp.asarray(X),
                                        mode=mode))
        b = tapi.chunked_dot(t, torch.from_numpy(w), torch.from_numpy(X),
                             mode=mode).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-6)
        assert tapi.chunked_dot_loop is tapi.chunked_dot
        lo_j, hi_j = jcal.calibrate_range(j, w, X, mode=mode)
        lo_t, hi_t = tcal.calibrate_range(t, w, X, mode=mode)
        np.testing.assert_allclose([lo_t, hi_t], [lo_j, hi_j], rtol=1e-6)
        target = X.astype(np.float64).sum(-1) * 3.0 + 7.0
        cj = jcal.calibrate(j, w, X, mode=mode, target=target)
        ct = tcal.calibrate(t, w, X, mode=mode, target=target)
        np.testing.assert_allclose(ct.coef, cj.coef, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            tcal.trimmed_scores(ct, t, w, X),
            np.asarray(jcal.trimmed_scores(cj, j, w, X)), rtol=1e-5)
    assert list(tapi.iter_chunks(506, 256)) == [(0, 256), (256, 506)]


def test_trimmed_scores_fused_single_chunk():
    """A one-conversion operand runs as ONE op with the fused epilogue
    and agrees with the decode-then-trim float64 oracle."""
    t = tapi.get_backend("kernel", P, CHIP_T, device="cpu")
    w, X = D[:1, :200], QS
    target = X.astype(np.float64).sum(-1) - 3.0
    cal = tcal.calibrate(t, w, X, mode="dp", target=target)
    fused = tcal.trimmed_scores(cal, t, w, X, fused=True)
    legacy = tcal.trimmed_scores(cal, t, w, X, fused=False)
    np.testing.assert_allclose(fused, legacy, rtol=1e-5)
    with pytest.raises(ValueError):
        tcal.trimmed_scores(cal, t, np.zeros((1, 300), np.uint8),
                            np.zeros((2, 300), np.uint8), fused=True)
    with pytest.raises(ValueError):
        tcal.trimmed_scores(tcal.Calibration("dp", (0.0, 1.0)), t, w, X)
