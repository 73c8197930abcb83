"""The whole slice on the CPU: the port's four applications against the
JAX package's.

At zero noise, with the chip record and the trained SVM weights carried
over by ``repro_torch.convert``, each application's ``acc_dima`` (on the
port's default ``kernel`` backend, whose CPU path is the kernels' plain
versions) equals the JAX ``run_*`` on its ``reference`` backend, and the
trimmed scores agree to 1e-5 of the score scale.  The torch-trained SVM
lands within one LSB of JAX's quantized weights.  One noisy
``run_all(device="cpu")`` keeps every gap to digital within the paper's
1 point (applications.py:1-5).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import applications as japps
from repro.core import calibration as jcal
from repro.core import noise as jnoise
from repro.core.api import get_backend as jget
from repro.core.params import DimaParams as JaxParams
from repro.data import synthetic as jsyn
from repro.quant import bitplanes as jbp
from repro_torch import convert
from repro_torch.core import applications as tapps
from repro_torch.core import calibration as tcal
from repro_torch.core.api import get_backend as tget
from repro_torch.core.params import DimaParams
from repro_torch.data import synthetic as tsyn
from repro_torch.quant import bitplanes as tbp

P = DimaParams()
JP = JaxParams()
CHIP_J = jnoise.sample_chip(jax.random.PRNGKey(7), JP)
CHIP_T = convert.chip_from_jax({k: np.asarray(v) for k, v in CHIP_J.items()},
                               device="cpu")


def _jax_svm():
    X, y = jsyn.faces_dataset(seed=0)
    return japps.train_linear_svm(X[:-100], y[:-100])


def test_datasets_array_equal():
    for name, kw in (("faces_dataset", {}), ("gunshot_queries", {}),
                     ("face_id_dataset", {}), ("digits_dataset", {}),
                     ("gunshot_template", {})):
        a = getattr(jsyn, name)(**kw)
        b = getattr(tsyn, name)(**kw)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)


def test_sign_split_matches_jax():
    v = np.random.default_rng(0).integers(-255, 256, (7, 33))
    for x, y in zip(jbp.sign_split(v), tbp.sign_split(v)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    np.testing.assert_array_equal(tbp.sign_merge(*tbp.sign_split(v)).numpy(),
                                  v)
    with pytest.raises(ValueError):
        tbp.sign_split(np.array([300]))


@pytest.mark.parametrize("app", ["svm", "svm_rails", "mf", "tm", "knn"])
def test_app_zero_noise_matches_jax(app):
    name = app.split("_")[0]
    kw = {"signed_rails": True} if app == "svm_rails" else {}
    j_fn, t_fn = japps.ALL_APPS[name], tapps.ALL_APPS[name]
    if name == "svm":
        kw["weights"] = convert.svm_from_jax(*_jax_svm())
    a = j_fn(JP, CHIP_J, None, **{k: v for k, v in kw.items()
                                  if k != "weights"})
    b = t_fn(P, CHIP_T, None, device="cpu", **kw)
    assert (b.acc_dima, b.acc_digital) == (a.acc_dima, a.acc_digital), \
        (a, b)
    for f in ("cost", "cost_mb", "cost_conv"):
        assert dataclasses.astuple(getattr(a, f)) == \
            dataclasses.astuple(getattr(b, f))
    assert (b.name, b.n_queries) == (a.name, a.n_queries)


def test_trimmed_scores_match_jax_at_zero_noise():
    """The signed apps' analog scores — MF through the fused one-launch
    epilogue, SVM through the two-conversion chunked path — agree with
    the JAX package's to 1e-5 of the score scale."""
    Xq, yq, tmpl = tsyn.gunshot_queries(n_queries=100 + 64, seed=2)
    w, _ = _jax_svm()
    wq = np.clip(np.round(w / (np.max(np.abs(w)) / 127.0)), -128, 127)
    w_stored = (wq.astype(np.int32) + 128).astype(np.uint8)[None, :]
    Xf, _ = tsyn.faces_dataset(seed=0)
    for stored, X in ((tmpl[None, :], Xq), (w_stored, Xf[:164])):
        target = X.astype(np.float64).sum(-1) * 0.7 + 11.0
        jb = jget("reference", JP, CHIP_J)
        tb = tget("kernel", P, CHIP_T, device="cpu")
        cj = jcal.calibrate(jb, stored, X[:64], mode="dp", target=target[:64])
        ct = tcal.calibrate(tb, stored, X[:64], mode="dp", target=target[:64])
        sj = np.asarray(jcal.trimmed_scores(cj, jb, stored, X[64:]))
        st = tcal.trimmed_scores(ct, tb, stored, X[64:])
        assert np.abs(st - sj).max() <= 1e-5 * np.abs(sj).max()


def test_torch_trained_svm_within_one_lsb():
    X, y = tsyn.faces_dataset(seed=0)
    w_t, b_t = tapps.train_linear_svm(X[:-100], y[:-100], device="cpu")
    w_j, b_j = _jax_svm()

    def quant(w):
        return np.clip(np.round(w / (np.max(np.abs(w)) / 127.0)), -128, 127)

    diff = np.abs(quant(w_t) - quant(w_j))
    n_diff = int((diff > 0).sum())
    print(f"torch-trained SVM: {n_diff} of {diff.size} quantized weights "
          f"differ from JAX's by 1 LSB; bias {b_t:.6f} vs {b_j:.6f}")
    assert diff.max() <= 1, f"{n_diff} weights differ, max {diff.max()} LSB"
    assert abs(b_t - b_j) < 1e-3


def test_noisy_run_all_cpu_keeps_the_gap():
    res = tapps.run_all(device="cpu")
    assert list(res) == ["svm", "mf", "tm", "knn"]
    for name, r in res.items():
        assert abs(r.acc_dima - r.acc_digital) <= 0.01 + 1e-9, (name, r)
    assert res["mf"].acc_dima == 1.0 and res["tm"].acc_dima == 1.0
    assert abs(res["mf"].cost.energy_pj - 481.5) < 5
    sub = tapps.run_all(device="cpu", apps=("tm",), backend="reference")
    assert list(sub) == ["tm"]
