"""The paper's four applications end-to-end on the DIMA pipeline (Fig. 6).

Each app runs twice: through the analog chain (MR-FR→BLP→CBLP→ADC) and
through the exact 8-b digital reference — the paper's claim is ≤1 %
accuracy degradation between the two at 3.7–9.7× lower energy.

All analog compute goes through one backend (``backend``: a name or a
``DimaBackend``); the default is ``"kernel"``, so on the card every
analog op is a CUDA kernel launch.  ``device`` is CUDA unless the caller
passes ``device="cpu"``.  The datasets come from the port's numpy copy
of the synthetic generators, so they are array-equal to the JAX
package's.

Signed arithmetic (SVM weights, MF correlation) uses offset-binary
storage: w is stored as ŵ = w+128 and the cross terms are removed
digitally.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import api as api_mod
from repro_torch.core import calibration as cal_mod
from repro_torch.core import energy as energy_mod
from repro_torch.core import noise as noise_mod
from repro_torch.core import pipeline as pl
from repro_torch.core.api import get_backend
from repro_torch.core.params import DimaParams
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.quant import bitplanes as bp_mod


class AppResult(NamedTuple):
    name: str
    acc_dima: float
    acc_digital: float
    cost: energy_mod.Cost
    cost_mb: energy_mod.Cost
    cost_conv: energy_mod.Cost
    n_queries: int


def _result(name: str, p: DimaParams, n_queries: int, acc_dima: float,
            acc_digital: float) -> AppResult:
    """Attach the three cost models to an (acc_dima, acc_digital) pair."""
    return AppResult(name, acc_dima, acc_digital,
                     energy_mod.app_cost(p, name),
                     energy_mod.app_cost(p, name, multi_bank=True),
                     energy_mod.app_cost(p, name, arch="conv"), n_queries)


def _split2(gen):
    """(calibration, test) generators: children 0 and 1 of ``gen``."""
    return (None, None) if gen is None else tuple(noise_mod.split(gen, 2))


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _backend(backend, p, chip, backend_kwargs, device):
    return get_backend(backend, p, chip, device=device,
                       **(backend_kwargs or {}))


# ---------------------------------------------------------------------------
# 1) SVM face detection (binary)
# ---------------------------------------------------------------------------

def train_linear_svm(X, y, steps=400, lr=0.5, c=1e-3, seed=0, device=None):
    """Hinge-loss linear SVM, full-batch gradient descent with
    ``torch.autograd`` (the JAX package's recipe). X float [0, 255]."""
    dev = resolve_device(device)
    Xf = torch.as_tensor(X, dtype=torch.float32, device=dev) / 255.0
    yf = torch.as_tensor(y, dtype=torch.float32, device=dev) * 2 - 1
    w = torch.zeros((X.shape[1],), device=dev, requires_grad=True)
    b = torch.zeros((), device=dev, requires_grad=True)
    for _ in range(steps):
        m = yf * (Xf @ w + b)
        loss = torch.mean(torch.maximum(torch.zeros_like(m), 1 - m)) \
            + c * torch.sum(w * w)
        gw, gb = torch.autograd.grad(loss, (w, b))
        with torch.no_grad():
            w -= lr * gw
            b -= lr * gb
    return w.detach().cpu().numpy(), float(b.detach())


def signed_rail_scores(be, w_signed, X, *, gen=None, v_range=None):
    """Differential signed-weight scoring on the unsigned array: the
    signed weight vector splits into two non-negative rails
    (``quant.bitplanes.sign_split``: w = pos − neg), each rail streams as
    an ordinary unsigned chunked dot, and the controller subtracts the
    decoded rails.  Rail generators are children 0 / 1 of ``gen``."""
    pos, neg = bp_mod.sign_split(w_signed)
    kp, kn = _split2(gen)
    sp = api_mod.chunked_dot(be, pos[None, :], X, mode="dp", gen=kp,
                             v_range=v_range)
    sn = api_mod.chunked_dot(be, neg[None, :], X, mode="dp", gen=kn,
                             v_range=v_range)
    return _numpy(sp).astype(np.float64) - _numpy(sn).astype(np.float64)


def run_svm(p: DimaParams = DimaParams(), chip=None, gen=None,
            n_queries=100, seed=0, backend="kernel", backend_kwargs=None,
            signed_rails=False, device=None, weights=None) -> AppResult:
    """``signed_rails=True`` swaps the offset-binary weight storage for
    the two-rail ``sign_split`` layout.  ``weights=(w, b)`` skips the
    training and scores with a given float SVM (``convert.svm_from_jax``
    carries the JAX package's over)."""
    dev = resolve_device(device)
    be = _backend(backend, p, chip, backend_kwargs, dev)
    X, y = synthetic.faces_dataset(seed=seed)
    Xtr, ytr = X[:-n_queries], y[:-n_queries]
    Xte, yte = X[-n_queries:], y[-n_queries:]

    w, b = (train_linear_svm(Xtr, ytr, seed=seed, device=dev)
            if weights is None else weights)
    s_w = np.max(np.abs(w)) / 127.0
    wq = np.clip(np.round(w / s_w), -128, 127).astype(np.int32)
    w_stored = (wq + 128).astype(np.uint8)           # offset-binary in array

    def score_digital(X):
        dot = _numpy(pl.digital_dot(w_stored[None, :], X)).astype(np.int64) \
            - 128 * X.astype(np.int64).sum(-1)
        return dot.astype(np.float64) * s_w / 255.0 + b

    acc_dig = float(np.mean((score_digital(Xte) >= 0) == (yte == 1)))

    Xcal = Xtr[:64]
    kc, kt = _split2(gen)
    if signed_rails:
        pos, neg = bp_mod.sign_split(wq)
        lo_p, hi_p = cal_mod.calibrate_range(be, pos[None, :], Xcal,
                                             mode="dp")
        lo_n, hi_n = cal_mod.calibrate_range(be, neg[None, :], Xcal,
                                             mode="dp")
        v_range = (min(lo_p, lo_n), max(hi_p, hi_n))
        s_cal = signed_rail_scores(be, wq, Xcal, gen=kc, v_range=v_range)
        feats = np.stack([s_cal, Xcal.astype(np.float64).sum(-1)], 1)
        coef = cal_mod.affine_trim(feats, score_digital(Xcal))
        s_te = signed_rail_scores(be, wq, Xte, gen=kt, v_range=v_range)
        score_a = cal_mod.apply_trim(
            coef, np.stack([s_te, Xte.astype(np.float64).sum(-1)], 1))
    else:
        cal = cal_mod.calibrate(be, w_stored[None, :], Xcal, mode="dp",
                                target=score_digital(Xcal), gen=kc)
        score_a = cal_mod.trimmed_scores(cal, be, w_stored[None, :], Xte,
                                         gen=kt)
    acc_dima = float(np.mean((score_a >= 0) == (yte == 1)))

    return _result("svm", p, n_queries, acc_dima, acc_dig)


# ---------------------------------------------------------------------------
# 2) Matched-filter gunshot detection (binary)
# ---------------------------------------------------------------------------

def run_mf(p: DimaParams = DimaParams(), chip=None, gen=None,
           n_queries=100, seed=0, backend="kernel", backend_kwargs=None,
           device=None) -> AppResult:
    be = _backend(backend, p, chip, backend_kwargs, resolve_device(device))
    Xq, yq, tmpl = synthetic.gunshot_queries(n_queries=n_queries + 64,
                                             seed=seed + 2)
    Xcal, ycal = Xq[:64], yq[:64]          # calibration split
    Xte, yte = Xq[64:], yq[64:]
    sum_t = int(tmpl.astype(np.int64).sum())

    def corr_digital(X):
        d = _numpy(pl.digital_dot(tmpl[None, :], X)).astype(np.int64)
        return d - 128 * X.astype(np.int64).sum(-1) - 128 * sum_t \
            + 256 * 128 * 128

    cd_cal = corr_digital(Xcal)
    thr = 0.5 * (cd_cal[ycal == 1].mean() + cd_cal[ycal == 0].mean())
    acc_dig = float(np.mean((corr_digital(Xte) >= thr) == (yte == 1)))

    kc, kt = _split2(gen)
    cal = cal_mod.calibrate(be, tmpl[None, :], Xcal, mode="dp",
                            target=cd_cal.astype(np.float64), gen=kc)
    corr_a = cal_mod.trimmed_scores(cal, be, tmpl[None, :], Xte, gen=kt)
    acc_dima = float(np.mean((corr_a >= thr) == (yte == 1)))

    return _result("mf", p, n_queries, acc_dima, acc_dig)


# ---------------------------------------------------------------------------
# 3) Template matching face recognition (64-class, MD mode)
# ---------------------------------------------------------------------------

def run_tm(p: DimaParams = DimaParams(), chip=None, gen=None,
           n_queries=64, seed=0, backend="kernel", backend_kwargs=None,
           device=None) -> AppResult:
    be = _backend(backend, p, chip, backend_kwargs, resolve_device(device))
    D, Q, yq = synthetic.face_id_dataset(n_queries=n_queries, seed=seed + 3)

    md_dig = _numpy(pl.digital_manhattan(D[None, :, :], Q[:, None, :]))
    acc_dig = float(np.mean(md_dig.argmin(-1) == yq))

    cal = cal_mod.calibrate(be, D[None, :, :], Q[:8, None, :], mode="md")
    out = be.manhattan(D[None, :, :], Q[:, None, :], gen=gen,
                       v_range=cal.v_range)
    acc_dima = float(np.mean(_numpy(out.code).argmin(-1) == yq))

    return _result("tm", p, n_queries, acc_dima, acc_dig)


# ---------------------------------------------------------------------------
# 4) KNN digit recognition (4-class, MD mode, k=5)
# ---------------------------------------------------------------------------

def run_knn(p: DimaParams = DimaParams(), chip=None, gen=None,
            n_queries=100, seed=0, k=5, backend="kernel",
            backend_kwargs=None, device=None) -> AppResult:
    be = _backend(backend, p, chip, backend_kwargs, resolve_device(device))
    D, yd, Q, yq = synthetic.digits_dataset(n_queries=n_queries, seed=seed + 4)

    def vote(dist):
        idx = np.argsort(dist, axis=-1)[:, :k]
        lab = yd[idx]
        return np.apply_along_axis(
            lambda r: np.bincount(r, minlength=4).argmax(), 1, lab)

    md_dig = _numpy(pl.digital_manhattan(D[None, :, :], Q[:, None, :]))
    acc_dig = float(np.mean(vote(md_dig) == yq))

    cal = cal_mod.calibrate(be, D[None, :, :], Q[:8, None, :], mode="md")
    out = be.manhattan(D[None, :, :], Q[:, None, :], gen=gen,
                       v_range=cal.v_range)
    acc_dima = float(np.mean(vote(_numpy(out.code)) == yq))

    return _result("knn", p, n_queries, acc_dima, acc_dig)


ALL_APPS = {"svm": run_svm, "mf": run_mf, "tm": run_tm, "knn": run_knn}


def run_all(p: DimaParams = DimaParams(), chip_key=7, noise_key=11,
            backend="kernel", backend_kwargs=None, apps=None, device=None):
    """Run the four applications on one sampled chip.  The chip comes
    from a CPU generator seeded with ``chip_key`` (so it is the same
    silicon on either device); each app's noise from a generator on
    ``device`` seeded with ``noise_key``.  ``apps`` optionally restricts
    to a subset of ``ALL_APPS``."""
    dev = resolve_device(device)
    chip = noise_mod.sample_chip(torch.Generator().manual_seed(chip_key), p,
                                 dev)
    out = {}
    for name, fn in ALL_APPS.items():
        if apps is not None and name not in apps:
            continue
        gen = torch.Generator(device=dev).manual_seed(noise_key)
        out[name] = fn(p, chip, gen, backend=backend,
                       backend_kwargs=backend_kwargs, device=dev)
    return out
