"""Deterministic synthetic stand-ins for the paper's datasets.

MIT-CBCL and MNIST are not available offline; these generators match the
*statistics that matter* for the paper's claims (8-b dynamic range, image
size, class structure, task difficulty tuned so the digital-reference
accuracy lands at the paper's reported numbers — the claim under test is
the analog-vs-digital gap ≤1 %, see DESIGN.md §2).

Everything is a pure function of an integer seed.  This is the port's own
numpy copy of ``repro.data.synthetic``: the same generators with the same
seeds, so both packages see array-equal datasets.
"""
from __future__ import annotations

import numpy as np


def _smooth(img, passes=2):
    for _ in range(passes):
        img = (img
               + np.roll(img, 1, -1) + np.roll(img, -1, -1)
               + np.roll(img, 1, -2) + np.roll(img, -1, -2)) / 5.0
    return img


def _to_u8(x):
    x = x - x.min()
    x = x / max(x.max(), 1e-9)
    return np.clip(np.round(x * 255), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# 1) Face detection (SVM): 23×22 8-b images, face vs non-face
# ---------------------------------------------------------------------------

def faces_dataset(n_per_class=200, h=23, w=22, seed=0, overlap=0.23):
    """Faces = shared smooth prototype + per-sample smooth variation;
    non-faces = clutter *mixed with a fraction of the prototype* so the
    classes overlap — ``overlap`` is tuned so the 8-b digital SVM lands at
    the paper's ≈96 % (Fig. 6)."""
    rng = np.random.default_rng(seed)
    proto = _smooth(rng.normal(0, 1, (h, w)), 4)
    # oval "head" mask makes the prototype face-like (center-heavy energy)
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2) < 0.85
    proto = proto * mask

    def sample(is_face):
        clutter = _smooth(rng.normal(0, 1, (h, w)), 4) * mask
        base = proto if is_face else overlap * proto + (1 - overlap) * clutter * 1.15
        var = _smooth(rng.normal(0, 0.9, (h, w)), 2)
        noise = rng.normal(0, 0.25, (h, w))
        return _to_u8(base + var + noise)

    X = np.stack([sample(True) for _ in range(n_per_class)]
                 + [sample(False) for _ in range(n_per_class)])
    y = np.concatenate([np.ones(n_per_class, np.int32),
                        np.zeros(n_per_class, np.int32)])
    idx = rng.permutation(len(y))
    return X[idx].reshape(len(y), -1), y[idx]


# ---------------------------------------------------------------------------
# 2) Event (gun shot) detection (matched filter): 256-sample 8-b audio
# ---------------------------------------------------------------------------

def gunshot_template(n=256, seed=1):
    """Damped broadband transient (muzzle blast-like)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    env = np.exp(-t / 60.0)
    carrier = np.sin(2 * np.pi * 0.11 * t) + 0.5 * np.sin(2 * np.pi * 0.23 * t + 1.0)
    s = env * (carrier + 0.3 * rng.normal(0, 1, n))
    return s / np.sqrt(np.mean(s ** 2))


def gunshot_queries(n_queries=100, n=256, snr_db=3.0, seed=2):
    """P1 = template + AWGN at snr_db; P2 = AWGN of equal total power.
    Returns (signals uint8, labels, template uint8)."""
    rng = np.random.default_rng(seed)
    s = gunshot_template(n)
    sig_pow = np.mean(s ** 2)
    noise_pow = sig_pow / (10 ** (snr_db / 10))
    xs, ys = [], []
    for i in range(n_queries):
        if i % 2 == 0:
            x = s + rng.normal(0, np.sqrt(noise_pow), n)
            ys.append(1)
        else:
            x = rng.normal(0, np.sqrt(sig_pow + noise_pow), n)
            ys.append(0)
        xs.append(x)
    lo, hi = -4.0, 4.0   # fixed scale -> shared 8-b quantizer
    q = lambda x: np.clip(np.round((x - lo) / (hi - lo) * 255), 0, 255).astype(np.uint8)
    return q(np.stack(xs)), np.asarray(ys, np.int32), q(s)


# ---------------------------------------------------------------------------
# 3) Face recognition (template matching): 64 faces, 16×16
# ---------------------------------------------------------------------------

def face_id_dataset(n_classes=64, h=16, w=16, n_queries=64, seed=3):
    rng = np.random.default_rng(seed)
    protos = []
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2) < 0.9
    for _ in range(n_classes):
        protos.append(_to_u8(_smooth(rng.normal(0, 1, (h, w)), 3) * mask))
    D = np.stack(protos).reshape(n_classes, -1)
    q_idx = rng.integers(0, n_classes, n_queries)
    queries = []
    for c in q_idx:
        img = D[c].astype(np.float64) + rng.normal(0, 12.0, h * w)
        queries.append(np.clip(np.round(img), 0, 255).astype(np.uint8))
    return D, np.stack(queries), q_idx.astype(np.int32)


# ---------------------------------------------------------------------------
# 4) Hand-written digits 0-3 (KNN): procedural 16×16 glyphs
# ---------------------------------------------------------------------------

_SEGS = {  # 7-seg-ish strokes on a 16x16 canvas: (y0,x0,y1,x1)
    0: [(2, 4, 2, 11), (13, 4, 13, 11), (2, 4, 13, 4), (2, 11, 13, 11)],
    1: [(2, 8, 13, 8), (2, 8, 4, 6)],
    2: [(2, 4, 2, 11), (2, 11, 7, 11), (7, 4, 7, 11), (7, 4, 13, 4),
        (13, 4, 13, 11)],
    3: [(2, 4, 2, 11), (7, 5, 7, 11), (13, 4, 13, 11), (2, 11, 13, 11)],
}


def _draw_digit(digit, rng, h=16, w=16):
    """MD (L1) matching is shift-sensitive: the vertical-shift probability
    is the difficulty knob, tuned so digital 5-NN lands at the paper's
    ≈90 % (Fig. 6)."""
    img = np.zeros((h, w))
    dy = int(rng.choice([-1, 0, 1], p=[0.15, 0.70, 0.15]))
    dx = int(rng.integers(-1, 2))
    thick = rng.uniform(1.05, 1.3)
    for (y0, x0, y1, x1) in _SEGS[digit]:
        n = max(abs(y1 - y0), abs(x1 - x0)) * 3 + 1
        ys = np.linspace(y0, y1, n) + dy + rng.normal(0, 0.06, n).cumsum() * 0.2
        xs = np.linspace(x0, x1, n) + dx + rng.normal(0, 0.06, n).cumsum() * 0.2
        for y, x in zip(ys, xs):
            yy, xx = np.mgrid[0:h, 0:w]
            img += np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * (thick * 0.5) ** 2))
    img = img / max(img.max(), 1e-9)
    img = img + rng.normal(0, 0.03, (h, w))
    return _to_u8(img)


def digits_dataset(n_classes=4, per_class_stored=16, n_queries=100, seed=4):
    """D: 64 stored references (16/class); queries: fresh samples."""
    rng = np.random.default_rng(seed)
    stored, stored_y = [], []
    for c in range(n_classes):
        for _ in range(per_class_stored):
            stored.append(_draw_digit(c, rng).reshape(-1))
            stored_y.append(c)
    queries, qy = [], []
    for i in range(n_queries):
        c = int(rng.integers(0, n_classes))
        queries.append(_draw_digit(c, rng).reshape(-1))
        qy.append(c)
    return (np.stack(stored), np.asarray(stored_y, np.int32),
            np.stack(queries), np.asarray(qy, np.int32))
