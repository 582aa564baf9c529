"""Vertical grid generation (uniform + stretched).

Re-derivation of the reference udprep GridSection z-grid methods
(tools/python/udprep/udprep_grid.py:61-290): a linear near-wall prefix of
`hlin/dzlin` cells, then a computational-coordinate stretch (exponential,
tanh, or double-tanh) whose factor is decremented until the first
stretched spacing is at least the linear spacing; `expcheck` instead
solves alpha/(exp(alpha)-1) = dzlin*ir/L for a C1-matched exponential."""
from __future__ import annotations

import warnings

import numpy as np


def _round_half_away(value: float) -> int:
    """MATLAB-style round (halves away from zero), used for grid counts."""
    return int(np.sign(value) * np.floor(abs(value) + 0.5))


def _transform(method: str):
    if method == "exp":
        return lambda gf, xi: (np.exp(gf * xi) - 1.0) / (np.exp(gf) - 1.0)
    if method == "tanh":
        return lambda gf, xi: 1.0 - np.tanh(gf * (1.0 - xi)) / np.tanh(gf)
    if method == "2tanh":
        return lambda gf, xi: 0.5 * (1.0 - np.tanh(gf * (1.0 - 2.0 * xi))
                                     / np.tanh(gf))
    raise ValueError(f"unknown stretch method {method!r} "
                     "(use exp | expcheck | tanh | 2tanh)")


def _solve_exp_alpha(ratio: float) -> float:
    """alpha/(exp(alpha)-1) = ratio, avoiding the trivial alpha=0 root
    (udprep_grid.py:139-166; bisection instead of scipy.brentq)."""
    if not np.isfinite(ratio) or ratio <= 0.0:
        raise ValueError(f"invalid exponential stretch ratio {ratio}")
    if np.isclose(ratio, 1.0, rtol=1e-12, atol=1e-12):
        return 0.0
    f = lambda a: a - ratio * np.expm1(a)
    if ratio < 1.0:
        lo, hi = 1e-12, 1.0
        while f(hi) > 0.0:
            hi *= 2.0
            if hi > 700.0:
                raise ValueError(f"cannot bracket alpha for ratio={ratio}")
    else:
        lo, hi = -1.0, -1e-12
        while f(lo) > 0.0:
            lo *= 2.0
            if lo < -1e6:
                raise ValueError(f"cannot bracket alpha for ratio={ratio}")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f(mid) > 0.0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def zgrid_faces(ktot: int, zsize: float, lzstretch: bool = False,
                method: str = "tanh", hlin: float | None = None,
                dzlin: float | None = None,
                stretchconst: float = 1.5) -> np.ndarray:
    """Face heights zh (ktot+1,), zh[0]=0, zh[-1]=zsize."""
    if not lzstretch:
        return np.linspace(0.0, zsize, ktot + 1)
    dz = zsize / ktot
    dzlin = dzlin if dzlin is not None else dz
    hlin = hlin if hlin is not None else 0.1 * zsize
    il = _round_half_away(hlin / dzlin)
    ir = ktot - il
    zm = np.zeros(ktot + 1)
    zm[: il + 1] = np.linspace(0.0, hlin, il + 1)
    if ir <= 0:
        return zm

    if method == "expcheck":
        # C1-matched exponential (udprep_grid.py:224-262); hlin snaps to
        # il*dzlin there
        z0 = il * dzlin
        L = zsize - z0
        xi = np.linspace(0.0, 1.0, ir + 1)
        alpha = _solve_exp_alpha((dzlin * ir) / L)
        zhat = xi if alpha == 0.0 else np.expm1(alpha * xi) / np.expm1(alpha)
        zm[: il + 1] = np.linspace(0.0, z0, il + 1)
        zm[il:] = z0 + zhat * L
        dzv = np.diff(zm)
        s = dzv[1:] / dzv[:-1]
        if s.min() < 0.95 or s.max() > 1.05:
            warnings.warn("stretch factor outside [0.95, 1.05] "
                          f"(min={s.min():.3f}, max={s.max():.3f})",
                          RuntimeWarning)
        if alpha < 0:
            warnings.warn("negative alpha: refinement toward the top",
                          RuntimeWarning)
        return zm

    tr = _transform(method)
    linear_dz = hlin / il if il > 0 else dzlin
    xi = np.arange(0, ir + 1, dtype=float) / ir
    gf = float(stretchconst)
    # decrement the stretch factor until the first stretched spacing is at
    # least the linear spacing (udprep_grid.py:168-216, incl. the
    # positive floor so a 0/0 transform can never write NaN heights)
    while gf > 1e-6:
        zm[il:] = zm[il] + (zsize - zm[il]) * tr(gf, xi)
        if (zm[il + 1] - zm[il]) < linear_dz:
            gf -= 0.01
            continue
        dzv = np.diff(zm)
        if dzv[-1] > 3 * linear_dz:
            warnings.warn("final grid spacing large; consider reducing "
                          "domain height", RuntimeWarning)
        break
    else:
        raise ValueError(
            "unable to fit a stretched z-grid: stretch factor decayed to "
            f"<=1e-6 from stretchconst={stretchconst} without the first "
            f"stretched spacing reaching the linear one ({linear_dz:g} m); "
            "increase zsize, reduce hlin/dzlin, or lower ktot")
    if not np.all(np.isfinite(zm)) or np.any(np.diff(zm) <= 0.0):
        raise ValueError("stretched z-grid is non-finite or non-monotonic")
    return zm


def zgrid_centers(ktot: int, zsize: float, **kw) -> np.ndarray:
    """Cell-centre heights zf (ktot,) — what prof.inp carries."""
    zh = zgrid_faces(ktot, zsize, **kw)
    return 0.5 * (zh[:-1] + zh[1:])
