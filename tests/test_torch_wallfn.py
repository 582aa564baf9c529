"""The port's rough-wall transfer coefficients (``ibm/wallfn.py``: ``unom``,
``unoh``, ``ctm_neutral``) against a direct scalar evaluation of the
formulas of modwallfunctions.f90:171-260 (Uno et al. 1995: constants b1 =
9.4, b2 = 4.7, dm = 7.4, dh = 5.3; Louis-type stability functions, one
Richardson-number correction for the roughness-length ratio), written here
in plain Python floats, independent of the port and of udales_tpu.  The
log-law row of validate_abl_torch.py rests on them.  No JAX needed.
"""
import math

import numpy as np
import pytest
import torch

from udales_tpu_torch.ibm import wallfn

FKAR = 0.41
B1, B2, DM, DH = 9.4, 4.7, 7.4, 5.3
# the first-cell geometry of a 1 m grid over z0 = 0.03, z0h = 0.003
DELTA, Z0, Z0H = 0.5, 0.03, 0.003
LOGDZ = math.log(DELTA / Z0)
LOGZH = math.log(Z0 / Z0H)
SQDZ = math.sqrt(DELTA / Z0)
RIB = [-2.0, -0.5, -0.05, -1e-4, 0.0, 1e-4, 0.05, 0.2, 0.5]


def fm_fh(rib):
    """Fm, Fh at bulk Richardson number `rib` (modwallfunctions.f90:185-
    193): stable (rib > 0) 1 / (1 + b2 rib)^2 for both; otherwise 1 - b1
    rib / (1 + c sqrt|rib|), c = d fkar^2 / ln^2(delta/z0) b1 sqrt(delta/z0)
    with d = dm (momentum) or dh (heat)."""
    if rib > 0:
        f = 1.0 / (1.0 + B2 * rib) ** 2
        return f, f
    base = FKAR ** 2 / LOGDZ ** 2 * B1 * SQDZ
    fm = 1.0 - B1 * rib / (1.0 + DM * base * math.sqrt(abs(rib)))
    fh = 1.0 - B1 * rib / (1.0 + DH * base * math.sqrt(abs(rib)))
    return fm, fh


def corrected_rib(rib, prt):
    """The Richardson number corrected for z0/z0h, as unom and unoh both
    form it: rib - rib prt ln(z0/z0h) / (prt ln(z0/z0h) + M), M = prt
    ln(delta/z0) sqrt(Fm) / Fh."""
    fm, fh = fm_fh(rib)
    m = prt * LOGDZ * math.sqrt(fm) / fh
    return rib - rib * prt * LOGZH / (prt * LOGZH + m)


def ctm(rib, prt):
    """Momentum transfer coefficient fkar^2 / ln^2(delta/z0) Fm(rib1)
    (modwallfunctions.f90:224-260)."""
    return FKAR ** 2 / LOGDZ ** 2 * fm_fh(corrected_rib(rib, prt))[0]


def heat(rib, prt, utang, dT):
    """(flux, cth) (modwallfunctions.f90:171-220): cth = sqrt(utang) fkar^2
    / ln^2(delta/z0) Fh(rib1) / prt, and the flux cth dT / (prt
    ln(z0/z0h) / M1 + 1) with M1 at the corrected number."""
    fm1, fh1 = fm_fh(corrected_rib(rib, prt))
    m1 = prt * LOGDZ * math.sqrt(fm1) / fh1
    cth = math.sqrt(utang) * FKAR ** 2 / LOGDZ ** 2 * fh1 / prt
    return cth * dT / (prt * LOGZH / m1 + 1.0), cth


@pytest.mark.parametrize("prt", [0.71, 1.0])
def test_unom_matches_the_formulas(prt):
    got = wallfn.unom(LOGDZ, LOGZH, SQDZ,
                      torch.tensor(RIB, dtype=torch.float64), prt).numpy()
    want = np.array([ctm(r, prt) for r in RIB])
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


@pytest.mark.parametrize("prt", [0.71, 1.0])
def test_unoh_matches_the_formulas(prt):
    rng = np.random.default_rng(3)
    utang = rng.uniform(1e-4, 4.0, len(RIB))
    dT = rng.standard_normal(len(RIB))
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    flux, cth = wallfn.unoh(LOGDZ, LOGZH, SQDZ, t(utang), t(dT), t(RIB), prt)
    want = np.array([heat(r, prt, u, d) for r, u, d in zip(RIB, utang, dT)])
    np.testing.assert_allclose(flux.numpy(), want[:, 0], rtol=1e-13, atol=0)
    np.testing.assert_allclose(cth.numpy(), want[:, 1], rtol=1e-13, atol=0)


def test_neutral_limit_is_the_log_law_coefficient():
    """At Ri_b = 0 unom is the neutral ctm = kappa^2 / ln^2(delta/z0), and
    ctm_neutral is the same number."""
    neutral = FKAR ** 2 / math.log(DELTA / Z0) ** 2
    got = float(wallfn.unom(LOGDZ, LOGZH, SQDZ,
                            torch.tensor(0.0, dtype=torch.float64), 0.71))
    assert got == pytest.approx(neutral, rel=1e-15)
    assert float(wallfn.ctm_neutral(LOGDZ)) == pytest.approx(neutral,
                                                              rel=1e-15)


def test_stability_orders_the_coefficients():
    """Unstable air mixes more and stable air less than neutral: unom and
    unoh's cth fall monotonically with Ri_b."""
    rib = torch.tensor(RIB, dtype=torch.float64)
    ones = torch.ones_like(rib)
    for coef in (wallfn.unom(LOGDZ, LOGZH, SQDZ, rib, 0.71),
                 wallfn.unoh(LOGDZ, LOGZH, SQDZ, ones, ones, rib, 0.71)[1]):
        assert bool((coef[1:] < coef[:-1]).all()), coef
