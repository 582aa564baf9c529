"""Rough-wall log-law transfer coefficients (port of
``udales_tpu.ibm.wallfn``; src/modwallfunctions.f90).

  - unom (:224-260): momentum transfer coefficient with the Richardson
    number stability iteration
  - unoh (:171-220): heat transfer coefficient and flux
  - neutral variant: ctm = fkar^2 / log^2(delta/z0) (:262-352)

Elementwise functions: arguments may be tensors or Python floats.
"""
from __future__ import annotations

import torch

from ..config import const

B1 = 9.4   # Uno 1995 constants (modwallfunctions.f90:178-181)
B2 = 4.7
DM = 7.4
DH = 5.3
UMIN = 0.0001  # m^2/s^2 floor on |u_tan|^2


def _stability_fm_fh(Ribl, logdz, sqdz, fkar2):
    """Louis-type stability functions Fm, Fh (modwallfunctions.f90:185-193)."""
    cm = (DM * fkar2) / (logdz ** 2) * B1 * sqdz
    ch = (DH * fkar2) / (logdz ** 2) * B1 * sqdz
    stable = Ribl > 0
    Fm_s = 1.0 / (1.0 + B2 * Ribl) ** 2
    Fm_u = 1.0 - (B1 * Ribl) / (1.0 + cm * torch.sqrt(torch.abs(Ribl)))
    Fh_u = 1.0 - (B1 * Ribl) / (1.0 + ch * torch.sqrt(torch.abs(Ribl)))
    return torch.where(stable, Fm_s, Fm_u), torch.where(stable, Fm_s, Fh_u)


def unom(logdz, logzh, sqdz, Ribl0, prandtlturb=const.prandtlmol):
    """Momentum transfer coefficient Ctm (modwallfunctions.f90:224-260)."""
    fkar2 = const.fkar ** 2
    Fm, Fh = _stability_fm_fh(Ribl0, logdz, sqdz, fkar2)
    M = prandtlturb * logdz * torch.sqrt(Fm) / Fh
    Ribl1 = Ribl0 - Ribl0 * prandtlturb * logzh / (prandtlturb * logzh + M)
    Fm1, _ = _stability_fm_fh(Ribl1, logdz, sqdz, fkar2)
    return fkar2 / (logdz ** 2) * Fm1


def unoh(logdz, logzh, sqdz, utangInt, dT, Ribl0,
         prandtlturb=const.prandtlmol):
    """Heat transfer coefficient + kinematic heat flux
    (modwallfunctions.f90:171-220).  Returns (flux, cth)."""
    fkar2 = const.fkar ** 2
    Fm, Fh = _stability_fm_fh(Ribl0, logdz, sqdz, fkar2)
    M = prandtlturb * logdz * torch.sqrt(Fm) / Fh
    Ribl1 = Ribl0 - Ribl0 * prandtlturb * logzh / (prandtlturb * logzh + M)
    Fm1, Fh1 = _stability_fm_fh(Ribl1, logdz, sqdz, fkar2)
    M1 = prandtlturb * logdz * torch.sqrt(Fm1) / Fh1
    dTrough = dT / (prandtlturb * logzh / M1 + 1.0)
    cth = torch.sqrt(utangInt) * fkar2 / (logdz ** 2) * Fh1 / prandtlturb
    return cth * dTrough, cth


def ctm_neutral(logdz):
    """Neutral momentum transfer coefficient (modwallfunctions.f90:324)."""
    return const.fkar ** 2 / (logdz ** 2)
