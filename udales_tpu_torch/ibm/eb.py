"""Facet surface energy balance: radiation and multi-layer conduction (port
of ``udales_tpu.ibm.eb``; src/modEB.f90 and the EB parts of
src/initfac.f90).

Everything is batched over facets on the device:

  - the longwave radiosity exchange `calclw` (modEB.f90:335-363) as a dense
    (nfcts x nfcts) view-factor product, or an ``index_add_`` over the
    sparse triplets
  - the per-facet (nfaclyrs+1)^2 conduction solves (modEB.f90:449-508) as
    one batched ``torch.linalg.solve_ex`` (no singularity check, so no host
    synchronisation)
  - the green-roof resistances and soil moisture `updateGR`
    (modEB.f90:366-413) vectorized over facets.

The balance fires every dtEB seconds, quantized to integers (tnextEB =
NINT(timee + dtEB), modEB.f90:535).  `timee` is a device tensor and the
step makes no host synchronisation, so `maybe_update` always computes the
update and keeps it leaf by leaf with ``torch.where(fire, new, old)``.
"""
from __future__ import annotations

from dataclasses import dataclass, fields as dc_fields
from pathlib import Path

import numpy as np
import torch

from ..config import Config, const
from ..io.inputs import read_column_file, read_facets_inp


def qsat_fn(T):
    """Saturation humidity (initfac.f90:406-412, Bolton 1980)."""
    gres = 611.00 * torch.exp(17.27 * (T - 273.15) / (T - 35.85))
    return 0.62198 * 0.01 * gres / (1000.0 - 0.01 * gres)


@dataclass(frozen=True)
class FacetState:
    """Per-facet prognostic state carried in the solver State."""
    T: torch.Tensor        # (nfcts, nlyr+1) layer temperatures
    Tdash: torch.Tensor    # (nfcts, nlyr+1) interface gradients dT/dz
                           # (facTdash, modEB.f90:504-505)
    hfi: torch.Tensor      # (nfcts,) time-integrated sensible heat [K m^3]
    efi: torch.Tensor      # (nfcts,) time-integrated latent flux
    wsoil: torch.Tensor    # (nfcts,) green-roof soil moisture
    hurel: torch.Tensor    # (nfcts,) relative humidity above soil
    qsat: torch.Tensor     # (nfcts,) saturation humidity at the surface
    f: torch.Tensor        # (nfcts, 5) resistance factors (facf)
    tnextEB: torch.Tensor  # scalar: next EB fire time
    tEB_last: torch.Tensor  # scalar: time of the last EB solve


FACET_STATE_NAMES = tuple(f.name for f in dc_fields(FacetState))


class FacetEB:
    """Static facet energy-balance data and the batched solve."""

    def __init__(self, cfg: Config, facets, faca, facem, facd, faccp, faclam,
                 faclGR, vf=None, vf_sparse=None, svf=None, netsw=None,
                 Tfacinit=None, dtype=torch.float32, device="cpu"):
        self.cfg = cfg
        nfcts = len(facets)
        self.nfcts = nfcts
        L = cfg.eb.nfaclyrs
        self.L = L
        self.dtype = dtype
        self.device = torch.device(device)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=self.device)
        self.facets = np.asarray(facets)
        self.model_mask = torch.as_tensor(self.facets >= -100,
                                          device=self.device)  # solve these
        self.faca = t(faca)
        self.facem = t(facem)
        self.faclGR = torch.as_tensor(np.asarray(faclGR, bool),
                                      device=self.device)
        self.facd = t(facd)       # (nfcts, L)
        self.faclam = t(faclam)   # (nfcts, L+1)
        self.svf = t(svf if svf is not None else np.zeros(nfcts))
        self.netsw = t(netsw if netsw is not None else np.zeros(nfcts))
        self.vf = None if vf is None else t(vf)
        self.vf_sparse = None
        if vf_sparse is not None:   # (i, j, val) triplets
            i, j, v = vf_sparse
            li = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                           device=self.device)
            self.vf_sparse = (li(i), li(j), t(v))

        # static matrices (initEB, modEB.f90:275-295 + :466-485)
        n = L + 1
        AM = np.zeros((n, n))
        AM[0, 0] = 1.0
        for j in range(1, n):
            AM[j, j - 1] = 0.5
            AM[j, j] = 0.5
        self.inAM = t(np.linalg.inv(AM))

        BM = np.zeros((nfcts, n, n))
        CM = np.zeros((nfcts, n, n))
        DM = np.zeros((nfcts, n, n))
        EM = np.zeros((nfcts, n, n))
        d = np.asarray(facd)
        lam = np.asarray(faclam)
        cpv = np.asarray(faccp)
        for j in range(L):
            ca = np.where(d[:, j] > 0, 1.0 / np.maximum(d[:, j], 1e-30), 0.0)
            BM[:, j + 1, j] = -ca
            BM[:, j + 1, j + 1] = ca
            EM[:, j, j] = -lam[:, j]
            EM[:, j, j + 1] = lam[:, j + 1]
            cb = cpv[:, j] * d[:, j] / 2.0
            CM[:, j, j] = cb
            CM[:, j, j + 1] = cb
            ca2 = cpv[:, j] * d[:, j] ** 2 / 12.0
            DM[:, j, j] = ca2
            DM[:, j, j + 1] = -ca2
        CM[:, L, L] = 1.0
        self.BM0, self.CM, self.DM, self.EM = t(BM), t(CM), t(DM), t(EM)

        # initial facet temperatures (initfac.f90:320-349); with lfacTlyrs
        # the file carries per-layer temperatures (initfac.f90:301-318)
        T0 = np.zeros((nfcts, n))
        inner = np.where(self.facets > 0, cfg.eb.bldT, cfg.eb.flrT)
        Ti_arr = np.asarray(Tfacinit) if Tfacinit is not None else None
        if Ti_arr is not None and Ti_arr.ndim == 2:
            T0[:, :L] = Ti_arr[:, :L]
        else:
            Ti = Ti_arr if Ti_arr is not None else np.full(nfcts, 295.0)
            for j in range(n):
                T0[:, j] = Ti - (Ti - inner) / L * j
        T0[:, L] = inner
        self.T0 = t(T0)

    # -- loading -----------------------------------------------------------
    @classmethod
    def load(cls, case_dir: str | Path, expnr: str, cfg: Config, ibm,
             device="cpu"):
        """Facet properties (factypes.inp), sky view factors, net shortwave,
        initial temperatures and the view factors of a case directory:
        sparse triplets (``lvfsparse``, vfsparse.inp) or the dense netCDF-3
        matrix vf.nc.inp."""
        case_dir = Path(case_dir)
        nfcts = ibm.nfcts
        facets, _ = read_facets_inp(case_dir / f"facets.inp.{expnr}")
        ft = np.loadtxt(case_dir / f"factypes.inp.{expnr}", skiprows=3,
                        ndmin=2)
        typemap = {int(r[0]): r for r in ft}
        L = cfg.eb.nfaclyrs
        facem = np.zeros(nfcts)
        facd = np.zeros((nfcts, L))
        faccp = np.zeros((nfcts, L))
        faclam = np.zeros((nfcts, L + 1))
        faclGR = np.zeros(nfcts, bool)
        for i, t in enumerate(facets):
            r = typemap[int(t)]
            faclGR[i] = abs(r[1] - 1.0) < 1e-5
            facem[i] = r[5]
            if t < -100:
                continue
            # columns (initfac.f90:236-246): d at 6+j, C at 6+L+j, l at 6+2L+j
            facd[i] = r[6: 6 + L]
            faccp[i] = r[6 + L: 6 + 2 * L]
            lcol = r[6 + 2 * L: 6 + 3 * L]
            faclam[i, 0] = lcol[0]
            faclam[i, 1:L] = 0.5 * (lcol[:-1] + lcol[1:])
            faclam[i, L] = faclam[i, L - 1]
        svf = read_column_file(case_dir / f"svf.inp.{expnr}")
        netsw = read_column_file(case_dir / f"netsw.inp.{expnr}")
        tlyr_p = case_dir / f"Tfacinit_layers.inp.{expnr}"
        tfac_p = case_dir / f"Tfacinit.inp.{expnr}"
        if cfg.eb.lfacTlyrs and tlyr_p.exists():
            Tfacinit = np.loadtxt(tlyr_p, skiprows=1, ndmin=2)
        else:
            Tfacinit = read_column_file(tfac_p) if tfac_p.exists() else None
        vf = vf_sparse = None
        if cfg.eb.lvfsparse:
            tri = np.loadtxt(case_dir / f"vfsparse.inp.{expnr}", ndmin=2)
            vf_sparse = (tri[:, 0].astype(np.int64) - 1,
                         tri[:, 1].astype(np.int64) - 1, tri[:, 2])
        else:
            from scipy.io import netcdf_file
            f = netcdf_file(str(case_dir / f"vf.nc.inp.{expnr}"), "r",
                            mmap=False)
            # netCDF-Fortran reverses the dimension order: the reference's
            # vf(n, m) (rows summing with svf to 1, the enclosure property)
            # is the transpose of the C-order array scipy returns
            vf = np.array(f.variables["view factor"][:], dtype=np.float64).T
            f.close()
        return cls(cfg, facets, ibm.faca, facem, facd, faccp, faclam, faclGR,
                   vf, vf_sparse, svf, netsw, Tfacinit,
                   dtype=ibm.grid.torch_dtype, device=device)

    def initial_state(self) -> FacetState:
        eb = self.cfg.eb
        kw = dict(dtype=self.dtype, device=self.device)
        z = torch.zeros(self.nfcts, **kw)
        wsoil = torch.where(self.faclGR, torch.full_like(z, eb.wsoil), z)
        hurel0 = 0.5 * (1.0 - np.cos(3.14159 * eb.wsoil / eb.wfc))
        hurel = torch.where(self.faclGR, torch.full_like(z, hurel0), z)
        f = torch.zeros((self.nfcts, 5), **kw)
        f[:, 3] = 200.0     # initfac.f90:134
        f[:, 4] = 50.0
        return FacetState(
            T=self.T0, Tdash=torch.zeros_like(self.T0), hfi=z, efi=z,
            wsoil=wsoil, hurel=hurel, qsat=qsat_fn(self.T0[:, 0]), f=f,
            tnextEB=torch.tensor(eb.dtEB, **kw),
            tEB_last=torch.tensor(0.0, **kw))

    # -- physics -----------------------------------------------------------
    def calclw(self, T, skyLW=None):
        """Longwave in-flux per facet (modEB.f90:335-363)."""
        emitted = self.facem * const.boltz * T[:, 0] ** 4
        if self.vf is not None:
            lw = self.vf @ emitted
        else:
            i, j, v = self.vf_sparse
            lw = torch.zeros_like(emitted).index_add(0, i, v * emitted[j])
        skyLW = self.cfg.eb.skyLW if skyLW is None else skyLW
        return (lw + self.svf * skyLW) * self.facem

    def update(self, fstate: FacetState, timee, skyLW=None,
               netsw=None) -> FacetState:
        """One EB solve (modEB.f90:429-541).  skyLW/netsw may be the
        time-interpolated overrides (modtimedep timedeplw/timedepsw)."""
        eb = self.cfg.eb
        tEB = torch.clamp(timee - fstate.tEB_last, min=1e-6)

        # mean fluxes since the last solve [W/m^2] (modEB.f90:392, 445)
        hfi = fstate.hfi / tEB / self.faca * const.rhoa * const.cp
        efi = fstate.efi / tEB / self.faca * const.rhoa * const.rlv

        # green roof update (modEB.f90:366-413)
        wsoil = fstate.wsoil
        if not eb.lconstW:
            wsoil = torch.where(
                self.faclGR,
                torch.clamp(wsoil + efi * tEB / const.rlv
                            / torch.clamp(self.facd[:, 0], min=1e-30),
                            min=0.0),
                wsoil)
        hurel = torch.where(
            self.faclGR,
            torch.clamp(0.5 * (1.0 - torch.cos(3.14159 * wsoil / eb.wfc)),
                        0.0, 1.0),
            fstate.hurel)
        T1 = fstate.T[:, 0]
        nsw = self.netsw if netsw is None else netsw
        f1 = 1.0 / torch.clamp((0.004 * nsw + 0.05)
                               / (0.81 * (0.004 * nsw + 1.0)), max=1.0)
        f2 = 1.0 / torch.clamp((wsoil - eb.wwilt) / (eb.wfc - eb.wwilt),
                               0.001, 1.0)
        f4 = 1.0 / torch.clamp(1.0 - 0.0016 * (298.0 - T1) ** 2, min=0.001)
        rplant = torch.clamp(eb.rsmin / eb.GRLAI * f1 * f2 * f4, max=5000.0)
        rsoil = torch.clamp(eb.rsmin * f2, max=5000.0)
        f = torch.where(self.faclGR[:, None],
                        torch.stack([f1, f2, f4, rplant, rsoil], dim=1),
                        fstate.f)

        LWin = self.calclw(fstate.T, skyLW)

        # batched conduction solve (modEB.f90:458-508)
        lam1 = torch.clamp(self.faclam[:, 0], min=1e-30)
        ab = const.boltz * self.facem * T1 ** 3 / lam1
        n = self.L + 1
        BM = self.BM0.clone()
        BM[:, 0, 0] = ab
        bb = torch.zeros((self.nfcts, n), dtype=fstate.T.dtype,
                         device=fstate.T.device)
        bb[:, 0] = -(nsw + LWin + hfi + efi) / lam1
        inAM = self.inAM
        w = torch.einsum("fij,jk,fk->fi", self.EM, inAM, bb) * tEB
        HM0 = torch.einsum("ij,fjk->fik", inAM, BM)
        FM = self.CM + torch.einsum("fij,fjk->fik", self.DM, HM0)
        GM = torch.einsum("fij,fjk->fik", self.EM, HM0)
        HH = FM - GM * tEB
        rhs = torch.einsum("fij,fj->fi", FM, fstate.T) + w
        # guard unsolved facets (bounding walls) with identity systems
        eye = torch.eye(n, dtype=HH.dtype, device=HH.device)
        HHs = torch.where(self.model_mask[:, None, None], HH, eye)
        Tnew = torch.linalg.solve_ex(HHs, rhs[..., None])[0][..., 0]
        Tnew = torch.where(self.model_mask[:, None], Tnew, fstate.T)

        # interface gradients facTdash = inAM (bb + BM Tnew)
        # (modEB.f90:503-505); the ground heat flux is -lam * Tdash[:, 0]
        w2 = torch.einsum("fij,fj->fi", BM, Tnew)
        Tdash = torch.einsum("ij,fj->fi", inAM, bb + w2)
        Tdash = torch.where(self.model_mask[:, None], Tdash, fstate.Tdash)

        return FacetState(
            T=Tnew, Tdash=Tdash, hfi=torch.zeros_like(fstate.hfi),
            efi=torch.zeros_like(fstate.efi), wsoil=wsoil, hurel=hurel,
            qsat=qsat_fn(Tnew[:, 0]), f=f,
            tnextEB=torch.round(timee + eb.dtEB).to(fstate.tnextEB.dtype),
            tEB_last=timee.to(fstate.tEB_last.dtype))

    def maybe_update(self, fstate: FacetState, timee, skyLW=None,
                     netsw=None) -> FacetState:
        """The EB fire gated on the device (modEB.f90:429): the update is
        always computed and every leaf keeps its old value, bit for bit,
        unless ``timee >= tnextEB``."""
        fire = timee >= fstate.tnextEB
        new = self.update(fstate, timee, skyLW, netsw)
        return FacetState(**{k: torch.where(fire, getattr(new, k),
                                            getattr(fstate, k))
                             for k in FACET_STATE_NAMES})
