"""Model assembly and RK3 time integration (port of ``udales_tpu.run``,
closed-domain slice, with the immersed boundary).

Reference main loop src/program.f90:133-223 and Wicker-Skamarock RK3
(src/modtstep.f90): one `substep` evaluates every tendency, projects with
the Poisson solver and integrates

    c = m + rk3coef * tend,   rk3coef = dt / (4 - rk3step)

with m <- c on the third substep.  `dt` and `timee` stay 0-d device
tensors and `step` makes no host synchronisation (no `.item()`, no Python
branch on a tensor), so N steps can later be captured as one CUDA graph.

With an ``ibm.IBM`` the substep takes the IBM hooks where udales_tpu's does
(run.py:162-535): masked thermodynamics slab averages, the pmask-folded
diffusion, the facet wall functions after the forces, the masked
volume-flow correction and ibmnorm before the projection.  With an
``ibm.eb.FacetEB`` (``lEB``) the State carries the facet state: the wall
functions read its live surface temperatures, the third substep integrates
the per-facet fluxes, and `step` ends with the device-gated energy-balance
solve.  `load_case` builds a Model from a case directory (udales_tpu
``load_case``).

Configuration branches the port does not cover (open boundaries, physics
modules, nudging, large-scale tendencies, sponge damping, chemistry,
passive scalars, the one-equation closure) raise NotImplementedError when
the Model is built.
"""
from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from .config import (BCTOPM_PRESSURE, BC_PERIODIC, IADV_KAPPA, SGS_ONEEQN,
                     Config, const, load_namoptions)
from .convert import load_profiles
from .grid import Grid
from .io.inputs import CaseInputs, large_scale_pressure_gradient
from .state import (FACSTAT_FIELDS, Fields, State, initial_state,
                    profile_fields, randomize, zero_facstats)
from .ops import advection as adv
from .ops import subgrid as sgs
from .ops.boundary import Ghosts, ghost_u, ghost_v, ghost_w, make_ghosts
from .ops.forces import (coriolis, forces, masscorr_uvol, masscorr_vvol,
                         periodic_eb_corr)
from .ops.fused_diff import fused_diff_mom
from .ops.halo import pad_periodic_xy
from .ops.poisson import PoissonSolver
from .ops.thermo import ThermoDiag, avexy_masked, thermodynamics
from .ibm.bottom import bottom_tendencies
from .ibm.eb import FacetEB
from .timedep import Timedep


def _unsupported(cfg: Config, ibm=None):
    """Names of the configured features this port does not implement."""
    ph, bc = cfg.physics, cfg.bc
    codes = {c.strip() for c in cfg.output.fieldvars.split(",")}
    checks = {
        "open x/y boundaries": (bc.BCxm != BC_PERIODIC
                                or bc.BCym != BC_PERIODIC),
        "inlet generation / driver replay": cfg.driver.iinletgen != 0,
        "passive scalars": cfg.scalars.nsv > 0,
        "one-equation TKE closure": cfg.subgrid.model == SGS_ONEEQN,
        "kappa advection of thl": (ph.ltempeq
                                   and cfg.iadv_thl == IADV_KAPPA),
        "shifted periodic BCs": ph.ds > 0,
        "sponge-layer damping": ph.igrw_damp != 0,
        "nudging": ph.lnudge and ph.nnudge > 0,
        "free-stream controllers": ph.ifixuinf != 0,
        "facet energy-balance file output (lwriteEBfiles)": (
            cfg.eb.lEB and cfg.eb.lwriteEBfiles),
        "an IBM case (libm, nfcts > 0) without its IBM": (
            ibm is None and cfg.run.libm and cfg.walls.nfcts > 0),
        "wall-stress field dumps": bool(
            cfg.output.lfielddump and codes & {"tx", "ty", "tz", "hf"}),
    }
    return [name for name, on in checks.items() if on]


class Model:
    """Static configuration and precomputed operators for one case (the
    reference's init* routines, program.f90:63-124); everything mutable
    lives in `State`.  `ibm` is the case's ``ibm.IBM`` on the same device,
    or None.  `device` is the card unless the caller asks for "cpu"; with
    no card the constructor raises.  The static profiles are zero until set
    (`load_case` reads them; see also ``convert.load_profiles``)."""

    def __init__(self, cfg: Config, grid: Grid, ibm=None, device="cuda"):
        missing = _unsupported(cfg, ibm)
        if missing:
            raise NotImplementedError(
                "not ported to udales_tpu_torch yet: " + ", ".join(missing))
        self.cfg = cfg
        self.grid = grid
        self.ibm = ibm
        self.device = torch.device(device)
        self.inputs = None   # io.inputs.CaseInputs once load_case reads one
        self.eb = None       # ibm.eb.FacetEB for energy-balance runs
        self.timedep = None  # timedep.Timedep
        self.pois = PoissonSolver(grid, cfg, device=self.device)
        nz = grid.ktot
        kw = dict(dtype=grid.torch_dtype, device=self.device)
        self.dpdxl = torch.zeros(nz, **kw)
        self.dpdyl = torch.zeros(nz, **kw)
        self.ug = torch.zeros(nz, **kw)
        self.vg = torch.zeros(nz, **kw)
        self.thlpcar = torch.zeros(nz, **kw)
        self.whls = torch.zeros(nz + 1, **kw)
        self.dqtdtls = torch.zeros(nz, **kw)

    # -- initial condition -------------------------------------------------
    def cold_start(self, seed: int = 43, dt0: float | None = None) -> State:
        """Profile initialization and randomization
        (modstartup.readinitfiles:943; udales_tpu run.py:99-131).  The noise
        comes from a torch.Generator seeded with `seed` on the model's
        device, so it is not jax.random's: parity tests start both packages
        from one converted State.  Solid cells keep the profile values, as
        in the reference; ibmnorm and the projection zero them within the
        first substep."""
        cfg, grid = self.cfg, self.grid
        nz = grid.ktot
        if self.inputs is not None:
            p = self.inputs.prof
            f = profile_fields(grid, p["u"], p["v"], p["thl"], p["qt"],
                               np.maximum(p["e12"], const.e12min),
                               device=self.device)
        else:
            f = profile_fields(grid, np.zeros(nz), np.zeros(nz),
                               np.full(nz, 288.0), np.zeros(nz),
                               np.full(nz, const.e12min), device=self.device)
        if cfg.run.lrandomize:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            f = randomize(f, gen, cfg.run.randu, min(cfg.run.krand, nz))
        dt0 = dt0 if dt0 is not None else min(cfg.run.dtmax, 0.1)
        fac = self.eb.initial_state() if self.eb is not None else None
        st = initial_state(grid, f, dt0=dt0, fac=fac)
        if cfg.walls.lwritefac and self.ibm is not None:
            st = st.replace(facstats=zero_facstats(
                self.ibm.nfcts, grid.torch_dtype, self.device))
        return st

    # -- one RK3 substep ---------------------------------------------------
    def substep(self, state: State, rk3step: int, th: ThermoDiag | None = None,
                closure_out=None) -> State:
        """One substep.  `th`/`closure_out` hand down the diagnostics `step`
        already computed on `m` for the adaptive dt; valid only for
        rk3step == 1, where c == m."""
        cfg, grid = self.cfg, self.grid
        nz = grid.ktot
        c, m = state.c, state.m
        rk3coef = state.dt / (4.0 - rk3step)
        ltemp = cfg.physics.ltempeq
        lmoist = cfg.physics.lmoist
        ibm = self.ibm

        if th is None:
            th = thermodynamics(c, cfg, grid,
                                ibm.masks if ibm is not None else None)

        # --- SGS closure (modsubgrid.closure) ------------------------------
        thvs = cfg.bc.thls if cfg.bc.thls > 0 else 288.0
        if closure_out is None:
            gvel = _velocity_ghosts(c, cfg, grid)
            ekm, ekh, _ = sgs.closure(gvel, grid, cfg, e12=c.e12,
                                      dthvdz=th.dthvdz, thl=c.thl, thvs=thvs)
        else:
            ekm, ekh, _ = closure_out

        g = make_ghosts(c, ekm, ekh, cfg, grid)

        # --- advection (+ pressure-gradient term, modadvection) ------------
        gp = _pad_pres(state.pres)
        du = adv.adv_u(g, grid) \
            - (gp[1:-1, 1:-1, :] - gp[:-2, 1:-1, :]) * grid.dxi
        dv = adv.adv_v(g, grid) \
            - (gp[1:-1, 1:-1, :] - gp[1:-1, :-2, :]) * grid.dyi
        dw = adv.adv_w(g, grid)
        dzhi = grid.t("dzhi", self.device)
        dw[..., 1:nz] -= (state.pres[:, :, 1:] - state.pres[:, :, :-1]) \
            * dzhi[1:nz][None, None, :]
        dthl = adv.adv_c2(g.thl, g, grid) if ltemp else None
        dqt = adv.adv_c2(g.qt, g, grid) if lmoist else None

        # --- subgrid diffusion: the hand-written kernel on CUDA ------------
        # the IBM diffusion corrections (diffu_corr..diffc_corr) are folded
        # into the sweeps as {0,1} flux masks, as in udales_tpu
        pmasks = Mc = None
        if ibm is not None:
            pmasks = dict(u=ibm.pmask_u, v=ibm.pmask_v, w=ibm.pmask_w)
            Mc = ibm.pmask_c
        xu, xv, xw = fused_diff_mom(g, grid, pmasks=pmasks)
        du, dv, dw = du + xu, dv + xv, dw + xw
        if ltemp:
            dthl = dthl + sgs.diff_c(g.thl, g.ekh, grid, M=Mc)
        if lmoist:
            dqt = dqt + sgs.diff_c(g.qt, g.ekh, grid, M=Mc)

        # --- floor wall functions (modibm.bottom) --------------------------
        bu, bv, bthl, bqt, _ = bottom_tendencies(g, cfg, grid)
        du, dv = du + bu, dv + bv
        if ltemp:
            dthl = dthl + bthl
        if lmoist:
            dqt = dqt + bqt

        # --- coriolis / forces ---------------------------------------------
        cu, cv, cw = coriolis(g, grid, cfg, self.ug, self.vg)
        du, dv, dw = du + cu, dv + cv, dw + cw
        fu, fv, fw = forces(g, grid, cfg, self.dpdxl, self.dpdyl,
                            th.thv0h, th.thvh)
        du, dv, dw = du + fu, dv + fv, dw + fw
        if ltemp:
            dthl = dthl + self.thlpcar[None, None, :]

        # --- IBM wall functions (modibm.ibmwallfun) ------------------------
        fac, facstats = state.fac, state.facstats
        if ibm is not None:
            bctf = (self.timedep.surf_fluxes(state.timee)
                    if self.timedep is not None else None)
            need_fac = fac is not None and rk3step == 3
            need_fstats = (cfg.walls.lwritefac and rk3step == 3
                           and facstats is not None)
            (du, dv, dw, dthl, dqt, fachf, facef, hf_tot, ef_tot,
             fstats) = ibm.wallfun(g, du, dv, dw, dthl, dqt, fac, bctf,
                                   need_fac=need_fac,
                                   need_facstats=need_fstats,
                                   pres=state.pres)
            # intqH (modEB.f90:220-247): the facet fluxes accumulate in time
            # on the last substep, with the full dt
            if need_fac:
                fac = replace(fac, hfi=fac.hfi + state.dt * fachf,
                              efi=fac.efi + state.dt * facef)
            # lwritefac dt-weighted accumulation (modibm.f90:1246-1254)
            if need_fstats:
                facstats = replace(facstats, **{
                    k: getattr(facstats, k) + state.dt * fstats[k]
                    for k in FACSTAT_FIELDS})
            # periodic heat-buildup sink (modforces.periodicEBcorr)
            if cfg.eb.lperiodicEBcorr:
                pthl, pqt = periodic_eb_corr(grid, cfg, hf_tot, ef_tot)
                if ltemp:
                    dthl = dthl + pthl[None, None, :]
                if lmoist:
                    dqt = dqt + pqt[None, None, :]

        # --- mass-flow-rate correction (modforces.masscorr) ----------------
        IIu = IIv = None
        if ibm is not None:
            IIu, IIv = ibm.masks.u, ibm.masks.v
        if cfg.physics.luvolflowr:
            du = masscorr_uvol(du, m.u, grid, cfg, rk3coef, IIu)
        if cfg.physics.lvvolflowr:
            dv = masscorr_vvol(dv, m.v, grid, cfg, rk3coef, IIv)

        # --- IBM: zero solid velocities, fill solid thl (ibmnorm) ----------
        if ibm is not None:
            dzf = grid.t("dzf", self.device)
            thl_vmean = torch.sum(th.thl0av * dzf) / float(grid.zh[-1])
            du, dv, dw, dthl, dqt, m = ibm.ibmnorm(c, m, du, dv, dw, dthl,
                                                   thl_vmean, dqt)

        # --- forces hard-zeroes wp at the floor (modforces.f90:125) --------
        dw[..., 0] = 0.0

        # --- pressure projection (modpois.poisson) -------------------------
        du, dv, dw, p = self._project(du, dv, dw, m, rk3coef, state.pres)
        pres = state.pres + p

        # --- integrate (modtstep.tstep_integrate) --------------------------
        w_new = m.w + rk3coef * dw
        w_new[..., 0] = 0.0
        c_new = Fields(
            u=m.u + rk3coef * du,
            v=m.v + rk3coef * dv,
            w=w_new,
            thl=m.thl + rk3coef * dthl if ltemp else m.thl,
            qt=m.qt + rk3coef * dqt if lmoist else m.qt,
            e12=torch.clamp(m.e12, min=const.e12min),
            sv=m.sv,
        )
        m_new = c_new if rk3step == 3 else m
        return state.replace(c=c_new, m=m_new, pres=pres, fac=fac,
                             facstats=facstats)

    def _project(self, du, dv, dw, m: Fields, rk3coef, pres):
        """fillps + bcpup + poisson + tderive (modpois.f90:911-998, 419-712,
        1001-1105), periodic x/y with an impermeable bottom and an
        impermeable or pressure (``BCtopm``) top.  `pres` is the accumulated
        pressure.  Returns the projected tendencies and the pressure
        correction."""
        grid, cfg = self.grid, self.cfg
        nz = grid.ktot
        rk3coefi = 1.0 / rk3coef
        lptop = cfg.bc.BCtopm == BCTOPM_PRESSURE
        IIc = self.ibm.masks.c if self.ibm is not None else None
        dzhi_top = 1.0 / float(grid.dzh[-1])

        def top_gradient(p):
            """2 <p>_ke dzhi(ke+1), the slab mean over the fluid cells."""
            pij = avexy_masked(p, IIc)
            pij = torch.where(pij < -900.0, 0.0, pij)
            return 2.0 * pij[nz - 1] * dzhi_top

        dw = dw.clone()
        pup = du + m.u * rk3coefi
        pvp = dv + m.v * rk3coefi
        pwp = dw + m.w * rk3coefi
        pwp[..., 0] = 0.0
        if lptop:
            # pwp(ke+1) = wm/rk3coef + 2 <pres0>_ke dzhi(ke+1)
            # (modboundary.f90:1241); the wp part is folded into dw
            wtop_t = top_gradient(pres)
            dw[..., nz] = wtop_t
            pwp[..., nz] = m.w[..., nz] * rk3coefi + wtop_t
        else:
            pwp[..., nz] = 0.0
        dzfi = grid.t("dzfi", self.device)
        gpu = pad_periodic_xy(pup, 1)
        ddx = (gpu[2:, 1:-1, :] - gpu[1:-1, 1:-1, :]) * grid.dxi
        gpv = pad_periodic_xy(pvp, 1)
        ddy = (gpv[1:-1, 2:, :] - gpv[1:-1, 1:-1, :]) * grid.dyi
        rhs = (ddx + ddy
               + (pwp[:, :, 1:] - pwp[:, :, :-1]) * dzfi[None, None, :])
        p = self.pois.solve(rhs)
        gp = _pad_pres(p)
        du = du - (gp[1:-1, 1:-1, :] - gp[:-2, 1:-1, :]) * grid.dxi
        dv = dv - (gp[1:-1, 1:-1, :] - gp[1:-1, :-2, :]) * grid.dyi
        dzhi = grid.t("dzhi", self.device)
        dw[..., 1:nz] += -(p[:, :, 1:] - p[:, :, :-1]) \
            * dzhi[1:nz][None, None, :]
        if lptop:
            # wp(ke+1) += 2 <p>_ke dzhi(ke+1) (modpois.f90:1058-1069)
            dw[..., nz] += top_gradient(p)
        return du, dv, dw, p

    # -- dt control (modtstep.tstep_update:49-154) --------------------------
    def new_dt(self, state: State, ekm=None, ekh=None):
        cfg, grid = self.cfg, self.grid
        if not cfg.run.ladaptive:
            return torch.full((), cfg.run.dtmax, dtype=state.dt.dtype,
                              device=state.dt.device)
        m = state.m
        nz = grid.ktot
        dzh = grid.t("dzh", self.device)
        courtot_per_dt = torch.max(
            torch.abs(m.u) * grid.dxi + torch.abs(m.v) * grid.dyi
            + torch.abs(m.w[..., :nz]) / dzh[:nz][None, None, :])
        new = cfg.courant / torch.clamp(courtot_per_dt, min=1e-12)
        if ekm is not None:
            dzh2i = grid.t("dzh2i", self.device)
            coef = dzh2i[:nz][None, None, :] + grid.dx2i + grid.dy2i
            diff_per_dt = torch.maximum(torch.max(ekm * coef),
                                        torch.max(ekh * coef))
            new = torch.minimum(new, cfg.run.diffnr
                                / torch.clamp(diff_per_dt, min=1e-12))
        return torch.clamp(new, max=cfg.run.dtmax).to(state.dt.dtype)

    # -- full step -----------------------------------------------------------
    def step(self, state: State) -> State:
        """One full RK3 timestep (3 substeps) + dt/time bookkeeping."""
        cfg, grid = self.cfg, self.grid
        gvel = _velocity_ghosts(state.m, cfg, grid)
        th = thermodynamics(state.m, cfg, grid,
                            self.ibm.masks if self.ibm is not None else None)
        thvs = cfg.bc.thls if cfg.bc.thls > 0 else 288.0
        closure_out = sgs.closure(gvel, grid, cfg, e12=state.m.e12,
                                  dthvdz=th.dthvdz, thl=state.m.thl,
                                  thvs=thvs)
        dt = self.new_dt(state, closure_out[0], closure_out[1])
        state = state.replace(dt=dt, timee=state.timee + dt)
        # c == m at step entry, so substep 1 reuses the diagnostics computed
        # for the adaptive dt
        state = self.substep(state, 1, th=th, closure_out=closure_out)
        for rk3step in (2, 3):
            state = self.substep(state, rk3step)
        # the facet energy balance fires every dtEB (quantized),
        # modEB.f90:429; gated on the device, see FacetEB.maybe_update
        if self.eb is not None and state.fac is not None:
            skyLW = netsw = None
            if self.timedep is not None:
                skyLW = self.timedep.sky_lw(state.timee)
                netsw = self.timedep.net_sw(state.timee)
            state = state.replace(fac=self.eb.maybe_update(
                state.fac, state.timee, skyLW=skyLW, netsw=netsw))
        return state

    def run(self, state: State, nsteps: int) -> State:
        """`nsteps` full steps."""
        for _ in range(nsteps):
            state = self.step(state)
        return state


def _case_profiles(inputs, cfg: Config, grid: Grid) -> dict:
    """The Model's static vertical profiles from a case's lscale.inp
    (udales_tpu ``Model.__init__``, run.py:68-95)."""
    nz = grid.ktot
    ls = inputs.lscale
    dpdxl, dpdyl = large_scale_pressure_gradient(ls, cfg)
    # subsidence half-level profile (modstartup.f90:2125-2129)
    wfls = np.asarray(ls["wfls"], float)
    dzf, dzh = grid.dzf, grid.dzh
    whls = np.zeros(nz + 1)
    whls[1:nz] = (wfls[1:] * dzf[:-1] + wfls[:-1] * dzf[1:]) \
        / (2.0 * dzh[1:nz])
    whls[nz] = (wfls[-1] + dzf[-1] * (wfls[-1] - wfls[-2]) / dzh[-2]
                if nz > 1 else wfls[-1])
    return dict(dpdxl=dpdxl, dpdyl=dpdyl, ug=ls["ug"], vg=ls["vg"],
                thlpcar=ls["thlpcar"], whls=whls, dqtdtls=ls["dqtdt"])


def load_case(case_dir, expnr: str | None = None, dtype: str = "float32",
              device="cuda") -> Model:
    """Build a Model from a case directory (namoptions and inputs), the
    subset of udales_tpu ``load_case`` (run.py:772-791) this port covers:
    grid from prof.inp, profiles from prof.inp and lscale.inp, the IBM when
    ``libm`` and ``nfcts > 0``, with ``lEB`` its facet energy balance, and
    the time-dependent series whose switches are on and whose files exist.
    Inputs that would switch on a subsystem the port lacks raise
    NotImplementedError."""
    case_dir = Path(case_dir)
    if expnr is None:
        expnr = sorted(case_dir.glob("namoptions.*"))[0].suffix[1:]
    cfg = load_namoptions(case_dir / f"namoptions.{expnr}", dtype=dtype)
    dom = cfg.domain
    np_dt = np.float32 if dtype == "float32" else np.float64
    grid = Grid.from_prof_inp(case_dir / f"prof.inp.{expnr}", dom.itot,
                              dom.jtot, dom.ktot, dom.xlen, dom.ylen,
                              dtype=np_dt)
    inputs = CaseInputs.load(case_dir, expnr, dom.ktot, cfg.scalars.nsv)
    lacking = {
        "large-scale tendencies": bool(np.any(inputs.lscale["wfls"] != 0)
                                       or np.any(inputs.lscale["dqtdt"] != 0)),
        "trees": cfg.trees.ltrees,
        "purifiers": cfg.purifs.lpurif,
        "heat pumps": cfg.heatpump.lheatpump,
    }
    missing = [name for name, on in lacking.items() if on]
    if missing:
        raise NotImplementedError(
            "not ported to udales_tpu_torch yet: " + ", ".join(missing))
    ibm = None
    if cfg.run.libm and cfg.walls.nfcts > 0:
        from .ibm.ibm import IBM
        ibm = IBM.load(case_dir, expnr, cfg, grid, device=device)
    model = Model(cfg, grid, ibm, device=device)
    load_profiles(model, _case_profiles(inputs, cfg, grid))
    model.inputs = inputs
    if cfg.eb.lEB and ibm is not None:
        model.eb = FacetEB.load(case_dir, expnr, cfg, ibm, device=device)
    model.timedep = Timedep.load(case_dir, expnr, cfg, dom.ktot,
                                 dtype=grid.torch_dtype, device=device)
    return model


def _velocity_ghosts(f: Fields, cfg: Config, grid: Grid) -> Ghosts:
    """Minimal ghost set (u, v, w only) for closure/dt before ekm exists."""
    return Ghosts(u=ghost_u(f.u, cfg), v=ghost_v(f.v, cfg),
                  w=ghost_w(f.w, cfg), thl=None, qt=None, e12=None, sv=None,
                  ekm=None, ekh=None)


def _pad_pres(p):
    """Pressure ghosts (bcp, modboundary.f90:1344-1430): periodic wrap."""
    return pad_periodic_xy(p, 1)
