"""Model assembly and RK3 time integration (port of ``udales_tpu.run``,
closed-domain slice).

Reference main loop src/program.f90:133-223 and Wicker-Skamarock RK3
(src/modtstep.f90): one `substep` evaluates every tendency, projects with
the Poisson solver and integrates

    c = m + rk3coef * tend,   rk3coef = dt / (4 - rk3step)

with m <- c on the third substep.  `dt` and `timee` stay 0-d device
tensors and `step` makes no host synchronisation (no `.item()`, no Python
branch on a tensor), so N steps can later be captured as one CUDA graph.

Configuration branches the slice does not cover (IBM, facet energy balance,
open boundaries, physics modules, nudging, large-scale tendencies, sponge
damping, chemistry, passive scalars, the one-equation closure, moist
thermodynamics) raise NotImplementedError when the Model is built.
"""
from __future__ import annotations

import torch

from .config import (BCTOPM_PRESSURE, BC_PERIODIC, IADV_KAPPA, SGS_ONEEQN,
                     Config, const)
from .grid import Grid
from .state import Fields, State
from .ops import advection as adv
from .ops import subgrid as sgs
from .ops.boundary import Ghosts, ghost_u, ghost_v, ghost_w, make_ghosts
from .ops.forces import coriolis, forces, masscorr_uvol, masscorr_vvol
from .ops.fused_diff import fused_diff_mom
from .ops.halo import pad_periodic_xy
from .ops.poisson import PoissonSolver
from .ops.thermo import ThermoDiag, thermodynamics
from .ibm.bottom import bottom_tendencies


def _unsupported(cfg: Config):
    """Names of the configured features this port does not implement."""
    ph, bc = cfg.physics, cfg.bc
    codes = {c.strip() for c in cfg.output.fieldvars.split(",")}
    checks = {
        "open x/y boundaries": (bc.BCxm != BC_PERIODIC
                                or bc.BCym != BC_PERIODIC),
        "inlet generation / driver replay": cfg.driver.iinletgen != 0,
        "pressure top BC": bc.BCtopm == BCTOPM_PRESSURE,
        "moist thermodynamics": ph.lmoist,
        "passive scalars": cfg.scalars.nsv > 0,
        "one-equation TKE closure": cfg.subgrid.model == SGS_ONEEQN,
        "kappa advection of thl": (ph.ltempeq
                                   and cfg.iadv_thl == IADV_KAPPA),
        "shifted periodic BCs": ph.ds > 0,
        "sponge-layer damping": ph.igrw_damp != 0,
        "nudging": ph.lnudge and ph.nnudge > 0,
        "free-stream controllers": ph.ifixuinf != 0,
        "facet energy balance": cfg.eb.lEB,
        "wall-stress field dumps": bool(
            cfg.output.lfielddump and codes & {"tx", "ty", "tz", "hf"}),
    }
    return [name for name, on in checks.items() if on]


class Model:
    """Static configuration and precomputed operators for one case (the
    reference's init* routines, program.f90:63-124); everything mutable
    lives in `State`.  Built without case inputs: the static profiles are
    zero until set (see ``convert.load_profiles``)."""

    def __init__(self, cfg: Config, grid: Grid, device="cpu"):
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(
                "not ported to udales_tpu_torch yet: " + ", ".join(missing))
        self.cfg = cfg
        self.grid = grid
        self.device = torch.device(device)
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

        if th is None:
            th = thermodynamics(c, cfg, grid)

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

        # --- subgrid diffusion: the hand-written kernel on CUDA ------------
        xu, xv, xw = fused_diff_mom(g, grid)
        du, dv, dw = du + xu, dv + xv, dw + xw
        if ltemp:
            dthl = dthl + sgs.diff_c(g.thl, g.ekh, grid)

        # --- floor wall functions (modibm.bottom) --------------------------
        bu, bv, bthl, _, _ = bottom_tendencies(g, cfg, grid)
        du, dv = du + bu, dv + bv
        if ltemp:
            dthl = dthl + bthl

        # --- coriolis / forces ---------------------------------------------
        cu, cv, cw = coriolis(g, grid, cfg, self.ug, self.vg)
        du, dv, dw = du + cu, dv + cv, dw + cw
        fu, fv, fw = forces(g, grid, cfg, self.dpdxl, self.dpdyl,
                            th.thv0h, th.thvh)
        du, dv, dw = du + fu, dv + fv, dw + fw
        if ltemp:
            dthl = dthl + self.thlpcar[None, None, :]

        # --- mass-flow-rate correction (modforces.masscorr) ----------------
        if cfg.physics.luvolflowr:
            du = masscorr_uvol(du, m.u, grid, cfg, rk3coef)
        if cfg.physics.lvvolflowr:
            dv = masscorr_vvol(dv, m.v, grid, cfg, rk3coef)

        # --- forces hard-zeroes wp at the floor (modforces.f90:125) --------
        dw[..., 0] = 0.0

        # --- pressure projection (modpois.poisson) -------------------------
        du, dv, dw, p = self._project(du, dv, dw, m, rk3coef)
        pres = state.pres + p

        # --- integrate (modtstep.tstep_integrate) --------------------------
        w_new = m.w + rk3coef * dw
        w_new[..., 0] = 0.0
        c_new = Fields(
            u=m.u + rk3coef * du,
            v=m.v + rk3coef * dv,
            w=w_new,
            thl=m.thl + rk3coef * dthl if ltemp else m.thl,
            qt=m.qt,
            e12=torch.clamp(m.e12, min=const.e12min),
            sv=m.sv,
        )
        m_new = c_new if rk3step == 3 else m
        return state.replace(c=c_new, m=m_new, pres=pres)

    def _project(self, du, dv, dw, m: Fields, rk3coef):
        """fillps + bcpup + poisson + tderive (modpois.f90:911-998, 419-712,
        1001-1105), periodic x/y with impermeable bottom and top.  Returns
        the projected tendencies and the pressure correction."""
        grid = self.grid
        nz = grid.ktot
        rk3coefi = 1.0 / rk3coef
        pup = du + m.u * rk3coefi
        pvp = dv + m.v * rk3coefi
        pwp = dw + m.w * rk3coefi
        pwp[..., 0] = 0.0
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
        dw = dw.clone()
        dw[..., 1:nz] += -(p[:, :, 1:] - p[:, :, :-1]) \
            * dzhi[1:nz][None, None, :]
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
        th = thermodynamics(state.m, cfg, grid)
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
        return state

    def run(self, state: State, nsteps: int) -> State:
        """`nsteps` full steps."""
        for _ in range(nsteps):
            state = self.step(state)
        return state


def _velocity_ghosts(f: Fields, cfg: Config, grid: Grid) -> Ghosts:
    """Minimal ghost set (u, v, w only) for closure/dt before ekm exists."""
    return Ghosts(u=ghost_u(f.u, cfg), v=ghost_v(f.v, cfg),
                  w=ghost_w(f.w, cfg), thl=None, qt=None, e12=None, sv=None,
                  ekm=None, ekh=None)


def _pad_pres(p):
    """Pressure ghosts (bcp, modboundary.f90:1344-1430): periodic wrap."""
    return pad_periodic_xy(p, 1)
