"""Model assembly and RK3 time integration (port of ``udales_tpu.run``).

Reference main loop src/program.f90:133-223 and Wicker-Skamarock RK3
(src/modtstep.f90): one `substep` evaluates every tendency, projects with
the Poisson solver and integrates

    c = m + rk3coef * tend,   rk3coef = dt / (4 - rk3step)

with m <- c on the third substep.  `dt` and `timee` stay 0-d device
tensors and `step` makes no host synchronisation (no `.item()`, no Python
branch on a tensor) and no host-to-device copy, so `step_jit` captures it
as one CUDA graph (``graph.CompiledStep``) and ``run(..., graph=True)``
replays it.  On the card hand-written kernels (``ops.kernel``) do a
substep's advection leaf (``ops.fused_adv``), its Vreman closure
(``ops.fused_vreman``), its momentum diffusion (``ops.fused_diff``), the
velocity and thl part of its ibmnorm (``ops.fused_ibmnorm``) and its
scalar stack (``ops.fused_scalars``); on the CPU their plain versions run.

With an ``ibm.IBM`` the substep takes the IBM hooks where udales_tpu's does
(run.py:162-535): masked thermodynamics slab averages, the pmask-folded
diffusion, the facet wall functions after the forces, the masked
volume-flow correction and ibmnorm before the projection.  With an
``ibm.eb.FacetEB`` (``lEB``) the State carries the facet state: the wall
functions read its live surface temperatures, the third substep integrates
the per-facet fluxes, and `step` ends with the device-gated energy-balance
solve.  `load_case` builds a Model from a case directory (udales_tpu
``load_case``).

Open x/y boundaries follow udales_tpu's run.py:183-229, 486-521, 567-607:
an ``ops.openbc.Inlet`` (profile, driver series, rolling driver window,
recycle, or the ``ops.inletgen`` generator) supplies the inlet planes of
each substep, the ghosts are built from them and from the prognostic outlet
planes ``Fields.bx`` / ``Fields.by``, the projection takes the inlet face
as given and the outlet face as convective, and the integrate step pins the
inlet and advects the outlet planes of both `c` and `m`.  With
``lchunkread`` that window is refilled between steps by
``Model.driver_stream.ensure`` (``run`` calls it; a caller that steps by
hand calls it before each ``step``).

The long-tail physics follows udales_tpu's run.py:246-320, 438-531:
passive scalars (kappa advection, ``diff_c`` with the IBM's folded mask,
the large-scale term, ibmnorm's solid fill; all ``nsv`` scalars as one
tensor with a leading axis, so that the launches do not grow with
``nsv``), the one-equation TKE closure (its ``e12`` tendency and floor),
and the hooks of ``physics.py`` in the reference's order: ibmnorm,
``Vegetation.forcing``, ``HeatPumps.apply``, ``ScalarSources.field``, the
``dw`` floor, the projection, ``Purifiers.apply``, the integrate step, and
``chem_update`` on the third substep.

With ``Model.need_taudiag`` (a field dump of tx/ty/tz/hf) the third
substep keeps the wall-stress diagnostics in ``State.taud``, as udales_tpu's
run.py:356-403 does.  An IBM case built without its IBM raises
NotImplementedError when the Model is built.

``Model(..., mesh=...)`` and ``load_case(..., mesh=...)`` split the run
over the ranks of a ``parallel.mesh.Mesh``, as udales_tpu's Model takes a
device mesh (run.py:46-65): the Model keeps this rank's block grid
(``Grid.block``), the State holds this rank's blocks
(``parallel.mesh.shard_state``; the facet state whole on every rank), the
halos, slab means, the dt limit and the Poisson transposes go through the
mesh's collectives, and each rank launches the kernels on its ghosted
block.  The IBM, the scalar sources, the vegetation, the purifiers and the
heat pumps are those of the rank's block (their ``block`` constructors),
the facet sums of the wall functions are the domain's, and every rank runs
the energy balance on the same facet state.  Open boundaries: the inlet
planes are the rank's y (x) block, pinned and ghosted only by the ranks
that hold the domain's inlet edge (``Grid.edge_xlo``); the outlet planes are
advanced by the ranks that hold the domain's last x (y) cells and reach
the rest of their row (column) from them (``Mesh.from_owner``), so every
rank holds the same planes; the projection's face divergence takes the
next rank's first face through ``Mesh.halo_hi``.  `_split_unsupported`
names what the split refuses (nothing today).
"""
from __future__ import annotations

from dataclasses import fields, replace
from pathlib import Path

import numpy as np
import torch

from . import trace
from .config import (BCTOPM_PRESSURE, BC_DRIVER, BC_PROFILE,
                     IADV_KAPPA, SGS_ONEEQN, Config, const, load_namoptions)
from .convert import load_profiles
from .graph import CompiledStep
from .grid import Grid
from .io.inputs import CaseInputs, large_scale_pressure_gradient
from .state import (FACSTAT_FIELDS, Ctl, Fields, State, initial_state,
                    profile_fields, randomize, zero_facstats)
from .ops import advection as adv
from .ops import subgrid as sgs
from .ops.boundary import (Ghosts, ghost_scalar_kappa, ghost_u, ghost_v,
                           ghost_w, make_ghosts, split_pad)
from .ops.forces import (coriolis, fixuinf1, forces, grwdamp, lstend,
                         masscorr_uvol, masscorr_vvol, nudge_top,
                         periodic_eb_corr, shift_profile, shifted_pbcs,
                         sponge_profile)
from .ops import fused_ibmnorm, fused_vreman
from .ops.fused_adv import fused_adv_mom
from .ops.fused_diff import fused_diff_mom
from .ops.fused_scalars import fused_scalars
from .ops.halo import pad_edge, pad_periodic_xy, pad_wrap
from .ops.inletgen import (InletGenParams, init_inletgen, inletgen_planes,
                           inletgen_update)
from .ops.openbc import (BC_RECYCLE, Inlet, convect_planes, convect_planes_y,
                         driver_window_planes, init_xplanes, init_yplanes,
                         load_driver_inlet, recycle_planes, uouttot_value,
                         vouttot_value, ycut_series)
from .ops.poisson import PoissonSolver
from .ops.thermo import ThermoDiag, avexy_masked, thermodynamics
from .ibm.bottom import bottom_tendencies
from .ibm.eb import FacetEB
from .parallel.mesh import shard_state
from .physics import (HeatPumps, Purifiers, ScalarSources, Vegetation,
                      chem_update)
from .timedep import Timedep


def _unsupported(cfg: Config, ibm=None):
    """Names of the configured features this port does not implement."""
    checks = {
        "an IBM case (libm, nfcts > 0) without its IBM": (
            ibm is None and cfg.run.libm and cfg.walls.nfcts > 0),
    }
    return [name for name, on in checks.items() if on]


def _split_unsupported(cfg: Config):
    """Names of the configured features whose x/y split is not ported.  The
    split covers every path of the Model (flat, IBM, energy balance,
    scalars, the long-tail physics, open boundaries, the inlet generator and
    the driver), so the list is empty; it names whatever a later feature
    leaves unsplit."""
    checks = {}
    return [name for name, on in checks.items() if on]


def inlet_planes(inlet, igparams, grid: Grid, state: State, f: Fields, ig):
    """The x-inlet planes on `grid` at `state.timee`: from the generator
    state `ig`, recycled from the fields `f`, interpolated in the rolling
    driver window, or from the `inlet`'s own profiles or series.  A Model
    passes its block grid; ``sim.Simulation`` of a split Model the domain's
    grid, the gathered State and the whole series."""
    ny, nz = grid.jtot, grid.ktot
    if igparams is not None:
        return inletgen_planes(ig, inlet, ny, nz)
    if inlet.mode == BC_RECYCLE:
        return recycle_planes(inlet, f, ny, nz, grid=grid)
    if state.drv is not None:
        # streaming replay: lerp from the rolling device window
        # (lchunkread, moddriver.f90:933; io/driverstream.py)
        return driver_window_planes(state.drv, state.timee)
    return inlet.planes(state.timee, ny, nz)


class Model:
    """Static configuration and precomputed operators for one case (the
    reference's init* routines, program.f90:63-124); everything mutable
    lives in `State`.  `ibm` is the case's ``ibm.IBM`` on the same device,
    or None.  `device` is the card unless the caller asks for "cpu"; with
    no card the constructor raises.  The static profiles are zero until set
    (`load_case` reads them; see also ``convert.load_profiles``).  With a
    `mesh` (``parallel.mesh.Mesh``) the Model steps this rank's block of the
    whole-domain `grid` (``domain_grid``), held in ``grid``; its `ibm` is
    then the block's (``IBM.load(..., mesh=mesh)``).

    ``field_substeps`` counts the scalar fields a substep advects and
    diffuses (nsv each substep; the trace's ``scalars.field_substeps``) and
    ``chem_updates`` the chemistry's updates (one a step with ``lchem``;
    ``chem.updates``)."""

    field_substeps = trace.counter("scalars.field_substeps")
    chem_updates = trace.counter("chem.updates")

    def __init__(self, cfg: Config, grid: Grid, ibm=None, device="cuda",
                 mesh=None):
        missing = _unsupported(cfg, ibm)
        if missing:
            raise NotImplementedError(
                "not ported to udales_tpu_torch yet: " + ", ".join(missing))
        if mesh is not None:
            missing = _split_unsupported(cfg)
            if missing:
                raise NotImplementedError(
                    "the x/y split is not ported to udales_tpu_torch yet "
                    "for " + ", ".join(missing))
        if ibm is not None and getattr(ibm, "mesh", None) is not mesh:
            raise ValueError("the IBM and the Model must be on one mesh: "
                             "build it with IBM.load(..., mesh=mesh)")
        self.cfg = cfg
        self.mesh = mesh
        self.domain_grid = grid
        grid = grid.block(mesh) if mesh is not None else grid
        self.grid = grid
        self.ibm = ibm
        self.device = torch.device(device)
        self.inputs = None   # io.inputs.CaseInputs once load_case reads one
        self.eb = None       # ibm.eb.FacetEB for energy-balance runs
        self.timedep = None  # timedep.Timedep
        self.inlet = None    # ops.openbc.Inlet for open-x runs
        self.inlet_y = None  # ops.openbc.Inlet for open-y runs (profile only)
        self.igparams = None  # ops.inletgen.InletGenParams (iinletgen=1)
        self.driver_stream = None  # io.driverstream.DriverStream (lchunkread)
        self.vegetation = None   # physics.Vegetation
        self.heatpumps = None    # physics.HeatPumps
        self.scalsources = None  # physics.ScalarSources
        self.purifiers = None    # physics.Purifiers
        self.has_lstend = False    # lscale.inp holds subsidence or dqtdt
        # tau_x/y/z + thl_flux diagnostics only when fielddump asks for them
        codes = {c.strip() for c in cfg.output.fieldvars.split(",")}
        self.need_taudiag = bool(cfg.output.lfielddump
                                 and codes & {"tx", "ty", "tz", "hf"})
        self._nudge_prof = None
        self._step_jit = None    # graph.CompiledStep, built by step_jit()
        # held in the registry from here, so that a capture finds them
        self.field_substeps = 0
        self.chem_updates = 0
        self.pois = PoissonSolver(grid, cfg, device=self.device, mesh=mesh)
        nz = grid.ktot
        kw = dict(dtype=grid.torch_dtype, device=self.device)
        self.dpdxl = torch.zeros(nz, **kw)
        self.dpdyl = torch.zeros(nz, **kw)
        self.ug = torch.zeros(nz, **kw)
        self.vg = torch.zeros(nz, **kw)
        self.thlpcar = torch.zeros(nz, **kw)
        self.whls = torch.zeros(nz + 1, **kw)
        self.dqtdtls = torch.zeros(nz, **kw)
        # the static profiles of the sponge layer and the shifted periodic
        # boundaries, on the device from the start: a host-to-device copy
        # inside the step would not be capturable
        self.sponge = (sponge_profile(grid, cfg, self.device)
                       if cfg.physics.igrw_damp != 0 else None)
        self.shift = (shift_profile(grid, cfg.physics.ds, self.device)
                      if cfg.physics.ds > 0 else None)

    # -- initial condition -------------------------------------------------
    def cold_start(self, seed: int = 43, dt0: float | None = None) -> State:
        """Profile initialization and randomization
        (modstartup.readinitfiles:943; udales_tpu run.py:99-131).  The noise
        comes from a torch.Generator seeded with `seed` on the model's
        device, so it is not jax.random's: parity tests start both packages
        from one converted State.  Solid cells keep the profile values, as
        in the reference; ibmnorm and the projection zero them within the
        first substep.  Under a split the whole-domain start is made and
        this rank keeps its block of it, so every rank starts as one device
        would."""
        cfg, grid = self.cfg, self.domain_grid
        nz = grid.ktot
        if self.inputs is not None:
            # the scalars start from scalar.inp; without that file a case
            # carries no scalar, as in the reference (run.py:105-109)
            p = self.inputs.prof
            f = profile_fields(grid, p["u"], p["v"], p["thl"], p["qt"],
                               np.maximum(p["e12"], const.e12min),
                               self.inputs.scalar, device=self.device)
        else:
            f = profile_fields(grid, np.zeros(nz), np.zeros(nz),
                               np.full(nz, 288.0), np.zeros(nz),
                               np.full(nz, const.e12min),
                               np.zeros((cfg.scalars.nsv, nz)),
                               device=self.device)
        if cfg.run.lrandomize:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            f = randomize(f, gen, cfg.run.randu, min(cfg.run.krand, nz))
        dt0 = dt0 if dt0 is not None else min(cfg.run.dtmax, 0.1)
        if self.inlet is not None:
            f = replace(f, bx=init_xplanes(f, grid))
        if self.inlet_y is not None:
            f = replace(f, by=init_yplanes(f, grid))
        fac = self.eb.initial_state() if self.eb is not None else None
        st = initial_state(grid, f, dt0=dt0, fac=fac)
        if self.igparams is not None:
            st = st.replace(ig=init_inletgen(cfg, grid, f, self.igparams))
        if self.need_taudiag:
            kw = dict(dtype=grid.torch_dtype, device=self.device)
            z3 = lambda: torch.zeros(grid.shape, **kw)
            st = st.replace(taud=dict(
                x=z3(), y=z3(), z=torch.zeros((*grid.shape[:2], nz + 1), **kw),
                hf=z3()))
        if cfg.walls.lwritefac and self.ibm is not None:
            st = st.replace(facstats=zero_facstats(
                self.ibm.nfcts, grid.torch_dtype, self.device))
        if cfg.physics.ifixuinf == 2:
            z = torch.zeros((), dtype=grid.torch_dtype, device=self.device)
            uref = cfg.bc.Vinf if cfg.physics.lvinf else cfg.bc.Uinf
            st = st.replace(ctl=Ctl(freestreamav=z + uref, dgdt=z,
                                    dpdx_shift=z))
        if self.mesh is not None:
            st = shard_state(st, self.mesh)
        return st

    # -- inlet planes of the open-x boundary ---------------------------------
    def _inlet_planes(self, state: State, f: Fields, ig):
        return inlet_planes(self.inlet, self.igparams, self.grid, state, f,
                            ig)

    # -- one RK3 substep ---------------------------------------------------
    def substep(self, state: State, rk3step: int, th: ThermoDiag | None = None,
                closure_out=None) -> State:
        """One substep.  `th`/`closure_out` hand down the diagnostics `step`
        already computed on `m` for the adaptive dt; valid only for
        rk3step == 1, where c == m.  In the run's trace it is the span
        ``rk<rk3step>`` of the leaves thermo, openbc, closure, ghosts,
        advection (with the pressure-gradient terms and the shifted periodic
        boundaries), scalars, diffusion, forces, wallfun, ibmnorm (with the
        free-stream controllers and the volume-flow correction before it),
        canopy, poisson, integrate (purifiers, the RK3 update, the inlet and
        outlet planes) and chem.  Three are opened only where they hold
        work, so that a case without it keeps the leaves and graph nodes it
        had: scalars (the kappa advection and diffusion of the scalars)
        where there are scalars; canopy (their solid fill, the trees, the
        heat pumps, the scalar sources and the ``dw`` floor, which are
        otherwise ibmnorm's) where there are scalars or trees; chem
        (``chem_update``) on the third substep with ``lchem``."""
        with trace.span(f"rk{rk3step}"):
            return self._substep(state, rk3step, th, closure_out)

    def _substep(self, state: State, rk3step: int, th, closure_out) -> State:
        trace.leaf("thermo")
        cfg, grid = self.cfg, self.grid
        nx, ny, nz = grid.shape
        c, m = state.c, state.m
        rk3coef = state.dt / (4.0 - rk3step)
        ltemp = cfg.physics.ltempeq
        lmoist = cfg.physics.lmoist
        oneeqn = cfg.subgrid.model == SGS_ONEEQN
        nsv = c.sv.shape[0]
        ibm = self.ibm

        if th is None:
            th = thermodynamics(c, cfg, grid,
                                ibm.masks if ibm is not None else None)

        # --- open-x inlet/outlet context (modboundary.f90:688-996) ---------
        trace.leaf("openbc")
        openx = uouttot = inlet_planes = None
        ig = state.ig
        if self.inlet is not None:
            if self.igparams is not None:
                # the Lund-1998 rescale-recycle generator (modinlet.f90
                # inletgen, called per substep as in the legacy time loop)
                ig = inletgen_update(ig, c, cfg, grid, state.dt, rk3step,
                                     self.igparams)
            inlet_planes = self._inlet_planes(state, c, ig)
            openx = {"inlet": inlet_planes, "bx": c.bx}
            uouttot = uouttot_value(cfg, th.u0av, grid)

        # --- open-y inlet/outlet context (ymi_profile/ymo_convective) ------
        openy = vouttot = inlet_y = None
        if self.inlet_y is not None:
            inlet_y = self.inlet_y.planes(state.timee, nx, nz)
            openy = {"inlet": inlet_y, "by": c.by}
            vouttot = vouttot_value(cfg, th.v0av, grid)

        # --- SGS closure (modsubgrid.closure) ------------------------------
        trace.leaf("closure")
        thvs = cfg.bc.thls if cfg.bc.thls > 0 else 288.0
        if closure_out is None:
            gvel = _velocity_ghosts(c, cfg, grid, openx, openy)
            ekm, ekh, zlt = fused_vreman.closure(
                gvel, grid, cfg, e12=c.e12, dthvdz=th.dthvdz, thl=c.thl,
                thvs=thvs)
        else:
            ekm, ekh, zlt = closure_out

        trace.leaf("ghosts")
        g = make_ghosts(c, ekm, ekh, cfg, grid, openx=openx, openy=openy)

        # --- advection (+ pressure-gradient term, modadvection) ------------
        trace.leaf("advection")
        # cd2 momentum, the pressure-gradient terms and cd2 thl in one
        # pass: the hand-written kernel on CUDA
        gp = _pad_pres(state.pres, openx, openy, grid.mesh)
        kappa_thl = ltemp and cfg.iadv_thl == IADV_KAPPA
        du, dv, dw, dthl = fused_adv_mom(g, gp, grid,
                                         thl=ltemp and not kappa_thl)
        if kappa_thl:
            dthl = adv.adv_kappa(_kappa_ghost_scalar(c.thl, cfg, openx,
                                                     openy, grid.mesh),
                                 g, grid)
        dqt = adv.adv_c2(g.qt, g, grid) if lmoist else None
        de12 = adv.adv_c2(g.e12, g, grid) if oneeqn else None

        # --- shifted periodic BCs (modforces.f90:953, after advection) -----
        if cfg.physics.ds > 0:
            su, sv, sw = shifted_pbcs(c, grid, cfg, rk3coef, th.u0av,
                                      cfg.physics.ds, vsx=self.shift)
            du, dv, dw = du + su, dv + sv, dw + sw

        # the IBM diffusion corrections (diffu_corr..diffc_corr) are folded
        # into the sweeps as {0,1} flux masks, as in udales_tpu
        pmasks = Mc = None
        if ibm is not None:
            pmasks = dict(u=ibm.pmask_u, v=ibm.pmask_v, w=ibm.pmask_w)
            Mc = ibm.pmask_c

        # --- the scalar stack: kappa advection and subgrid diffusion of
        # every scalar at once (g.sv is (nsv, ...) in the kappa layout) -----
        dsv = c.sv
        if nsv > 0:
            trace.leaf("scalars")
            self.field_substeps += nsv
            dsv = fused_scalars(g, grid, Mc)

        # --- subgrid diffusion: the hand-written kernel on CUDA ------------
        trace.leaf("diffusion")
        xu, xv, xw = fused_diff_mom(g, grid, pmasks=pmasks)
        du, dv, dw = du + xu, dv + xv, dw + xw
        if ltemp:
            dthl = dthl + sgs.diff_c(g.thl, g.ekh, grid, M=Mc)
        if lmoist:
            dqt = dqt + sgs.diff_c(g.qt, g.ekh, grid, M=Mc)
        if oneeqn:
            de12 = de12 + sgs.diff_e(g, grid)
            de12 = de12 + sgs.tke_sources(g, grid, cfg, c.e12, ekm, ekh,
                                          th.dthvdz, zlt, thvs)

        # --- floor wall functions (modibm.bottom; the scalars' floor flux
        # is zero) ----------------------------------------------------------
        trace.leaf("forces")
        bu, bv, bthl, bqt, _ = bottom_tendencies(g, cfg, grid)
        du, dv = du + bu, dv + bv
        if ltemp:
            dthl = dthl + bthl
        if lmoist:
            dqt = dqt + bqt

        # --- coriolis / forces ---------------------------------------------
        cu, cv, cw = coriolis(g, grid, cfg, self.ug, self.vg)
        du, dv, dw = du + cu, dv + cv, dw + cw
        dpdxl = self.dpdxl
        if cfg.physics.ifixuinf == 2 and state.ctl is not None:
            dpdxl = dpdxl + state.ctl.dpdx_shift
        fu, fv, fw = forces(g, grid, cfg, dpdxl, self.dpdyl,
                            th.thv0h, th.thvh)
        du, dv, dw = du + fu, dv + fv, dw + fw

        # --- large-scale subsidence/advection (modforces.lstend) -----------
        if self.has_lstend:
            IIc = ibm.masks.c if ibm is not None else None
            sv0av = (torch.stack([avexy_masked(c.sv[n], IIc, mesh=grid.mesh)
                                  for n in range(nsv)])
                     if nsv else c.sv.new_zeros((0, nz)))
            sv0av = torch.where(sv0av < -900.0, 0.0, sv0av)
            lu, lv, lthl, lqt, lsv = lstend(
                c, grid, cfg, self.whls, th.u0av, th.v0av, th.thl0av,
                th.qt0av, sv0av, self.dqtdtls)
            du = du + lu[None, None, :]
            dv = dv + lv[None, None, :]
            if ltemp:
                dthl = dthl + lthl[None, None, :]
            if lmoist:
                dqt = dqt + lqt[None, None, :]
            if nsv:
                dsv = dsv + lsv[:, None, None, :]
        if ltemp:
            dthl = dthl + self.thlpcar[None, None, :]
        if cfg.physics.igrw_damp != 0:
            gu, gv, gw, gthl, gqt = grwdamp(
                c, grid, cfg, th.u0av, th.v0av, th.thl0av, th.qt0av,
                self.ug, self.vg, tsc=self.sponge)
            du, dv, dw = du + gu, dv + gv, dw + gw
            if ltemp:
                dthl = dthl + gthl
            if lmoist:
                dqt = dqt + gqt

        # --- nudging to (possibly time-dependent) profiles -----------------
        if cfg.physics.lnudge and cfg.physics.nnudge > 0:
            nprofs = None
            if self.timedep is not None:
                nprofs = self.timedep.nudge_profiles(state.timee)
            if nprofs is None:
                nprofs = self._static_nudge_profiles()
            if nprofs is not None:
                nu, nv, nthl, nqt = nudge_top(
                    c, grid, cfg, nprofs["u"], nprofs["v"], nprofs["thl"],
                    nprofs["qt"], u0av=th.u0av, v0av=th.v0av,
                    thl0av=th.thl0av, qt0av=th.qt0av)
                du, dv = du + nu, dv + nv
                if ltemp:
                    dthl = dthl + nthl
                if lmoist:
                    dqt = dqt + nqt

        # --- IBM wall functions (modibm.ibmwallfun) ------------------------
        trace.leaf("wallfun")
        fac, facstats = state.fac, state.facstats
        taud = state.taud
        need_tau = self.need_taudiag and rk3step == 3
        if ibm is not None:
            pre = (du, dv, dw, dthl)
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
            if need_tau:
                # tau_* / thl_flux diagnostics: the bottom + ibmwallfun
                # tendency increments of this substep (modibm.f90:1185,
                # 2014-2093; dumped by fielddump tx/ty/tz/hf)
                dhf = bthl if dthl is None else (
                    dthl + bthl if pre[3] is None else dthl - pre[3] + bthl)
                taud = dict(x=(du - pre[0]) + bu, y=(dv - pre[1]) + bv,
                            z=dw - pre[2], hf=dhf)
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
        elif need_tau:
            taud = dict(x=bu, y=bv, z=torch.zeros_like(dw), hf=bthl)

        # --- free-stream controllers (modforces.fixuinf1/2) ----------------
        trace.leaf("ibmnorm")
        ctl = state.ctl
        if cfg.physics.ifixuinf == 1 and rk3step == 3:
            cu1, cv1 = fixuinf1(c, grid, cfg, state.dt, th.u0av, th.v0av)
            du = du + cu1
            dv = dv + cv1
        if cfg.physics.ifixuinf == 2 and ctl is not None:
            ctl = replace(ctl,
                          dpdx_shift=ctl.dpdx_shift + ctl.dgdt * rk3coef)
            if rk3step == 3:
                freestream = th.v0av[-1] if cfg.physics.lvinf else th.u0av[-1]
                inletav = max(cfg.physics.inletav, 1e-9)
                fav = (freestream * state.dt / inletav
                       + (1.0 - state.dt / inletav) * ctl.freestreamav)
                tscale = cfg.physics.tscale if cfg.physics.tscale > 0 else 1.0
                uref = cfg.bc.Vinf if cfg.physics.lvinf else cfg.bc.Uinf
                ctl = replace(ctl, freestreamav=fav,
                              dgdt=(1.0 / tscale) * (fav - uref))

        # --- mass-flow-rate correction (modforces.masscorr; skipped for
        # inflow/outflow runs, :352/:394) -----------------------------------
        IIu = IIv = None
        if ibm is not None:
            IIu, IIv = ibm.masks.u, ibm.masks.v
        if cfg.physics.luvolflowr and openx is None:
            du = masscorr_uvol(du, m.u, grid, cfg, rk3coef, IIu)
        if cfg.physics.lvvolflowr and openx is None and openy is None:
            dv = masscorr_vvol(dv, m.v, grid, cfg, rk3coef, IIv)

        # --- IBM: zero solid velocities, fill solid thl and qt (ibmnorm) ---
        if ibm is not None:
            dzf = grid.t("dzf", self.device)
            thl_vmean = torch.sum(th.thl0av * dzf) / float(grid.zh[-1])
            du, dv, dw, dthl, dqt, _, m = fused_ibmnorm.ibmnorm(
                ibm, c, m, du, dv, dw, dthl, thl_vmean, dqt)

        # --- the canopy: the scalars' solid fill (ibmnorm's, before the
        # trees read m), the trees, the heat pumps, the sources --------------
        veg = self.vegetation
        trees = veg is not None and veg.has_canopy
        if nsv > 0 or trees:
            trace.leaf("canopy")
        if ibm is not None:
            m, dsv = ibm.fill_scalars(m, dsv)

        # --- vegetation canopy forcing (vegetation.f90:351) ----------------
        if trees:
            du, dv, dw, dthl, dqt, dsv = veg.forcing(m, grid, cfg, du, dv, dw,
                                                     dthl, dqt, dsv)

        # --- heat pumps (heatpump.f90:60) ----------------------------------
        if self.heatpumps is not None and ltemp:
            m, c, dw, dthl = self.heatpumps.apply(m, c, dw, dthl)

        # --- scalar sources (modscalsource.f90:385) ------------------------
        if self.scalsources is not None and nsv > 0:
            dsv = dsv + self.scalsources.field

        # --- forces hard-zeroes wp at the floor (modforces.f90:125) --------
        dw[..., 0] = 0.0

        # --- pressure projection (modpois.poisson) -------------------------
        trace.leaf("poisson")
        du, dv, dw, p, du_out, dv_out = self._project(
            du, dv, dw, m, rk3coef, state.pres, c=c, openx=openx,
            uouttot=uouttot, openy=openy, vouttot=vouttot)
        pres = state.pres + p

        # --- purifiers (modpurifiers.f90, between poisson and integrate):
        # they set m and c velocities after the projection, so div u is not
        # zero in and around their boxes by design ---------------------------
        trace.leaf("integrate")
        if self.purifiers is not None:
            m, c, du, dv, dw, dsv = self.purifiers.apply(m, c, du, dv, dw,
                                                         dsv)

        # --- integrate (modtstep.tstep_integrate) --------------------------
        w_new = m.w + rk3coef * dw
        w_new[..., 0] = 0.0
        c_new = Fields(
            u=m.u + rk3coef * du,
            v=m.v + rk3coef * dv,
            w=w_new,
            thl=m.thl + rk3coef * dthl if ltemp else m.thl,
            qt=m.qt + rk3coef * dqt if lmoist else m.qt,
            e12=torch.clamp(m.e12 + rk3coef * de12 if oneeqn else m.e12,
                            min=const.e12min),
            sv=m.sv + rk3coef * dsv if nsv > 0 else m.sv,
            bx=c.bx,
            by=c.by,
        )
        # u, v, w (and thl, qt when integrated) of c_new are fresh tensors,
        # so the inlet pins below write in place
        # (on a split, the ranks at the domain's inlet edge pin, those at
        # its outlet edge advance the planes for their row or column)
        m_new = m
        if openy is not None:
            # pin the inlet plane (ymi_profile) and advance the prognostic
            # outlet planes (ymo_* convective)
            if grid.edge_ylo:
                c_new.v[:, 0] = inlet_y["v"]
                if ltemp and cfg.bc.BCyT == BC_PROFILE:
                    c_new.thl[:, 0] = inlet_y["thl"]
            byc = replace(c.by, v=m.by.v + rk3coef * dv_out)
            byc = convect_planes_y(byc, c_new, grid, rk3coef, vouttot,
                                   inlet_y)
            bym = convect_planes_y(m.by, m, grid, rk3coef, vouttot, inlet_y)
            byc, bym = _outlet_planes(grid, "y", byc, bym)
            c_new = replace(c_new, by=byc)
            m_new = replace(m_new, by=bym)
        if openx is not None:
            # enforce the inlet plane (xmi_*, modboundary.f90:697/730) and
            # advance the prognostic outlet planes (xmo_* convective)
            if grid.edge_xlo:
                c_new.u[0] = inlet_planes["u"]
                if ltemp and cfg.bc.BCxT == BC_PROFILE:
                    # xTi_profile also pins the first internal cell
                    # (modboundary.f90:786-791)
                    c_new.thl[0] = inlet_planes["thl"]
            bxc = replace(c.bx, u=m.bx.u + rk3coef * du_out)
            bxc = convect_planes(bxc, c_new, grid, rk3coef, uouttot,
                                 inlet_planes)
            bxm = convect_planes(m.bx, m, grid, rk3coef, uouttot,
                                 inlet_planes)
            bxc, bxm = _outlet_planes(grid, "x", bxc, bxm)
            c_new = replace(c_new, bx=bxc)
            m_new = replace(m_new, bx=bxm)
        if oneeqn:
            m_new = replace(m_new, e12=torch.clamp(m.e12, min=const.e12min))
        # chemistry once per full step on the updated scalars
        # (modtstep.f90:236-238, modchem.f90); the fluid mask of an IBM case
        if cfg.chem.lchem and rk3step == 3 and nsv >= 3:
            trace.leaf("chem")
            self.chem_updates += 1
            c_new = replace(c_new, sv=chem_update(
                c_new.sv, state.dt, cfg,
                ibm.masks.c if ibm is not None else 1.0))
        if rk3step == 3:
            m_new = c_new
        return state.replace(c=c_new, m=m_new, pres=pres, fac=fac,
                             facstats=facstats, ctl=ctl, ig=ig, taud=taud)

    def _static_nudge_profiles(self):
        """prof.inp's u, v, thl, qt as the nudging targets (None without
        case inputs), on the model's device."""
        if self._nudge_prof is None and self.inputs is not None:
            p = self.inputs.prof
            self._nudge_prof = {k: torch.as_tensor(
                np.asarray(p[k]), dtype=self.grid.torch_dtype,
                device=self.device) for k in ("u", "v", "thl", "qt")}
        return self._nudge_prof

    def _project(self, du, dv, dw, m: Fields, rk3coef, pres, c=None,
                 openx=None, uouttot=None, openy=None, vouttot=None):
        """fillps + bcpup + poisson + tderive (modpois.f90:911-998, 419-712,
        1001-1105; modboundary.f90:1191-1341): periodic or open x/y with an
        impermeable bottom and an impermeable or pressure (``BCtopm``) top.
        `pres` is the accumulated pressure.  Returns the projected
        tendencies, the pressure correction, and the outlet-face u/v
        tendencies (None for periodic directions)."""
        grid, cfg = self.grid, self.cfg
        nz = grid.ktot
        rk3coefi = 1.0 / rk3coef
        lptop = cfg.bc.BCtopm == BCTOPM_PRESSURE
        IIc = self.ibm.masks.c if self.ibm is not None else None
        dzhi_top = 1.0 / float(grid.dzh[-1])

        def top_gradient(p):
            """2 <p>_ke dzhi(ke+1), the slab mean over the fluid cells."""
            pij = avexy_masked(p, IIc, mesh=grid.mesh)
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
        du_out = dv_out = None
        # x face divergence term
        if openx is None:
            gpu = pad_periodic_xy(pup, 1, grid.mesh)
            ddx = (gpu[2:, 1:-1, :] - gpu[1:-1, 1:-1, :]) * grid.dxi
        else:
            # bcpup open-x (modboundary.f90:1247-1305): inlet face fixed to
            # the inlet plane; outlet face convective.  pup is this
            # function's own tensor; du is the caller's and is copied
            du = du.clone()
            if grid.edge_xlo:
                du[0] = 0.0
                pup[0] = openx["inlet"]["u"] * rk3coefi
            u_out = openx["bx"].u          # current outlet u (u0(ie+1))
            u_out_m = m.bx.u
            pup_out = (u_out_m * rk3coefi
                       - (u_out - c.u[-1]) * grid.dxi * uouttot)
            du_out = pup_out - u_out_m * rk3coefi
            pup_faces = torch.cat([pup, _next_face(pup, pup_out, grid, "x")],
                                  dim=0)
            ddx = (pup_faces[1:] - pup_faces[:-1]) * grid.dxi
        # y face divergence term
        if openy is None:
            gpv = pad_periodic_xy(pvp, 1, grid.mesh)
            ddy = (gpv[1:-1, 2:, :] - gpv[1:-1, 1:-1, :]) * grid.dyi
        else:
            # bcpup open-y: inlet v face fixed; outlet v face convective
            dv = dv.clone()
            if grid.edge_ylo:
                dv[:, 0] = 0.0
                pvp[:, 0] = openy["inlet"]["v"] * rk3coefi
            v_out = openy["by"].v
            v_out_m = m.by.v
            pvp_out = (v_out_m * rk3coefi
                       - (v_out - c.v[:, -1]) * grid.dyi * vouttot)
            dv_out = pvp_out - v_out_m * rk3coefi
            pvp_faces = torch.cat([pvp, _next_face(pvp, pvp_out, grid, "y")],
                                  dim=1)
            ddy = (pvp_faces[:, 1:] - pvp_faces[:, :-1]) * grid.dyi
        rhs = (ddx + ddy
               + (pwp[:, :, 1:] - pwp[:, :, :-1]) * dzfi[None, None, :])
        p = self.pois.solve(rhs)
        # tderive: subtract grad p from the tendencies (Neumann ghosts at
        # open boundaries leave the inlet face untouched, modpois:1046-1056)
        gp = _pad_pres(p, openx, openy, grid.mesh)
        du = du - (gp[1:-1, 1:-1, :] - gp[:-2, 1:-1, :]) * grid.dxi
        dv = dv - (gp[1:-1, 1:-1, :] - gp[1:-1, :-2, :]) * grid.dyi
        dzhi = grid.t("dzhi", self.device)
        dw[..., 1:nz] += -(p[:, :, 1:] - p[:, :, :-1]) \
            * dzhi[1:nz][None, None, :]
        if lptop:
            # wp(ke+1) += 2 <p>_ke dzhi(ke+1) (modpois.f90:1058-1069)
            dw[..., nz] += top_gradient(p)
        return du, dv, dw, p, du_out, dv_out

    # -- dt control (modtstep.tstep_update:49-154) --------------------------
    def new_dt(self, state: State, ekm=None, ekh=None):
        """The adaptive dt; under a split each max is the domain's (a MAX
        all-reduce)."""
        cfg, grid = self.cfg, self.grid
        if not cfg.run.ladaptive:
            return torch.full((), cfg.run.dtmax, dtype=state.dt.dtype,
                              device=state.dt.device)
        m = state.m
        nz = grid.ktot
        dzh = grid.t("dzh", self.device)
        mesh = self.mesh
        gmax = (torch.max if mesh is None
                else lambda t: mesh.allreduce_max(torch.max(t)))
        courtot_per_dt = gmax(
            torch.abs(m.u) * grid.dxi + torch.abs(m.v) * grid.dyi
            + torch.abs(m.w[..., :nz]) / dzh[:nz][None, None, :])
        new = cfg.courant / torch.clamp(courtot_per_dt, min=1e-12)
        if ekm is not None:
            dzh2i = grid.t("dzh2i", self.device)
            coef = dzh2i[:nz][None, None, :] + grid.dx2i + grid.dy2i
            diff_per_dt = torch.maximum(gmax(ekm * coef), gmax(ekh * coef))
            new = torch.minimum(new, cfg.run.diffnr
                                / torch.clamp(diff_per_dt, min=1e-12))
        return torch.clamp(new, max=cfg.run.dtmax).to(state.dt.dtype)

    # -- full step -----------------------------------------------------------
    def step(self, state: State) -> State:
        """One full RK3 timestep (3 substeps) + dt/time bookkeeping.  In the
        run's trace it is a device step (``model.step``): the leaves ghosts,
        thermo, closure and new_dt of the span ``entry``, those of each
        `substep`, and eb, the facet energy balance."""
        with trace.device_step("model.step", self.device):
            cfg, grid = self.cfg, self.grid
            with trace.span("entry"):
                # the closure for the dt limit sees the inlet planes at the
                # old time
                trace.leaf("ghosts")
                openx0 = openy0 = None
                if self.inlet is not None:
                    openx0 = {"inlet": self._inlet_planes(state, state.m,
                                                          state.ig),
                              "bx": state.m.bx}
                if self.inlet_y is not None:
                    openy0 = {"inlet": self.inlet_y.planes(
                        state.timee, grid.itot, grid.ktot), "by": state.m.by}
                gvel = _velocity_ghosts(state.m, cfg, grid, openx0, openy0)
                trace.leaf("thermo")
                th = thermodynamics(state.m, cfg, grid, self.ibm.masks
                                    if self.ibm is not None else None)
                trace.leaf("closure")
                thvs = cfg.bc.thls if cfg.bc.thls > 0 else 288.0
                closure_out = fused_vreman.closure(
                    gvel, grid, cfg, e12=state.m.e12, dthvdz=th.dthvdz,
                    thl=state.m.thl, thvs=thvs)
                trace.leaf("new_dt")
                dt = self.new_dt(state, closure_out[0], closure_out[1])
                state = state.replace(dt=dt, timee=state.timee + dt)
            # c == m at step entry, so substep 1 reuses the diagnostics
            # computed for the adaptive dt.  With open boundaries the
            # velocity ghosts are time-interpolated inlet planes and timee
            # just advanced, so the closure is recomputed there (th has no
            # ghosts and stays exact).
            closed = openx0 is None and openy0 is None
            state = self.substep(state, 1, th=th,
                                 closure_out=closure_out if closed else None)
            for rk3step in (2, 3):
                state = self.substep(state, rk3step)
            # the facet energy balance fires every dtEB (quantized),
            # modEB.f90:429; gated on the device, see FacetEB.maybe_update
            trace.leaf("eb")
            if self.eb is not None and state.fac is not None:
                skyLW = netsw = None
                if self.timedep is not None:
                    skyLW = self.timedep.sky_lw(state.timee)
                    netsw = self.timedep.net_sw(state.timee)
                state = state.replace(fac=self.eb.maybe_update(
                    state.fac, state.timee, skyLW=skyLW, netsw=netsw))
            return state

    def step_jit(self):
        """The compiled step (``graph.CompiledStep``): `step` as one CUDA
        graph replayed a call on the card, the same body eagerly on the
        CPU; built once per Model and cached, as udales_tpu's
        ``jax.jit(self.step)``.  On a Model split over a capturable mesh
        (NCCL; gloo on the CPU) the graph holds this rank's block step
        with its collectives, and every rank builds at the same call; the
        driver window's refill (``DriverStream.ensure``, a host wait) is
        not in it.  A host-staged mesh raises NotImplementedError: its
        exchanges wait on the host."""
        if self._step_jit is None:
            self._step_jit = CompiledStep(self)
        return self._step_jit

    def run(self, state: State, nsteps: int, graph: bool = False) -> State:
        """`nsteps` full steps; a streaming driver replay refills its
        window between them, outside the step (and outside the graph).
        With `graph` the steps are replays of `step_jit()` (udales_tpu's
        on-device ``lax.scan``), on one process or on every rank of a
        capturable mesh, and the State returned is a copy of the compiled
        step's static State, the caller's to keep; eagerly (the default)
        each step is `step`.  The loop is the trace's span ``model.run``."""
        step = self.step_jit() if graph else self.step
        with trace.span("model.run"):
            for _ in range(nsteps):
                if self.driver_stream is not None:
                    state = self.driver_stream.ensure(state)
                state = step(state)
        if graph and nsteps > 0:
            state = state.map(torch.clone)
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
              device="cuda", mesh=None) -> Model:
    """Build a Model from a case directory (namoptions and inputs), as
    udales_tpu ``load_case`` (run.py:772-901) does: grid from prof.inp,
    profiles from prof.inp and lscale.inp (and scalar.inp), the IBM when
    ``libm`` and ``nfcts > 0``, with ``lEB`` its facet energy balance, the
    time-dependent series whose switches are on and whose files exist, the
    scalar sources, vegetation, purifiers and heat pumps whose switches are
    on and whose files exist, and the open-boundary inlet.  With a `mesh`
    (``parallel.mesh.Mesh``) the Model of this rank's block: each of those
    is built on the domain grid and cut to the block."""
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
    ibm = None
    if cfg.run.libm and cfg.walls.nfcts > 0:
        from .ibm.ibm import IBM
        ibm = IBM.load(case_dir, expnr, cfg, grid, device=device, mesh=mesh)
    model = Model(cfg, grid, ibm, device=device, mesh=mesh)
    blk = model.grid
    cut = (lambda part: part) if mesh is None else (
        lambda part: part.block(blk))
    load_profiles(model, _case_profiles(inputs, cfg, grid))
    model.inputs = inputs
    model.has_lstend = bool(np.any(inputs.lscale["wfls"] != 0)
                            or np.any(inputs.lscale["dqtdt"] != 0))
    if cfg.eb.lEB and ibm is not None:
        model.eb = FacetEB.load(case_dir, expnr, cfg, ibm, device=device)
    model.timedep = Timedep.load(case_dir, expnr, cfg, dom.ktot,
                                 dtype=grid.torch_dtype, device=device)
    # the long-tail physics (udales_tpu run.py:800-810)
    if cfg.scalars.nsv > 0 and (cfg.scalars.lscasrc or cfg.scalars.lscasrcl):
        model.scalsources = cut(ScalarSources.load(case_dir, expnr, cfg,
                                                   grid, device=device))
    if cfg.trees.ltrees and (case_dir / f"veg.inp.{expnr}").exists():
        model.vegetation = cut(Vegetation.load(case_dir, expnr, cfg, grid,
                                               device=device))
    if cfg.purifs.lpurif and (case_dir / f"purifs.inp.{expnr}").exists():
        model.purifiers = cut(Purifiers.load(case_dir, expnr, cfg, grid))
    if (cfg.heatpump.lheatpump
            and (case_dir / f"heatpump.inp.{expnr}").exists()):
        model.heatpumps = cut(HeatPumps.load(case_dir, expnr, cfg, grid,
                                             device=device))
    _load_inlet(model, case_dir, inputs)
    return model


def _load_inlet(model: Model, case_dir: Path, inputs) -> None:
    """The open-boundary inlet of a case (udales_tpu ``load_case``,
    run.py:811-900): profile inlets in x and/or y, a driver inlet (rolling
    window over the reference's ``?driver_*`` files with ``lchunkread``, an
    h5 series, or the whole of the Fortran files), the rescale-recycle
    generator (iinletgen=1) or the replay of its recorded planes
    (iinletgen=2)."""
    cfg, grid, dom = model.cfg, model.grid, model.cfg.domain
    kw = dict(dtype=grid.torch_dtype, device=model.device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), **kw)
    # a split Model's series are its y block of the domain's records
    rows = (None if model.mesh is None
            else slice(grid.j0, grid.j0 + grid.jtot))
    p = inputs.prof
    nsv = cfg.scalars.nsv
    profiles = lambda: dict(
        uprof=t(p["u"]), vprof=t(p["v"]), thlprof=t(p["thl"]),
        qtprof=t(p["qt"]), e12prof=t(np.maximum(p["e12"], const.e12min)))
    if cfg.bc.BCxm == BC_PROFILE or cfg.bc.BCym == BC_PROFILE:
        inl = Inlet(mode=BC_PROFILE, **profiles(),
                    svprof=(t(inputs.scalar) if inputs.scalar is not None
                            else torch.zeros((nsv, dom.ktot), **kw)))
        if cfg.bc.BCxm == BC_PROFILE:
            model.inlet = inl
        if cfg.bc.BCym == BC_PROFILE:
            model.inlet_y = inl
    if cfg.bc.BCxm == BC_DRIVER:
        djob = cfg.driver.driverjobnr
        dpath = case_dir / f"driverdata.{djob:03d}.h5"
        tdrv = case_dir / f"tdriver_000.{djob:03d}"
        series = dict(driverstore=cfg.driver.driverstore or None, nsv=nsv,
                      ltempeq=cfg.physics.ltempeq, lmoist=cfg.physics.lmoist)
        if cfg.driver.lchunkread and tdrv.exists():
            # streaming replay (lchunkread, moddriver.f90:933): only
            # chunkread_size planes live on the device; the window in
            # State.drv is refilled between steps (io/driverstream.py)
            from .io.driverstream import DriverStream
            model.inlet = Inlet(mode=BC_DRIVER)
            model.driver_stream = DriverStream(
                case_dir, djob, dom.jtot, dom.ktot, grid.torch_dtype,
                chunk=cfg.driver.chunkread_size, device=model.device,
                rows=rows, **series)
        elif dpath.exists():
            model.inlet = load_driver_inlet(dpath, grid.torch_dtype,
                                            model.device, rows=rows)
        elif tdrv.exists():
            # reference Fortran ?driver_* files (moddriver.f90:750
            # readdriverfile): direct-access f8 planes per y-rank
            from .io.driverfiles import read_driver_files
            d = ycut_series(read_driver_files(case_dir, djob, dom.jtot,
                                              dom.ktot, **series), rows)
            model.inlet = Inlet(mode=BC_DRIVER, **{
                k: t(d[k]) if k in d else None
                for k in ("t", "u", "v", "w", "thl", "qt", "sv")})
        else:
            raise FileNotFoundError(
                f"driver-inlet case (idriver=2): neither {dpath.name} nor "
                f"reference driver files (tdriver_000.{djob:03d} + "
                f"?driver_*) found in {case_dir}; record them by running "
                f"the precursor case (idriver=1, experiment {djob:03d}) "
                f"first (moddriver.f90:515/750)")
    elif cfg.driver.iinletgen == 1:
        # the Lund-1998 rescale-recycle generator (modinlet.f90 inletgen):
        # the Inlet holds the profile context (qt/e12/sv planes); the
        # generator state itself lives in State.ig (ops/inletgen.py)
        model.inlet = Inlet(mode=BC_RECYCLE, **profiles(),
                            svprof=torch.zeros((nsv, dom.ktot), **kw),
                            irecy=cfg.driver.iplane)
        model.igparams = InletGenParams(cfg, model.domain_grid)
    elif cfg.driver.iinletgen == 2:
        # replay planes recorded by a previous iinletgen=1 run
        # (modinlet.f90:860-944 readinletfile analogue; lerp in time)
        ip = case_dir / f"inletdata.{cfg.driver.driverjobnr:03d}.npz"
        if not ip.exists():
            raise FileNotFoundError(
                f"{ip}: iinletgen=2 needs planes recorded by running the "
                f"generator case (iinletgen=1, lstoreplane) first")
        d = ycut_series(dict(np.load(ip)), rows)
        nt = len(d["t"])
        model.inlet = Inlet(
            mode=BC_DRIVER, t=t(d["t"]), u=t(d["u"]), v=t(d["v"]),
            w=t(d["w"]), thl=t(d["thl"]),
            qt=t(p["qt"])[None, None, :].expand(nt, grid.jtot, dom.ktot),
            sv=torch.zeros((nt, nsv, grid.jtot, dom.ktot), **kw),
            e12prof=t(np.maximum(p["e12"], const.e12min)))


def _velocity_ghosts(f: Fields, cfg: Config, grid: Grid, openx=None,
                     openy=None) -> Ghosts:
    """Minimal ghost set (u, v, w only) for closure/dt before ekm exists."""
    mesh = grid.mesh
    return Ghosts(u=ghost_u(f.u, cfg, openx=openx, openy=openy, mesh=mesh),
                  v=ghost_v(f.v, cfg, openx=openx, openy=openy, mesh=mesh),
                  w=ghost_w(f.w, cfg, openx=openx, openy=openy, mesh=mesh),
                  thl=None, qt=None, e12=None, sv=None, ekm=None, ekh=None)


def _kappa_ghost_scalar(cfield, cfg: Config, openx=None, openy=None,
                        mesh=None):
    """Kappa-layout ghosts of thl, which rides through the sv slot of the
    open-boundary contexts (periodic over the ranks of `mesh`)."""
    if openx is not None:
        openx = {**openx,
                 "inlet": {**openx["inlet"],
                           "sv": openx["inlet"]["thl"][None]},
                 "bx": replace(openx["bx"], sv=openx["bx"].thl[None])}
    if openy is not None:
        openy = {**openy,
                 "inlet": {**openy["inlet"],
                           "sv": openy["inlet"]["thl"][None]},
                 "by": replace(openy["by"], sv=openy["by"].thl[None])}
    return ghost_scalar_kappa(cfield, cfg, openx=openx, openy=openy,
                              sv_index=0, mesh=mesh)


def _pad_pres(p, openx=None, openy=None, mesh=None):
    """Pressure ghosts (bcp, modboundary.f90:1344-1430): periodic wrap, or
    zero gradient at open boundaries; on a block of `mesh` the halos from
    its neighbours and the zero gradient only on the domain's open edges."""
    if mesh is not None:
        ox, oy = openx is not None, openy is not None
        return split_pad(p, 1, mesh,
                         p[0] if ox else None, p[-1] if ox else None,
                         p[:, 0] if oy else None, p[:, -1] if oy else None)
    px = pad_edge(p, 0, 1) if openx is not None else pad_wrap(p, 0, 1)
    return pad_edge(px, 1, 1) if openy is not None else pad_wrap(px, 1, 1)


def _next_face(pf, pf_out, grid: Grid, axis: str):
    """The face after the block's last one of the projected velocity `pf`
    along `axis` ("x": dim 0, "y": dim 1): the convective outlet face
    `pf_out` on the block at the domain's outlet edge, the next rank's
    first face elsewhere (every rank of the row or column exchanges)."""
    dim = 0 if axis == "x" else 1
    mesh = grid.mesh
    nxt = None
    if mesh is not None and (mesh.px if axis == "x" else mesh.py) > 1:
        nxt = mesh.halo_hi(pf, dim, 1, axis)
    if grid.edge_xhi if axis == "x" else grid.edge_yhi:
        nxt = pf_out.unsqueeze(dim)
    return nxt


def _outlet_planes(grid: Grid, axis: str, *planes):
    """The outlet planes (``XPlanes`` of an open x, ``YPlanes`` of an open
    y) as the ranks at the domain's outlet edge advanced them, on every rank
    of their row (column); unchanged on one rank along `axis`."""
    mesh = grid.mesh
    n = 1 if mesh is None else (mesh.px if axis == "x" else mesh.py)
    if n == 1:
        return planes
    names = [f.name for f in fields(planes[0])]
    got = mesh.from_owner([getattr(p, k) for p in planes for k in names],
                          n - 1, axis)
    return tuple(type(p)(**dict(zip(names, got[i * len(names):
                                                (i + 1) * len(names)])))
                 for i, p in enumerate(planes))
