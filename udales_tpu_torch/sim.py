"""Simulation driver: the program.f90 equivalent (port of
``udales_tpu.sim``).

`Simulation.run` steps the Model and, between steps, serves the output
events on the reference's cadences: field dumps (tfielddump), statistics
samples and writes (tsample / tstatsdump), facet outputs (dtEB, dtfac),
restart writes (trestart), the runtime monitor (tcheck), the precursor and
inlet-plane recorders, and the ``exit_now.<exp>`` graceful-stop sentinel
(modsave.f90:63-75).  The loop steps with the compiled step
(``Model.step_jit``: one CUDA graph replayed a step on the card), on one
process or on every rank of a capturable mesh (NCCL; gloo on the CPU), and
the driver's window refill, the writers and the loop's reads run between
replays on the State the graph writes in place; no writer keeps a State
tensor past its call.  The step itself makes no host synchronisation; the
loop reads the simulated time and the time step once a step, in one copy,
and hands the time to every writer.

On a Model split over a mesh (``parallel.mesh``) every rank runs the loop
and the step's collectives; rank 0 holds the writers and decides, once a
step, whether an output event is due; when one is, every rank gathers the
State (``gather_state``, the counterpart of udales_tpu's ``np.asarray`` of
a sharded leaf) and rank 0 serves the events from the whole State, with
the whole domain's grid, IBM masks, canopy and inlets (`_Whole`), and
writes every file.  `gathers` and `gather_seconds` count the gathers.  The
gather reads the compiled step's static State after the replay that wrote
it, and the flags' read of that decision is a host wait between steps,
outside the graph.  A host-staged mesh (shared-card gloo ranks) steps
eagerly: its exchanges wait on the host, which a graph cannot hold.

The loop is traced (``trace``): each step is the span ``sim.step`` (the
replay), ``sim.sync`` its one host read, ``sim.outputs`` the events after
it, one child span per writer family that serves an event
(``fielddump``, ``xytdump``, ``driverrec``, ``inletrec``, ``tdump``,
``tkedump``, ``xydump``, ``ydump``, ``ytdump``, ``slices``, ``mintdump``,
``treedump``, ``monitor``, ``fac``, ``facstats``, ``restart``), each with
``sample`` (the device work and copies to the host) and ``write`` (what
goes to the file, with the bytes handed to the writer), and
``sim.exit_now`` the look for the stop sentinel.  The stop's checkpoint is
the span ``restart`` outside ``sim.outputs``; the writers' last flush at
the end is ``sim.close``.

`main` is ``python -m udales_tpu_torch <case>``: runmodes 1003-1005, a cold
or warm start (native ``.h5`` checkpoint or the reference's Fortran restart
files, ``lstratstart``) and the run, on the card unless ``--device cpu``;
it ends with the trace's summary.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import trace
from .config import const
from .io import hdf5
from .io.driverfiles import write_driver_files
from .io.fielddump import FieldDump
from .io.ncwriter import NCWriter
from .io.restart import save_checkpoint
from .io.stats import (MinTDump, SliceDump, TDump, TKEDump, TreeDump,
                       XYDump, XYTDump, YDump, YTDump)
from .parallel.mesh import gather_state
from .state import zero_facstats


def _host(a):
    """A host copy of `a` that owns its memory: the recorders keep it past
    the step, and on the CPU ``.numpy()`` of the tensor itself would share
    the compiled step's static State, which the next step overwrites."""
    return a.detach().to("cpu", copy=True).numpy()


class DriverRecorder:
    """Precursor-plane recorder (idriver=1, moddriver.f90 drivergen:174 /
    writedriverfile:515): every dtdriver after tdriverstart, store the y-z
    planes of u (at face iplane), v, w, thl, qt, sv.  `save` writes the
    reference's Fortran direct-access ``?driver_*`` files, which
    ``run.load_case`` replays (idriver=2), and ``driverdata.<exp>.h5`` for
    ``ops.openbc.load_driver_inlet``."""

    def __init__(self, cfg, grid, outdir):
        self.cfg = cfg
        self.grid = grid
        self.outdir = Path(outdir)
        self.tnext = cfg.driver.tdriverstart
        self.frames = []
        self.times = []

    def due(self, t: float) -> bool:
        """Whether the simulated time `t` has reached the cadence."""
        return t >= self.tnext

    def maybe_record(self, state, t: float | None = None):
        """Record when the simulated time `t` (default: read from
        ``state.timee``) has reached the cadence."""
        t = float(state.timee) if t is None else t
        if not self.due(t):
            return
        self.tnext += self.cfg.driver.dtdriver
        c = state.c
        nx = self.grid.itot
        ip = self.cfg.driver.iplane % nx    # face index (wraps at itot)
        ic = min(ip, nx - 1)
        self.times.append(t)
        with trace.span("driverrec"), trace.span("sample"):
            self.frames.append(dict(
                u=_host(c.u[ip % nx]), v=_host(c.v[ic]), w=_host(c.w[ic]),
                thl=_host(c.thl[ic]), qt=_host(c.qt[ic]),
                sv=_host(c.sv[:, ic]) if c.sv.shape[0] else None))

    def save(self):
        """Write the recorded series; returns the path of the time file
        (None when nothing was recorded)."""
        if not self.frames:
            return None
        exp = f"{self.cfg.run.iexpnr:03d}"
        planes = {k: np.stack([fr[k] for fr in self.frames])
                  for k in ("u", "v", "w", "thl", "qt")}
        planes["sv"] = (np.stack([fr["sv"] for fr in self.frames])
                        if self.frames[0]["sv"] is not None else None)
        write_driver_files(self.outdir, exp, np.asarray(self.times), planes,
                           self.grid.jtot, self.grid.ktot,
                           tdriverstart=self.cfg.driver.tdriverstart)
        trace.add_bytes(hdf5.write(
            self.outdir / f"driverdata.{exp}.h5",
            {"t": np.asarray(self.times)}
            | {k: v for k, v in planes.items() if v is not None}))
        return self.outdir / f"tdriver_000.{exp}"


class _Whole:
    """What the writers read of a Model split over a mesh, for the gathered
    State: the domain's grid, the IBM's masks, the canopy and the inlets
    (a driver series gathered along y) of the whole domain.  Every rank
    builds it: the gathers are collective."""

    def __init__(self, model):
        mesh = model.mesh

        def whole(a):
            # arrays cut by Grid.cut: x and y are axes -3 and -2
            return mesh.gather(a, (None,) * (a.ndim - 3) + ("x", "y", None))
        self.cfg, self.device, self.mesh = model.cfg, model.device, None
        self.grid = model.domain_grid
        self.eb, self.inputs = model.eb, model.inputs
        self.inlet_y, self.igparams = model.inlet_y, model.igparams
        self.ibm = None
        if model.ibm is not None:
            m = model.ibm.masks
            self.ibm = SimpleNamespace(
                nfcts=model.ibm.nfcts, masks=dataclasses.replace(m, **{
                    f.name: whole(getattr(m, f.name))
                    for f in dataclasses.fields(m)}))
        self.vegetation = None
        if model.vegetation is not None:
            veg = self.vegetation = copy.copy(model.vegetation)
            veg.grid = self.grid
            for name in ("lad", "dcoef_u", "dcoef_v", "dcoef_w", "ud",
                         "lsize", "rs", "sveg", "dep", "active"):
                a = getattr(veg, name)
                setattr(veg, name, None if a is None else whole(a))
        inl = self.inlet = model.inlet
        if inl is not None and inl.u is not None:
            # a recorded driver series, cut along y at load
            self.inlet = dataclasses.replace(inl, **{
                k: mesh.gather(getattr(inl, k), (None, None, "y", None)
                               if k == "sv" else (None, "y", None))
                for k in ("u", "v", "w", "thl", "qt", "sv")
                if getattr(inl, k) is not None})

    def _inlet_planes(self, state, f, ig):
        from .run import inlet_planes
        return inlet_planes(self.inlet, self.igparams, self.grid, state, f,
                            ig)


class Simulation:
    """The run loop of one Model with every writer its configuration
    switches on; the writers' tensors live on the model's device.  On a
    split Model the writers live on rank 0 and read the gathered State."""

    gathers = trace.counter("sim.gathers")
    gather_seconds = trace.counter("sim.gather_seconds")

    def __init__(self, model, outdir: str | Path = ".", monitor: bool = True):
        self.model = model
        self.mesh = model.mesh
        self.root = self.mesh is None or self.mesh.rank == 0
        # what the writers read: the Model, or the whole domain of a split
        self.view = view = model if self.mesh is None else _Whole(model)
        self.gathers, self.gather_seconds = 0, 0.0
        self.cfg = cfg = model.cfg
        grid, dev = view.grid, model.device
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        # the step: the compiled step (a CUDA graph replayed a step on the
        # card, its eager body on the CPU), as udales_tpu steps with
        # jax.jit(model.step), on one process or a capturable mesh; a
        # host-staged mesh steps eagerly, since its exchanges wait on the
        # host
        self.compiled = self.mesh is None or self.mesh.capturable
        self.step = model.step_jit() if self.compiled else model.step
        self.step_kind = (f"compiled ({self.step.kind})" if self.compiled
                          else "eager (host-staged split)")
        # the writers: every switch, on rank 0 of a split
        o = dataclasses.replace(cfg.output, **({} if self.root else {
            k: False for k in ("lfielddump", "lxytdump", "lxydump",
                               "lydump", "ltdump", "ltkedump", "lytdump",
                               "lmintdump", "ltreedump", "lkslicedump",
                               "lislicedump", "ljslicedump")}))
        nsv = cfg.scalars.nsv
        out = self.outdir
        model = view
        self.fielddump = (FieldDump(cfg, grid, out, masks=model.ibm.masks
                                    if model.ibm is not None else None)
                          if o.lfielddump else None)
        self.xytdump = (XYTDump(cfg, grid, out, model=model, device=dev)
                        if o.lxytdump else None)
        self.xydump = XYDump(cfg, grid, out, model=model) \
            if o.lxydump else None
        self.ydump = YDump(cfg, grid, out, nsv=nsv, model=model) \
            if o.lydump else None
        self.tdump = (TDump(cfg, grid, out, nsv, model=model, device=dev)
                      if o.ltdump else None)
        self.tkedump = (TKEDump(cfg, grid, out, model, device=dev)
                        if o.ltkedump else None)
        self.ytdump = (YTDump(cfg, grid, out, nsv=nsv, model=model,
                              device=dev) if o.lytdump else None)
        self.mintdump = MinTDump(cfg, grid, out, device=dev) \
            if o.lmintdump else None
        self.treedump = (TreeDump(cfg, grid, model.vegetation, out,
                                  device=dev)
                         if (o.ltreedump and model.vegetation is not None)
                         else None)
        self.slices = (SliceDump(cfg, grid, out, nsv)
                       if (o.lkslicedump or o.lislicedump or o.ljslicedump)
                       else None)
        self.facwriter = None
        if cfg.eb.lEB and cfg.eb.lwriteEBfiles and model.eb and self.root:
            exp = self._exp()
            w = NCWriter(out / f"facT.{exp}.nc", nfcts=model.eb.nfcts,
                         nlayers=cfg.eb.nfaclyrs + 1)
            w.define("T", ("facet", "layer"), "K", "Temperature")
            w.define("dTdz", ("facet", "layer"), "K/m",
                     "Temperature gradient")
            w2 = NCWriter(out / f"facEB.{exp}.nc", nfcts=model.eb.nfcts)
            w2.define("netsw", ("facet",), "W/m^2", "Net shortwave")
            w2.define("LWin", ("facet",), "W/m^2", "Incoming longwave")
            w2.define("LWout", ("facet",), "W/m^2", "Outgoing longwave")
            w2.define("hf", ("facet",), "W/m^2", "Sensible heat")
            w2.define("ef", ("facet",), "W/m^2", "Latent heat")
            w2.define("WGR", ("facet",), "?", "Water content")
            self.facwriter = (w, w2)
            self._last_facwrite = 0.0
        # fac.<exp>.nc facet stress/pressure output (lwritefac,
        # modibm.f90:198-247)
        self.facstatwriter = None
        if cfg.walls.lwritefac and model.ibm is not None and self.root:
            wf = NCWriter(out / f"fac.{self._exp()}.nc",
                          nfcts=model.ibm.nfcts)
            wf.define("tau_x", ("facet",), "m^2/s^2", "tau_x")
            wf.define("tau_y", ("facet",), "m^2/s^2", "tau_y")
            wf.define("tau_z", ("facet",), "m^2/s^2", "tau_z")
            wf.define("pres", ("facet",), "m^2/s^2", "pressure")
            wf.define("htc", ("facet",), "", "heat transfer coefficient")
            wf.define("cth", ("facet",), "",
                      "heat transfer coefficient (Ivo)")
            wf.define("pres_flc", ("facet",), "", "pressure fluctuation")
            self.facstatwriter = wf
            self.tnextfacstat = cfg.walls.dtfac
        self.monitor = monitor
        # tcheck cadence (modchecksim.f90:37,64-67): report every tcheck
        # seconds of simulated time; tcheck=0 means every step in the
        # reference, every 50 steps here (as in udales_tpu)
        self.tcheck = o.tcheck
        self.tnextcheck = 0.0
        self.tnextrestart = cfg.run.trestart
        self.ntrun = 0
        # per-step monitor file (modtstep.f90:290-320 writes monitor<id>.txt)
        self._monitor_path = out / f"monitor.{self._exp()}.txt"
        self.profile_dir = None  # a directory: torch.profiler trace
        self.driver_rec = (DriverRecorder(cfg, grid, out)
                           if cfg.driver.idriver == 1 and self.root
                           else None)
        # inlet-plane recorder (lstoreplane, modinlet.f90 writeinletfile):
        # the generated planes live in State.ig; stored once per full step
        self.inlet_rec = ([] if (cfg.driver.iinletgen == 1
                                 and cfg.driver.lstoreplane and self.root)
                          else None)
        self._inlet_rec_t = []

    def _exp(self):
        return f"{self.cfg.run.iexpnr:03d}"

    def _writers(self):
        return (self.fielddump, self.xytdump, self.tdump, self.ytdump,
                self.slices, self.tkedump, self.xydump, self.ydump,
                self.mintdump, self.treedump, self.facstatwriter,
                *(self.facwriter or ()))

    @staticmethod
    def _time_and_dt(state):
        """(timee, dt) of `state` as host floats, in one device copy."""
        t, dt = torch.stack([state.timee, state.dt]).tolist()
        return t, dt

    def run(self, state=None, runtime: float | None = None, seed: int = 43):
        cfg = self.cfg
        if state is None:
            state = self.model.cold_start(seed=seed)
        runtime = runtime if runtime is not None else cfg.run.runtime
        t0 = float(state.timee)
        t_end = t0 + runtime
        # warmstart: fast-forward output timers to the first cadence
        # multiple at/after the restart time (otherwise every writer would
        # fire once per step while catching up from t=0)

        def _ff(obj, attr, cad):
            if (obj is not None and cad > 0 and hasattr(obj, attr)
                    and getattr(obj, attr) < t0):
                setattr(obj, attr, cad * math.ceil(t0 / cad + 1e-9))
        _ff(self.fielddump, "tnext", cfg.output.tfielddump)
        for w in (self.xytdump, self.tdump, self.tkedump, self.ytdump,
                  self.mintdump, self.treedump):
            _ff(w, "tnext_sample", cfg.output.tsample)
            _ff(w, "tnext_write", cfg.output.tstatsdump)
        for w in (self.xydump, self.ydump, self.slices):
            for attr, cad in (("tnext", cfg.output.tsample),
                              ("tnext_sample", cfg.output.tsample),
                              ("tnext_write", cfg.output.tstatsdump)):
                if w is not None and hasattr(w, attr):
                    _ff(w, attr, cad)
        _ff(self, "tnextrestart", cfg.run.trestart)
        _ff(self, "tnextcheck", self.tcheck)
        masks = self.view.ibm.masks if self.view.ibm else None
        wall0 = time.time()
        nsteps = 0
        prof = None
        if self.profile_dir is not None and self.root:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.model.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        t = t0
        try:
            with (open(self._monitor_path, "a") if self.root
                  else contextlib.nullcontext()) as mon:
                while t < t_end:
                    if self.model.driver_stream is not None:
                        # streaming precursor replay: swap in the next chunk
                        # when timee crosses the device window (lchunkread)
                        state = self.model.driver_stream.ensure(state)
                    with trace.span("sim.step"):
                        state = self.step(state)
                    nsteps += 1
                    self.ntrun += 1
                    with trace.span("sim.sync"):    # the step's one sync
                        t, dt = self._time_and_dt(state)
                    if self.mesh is None:
                        with trace.span("sim.outputs"):
                            state = self._outputs(state, t, masks, nsteps,
                                                  wall0)
                        with trace.span("sim.exit_now"):
                            stop = self._exit_now()
                        if stop:
                            self._write_restart(state)
                    else:
                        with trace.span("sim.outputs"):
                            state, stop = self._split_outputs(
                                state, t, masks, nsteps, wall0)
                    if mon is not None:
                        mon.write(f"{t:14.6e} {dt:14.6e}\n")
                    if stop:
                        break
                    if prof is not None and nsteps == 12:
                        self._stop_profile(prof)
                        prof = None
        finally:
            if prof is not None:
                self._stop_profile(prof)
            with trace.span("sim.close"):
                self._close()
        # the compiled step's State is its own until its next call
        return state.map(torch.clone) if self.compiled else state

    def _exit_now(self):
        """The graceful-stop sentinel ``exit_now.<exp>`` exists."""
        return (self.outdir / f"exit_now.{self._exp()}").exists()

    # -- the events of `_outputs`, each decided in one place ---------------
    def _cadenced(self):
        """The writers that keep their own cadence (`due`)."""
        return [w for w in (self.fielddump, self.xytdump, self.driver_rec,
                            self.tdump, self.tkedump, self.xydump, self.ydump,
                            self.ytdump, self.slices, self.mintdump,
                            self.treedump) if w is not None]

    def _inlet_rec_due(self, state):
        return self.inlet_rec is not None and state.ig is not None

    def _monitor_due(self, t, nsteps):
        return self.monitor and (t >= self.tnextcheck if self.tcheck > 0
                                 else nsteps % 50 == 0)

    def _fac_due(self, state, t):
        return (self.facwriter is not None and state.fac is not None
                and t >= self._last_facwrite + self.cfg.eb.dtEB)

    def _facstat_due(self, state, t):
        return (self.facstatwriter is not None and state.facstats is not None
                and t >= self.tnextfacstat)

    def _due(self, state, t, nsteps):
        """Whether `_outputs` at the simulated time `t` serves any event
        (rank 0 of a split decides for every rank)."""
        return (any(w.due(t) for w in self._cadenced())
                or self._inlet_rec_due(state) or self._monitor_due(t, nsteps)
                or self._fac_due(state, t) or self._facstat_due(state, t)
                or t >= self.tnextrestart)

    def _split_outputs(self, state, t, masks, nsteps, wall0):
        """`_outputs` of a split Model, and whether to stop: rank 0 says
        whether an event is due, whether the facet statistics restart and
        whether the sentinel asks to stop (one MAX all-reduce of three
        flags); when an event is due every rank gathers the State and rank
        0 serves it.  Returns (this rank's State, stop)."""
        mesh = self.mesh
        flags = torch.zeros(3, dtype=state.dt.dtype, device=state.dt.device)
        if self.root:
            flags = torch.tensor([
                self._due(state, t, nsteps), self._facstat_due(state, t),
                self._exit_now()], dtype=flags.dtype, device=flags.device)
        due, reset, stop = (v > 0 for v in mesh.allreduce_max(flags).tolist())
        if due or stop:
            t0 = time.perf_counter()
            whole = gather_state(state, mesh)
            self.gathers += 1
            self.gather_seconds += time.perf_counter() - t0
            if self.root:
                whole = self._outputs(whole, t, masks, nsteps, wall0)
                if stop:
                    self._write_restart(whole)
        if reset:
            # the facet statistics are whole on every rank: each restarts
            # them as rank 0's write did
            state = state.replace(facstats=self._fresh_facstats(
                state.facstats, t))
        return state, stop

    def _outputs(self, state, t, masks, nsteps, wall0):
        """Every output event due at the simulated time `t`, in the
        reference's order; returns the State (the facet statistics restart
        after a write)."""
        if self.fielddump is not None:
            self.fielddump.maybe_dump(state, t)
        if self.xytdump is not None:
            self.xytdump.maybe_sample(state, t, masks)
        if self.driver_rec is not None:
            self.driver_rec.maybe_record(state, t)
        if self._inlet_rec_due(state):
            self._inlet_rec_t.append(t)
            ig = state.ig
            with trace.span("inletrec"), trace.span("sample"):
                self.inlet_rec.append(dict(u=_host(ig.u0), v=_host(ig.v0),
                                           w=_host(ig.w0), thl=_host(ig.t0)))
        if self.tdump is not None:
            self.tdump.maybe_sample(state, t)
        if self.tkedump is not None:
            self.tkedump.maybe_sample(state, t)
        if self.xydump is not None:
            self.xydump.maybe_dump(state, t, masks)
        if self.ydump is not None:
            self.ydump.maybe_dump(state, t, masks)
        if self.ytdump is not None:
            self.ytdump.maybe_sample(state, t, masks)
        if self.slices is not None:
            self.slices.maybe_dump(state, t)
        if self.mintdump is not None:
            self.mintdump.maybe_sample(state, t)
        if self.treedump is not None:
            self.treedump.maybe_sample(state, t)
        if self._monitor_due(t, nsteps):
            self.tnextcheck = t + self.tcheck
            with trace.span("monitor"):
                self._checksim(state, nsteps, wall0)
        if self._fac_due(state, t):
            self._last_facwrite = t
            with trace.span("fac"):
                self._write_fac(state, t)
        if self._facstat_due(state, t):
            with trace.span("facstats"):
                state = self._write_facstats(state, t)
            self.tnextfacstat = round(t + self.cfg.walls.dtfac)
        if t >= self.tnextrestart:
            self.tnextrestart += self.cfg.run.trestart
            self._write_restart(state)
        return state

    def _stop_profile(self, prof):
        prof.stop()
        Path(self.profile_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(self.profile_dir)
                                     / f"trace.{self._exp()}.json"))

    def _close(self):
        for w in self._writers():
            if w is not None:
                w.close()
        if self.driver_rec is not None:
            with trace.span("driverrec"), trace.span("write"):
                self.driver_rec.save()
        if self.inlet_rec:
            planes = {k: np.stack([f[k] for f in self.inlet_rec])
                      for k in ("u", "v", "w", "thl")}
            with trace.span("inletrec"), trace.span("write"):
                trace.add_bytes(sum(a.nbytes for a in planes.values()))
                np.savez(self.outdir / f"inletdata.{self._exp()}.npz",
                         t=np.asarray(self._inlet_rec_t), **planes)

    def _write_facstats(self, state, t):
        """fac.<exp>.nc write (modibm.f90:1256-1280): normalize the
        dt-weighted sums by the elapsed interval, write, reset.  The
        pressure fluctuation is the proper interval variance
        <p^2> - <p>^2 (the reference's expression at modibm.f90:1265 mixes
        dtfac and tfac in the mean-square term; udales_tpu's deliberate
        deviation, followed here)."""
        fs = state.facstats
        with trace.span("sample"):
            tint = max(t - float(fs.tlast), 1e-9)
            avg = lambda a: _host(a) / tint
            pav = avg(fs.pres)
            data = {
                "tau_x": avg(fs.tau_x), "tau_y": avg(fs.tau_y),
                "tau_z": avg(fs.tau_z), "pres": pav,
                "htc": avg(fs.htc), "cth": avg(fs.cth),
                "pres_flc": avg(fs.pres2) - pav * pav,
            }
        with trace.span("write"):
            self.facstatwriter.append(t, data)
        return state.replace(facstats=self._fresh_facstats(fs, t))

    def _fresh_facstats(self, fs, t):
        """Zero facet statistics whose interval starts at `t`."""
        grid = self.view.grid
        fresh = zero_facstats(fs.tau_x.shape[0], grid.torch_dtype,
                              fs.tau_x.device)
        return dataclasses.replace(fresh, tlast=torch.tensor(
            t, dtype=grid.torch_dtype, device=fs.tau_x.device))

    def _write_fac(self, state, t):
        """facT/facEB outputs (modEB.f90:510-532)."""
        eb = self.model.eb
        fac = state.fac
        wT, wEB = self.facwriter
        with trace.span("sample"):
            T = _host(fac.T)
            dT = {"T": T, "dTdz": _host(fac.Tdash)}
            em = _host(eb.facem)
            data = {
                "netsw": _host(eb.netsw),
                "LWin": _host(eb.calclw(fac.T)),
                "LWout": const.boltz * em * T[:, 0] ** 4,
                "hf": _host(fac.hfi),
                "ef": _host(fac.efi),
                "WGR": _host(fac.wsoil),
            }
        with trace.span("write"):
            wT.append(t, dT)
            wEB.append(t, data)

    def _stats_writers(self):
        """Active statistics writers with resumable accumulators."""
        out = {}
        for name in ("xytdump", "tdump", "ytdump", "tkedump", "mintdump",
                     "treedump"):
            w = getattr(self, name, None)
            if w is not None and hasattr(w, "acc"):
                out[name] = w
        return out

    @staticmethod
    def _acc_items(acc):
        if isinstance(acc, dict):
            return acc.items()
        return [(f.name, getattr(acc, f.name))
                for f in dataclasses.fields(acc)]

    def _write_restart(self, state):
        name = self.outdir / f"initd{self.ntrun:08d}.{self._exp()}.h5"
        # statistics continuation (the reference's lreadmean pathway,
        # modstartup.f90:2225-2280, reads legacy means/SGS files; here the
        # live accumulators of every enabled family ride the checkpoint)
        with trace.span("restart"):
            with trace.span("sample"):
                stats = {fam: hdf5.Group(
                    {k: _host(v) for k, v in self._acc_items(w.acc)},
                    attrs=dict(tnext_sample=w.tnext_sample,
                               tnext_write=w.tnext_write))
                    for fam, w in self._stats_writers().items()}
            save_checkpoint(name, state, self.ntrun, extra={"stats": stats})

    def resume_stats(self, ckpt_path):
        """Restore statistics accumulators from a checkpoint written by
        _write_restart (lreadmean-equivalent continuation)."""
        stats = hdf5.read(ckpt_path).get("stats", {})
        for fam, w in self._stats_writers().items():
            if fam not in stats:
                continue
            g = stats[fam]
            data = {k: torch.as_tensor(v, device=self.model.device)
                    for k, v in g.items()}
            if isinstance(w.acc, dict):
                w.acc = {k: data.get(k, v) for k, v in w.acc.items()}
            else:
                w.acc = type(w.acc)(**data)
            w.tnext_sample = float(g.attrs["tnext_sample"])
            w.tnext_write = float(g.attrs["tnext_write"])

    def _checksim(self, state, nsteps, wall0):
        """Runtime monitor (modchecksim.f90:76-205): Courant number,
        diffusion number, and max divergence."""
        from .ops import fused_vreman as fv
        from .ops.thermo import thermodynamics
        from .run import _velocity_ghosts
        grid, cfg = self.view.grid, self.view.cfg
        c = state.c
        with trace.span("sample"):
            nz = grid.ktot
            dev = c.u.device
            cour = torch.max(
                c.u.abs() * grid.dxi + c.v.abs() * grid.dyi
                + c.w[..., :nz].abs() / grid.t("dzh", dev)[:nz]) * state.dt
            gu = torch.cat([c.u, c.u[:1]], dim=0)
            gv = torch.cat([c.v, c.v[:, :1]], dim=1)
            div = ((gu[1:] - gu[:-1]) * grid.dxi
                   + (gv[:, 1:] - gv[:, :-1]) * grid.dyi
                   + (c.w[:, :, 1:] - c.w[:, :, :-1]) * grid.t("dzfi", dev))
            # diffusion number (modchecksim.calcdiffnr:129-160): recompute the
            # closure on the current fields, max over ekm AND ekh
            th = thermodynamics(c, cfg, grid,
                                self.view.ibm.masks if self.view.ibm else None)
            gvel = _velocity_ghosts(c, cfg, grid)
            thvs = cfg.bc.thls if cfg.bc.thls > 0 else 288.0
            ekm, ekh, _ = fv.closure(gvel, grid, cfg, e12=c.e12,
                                     dthvdz=th.dthvdz, thl=c.thl, thvs=thvs)
            coef = grid.t("dzh2i", dev)[:nz] + grid.dx2i + grid.dy2i
            diffnr = torch.maximum(torch.max(ekm * coef),
                                   torch.max(ekh * coef)) * state.dt
            t, dt, cour, diffnr, dmax = torch.stack([
                state.timee, state.dt, cour, diffnr, div.abs().max()]).tolist()
        rate = nsteps / max(time.time() - wall0, 1e-9)
        with trace.span("write"):
            print(f"  t={t:9.2f}s dt={dt:.4f} CFL={cour:.3f} "
                  f"diffnr={diffnr:.3f} max|div|={dmax:.2e} "
                  f"[{rate:.1f} steps/s]", flush=True)


def execute_runmode_actions(model, case_dir) -> int | None:
    """In-solver test runmodes dispatched before the time loop
    (program.f90:239-275; test bodies src/tests.f90). Returns an exit code
    for runmodes 1003/1004/1005, None for a normal run (runmode 1)."""
    from .ops.thermo import avexy_masked
    cfg, grid = model.cfg, model.grid
    rm = cfg.run.runmode
    if rm == 1003:
        # tests_2decomp_init_exit (tests.f90:30-45): print the layout
        dev = model.device
        ncards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        name = (f" ({torch.cuda.get_device_name(dev)})"
                if dev.type == "cuda" else "")
        print(f"runmode 1003: model on {dev}{name}; {ncards} CUDA "
              f"device(s) visible")
        if model.mesh is not None:
            m = model.mesh
            print(f"mesh {dict(zip(m.axis_names, m.shape))}, rank {m.rank} "
                  f"at ({m.cx}, {m.cy}), {m.backend}")
        print(f"grid {grid.itot}x{grid.jtot}x{grid.ktot}")
        return 0
    if rm == 1004:
        # tests_read_sparse_ijk (tests.f90:47-133): the sparse readers must
        # agree with the &WALLS counts and stay inside the grid
        from .io.inputs import read_sparse_ijk
        ok = True
        lims = {"u": (grid.itot, grid.jtot, grid.ktot),
                "v": (grid.itot, grid.jtot, grid.ktot),
                "w": (grid.itot, grid.jtot, grid.ktot + 1),
                "c": (grid.itot, grid.jtot, grid.ktot)}
        for s in "uvwc":
            for stem, key in ((f"solid_{s}.txt", f"nsolpts_{s}"),
                              (f"fluid_boundary_{s}.txt", f"nbndpts_{s}")):
                p = Path(case_dir) / stem
                if not p.exists():
                    continue
                ijk = read_sparse_ijk(p)
                want = getattr(cfg.walls, key)
                if len(ijk) != want:
                    print(f"runmode 1004 FAIL: {stem} has {len(ijk)} "
                          f"points, &WALLS says {want}")
                    ok = False
                if len(ijk) and (ijk.min() < 0
                                 or (ijk.max(axis=0) >= lims[s]).any()):
                    print(f"runmode 1004 FAIL: {stem} out of bounds")
                    ok = False
        print(f"runmode 1004: {'PASS' if ok else 'FAIL'}")
        return 0 if ok else 1
    if rm == 1005:
        # tests_mpi_operators (tests.f90:215-429): masked reductions on the
        # model's device against plain numpy on the same arrays
        rng = np.random.default_rng(7)
        nx, ny, nz = grid.shape
        f = rng.random((nx, ny, nz))
        mask = (rng.random((nx, ny, nz)) > 0.3).astype(float)
        t = lambda a: torch.as_tensor(a, device=model.device)
        tf, tm = t(f), t(mask)
        got = _host(avexy_masked(tf, tm))
        cnt = mask.sum(axis=(0, 1))
        want = np.where(cnt > 0, (f * mask).sum(axis=(0, 1))
                        / np.maximum(cnt, 1), -999.0)
        ok = np.allclose(got, want, atol=1e-12)
        # avey/sumx/sumy semantics (modmpi.f90:691-752)
        gy = _host((tf * tm).sum(dim=1)
                   / torch.clamp(tm.sum(dim=1), min=1))
        wy = (f * mask).sum(axis=1) / np.maximum(mask.sum(axis=1), 1)
        ok &= np.allclose(gy, wy, atol=1e-12)
        ok &= np.allclose(_host((tf * tm).sum(dim=0)),
                          (f * mask).sum(axis=0), atol=1e-12)
        print(f"runmode 1005: {'PASS' if ok else 'FAIL'}")
        return 0 if ok else 1
    return None


def main(argv=None):
    """CLI: python -m udales_tpu_torch <case_dir_or_namoptions> [options]"""
    import argparse
    from .run import load_case
    ap = argparse.ArgumentParser(prog="udales_tpu_torch",
                                 description="urban LES on a CUDA card "
                                             "(PyTorch)")
    ap.add_argument("case", help="case directory or namoptions.<exp> path")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--runtime", type=float, default=None)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=43)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card; "
                         "'cpu' for a run without one)")
    ap.add_argument("--profile", default=None,
                    help="directory for a torch.profiler trace of the first "
                         "12 steps, with the program's spans")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("udales_tpu_torch: no CUDA device (torch.cuda."
                         "is_available() is False); pass --device cpu to "
                         "run on the CPU")

    case = Path(args.case)
    if case.is_file():
        expnr = case.suffix[1:]
        case = case.parent
    else:
        expnr = None
    model = load_case(case, expnr, dtype=args.dtype, device=args.device)
    rc = execute_runmode_actions(model, case)
    if rc is not None:
        raise SystemExit(rc)
    outdir = args.outdir or "."
    sim = Simulation(model, outdir)
    if args.profile:
        sim.profile_dir = args.profile
    print(f"udales_tpu_torch: case {case} grid {model.grid} "
          f"device {model.device}", flush=True)
    state = None
    run = model.cfg.run
    if (run.lwarmstart or run.lstratstart) and run.startfile:
        exp = f"{run.iexpnr:03d}"
        if run.startfile.endswith(".h5"):
            # native checkpoint resume
            from .io.restart import load_checkpoint
            ck = case / run.startfile
            ck = ck if ck.exists() else Path(outdir) / run.startfile
            state = load_checkpoint(ck, model.grid, model=model)
            sim.resume_stats(ck)   # lreadmean-equivalent continuation
        else:
            # reference Fortran unformatted restart files
            from .io.restart import warmstart_state
            sdir = case / "warmstart_files"
            sdir = sdir if sdir.exists() else case
            state = warmstart_state(sdir, run.startfile, exp, model.cfg,
                                    model.grid, device=model.device,
                                    model=model)
        if run.lstratstart and model.inputs is not None:
            # lstratstart (modstartup.f90:991-1084): keep the restart
            # velocities but re-impose the thl/qt profiles from prof.inp
            p = model.inputs.prof
            kw = dict(dtype=model.grid.torch_dtype, device=model.device)
            tile = lambda prof: torch.as_tensor(
                np.asarray(prof), **kw)[None, None, :].expand(
                    model.grid.shape).clone()
            newf = lambda f: dataclasses.replace(f, thl=tile(p["thl"]),
                                                 qt=tile(p["qt"]))
            state = state.replace(m=newf(state.m), c=newf(state.c))
        print(f"warmstart from {run.startfile} "
              f"t={float(state.timee):.2f}", flush=True)
    final = sim.run(state, runtime=args.runtime, seed=args.seed)
    print(f"done: t={float(final.timee):.3f}s after {sim.ntrun} steps; "
          f"step {sim.step_kind}", flush=True)
    print(trace.summary(), flush=True)
    return final
