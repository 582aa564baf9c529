"""Time the fused momentum-diffusion CUDA kernel alone on one CUDA card,
beside variants of its source.

    python3 prof_torch_fused_diff.py [--sizes 128 256] [--reps 50]
        [--tiles 8x64x528x4 16x32x528x5 ...] [--source other.cu ...]
        [--ablate]

Builds ``udales_tpu_torch/csrc/fused_diff_mom.cu`` as the package does
(`default`), a copy of it for every ``--tiles TJxTKxMIN_BLOCKSxNSLOT`` with
those four constants rewritten (the tile of a block, the least number of
blocks the launcher cuts i for and the planes in the shared-memory ring),
and every ``--source`` file that exports the same C entry points (an
earlier design, say).  The package's wrapper takes no such options: the
variants are made and built here.  Each build is first held against the
plain sweeps ``subgrid.diff_u/v/w`` on a ragged float64 grid and at every
size in float32; a miss raises.  Then, for every size n (n^3 cells,
float32), unmasked and with random {0,1} masks, the builds are timed in
turns (forwards, then backwards) with CUDA events over ``--reps``
back-to-back calls, eagerly and captured in one CUDA graph (where the
host's launch rate cannot set the time), and each time is printed with the
bound (least bytes over 3.35 TB/s) and the share of it reached.  nvcc's
register report and the resident blocks per SM of each build are printed
too.  The table also goes to ``chiprun_out/prof_torch_fused_diff.txt``.
The timers, inputs and the check are ``chip_smoke.py``'s.

``--ablate`` also times three cuts of the package's source that leave part
of the work out on purpose to see what the rest costs: ``no-stencil``
(copies and stores, one load a field in place of the arithmetic),
``no-copies`` (only the first planes of a block are copied) and
``no-stores``.  They compute something else, so they are not held against
the plain sweeps.  Every rewrite names a text of the source that must occur
exactly once, so an edit of the kernel that moves it stops this script with
a message and cannot go unseen.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (HBM_BYTES_PER_S, check_kernel, cuda_ms, graph_ms,
                        plain_diff, random_ghosts, random_masks)
from udales_tpu_torch.grid import Grid
from udales_tpu_torch.ops.fused_diff import SOURCE, FusedDiffMom, least_bytes
from udales_tpu_torch.ops.kernel import BUILD_DIR

OUT = Path(__file__).resolve().parent / "chiprun_out"

# the constants a --tiles spec rewrites, in the spec's order
_TILE = (r"constexpr int TJ = \d+, TK = \d+;",
         "constexpr int TJ = {0}, TK = {1};")
_MIN_BLOCKS = (r"constexpr int MIN_BLOCKS = \d+;",
               "constexpr int MIN_BLOCKS = {2};")
_NSLOT = (r"constexpr int NSLOT = \d+;", "constexpr int NSLOT = {3};")

_AT_POINT = "    const long long o = ((long long)i * ny + j) * nz + k;\n"
# name -> (text of the source, its replacement), each found exactly once
ABLATIONS = {
    "no-stencil": [(_AT_POINT, _AT_POINT + """    {
      const long long ow_ = ((long long)i * ny + j) * (nz + 1) + k;
      du[o] = C(u, 0, 0, 0);
      dv[o] = C(v, 0, 0, 0);
      dw[ow_] = W(0, 0, 0) + ekm_c + MC(pm_u, 0, 0, 0) + MC(pm_v, 0, 0, 0)
                + MW(0, 0);
      if (k == nz - 1) dw[ow_ + 1] = T(0);
      continue;
    }
""")],
    "no-copies": [("    load_plane(s + 2 + AHEAD);\n", "")],
    # a condition the compiler cannot rule out and the data never meets
    "no-stores": [(f"      d{c}[{o}] = t_x",
                   f"      if (t_x == T(12345.678)) d{c}[{o}] = t_x")
                  for c, o in (("u", "o"), ("v", "o"), ("w", "ow"))],
}


class Variant(FusedDiffMom):
    """The package's wrapper around another source file."""

    def __init__(self, source):
        super().__init__()
        self.source = Path(source)


def rewritten(name, edits, regex=False):
    """A copy of the package's source with every (old, new) of `edits`
    applied, written next to the built libraries; each `old` must occur
    exactly once."""
    text = SOURCE.read_text()
    for old, new in edits:
        pattern = old if regex else re.escape(old)
        text, found = re.subn(pattern, lambda m: new, text)
        if found != 1:
            raise RuntimeError(f"variant {name}: {old!r} occurs {found} "
                               f"times in {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"fused_diff_mom_{name}.cu"
    path.write_text(text)
    return path


def tile_variant(spec):
    values = [int(x) for x in spec.split("x")]
    if len(values) != 4:
        raise SystemExit(f"--tiles {spec}: expected TJxTKxMIN_BLOCKSxNSLOT")
    return rewritten(spec, [(old, new.format(*values))
                            for old, new in (_TILE, _MIN_BLOCKS, _NSLOT)],
                     regex=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--tiles", nargs="*", default=[])
    ap.add_argument("--source", nargs="*", default=[])
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof_torch_fused_diff: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    lines = []

    def say(msg):
        print(msg, flush=True)
        lines.append(msg)
    say(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    builds = {"default": Variant(SOURCE)}
    for spec in args.tiles:
        builds[spec] = Variant(tile_variant(spec))
    for src in args.source:
        builds[Path(src).name] = Variant(src)
    unchecked = list(ABLATIONS) if args.ablate else []
    for name in unchecked:
        builds[name] = Variant(rewritten(name, ABLATIONS[name]))

    zf = np.cumsum(1.04 ** np.arange(37)) - 0.5 * 1.04 ** np.arange(37)
    ragged = Grid(24, 20, 37, 24.0, 20.0, zf, dtype=np.float64)
    grids = {n: Grid.uniform(n, n, n, float(n), float(n), float(n),
                             dtype=np.float32) for n in args.sizes}
    for name, kern in builds.items():
        lib = kern.load()
        say(f"[{name}] built {kern.source.name}")
        for line in kern.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                say("    " + line.strip())
        if hasattr(lib, "fused_diff_mom_blocks_per_sm"):
            say("    resident blocks per SM: " + ", ".join(
                f"{'masked' if m else 'unmasked'} "
                f"{'f64' if dt == torch.float64 else 'f32'} "
                f"{kern.blocks_per_sm(dt, m)}"
                for dt in (torch.float32, torch.float64)
                for m in (False, True)))
        for masked in () if name in unchecked else (False, True):
            for grid, dtype, rtol in [(ragged, torch.float64, 1e-12)] + [
                    (grid, torch.float32, 1e-5) for grid in grids.values()]:
                pm = (random_masks(grid, dtype, "cuda", seed=4) if masked
                      else None)
                err = check_kernel(
                    kern, random_ghosts(grid, dtype, "cuda", seed=1), grid,
                    pm, rtol, f"{name} {grid.shape} masked={masked}", "check")
                say(f"    {grid.shape} {str(dtype)[6:]} masked={masked}: "
                    f"max abs err {err:.3e}")

    for n, grid in grids.items():
        for masked in (False, True):
            g = random_ghosts(grid, torch.float32, "cuda", seed=2)
            pm = (random_masks(grid, torch.float32, "cuda", seed=4) if masked
                  else None)
            bound_ms = least_bytes(grid.shape, 4, masked) \
                / HBM_BYTES_PER_S * 1e3
            for kern in builds.values():
                for _ in range(3):
                    kern(g, grid, pmasks=pm)
            order = list(builds) + list(builds)[::-1]
            times = {name: [] for name in builds}
            graphed = {name: [] for name in builds}
            for name in order:
                kern = builds[name]
                call = lambda: kern(g, grid, pmasks=pm)
                times[name].append(cuda_ms(call, args.reps))
                graphed[name].append(graph_ms(call, args.reps))
            plain_ms = cuda_ms(lambda: plain_diff(g, grid, pm), 10)
            say(f"{n}^3 float32 {'masked' if masked else 'unmasked'} on "
                f"{smi}: bound {bound_ms:.4f} ms "
                f"({least_bytes(grid.shape, 4, masked) / 1e6:.1f} MB at "
                f"3.35 TB/s); plain sweeps {plain_ms:.4f} ms")
            for name, (t1, t2) in times.items():
                ms = (t1 + t2) / 2
                g1, g2 = graphed[name]
                say(f"    {name:28s} {ms:.4f} ms ({t1:.4f}, {t2:.4f}) = "
                    f"{100 * bound_ms / ms:.1f}% of the bound; in a CUDA "
                    f"graph {(g1 + g2) / 2:.4f} ms ({g1:.4f}, {g2:.4f}) = "
                    f"{200 * bound_ms / (g1 + g2):.1f}%")
    OUT.mkdir(exist_ok=True)
    (OUT / "prof_torch_fused_diff.txt").write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    sys.exit(main())
