"""The SGS momentum diffusion as plain tensor sweeps: ``subgrid.diff_u/v/w``
(with ``M=`` the IBM's ghosted fluid masks).  The program launches a
hand-written kernel here; the reference computes the same function with
the plain sweeps on any device."""
from __future__ import annotations

from ..grid import Grid
from . import subgrid as sgs


def fused_diff_mom(g, grid: Grid, pmasks=None):
    """(du, dv, dw) SGS momentum tendencies from the h=1 ghosted
    ``g.u, g.v, g.w, g.ekm``; `pmasks` {"u", "v", "w"}: the ghosted IBM
    fluid masks or None."""
    if pmasks is None:
        return (sgs.diff_u(g, grid), sgs.diff_v(g, grid),
                sgs.diff_w(g, grid))
    return (sgs.diff_u(g, grid, M=pmasks["u"]),
            sgs.diff_v(g, grid, M=pmasks["v"]),
            sgs.diff_w(g, grid, M=pmasks["w"]))
