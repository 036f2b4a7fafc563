"""The GLS face table's kernel (ops/face_table.py) on the card: held to its
plain version bit for bit, and timed beside its bound.

``check(interp, label)`` builds the table of the interpolator's grid from
a seeded non-symmetric K, diff_mag and Neumann values (on about 40% of
the points), with the kernel and with the plain version on the same card
tensors, raises unless the two agree to the bit, times both
(``kernel_stages.best_ms``), and prints and returns one row: faces, the
kernel's ms, its bound (``table_bytes`` at the card's memory rate) and
its share of it, the plain version's ms, the device bytes each holds at
its peak (the table and the plain version's temporaries), the launches
counted and the launch's occupancy.  Run alone (on the card):

    python -m ninpol_tpu_torch.tools.face_table [--n 68] [--hexa 128]

checks tetra_mesh(20) (its last 256-face tile partial), hexa_mesh(16)
and the two meshes named.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import face_table as ft
from .kernel_stages import best_ms
from .problem import bound, build_problem


def inputs(interp, seed=0):
    """``face_table``'s arguments on the interpolator's device: the grid's
    face geometry, cell pairs and points, and a seeded K (not symmetric),
    diff_mag and Neumann values."""
    dg = interp.device_grid
    n, p = dg.n_elems, dg.n_points
    rng = np.random.default_rng(seed)
    host = (rng.normal(size=9 * n), rng.random(n) * 3.0,
            rng.normal(size=p) * (rng.random(p) < 0.4))
    return [dg.face_geo, dg.esuf_pair, dg.inpofa] + [
        torch.as_tensor(a, device=dg.device) for a in host]


def differing_rows(args):
    """Rows where the kernel's table and the plain version's differ in
    any bit, and the largest difference."""
    got = ft.face_table(*args)
    want = ft.face_table_reference(*args)
    torch.cuda.synchronize()
    rows = int((got.view(torch.int64) != want.view(torch.int64))
               .any(dim=1).sum())
    return rows, float((got - want).abs().max()) if got.numel() else 0.0


def peak_bytes(fn):
    """Device bytes fn() holds at its peak beyond what was allocated
    before it, its result included."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - before


def check(interp, label):
    args = inputs(interp)
    n = args[0].shape[0]
    launches = ft.face_table.launches
    rows, gap = differing_rows(args)
    if rows:
        raise RuntimeError(f"face_table on {label}: {rows} of {n} rows "
                           f"differ from the plain version (max {gap:.3e})")
    ms = best_ms(lambda: ft.face_table(*args))
    plain_ms = best_ms(lambda: ft.face_table_reference(*args))
    peak = peak_bytes(lambda: ft.face_table(*args))
    plain_peak = peak_bytes(lambda: ft.face_table_reference(*args))
    dg = interp.device_grid
    bound_ms, by = bound(0.0, ft.table_bytes(n, dg.n_elems, dg.n_points))
    row = {"label": label, "n_faces": n, "tile_remainder": n % 256,
           "max_abs_err": gap,
           "ms": ms, "bound_ms": bound_ms, "bound_by": by,
           "bound_share": bound_ms / ms, "plain_ms": plain_ms,
           "peak_bytes": peak, "plain_peak_bytes": plain_peak,
           "launches": ft.face_table.launches - launches,
           "occupancy": ft.occupancy()}
    print(f"# face_table {json.dumps(row)}", flush=True)
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=68)
    ap.add_argument("--hexa", type=int, default=128)
    args = ap.parse_args()
    for n, family in ((20, "tetra"), (16, "hexa"), (args.n, "tetra"),
                      (args.hexa, "hexa")):
        interp, _ = build_problem(n, family=family)
        check(interp, f"{family}_mesh({n})")
        for line in ft.library.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"#   {line.strip()}", flush=True)
        ft.library.build_log = ""
        del interp
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
