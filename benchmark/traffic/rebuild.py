"""The one generator of the benchmark's traffic: closed-loop weight
rebuilds on a fixed mesh, one caller.

A reservoir workflow rebuilds the interpolation weights whenever the
permeability changes (an ensemble for history matching, a coupled step
that updates K).  Each rebuild draws a fresh realization K_r
(yardstick/problem.py), hands it to the program with ``load_data`` (with
its diff_mag from the program's ``compute_diffusion_magnitude``, as a
user does) and asks for the weights of every node on the mix's delivery:

  * ``device_out``: ``prepare_interpolator(method, "u", all nodes,
    device_out=True)``, ended when the device is done;
  * ``csr``: ``interpolate("u", method)``, the scipy CSR matrix and the
    Neumann vector on the host (the upstream's own contract).

A mix file (traffic/<mix>.json) gives ``generator`` (this module's
name), ``method``, ``delivery``, ``field`` (Field's parameters),
``check_nodes`` (nodes compared a rebuild), optionally ``settings``
({"gls.fused": false, ...}, set on the Interpolator) and ``limits``.
"""
from __future__ import annotations

import contextlib
import io
import sys
import time

import numpy as np
import torch
from torch.autograd.profiler import record_function

from .. import judge
from ..reference import gls as reference
from ..yardstick import meshgen, problem, topology, work

PHASE_PREFIX = "# gls phases: "


def parse_phases(text):
    """The program's NINPOL_TPU_PHASES line -> {name: cumulative s}
    (a mark such as ``n_bad_sync(n_bad=0)`` under its name before the
    bracket); other stderr lines are passed on."""
    phases = {}
    for line in text.splitlines():
        if not line.startswith(PHASE_PREFIX):
            print(line, file=sys.stderr)
            continue
        for token in line[len(PHASE_PREFIX):].split():
            name, t = token.rsplit("=", 1)
            phases[name.split("(")[0]] = float(t.rstrip("s"))
    return phases


class Generator:

    def __init__(self, run):
        self.run = run
        self.params = p = run.params
        self.method = p["method"]
        self.delivery = p["delivery"]
        if self.delivery not in ("device_out", "csr"):
            raise ValueError(f"unknown delivery {self.delivery!r}")
        self.device = torch.device(run.device)

    # -- set-up ---------------------------------------------------------
    def setup_mesh(self):
        """The mesh, its own topology, the base problem, and the program
        with the mesh loaded (timed: ``grid_build_s``)."""
        from ninpol_tpu_torch import Interpolator, Mesh

        cfg = self.run.config
        self.points, self.cells, self.cell_type = meshgen.FAMILIES[
            cfg["family"]](cfg["n"])
        self.topo = topology.mesh_faces(
            torch.as_tensor(self.cells, device=self.device), self.cell_type,
            len(self.points))
        self.cents = topology.cell_centres(self.points, self.cells)
        self.K0 = problem.alh_k(self.cents)
        self.u = np.sum(self.cents ** 2, axis=1)
        self.cents_dev = torch.as_tensor(self.cents, device=self.device)
        self.K0_dev = torch.as_tensor(self.K0, device=self.device)

        self.interp = Interpolator(device=str(self.device))
        for path, value in self.params.get("settings", {}).items():
            self.set(path, value)
        t0 = time.perf_counter()
        self.interp.load_mesh(mesh_obj=Mesh(
            self.points, [(self.cell_type, self.cells)],
            cell_data={"permeability": [self.K0], "u": [self.u]}))
        self.run.grid_build_s = time.perf_counter() - t0
        self.targets = np.arange(len(self.points))
        self.bnd = np.flatnonzero(self.topo["n_bface"] > 0)
        # K_r reaches the host through one buffer, page-locked on a card
        self.K_host = torch.empty(self.K0_dev.shape, dtype=torch.float64,
                                  pin_memory=self.device.type == "cuda")

    def set(self, path, value):
        """Set the Interpolator's setting ``path`` ("delivery_f32",
        "gls.fused", ...) to ``value``; return the value it had."""
        owner, _, attr = path.rpartition(".")
        obj = getattr(self.interp, owner) if owner else self.interp
        before = getattr(obj, attr)
        setattr(obj, attr, value)
        return before

    def setup_seed(self, seed):
        """The seed's boundary conditions (loaded into the program), its
        realizations and the work count."""
        self.seed = seed
        self.nflag, self.nval = problem.boundary_problem(
            self.points, self.topo, self.K0, seed)
        self.interp.load_data({"neumann_u": self.nval,
                               "neumann_flag_u": self.nflag,
                               "dirichlet_flag_u": 1 - self.nflag},
                              "points")
        self.field = problem.Field(seed, **self.params["field"])
        self.solved = work.solved_nodes(self.topo, self.nflag)
        self.solved_dev = torch.as_tensor(self.solved, device=self.device)
        self.run.work = work.gls_work(self.topo, self.nflag)

    def setup(self):
        t = [time.perf_counter()]
        self.setup_mesh()
        t.append(time.perf_counter())
        self.setup_seed(self.run.seed)
        t.append(time.perf_counter())
        self.warm()
        t.append(time.perf_counter())
        print(f"# set-up steps s: mesh, topology, problem and load_mesh "
              f"{t[1] - t[0]:.3f} (load_mesh {self.run.grid_build_s:.3f}); "
              f"boundary data {t[2] - t[1]:.3f}; warm-up {t[3] - t[2]:.3f}",
              file=sys.stderr)

    def warm(self):
        """One whole rebuild (it builds and loads the kernels), then the
        exact fallback, which a rebuild reaches now and then: a subset of
        the solved nodes sent there with the method's ``fallback_tol`` at
        0 for one call."""
        self.rebuild(0, keep=False)
        m = getattr(self.interp, self.method)
        if hasattr(m, "fallback_tol"):
            tol, m.fallback_tol = m.fallback_tol, 0.0
            g = problem.rng(self.seed, problem.WARM)
            sub = g.choice(np.flatnonzero(self.solved),
                           min(512, int(self.solved.sum())), replace=False)
            self.interp.prepare_interpolator(self.method, "u", np.sort(sub),
                                             device_out=True)
            self.sync()
            m.fallback_tol = tol

    # -- the rebuild ----------------------------------------------------
    def sample(self, r):
        """The nodes compared for rebuild r, drawn from (seed, r): a
        quarter among the boundary points, the rest among all."""
        g = problem.rng(self.seed, problem.SAMPLE, r)
        n = self.params["check_nodes"]
        a = g.choice(self.bnd, min(n // 4, len(self.bnd)), replace=False)
        b = g.choice(len(self.targets), min(n - len(a), len(self.targets)),
                     replace=False)
        return np.unique(np.concatenate([a, b]))

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def rebuild(self, r, keep=True):
        """One rebuild with realization r; its record (times, n_bad, the
        program's phase line in traced runs, and what the check needs)."""
        rec = {"r": r}
        t0 = time.perf_counter()
        with record_function("bench.field"):
            self.K_host.copy_(self.field.perm(self.K0_dev, self.cents_dev, r))
            K = self.K_host.numpy()
        t1 = time.perf_counter()
        with record_function("bench.load_data"):
            self.interp.load_data(
                {"permeability": K,
                 "diff_mag": self.interp.compute_diffusion_magnitude(K),
                 "u": self.u}, "cells")
        t2 = time.perf_counter()
        err = io.StringIO()
        with record_function("bench.deliver"), \
                contextlib.redirect_stderr(err):
            if self.delivery == "device_out":
                out = self.interp.prepare_interpolator(
                    self.method, "u", self.targets, device_out=True)
                self.sync()
            else:
                W, nw = self.interp.interpolate("u", self.method)
        t3 = time.perf_counter()
        rec.update(field_s=t1 - t0, load_s=t2 - t1, deliver_s=t3 - t2,
                   wall_s=t3 - t0, n_bad=getattr(
                       getattr(self.interp, self.method), "last_n_bad",
                       None),
                   phases=parse_phases(err.getvalue()))
        if keep:
            nodes = self.sample(r)
            rec["nodes"] = nodes
            if self.delivery == "device_out":
                rec["rows"] = out[torch.as_tensor(nodes, device=self.device)]
                w = out[:, :-1]
                gap = torch.maximum(
                    torch.where(self.solved_dev, (w.sum(1) - 1).abs(),
                                0).max(),
                    torch.where(self.solved_dev, 0,
                                out.abs().sum(1)).max())
                rec["row_sum_gap"] = gap
            else:
                rec["W"], rec["nw"] = W, nw
        return rec

    def window(self, seconds):
        """Rebuilds one after another until ``seconds`` have passed; the
        records and the window's wall seconds."""
        records = []
        t0 = time.perf_counter()
        with record_function("bench.window"):
            while True:
                records.append(self.rebuild(len(records) + 1))
                if time.perf_counter() - t0 >= seconds:
                    break
        return records, time.perf_counter() - t0

    def release(self):
        """Drop the program (its device state) once the window is read."""
        self.interp = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------
    def reference(self, records, dtype=torch.float64):
        """The plain reference's (ids, w, wn) for each record's nodes."""
        nodes = np.unique(np.concatenate([rec["nodes"] for rec in records]))
        around = reference.cells_around(self.cells, nodes)
        out = []
        for rec in records:
            r = rec["r"]

            def perm_of(ids, r=r):
                return self.field.perm(self.K0[ids], self.cents[ids], r)

            out.append(reference.gls_weights(
                self.points, self.cells, self.cell_type, rec["nodes"],
                around, perm_of, self.nflag, self.nval, dtype=dtype))
        return out

    def numbers(self, records, refs):
        """Per rebuild {weight_gap, neumann_gap, row_sum_gap} of the
        program's outputs against the reference's."""
        out = []
        for rec, ref in zip(records, refs):
            if self.delivery == "device_out":
                gaps = judge.dense_gaps(rec["rows"].cpu().numpy(), ref)
                rs = float(rec["row_sum_gap"])
            else:
                W, nw = rec["W"], np.asarray(rec["nw"])
                gaps = judge.csr_gaps(W[rec["nodes"]], nw[rec["nodes"]], ref)
                n_elem = self.topo["n_elem"]
                sums = np.asarray(W.sum(axis=1)).ravel() - n_elem * nw
                abs_sums = (np.asarray(abs(W).sum(axis=1)).ravel()
                            + np.abs(nw))
                rs = judge.row_sum_gap(sums, abs_sums, self.solved)
            out.append({"weight_gap": max(g[0] for g in gaps),
                        "neumann_gap": max(g[1] for g in gaps),
                        "row_sum_gap": rs})
        return out

    def control(self, records, refs, dtype=torch.float32):
        """The numbers of the reference computed in ``dtype`` put in the
        program's place, on the same nodes: the control."""
        out = []
        for rec, ref, low in zip(records, refs,
                                 self.reference(records, dtype)):
            ncols = max(len(ids) for ids, _, _ in low) + 1
            rows = np.zeros((len(low), ncols))
            for i, (ids, w, wn) in enumerate(low):
                rows[i, :len(w)] = w
                rows[i, -1] = wn
            gaps = judge.dense_gaps(rows, ref)
            solved = self.solved[rec["nodes"]]
            out.append({"weight_gap": max(g[0] for g in gaps),
                        "neumann_gap": max(g[1] for g in gaps),
                        "row_sum_gap": judge.row_sum_gap(
                            rows[:, :-1].sum(1), np.abs(rows).sum(1),
                            solved)})
        return out

