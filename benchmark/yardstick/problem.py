"""The problem the benchmark hands to the program and to the reference.

bench.py's problem, frozen and seeded by the run's seed: the ALH
full-tensor permeability, u = x^2 + y^2 + z^2 at the cell centres, a
seeded Dirichlet/Neumann split of the boundary faces and the manufactured
Neumann flux -(K grad u).n of the base K averaged onto the points.  Each
rebuild takes a fresh realization K_r = K * exp(sigma g_r) of a smooth
unit-variance Gaussian field g_r: a combination of cosine modes made once
per run, with new weights drawn from (seed, rebuild index).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import topology

# the streams drawn from a run's seed, one per use
MODES, SPLIT, WEIGHTS, SAMPLE, WARM = range(5)


def rng(seed, stream, *index):
    """The numpy generator of ``stream`` (and ``index``) of a seed."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream, *index])


def alh_k(cents):
    """bench.py's ALH permeability at the cell centres, (n, 9) row-major
    3x3: K = (|x|^2 + 1) I - x x^T."""
    x, y, z = cents[:, 0], cents[:, 1], cents[:, 2]
    one = x * 0 + 1
    return np.stack([y * y + z * z + one, -x * y, -x * z,
                     -x * y, x * x + z * z + one, -y * z,
                     -x * z, -y * z, x * x + y * y + one], axis=1)


def diff_mag(perm):
    """(1 - 3 det(K)^(1/3) / tr(K))^2 (ninpol interpolator.pyx:501-509)."""
    K = np.reshape(perm, (-1, 3, 3))
    return (1 - 3 * np.linalg.det(K) ** (1 / 3) / np.trace(
        K, axis1=1, axis2=2)) ** 2


def boundary_problem(points, topo, perm, seed):
    """The seeded boundary conditions of bench.py:67-101: half of the
    boundary faces, drawn from the seed, are Dirichlet and the rest
    Neumann; a boundary point is Neumann where its Neumann faces outnumber
    its Dirichlet ones.  The Neumann value of a point is the mean over its
    faces (all of them, interior faces counting 0) of -(K grad u).n on
    its boundary faces, with the owner's base K.  Returns (neumann_flag,
    neumann_value) per point."""
    n_points = len(points)
    bpts, owner = topo["bface_points"], topo["bface_cell"]
    nb = len(owner)
    dirichlet = np.zeros(nb, bool)
    dirichlet[rng(seed, SPLIT).choice(nb, nb // 2, replace=False)] = True
    on = bpts >= 0
    sign = np.where(dirichlet, 1, -1)[:, None] * on
    vote = np.bincount(bpts[on], weights=sign[on], minlength=n_points)
    is_bpoint = topo["n_bface"] > 0
    nflag = (is_bpoint & (vote < 0)).astype(np.float64)

    fc = topology.face_centers(points, bpts)
    normal = topology.face_normals(points, bpts)
    K = np.reshape(perm, (-1, 3, 3))[owner]
    flux = -np.einsum("fij,fj->fi", K, 2 * fc)
    nval = np.einsum("fi,fi->f", flux, normal)
    sums = np.bincount(bpts[on], weights=np.broadcast_to(
        nval[:, None], bpts.shape)[on], minlength=n_points)
    neumann = np.where(nflag > 0,
                       sums / np.maximum(topo["n_face"], 1), 0.0)
    return nflag, neumann


class Field:
    """The run's permeability realizations: ``n_modes`` cosine modes with
    wave numbers uniform in [cycles_min, cycles_max] cycles across the
    unit cube, random directions and phases (from the seed), and per
    rebuild r new N(0, 2 / n_modes) weights, so g_r has unit variance."""

    def __init__(self, seed, n_modes, cycles_min, cycles_max, sigma):
        g = rng(seed, MODES)
        d = g.normal(size=(n_modes, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        cyc = g.uniform(cycles_min, cycles_max, size=n_modes)
        self.wave = 2 * math.pi * cyc[:, None] * d
        self.phase = g.uniform(0, 2 * math.pi, size=n_modes)
        self.seed, self.n_modes, self.sigma = seed, n_modes, sigma

    def weights(self, r):
        return rng(self.seed, WEIGHTS, r).normal(
            0.0, math.sqrt(2.0 / self.n_modes), size=self.n_modes)

    def g(self, cents, r):
        """g_r at ``cents`` (numpy or torch (n, 3) float64), elementwise
        in a fixed order, so a subset of cells reads the same bits."""
        a = self.weights(r)
        out = cents[:, 0] * 0.0
        for j in range(self.n_modes):
            k = self.wave[j]
            arg = (cents[:, 0] * k[0] + cents[:, 1] * k[1]
                   + cents[:, 2] * k[2] + self.phase[j])
            out = out + a[j] * (torch.cos(arg) if torch.is_tensor(arg)
                                else np.cos(arg))
        return out

    def perm(self, base, cents, r):
        """K_r = base * exp(sigma g_r) at ``cents``, (n, 9)."""
        s = self.sigma * self.g(cents, r)
        s = torch.exp(s) if torch.is_tensor(s) else np.exp(s)
        return base * s[:, None]
