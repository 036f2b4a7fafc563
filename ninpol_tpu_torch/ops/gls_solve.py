"""The GLS per-node solve: hand-written CUDA kernel, its wrapper, and its
plain PyTorch version.

Replaces ``ninpol_tpu/ops/pallas_chol.py::gls_solve_fused`` (the Pallas
kernel ``_solve_kernel``).  Per node it assembles the least-squares system
of the GLS stencil, builds a shifted CholeskyQR2 preconditioner in
float32, runs ``sweeps`` float64 refinement sweeps
``y += M (b - A^T A y)`` with ``b = e_{n-1}``, and returns

  w      (B, E)  the cell rows of ``A y``: the node's cell weights,
  wn     (B,)    sum_f nm_f * (Neumann row f . y): the true Neumann weight,
  rnorm  (B,)    ||dy|| / ||y|| of the last sweep, forced to 1 when a
                 Cholesky pivot was clamped (the exact-fallback signal).

Nodes that are not active (invalid, or with n_bface >= n_face) get zeros.

Inputs (float64 unless stated, natural layout, B nodes):
  dk (B,E,3)   centroid - x, masked by the cell-valid flag
  l1, l2 (B,F,3)  K@N of the face's first/second cell, interior faces
  t1m, tt (B,F,3) T1 and tau*T2, interior faces
  lb (B,F,3), nm (B,F)  K@N of the owner and the Neumann mean on boundary
                 faces; both None for an interior-only (no Neumann) unit
  pair (B,F,2) int32  the face's cell pair (second < 0: boundary face)
  ks (B,E) int32      the node's surrounding cells
  cv (B,E), fv (B,F), isneu (B,), valid (B,)  bool masks

Column basis: x_e at 3e + c (component c of cell e's gradient), the
constant (the node value) at 3E.  Rows: E cell rows, then three rows per
face (flux continuity, T1, tau*T2), then one Neumann row per face.

Precision split (kept from the TPU kernel): the preconditioner is float32
(equilibration, Gram1 + shift, clamped Cholesky and L1^-1, Q = A L1^-T,
Gram2, L2, and every application of M = Lc^T Lc with Lc = L2^-1 L1^-1);
the right-hand side, the solution, the structured residual with the
unscaled A, and all outputs are float64.  Breakdown detection reads both
rounds: dmax = max_k max(dinv1[k], dinv1[k] * dinv2[k]) > 3e4.

``rounds`` (ninpol_tpu's ``GLSInterpolation.precond_rounds``, 2 by
default) < 2 stops the preconditioner after its first round, as the TPU
kernel does (pallas_chol.py:643-669): M = D L1^-T L1^-1 D, breakdown from
dinv1 alone.  Its caller then runs two more sweeps (ninpol_tpu gls.py:277).

On a CPU tensor ``gls_solve`` runs ``gls_solve_reference``; on a CUDA
tensor it launches the kernel in ``csrc/gls_solve.cu`` (built with nvcc on
first use by ``cuda_lib.CudaLibrary``) or raises.  The plain version is
``cholqr2_solve`` on the plain versions of ``ops/cholqr.py``; the same
body on those wrappers, whose kernels run the preconditioner as separate
launches, is ninpol_tpu's unfused route (``_methods/gls.py``).  There
the flag reads max(|diag L1^-1|, |diag Lc|), the same numbers up to
rounding, and counts a non-finite value as clamped, as the kernel's
fmaxf-clamped pivots do.

Stage cuts: ``gls_solve_stage(stop, ...)`` launches the kernel's instance
that stops after the stage ``stop`` (a name of ``STAGES``; "all" is the
production kernel, the same outputs as ``gls_solve``) from its own
library, ``stage_library``: the same source built with
``-DGLS_SOLVE_STAGE_CUTS``, so that ``gls_solve`` builds and loads only
the production instances.  A cut gives zero w and wn and, as rnorm, each
active node's float64 sum of the entries of the state its last stage
ends on (``cholqr2_solve(..., stop=...)`` names them).
``tools/kernel_stages.py`` times the cuts.
"""
from __future__ import annotations

import ctypes

import torch

from .cholqr import PLAIN, cholqr_factors
from . import cuda_lib
from .cuda_lib import CudaLibrary, check_launch, check_tensor, on_card, stream

_FLOAT_ARGS = ("dk", "l1", "l2", "t1m", "tt")
_MASK_ARGS = ("cv", "fv", "isneu", "valid")

# the kernel's stage cuts, in the order it runs the stages (the Stop enum
# of csrc/gls_solve.cu); the one-round instance has no cut in round two
STAGES = ("floor", "rows", "gram1", "chol1", "q", "gram2", "chol2",
          "sweeps", "all")
_ROUND2_STAGES = ("q", "gram2", "chol2")


def stages(rounds=2):
    """The stage cuts of the kernel's ``rounds`` instance, in order."""
    return tuple(s for s in STAGES if rounds >= 2 or s not in _ROUND2_STAGES)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------
def node_active(pair, fv, valid):
    """Valid nodes that assemble a system: a node with n_bface >= n_face
    skips assembly (gls.pyx:266) and gets zero outputs."""
    bnd = fv & (pair[..., 1] < 0)
    return valid & ~(bnd.sum(dim=1) >= fv.sum(dim=1))


def incidence(pair, ks, cv, fv, isneu):
    """One-hot face->cell selectors (B, F, E) as float64: S1/S2 pick the
    first/second cell of each interior face, Sb the owner (first) cell of
    each boundary face of a Neumann node."""
    k1, k2 = pair[..., 0], pair[..., 1]
    interior = fv & (k2 >= 0)
    bnd = fv & (k2 < 0)
    m2 = interior[:, :, None] & cv[:, None, :]
    S1 = (ks[:, None, :] == torch.where(interior, k1, 0)[:, :, None]) & m2
    S2 = (ks[:, None, :] == torch.where(interior, k2, 0)[:, :, None]) & m2
    bmask = bnd & isneu[:, None]
    Sb = ((ks[:, None, :] == torch.where(bmask, k1, 0)[:, :, None])
          & bmask[:, :, None] & cv[:, None, :])
    f64 = torch.float64
    return S1.to(f64), S2.to(f64), Sb.to(f64)


def assemble(dk, l1, l2, t1m, tt, lb, S1, S2, Sb, cv, active):
    """Dense float64 system rows (B, m, n), m = E + 3F (+ F with Neumann
    rows), n = 3E + 1, zeroed for inactive nodes."""
    B, E, _ = dk.shape
    F = l1.shape[1]
    f64 = torch.float64
    eyeE = torch.eye(E, dtype=f64, device=dk.device)
    cell_grad = torch.einsum("ef,bec->befc", eyeE, dk).reshape(B, E, 3 * E)
    cell_rows = torch.cat([cell_grad, cv.to(f64)[:, :, None]], dim=2)
    rows1 = (torch.einsum("bfe,bfc->bfec", -S1, l1)
             + torch.einsum("bfe,bfc->bfec", S2, l2))
    dS = S2 - S1
    rows2 = torch.einsum("bfe,bfc->bfec", dS, t1m)
    rows3 = torch.einsum("bfe,bfc->bfec", dS, tt)
    face_rows = torch.stack([rows1, rows2, rows3], dim=2).reshape(
        B, 3 * F, 3 * E)
    zcol = torch.zeros((B, 3 * F, 1), dtype=f64, device=dk.device)
    blocks = [cell_rows, torch.cat([face_rows, zcol], dim=2)]
    if lb is not None:
        neu_rows = torch.einsum("bfe,bfc->bfec", -Sb, lb).reshape(
            B, F, 3 * E)
        blocks.append(torch.cat([neu_rows, zcol[:, :F]], dim=2))
    return torch.cat(blocks, dim=1) * active.to(f64)[:, None, None]


def cholqr2_solve(pieces, dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv, fv,
                  isneu, valid, *, sweeps=3, tiny=1e-12, shift=1.5e-5,
                  rounds=2, stop="all"):
    """The solve as batched dense torch ops around the four preconditioner
    pieces of ops/cholqr.py (``cholqr.KERNELS`` or ``cholqr.PLAIN``): the
    dense float64 A, the float32 factors of ``cholqr_factors`` (of its
    ``rounds``), then

      y = M e_n, then ``sweeps`` times y += M (e_n - A^T A y)

    in float64 with M(r) = D Lc^T Lc (D r), D r rounded to float32 and the
    float32 image scaled back in float64 (ninpol_tpu gls.py:643-646); the
    kernel scales in float32, a rounding of the preconditioner that the
    sweeps absorb.  rnorm = ||dy|| / max(||y||, 1e-300), 1 on a ``sick``
    node.

    ``stop`` (a stage of ``stages(rounds)`` but "all") ends the solve as
    the kernel's stage cut does: zero w and wn, and as rnorm each active
    node's float64 sum of the entries of that stage's state: the inputs
    and the incidence's cell slots (-1 for none) ("floor"), A in float32
    ("rows"), G1, L1^-1, Q = As L1^-T, G2, Lc, y after the sweeps."""
    B, E, _ = dk.shape
    F = l1.shape[1]
    n = 3 * E + 1
    f32, f64 = torch.float32, torch.float64
    if stop not in stages(rounds):
        raise ValueError(f"no stage {stop!r} at rounds={rounds}: "
                         f"{stages(rounds)}")
    S1, S2, Sb = incidence(pair, ks, cv, fv, isneu)
    active = node_active(pair, fv, valid)

    def cut(total):
        zero = torch.zeros((), dtype=f64, device=dk.device)
        return (torch.zeros((B, E), dtype=f64, device=dk.device),
                torch.zeros(B, dtype=f64, device=dk.device),
                torch.where(active, total, zero))

    def entries(x):
        return x.to(f64).flatten(1).sum(dim=1)

    if stop == "floor":
        # without Neumann rows no face has an owner slot
        slots = [torch.where(S.any(dim=2), S.argmax(dim=2), -1)
                 for S in (S1, S2, Sb if lb is not None else 0 * Sb)]
        return cut(sum(entries(x) for x in (dk, l1, l2, t1m, tt, lb, nm,
                                             *slots) if x is not None))
    A = assemble(dk, l1, l2, t1m, tt, lb, S1, S2, Sb, cv, active)
    if stop == "rows":
        return cut(entries(A.to(f32)))
    pc = cholqr_factors(A, pieces, tiny, shift, rounds)
    if stop == "q":
        return cut(entries(torch.bmm(pc["As"], pc["Li1"].transpose(1, 2))))
    factor = {"gram1": "G1", "chol1": "Li1", "gram2": "G2", "chol2": "Lc"}
    if stop in factor:
        return cut(entries(pc[factor[stop]]))
    prec_apply = pieces[3]
    D, Lc = pc["D"].to(f64), pc["Lc"]

    def M(r):
        return prec_apply(Lc, (r * D).to(f32)).to(f64) * D

    # ---- float64 refinement sweeps
    b = torch.zeros((B, n), dtype=f64, device=dk.device)
    b[:, n - 1] = 1.0
    y = M(b)
    dy = y
    for _ in range(sweeps):
        dy = M(b - mul_G(A, y))
        y = y + dy
    if stop == "sweeps":
        return cut(y.sum(dim=1))
    rnorm = torch.linalg.vector_norm(dy, dim=1) / torch.clamp_min(
        torch.linalg.vector_norm(y, dim=1), 1e-300)
    rnorm = torch.where(pc["sick"], 1.0, rnorm)
    return solve_outputs(A, y, rnorm, nm, active, E, F)


def mul_G(A, y):
    """A^T (A y) in float64, without forming A^T A."""
    return torch.einsum("bmn,bm->bn", A, torch.einsum("bmn,bn->bm", A, y))


def solve_outputs(A, y, rnorm, nm, active, E, F):
    """The solve's outputs from its solution y of (A^T A) y = e_n: the
    cell rows of A y (the node's cell weights), sum_f nm_f * (Neumann row
    f . y) (0 without Neumann rows) and rnorm, each zeroed on inactive
    nodes."""
    t = torch.einsum("bmn,bn->bm", A, y)
    w = t[:, :E]
    if nm is not None:
        wn = torch.sum(nm * t[:, E + 3 * F:], dim=1)
    else:
        wn = torch.zeros_like(rnorm)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    return (torch.where(active[:, None], w, zero),
            torch.where(active, wn, zero),
            torch.where(active, rnorm, zero))


def gls_solve_reference(dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv, fv,
                        isneu, valid, *, sweeps=3, tiny=1e-12,
                        shift=1.5e-5, rounds=2, stop="all"):
    """Plain PyTorch version of the kernel (of its stage cut ``stop``): the
    same function, as batched dense torch ops (dense A, explicit factors
    from the plain versions of ops/cholqr.py, so it stays plain on a CUDA
    tensor)."""
    return cholqr2_solve(PLAIN, dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv,
                         fv, isneu, valid, sweeps=sweeps, tiny=tiny,
                         shift=shift, rounds=rounds, stop=stop)


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------
def _bind_common(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gls_solve_workspace_floats.argtypes = [ci, ci, ci]
    lib.gls_solve_workspace_floats.restype = ctypes.c_longlong
    lib.gls_solve_occupancy.argtypes = [
        ci, ci, ci, ci, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ci), ctypes.POINTER(ci), ctypes.POINTER(ci),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.gls_solve_occupancy.restype = ci
    # the inputs, outputs and workspace of a launch
    return [vp] * 13 + [vp] * 3 + [vp, ctypes.c_longlong]


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gls_solve_launch.argtypes = (
        _bind_common(lib) + [ci] * 6 + [ctypes.c_double] * 2 + [vp])
    lib.gls_solve_launch.restype = ci


def _bind_stages(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gls_solve_stage_launch.argtypes = (
        _bind_common(lib) + [ci] * 7 + [ctypes.c_double] * 2 + [vp])
    lib.gls_solve_stage_launch.restype = ci


# the production kernel (its kAll instances), and apart from it, built
# only when a cut is launched, the same source with every stage cut
library = CudaLibrary("gls_solve", _bind)
stage_library = CudaLibrary("gls_solve", _bind_stages,
                            define="GLS_SOLVE_STAGE_CUTS")


def occupancy(E, F, with_neumann, rounds=2):
    """The kernel's launch for one (E, F, with_neumann) class and
    preconditioner rounds on the current card (``cuda_lib.occupancy``):
    its dynamic shared memory bytes, threads, blocks an SM holds,
    registers and local (spill) bytes a thread."""
    return cuda_lib.occupancy(library.get().gls_solve_occupancy,
                              f"gls_solve occupancy query (E={E}, F={F}, "
                              f"rounds={rounds})", E, F, int(with_neumann),
                              int(rounds))


def _check_inputs(t):
    """Raise on anything the kernel does not take."""
    dk = t["dk"]
    if dk.dim() != 3 or dk.shape[2] != 3:
        raise ValueError(f"dk must be (B, E, 3), got {tuple(dk.shape)}")
    B, E, _ = dk.shape
    F = t["l1"].shape[1] if t["l1"].dim() == 3 else -1
    want = {"dk": (B, E, 3), "l1": (B, F, 3), "l2": (B, F, 3),
            "t1m": (B, F, 3), "tt": (B, F, 3), "pair": (B, F, 2),
            "ks": (B, E), "cv": (B, E), "fv": (B, F), "isneu": (B,),
            "valid": (B,)}
    dtypes = dict.fromkeys(_FLOAT_ARGS, torch.float64)
    dtypes.update(dict.fromkeys(_MASK_ARGS, torch.bool))
    dtypes.update(pair=torch.int32, ks=torch.int32)
    if (t["lb"] is None) != (t["nm"] is None):
        raise ValueError("lb and nm must both be given or both be None")
    if t["lb"] is not None:
        want.update(lb=(B, F, 3), nm=(B, F))
        dtypes.update(lb=torch.float64, nm=torch.float64)
    for name, shape in want.items():
        check_tensor(name, t[name], shape, dtypes[name], dk.device)
    return B, E, F


def gls_solve(dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv, fv, isneu, valid,
              *, sweeps=3, tiny=1e-12, shift=1.5e-5, rounds=2):
    """Solve B GLS node systems; see the module docstring for the
    contract.  CPU tensors run the plain version, CUDA tensors the
    kernel; ``gls_solve.launches`` counts kernel launches."""
    t = dict(dk=dk, l1=l1, l2=l2, t1m=t1m, tt=tt, lb=lb, nm=nm, pair=pair,
             ks=ks, cv=cv, fv=fv, isneu=isneu, valid=valid)
    B, E, F = _check_inputs(t)
    if not on_card(dk, "gls_solve"):
        return gls_solve_reference(**t, sweeps=sweeps, tiny=tiny,
                                   shift=shift, rounds=rounds)
    out = _launch(t, B, E, F, sweeps, tiny, shift, rounds)
    gls_solve.launches += 1
    return out


def gls_solve_stage(stop, dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv, fv,
                    isneu, valid, *, sweeps=3, tiny=1e-12, shift=1.5e-5,
                    rounds=2):
    """The kernel's ``rounds`` instance cut after stage ``stop`` (a name of
    ``stages(rounds)``; see the module docstring).  CPU tensors run the
    plain version, CUDA tensors the cut; ``gls_solve_stage.launches``
    counts its launches."""
    if stop not in stages(rounds):
        raise ValueError(f"no stage {stop!r} at rounds={rounds}: "
                         f"{stages(rounds)}")
    t = dict(dk=dk, l1=l1, l2=l2, t1m=t1m, tt=tt, lb=lb, nm=nm, pair=pair,
             ks=ks, cv=cv, fv=fv, isneu=isneu, valid=valid)
    B, E, F = _check_inputs(t)
    if not on_card(dk, "gls_solve_stage"):
        return gls_solve_reference(**t, sweeps=sweeps, tiny=tiny,
                                   shift=shift, rounds=rounds, stop=stop)
    out = _launch(t, B, E, F, sweeps, tiny, shift, rounds,
                  STAGES.index(stop))
    gls_solve_stage.launches += 1
    return out


def _launch(t, B, E, F, sweeps, tiny, shift, rounds, stop=None):
    """One launch on the inputs ``t`` (checked): the production entry, or
    the entry of the stage cuts at the Stop ``stop``."""
    dk, lb = t["dk"], t["lb"]
    f64 = torch.float64
    w = torch.empty((B, E), dtype=f64, device=dk.device)
    wn = torch.empty(B, dtype=f64, device=dk.device)
    rnorm = torch.empty(B, dtype=f64, device=dk.device)
    if B == 0:
        return w, wn, rnorm
    lib = (library if stop is None else stage_library).get()
    with_neumann = lb is not None
    with torch.cuda.device(dk.device):
        ws_floats = lib.gls_solve_workspace_floats(E, F, int(with_neumann))
        ws = (torch.empty(B * ws_floats, dtype=torch.float32,
                          device=dk.device) if ws_floats else None)
        ptr = lambda x: None if x is None else x.data_ptr()
        args = ([ptr(t[k]) for k in ("dk", "l1", "l2", "t1m", "tt", "lb",
                                     "nm", "pair", "ks", "cv", "fv",
                                     "isneu", "valid")]
                + [ptr(w), ptr(wn), ptr(rnorm), ptr(ws), ws_floats,
                   B, E, F, int(with_neumann), int(sweeps), int(rounds)])
        tail = [float(tiny), float(shift), stream(dk.device)]
        if stop is None:
            err = lib.gls_solve_launch(*args, *tail)
        else:
            err = lib.gls_solve_stage_launch(*args, stop, *tail)
    what = "gls_solve" if stop is None else f"gls_solve_stage {STAGES[stop]}"
    check_launch(err, f"{what} (B={B}, E={E}, F={F}, "
                      f"with_neumann={with_neumann}, rounds={rounds})")
    return w, wn, rnorm


gls_solve.launches = 0
gls_solve_stage.launches = 0
