"""How many nodes the "refined" GLS solver leaves to the exact fallback,
in ninpol_tpu and in the PyTorch port, on the same systems.

Every class of the port's "refined" route on an ALH mesh (seed 0, every
point a target) goes, as one float64 A, through the port's
``ops/solve.py::solve_normal_refined`` and through ninpol_tpu's
``solve_normal_refined_ops`` (jitted, XLA on the CPU), both at
``n_refine`` sweeps; a node falls back where its error estimate is above
1e-11.  Prints one JSON line a class and a total.

Run: JAX_PLATFORMS=cpu python -m tests.utils.refined_fallback tetra 6 [n_refine]
"""
import json
import sys

import numpy as np
import torch


def main(fam, n, n_refine=2):
    import jax
    import jax.numpy as jnp
    import ninpol_tpu_torch
    from ninpol_tpu.ops.solve import solve_normal_refined_ops
    from ninpol_tpu.utils import meshgen
    from ninpol_tpu_torch._methods.gls import csne_system, gls_gather
    from ninpol_tpu_torch.ops.gls_solve import mul_G
    from ninpol_tpu_torch.ops.solve import solve_normal_refined
    from tests.utils.cases import ALHCase

    case = ALHCase()
    case.assign_mesh_properties(meshgen.FAMILIES[fam](n), seed=0)
    port = ninpol_tpu_torch.Interpolator(device="cpu")
    port.load_mesh(mesh_obj=case.mesh)
    dg = port.device_grid
    classes, face_table, nflag = port.gls.plan(
        dg, port.cells_data, port.points_data, port.variable_to_index,
        case.name, np.arange(port.grid.n_points))

    def ref_solve(A64, b64):
        return solve_normal_refined_ops(
            A64.astype(jnp.float32), b64,
            lambda v: jnp.einsum("bmn,bm->bn", A64,
                                 jnp.einsum("bmn,bn->bm", A64, v)),
            n_refine=n_refine)

    total = {"mesh": f"{fam}_mesh({n})", "n_refine": n_refine, "active": 0,
             "fallback_port": 0, "fallback_ninpol_tpu": 0}
    for c in classes:
        inp, _ = gls_gather(dg, face_table, nflag,
                            torch.as_tensor(c["nodes"]), c["E"], c["F"],
                            c["with_neumann"], tau_guard="norm")
        A, active = csne_system(**{k: v for k, v in inp.items()
                                   if k != "nm"})
        b = torch.zeros(A.shape[::2], dtype=torch.float64)
        b[:, -1] = 1.0
        _, rn = solve_normal_refined(A, b, lambda v: mul_G(A, v), n_refine)
        _, rr = jax.jit(ref_solve)(jnp.asarray(A.numpy()),
                                   jnp.asarray(b.numpy()))
        act = active.numpy()
        rn, rr = rn.numpy()[act], np.asarray(rr)[act]
        row = {"E": c["E"], "F": c["F"], "with_neumann": c["with_neumann"],
               "active": int(act.sum()),
               "fallback_port": int((~(rn <= 1e-11)).sum()),
               "fallback_ninpol_tpu": int((~(rr <= 1e-11)).sum()),
               "median_rnorm_port": float(np.median(rn)),
               "median_rnorm_ninpol_tpu": float(np.median(rr))}
        print(json.dumps(row), flush=True)
        for k in ("active", "fallback_port", "fallback_ninpol_tpu"):
            total[k] += row[k]
    print(json.dumps(total), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]),
         *(int(a) for a in sys.argv[3:4]))
