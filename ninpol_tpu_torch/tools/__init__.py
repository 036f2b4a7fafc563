"""Scripts that measure the port on the card.

``SITES`` maps each ``pl.pallas_call`` site of the repo's TPU probes
(tools/*.py, "file:line") to the port's answer: (status, by whom).
"ported" sites have a kernel or a stage cut of the port that computes
what the site computes; "answered" ones are timed by an existing kernel
or stage cut.
"""

_STAGES = "kernel 1's stage cuts (kernel_stages.py)"

SITES = {
    # the stage timings and the per-step floor: kernel 1's stage cuts
    "kernel_stages.py:70": ("ported", f"{_STAGES}: gram1"),
    "kernel_stages.py:84": ("ported", f"{_STAGES}: chol1"),
    "kernel_stages.py:102": ("ported", f"{_STAGES}: q"),
    "kernel_stages.py:121": ("ported", f"{_STAGES}: sweeps"),
    **{f"r5_floor_probe.py:{line}": ("ported", f"{_STAGES}: floor")
       for line in (76, 98, 124, 143, 211, 233)},
    # the factorizations (factor_probes.py)
    "trsm_probe.py:93": ("answered", f"{_STAGES}: chol1 to gram2; "
                         "chol_linv_f32 + round2_gram_f32"),
    "trsm_probe.py:129": ("ported", "chol_trsm_gram"),
    "trsm_probe.py:192": ("ported", "chol_trsm_gram (tensor-core factor)"),
    "chol_mxu_probe.py:73": ("ported", "chol_linv_tc"),
    "chol_tri_probe.py:59": ("answered", f"{_STAGES}: chol1 "
                             "(chol_linv_rows_inplace keeps to the "
                             "triangle)"),
    "trisolve_probe.py:79": ("ported", "chol_factor"),
    "trisolve_probe.py:95": ("answered", "chol_linv_f32 with P; "
                             f"{_STAGES}: chol2"),
    "trisolve_probe.py:115": ("answered", "4 x prec_apply_f32"),
    "trisolve_probe.py:162": ("ported", "chol_trisolve_apply"),
    # the Gram and Q stages on tensor cores (mxu_probes.py)
    "mxu_probe.py:108": ("ported", "node_transpose (in)"),
    "mxu_probe.py:123": ("ported", "gram_tc (node-major)"),
    "mxu_probe.py:138": ("ported", "gram_tc (bf16)"),
    "mxu_probe.py:150": ("ported", "node_transpose (out)"),
    "mxu_probe.py:166": ("ported", "gram_tc (node-minor)"),
    "mxu_probe.py:185": ("ported", "q_tc"),
    "mxu_probe.py:215": ("ported", "gram_q_gram_tc"),
    "mxu_probe.py:230": ("answered", "gram_f32 (gram_reg_kernel); "
                         f"{_STAGES}: gram1"),
    "mxu_probe.py:241": ("answered", f"{_STAGES}: q; round2_gram_f32 "
                         "(Q with G2)"),
    "r5_mxu_shapes.py:84": ("ported", "gram_tc (shapes)"),
    # kernel 1's input stream (input_probes.py)
    "r5_layout_probe.py:60": ("ported", "input_sum (natural)"),
    "r5_layout_probe.py:72": ("ported", "input_sum (packed)"),
    "r5_layout_probe.py:85": ("ported", "input_sum (wide, bulk)"),
    "r5_layout_probe.py:105": ("ported", "input_sum (multi, minor)"),
    "r5_overlap_probe.py:100": ("ported", "overlap_probe"),
}


def site_of(kernel):
    """The "tools/file:line" site that the port's kernel ``kernel``
    (SITES' "by") ports."""
    for site, (status, by) in SITES.items():
        if status == "ported" and by == kernel:
            return f"tools/{site}"
    raise KeyError(f"no tools/ site is ported by {kernel!r}")
