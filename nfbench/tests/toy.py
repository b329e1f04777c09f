"""Toy sizes of every cell, for the CPU tests: the same code paths at widths
a test run holds (published widths run only on the card)."""

FUNNEL = {"cfg": {"dim": 8, "hidden_dim": 16, "fit_steps": 20,
                  "fit_batch": 64, "fit_warmup": 5}}
LJ = {"cfg": {"nparticles": 4, "hidden_dim": 16, "nsplines": 8}}

TOY = {
    "funnel64_realnvp.neutra_hmc": dict(FUNNEL, traffic={
        "chains": 256, "adapt_chains": 128, "chunk": 2, "warmup": 10,
        "check_chains": 64, "trace_seconds": 0.2}),
    "funnel64_realnvp.rkl_train": dict(FUNNEL, traffic={
        "batch": 64, "trace_seconds": 0.2}),
    "lj32_nsf_ar.fkl_train": dict(LJ, traffic={
        "batch": 32, "frames": 500, "trace_seconds": 0.2}),
    "lj32_nsf_ar.nf_sample": dict(LJ, traffic={
        "batch": 64, "check_rows": 16, "bound_rows": 32,
        "trace_seconds": 0.2}),
}

# Limits for the toy sizes, between the program's readings there (float32
# against the float64 reference: 1e-8 to 3e-6 on every number) and the
# control's (the reference in TF32: 1e-5 and up), so that a sound toy run
# is correct and a broken one is not.
TOY_LIMITS = {
    "funnel64_realnvp.neutra_hmc": {"hmc_pos_gap": 1e-4,
                                    "hmc_flip_margin": 1e-3,
                                    "lp_gap": 1e-5, "push_gap": 1e-5},
    "funnel64_realnvp.rkl_train": {"loss_gap": 1e-5, "grad_gap": 1e-5,
                                   "grad_diff_median": 1e-4,
                                   "step_gap": 1e-2},
    "lj32_nsf_ar.fkl_train": {"loss_gap": 1e-5, "grad_gap": 1e-5,
                              "grad_diff_median": 1e-4, "step_gap": 1e-4},
    "lj32_nsf_ar.nf_sample": {"x_gap": 5e-6, "logp_gap": 5e-6},
}


def toy_cell(bench, workload, seed, seconds=0.3, trace=0):
    from nfbench import run

    cell = run.Cell(bench, workload, seed, seconds, trace, "cpu",
                    overrides=TOY[workload])
    cell.limits = dict(TOY_LIMITS[workload])
    return cell
