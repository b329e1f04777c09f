"""The comparison that decides `correct` fails what it must: the control
(the reference in TF32 in the program's place) and each fault the cells can
have, driven through the rest of a run on the CPU at toy sizes, with the
toy limits; the sound program passes the same limits."""

import pytest

from nfbench import faults, run
from nfbench.kinds import fkl_train, neutra_hmc, nf_sample, rkl_train
from nfbench.tests.toy import toy_cell

BROKEN = [
    ("funnel64_realnvp.neutra_hmc", neutra_hmc.Reference, "control"),
    ("funnel64_realnvp.neutra_hmc", faults.StuckHMC, "stuck"),
    ("funnel64_realnvp.neutra_hmc", faults.HalfBatchHMC, "half"),
    ("funnel64_realnvp.neutra_hmc", faults.AlteredHMC, "altered"),
    ("lj32_nsf_ar.fkl_train", fkl_train.Reference, "control"),
    ("lj32_nsf_ar.fkl_train", faults.StuckFKL, "stuck"),
    ("lj32_nsf_ar.fkl_train", faults.HalfBatchFKL, "half"),
    ("lj32_nsf_ar.nf_sample", nf_sample.Reference, "control"),
    ("lj32_nsf_ar.nf_sample", faults.AlteredSample, "altered"),
    ("funnel64_realnvp.rkl_train", rkl_train.Reference, "control"),
    ("funnel64_realnvp.rkl_train", faults.StuckRKL, "stuck"),
    ("funnel64_realnvp.rkl_train", faults.HalfBatchRKL, "half"),
]


@pytest.mark.parametrize("workload,system,kind", BROKEN,
                         ids=[f"{w.split('.')[1]}-{k}" for w, _, k in BROKEN])
@pytest.mark.parametrize("seed", [7, 2**31 + 99])
def test_broken_is_not_correct(bench, workload, system, kind, seed):
    line = run.run_cell(bench, toy_cell(bench, workload, seed), system)
    assert line["correct"] is False, line["checks"]
    assert line["failed"] >= 1


@pytest.mark.parametrize("workload", sorted({w for w, _, _ in BROKEN}))
@pytest.mark.parametrize("seed", [7, 2**31 + 99])
def test_sound_is_correct(bench, workload, seed):
    line = run.run_cell(bench, toy_cell(bench, workload, seed))
    assert line["correct"] is True, line["checks"]
