"""The particle cells (lj500_nsf_tcl.rkl_lj, lj32_nsf_ar.hmc_data) on the
CPU at toy sizes: each dry run gives a line of the required shape, the
control and every planted fault come out not correct and the sound
program correct, the shape counts equal hand counts, and the spline
reference's pieces agree with themselves.

Importing this module registers the two cells' toy sizes and limits in
nfbench/tests/toy.py's tables, beside the first four cells', so that the
tests that walk every cell of BENCHMARK.json find them."""

import json
import math

import pytest
import torch

from nfbench import faults_particles, run
from nfbench.kinds import hmc_data, rkl_particles
from nfbench.tests.toy import TOY, TOY_LIMITS, toy_cell

TCL = {"cfg": {"nparticles": 32, "layers": 2, "embed_dim": 16,
               "num_heads": 2, "nsplines": 4, "num_freqs": 2,
               "final_scale": 0.5}}
TOY.update({
    "lj500_nsf_tcl.rkl_lj": dict(TCL, traffic={
        "batch": 4, "check_chunk": 2, "control_chunk": 2, "bound_rows": 2,
        "trace_seconds": 0.2}),
    "lj32_nsf_ar.hmc_data": {"cfg": {"nparticles": 4}, "traffic": {
        "chains": 64, "adapt_chains": 32, "warmup": 10, "draws_per_call": 2,
        "check_chains": 16, "check_transitions": 4, "trace_seconds": 0.2}},
})
# between the program's toy readings (float32 against the float64
# reference: 1e-7 to 1e-5) and the control's (TF32: 1e-4 and up)
TOY_LIMITS.update({
    "lj500_nsf_tcl.rkl_lj": {"loss_gap": 1e-5, "grad_gap": 3e-5,
                             "grad_diff_median": 1e-4, "step_gap": 1e-2},
    "lj32_nsf_ar.hmc_data": {"hmc_pos_gap": 1e-4, "hmc_flip_margin": 1e-3,
                             "lp_gap": 1e-5},
})
CELLS = ["lj500_nsf_tcl.rkl_lj", "lj32_nsf_ar.hmc_data"]
BROKEN = [
    ("lj500_nsf_tcl.rkl_lj", rkl_particles.Reference, "control"),
    ("lj500_nsf_tcl.rkl_lj", faults_particles.StuckRKLParticles, "stuck"),
    ("lj500_nsf_tcl.rkl_lj", faults_particles.HalfBatchRKLParticles, "half"),
    ("lj32_nsf_ar.hmc_data", hmc_data.Reference, "control"),
    ("lj32_nsf_ar.hmc_data", faults_particles.StuckHMCData, "stuck"),
    ("lj32_nsf_ar.hmc_data", faults_particles.HalfBatchHMCData, "half"),
]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_line(bench, workload, trace):
    line = run.run_cell(bench, toy_cell(bench, workload, 2**31 + 12345,
                                        trace=trace))
    json.loads(json.dumps(line))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    e2e = {m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])}
    if trace:
        assert line["metrics"] == {}  # a CPU run measures no device
    else:
        assert set(line["metrics"]) == e2e
        for m in line["metrics"].values():
            assert math.isfinite(m["value"]) and m["value"] > 0


@pytest.mark.parametrize("workload,system,kind", BROKEN,
                         ids=[f"{w.split('.')[1]}-{k}" for w, _, k in BROKEN])
@pytest.mark.parametrize("seed", [7, 2**31 + 99])
def test_broken_is_not_correct(bench, workload, system, kind, seed):
    line = run.run_cell(bench, toy_cell(bench, workload, seed), system)
    assert line["correct"] is False, line["checks"]
    assert line["failed"] >= 1


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [7, 2**31 + 99])
def test_sound_is_correct(bench, workload, seed):
    line = run.run_cell(bench, toy_cell(bench, workload, seed))
    assert line["correct"] is True, line["checks"]


# ---------------------------------------------------------- shape counts
def tcl_ref():
    return run.load_file(run.HERE / "configs" / "lj500_nsf_tcl.py",
                         "nfbench.configs.lj500_nsf_tcl")


TCL_CFG = json.loads((run.HERE / "configs" / "lj500_nsf_tcl.json")
                     .read_text())
# one particle through one coupling layer: the embedding 32 x 256, each
# block's QKV 256 x 768, output 256 x 256 and MLP 2 x 256 x 1024,
# attention's Q K^T and P V 2 x 500 x 256, the output projection 256 x 49
TOKEN_MACS = 32 * 256 + 2 * (256 * 768 + 256 * 256 + 2 * 256 * 1024
                             + 2 * 500 * 256) + 256 * 49


def test_tcl_shape_counts_equal_hand_counts():
    ref = tcl_ref()
    assert ref.macs_per_token(TCL_CFG) == (TOKEN_MACS, 32 * 256)
    fwd = 128 * 500 * 24 * TOKEN_MACS
    assert ref.flops_sample(TCL_CFG, 128) == 2 * fwd
    assert ref.flops_rkl_step(TCL_CFG, 128) == 2 * (3 * fwd
                                                    - 128 * 500 * 32 * 256)
    assert ref.flops_attention_forward(TCL_CFG, 128) == \
        2 * 128 * 500 * 24 * 2 * 2 * 500 * 256
    # the configuration's arithmetic: 50.5 GFLOP a sample forward, ~19.4
    # TFLOP a step at batch 128
    assert ref.flops_sample(TCL_CFG, 1) == pytest.approx(50.5e9, rel=2e-3)
    assert ref.flops_rkl_step(TCL_CFG, 128) == pytest.approx(19.4e12,
                                                             rel=2e-3)


def test_tcl_parameters_are_38_4_million():
    sizes = [math.prod(s) for s in tcl_ref().shapes(TCL_CFG).values()]
    assert sum(sizes) == 24 * 1_598_513


def test_circular_byte_count_equals_hand_count():
    from nfbench.crqs_yardstick import crqs_bytes_ops

    n, k = 16, 16
    w = torch.zeros(n, k)      # 16 equal bins on [-1, 1]
    x = torch.full((n,), 0.1)  # bin 8
    x[8:] = 0.95               # bin 15: its right slope is knot 0's
    (fb, fo), (vb, vo) = crqs_bytes_ops(x, w, w, False, (-1.0, 1.0) * 2)
    column, params = 2 * 32, n * k * 4
    # a row of d is two sectors: rows 0-7 read d[8] and d[9], one sector;
    # rows 8-15 d[15] and d[0], both
    d_read = 8 * 32 + 8 * 2 * 32
    assert fb == 3 * column + 2 * params + d_read
    assert vb == 3 * column + column + 2 * params + d_read + 3 * params
    assert fo == n * (28 * k + 50) and vo == n * (36 * k + 200)


NEW_SPANS = {
    "attention_device_ms.rkl_lj": "tcl.attention",
    "mlp_device_ms.rkl_lj": "tcl.mlp",
    "crqs_device_ms.rkl_lj": "tcl.spline",
    "lj_energy_device_ms.rkl_lj": "lj.energy",
    "lj_energy_device_ms.hmc_data": "lj.energy",
}


@pytest.mark.parametrize("metric", sorted(NEW_SPANS))
def test_span_reader_reads_device_ms_a_unit_and_nothing_without(metric):
    from types import SimpleNamespace

    from nfbench.tests.test_bench_spans import reader, summary

    t = summary(NEW_SPANS[metric])
    assert reader(metric).read(SimpleNamespace(trace=t)) == pytest.approx(
        1e3 * 800e-9 / 2)
    t.ranges = [r for r in t.ranges if r[0] != NEW_SPANS[metric]]
    assert reader(metric).read(SimpleNamespace(trace=t)) is None


def test_attention_flop_share_reads_the_sdpa_span():
    from types import SimpleNamespace

    from nfbench.tests.test_bench_spans import reader, summary

    t = summary("tcl.sdpa")  # 800 ns of kernels in it, 2 units
    ctx = SimpleNamespace(trace=t, peak_fp32=1e12,
                          layer={"attention_flops_per_unit": 100.0})
    got = reader("attention_flop_share.rkl_lj").read(ctx)
    assert got == pytest.approx(100.0 * 200.0 / 800e-9 / 1e12)
    t.ranges = [r for r in t.ranges if r[0] != "tcl.sdpa"]
    assert reader("attention_flop_share.rkl_lj").read(ctx) is None


def test_new_references_load_nothing_of_the_program_nor_jax():
    from nfbench.tests.test_bench_imports import FORBIDDEN, loaded_after

    code = "\n".join([
        "import importlib.util, sys", "sys.path.insert(0, '.')",
        "import nfbench.ljref, nfbench.crqs_yardstick",
        "s = importlib.util.spec_from_file_location('r', "
        f"{str(run.HERE / 'configs' / 'lj500_nsf_tcl.py')!r})",
        "m = importlib.util.module_from_spec(s)", "s.loader.exec_module(m)"])
    loaded = loaded_after(code)
    assert "normalizingflow_tpu_torch" not in loaded
    assert not loaded & set(FORBIDDEN)
