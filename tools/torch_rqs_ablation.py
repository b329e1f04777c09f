"""What bounds the RQS kernels on the GPU: csrc/rqs.cu against ablations of
itself, and against other versions of the source, timed in turns.

Builds, each into its own library under normalizingflow_tpu_torch/_build/:

  * kernel  : csrc/rqs.cu as it is;
  * no_map  : the same with the rational-quadratic map, its reverse and the
              derivative-logit softplus taken out (the knots, the bin search
              and every load and store stay), to price the map;
  * f32_exps: the softmax's exps in float32 (not a valid kernel: its knots
              miss the tolerance), to price the float64 exps;
  * any NAME=PATH given on the command line, e.g. an older csrc/rqs.cu
    (`git show <commit>:normalizingflow_tpu_torch/csrc/rqs.cu > old.cu`);
    a source without the VJP entry point is timed on the forward only.

The two ablations replace exact passages of the source: when csrc/rqs.cu
no longer holds one, the tool stops and prints the passage it looked for.

Then times the forward and the VJP of each at (262144, 32) and (65536, 32),
inverse, B = 6 (the spline line's shapes) with chip_smoke.py's CUDA-event
timer (L2 flushed), in turns A B .. B A, and reports whether each variant's
outputs equal the kernel's bit for bit.

    python tools/torch_rqs_ablation.py [NAME=PATH ...]

Needs a CUDA device and nvcc. Imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from normalizingflow_tpu_torch.ops import _build  # noqa: E402
from normalizingflow_tpu_torch.ops import rqs as ops_rqs  # noqa: E402

SHAPES = [(262144, 32), (65536, 32)]

NO_MAP = [
    ("rq_map<kInverse>(me.bin, out, logdet);",
     "out = me.bin.cw; logdet = me.bin.wb;"),
    ("const Bin g = map_vjp<kInverse>(me.bin, me.inside ? gyv : 0.0,\n"
     "                                  me.inside ? a.gld[me.row] : 0.0);",
     "Bin g = me.bin; g.xs = gyv;"),
    ("c.min_d + softplus(static_cast<double>(\n"
     "                                          drow[me.idx - 1]))",
     "static_cast<double>(drow[me.idx - 1])"),
    ("c.min_d + softplus(static_cast<double>(\n"
     "                                              drow[me.idx]))",
     "static_cast<double>(drow[me.idx])"),
    ("c.min_d + softplus(raw_l)", "raw_l"),
    ("c.min_d + softplus(raw_r)", "raw_r"),
]
F32_EXPS = [("exp(static_cast<double>(v[j]) - mx)",
             "static_cast<double>(__expf(v[j] - static_cast<float>(mx)))")]


def edited(src, edits):
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"ablation edit no longer applies: {old!r}")
        src = src.replace(old, new)
    return src


def check(err):
    if err != 0:
        raise RuntimeError(f"kernel launch failed: CUDA error {err}")


def build(sources):
    """{name: ctypes library} for {name: CUDA source text}: each text is
    written to _build/ablation/<name>.cu and built by ops/_build.py, nvcc in
    parallel."""
    src_dir = _build.BUILD_DIR / "ablation"
    src_dir.mkdir(parents=True, exist_ok=True)
    for name, text in sources.items():
        (src_dir / f"{name}.cu").write_text(text)
    _build.build(list(sources), src_dir)
    return {name: ops_rqs.bind(_build.load(name, src_dir))
            for name in sources}


def main(argv):
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    src = (_build.SOURCE_DIR / f"{ops_rqs.KERNEL}.cu").read_text()
    sources = {"kernel": src, "no_map": edited(src, NO_MAP),
               "f32_exps": edited(src, F32_EXPS)}
    for arg in argv:
        name, path = arg.split("=", 1)
        sources[name] = Path(path).read_text()
    print(cs.device_line(), flush=True)
    libs = build(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    bounds = cs.RQS_BOUNDS["sym"]
    consts = ops_rqs._consts(True, *bounds)
    for n, k in SHAPES:
        x, w, h, d = cs.rqs_inputs(n, k, bounds, True, gen)
        gy, gld = (torch.randn(n, device="cuda", generator=gen)
                   for _ in range(2))
        outs = {}
        order = list(libs) + list(libs)[::-1]
        for name in order:
            lib = libs[name]
            y, ld, gx = (torch.empty_like(x) for _ in range(3))
            gw, gh, gd = (torch.empty_like(t) for t in (w, h, d))

            def fwd():
                check(lib.nf_rqs_f32(
                    x.data_ptr(), w.data_ptr(), h.data_ptr(), d.data_ptr(),
                    y.data_ptr(), ld.data_ptr(), n, k, *consts, stream))

            def vjp():
                check(lib.nf_rqs_vjp_f32(
                    x.data_ptr(), w.data_ptr(), h.data_ptr(), d.data_ptr(),
                    gy.data_ptr(), gld.data_ptr(), gx.data_ptr(),
                    gw.data_ptr(), gh.data_ptr(), gd.data_ptr(), n, k,
                    *consts, stream))

            ms = cs.cuda_time_ms(fwd, flush=flush)
            line = f"({n},{k}) {name}: fwd {ms:.5f} ms"
            out = [y, ld]
            if hasattr(lib, "nf_rqs_vjp_f32"):
                ms = cs.cuda_time_ms(vjp, reps=20, flush=flush)
                line += f", vjp {ms:.5f} ms"
                out += [gx, gw, gh, gd]
            torch.cuda.synchronize()
            outs[name] = [t.nan_to_num() for t in out]
            print(line, flush=True)
        for name, out in outs.items():
            same = [torch.equal(a, b) for a, b in zip(out, outs["kernel"])]
            print(f"({n},{k}) {name}: outputs equal to the kernel's bit for "
                  f"bit: {all(same)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
