"""What bounds the accept kernel on the GPU: csrc/accept_select.cu against an
ablation of itself and against other versions of the source, timed in turns.

Builds, each into its own library under normalizingflow_tpu_torch/_build/:

  * kernel : csrc/accept_select.cu as it is (the fused transition tail, q
             loaded with the rest before the decision);
  * late_q : the same with q loaded after the decision, by accepted rows
             only (kSpeculativeQ = false);
  * any NAME=PATH given on the command line, e.g. an older source
    (`git show <commit>:normalizingflow_tpu_torch/csrc/accept_select.cu >
    _scratch/old.cu`). A source without the fused entry point but with the
    unfused `nf_accept_select_f32` of earlier versions is timed twice: its
    kernel alone, on p and h_old computed beforehand ("NAME alone"), and
    with the torch half-kick and h_old before it ("NAME + torch"), which is
    the whole function the fused kernel computes.

Then, at chip_smoke.py's KERNEL_SHAPES on its fused inputs at about 0.81
accepts (the main path's rate), times each with chip_smoke.py's CUDA-event
timer (L2 flushed; the fused kernels in place, the state restored before
each call outside the timed region), in turns A B .. B A, and reports
whether each variant's outputs agree with the kernel's: bit for bit for
the fused variants; for the unfused ones, the rows whose decision differs
(the kinetic energies round in another order) and whether every other row
selects the same. Beside them, as a yardstick of the timer and the card
and not of the function, one torch copy that moves as many bytes as the
fused function must.

    python tools/torch_accept_ablation.py [NAME=PATH ...]

Needs a CUDA device and nvcc. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import sys
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from normalizingflow_tpu_torch.ops import _build  # noqa: E402
from normalizingflow_tpu_torch.ops import hmc as ops_hmc  # noqa: E402

LATE_Q = [("constexpr bool kSpeculativeQ = true;",
           "constexpr bool kSpeculativeQ = false;")]
UNFUSED = "nf_accept_select_f32"  # the entry point of earlier sources
UNFUSED_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])


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
    """{name: (entry point, fused?)} for {name: CUDA source text}: each text
    is written to _build/ablation/<name>.cu and built by ops/_build.py, nvcc
    in parallel."""
    src_dir = _build.BUILD_DIR / "ablation"
    src_dir.mkdir(parents=True, exist_ok=True)
    for name, text in sources.items():
        (src_dir / f"{name}.cu").write_text(text)
    _build.build(list(sources), src_dir)
    entries = {}
    for name in sources:
        lib = _build.load(name, src_dir)
        if hasattr(lib, ops_hmc.ENTRY):
            entries[name] = (ops_hmc.bind(lib), True)
        else:
            fn = getattr(lib, UNFUSED)
            fn.argtypes = UNFUSED_ARGTYPES
            fn.restype = ctypes.c_int
            entries[name] = (fn, False)
    return entries


class Arm:
    """One timed variant at one shape: `run` computes the function into this
    arm's own outputs, `restore` resets what an in-place run changed."""

    def __init__(self, fn, fused, with_torch, args, stream):
        (self.q, self.p_half, self.eps, self.g_new, self.mom, self.pos,
         self.grad, self.state_lp, self.lp_new, self.log_u, self.inv_m) = args
        n, d = self.q.shape
        self.fn, self.fused, self.with_torch = fn, fused, with_torch
        self.n, self.d, self.vec4, self.stream = n, d, int(d % 4 == 0), stream
        self.work = [t.clone() for t in (self.pos, self.grad, self.state_lp)]
        self.ap, self.de = (torch.empty_like(self.lp_new) for _ in range(2))
        self.acc = torch.empty(n, dtype=torch.bool, device=self.q.device)
        self.p, self.h_old = self.kick_and_h_old()

    def kick_and_h_old(self):
        return (self.p_half + 0.5 * self.eps * self.g_new,
                -self.state_lp + 0.5 * torch.sum(
                    self.inv_m * self.mom * self.mom, dim=-1))

    def restore(self):
        if self.fused:
            for w, t in zip(self.work, (self.pos, self.grad, self.state_lp)):
                w.copy_(t)

    def run(self):
        w_pos, w_grad, w_lp = self.work
        if self.fused:  # in place, as the main path runs it
            ptrs = [None if t is None else t.data_ptr() for t in (
                self.q, self.p_half, self.g_new, self.mom, self.eps, None,
                self.lp_new, w_lp, self.log_u, self.inv_m, None, None,
                w_pos, w_grad, w_lp, self.ap, self.acc, self.de)]
            check(self.fn(*ptrs, self.n, self.d, self.vec4, self.stream))
            return
        p, h_old = (self.kick_and_h_old() if self.with_torch
                    else (self.p, self.h_old))
        check(self.fn(*[t.data_ptr() for t in (
            self.q, p, self.g_new, self.pos, self.grad, self.lp_new,
            self.state_lp, h_old, self.log_u, self.inv_m, w_pos, w_lp,
            w_grad, self.ap, self.acc, self.de)], self.n, self.d, self.vec4,
            self.stream))

    def outputs(self):
        self.restore()
        self.run()
        torch.cuda.synchronize()
        return [t.clone() for t in (*self.work, self.ap, self.acc, self.de)]


def agreement(out, ref):
    """'bit for bit', or the rows whose decision differs and whether every
    other row selects the same state."""
    pos, grad, lp, ap, acc, de = out
    if all(torch.equal(a.nan_to_num(), b.nan_to_num())
           for a, b in zip(out, ref)):
        return "outputs equal to the kernel's bit for bit"
    same = acc == ref[4]
    sel = all(torch.equal(a[same].nan_to_num(), b[same].nan_to_num())
              for a, b in zip((pos, grad, lp), ref[:3]))
    fin = torch.isfinite(de) & torch.isfinite(ref[5])
    return (f"decisions differ in {int((~same).sum())} rows, the others "
            f"select the same state: {sel}, max |dE diff| "
            f"{float((de - ref[5])[fin].abs().max()):.3g}")


def main(argv):
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    src = (_build.SOURCE_DIR / f"{ops_hmc.KERNEL}.cu").read_text()
    sources = {"kernel": src, "late_q": edited(src, LATE_Q)}
    for arg in argv:
        name, path = arg.split("=", 1)
        sources[name] = Path(path).read_text()
    print(cs.device_line(), flush=True)
    entries = build(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for n, d in cs.KERNEL_SHAPES:
        args = cs.fused_inputs(n, d, gen, **cs.ACCEPT_MIXES["main"])
        arms = {}
        for name, (fn, fused) in entries.items():
            if fused:
                arms[name] = Arm(fn, True, False, args, stream)
            else:
                arms[f"{name} alone"] = Arm(fn, False, False, args, stream)
                arms[f"{name} + torch"] = Arm(fn, False, True, args, stream)
        ref = arms["kernel"].outputs()
        bound_ms, _ = cs.fused_bound(args, ref[4], inplace=True)
        moved = bound_ms * 1e-3 * cs.HBM_BYTES_PER_S
        # yardstick, not the function: one copy that reads and writes half
        # the bytes the fused function moves each
        src = torch.empty(int(moved / 8), device="cuda")
        dst = torch.empty_like(src)
        copy = cs.cuda_time_ms(lambda: dst.copy_(src), flush=flush)
        times = {name: [] for name in arms}
        for name in list(arms) + list(arms)[::-1]:
            arm = arms[name]
            times[name].append(cs.cuda_time_ms(arm.run, flush=flush,
                                               prepare=arm.restore))
        print(f"({n},{d}): accepted {int(ref[4].sum())}/{n}, fused bound "
              f"{bound_ms:.5f} ms ({moved / 1e6:.2f} MB); a torch copy of "
              f"as many bytes: {copy:.5f} ms", flush=True)
        for name, arm in arms.items():
            ms = ", ".join(f"{t:.5f}" for t in times[name])
            print(f"({n},{d}) {name}: {ms} ms; share of the fused bound "
                  f"{bound_ms / min(times[name]):.3f}; "
                  f"{agreement(arm.outputs(), ref)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
