"""LJ site-hopping diagnostic on the card: the twin of
tools/lj_permutation.py for normalizingflow_tpu_torch.

The flow (Einstein-site prior) indexes atoms by lattice site, so a data
frame whose atoms have swapped sites is a low-density point of the learned
density even when its energy is perfect. The diagnostic relabels each
held-out frame's atoms to their nearest lattice sites (optimal assignment
under the minimum-image metric: the permutation part of the motion undone,
every displacement kept) and evaluates the flow's log-density again. If
the held-out gap were permutation physics, logp(relabeled) would move by
hundreds of nats toward logp(generated); if the flow is a poor fit of the
local density, relabeling changes almost nothing.

Usage: python tools/torch_lj_permutation.py [configs/LJ.yaml] [--cpu]

The trained flow comes from apps.test.load_trained (the port's
`{name}.pt`, else the JAX package's `{name}.msgpack`); the lattice and box
from its Einstein prior; the held-out frames from the config's
testing_data. Runs on the card unless --cpu is given (without CUDA it
raises). Prints the JAX tool's five lines and the kernels' launches, and
writes runs/torch_fit/lj_permutation.json. Imports torch, numpy, scipy and
the port only.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from normalizingflow_tpu_torch.apps.fe_eval import (  # noqa: E402
    evaluate,
    generate_from_nf,
)
from normalizingflow_tpu_torch.apps.test import load_trained  # noqa: E402
from normalizingflow_tpu_torch.config import load_config  # noqa: E402
from normalizingflow_tpu_torch.device import entry_device  # noqa: E402
from normalizingflow_tpu_torch.ops import launch_counts  # noqa: E402
from tools.torch_fit_sweep import OUT, row_extras  # noqa: E402

GEN_SEED = 123


def min_image(dx, L):
    return dx - L * np.round(dx / L)


def relabel_to_sites(frames, centers, L):
    """Optimal atom->site relabeling per frame (Hungarian, PBC metric).

    frames (n, natoms, 3), centers (natoms, 3). Returns (relabeled frames,
    #frames with a non-identity permutation, mean #atoms displaced)."""
    n, natoms, _ = frames.shape
    out = np.empty_like(frames)
    n_permuted = 0
    n_moved = 0
    for i in range(n):
        dx = frames[i][:, None, :] - centers[None, :, :]
        d2 = (min_image(dx, L) ** 2).sum(-1)
        rows, cols = linear_sum_assignment(d2)
        perm = np.empty(natoms, dtype=int)
        perm[cols] = rows  # atom perm[j] is assigned to site j
        out[i] = frames[i][perm]
        moved = int((perm != np.arange(natoms)).sum())
        n_permuted += moved > 0
        n_moved += moved
    return out, n_permuted, n_moved / n


def diagnose(flow, potential, test, z=None):
    """The diagnostic's numbers on the held-out frames `test` (n, natoms *
    3): {"frames", "atoms", "box", "n_permuted", "mean_moved", "u_raw",
    "u_rel", "logp_gen", "logp_raw", "logp_rel", "recovered_pct"}. The
    generated draws (as many as frames) come from a generator on the flow's
    device seeded with 123, or are pushed from the latents `z`."""
    p = next(flow.parameters())
    centers = flow.prior.centers.cpu().numpy()  # (natoms, 3) lattice
    L = float(flow.prior.boxlength)
    natoms = centers.shape[0]
    test = test.reshape(len(test), natoms, 3).astype(np.float32)
    relabeled, n_perm, mean_moved = relabel_to_sites(test, centers, L)

    def flat(frames):
        return torch.as_tensor(frames.reshape(len(frames), -1),
                               device=p.device, dtype=p.dtype)

    lp_raw = evaluate(flow, flat(test))
    lp_rel = evaluate(flow, flat(relabeled))
    gen = torch.Generator(device=p.device).manual_seed(GEN_SEED)
    _, lp_gen = generate_from_nf(flow, len(test), generator=gen, z=z)
    raw, rel, gen_lp = (float(torch.mean(a)) for a in (lp_raw, lp_rel,
                                                       lp_gen))
    # energy invariance: relabeling is a permutation, U must not move
    with torch.no_grad():
        u_raw = float(torch.mean(potential.potential(flat(test))))
        u_rel = float(torch.mean(potential.potential(flat(relabeled))))
    return {"frames": len(test), "atoms": natoms, "box": L,
            "n_permuted": int(n_perm), "mean_moved": float(mean_moved),
            "u_raw": u_raw, "u_rel": u_rel, "logp_gen": gen_lp,
            "logp_raw": raw, "logp_rel": rel,
            "recovered_pct": (rel - raw) / max(gen_lp - raw, 1e-9) * 100}


def report(r):
    """The JAX tool's five lines."""
    n, natoms = r["frames"], r["atoms"]
    gen, raw, rel = r["logp_gen"], r["logp_raw"], r["logp_rel"]
    return "\n".join([
        f"frames: {n}  atoms: {natoms}  box L: {r['box']:.3f}",
        f"non-identity assignment in {r['n_permuted']}/{n} frames; "
        f"mean atoms off their own site: {r['mean_moved']:.1f}/{natoms}",
        f"energy invariance: mean U raw {r['u_raw']:.3f} vs relabeled "
        f"{r['u_rel']:.3f} (must match)",
        f"mean flow logp: generated {gen:.2f}  held-out RAW {raw:.2f}  "
        f"held-out RELABELED {rel:.2f}",
        f"gap vs generated: raw {gen - raw:+.2f}  relabeled {gen - rel:+.2f}"
        f"  (recovered {r['recovered_pct']:.1f}% of the gap by undoing the "
        "site permutation)"])


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = entry_device("cpu" if "--cpu" in argv else "cuda")
    argv = [a for a in argv if a != "--cpu"]
    cfg = load_config(argv[0] if argv else "configs/LJ.yaml")
    flow, potential, cfg = load_trained(cfg, device=device)
    test = np.load(os.path.join(REPO, cfg.dataset.testing_data))
    before = launch_counts()
    r = diagnose(flow, potential, test)
    print(report(r))
    r.update(row_extras("lj_permutation", device, before))
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "lj_permutation.json").write_text(json.dumps(r, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
