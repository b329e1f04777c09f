"""Weak scaling of chain-sharded NeuTra HMC. Twin of bench_scaling.py.

    python -m normalizingflow_tpu_torch.bench_scaling

Fix CHAINS_PER_DEVICE, run the timed sampling phase of the bench's
pipeline (parallel.run_hmc_sharded on the funnel flow's pullback) at world
size 1 and at world size W, and report

    efficiency = throughput(W) / (W * throughput(1))

World size 1 is one NCCL rank in this process; W = torch.cuda.device_count()
(when above 1) is one process a card, spawned with torch.multiprocessing,
over NCCL. Each rank builds its mesh with parallel.make_mesh on a
process group whose rendezvous is a file in a temporary directory. The
flow is trained once, here, and every rank loads its weights.

Prints one JSON line per world size (`neutra_hmc_draws_per_s`) and a final
`scaling_efficiency` line, whose value is null when one card is visible.
On the CPU (`main(device="cpu")`, for the tests) the ranks use gloo and
W = 2; that checks the method only, since the ranks share one host's
cores.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import bench
from .device import entry_device
from .mcmc import pullback_logprob_batched
from .mcmc.neutra import frozen
from .parallel import make_mesh, run_hmc_sharded
from .targets import NealsFunnel

CHAINS_PER_DEVICE = 2048
DRAWS = 256
LEAPFROG = 4
WARMUP = 50
CPU_WORLD = 2  # gloo ranks of the CPU's methodology check


def throughput(mesh, flow, target, generator,
               chains_per_device=CHAINS_PER_DEVICE, draws=DRAWS):
    """Draws a second of the sharded sampling phase on `mesh`: adaptation
    (warmup 50, 2 draws, step 0.5) from chains_per_device * world prior
    draws of `generator` (seeded alike on every rank), a warm call, then
    one timed run of `draws` draws at the adapted step size and mass. The
    window opens after a synchronize and closes when this rank holds a
    value of its last draw. Returns (draws/s, seconds)."""
    chains = chains_per_device * mesh.size
    logprob = pullback_logprob_batched(flow, target)
    with frozen(flow):
        z0 = flow.prior.sample(chains, generator=generator)
        adapt = run_hmc_sharded(mesh, 2, logprob, z0, 2, num_warmup=WARMUP,
                                step_size=0.5, num_leapfrog=LEAPFROG)
        # run_hmc_sharded takes the global batch and keeps its rows
        position = mesh.all_gather(adapt.final_state.position)

        def run(seed):
            res = run_hmc_sharded(
                mesh, seed, logprob, position, draws, num_warmup=0,
                step_size=float(adapt.step_size),
                inv_mass_diag=adapt.inv_mass_diag, num_leapfrog=LEAPFROG)
            return float(res.samples[-1, 0].sum())

        run(3)  # warm
        bench.synchronize(mesh.device)
        t0 = time.perf_counter()
        run(4)
        dt = time.perf_counter() - t0
    return chains * draws / dt, dt


def _rank(rank, world, tmp, device_type, chains_per_device, draws):
    """One rank of world size `world`: joins the group (NCCL on cards,
    gloo on the CPU), measures `throughput` with the trained flow in
    `tmp`, and rank 0 writes its line to tmp/w<world>.json."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{tmp}/store{world}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(device=None if device_type == "cuda" else "cpu")
        flow = bench.build_flow(device=mesh.device)
        flow.load_state_dict(torch.load(Path(tmp) / "flow.pt",
                                        map_location=mesh.device))
        thr, dt = throughput(mesh, flow, NealsFunnel(bench.DIM),
                             bench.seeded(mesh.device, 1), chains_per_device,
                             draws)
        if rank == 0:
            (Path(tmp) / f"w{world}.json").write_text(json.dumps({
                "metric": "neutra_hmc_draws_per_s",
                "mesh_devices": world,
                "value": round(thr, 1),
                "unit": "draws/s",
                "chains": chains_per_device * world,
                "sample_s": round(dt, 3),
                "backend": backend,
            }))
    finally:
        dist.destroy_process_group()


def efficiency_line(results, device_type):
    """The summary line from {world size: draws/s}."""
    if len(results) < 2:
        return {"metric": "scaling_efficiency", "value": None,
                "note": "single device visible; run on a host with several "
                        "cards"}
    n = max(results)
    eff = results[n] / (n * results[1])
    return {
        "metric": "scaling_efficiency",
        "value": round(eff, 4),
        "unit": "fraction",
        "vs_baseline": round(eff / 0.9, 4),
        "devices": n,
        "note": ("CPU ranks share one host's cores; the efficiency means "
                 "nothing there" if device_type == "cpu" else "real devices"),
    }


def main(device="cuda", train_steps=bench.TRAIN_STEPS,
         lr_warmup=bench.LR_WARMUP, chains_per_device=CHAINS_PER_DEVICE,
         draws=DRAWS):
    device = entry_device(device)
    world = (torch.cuda.device_count() if device.type == "cuda"
             else CPU_WORLD)
    gen = bench.seeded(device, 0)
    flow = bench.build_flow(generator=gen, device=device)
    # Scaling measures the sampler; the training is bench.py's.
    bench.train(flow, NealsFunnel(bench.DIM), train_steps, bench.TRAIN_BATCH,
                gen, device=device, warmup_steps=lr_warmup,
                peak_lr=bench.PEAK_LR)
    bench.log("trained")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(flow.state_dict(), Path(tmp) / "flow.pt")
        del flow
        for size in sorted({1, world}):
            args = (size, tmp, device.type, chains_per_device, draws)
            if size == 1:
                _rank(0, *args)
            else:
                mp.spawn(_rank, args=args, nprocs=size)
            line = json.loads((Path(tmp) / f"w{size}.json").read_text())
            results[size] = line["value"]
            print(json.dumps(line), flush=True)
    print(json.dumps(efficiency_line(results, device.type)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
