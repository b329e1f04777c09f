"""Polymer field-theory experiment CLI. Twin of
normalizingflow_tpu/apps/polymer.py.

`python -m normalizingflow_tpu_torch.apps.polymer <config.yaml>
{data|training|testing} [nframes]`

  * data: exact massive-GFF surrogate fields (targets/gff.py), the
    reference's unshipped SCFT data's stand-in, drawn on the config's
    device and written 80/20 to the training and testing paths (.npy);
  * training: apps.train on those fields;
  * testing: the sampling latency of 100 flow draws, first call and hot,
    each timed to a device synchronisation; the draws written to
    `{testing_dir}/generated_fields.npy`; the mean flow log-density of the
    draws against that of 100 held-out fields; and the gap between the
    flow's held-out log-density and the exact GFF one. The numbers are also
    written to `{testing_dir}/polymer_{name}_testing.npz`. The field images
    need matplotlib; where it is not installed they are skipped with a note
    on stderr and every number is still computed.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import time

import numpy as np
import torch

from ..config import config_device, load_config
from ..targets.gff import GaussianField
from .fe_eval import evaluate
from .test import load_trained, save_estimates
from .train import main as train_main

NSAMPLES = 100


def field_shape(cfg):
    """(channels, L, L) from the config (2048 dims -> 2 x 32 x 32)."""
    ds = cfg.dataset
    n = ds.nparticles * ds.dim
    L = int(round((n / ds.channels) ** 0.5))
    if ds.channels * L * L != n:
        raise ValueError(f"dataset dim {n} is not channels x L x L")
    return (ds.channels, L, L)


def surrogate(cfg, device=None):
    """The config's GFF: L from the field shape, the dataset's masses."""
    ds = cfg.dataset
    _, L, _ = field_shape(cfg)
    return GaussianField(
        L=L, channels=ds.channels,
        mass=ds.mass if ds.mass is not None else (0.5, 1.0), device=device)


def save_field(cfg, x, shape=None):
    shape = shape or field_shape(cfg)
    x = np.asarray(x).reshape((-1,) + shape)
    os.makedirs(cfg.output.testing_dir, exist_ok=True)
    path = os.path.join(cfg.output.testing_dir, "generated_fields.npy")
    np.save(path, x)
    return path


def plot_field(x, outdir=".", shape=(2, 32, 32)):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.asarray(x).reshape(shape)
    for name, field in zip(("omega_plus", "omega_minus"), x):
        plt.figure()
        plt.imshow(field)
        plt.savefig(os.path.join(outdir, f"{name}.png"))
        plt.close()


def generate_data(cfg, nframes=2000, seed=0):
    """Write surrogate GFF train/test fields to the config's data paths,
    drawn on the config's device."""
    device = config_device(cfg)
    gff = surrogate(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    fields = gff.sample(nframes, generator=gen)
    exact = float(torch.mean(gff.log_prob(fields[:64])))
    fields = fields.cpu().numpy()
    ds = cfg.dataset
    n_train = int(0.8 * nframes)
    for path, arr in ((ds.training_data, fields[:n_train]),
                      (ds.testing_data, fields[n_train:])):
        if path is None:
            continue
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.save(path, arr)
    print(f"wrote {n_train} train + {nframes - n_train} test GFF fields "
          f"(exact logp {exact:.2f}) -> {ds.training_data}, "
          f"{ds.testing_data}")
    return 0


def _timed_sample(flow, generator):
    """(draws, their log-densities, seconds to a device sync)."""
    device = next(flow.parameters()).device
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        x, log_px, _ = flow.sample(NSAMPLES, generator=generator)
    sync()
    return x, log_px, time.perf_counter() - t0


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2 or argv[1] not in ("data", "training", "testing"):
        print("usage: python -m normalizingflow_tpu_torch.apps.polymer "
              "<config.yaml> {data|training|testing} [nframes]",
              file=sys.stderr)
        return 2
    if argv[1] == "data":
        cfg = load_config(argv[0])
        return generate_data(
            cfg, nframes=int(argv[2]) if len(argv) > 2 else 2000)
    if argv[1] == "training":
        return train_main([argv[0]])

    cfg = load_config(argv[0])
    flow, potential, cfg = load_trained(cfg)
    device = next(flow.parameters()).device
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 3)
    # The NSF_AR inverse is a sequential loop over the 2048 dims: the first
    # call (allocator and library warm-up) is timed apart from a hot one.
    _, _, t_first = _timed_sample(flow, gen)
    x1, q1, t_hot = _timed_sample(flow, gen)
    dim = cfg.dataset.nparticles * cfg.dataset.dim
    print(f"sampling latency: {t_hot:.3f}s hot / {t_first:.3f}s first call "
          f"for {NSAMPLES} frames of dim {dim} ({cfg.flow.type} inverse)")
    save_field(cfg, x1.cpu().numpy())
    out_dir = cfg.output.testing_dir
    if importlib.util.find_spec("matplotlib") is None:
        print(f"matplotlib is not installed: the field images in {out_dir} "
              f"are not written", file=sys.stderr)
    else:
        plot_field(x1[0].cpu().numpy(), out_dir, field_shape(cfg))
    x2 = potential.sample(NSAMPLES, generator=gen)
    q2 = evaluate(flow, x2.reshape(len(x2), -1))
    logp_gen, logp_data = float(q1.mean()), float(q2.mean())
    print("logp of generated data vs testing data:", logp_gen, logp_data)
    # the surrogate's density is exactly normalized, so the flow's held-out
    # log-density is compared with the true one
    with torch.no_grad():
        exact = float(torch.mean(surrogate(cfg, device).log_prob(
            x2.reshape(len(x2), -1))))
    print(f"exact GFF logp of testing data: {exact:.4f} "
          f"(flow - exact gap: {logp_data - exact:+.4f})")
    save_estimates(
        os.path.join(out_dir, f"polymer_{cfg.dataset.name}_testing.npz"),
        {"sample_s_hot": t_hot, "sample_s_first": t_first,
         "logp_generated": logp_gen, "logp_data": logp_data,
         "logp_exact": exact, "gap": logp_data - exact})
    return 0


if __name__ == "__main__":
    sys.exit(main())
