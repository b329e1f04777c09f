"""Free-energy evaluation CLI. Twin of normalizingflow_tpu/apps/test.py.

`python -m normalizingflow_tpu_torch.apps.test <config.yaml>
[--checkpoint PATH]`

Loads the trained model (`{model_dir}/{name}.pt`, else the JAX package's
`{model_dir}/{name}.msgpack`; or the checkpoint that `--checkpoint` names:
a `.msgpack` path is read as the JAX package's checkpoint, any other as the
port's), runs `fe_diff` at 500
samples (with relaxation for the particle systems, as the reference does)
and prints the four estimates. Beside the Q plot it writes
`{testing_dir}/fe_{name}.npz`: the estimates, the work matrices and the
frames that entered them. Where matplotlib is not installed, the plot is
skipped with a note on stderr; nothing else depends on it.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import torch

from ..config import config_device, load_config, setup_model
from ..params import from_jax, to_numpy
from ..train.checkpoint import (
    is_jax_checkpoint,
    load_checkpoint,
    load_jax_checkpoint,
)
from .fe_eval import fe_diff
from .train import checkpoint_path, jax_checkpoint_path

RELAXED_POTENTIALS = ("LJ", "Fe", "EAM")


def load_trained(cfg, mode="testing", device=None, checkpoint=None):
    """(flow with the checkpoint's params, data potential, cfg). The
    checkpoint is `checkpoint` if given (a `.msgpack` path is the JAX
    package's format, read by load_jax_checkpoint), else the port's
    `{model_dir}/{name}.pt`, else the JAX package's `{name}.msgpack` in the
    same model_dir (its best model, fine-tuned or not)."""
    device = config_device(cfg) if device is None else device
    flow, potential, cfg = setup_model(cfg, mode=mode, device=device)
    path = checkpoint or checkpoint_path(cfg)
    if checkpoint is None and not os.path.exists(path) and os.path.exists(
            jax_checkpoint_path(cfg)):
        path = jax_checkpoint_path(cfg)
        print(f"no {checkpoint_path(cfg)}: evaluating the JAX package's "
              f"{path}", file=sys.stderr)
    if is_jax_checkpoint(path):
        load_jax_checkpoint(path, flow)
    else:
        state = load_checkpoint(path, {"params": to_numpy(flow)})
        from_jax(flow, state["params"])
    return flow, potential, cfg


def save_estimates(path, out):
    """The estimates and arrays of an fe_diff result, as one .npz."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


def plot_path_or_none(path):
    if importlib.util.find_spec("matplotlib") is None:
        print(f"matplotlib is not installed: {path} not written",
              file=sys.stderr)
        return None
    return path


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or len(argv) not in (1, 3) or (
            len(argv) == 3 and argv[1] != "--checkpoint"):
        print("usage: python -m normalizingflow_tpu_torch.apps.test "
              "<config.yaml> [--checkpoint PATH]", file=sys.stderr)
        return 2
    cfg = load_config(argv[0])
    flow, potential, cfg = load_trained(
        cfg, checkpoint=argv[2] if len(argv) == 3 else None)
    out_dir = cfg.output.testing_dir
    os.makedirs(out_dir, exist_ok=True)
    name = cfg.dataset.name
    device = next(flow.parameters()).device
    out = fe_diff(
        flow, potential, nsamples=500, n_particles=cfg.dataset.nparticles,
        kT=cfg.dataset.kT,
        plot_path=plot_path_or_none(os.path.join(out_dir, f"Q_{name}.png")),
        relaxation=cfg.dataset.potential in RELAXED_POTENTIALS,
        generator=torch.Generator(device=device).manual_seed(cfg.seed + 1))
    save_estimates(os.path.join(out_dir, f"fe_{name}.npz"), out)
    print(f"bar={out['bar']:.6f} md={out['md']:.6f} nf={out['nf']:.6f} "
          f"emus={out['emus']:.6f}  (kT per particle)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
