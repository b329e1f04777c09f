"""Write tests/data/jax_gaussian_rnvp.msgpack.last, the JAX package's
training state of configs/Gaussian_rnvp.yaml cut at epoch 2000.

    JAX_PLATFORMS=cpu python tools/jax_resume_fixture.py [OUT]

Runs the JAX package's training CLI (normalizingflow_tpu.apps.train) on the
CPU, in float32, on a copy of the config whose max_epochs is 2000 and whose
output paths lie in a temporary directory, then copies the run's
`Gaussian_rnvp_2l.msgpack.last` (params, optax's Adam state, PRNG key,
epoch and losses) to OUT. The config's exponential rate schedule does not
depend on max_epochs, so the state is the one a full 3000-epoch run holds
at epoch 2000. The port's tests and chip_smoke.py's `jax_resume` phase
resume it with the port; a machine without JAX needs the committed file.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import yaml
from flax import serialization

from normalizingflow_tpu.apps import train

CONFIG = os.path.join(REPO, "configs", "Gaussian_rnvp.yaml")
EPOCHS = 2000
OUT = os.path.join(REPO, "tests", "data", "jax_gaussian_rnvp.msgpack.last")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    out = argv[0] if argv else OUT
    with open(CONFIG) as fh:
        raw = yaml.safe_load(fh)
    with tempfile.TemporaryDirectory() as tmp:
        raw["train_parameters"]["max_epochs"] = EPOCHS
        raw["output"] = {k: os.path.join(tmp, k) + "/" for k in (
            "training_dir", "testing_dir", "model_dir")}
        cfg = os.path.join(tmp, "Gaussian_rnvp.yaml")
        with open(cfg, "w") as fh:
            yaml.safe_dump(raw, fh)
        if train.main([cfg]) != 0:
            return 1
        last = os.path.join(tmp, "model_dir",
                            f"{raw['dataset']['name']}.msgpack.last")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        shutil.copyfile(last, out)
    with open(out, "rb") as fh:
        state = serialization.msgpack_restore(fh.read())
    print(f"{out}: {os.path.getsize(out)} bytes, epoch {int(state['epoch'])}, "
          f"losses {np.asarray(state['losses']).tolist()}, key "
          f"{np.asarray(state['key']).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
