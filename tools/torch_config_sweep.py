"""Run the shipped configs that `chip_smoke.py` does not drive (Fe_100K,
Fe_700K and the three Gaussian-mixture configs) through the port's CLI
mains on the GPU, at EPOCHS training epochs, with `chip_smoke.py`'s phases
and gates.

    python tools/torch_config_sweep.py

Fe runs as `chip_smoke.py`'s free-energy phases do (`fe_cli_phase`):
apps.sample_data (FRAMES frames), apps.train, apps.test with relaxation and
apps.fe testing, with exact launch counts, data acceptance and box, training
progress, finite estimates, MBAR converging to bar within 0.01, and each
trained layer's RQS kernels against the float64 plain versions. The
Gaussian configs, whose exact answer is 0, run as its Einstein phase does
(`analytic_phase`): apps.train and apps.test, |bar| <= 0.05 and |emus -
bar| <= 0.01. Prints the card, each phase's statistics, and exits non-zero
if a config failed. Needs a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    FE_FRAMES,
    analytic_phase,
    device_line,
    fe_cli_phase,
)

EPOCHS = 1000
FRAMES = FE_FRAMES
# The JAX package's bar of the Fe configs (runs/parity/results.json, TPU
# v5e, 10000 frames, the configs' 15000 epochs): printed beside the port's.
FE_RECORD = {"Fe_100K": "bar -4.212947", "Fe_700K": "bar -3.987767"}
GAUSSIAN = ["Gaussian", "GaussianMixture", "Gaussian_rnvp"]


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(device_line(), flush=True)
    failed = []
    for name in [*FE_RECORD, *GAUSSIAN]:
        label = f"sweep {name}"
        try:
            if name in FE_RECORD:
                fe_cli_phase(label, name, 0, FRAMES,
                             train={"max_epochs": EPOCHS}, mbar_tol=0.01,
                             record=FE_RECORD[name])
            else:
                analytic_phase(label, name, EPOCHS)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        torch.cuda.empty_cache()
    if failed:
        print(f"sweep failed: {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
