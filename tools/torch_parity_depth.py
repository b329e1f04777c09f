"""chip_smoke.py's parity phase at several training depths, on the GPU:

    python tools/torch_parity_depth.py [epochs ...]   (default: 250 500 750
                                                       1000 1500)

For each depth: configs/Gaussian.yaml through tools/torch_parity.py's
run_config in this process (train, apps.fe testing, apps.test), with the
phase's gates (status_of "ok", |bar| <= 0.05, exact launch counts, the
trained layer's kernels against their plain versions). Prints
the card, the phase's line at each depth and a last line naming the depths
whose gates passed; the fewest is the phase's PARITY_EPOCHS. Exits non-zero
if none passed. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    depths = [int(a) for a in argv] or [250, 500, 750, 1000, 1500]
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.device_line(), flush=True)
    passed = []
    for epochs in depths:
        try:
            chip_smoke.parity_phase(0, epochs)
            passed.append(epochs)
        except AssertionError as e:
            print(f"parity at {epochs} epochs: {e}", flush=True)
        torch.cuda.empty_cache()
    print(f"parity gates passed at epochs {passed} of {depths}", flush=True)
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
