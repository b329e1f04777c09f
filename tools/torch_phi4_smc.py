"""Phi4 free-energy cross-check by flow-proposal SMC, on the port.

Twin of tools/phi4_smc.py: loads the port's trained model of a Phi4 config
(`apps.test.load_trained`: `{model_dir}/{name}.pt`, from `apps.train`) and
runs `mcmc.flow_smc` with the flow as proposal, 4 mutation steps of L = 8
at step 0.1, for 3 seeds. Its log-evidence is a third estimate of the free
energy beside BAR and MBAR:

  dF/particle = -log Z_target / N   (the flow density is normalized, and
                                     kT = 1 for the phi^4 action)

    python tools/torch_phi4_smc.py [configs/Phi4.yaml] [n_particles=8192]

Runs on the config's device (the card unless it says `device: cpu`).
Imports nothing of JAX.
"""

from __future__ import annotations

import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import SMC_SEEDS, phi4_smc  # noqa: E402
from normalizingflow_tpu_torch.config import load_config  # noqa: E402


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    cfg = load_config(argv[0] if argv else "configs/Phi4.yaml")
    n = int(argv[1]) if len(argv) > 1 else 8192
    runs = phi4_smc(cfg, n, range(SMC_SEEDS))
    for r in runs:
        print(f"seed {r['seed']}: log Z = {r['log_z']:.3f}  "
              f"stages = {r['stages']}  "
              f"final accept = {r['final_accept']:.3f}  "
              f"dF/particle = {r['df']:.4f}")
    estimates = [r["df"] for r in runs]
    print(f"smc dF/particle over {len(estimates)} runs: "
          f"{statistics.fmean(estimates):.4f} +/- "
          f"{statistics.pstdev(estimates):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
