"""readings.py for the particle cells' kinds (rkl_particles, hmc_data):
the same runs, with their controls and planted faults
(nfbench/faults_particles.py) added to its table.

    python3 -m nfbench.readings_particles --workload <name> --seed <first> \
        --seconds <s> --runs port:12,control:3,half:3 [--device cuda]
"""

from __future__ import annotations

import sys

from nfbench import faults_particles, readings
from nfbench.kinds import hmc_data, rkl_particles

SYSTEMS = {
    "rkl_particles": {"port": None, "control": rkl_particles.Reference,
                      "stuck": faults_particles.StuckRKLParticles,
                      "half": faults_particles.HalfBatchRKLParticles},
    "hmc_data": {"port": None, "control": hmc_data.Reference,
                 "stuck": faults_particles.StuckHMCData,
                 "half": faults_particles.HalfBatchHMCData},
}


def main(argv=None):
    readings.SYSTEMS.update(SYSTEMS)
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
