"""The program with a fault planted, for the particle cells
(kinds/rkl_particles.py, kinds/hmc_data.py), as nfbench/faults.py plants
them in the other cells' Ports:

  * Stuck: a step that returns its state unchanged;
  * HalfBatch: half of the batch left out, the mean taken over the rest.
"""

from __future__ import annotations

import torch

from nfbench.kinds import hmc_data, rkl_particles


class StuckRKLParticles(rkl_particles.Port):
    def step(self, z):
        before = [p.detach().clone() for p in self.flow.parameters()]
        loss = super().step(z)
        with torch.no_grad():
            for p, b in zip(self.flow.parameters(), before):
                p.copy_(b)
        return loss


class HalfBatchRKLParticles(rkl_particles.Port):
    def step(self, z):
        return super().step(z[:z.shape[0] // 2])


class StuckHMCData(hmc_data.Port):
    def chunk(self, z, n, draws, step, inv_mass, leapfrog, thin=None):
        for _ in range(n * (thin or self.thin)):
            next(draws)
        lp = self.logprob(z)
        return (z.expand(n, *z.shape).clone(),
                lp.expand(n, *lp.shape).clone(), z)


class HalfBatchHMCData(hmc_data.Port):
    """Transitions run on the first half of the chains; the rest stay."""

    def chunk(self, z, n, draws, step, inv_mass, leapfrog, thin=None):
        half = z.shape[0] // 2
        halves = ((j[:half], m[:half], a[:half]) for j, m, a in draws)
        zs, lps, last = super().chunk(z[:half], n, halves, step, inv_mass,
                                      leapfrog, thin)
        rest = z[half:].expand(n, *z[half:].shape)
        lp_rest = self.logprob(z[half:]).expand(n, z.shape[0] - half)
        return (torch.cat([zs, rest], 1), torch.cat([lps, lp_rest], 1),
                torch.cat([last, z[half:]]))
