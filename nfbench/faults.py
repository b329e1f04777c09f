"""The program with a fault planted, for the check's own tests: each class
stands where a traffic kind's Port does and breaks the timed path in one way.

  * Stuck: a step that returns its state unchanged;
  * HalfBatch: half of the batch left out, the mean taken over the rest;
  * Altered: an answer altered where it is produced.

The cells have one chip, so there is no exchange between chips to leave
out.
"""

from __future__ import annotations

import torch

from nfbench.kinds import fkl_train, neutra_hmc, nf_sample, rkl_train


class StuckHMC(neutra_hmc.Port):
    def chunk(self, z, n, draws, step, inv_mass, leapfrog):
        for _ in range(n):
            next(draws)
        zs = z.expand(n, *z.shape).clone()
        lp = self.logprob(z)
        return zs, lp.expand(n, *lp.shape).clone(), z


class HalfBatchHMC(neutra_hmc.Port):
    """Transitions run on the first half of the chains; the rest stay."""

    def chunk(self, z, n, draws, step, inv_mass, leapfrog):
        half = z.shape[0] // 2
        halves = ((j[:half], m[:half], a[:half]) for j, m, a in draws)
        zs, lps, last = super().chunk(z[:half], n, halves, step, inv_mass,
                                      leapfrog)
        rest = z[half:].expand(n, *z[half:].shape)
        lp_rest = self.logprob(z[half:]).expand(n, z.shape[0] - half)
        return (torch.cat([zs, rest], 1), torch.cat([lps, lp_rest], 1),
                torch.cat([last, z[half:]]))


class AlteredHMC(neutra_hmc.Port):
    """Every pushed draw's first coordinate moved by 1e-2."""

    def push(self, zs):
        x = super().push(zs)
        x[..., 0] += 1e-2
        return x


class StuckFKL(fkl_train.Port):
    def train(self, feed, frames):
        for p in self.flow.parameters():
            p.register_hook(lambda g: torch.zeros_like(g))
        super().train(feed, frames)


class HalfBatchFKL(fkl_train.Port):
    def train(self, feed, frames):
        super().train((idx[:idx.shape[0] // 2] for idx in feed), frames)


class StuckRKL(rkl_train.Port):
    def step(self, z):
        before = [p.detach().clone() for p in self.flow.parameters()]
        loss = super().step(z)
        with torch.no_grad():
            for p, b in zip(self.flow.parameters(), before):
                p.copy_(b)
        return loss


class HalfBatchRKL(rkl_train.Port):
    def step(self, z):
        return super().step(z[:z.shape[0] // 2])


class AlteredSample(nf_sample.Port):
    """Every frame's first coordinate moved by 1e-2."""

    def sample(self, z):
        x, lp = super().sample(z)
        x[:, 0] += 1e-2
        return x, lp
