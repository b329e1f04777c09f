"""Builders of the program's flows and targets, one module a family, found
by the `family` key of a configuration file."""

import torch


@torch.no_grad()
def load_weights(flow, params):
    """Copy the benchmark's weights into the program's flow, name by name;
    raises where the two sets of names differ."""
    names = dict(flow.named_parameters())
    if set(names) != set(params):
        raise KeyError(f"parameters differ: program {sorted(names)[:4]}..., "
                       f"benchmark {sorted(params)[:4]}...")
    for name, p in names.items():
        p.copy_(params[name])
