"""Weights bridge between a JAX params pytree and the port's modules.

A JAX flow keeps its weights in a pytree of dicts and tuples
(`flow.init(key)`); the port keeps them in `nn.Module`s whose attribute
names are the dict keys and whose `Chain` children follow the tuple order.
For the RealNVP stack the tree is

    ({"mu", "log_sigma"},                       # ActNorm
     {"t1", "s1", "t2", "s2": {"w1", "b1", "w2", "b2", "w3", "b3"}},
     ...)                                       # AffineCoupling, ...

and the spline layers' trees are

    {"psi": {"w1", "b1", "w2", "b2", "w3", "b3"}}          # SplineCoupling
    {"init_raw", "cond": {"w1", "b1", ..., "b3"}}           # SplineAR
    {"init_param", "cond": {"w1", "b1", ..., "b3"}}         # MaskedAffineAR

(`cond` is absent at dim 1), and the elementary layers' are

    {"w", "u", "b"}                                        # Planar
    {"x0", "log_alpha", "beta"}                            # Radial
    {"P", "L", "S", "U"}                                   # InvertibleLinear

(P is a parameter that takes no gradient). MLP weights keep the JAX
(fan_in, fan_out) layout and the AR layers their stacked (dim-1, ...) one,
so leaves copy as they are. `NormalizingFlow` and `Invert` carry their inner bijector's tree.
A `Repeat` of n layers is one layer's tree with every leaf stacked on a
new leading axis of length n.
"""

from __future__ import annotations

import numpy as np
import torch

from .bijectors.base import Chain, Invert, Repeat
from .flow import NormalizingFlow


def _root(module):
    while isinstance(module, (NormalizingFlow, Invert)):
        module = module.bijector
    return module


def _map(fn, *trees):
    """fn over the leaves of trees of dicts and tuples of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (tuple, list)):
        return tuple(_map(fn, *sub) for sub in zip(*trees))
    return fn(*trees)


def from_jax(module, tree):
    """Copy a JAX params tree (numpy leaves) into `module` in place.

    Values are cast to each parameter's dtype and device. Raises if the
    tree's structure, keys or shapes differ from the module's.
    """
    module = _root(module)
    if isinstance(module, Repeat):
        for i, layer in enumerate(module.bijectors):
            from_jax(layer, _map(lambda a, i=i: np.asarray(a)[i], tree))
        return module
    if isinstance(module, Chain):
        if not isinstance(tree, (tuple, list)) or len(tree) != len(
                module.bijectors):
            raise ValueError(
                f"expected a sequence of {len(module.bijectors)} param trees")
        for child, sub in zip(module.bijectors, tree):
            from_jax(child, sub)
        return module
    own = dict(module.named_parameters(recurse=False))
    kids = dict(module.named_children())
    if not isinstance(tree, dict) or set(tree) != set(own) | set(kids):
        raise ValueError(
            f"{type(module).__name__}: params keys "
            f"{sorted(tree) if isinstance(tree, dict) else type(tree)} != "
            f"{sorted(set(own) | set(kids))}")
    for name, leaf in tree.items():
        if name in kids:
            from_jax(kids[name], leaf)
            continue
        p = own[name]
        arr = np.asarray(leaf)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(
                f"{name}: shape {arr.shape} != parameter shape "
                f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(arr)))
    return module


def to_numpy(module):
    """The module's parameters as a JAX-shaped tree of numpy arrays."""
    module = _root(module)
    if isinstance(module, Repeat):
        return _map(lambda *leaves: np.stack(leaves),
                    *(to_numpy(b) for b in module.bijectors))
    if isinstance(module, Chain):
        return tuple(to_numpy(b) for b in module.bijectors)
    tree = {k: p.detach().cpu().numpy()
            for k, p in module.named_parameters(recurse=False)}
    tree.update({k: to_numpy(m) for k, m in module.named_children()})
    return tree
