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


def _layer(leaf, i, n):
    """Layer i of a Repeat's stacked leaf, whose leading axis must be n."""
    if np.shape(leaf)[:1] != (n,):
        raise ValueError(f"Repeat of {n} layers: stacked leaf of shape "
                         f"{np.shape(leaf)}")
    return leaf[i]


def _pairs(module, tree):
    """(parameter, leaf) pairs of `module` and a JAX params-shaped tree, in
    the order of module.parameters(): a module's own parameters in
    registration order, then its children's (Chain and Repeat layers in
    order)."""
    module = _root(module)
    if isinstance(module, Repeat):
        n = len(module.bijectors)
        for i, layer in enumerate(module.bijectors):
            yield from _pairs(layer, _map(lambda a, i=i: _layer(a, i, n),
                                          tree))
        return
    if isinstance(module, Chain):
        if not isinstance(tree, (tuple, list)) or len(tree) != len(
                module.bijectors):
            raise ValueError(
                f"expected a sequence of {len(module.bijectors)} param trees")
        for child, sub in zip(module.bijectors, tree):
            yield from _pairs(child, sub)
        return
    own = dict(module.named_parameters(recurse=False))
    kids = dict(module.named_children())
    if not isinstance(tree, dict) or set(tree) != set(own) | set(kids):
        raise ValueError(
            f"{type(module).__name__}: params keys "
            f"{sorted(tree) if isinstance(tree, dict) else type(tree)} != "
            f"{sorted(set(own) | set(kids))}")
    for name, p in own.items():
        leaf = tree[name]
        if tuple(np.shape(leaf)) != tuple(p.shape):
            raise ValueError(
                f"{name}: shape {tuple(np.shape(leaf))} != parameter shape "
                f"{tuple(p.shape)}")
        yield p, leaf
    for name, kid in kids.items():
        yield from _pairs(kid, tree[name])


def jax_leaves(module, tree):
    """The leaves of a JAX params-shaped tree in the order of
    `module.parameters()`, each checked against its parameter's shape.

    The tree is the params themselves or any tree of their structure, such
    as optax's Adam moments `mu` and `nu`. Leaves are returned as they are
    (numpy arrays, or tensors where numpy has no dtype, as for bfloat16);
    a Repeat's stacked leaves are split into its layers. Raises if the
    tree's structure, keys or shapes differ from the module's.
    """
    pairs = list(_pairs(module, tree))
    if [id(p) for p, _ in pairs] != [id(p) for p in module.parameters()]:
        raise ValueError(f"{type(module).__name__} has parameters outside "
                         f"its bijectors' params tree")
    return [leaf for _, leaf in pairs]


def from_jax(module, tree):
    """Copy a JAX params tree (numpy leaves) into `module` in place.

    Values are cast to each parameter's dtype and device. Raises if the
    tree's structure, keys or shapes differ from the module's.
    """
    with torch.no_grad():
        for p, leaf in zip(module.parameters(), jax_leaves(module, tree)):
            p.copy_(leaf if isinstance(leaf, torch.Tensor)
                    else torch.from_numpy(np.array(leaf)))
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
