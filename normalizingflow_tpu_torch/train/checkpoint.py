"""Checkpoint / resume of the full training state.
Twin of normalizingflow_tpu/train/checkpoint.py, in the port's own format.

A checkpoint is one `torch.save` file of a dict

    {"params": params.to_numpy tree, "opt_state": Adam.state_tree(),
     "generator": the torch.Generator's state, "epoch", "losses"}

written atomically (a temporary file, then os.replace). Numpy leaves are
stored as CPU tensors sharing their memory: torch.save writes a tensor's
bytes as they are, where it pickles a numpy array through a copy, about
ten times slower for the LJ config's 0.5 GB training state; and a file of
tensors, containers and numbers loads with `weights_only=True`. The apps
name it `{name}.pt`, beside the JAX package's `{name}.msgpack`, so the two
never collide; the JAX package's msgpack files are not read here.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch


def _stored(tree):
    """The tree with numpy leaves as CPU tensors sharing their memory."""
    if isinstance(tree, dict):
        return {k: _stored(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_stored(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    return tree


def save_checkpoint(path, state):
    """Atomically write the dict `state` to `path`."""
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(_stored(state), tmp)
    os.replace(tmp, path)


def copy_checkpoint(src, dst):
    """Atomically duplicate an on-disk checkpoint."""
    tmp = dst + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def _cast_tree(tree, template):
    """Floating tensor leaves cast to the floating dtype of the template's
    leaf at the same place (numpy or tensor)."""
    if isinstance(tree, dict) and isinstance(template, dict):
        return {k: _cast_tree(v, template[k]) if k in template else v
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and isinstance(template,
                                                      (tuple, list)):
        return type(tree)(_cast_tree(a, b) for a, b in zip(tree, template))
    if isinstance(tree, torch.Tensor) and tree.is_floating_point() and \
            isinstance(template, (np.ndarray, torch.Tensor)):
        dtype = torch.as_tensor(template[:0] if template.ndim else
                                template).dtype
        if dtype.is_floating_point:
            return tree.to(dtype)
    return tree


def load_checkpoint(path, template=None):
    """Read a checkpoint written by `save_checkpoint`; array leaves come
    back as CPU tensors. With `template` (a dict of the same structure,
    for instance {"params": params.to_numpy(flow)}), floating leaves are
    cast to the template's dtypes."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return state if template is None else _cast_tree(state, template)
