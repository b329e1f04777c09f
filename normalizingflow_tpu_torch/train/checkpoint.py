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
never collide.

`read_jax_checkpoint` reads the JAX package's own files (`{name}.msgpack`,
the best model, and `{name}.msgpack.last`, the training state), so the port
can evaluate a model the JAX package trained and continue its training run
(train_flow_fused maps optax's Adam state through
loop.adam_state_from_optax and seeds its generator by `jax_key_seed`).
They are flax.serialization msgpack: tuples and lists as maps keyed "0",
"1", ...; arrays as msgpack extension 1, the packed (shape, dtype name,
C-order bytes); numpy scalars as extension 3, the same packing; complex
numbers as extension 2, (re, im); arrays over flax's chunk size as a map
of chunks; None (the fine-tuned best model's optimizer state and key) as
nil.
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


def is_jax_checkpoint(path):
    """Whether `path` names one of the JAX package's checkpoints."""
    return str(path).endswith((".msgpack", ".msgpack.last"))


def _jax_array(data):
    """A writable numpy array from flax's packed (shape, dtype name,
    bytes); a bfloat16 array, which numpy has no dtype for, as a torch
    tensor."""
    import msgpack

    shape, name, buffer = msgpack.unpackb(data, raw=True)
    name = name.decode()
    if name == "bfloat16":
        bits = (torch.frombuffer(bytearray(buffer), dtype=torch.int16)
                if buffer else torch.empty(0, dtype=torch.int16))
        return bits.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(bytearray(buffer),
                         dtype=np.dtype(name)).reshape(shape)


def _jax_ext(code, data):
    import msgpack

    if code == 1:  # ndarray
        return _jax_array(data)
    if code == 2:  # complex
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    if code == 3:  # numpy scalar
        return _jax_array(data)[()]
    raise ValueError(f"unknown msgpack extension type {code}")


def _jax_tree(node):
    """flax's state dict back to the params tree's containers: maps keyed
    "0".."n-1" are tuples, chunked arrays are joined."""
    if not isinstance(node, dict):
        return node
    if "__msgpack_chunked_array__" in node:
        shape = tuple(_jax_tree(node["shape"]))
        chunks = _jax_tree(node["chunks"])
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    tree = {k: _jax_tree(v) for k, v in node.items()}
    if tree and list(tree) == [str(i) for i in range(len(tree))]:
        return tuple(tree.values())
    return tree


def read_jax_checkpoint(path):
    """The state the JAX package's `save_checkpoint` wrote to `path`, as a
    tree of dicts, tuples and numpy arrays (bfloat16 leaves as tensors).
    Needs the `msgpack` package, imported here."""
    import msgpack

    with open(path, "rb") as fh:
        state = msgpack.unpackb(fh.read(), ext_hook=_jax_ext, raw=False,
                                strict_map_key=False)
    return _jax_tree(state)


def jax_key_seed(key):
    """The port's seed for a JAX PRNG key (two uint32 words k0, k1):
    (k0 << 32) | k1. torch has no threefry, so a run seeded this way draws
    other numbers than JAX's continuation would; the rule only makes them
    a function of the checkpoint."""
    if key is None:
        raise ValueError("the checkpoint holds no PRNG key")
    k0, k1 = (int(w) for w in np.asarray(key, dtype=np.uint32).reshape(2))
    return (k0 << 32) | k1


def load_jax_checkpoint(path, flow):
    """Copy the params of the JAX package's checkpoint at `path` into
    `flow` (params.from_jax; the flow must have the checkpoint's layout,
    Repeat where the JAX config stacked its layers) and return the whole
    decoded state ({"params", "opt_state", "key", "epoch", "losses"} for a
    training checkpoint)."""
    from ..params import from_jax

    state = read_jax_checkpoint(path)
    from_jax(flow, state["params"])
    return state
