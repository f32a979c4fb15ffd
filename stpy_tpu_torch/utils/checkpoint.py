"""Checkpoint and resume for trees of tensors and fitted models: the port
of stpy_tpu/utils/checkpoint.py.

A tree (nested dicts, lists and tuples of tensors or arrays) saves to one
.npz whose keys are the leaves' paths joined by "/", list positions
written as their index: the JAX package's layout (`_flatten`,
stpy_tpu/utils/checkpoint.py:16-27), so a file written by either package
loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import resolve_device


def _numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = _numpy(tree)
    return out


def _fill(like, leaves):
    """`like`'s structure with its leaves taken in turn from `leaves`,
    dict keys in sorted order (the JAX package's tree order)."""
    if isinstance(like, dict):
        return {k: _fill(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, leaves) for v in like)
    return next(leaves)


def save_pytree(path, tree):
    np.savez(path, **_flatten(tree))


def load_pytree(path, like=None, device=None):
    """Load an .npz back into nested dicts of tensors on the card (or
    `device`), each in its stored dtype; into the structure of `like`
    when given, its leaves filled in the file's order."""
    dev = resolve_device(device)
    path = str(path)
    with np.load(path if path.endswith(".npz") else path + ".npz") as dat:
        nested = {}
        for key in dat.files:
            parts = key.split("/")
            cur = nested
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = torch.as_tensor(dat[key], device=dev)
    if like is not None:
        return _fill(like, (torch.as_tensor(v, device=dev)
                            for v in _flatten(nested).values()))
    return nested


def save_model(path, model, attrs=("L", "A", "x", "y", "rate", "W")):
    """Save a fitted estimator's factors and data (`attrs` that are set)
    and its kernel's parameters."""
    tree = {}
    for a in attrs:
        v = getattr(model, a, None)
        if v is not None and hasattr(v, "shape"):
            tree[a] = v
    if getattr(model, "kernel_object", None) is not None:
        tree["params_dict"] = model.kernel_object.params_dict
    save_pytree(path, tree)


def load_model(path, model):
    """Restore what `save_model` saved into `model` (on its device) and
    mark it fitted."""
    tree = load_pytree(path, device=getattr(model, "device", None))
    for k, v in tree.items():
        if k == "params_dict":
            model.kernel_object.set_params(v)
        else:
            setattr(model, k, v)
    model.fitted = True
    return model
