"""Checkpoint and resume of the port's pipeline states, the counterpart
of the JAX package's slam2d_tpu/utils/checkpoint.py (orbax there).

A state is a tree of NamedTuples (FrontendState, PFState, PoseGraph,
TiledFrontendState, TiledGrid), dicts (full SLAM's `ckpt`), tuples and
lists whose leaves are tensors, numpy arrays or numpy scalars. A
checkpoint is a directory holding `arrays.npz` (one array a leaf, no
pickle) and `tree.json` (each leaf's path in the tree, dtype and shape).
numpy has no bfloat16: a bfloat16 tensor is stored as its raw 16 bits
(int16) under the dtype tag "bfloat16" and restored bit for bit with
`.view(torch.bfloat16)`.

`load_state(path, template)` rebuilds the template's tree and checks
every leaf's shape and dtype against it, as the JAX version restores
into its template's ShapeDtypeStructs. A tensor leaf is restored as a
tensor on the template leaf's device (or on `device`, which a template
on the "meta" device needs, e.g. `pf/fastslam.pf_state_template`); a
numpy leaf as a numpy array.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_FORMAT = 1


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, prefix=""):
    """[(path, leaf)] of `tree` in a fixed order."""
    if _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree, key=str))
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


def _rebuild(template, leaves):
    """`template`'s tree with its leaves taken in order from `leaves`."""
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(v, leaves) for v in template))
    if isinstance(template, dict):
        keys = sorted(template, key=str)
        vals = {k: _rebuild(template[k], leaves) for k in keys}
        return {k: vals[k] for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(x)


def save_state(path: str, state) -> str:
    """Save a state tree to the directory `path` (made if missing)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves = _leaves(state)
    arrays = {f"a{i}": _to_numpy(x) for i, (_, x) in enumerate(leaves)}
    meta = {
        "format": _FORMAT,
        "leaves": [
            {"path": p, "dtype": _dtype_name(x), "shape": list(np.shape(x))}
            for p, x in leaves
        ],
    }
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "tree.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return path


def load_state(path: str, template, device=None):
    """Restore a state saved by save_state into `template`'s tree (a state
    of the same schema: its leaves give the expected shapes and dtypes).
    Raises ValueError when a leaf's path, shape or dtype differs."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{path}: unknown checkpoint format {meta.get('format')}")
    tmpl = _leaves(template)
    saved = meta["leaves"]
    if [p for p, _ in tmpl] != [m["path"] for m in saved]:
        raise ValueError(
            f"{path}: the saved tree {[m['path'] for m in saved]} is not the "
            f"template's {[p for p, _ in tmpl]}"
        )
    out = []
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=False) as z:
        for i, ((p, t), m) in enumerate(zip(tmpl, saved)):
            want = (_dtype_name(t), list(np.shape(t)))
            if (m["dtype"], m["shape"]) != want:
                raise ValueError(
                    f"{path}: leaf {p!r} is {m['dtype']} {m['shape']}, the "
                    f"template's {want[0]} {want[1]}"
                )
            a = z[f"a{i}"]
            if not isinstance(t, torch.Tensor):
                out.append(a if np.ndim(t) or isinstance(t, np.ndarray)
                           else a[()])
                continue
            x = torch.from_numpy(a.copy())
            if m["dtype"] == "bfloat16":
                x = x.view(torch.bfloat16)
            dev = device if device is not None else t.device
            out.append(x.to(dev))
    return _rebuild(template, iter(out))
