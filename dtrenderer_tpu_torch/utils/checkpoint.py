"""RenderState checkpoint/resume.

Port of `dtrenderer_tpu/utils/checkpoint.py`: all state is a tree of
NamedTuple/dict/list/tuple nodes whose leaves are tensors, numpy arrays or
scalars, so persistence is (de)serializing the tree. Any such tree
round-trips through one .npz file.

The leaf order is dict keys sorted, NamedTuple fields and sequence items in
order; `None` is an empty node. That is the reference's leaf order, so a
file holds the same `leaf_<i>` arrays whichever package wrote it; the
structure string is each package's own.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, leaves: list) -> str:
    """Append tree's leaves to `leaves`; return its structure string."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "{" + ", ".join(
            f"{k!r}: {_flatten(tree[k], leaves)}" for k in keys) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_flatten(v, leaves)}"
            for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_flatten(v, leaves) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner},)"
    leaves.append(tree)
    return "*"


def _unflatten(like, leaves):
    """Rebuild like's structure around the iterator `leaves`."""
    if like is None:
        return None
    if isinstance(like, dict):
        new = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: new[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_unflatten(v, leaves) for v in like])
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf):
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree) -> None:
    """Serialize a tree of tensors/arrays (+ scalars) to an .npz file."""
    leaves: list = []
    structure = _flatten(tree, leaves)
    arrays = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(structure.encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_pytree(path: str, like):
    """Restore a tree saved by save_pytree; `like` provides the structure,
    and its tensor leaves the dtype and the device each restored tensor
    lands on.

    The stored structure is verified against `like`'s: restoring into a
    structurally different state is an error, not a silent reinterpretation.
    """
    leaves_like: list = []
    structure = _flatten(like, leaves_like)
    with np.load(path) as data:
        stored = bytes(data["__treedef__"]).decode()
        if stored != structure:
            raise ValueError(
                f"checkpoint structure mismatch:\n  stored: {stored}\n"
                f"  expected: {structure}")
        n_stored = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_stored != len(leaves_like):
            raise ValueError(
                f"checkpoint has {n_stored} leaves, `like` has "
                f"{len(leaves_like)}")
        arrays = [data[f"leaf_{i}"] for i in range(n_stored)]
    leaves = []
    for arr, ref in zip(arrays, leaves_like):
        if torch.is_tensor(ref):
            leaves.append(torch.from_numpy(arr).to(device=ref.device,
                                                   dtype=ref.dtype))
        elif isinstance(ref, np.ndarray):
            leaves.append(arr.astype(ref.dtype))
        else:
            leaves.append(arr.item())
    return _unflatten(like, iter(leaves))
