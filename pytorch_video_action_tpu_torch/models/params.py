"""Weight carry-over between the JAX package's parameter trees and the
port's modules.

The JAX package keeps params as nested dicts and lists of arrays (the tree
``train.checkpoint.load_params`` returns, e.g. ``rnn/0/fwd/wi``).  The
port's modules name their parameters after the same paths joined with
``.`` (``rnn.0.fwd.wi``), in the same layouts, so carry-over is a rename.
"""

from __future__ import annotations

import numpy as np
import torch

PORTED = ("bigru",)


def _check_name(name: str) -> None:
    if name not in PORTED:
        from . import not_ported

        raise not_ported(name)


def flatten(tree, sep: str, prefix: str = "") -> dict:
    """Nested dicts/lists -> ``{sep-joined path: leaf}``."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, sep, f"{prefix}{k}{sep}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, sep, f"{prefix}{i}{sep}"))
    else:
        out[prefix[:-len(sep)]] = tree
    return out


def unflatten(flat: dict, sep: str):
    """Inverse of :func:`flatten`; dicts keyed ``0..n-1`` become lists."""
    root: dict = {}
    for path, value in flat.items():
        keys = path.split(sep)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    keys = list(node)
    if keys and all(k.isdigit() for k in keys):
        idx = sorted(int(k) for k in keys)
        if idx == list(range(len(idx))):
            return [node[str(i)] for i in idx]
    return node


def from_jax_params(name: str, tree) -> dict[str, torch.Tensor]:
    """JAX params tree of numpy arrays -> the port's ``state_dict``."""
    _check_name(name)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flatten(tree, ".").items()}


def to_jax_params(name: str, state_dict) -> dict:
    """The port's ``state_dict`` -> JAX params tree of f32 numpy arrays."""
    _check_name(name)
    return unflatten({k: v.detach().to("cpu", torch.float32).numpy()
                      for k, v in state_dict.items()}, ".")
