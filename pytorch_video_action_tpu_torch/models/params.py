"""Weight carry-over between the JAX package's parameter trees and the
port's modules.

The JAX package keeps params as nested dicts and lists of arrays (the tree
``train.checkpoint.load_params`` returns, e.g. ``rnn/0/fwd/wi``).  The
port's modules name their parameters after the same paths joined with
``.`` (``rnn.0.fwd.wi``), in the same layouts, so carry-over is a rename.
A stateful model's buffers (``bn1.mean`` ...) are JAX's ``model_state``
tree, kept apart from the params.
"""

from __future__ import annotations

import numpy as np
import torch

PORTED = ("simple_fc", "bigru", "ctcloss", "vanilla_lstm", "bilstm",
          "bilstm_lm", "attn", "win_attn", "ms_tcn", "mstcn")
# each stateful model's buffers: the leaves of JAX's ``model_state`` tree
STATE_KEYS = {"bilstm_lm": ("bn1.mean", "bn1.var", "bn2.mean", "bn2.var")}


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


def _to_torch(tree) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flatten(tree, ".").items()}


def from_jax_params(name: str, tree, model_state=None
                    ) -> dict[str, torch.Tensor]:
    """JAX params tree (and ``model_state`` tree, if any) of numpy arrays ->
    the port's ``state_dict``."""
    _check_name(name)
    out = _to_torch(tree)
    if model_state is not None:
        out.update(_to_torch(model_state))
    return out


def to_jax_params(name: str, state_dict, with_state: bool = False):
    """The port's ``state_dict`` -> JAX params tree of f32 numpy arrays, or
    ``(params, model_state or None)`` when ``with_state``."""
    _check_name(name)
    keys = set(STATE_KEYS.get(name, ()))
    flat = {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in state_dict.items()}
    params = unflatten({k: v for k, v in flat.items() if k not in keys}, ".")
    if not with_state:
        return params
    state = {k: v for k, v in flat.items() if k in keys}
    return params, (unflatten(state, ".") if state else None)


def load_jax_params(model: torch.nn.Module, name: str, tree,
                    model_state=None) -> None:
    """Load a JAX params tree (and ``model_state``) into ``model``.  A
    stateful model's buffers keep their initial values when the checkpoint
    holds no state, as the JAX CLI keeps its initial ``model_state``."""
    missing, unexpected = model.load_state_dict(
        from_jax_params(name, tree, model_state), strict=False)
    allowed = set() if model_state is not None else set(STATE_KEYS.get(name, ()))
    if unexpected or set(missing) - allowed:
        raise RuntimeError(f"{name} checkpoint does not fit the model: "
                           f"missing {sorted(set(missing) - allowed)}, "
                           f"unexpected {sorted(unexpected)}")
