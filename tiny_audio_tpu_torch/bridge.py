"""Carry the JAX package's parameters into the PyTorch model.

:func:`load_jax_params` takes the JAX ``ASRModel.params`` tree
(``{"encoder", "decoder", "projector"}``) with numpy leaves, e.g.
``jax.tree.map(np.asarray, jax_model.params)``, and fills the port's modules:

- ``nn.scan`` stacks layers on axis 0; entry ``i`` goes to ``layers[i]``;
- a Dense ``kernel [in, out]`` becomes a Linear ``weight [out, in]``;
- a Conv ``kernel [k, in, out]`` becomes a Conv1d ``weight [out, in, k]``;
- an Embed ``embedding`` becomes ``embed_tokens.weight`` (the tied LM head
  reads that same tensor);
- every other leaf (norms, biases, ``embed_positions``, ``q_norm``) keeps its
  name and layout.

Each value is converted to the dtype of the parameter it fills, so the fp32
norm and projector params stay fp32.  It raises on a leaf it does not
consume and on a port parameter left unset.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, prefix + (str(key),))
    else:
        yield prefix, tree


def _to_torch_layout(leaf_name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf_name == "kernel":
        if value.ndim == 2:  # Dense [in, out] -> Linear [out, in]
            return "weight", value.T
        if value.ndim == 3:  # Conv [k, in, out] -> Conv1d [out, in, k]
            return "weight", value.transpose(2, 1, 0)
        raise ValueError(f"kernel of rank {value.ndim} has no torch layout")
    if leaf_name == "embedding":
        return "weight", value
    return leaf_name, value


def jax_to_state_dict(params_np: dict) -> dict[str, np.ndarray]:
    """Flat ``{torch parameter name: array}`` for a JAX ASRModel params tree."""
    out: dict[str, np.ndarray] = {}
    for path, leaf in _flatten(params_np):
        value = np.asarray(leaf)
        if not np.issubdtype(value.dtype, np.floating) or value.dtype.itemsize < 4:
            value = value.astype(np.float32)  # bfloat16 leaves: torch takes no ml_dtypes
        if len(path) > 2 and path[1] == "layers":  # scanned stack: [L, ...]
            tower, _, *rest = path
            for i in range(value.shape[0]):
                name, arr = _to_torch_layout(rest[-1], value[i])
                out[".".join([tower, "layers", str(i), *rest[:-1], name])] = arr
        else:
            name, arr = _to_torch_layout(path[-1], value)
            out[".".join([*path[:-1], name])] = arr
    return out


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, params_np: dict) -> None:
    """Fill ``model`` (a port ``ASRModel``) from JAX params with numpy leaves."""
    state = dict(model.named_parameters())
    unset = set(state)
    for name, arr in jax_to_state_dict(params_np).items():
        if name not in state:
            raise KeyError(f"JAX leaf {name!r} has no counterpart in the PyTorch model")
        param = state[name]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} vs PyTorch {tuple(param.shape)}")
        param.copy_(torch.tensor(arr))  # copies: JAX hands out read-only arrays
        unset.discard(name)
    if unset:
        raise KeyError(f"PyTorch parameters left unset: {sorted(unset)}")
