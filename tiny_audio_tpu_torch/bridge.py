"""Carry parameters between the JAX package's params tree and the PyTorch model.

:func:`load_jax_params` takes the JAX ``ASRModel.params`` tree
(``{"encoder", "decoder", "projector"}``) with numpy leaves (e.g.
``jax.tree.map(np.asarray, jax_model.params)``) or torch-tensor leaves (a
checkpoint read by :mod:`tiny_audio_tpu_torch.utils.msgpack_io`), and fills
the port's modules:

- ``nn.scan`` stacks layers on axis 0; entry ``i`` goes to ``layers[i]``;
- a Dense ``kernel [in, out]`` becomes a Linear ``weight [out, in]``;
- a Conv ``kernel [k, in, out]`` becomes a Conv1d ``weight [out, in, k]``;
- an Embed ``embedding`` becomes ``embed_tokens.weight`` (the tied LM head
  reads that same tensor);
- every other leaf (norms, biases, ``embed_positions``, ``q_norm``, flax
  ``LayerNorm``'s ``scale``, QFormer's ``query`` ``[1, nq, hidden]``, MoE's
  stacked ``experts_fc{1,2}_{kernel,bias}`` ``[E, in, out]``) keeps its
  name and layout.

Each value is converted to the dtype of the parameter it fills, so the fp32
norm and projector params stay fp32; bfloat16 leaves are read as bfloat16
(no round trip through fp32).  It raises on a leaf it does not consume and,
unless told otherwise, on a port parameter left unset.

:func:`state_dict_to_jax` is the inverse: the port's parameters as the JAX
params tree, for writing a checkpoint the JAX package loads.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, prefix + (str(key),))
    else:
        yield prefix, tree


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    value = np.asarray(leaf)
    if value.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 has torch's bits
        return torch.from_numpy(value.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(value))  # a copy: JAX hands out read-only arrays


def _to_torch_layout(leaf_name: str, value: torch.Tensor) -> tuple[str, torch.Tensor]:
    if leaf_name == "kernel":
        if value.ndim == 2:  # Dense [in, out] -> Linear [out, in]
            return "weight", value.T
        if value.ndim == 3:  # Conv [k, in, out] -> Conv1d [out, in, k]
            return "weight", value.permute(2, 1, 0)
        raise ValueError(f"kernel of rank {value.ndim} has no torch layout")
    if leaf_name == "embedding":
        return "weight", value
    return leaf_name, value


def jax_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """Flat ``{torch parameter name: tensor}`` for a JAX ASRModel params tree
    (views of the leaves, in their own dtype)."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        value = _as_tensor(leaf)
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
def load_jax_params(model: nn.Module, params: dict, require_all: bool = True) -> None:
    """Fill ``model`` (a port ``ASRModel``) from a JAX params tree.  With
    ``require_all=False`` parameters the tree does not hold keep their values
    (a checkpoint without one of the towers)."""
    state = dict(model.named_parameters())
    unset = set(state)
    for name, value in jax_to_state_dict(params).items():
        if name not in state:
            raise KeyError(f"JAX leaf {name!r} has no counterpart in the PyTorch model")
        param = state[name]
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{name}: JAX shape {tuple(value.shape)} vs PyTorch "
                             f"{tuple(param.shape)}")
        param.copy_(value)
        unset.discard(name)
    if unset and require_all:
        raise KeyError(f"PyTorch parameters left unset: {sorted(unset)}")


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


@torch.no_grad()
def state_dict_to_jax(model: nn.Module) -> dict:
    """The JAX params tree of a port ``ASRModel``: CPU tensors in the
    parameters' dtypes, layers stacked on axis 0, Linear and Conv1d weights
    as Dense and Conv kernels, Embedding weights as ``embedding``."""
    modules = dict(model.named_modules())
    tree: dict = {}
    stacks: dict = {}  # JAX path -> {layer index: tensor}
    for name, param in model.named_parameters():
        *module_path, leaf = name.split(".")
        module = modules[".".join(module_path)]
        value = param.detach().cpu()
        if leaf == "weight" and isinstance(module, nn.Linear):
            leaf, value = "kernel", value.T
        elif leaf == "weight" and isinstance(module, nn.Conv1d):
            leaf, value = "kernel", value.permute(2, 1, 0)
        elif leaf == "weight" and isinstance(module, nn.Embedding):
            leaf = "embedding"
        if len(module_path) > 2 and module_path[1] == "layers":
            tower, _, index, *rest = module_path
            stacks.setdefault((tower, "layers", *rest, leaf), {})[int(index)] = value
        else:
            _set(tree, (*module_path, leaf), value.contiguous())
    for path, by_index in stacks.items():
        _set(tree, path, torch.stack([by_index[i] for i in range(len(by_index))]))
    return tree
