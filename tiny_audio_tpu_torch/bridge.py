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

The HF converters (``convert_hf_*`` beside the port's modules,
:mod:`tiny_audio_tpu_torch.convert`) build that same tree from an HF state
dict with :func:`host_array` and :func:`cast_leaf`, so one table here maps
every name.
"""

from __future__ import annotations

from typing import Optional

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


def host_array(w) -> np.ndarray:
    """A state-dict value as numpy on the host: a torch tensor of any dtype
    through float32, a numpy array as it is (the JAX package's converters
    read values so, and the casts below then round them the same way)."""
    if isinstance(w, torch.Tensor):
        return w.detach().cpu().float().numpy()
    return np.asarray(w)


def cast_leaf(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A converted leaf as a contiguous CPU tensor of ``dtype``, rounded to
    nearest even as ``jnp.asarray(a, dtype)`` rounds it."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


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


def jax_leaf(modules: dict, name: str) -> tuple[tuple, Optional[int], Optional[str]]:
    """Where the port parameter ``name`` sits in the JAX params tree:
    (path, layer index of a scanned stack or None, ``"dense"`` / ``"conv"``
    when the value is transposed into a kernel, else None).  ``modules``
    is ``dict(model.named_modules())``."""
    *module_path, leaf = name.split(".")
    module = modules[".".join(module_path)]
    layout = None
    if leaf == "weight" and isinstance(module, nn.Linear):
        leaf, layout = "kernel", "dense"
    elif leaf == "weight" and isinstance(module, nn.Conv1d):
        leaf, layout = "kernel", "conv"
    elif leaf == "weight" and isinstance(module, nn.Embedding):
        leaf = "embedding"
    if len(module_path) > 2 and module_path[1] == "layers":
        tower, _, index, *rest = module_path
        return (tower, "layers", *rest, leaf), int(index), layout
    return (*module_path, leaf), None, layout


@torch.no_grad()
def state_dict_to_jax(model: nn.Module, values: Optional[dict] = None) -> dict:
    """The JAX params tree of a port ``ASRModel``: CPU tensors in the
    parameters' dtypes, layers stacked on axis 0, Linear and Conv1d weights
    as Dense and Conv kernels, Embedding weights as ``embedding``.
    ``values``: the tensors by parameter name instead of the model's own (a
    sharded model's gathered parameters)."""
    modules = dict(model.named_modules())
    tree: dict = {}
    stacks: dict = {}  # JAX path -> {layer index: tensor}
    for name, param in model.named_parameters():
        path, index, layout = jax_leaf(modules, name)
        value = (param if values is None else values[name]).detach().cpu()
        if layout == "dense":
            value = value.T
        elif layout == "conv":
            value = value.permute(2, 1, 0)
        if index is None:
            _set(tree, path, value.contiguous())
        else:
            stacks.setdefault(path, {})[index] = value
    for path, by_index in stacks.items():
        _set(tree, path, torch.stack([by_index[i] for i in range(len(by_index))]))
    return tree


_GRU_CELL = {"ir": ("kernel", "bias"), "iz": ("kernel", "bias"), "in": ("kernel", "bias"),
             "hr": ("kernel",), "hz": ("kernel",), "hn": ("kernel", "bias")}


def _is_gru_cell(tree) -> bool:
    return isinstance(tree, dict) and set(tree) == set(_GRU_CELL)


def _gru_state(prefix: str, cell: dict) -> dict[str, torch.Tensor]:
    """A flax GRUCell as ``nn.GRU``'s layer-0 tensors (gates r, z, n)."""
    for gate, leaves in _GRU_CELL.items():
        if set(cell[gate]) != set(leaves):
            raise KeyError(f"{prefix}.{gate}: leaves {sorted(cell[gate])}, expected {leaves}")
    kernel = {g: _as_tensor(cell[g]["kernel"]).T for g in _GRU_CELL}
    b_in = [_as_tensor(cell[f"i{g}"]["bias"]) for g in "rzn"]
    b_hn = _as_tensor(cell["hn"]["bias"])
    zero = torch.zeros_like(b_hn)
    return {f"{prefix}.weight_ih_l0": torch.cat([kernel[f"i{g}"] for g in "rzn"]),
            f"{prefix}.weight_hh_l0": torch.cat([kernel[f"h{g}"] for g in "rzn"]),
            f"{prefix}.bias_ih_l0": torch.cat(b_in),
            f"{prefix}.bias_hh_l0": torch.cat([zero, zero, b_hn])}


_TOWER_LEAVES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _tower_state(tree: dict, prefix: tuple = ()) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for key, sub in tree.items():
        path = prefix + (str(key),)
        if _is_gru_cell(sub):
            out.update(_gru_state(".".join(path), sub))
        elif isinstance(sub, dict):
            out.update(_tower_state(sub, path))
        else:
            name, value = _to_torch_layout(path[-1], _as_tensor(sub))
            out[".".join([*path[:-1], _TOWER_LEAVES.get(name, name)])] = value
    return out


@torch.no_grad()
def load_flax_tower(module: nn.Module, tree: dict) -> None:
    """Fill a tower ``module`` (parameters and buffers) from its flax params
    tree, each value in the dtype of the tensor it fills.  Raises on a leaf
    it does not consume and on a tensor left unset."""
    state = module.state_dict(keep_vars=True)
    unset = set(state)
    for name, value in _tower_state(tree).items():
        if name not in state:
            raise KeyError(f"flax leaf {name!r} has no counterpart in {type(module).__name__}")
        target = state[name]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{name}: flax shape {tuple(value.shape)} vs PyTorch "
                             f"{tuple(target.shape)}")
        target.copy_(value)
        unset.discard(name)
    if unset:
        raise KeyError(f"{type(module).__name__} tensors left unset: {sorted(unset)}")


def _gru_cell(gru: nn.GRU) -> dict:
    """``nn.GRU``'s layer 0 as a flax GRUCell (the inverse of
    :func:`_gru_state`); flax's cell has no hidden bias for r and z, so
    those must be zero."""
    h = gru.hidden_size
    w_ih, w_hh = gru.weight_ih_l0.detach().cpu(), gru.weight_hh_l0.detach().cpu()
    b_ih, b_hh = gru.bias_ih_l0.detach().cpu(), gru.bias_hh_l0.detach().cpu()
    if b_hh[:2 * h].any():
        raise ValueError("the GRU's hidden biases of r and z are not zero: no flax GRUCell "
                         "holds them")
    cell = {}
    for i, g in enumerate("rzn"):
        rows = slice(i * h, (i + 1) * h)
        cell[f"i{g}"] = {"kernel": w_ih[rows].T.contiguous(), "bias": b_ih[rows].clone()}
        cell[f"h{g}"] = {"kernel": w_hh[rows].T.contiguous()}
    cell["hn"]["bias"] = b_hh[2 * h:].clone()
    return cell


@torch.no_grad()
def tower_flax_tree(module: nn.Module) -> dict:
    """The flax params tree of a tower (CPU tensors; an ``nn.GRU`` as flax's
    GRUCell): the inverse of :func:`load_flax_tower`, for writing the file
    the JAX package reads."""
    modules = dict(module.named_modules())
    inverse = {v: k for k, v in _TOWER_LEAVES.items()}
    tree: dict = {}
    for name, value in module.state_dict().items():
        *owner_path, leaf = name.split(".")
        owner = modules[".".join(owner_path)]
        if isinstance(owner, nn.GRU):
            if leaf == "weight_ih_l0":  # the whole cell, once
                _set(tree, tuple(owner_path), _gru_cell(owner))
            continue
        value = value.detach().cpu()
        if leaf == "weight" and isinstance(owner, nn.Linear):
            leaf, value = "kernel", value.T
        elif leaf == "weight" and isinstance(owner, nn.Conv1d):
            leaf, value = "kernel", value.permute(2, 1, 0)
        else:
            leaf = inverse.get(leaf, leaf)
        _set(tree, (*owner_path, leaf), value.contiguous())
    return tree
