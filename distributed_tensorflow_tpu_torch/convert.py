"""Weights between the flax variable trees and the port's state dicts.

GPT-2 (``params_from_flax``/``params_to_flax``): Flax Dense kernels are
stored (in, out) and ``nn.Linear.weight`` is (out, in); a LayerNorm
``scale`` is ``weight``; ``wte`` stays tied to the head.  The flax tree
comes in two layouts: the scanned stack (``blocks/<module>/<leaf>`` with a
leading layer dim, the reference's default) and one ``h_<i>`` subtree per
layer.

MNIST, ResNet, BERT and Wide&Deep/DLRM (``variables_from_flax``/
``variables_to_flax``): the
port's modules carry the flax names, so a torch name is the flax path
joined by dots, and the owning module's type says how the leaf converts:
Conv kernels HWIO <-> OIHW ``weight``, Dense kernels (in, out) <->
``weight`` (out, in), ``embedding`` <-> an ``nn.Embedding``'s ``weight`` (a
``ShardedEmbed``'s is named ``embedding`` already), a norm's ``scale`` <->
``weight``.  A tensor keeps the dtype of the module's (a bf16 table comes
out of the flax tree bf16, exactly, through float32).  BatchNorm's ``batch_stats`` collection
(``mean``, ``var``) is the port's buffers of the same names.  A subtree
scanned over layers (BERT's ``layers``, leading axis ``n_layer``) is the
port's ``ModuleList`` of the same name.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_DENSE = ("c_attn", "c_proj", "mlp_c_fc", "mlp_c_proj")
_NORMS = ("ln_1", "ln_2")


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _layer_to_torch(prefix: str, layer: Mapping[str, Any], out: Dict[str, torch.Tensor]):
    for m in _DENSE:
        out[f"{prefix}.{m}.weight"] = torch.from_numpy(np.ascontiguousarray(_np(layer[m]["kernel"]).T))
        out[f"{prefix}.{m}.bias"] = torch.from_numpy(_np(layer[m]["bias"]).copy())
    for m in _NORMS:
        out[f"{prefix}.{m}.weight"] = torch.from_numpy(_np(layer[m]["scale"]).copy())
        out[f"{prefix}.{m}.bias"] = torch.from_numpy(_np(layer[m]["bias"]).copy())


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax GPT-2 params (either layout) -> the port's ``GPT2`` state dict
    (float32 CPU tensors)."""
    out = {
        "wte": torch.from_numpy(_np(tree["wte"]).copy()),
        "wpe": torch.from_numpy(_np(tree["wpe"]).copy()),
        "ln_f.weight": torch.from_numpy(_np(tree["ln_f"]["scale"]).copy()),
        "ln_f.bias": torch.from_numpy(_np(tree["ln_f"]["bias"]).copy()),
    }
    if "blocks" in tree:
        stack = tree["blocks"]
        n_layer = np.shape(stack["c_attn"]["kernel"])[0]
        for i in range(n_layer):
            layer = {m: {leaf: _np(v)[i] for leaf, v in stack[m].items()}
                     for m in _DENSE + _NORMS}
            _layer_to_torch(f"blocks.{i}", layer, out)
    else:
        i = 0
        while f"h_{i}" in tree:
            _layer_to_torch(f"blocks.{i}", tree[f"h_{i}"], out)
            i += 1
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor], *, scanned: bool = True
                   ) -> Dict[str, Any]:
    """The port's state dict (or a dict of its gradients) -> a flax tree
    of float32 numpy arrays, scanned (``blocks``) or per-layer (``h_i``)."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    n_layer = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    layers = []
    for i in range(n_layer):
        layer = {m: {"kernel": sd[f"blocks.{i}.{m}.weight"].T,
                     "bias": sd[f"blocks.{i}.{m}.bias"]} for m in _DENSE}
        layer.update({m: {"scale": sd[f"blocks.{i}.{m}.weight"],
                          "bias": sd[f"blocks.{i}.{m}.bias"]} for m in _NORMS})
        layers.append(layer)
    tree: Dict[str, Any] = {
        "wte": sd["wte"],
        "wpe": sd["wpe"],
        "ln_f": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]},
    }
    if scanned:
        tree["blocks"] = {m: {leaf: np.stack([l[m][leaf] for l in layers])
                              for leaf in layers[0][m]} for m in _DENSE + _NORMS}
    else:
        tree.update({f"h_{i}": layer for i, layer in enumerate(layers)})
    return tree


# -- MNIST, ResNet, BERT -------------------------------------------------------

def _flax_leaf(module: nn.Module, name: str, is_buffer: bool,
               scanned: Iterable[str]) -> Tuple[str, List[str], int, str]:
    """(collection, flax path, layer index or -1, kind) of a torch name."""
    parts = name.split(".")
    owner = module.get_submodule(".".join(parts[:-1])) if len(parts) > 1 else module
    leaf = parts[-1]
    kind = "copy"
    if is_buffer:
        collection = "batch_stats"
    else:
        collection = "params"
        if leaf == "weight" and isinstance(owner, nn.Conv2d):
            leaf, kind = "kernel", "conv"
        elif leaf == "weight" and isinstance(owner, nn.Linear):
            leaf, kind = "kernel", "dense"
        elif leaf == "weight" and isinstance(owner, nn.Embedding):
            leaf = "embedding"
        elif leaf == "weight" and owner is not module:  # LayerNorm, BatchNorm
            leaf = "scale"
    path, index = parts[:-1] + [leaf], -1
    if parts[0] in scanned:
        index = int(parts[1])
        path = [parts[0]] + path[2:]
    return collection, path, index, kind


def _to_torch_layout(x: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(x, (3, 2, 0, 1))  # HWIO -> OIHW
    return x.T if kind == "dense" else x


def _to_flax_layout(x: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(x, (2, 3, 1, 0))  # OIHW -> HWIO
    return x.T if kind == "dense" else x


def _named_tensors(module: nn.Module):
    yield from ((n, False) for n, _ in module.named_parameters())
    yield from ((n, True) for n, _ in module.named_buffers())


def variables_from_flax(module: nn.Module, variables: Mapping[str, Any], *,
                        scanned: Iterable[str] = ("layers",)) -> Dict[str, torch.Tensor]:
    """Flax variables ({"params": ..., "batch_stats": ...}) -> a state dict
    for ``module`` (CPU tensors in the module's dtypes), ready for
    ``load_state_dict``."""
    out = {}
    dtypes = {n: t.dtype for n, t in (*module.named_parameters(), *module.named_buffers())}
    for name, is_buffer in _named_tensors(module):
        collection, path, index, kind = _flax_leaf(module, name, is_buffer, tuple(scanned))
        x = variables[collection]
        for key in path:
            x = x[key]
        x = _np(x)
        if index >= 0:
            x = x[index]
        out[name] = torch.from_numpy(np.array(_to_torch_layout(x, kind), order="C")).to(
            dtypes[name])
    return out


def variables_to_flax(module: nn.Module, tensors: Mapping[str, torch.Tensor], *,
                      scanned: Iterable[str] = ("layers",)) -> Dict[str, Any]:
    """Tensors named as ``module``'s parameters and buffers (its state dict,
    or a dict of its gradients or optimizer moments) -> flax variables of
    float32 numpy arrays; a collection none of whose tensors is given is
    left out."""
    scanned = tuple(scanned)
    stacks: Dict[Tuple[str, Tuple[str, ...]], Dict[int, np.ndarray]] = {}
    tree: Dict[str, Any] = {}
    for name, is_buffer in _named_tensors(module):
        if name not in tensors:
            continue
        collection, path, index, kind = _flax_leaf(module, name, is_buffer, scanned)
        x = np.array(_to_flax_layout(tensors[name].detach().float().cpu().numpy(), kind))
        if index >= 0:
            stacks.setdefault((collection, tuple(path)), {})[index] = x
            continue
        node = tree.setdefault(collection, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x
    for (collection, path), layers in stacks.items():
        node = tree.setdefault(collection, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([layers[i] for i in range(len(layers))])
    return tree
