"""GPT-2 weights between the flax parameter tree and the port's state dict.

Flax Dense kernels are stored (in, out) and ``nn.Linear.weight`` is
(out, in); a LayerNorm ``scale`` is ``weight``; ``wte`` stays tied to the
head.  The flax tree comes in two layouts: the scanned stack
(``blocks/<module>/<leaf>`` with a leading layer dim, the reference's
default) and one ``h_<i>`` subtree per layer.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

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
