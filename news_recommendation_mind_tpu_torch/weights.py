"""The weight bridge: a flax parameter tree (numpy leaves) → a PLM
``state_dict``, and back.

The tree is the JAX package's layout, ``{"params": {"bert": ...,
"user_encoder": ...}}``. Names carry over with three renames: ``layer_i``
becomes ``layers.i``; a Dense ``kernel [in, out]`` becomes
``weight [out, in]``; a LayerNorm ``scale`` and an Embed ``embedding``
become ``weight``. ``PLM.load_state_dict`` (strict) then rejects any tree
whose names or shapes do not match the model. ``torch_to_jax_tree`` is
the inverse, for any tensors named like the model's parameters (the
parameters themselves, their gradients, Adam moments), so the two
packages' training states can be compared leaf by leaf.
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, List

import numpy as np
import torch

_LAYER = re.compile(r"layer_(\d+)")


def _torch_name(path: List[str]) -> str:
    return ".".join(
        f"layers.{m.group(1)}" if (m := _LAYER.fullmatch(p)) else p
        for p in path)


def jax_params_to_torch(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Convert a flax parameter tree with numpy leaves to a state_dict."""
    root = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: List[str]) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + [key])
                continue
            arr: Any = np.asarray(val, dtype=np.float32)
            if key == "kernel":
                arr, key = arr.T, "weight"
            elif key in ("scale", "embedding"):
                key = "weight"
            out[_torch_name(path + [key])] = torch.tensor(arr)

    walk(root, [])
    return out


def torch_to_jax_tree(named: Mapping
                      ) -> Dict[str, Any]:
    """Tensors named like a PLM's parameters → ``{"params": ...}``, the
    flax-shaped tree of float32 numpy arrays: ``layers.i`` back to
    ``layer_i``, a Dense ``weight [out, in]`` to ``kernel [in, out]``, a
    norm's ``weight`` to ``scale`` and an Embedding's to ``embedding``."""
    root: Dict[str, Any] = {}
    for name, tensor in named.items():
        arr = tensor.detach().float().cpu().numpy()
        path = name.replace("layers.", "layer_").split(".")
        if path[-1] == "weight":
            if arr.ndim == 1:
                path[-1] = "scale"
            elif path[-2].endswith("embeddings"):
                path[-1] = "embedding"
            else:
                path[-1], arr = "kernel", arr.T
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return {"params": root}
