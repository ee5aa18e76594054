"""JAX parameters and model state -> the port's state, and back.

The port's modules carry the JAX trees' names and layouts, so the flat
``state_dict`` key of a leaf is its path joined with dots:

* ``Transformer._init_params`` (``bigdl_tpu/nn/attention.py``): ``embed``,
  ``ln_f: {weight, bias}``, per block ``block{i}: {attn: {wq, wk, wv,
  wo}, ffn: {w1, b1, w2, b2[, w3]}, ln1, ln2}`` -> ``block0.attn.wq``;
* ``ResNet(format="NHWC", fused="pallas")``: Sequential indices, chain
  blocks under ``"j"``; the stem weight OIHW, each block's ``w1``/``w2``/
  ``w3``/``proj_w`` HWIO and ``bn1``/``bn2``/``bn3``/``proj_bn``; its
  state tree holds each BatchNorm's ``running_mean``/``running_var`` ->
  ``4.0.w1``, ``4.0.bn1.running_mean``, ``1.running_var``.

Arrays arrive as numpy (``jax.tree_util.tree_map(np.asarray, tree)``) and
leave as numpy (:func:`to_numpy_tree` of ``model.params`` and
``model.state``, so trained weights and statistics can be compared with the
JAX package's); this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> dict:
    """Nested dict -> {dotted path: leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def unflatten(flat: dict) -> dict:
    """{dotted path: leaf} -> nested dict."""
    out: dict = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def jax_to_state_dict(params, state=None, dtype=None) -> dict:
    """A JAX parameter tree (and model state tree, for models with
    BatchNorm) of numpy arrays -> one flat ``state_dict`` of CPU tensors
    (``model.load_state_dict`` moves them to the model's device). ``dtype``
    optionally casts floating parameter leaves; the state keeps its own
    dtype (float32 running statistics)."""
    out = {}
    for name, a in flatten(params).items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":   # numpy's bf16 is not torch's
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t
    if state is not None:
        out.update(jax_to_state_dict(state))
    return out


def to_numpy_tree(tree) -> dict:
    """The port's parameter tree (nested dict of tensors, JAX's names) ->
    the same nested dict of numpy arrays on the host; bfloat16 leaves
    become float32 (numpy has no bfloat16 of torch's)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_numpy_trees(model):
    """``(params, state)`` of a port model as nested dicts of numpy arrays
    with the JAX trees' names and layouts: the way back of
    :func:`jax_to_state_dict`."""
    return to_numpy_tree(model.params), to_numpy_tree(model.state)
