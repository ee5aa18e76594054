"""JAX parameters and model state -> the port's state, and back.

The port's modules carry the JAX trees' names and layouts, so the flat
``state_dict`` key of a leaf is its path joined with dots:

* ``Transformer._init_params`` (``bigdl_tpu/nn/attention.py``): ``embed``,
  ``ln_f: {weight, bias}``, per block ``block{i}: {attn: {wq, wk, wv,
  wo}, ffn: {w1, b1, w2, b2[, w3]}, ln1, ln2}`` -> ``block0.attn.wq``;
  in translation mode each decoder block also holds ``cross: {wq, wk, wv,
  wo}`` and ``ln3``, beside the encoder's ``enc_block{i}`` ->
  ``enc_block0.attn.wq``, ``block0.cross.wq``, ``block0.ln3.weight``;
* ``ResNet(format="NHWC", fused="pallas")`` (and ``"xla"``): Sequential
  indices, chain blocks under ``"j"``; the stem weight OIHW, each block's
  ``w1``/``w2``/``w3``/``proj_w`` HWIO and ``bn1``/``bn2``/``bn3``/
  ``proj_bn``; its state tree holds each BatchNorm's ``running_mean``/
  ``running_var`` -> ``4.0.w1``, ``4.0.bn1.running_mean``,
  ``1.running_var``; unchained (``fused_chain=False``, JAX's
  ``BIGDL_TPU_FUSED_CHAIN=0``) the blocks sit at the Sequential's own
  indices -> ``4.w1`` ... ``19.bn3.weight``, and the classifier at 22;
* ``MoETransformerLM``: the Transformer's names, a MoE block's ``ffn``
  holding ``router`` (D, E), ``w1`` (E, D, F) and ``w2`` (E, F, D) ->
  ``block1.ffn.router``; its state tree is ``aux_loss`` alone;
* ``Graph`` / ``StaticGraph`` / ``DynamicGraph``: each node's module
  under ``str(mod_idx)``, its index in the graph's topological order ->
  ``3.weight``;
* the sparse layers: ``SparseLinear`` is ``Linear``'s ``weight`` (out,
  in) / ``bias``, ``LookupTableSparse`` ``LookupTable``'s ``weight``;
* ``NeuralCF``: ``0.{mf_user, mf_item, mlp_user, mlp_item}``,
  ``1.mlp.{0, 2, ...}.{weight, bias}``, ``1.final``; ``WideAndDeep``:
  ``0.{wide_user, wide_item, wide_cross, emb_user, emb_item}``,
  ``1.deep.{0, 2, ...}``, ``1.deep_out``, ``1.bias`` (a scalar).

Arrays arrive as numpy (``jax.tree_util.tree_map(np.asarray, tree)``) and
leave as numpy (:func:`to_numpy_tree` of ``model.params`` and
``model.state``, so trained weights and statistics can be compared with the
JAX package's); this module imports no JAX. A parameter tree that serves
as it is (a registry version, ``generate``'s params) crosses with
:func:`to_torch_tree`, which also carries JAX's quantized weights over
(``quantization.lm``: int8 codes and float32 scales; JAX's int4 codes
become int8 through numpy); the port's quantized weights leave as the
port's carriers over numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils.carrier import TreeCarrier


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
    if isinstance(tree, TreeCarrier):
        return tree.map(to_numpy_tree)
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def host_copy_tree(tree) -> dict:
    """:func:`to_numpy_tree` with every leaf a host copy of its own, never
    a view of a CPU tensor's memory: what a checkpoint or ``get_weights``
    holds while training goes on writing the tensors in place."""
    if isinstance(tree, dict):
        return {k: host_copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, TreeCarrier):
        return tree.map(host_copy_tree)
    a = to_numpy_tree(tree)
    return np.array(a, copy=True) if tree.device.type == "cpu" else a


def _host_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy's bf16 is not torch's
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    elif a.dtype.name == "int4":         # JAX's int4 codes, held as int8
        t = torch.from_numpy(a.astype(np.int8))
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t if device is None else t.to(device)


def to_torch_tree(tree, device=None):
    """A JAX parameter tree (nested dicts, lists and tuples of numpy or JAX
    arrays) -> the same tree of tensors on ``device`` (the CPU by
    default). JAX's quantized weights (objects with ``q`` and ``s``, and
    ``group`` for int4) become the port's ``QuantizedWeight`` /
    ``QuantizedWeightInt4``."""
    if isinstance(tree, dict):
        return {k: to_torch_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch_tree(v, device) for v in tree)
    if hasattr(tree, "q") and hasattr(tree, "s"):
        from .quantization.lm import QuantizedWeight, QuantizedWeightInt4
        q, s = _host_tensor(tree.q, device), _host_tensor(tree.s, device)
        if hasattr(tree, "group"):
            return QuantizedWeightInt4(q, s, group=tree.group)
        return QuantizedWeight(q, s)
    return _host_tensor(tree, device)


def to_numpy_trees(model):
    """``(params, state)`` of a port model as nested dicts of numpy arrays
    with the JAX trees' names and layouts: the way back of
    :func:`jax_to_state_dict`."""
    return to_numpy_tree(model.params), to_numpy_tree(model.state)
