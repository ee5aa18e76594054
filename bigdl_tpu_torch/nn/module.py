"""Module base (counterpart of ``bigdl_tpu/nn/module.py``).

A thin layer over ``torch.nn.Module`` that keeps the facade names of the
JAX package's Torch-style API:

* ``forward`` - torch's own;
* ``training()`` / ``evaluate()`` - switch mode and return the module.
  ``torch.nn.Module`` keeps its mode in an attribute named ``training``, so
  here ``module.training`` reads as that flag (truthy in training mode) and
  calling it switches to training mode;
* ``parameters`` - torch's own;
* ``params`` - the module's parameters as a nested dict with the JAX
  parameter tree's names. The model code is written as functions of such a
  tree (``call(params, x)``, ``Transformer.generate(params, ...)``), as the
  JAX package is, so a serving registry can hold several versions of one
  model's weights;
* ``state`` - the module's state (its buffers: BatchNorm running
  statistics, ``running_mean`` / ``running_var``) as a nested dict with the
  JAX state tree's names, and ``apply(params, state, x, training)`` ->
  ``(output, new_state)``, the functional forward that the training loop
  differentiates. It returns new state tensors (detached) and leaves the
  given ones as they are; ``forward`` in training mode writes them back;
* ``reset(generator)`` - draws the parameters anew from their initialisers
  (``nn.init``), with ``generator`` (a ``torch.Generator`` on the
  parameters' device) or torch's global one, and sets the state to its
  initial values (the JAX package's ``init``);
* ``modules_iter`` / ``find_module`` / ``get_name`` / ``set_name``, and
  fine-tuning: ``freeze(*names)`` / ``unfreeze(*names)`` / ``is_frozen``
  flag whole subtrees of ``modules_iter`` (a container and its children;
  a composite module such as a fused ResNet stage is one module), and the
  training loop zeroes a frozen leaf's gradient and keeps its value;
* ``get_weights`` / ``set_weights`` (nested dicts of numpy arrays) and
  ``save_weights`` / ``load_weights``: one ``.npz`` with the JAX trees'
  "/"-joined names and layouts, so either package loads the other's file.

``torch.nn.Module.apply(fn)`` is shadowed by the JAX package's ``apply``;
use ``modules()`` to visit submodules.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import flatten, host_copy_tree, to_numpy_tree, unflatten


class _TrainingFlag:
    __slots__ = ("_module",)

    def __init__(self, module):
        self._module = module

    def __bool__(self):
        return self._module.__dict__.get("_train_mode", True)

    def __call__(self):
        return self._module.train(True)

    def __repr__(self):
        return repr(bool(self))


class Module(torch.nn.Module):
    """``name`` labels the module as the JAX package's ``name`` does (the
    class name and a process-wide instance number when not given)."""

    _instance_counter = [0]

    def __init__(self, name=None):
        super().__init__()
        Module._instance_counter[0] += 1
        n = Module._instance_counter[0]
        self.name = name or f"{type(self).__name__}{n}"

    @property
    def training(self):
        return _TrainingFlag(self)

    @training.setter
    def training(self, mode):
        self.__dict__["_train_mode"] = bool(mode)

    def evaluate(self):
        return self.train(False)

    @property
    def params(self) -> dict:
        """Nested dict of this module's parameters (the tensors
        themselves, not copies)."""
        out = {n: p for n, p in self._parameters.items() if p is not None}
        for n, m in self._modules.items():
            out[n] = m.params
        return out

    @property
    def state(self) -> dict:
        """Nested dict of this module's state (its persistent buffers, the
        tensors themselves)."""
        skip = self._non_persistent_buffers_set
        out = {n: b for n, b in self._buffers.items()
               if b is not None and n not in skip}
        for n, m in self._modules.items():
            out[n] = m.state
        return out

    def ensure_initialized(self):
        """The JAX package builds parameters lazily, on first use; the
        port's modules hold theirs from construction, so this returns the
        module as it is (the serving entry points call it as JAX's do)."""
        return self

    def evaluate_dataset(self, dataset, methods, batch_size=32):
        """Evaluate this module on ``dataset`` with the validation
        ``methods`` (``optim.evaluator.Evaluator``): one result each."""
        from ..optim.evaluator import Evaluator
        return Evaluator(self).evaluate(dataset, methods, batch_size)

    def call(self, params, x):
        """The forward as a function of a parameter tree."""
        raise NotImplementedError(type(self).__name__)

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        """The forward as a function of a parameter tree and a state tree:
        ``(output, new_state)``. Stateless modules return the state they
        were given."""
        return self.call(params, x), state

    def forward(self, x):
        state = self.state
        out, new_state = self.apply(self.params, state, x,
                                    training=bool(self.training))
        assign_state(state, new_state)
        return out

    def reset(self, generator=None):
        """Initialise every parameter and state tensor of this module and
        its children anew; modules that hold them override ``_reset``."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Module):
                    m._reset(generator)
        return self

    def _reset(self, generator):
        pass

    # -- names and the module walk ----------------------------------------
    def set_name(self, name):
        self.name = name
        return self

    def get_name(self):
        return self.name

    def modules_iter(self):
        """This module and, for a container, its children's walks in
        order (the JAX package's module walk: a composite module that is
        not a container counts as one)."""
        yield self

    def find_module(self, name):
        for m in self.modules_iter():
            if m.name == name:
                return m
        return None

    # -- fine-tuning ------------------------------------------------------
    def freeze(self, *names):
        """Mark this module (or the named descendants) and every module
        under it as not to be updated: the training loop zeroes their
        gradients and keeps their parameters through the update, so
        weight decay does not move them either."""
        for t in self._freeze_targets(names, "freeze"):
            for m in t.modules_iter():
                m._frozen = True
        return self

    def unfreeze(self, *names):
        for t in self._freeze_targets(names, "unfreeze"):
            for m in t.modules_iter():
                m._frozen = False
        return self

    def _freeze_targets(self, names, what):
        if not names:
            return [self]
        targets = []
        for n in names:
            m = self.find_module(n)
            if m is None:
                raise ValueError(f"{what}: no module named {n}")
            targets.append(m)
        return targets

    def is_frozen(self):
        return getattr(self, "_frozen", False)

    # -- weights ----------------------------------------------------------
    def get_weights(self):
        """The parameters as a nested dict of host numpy arrays (copies)."""
        return host_copy_tree(self.params)

    def set_weights(self, weights):
        """Copy a nested dict of arrays (the tree ``get_weights`` gives)
        into the parameters, each cast to its parameter's dtype."""
        copy_tree_into(self.params, weights)
        return self

    def save_weights(self, path):
        """The parameters in one ``.npz``, keyed by their "/"-joined tree
        names (numpy's ``savez`` adds the suffix when ``path`` lacks it)."""
        flat = flatten(to_numpy_tree(self.params))
        np.savez(path, **{k.replace(".", "/"): v for k, v in flat.items()})
        return self

    def load_weights(self, path):
        path = str(path)
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        copy_tree_into(self.params, unflatten(
            {k: data[k.replace(".", "/")] for k in flatten(self.params)}))
        return self


def copy_tree_into(live, host):
    """Copy each leaf of ``host`` (arrays or tensors, the same tree as
    ``live``) into the matching tensor of ``live`` in place, cast to the
    live tensor's dtype and device; numpy's bfloat16 (``ml_dtypes``) goes
    through float32."""
    with torch.no_grad():
        for k, t in live.items():
            if isinstance(t, dict):
                if flatten(t):      # a subtree without leaves has no key
                    copy_tree_into(t, host[k])
                continue
            v = host[k]
            if not isinstance(v, torch.Tensor):
                a = np.asarray(v)
                if a.dtype.name == "bfloat16":
                    a = a.astype(np.float32)
                v = torch.from_numpy(np.array(a, copy=True))
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} does not "
                                 f"match {tuple(t.shape)}")
            t.copy_(v)


def assign_state(state, new_state):
    """Copy each leaf of ``new_state`` into the matching tensor of
    ``state`` in place (leaves that are the same tensor are skipped)."""
    with torch.no_grad():
        for k, old in state.items():
            new = new_state[k]
            if isinstance(old, dict):
                assign_state(old, new)
            elif new is not old:
                old.copy_(new)


class Container(Module):
    """Base container holding an ordered list of children under the keys
    ``"0"``, ``"1"``, ... (the JAX package's ``Container``), so the params
    and state trees are keyed by child index."""

    def __init__(self, *modules, name=None):
        super().__init__(name=name)
        for m in modules:
            self.add(m)

    def add(self, module):
        self.add_module(str(len(self._modules)), module)
        return self

    def __getitem__(self, i):
        return self._modules[str(i)]

    def modules_iter(self):
        yield self
        for m in self._modules.values():
            yield from m.modules_iter()

    def child_apply(self, i, params, state, x, training, generator):
        """Apply child ``i`` to its own subtrees: ``(output, new_sub)``."""
        return self._modules[str(i)].apply(params[str(i)], state[str(i)], x,
                                           training, generator)


class Criterion:
    """Loss base (counterpart of the JAX package's ``Criterion``, parity
    with the reference's AbstractCriterion): ``forward(input, target)`` ->
    scalar tensor (differentiable in ``input``); ``backward`` derives
    gradInput with ``torch.autograd.grad`` instead of a hand-written
    updateGradInput."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average
        self.output = None
        self.grad_input = None

    def _forward(self, input, target):
        raise NotImplementedError(type(self).__name__)

    def forward(self, input, target):
        self.output = self._forward(input, target)
        return self.output

    def __call__(self, input, target):
        return self.forward(input, target)

    def backward(self, input, target):
        x = input.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self._forward(x, target)
        self.grad_input, = torch.autograd.grad(loss, x)
        return self.grad_input
