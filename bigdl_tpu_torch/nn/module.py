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
  initial values (the JAX package's ``init``).

``torch.nn.Module.apply(fn)`` is shadowed by the JAX package's ``apply``;
use ``modules()`` to visit submodules.
"""
from __future__ import annotations

import torch


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
