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
  "/"-joined names and layouts, so either package loads the other's file;
* ``init(generator)`` -> freshly drawn ``(params, state)`` trees (the
  module keeps its own), ``clone`` (a deep copy sharing no storage),
  ``get_extra_parameter`` / ``set_extra_parameter`` (the state leaves in
  the JAX trees' order: keys sorted at every level), ``predict`` /
  ``predict_class`` (``optim.predictor.Predictor``), and ``save`` /
  ``load``: a pickle with JAX's payload keys (``module``, ``params``,
  ``state``), the trees as numpy in JAX's layout and the module without
  its tensors. ``load`` refuses a file the JAX package wrote (it would
  import ``bigdl_tpu``): ``save_weights`` / ``load_weights`` or
  ``convert`` cross between the packages;
* the Torch backward protocol: ``backward(x, grad_output)`` returns the
  input's gradient and adds the parameters' gradients, times
  ``set_scale_w``'s factor, into ``grad_params`` (a tree like ``params``);
  ``update_grad_input`` only the former, ``acc_grad_parameters`` both (as
  JAX's); ``zero_grad_parameters``; ``get_parameters`` -> one flat weight
  vector, one flat gradient vector (copies, in the JAX trees' flattening
  order: keys sorted at every level) and the unravel of a flat vector
  back into the tree. ``backward`` recomputes the forward through
  autograd on the module's state; in training mode it draws what the
  last ``forward`` drew (a dropout mask), from a generator the stateful
  facade keeps per device (seeded by ``engine.new_generator``), where
  JAX's draws a new key. ``parameters()`` stays torch's iterator of the
  parameter tensors (the JAX package's returns the pair of weight and
  gradient lists): PyTorch itself, ``.to`` aside, walks it.

``torch.nn.Module.apply(fn)`` is shadowed by the JAX package's ``apply``;
use ``modules()`` to visit submodules.
"""
from __future__ import annotations

import copy
import os
import pickle

import numpy as np
import torch

from ..convert import flatten, host_copy_tree, to_numpy_tree, unflatten
from ..utils import engine
from ..utils.table import Table


class Node:
    """A node of a computation DAG (the reference's ``utils/Node.scala``
    with ``nn/Graph``), made by calling a module on other nodes: ``y =
    Linear(3, 4)(x_node)``. ``mod_idx`` is the module's index in the
    ``Graph`` that holds it (set by the graph; copies keep it)."""

    __slots__ = ("module", "prevs", "name", "mod_idx")

    def __init__(self, module, prevs, name=None):
        self.module = module
        self.prevs = list(prevs)
        self.name = name or (module.name if module is not None else "input")
        self.mod_idx = None

    def __repr__(self):
        return f"Node({self.name})"


def _node_args(args):
    """The nodes a call on nodes connects (one, several, or one list of
    them, as in JAX), or None for a call on data."""
    if args and all(isinstance(a, Node) for a in args):
        return list(args)
    if len(args) == 1 and isinstance(args[0], (list, tuple)) and args[0] \
            and all(isinstance(a, Node) for a in args[0]):
        return list(args[0])
    return None


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
        self.grad_params = None
        self.output = None
        self.grad_input = None
        self._scale_w = 1.0
        self._scale_b = 1.0

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

    def __call__(self, *args):
        """On nodes, a new graph node of this module; on data, torch's
        call (its hooks, then :meth:`forward`), several arguments as one
        ``Table``."""
        prevs = _node_args(args)
        if prevs is not None:
            return Node(self, prevs)
        if len(args) == 1:
            return super().__call__(args[0])
        return super().__call__(Table(*args))

    def forward(self, x):
        state = self.state
        training = bool(self.training)
        gen = self._draw_generator(x) if training else None
        out, new_state = self.apply(self.params, state, x, training=training,
                                    generator=gen)
        assign_state(state, new_state)
        self.output = out
        return out

    # -- the Torch backward protocol --------------------------------------
    def _draw_generator(self, x):
        """The facade's generator on x's device, its state recorded so a
        following ``backward`` draws the same values."""
        dev = _first_tensor(x).device
        gens = self.__dict__.setdefault("_facade_generators", {})
        if str(dev) not in gens:
            gens[str(dev)] = engine.new_generator(dev)
        g = gens[str(dev)]
        self.__dict__["_forward_draw"] = (str(dev), g.get_state())
        return g

    def _replay_generator(self, x):
        if not self.training:
            return None
        dev = _first_tensor(x).device
        last = self.__dict__.get("_forward_draw")
        if last is None or last[0] != str(dev):
            return self._draw_generator(x)
        g = torch.Generator(device=dev)
        g.set_state(last[1])
        return g

    def _vjp(self, x, grad_output, with_params):
        """(gradient of the input, gradient tree of the parameters or
        None) of the forward on this module's state at ``grad_output``."""
        xs = _tensor_leaves(x)
        xr = [t.detach().requires_grad_(True) if t.is_floating_point()
              else t for t in xs]
        params = self.params
        pleaves = flatten(params)
        with torch.enable_grad():
            out, _ = self.apply(params, self.state, _rebuild(x, iter(xr)),
                                training=bool(self.training),
                                generator=self._replay_generator(x))
            wrt = [t for t in xr if t.requires_grad]
            if with_params:
                wrt += list(pleaves.values())
            grads = torch.autograd.grad(
                _tensor_leaves(out), wrt, _tensor_leaves(grad_output),
                allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(wrt, grads)]
        it = iter(grads)
        gx = _rebuild(x, (next(it) if t.requires_grad else
                          torch.zeros_like(t) for t in xr))
        gp = (unflatten(dict(zip(pleaves, it))) if with_params and pleaves
              else None)
        return gx, gp

    def _grad_tree(self):
        if self.grad_params is None:
            self.grad_params = unflatten(
                {k: torch.zeros_like(v, requires_grad=False).detach()
                 for k, v in flatten(self.params).items()})
        return self.grad_params

    def backward(self, x, grad_output):
        """The input's gradient; the parameters' gradients (times the
        weight scale) are added into ``grad_params``."""
        gi, gp = self._vjp(x, grad_output, True)
        acc = flatten(self._grad_tree())
        if gp is not None:
            with torch.no_grad():
                for k, g in flatten(gp).items():
                    acc[k].add_(g, alpha=self._scale_w)
        self.grad_input = gi
        return gi

    def update_grad_input(self, x, grad_output):
        self.grad_input = self._vjp(x, grad_output, False)[0]
        return self.grad_input

    def acc_grad_parameters(self, x, grad_output):
        self.backward(x, grad_output)

    def zero_grad_parameters(self):
        if self.grad_params is not None:
            with torch.no_grad():
                for g in flatten(self.grad_params).values():
                    g.zero_()

    def get_parameters(self):
        """(flat weights, flat gradients, unravel): copies, in the JAX
        trees' order (keys sorted at every level, as ``ravel_pytree``
        flattens)."""
        names = _sorted_paths(self.params)
        w, g = flatten(self.params), flatten(self._grad_tree())
        flat_w = _cat([w[k] for k in names])
        flat_g = _cat([g[k] for k in names])
        shapes = [(k, tuple(w[k].shape), w[k].numel()) for k in names]

        def unravel(v):
            out, i = {}, 0
            for k, shape, n in shapes:
                out[k] = v[i:i + n].reshape(shape)
                i += n
            return unflatten(out)
        return flat_w, flat_g, unravel

    def is_training(self):
        return bool(self.training)

    def set_scale_w(self, s):
        self._scale_w = s
        return self

    def set_scale_b(self, s):
        self._scale_b = s
        return self

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

    # -- the functional init, copies and extra parameters -----------------
    def init(self, generator=None):
        """``(params, state)`` drawn afresh from the initialisers (with
        ``generator``, a ``torch.Generator`` on the parameters' device, or
        torch's global one) as new trees; this module keeps its own."""
        fresh = self.clone().reset(generator)
        return fresh.params, fresh.state

    def clone(self):
        """A deep copy: the same structure and values, no shared storage."""
        return copy.deepcopy(self)

    def get_extra_parameter(self):
        """The state leaves (BatchNorm running statistics) as a list of
        copies, in the JAX trees' order (keys sorted at every level)."""
        flat = flatten(self.state)
        return [flat[k].detach().clone() for k in _sorted_paths(self.state)]

    def set_extra_parameter(self, extra):
        """Copy a list in :meth:`get_extra_parameter`'s order into the
        state, each leaf cast to its tensor's dtype."""
        flat = flatten(self.state)
        names = _sorted_paths(self.state)
        if len(extra) != len(names):
            raise ValueError(f"expected {len(names)} extra parameters, "
                             f"got {len(extra)}")
        with torch.no_grad():
            for i, (k, e) in enumerate(zip(names, extra)):
                cur = flat[k]
                v = e if isinstance(e, torch.Tensor) else \
                    torch.as_tensor(np.asarray(e))
                if tuple(v.shape) != tuple(cur.shape):
                    raise ValueError(f"extra parameter {i}: shape "
                                     f"{tuple(v.shape)} does not match "
                                     f"{tuple(cur.shape)}")
                cur.copy_(v)
        return self

    # -- prediction -------------------------------------------------------
    def predict(self, dataset, batch_size=32):
        """Outputs over ``dataset`` (``optim.predictor.Predictor``)."""
        from ..optim.predictor import Predictor
        return Predictor(self).predict(dataset, batch_size)

    def predict_class(self, dataset, batch_size=32):
        from ..optim.predictor import Predictor
        return Predictor(self).predict_class(dataset, batch_size)

    # -- conversions ------------------------------------------------------
    def quantize(self, calibration=None):
        """Int8-inference copy (parity: AbstractModule.quantize;
        ``quantization.quantize``)."""
        from ..quantization.quantize import quantize as _q
        return _q(self, calibration=calibration)

    # -- serialization ----------------------------------------------------
    def save(self, path, overwrite=True):
        """Pickle the module to ``path`` with the JAX package's payload
        keys: ``params`` / ``state`` as numpy trees in JAX's names and
        layouts, ``module`` this module with its tensors on the meta
        device (no storage)."""
        if not overwrite and os.path.exists(path):
            raise IOError(f"{path} exists and overwrite=False")
        payload = {"module": self._strip_runtime(),
                   "params": host_copy_tree(self.params),
                   "state": host_copy_tree(self.state)}
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        return self

    def _strip_runtime(self):
        """A copy whose parameters and buffers are meta tensors and whose
        runtime attributes are cleared; the live tensors are not copied."""
        memo = {}
        for t in list(self.parameters()) + list(self.buffers()):
            meta = torch.empty_like(t, device="meta")
            memo[id(t)] = torch.nn.Parameter(
                meta, requires_grad=t.requires_grad) \
                if isinstance(t, torch.nn.Parameter) else meta
        c = copy.deepcopy(self, memo)
        for m in c.modules():
            if isinstance(m, Module):
                m.grad_params = m.output = m.grad_input = None
                m.__dict__.pop("_facade_generators", None)
                m.__dict__.pop("_forward_draw", None)
        return c

    @staticmethod
    def load(path, device=None):
        """The module :meth:`save` wrote, its tensors on ``device`` (the
        CUDA device by default; ``'cpu'`` for the CPU). A file the JAX
        package wrote holds its own module classes and is refused without
        importing them."""
        with open(path, "rb") as f:
            payload = _PortUnpickler(f).load()
        m = payload["module"].to_empty(device=engine.resolve_device(device))
        copy_tree_into(m.params, payload["params"])
        copy_tree_into(m.state, payload["state"])
        return m


class _PortUnpickler(pickle.Unpickler):
    """Refuses every global of the JAX package (``bigdl_tpu.``), so a JAX
    pickle fails before anything of it is imported."""

    def find_class(self, module, name):
        if module == "bigdl_tpu" or module.startswith("bigdl_tpu."):
            raise pickle.UnpicklingError(
                f"{module}.{name}: this file was written by the JAX package "
                f"(bigdl_tpu), whose modules the port does not import; save "
                f"its weights with save_weights and read them with "
                f"load_weights, or carry them over with bigdl_tpu_torch."
                f"convert")
        return super().find_class(module, name)


def _first_tensor(x):
    return _tensor_leaves(x)[0]


def _tensor_leaves(x):
    """The tensors of x (a tensor, an object with ``_leaves()`` such as
    ``nn.sparse.SparseTensor``, or a Table / list / tuple of them,
    nested), depth first; other values hold none."""
    if torch.is_tensor(x):
        return [x]
    if hasattr(x, "_leaves"):
        return list(x._leaves())
    if not isinstance(x, (Table, list, tuple)):
        return []           # no tensor in it (a sentinel, a number)
    return [t for item in x for t in _tensor_leaves(item)]


def _rebuild(x, leaves):
    """x's structure with its tensors taken in order from ``leaves``."""
    if torch.is_tensor(x):
        return next(leaves)
    if hasattr(x, "_leaves"):
        return x._with_leaves(leaves)
    if not isinstance(x, (Table, list, tuple)):
        return x
    items = [_rebuild(item, leaves) for item in x]
    return Table(*items) if isinstance(x, Table) else type(x)(items)


def _sorted_paths(tree, prefix=""):
    """The dotted leaf paths of a nested dict, keys sorted at every level
    (the JAX trees' flattening order)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _sorted_paths(v, f"{prefix}{k}.")
        else:
            out.append(f"{prefix}{k}")
    return out


def _cat(ts):
    if not ts:
        return torch.zeros(0)
    return torch.cat([t.detach().reshape(-1) for t in ts])


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
        """The loss's gradient in ``input``: a tensor, or a Table of them
        for a Table input."""
        xs = [t.detach().requires_grad_(True) for t in _tensor_leaves(input)]
        with torch.enable_grad():
            loss = self._forward(_rebuild(input, iter(xs)), target)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
        self.grad_input = _rebuild(input, (
            torch.zeros_like(x) if g is None else g
            for x, g in zip(xs, grads)))
        return self.grad_input


__all__ = ["Module", "Container", "Criterion", "Node", "copy_tree_into",
           "assign_state"]
