"""Triggers (counterpart of ``bigdl_tpu/optim/trigger.py``, parity with the
reference's ``optim/Trigger.scala``).

A trigger is a predicate over the optimizer state table
{'epoch', 'neval', 'epoch_finished', 'score', 'loss'}.
"""
from __future__ import annotations


class Trigger:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, state) -> bool:
        return bool(self._fn(state))

    def probe(self, state) -> bool:
        """Side-effect-free preview: would this trigger fire at ``state``?
        The state dict is copied so the predicate cannot mutate the
        caller's live table; stateful triggers override this to avoid
        advancing their own bookkeeping."""
        return bool(self._fn(dict(state)))


class _EveryEpoch(Trigger):
    """Fires once when an epoch boundary was just crossed."""

    def __init__(self):
        self.last_epoch = -1

        def fn(state):
            if state.get("epoch_finished", False):
                if state["epoch"] != self.last_epoch:
                    self.last_epoch = state["epoch"]
                    return True
            return False
        super().__init__(fn)

    def probe(self, state) -> bool:
        # pure: does NOT advance last_epoch
        return bool(state.get("epoch_finished", False)) and \
            state["epoch"] != self.last_epoch


class _SeveralIteration(Trigger):
    def __init__(self, interval: int):
        super().__init__(lambda s: s["neval"] > 0 and
                         s["neval"] % interval == 0)


def every_epoch():
    return _EveryEpoch()


def several_iteration(interval: int):
    return _SeveralIteration(interval)


def max_epoch(maximum: int):
    return Trigger(lambda s: s["epoch"] > maximum)


def max_iteration(maximum: int):
    return Trigger(lambda s: s["neval"] >= maximum)


def max_score(maximum: float):
    return Trigger(lambda s: s.get("score", float("-inf")) > maximum)


def min_loss(minimum: float):
    return Trigger(lambda s: s.get("loss", float("inf")) < minimum)


def and_(first, *others):
    return Trigger(lambda s: first(s) and all(o(s) for o in others))


def or_(first, *others):
    return Trigger(lambda s: first(s) or any(o(s) for o in others))


# reference-style namespace: Trigger.everyEpoch etc.
Trigger.every_epoch = staticmethod(every_epoch)
Trigger.several_iteration = staticmethod(several_iteration)
Trigger.max_epoch = staticmethod(max_epoch)
Trigger.max_iteration = staticmethod(max_iteration)
Trigger.max_score = staticmethod(max_score)
Trigger.min_loss = staticmethod(min_loss)
Trigger.and_ = staticmethod(and_)
Trigger.or_ = staticmethod(or_)


# pyspark API spellings (EveryEpoch/SeveralIteration/MaxEpoch/MaxIteration/
# MaxScore/MinLoss/TriggerAnd/TriggerOr construct the same triggers)
EveryEpoch = every_epoch
SeveralIteration = several_iteration
MaxEpoch = max_epoch
MaxIteration = max_iteration
MaxScore = max_score
MinLoss = min_loss
TriggerAnd = and_
TriggerOr = or_
