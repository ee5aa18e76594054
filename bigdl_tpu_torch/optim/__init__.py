from .optim_method import (SGD, Adam, AdamW, CosineAnnealing, Default,
                           EpochDecay, EpochDecayWithWarmUp, EpochSchedule,
                           EpochStep, Exponential, LearningRateSchedule,
                           MultiStep, NaturalExp, OptimMethod, Poly, Regime,
                           SequentialSchedule, Step, Warmup)
from .optimizer import BaseOptimizer, LocalOptimizer, Metrics, Optimizer
from .predictor import bucket_for
from .trigger import (EveryEpoch, MaxEpoch, MaxIteration, MaxScore, MinLoss,
                      SeveralIteration, Trigger, TriggerAnd, TriggerOr, and_,
                      every_epoch, max_epoch, max_iteration, max_score,
                      min_loss, or_, several_iteration)

__all__ = ["SGD", "Adam", "AdamW", "CosineAnnealing", "Default", "EpochDecay",
           "EpochDecayWithWarmUp", "EpochSchedule", "EpochStep",
           "Exponential", "LearningRateSchedule", "MultiStep", "NaturalExp",
           "OptimMethod", "Poly", "Regime", "SequentialSchedule", "Step",
           "Warmup", "BaseOptimizer", "LocalOptimizer", "Metrics",
           "Optimizer", "bucket_for", "EveryEpoch", "MaxEpoch",
           "MaxIteration", "MaxScore", "MinLoss", "SeveralIteration",
           "Trigger", "TriggerAnd", "TriggerOr", "and_", "every_epoch",
           "max_epoch", "max_iteration", "max_score", "min_loss", "or_",
           "several_iteration"]
