from .optim_method import (LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax,
                           AdamW, CosineAnnealing, Default, EpochDecay,
                           EpochDecayWithWarmUp, EpochSchedule, EpochStep,
                           Exponential, Ftrl, LarsSGD, LearningRateSchedule,
                           MultiStep, NaturalExp, OptimMethod, ParallelAdam,
                           Plateau, Poly, Regime, RMSprop, SequentialSchedule,
                           Step, Warmup)
from .evaluator import Evaluator, LocalValidator
from .optimizer import BaseOptimizer, LocalOptimizer, Metrics, Optimizer
from .predictor import bucket_for
from .regularizer import (L1L2Regularizer, L1Regularizer, L2Regularizer,
                          Regularizer)
from .trigger import (EveryEpoch, MaxEpoch, MaxIteration, MaxScore, MinLoss,
                      SeveralIteration, Trigger, TriggerAnd, TriggerOr, and_,
                      every_epoch, max_epoch, max_iteration, max_score,
                      min_loss, or_, several_iteration)
from .validation import (MAE, NDCG, AccuracyResult, HitRatio, Loss,
                         LossResult, Top1Accuracy, Top5Accuracy,
                         TreeNNAccuracy, ValidationMethod, ValidationResult)

__all__ = ["LBFGS", "SGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW", "Ftrl",
           "LarsSGD", "ParallelAdam", "Plateau", "RMSprop", "L1L2Regularizer",
           "L1Regularizer", "L2Regularizer", "Regularizer", "CosineAnnealing", "Default", "EpochDecay",
           "EpochDecayWithWarmUp", "EpochSchedule", "EpochStep",
           "Exponential", "LearningRateSchedule", "MultiStep", "NaturalExp",
           "OptimMethod", "Poly", "Regime", "SequentialSchedule", "Step",
           "Warmup", "BaseOptimizer", "LocalOptimizer", "Metrics",
           "Optimizer", "bucket_for", "EveryEpoch", "MaxEpoch",
           "MaxIteration", "MaxScore", "MinLoss", "SeveralIteration",
           "Trigger", "TriggerAnd", "TriggerOr", "and_", "every_epoch",
           "max_epoch", "max_iteration", "max_score", "min_loss", "or_",
           "several_iteration", "Evaluator", "LocalValidator", "MAE", "NDCG",
           "AccuracyResult", "HitRatio", "Loss", "LossResult", "Top1Accuracy",
           "Top5Accuracy", "TreeNNAccuracy", "ValidationMethod",
           "ValidationResult"]
