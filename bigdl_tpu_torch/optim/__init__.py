from .optim_method import (LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax,
                           AdamW, CosineAnnealing, Default, EpochDecay,
                           EpochDecayWithWarmUp, EpochSchedule, EpochStep,
                           Exponential, Ftrl, LarsSGD, LearningRateSchedule,
                           MultiStep, NaturalExp, OptimMethod, ParallelAdam,
                           Plateau, Poly, Regime, RMSprop, SequentialSchedule,
                           Step, Warmup)
from .evaluator import DistriValidator, Evaluator, LocalValidator
from .optimizer import (BaseOptimizer, DistriOptimizer, LocalOptimizer,
                        Metrics, Optimizer, ParallelOptimizer,
                        RemediationPolicy)
from .predictor import PredictionService, Predictor, bucket_for
from .regularizer import (L1L2Regularizer, L1Regularizer, L2Regularizer,
                          Regularizer)
from .trigger import (EveryEpoch, MaxEpoch, MaxIteration, MaxScore, MinLoss,
                      SeveralIteration, Trigger, TriggerAnd, TriggerOr, and_,
                      every_epoch, max_epoch, max_iteration, max_score,
                      min_loss, or_, several_iteration)
from .validation import (MAE, NDCG, AccuracyResult, HitRatio, Loss,
                         LossResult, Top1Accuracy, Top5Accuracy,
                         TreeNNAccuracy, ValidationMethod, ValidationResult)

# the pyspark optim namespace also exposes these (as JAX's does)
from ..nn.criterion import ActivityRegularization  # noqa: E402
from ..visualization import TrainSummary, ValidationSummary  # noqa: E402

__all__ = ["LBFGS", "SGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW", "Ftrl",
           "LarsSGD", "ParallelAdam", "Plateau", "RMSprop", "L1L2Regularizer",
           "L1Regularizer", "L2Regularizer", "Regularizer", "CosineAnnealing", "Default", "EpochDecay",
           "EpochDecayWithWarmUp", "EpochSchedule", "EpochStep",
           "Exponential", "LearningRateSchedule", "MultiStep", "NaturalExp",
           "OptimMethod", "Poly", "Regime", "SequentialSchedule", "Step",
           "Warmup", "BaseOptimizer", "LocalOptimizer", "DistriOptimizer",
           "ParallelOptimizer", "RemediationPolicy", "Metrics",
           "Optimizer", "bucket_for", "EveryEpoch", "MaxEpoch",
           "MaxIteration", "MaxScore", "MinLoss", "SeveralIteration",
           "Trigger", "TriggerAnd", "TriggerOr", "and_", "every_epoch",
           "max_epoch", "max_iteration", "max_score", "min_loss", "or_",
           "several_iteration", "Evaluator", "LocalValidator", "DistriValidator", "MAE", "NDCG",
           "AccuracyResult", "HitRatio", "Loss", "LossResult", "Top1Accuracy",
           "Top5Accuracy", "TreeNNAccuracy", "ValidationMethod",
           "ValidationResult", "Predictor", "PredictionService",
           "TrainSummary", "ValidationSummary", "ActivityRegularization"]
