"""``bigdl_tpu_torch.dlframes.dl_classifier``: the pyspark module path
(reference ``bigdl/dlframes/dl_classifier.py``); implementations live in
``dlframes/dl_estimator.py``."""
from .dl_estimator import (DLEstimator, DLModel, DLClassifier,  # noqa
                           DLClassifierModel)

__all__ = ["DLEstimator", "DLModel", "DLClassifier", "DLClassifierModel"]
