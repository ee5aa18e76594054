"""``bigdl_tpu_torch.dlframes``: the ML-pipeline stages (counterpart of
``bigdl_tpu/dlframes/``) over a pandas DataFrame or a dict of columns;
importing it loads no ``pandas``."""
from .dl_estimator import DLEstimator, DLModel, DLClassifier, DLClassifierModel
from .dl_image_reader import DLImageReader, DLImageTransformer
