"""Model-file loaders and savers (counterpart of ``bigdl_tpu/loaders``):
bigdl.proto (``bigdl_proto``), Caffe, Torch7 and TensorFlow GraphDef, and
``TFSession``. The loaders build the port's modules with their tensors on
``device`` (the CUDA device by default; ``"cpu"`` for the CPU)."""
from .caffe import load_caffe, parse_prototxt, read_caffemodel_blobs
from .caffe_persister import save_caffe
from .torchfile import load_torch, load_t7, save_torch, save_t7
from .tensorflow import load_tf_graph, load_tf, parse_graphdef
from .tf_saver import save_tf_graph
from .tf_session import TFSession
