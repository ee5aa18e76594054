"""``bigdl_tpu_torch.keras``: the Keras-1.2 API and its converter
(counterpart of ``bigdl_tpu/keras/``). ``Sequential`` / ``Model`` /
``model_from_json`` / ``load_keras`` / ``with_bigdl_backend`` take a
trailing ``device`` (the CUDA device by default; ``"cpu"`` for the CPU).
Importing it loads neither ``tensorflow`` nor ``h5py``."""
from .topology import (Sequential, Model, Input, InputLayer, KerasLayer,
                       KerasNode)
from .layers import (Dense, Activation, Dropout, Flatten, Reshape, Permute,
                     RepeatVector, Convolution2D, Convolution1D, MaxPooling2D,
                     AveragePooling2D, GlobalAveragePooling2D,
                     GlobalMaxPooling2D, MaxPooling1D, GlobalAveragePooling1D,
                     ZeroPadding2D, UpSampling2D, Cropping2D,
                     BatchNormalization, Embedding, LSTM, GRU, SimpleRNN,
                     Bidirectional, TimeDistributed, Merge, Highway,
                     LeakyReLU, ELU, ThresholdedReLU, GaussianNoise,
                     GaussianDropout, SpatialDropout2D, Masking,
                     SoftMax, AtrousConvolution1D, AtrousConvolution2D,
                     SeparableConvolution2D, Deconvolution2D, Convolution3D,
                     LocallyConnected1D, LocallyConnected2D,
                     Cropping1D, Cropping3D, ZeroPadding1D, ZeroPadding3D,
                     UpSampling1D, UpSampling3D, AveragePooling1D,
                     MaxPooling3D, AveragePooling3D, GlobalMaxPooling1D,
                     GlobalMaxPooling3D, GlobalAveragePooling3D,
                     ConvLSTM2D, MaxoutDense, PReLU, SReLU,
                     SpatialDropout1D, SpatialDropout3D)

Conv2D = Convolution2D
Conv1D = Convolution1D
Conv3D = Convolution3D
from .converter import (model_from_json, load_keras, load_weights,
                        load_weights_hdf5)
from .backend import KerasModelWrapper, with_bigdl_backend
