"""Training summaries as TensorBoard event files (counterpart of
``bigdl_tpu/visualization``): the writer, the reader and the train /
validation summaries the training loop records into. The files are the
JAX package's byte for byte, so either package reads the other's."""
from .event_reader import ScalarCache, iter_records, read_scalar
from .event_writer import EventWriter, crc32c
from .summary import Summary, TrainSummary, ValidationSummary

__all__ = ["ScalarCache", "iter_records", "read_scalar", "EventWriter",
           "crc32c", "Summary", "TrainSummary", "ValidationSummary"]
