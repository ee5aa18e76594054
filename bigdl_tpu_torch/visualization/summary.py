"""Training summaries (counterpart of
``bigdl_tpu/visualization/summary.py``): scalars and histograms written
to event files under ``log_dir/app_name/{train,validation}``, read back
from the files on disk, and per-tag triggers the training loop asks
before it records."""
from __future__ import annotations

import os

from .event_reader import ScalarCache
from .event_writer import EventWriter

__all__ = ["Summary", "TrainSummary", "ValidationSummary"]


class Summary:
    def __init__(self, log_dir: str, app_name: str, sub_dir: str):
        self.log_dir = os.path.join(log_dir, app_name, sub_dir)
        self.writer = EventWriter(self.log_dir)
        self._reader = ScalarCache(self.log_dir)
        self._triggers = {}

    def add_scalar(self, tag: str, value: float, step: int):
        self.writer.add_scalar(tag, value, step)
        return self

    def add_histogram(self, tag: str, values, step: int):
        """``values``: an array or a tensor; a CUDA tensor is copied to the
        host, a readback the caller chose."""
        self.writer.add_histogram(tag, values, step)
        return self

    def read_scalar(self, tag: str):
        """[(step, value), ...] from the event files on disk (the whole
        history, also what another process wrote); repeated calls rescan
        only appended bytes."""
        return self._reader.read(tag)

    def set_summary_trigger(self, name: str, trigger):
        """Record the tag ``name`` only when ``trigger`` fires; a tag
        without a trigger is recorded at every step."""
        self._triggers[name] = trigger
        return self

    def should_record(self, name: str, state) -> bool:
        trig = self._triggers.get(name)
        return True if trig is None else bool(trig(state))

    def close(self):
        self.writer.close()


class TrainSummary(Summary):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")


class ValidationSummary(Summary):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")
