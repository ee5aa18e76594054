"""DataFrame-based image reading + transformation (counterpart of
``bigdl_tpu/dlframes/dl_image_reader.py``).

Parity: reference ``dlframes/dl_image_reader.py`` (DLImageReader.readImages)
and ``dlframes/dl_image_transformer.py`` (DLImageTransformer) — the Spark
DataFrame image schema (origin, height, width, nChannels, mode, data)
becomes a pandas DataFrame with one ``image`` dict column of the same keys.
Decoding rides the shared loader stack: the native libjpeg path when built,
Pillow/torchvision otherwise (same as dataset/imagenet.py). The images are
host arrays; ``pandas`` is imported inside ``read_images`` only, and
``DLImageTransformer.transform`` also takes a dict of columns.
"""
from __future__ import annotations

import fnmatch
import os
from typing import List, Optional

import numpy as np

__all__ = ["DLImageReader", "DLImageTransformer"]


def _get_decoder():
    from ..dataset.imagenet import _decoder
    dec = _decoder()
    if dec is None:
        raise RuntimeError(
            "no image decoder available: build the native libjpeg loader or "
            "install Pillow/torchvision")
    return dec


def _image_row(path: str, arr: np.ndarray) -> dict:
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return {
        "origin": path,
        "height": int(arr.shape[0]),
        "width": int(arr.shape[1]),
        "nChannels": int(arr.shape[2]),
        "mode": int(arr.shape[2]),  # CV-type analog: channel count
        "data": arr,  # HWC uint8/float
    }


class DLImageReader:
    """DLImageReader.readImages parity — folder of images → DataFrame."""

    @staticmethod
    def read_images(path: str, pattern: str = "*", recursive: bool = True,
                    image_col: str = "image"):
        import pandas as pd
        decode = _get_decoder()  # resolved once, raises if no backend
        rows: List[dict] = []
        if os.path.isfile(path):
            files = [path]
        else:
            files = []
            if recursive:
                for root, _, names in os.walk(path):
                    files += [os.path.join(root, n) for n in sorted(names)]
            else:
                files = [os.path.join(path, n)
                         for n in sorted(os.listdir(path))]
        for f in files:
            if not fnmatch.fnmatch(os.path.basename(f), pattern):
                continue
            try:
                arr = decode(f)
            except Exception:
                continue  # unreadable/non-image files are skipped, like the
                # reference's sampleRatio-tolerant reader
            if arr is None:
                continue
            rows.append({image_col: _image_row(f, arr)})
        return pd.DataFrame(rows, columns=[image_col])


class DLImageTransformer:
    """DLImageTransformer parity — apply a vision transform pipeline to the
    image column, producing a float image column (HWC float32)."""

    def __init__(self, transformer, input_col: str = "image",
                 output_col: str = "output"):
        self.transformer = transformer
        self.input_col, self.output_col = input_col, output_col

    def set_input_col(self, c):
        self.input_col = c
        return self

    def set_output_col(self, c):
        self.output_col = c
        return self

    def transform(self, df):
        arrs = [np.asarray(img["data"], np.float32)
                for img in df[self.input_col]]
        results = list(self.transformer(arrs))  # Transformer = iterator op
        out_rows = []
        for img, res in zip(df[self.input_col], results):
            res = np.asarray(res, np.float32)
            if res.ndim == 2:
                res = res[:, :, None]
            out_rows.append(_image_row(img.get("origin", ""), res))
        out = df.copy()    # a DataFrame's or a dict's
        out[self.output_col] = out_rows
        return out
