"""Tabular row -> feature-tensor pipeline (counterpart of
``bigdl_tpu/dataset/datamining.py``, the reference's
``dataset/datamining/RowTransformer.scala``): a keyed container of
``RowTransformSchema``s that turns one tabular row into a ``Table`` of
numpy feature arrays, one entry per schema key.

A row is a ``dict`` (field name -> value), a pandas ``Series`` (or the
rows of a ``DataFrame`` via ``iterrows``) or a plain sequence
(index-addressed only). Host code, the port's own copy: the device only
sees the dense batches made from its output.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..utils.table import Table
from .transformer import Transformer

__all__ = ["RowTransformSchema", "ColToTensor", "ColsToNumeric",
           "RowTransformer"]


def _row_fields(row):
    """Field names of a row, or None for index-only rows."""
    if isinstance(row, dict):
        return list(row.keys())
    if hasattr(row, "index") and hasattr(row, "iloc"):   # pandas Series
        return [str(k) for k in row.index]
    return None


def _row_values(row):
    if isinstance(row, dict):
        return list(row.values())
    if hasattr(row, "index") and hasattr(row, "iloc"):
        return list(row.iloc[i] for i in range(len(row)))
    return list(row)


class RowTransformSchema:
    """One keyed transforming job: select columns, emit one array.

    ``field_names`` overrides ``indices``; both empty selects all columns
    (reference RowTransformSchema contract)."""

    def __init__(self, schema_key: str, indices: Sequence[int] = (),
                 field_names: Sequence[str] = ()):
        self.schema_key = schema_key
        self.indices = list(indices)
        self.field_names = list(field_names)

    def transform(self, values, fields):
        raise NotImplementedError

    def _select(self, row):
        names = _row_fields(row)
        vals = _row_values(row)
        if self.field_names:
            if names is None:
                raise ValueError(
                    f"schema {self.schema_key!r} selects by field name but "
                    "the row has no field names (use a dict or pandas row)")
            idx = [names.index(f) for f in self.field_names]
        elif self.indices:
            idx = self.indices
        else:
            idx = range(len(vals))
        sel_names = [names[i] if names else str(i) for i in idx]
        return [vals[i] for i in idx], sel_names


def _scalar_array(v):
    if isinstance(v, str):
        return np.asarray([v])
    if isinstance(v, (bool, np.bool_)):
        return np.asarray([1.0 if v else 0.0], np.float32)
    return np.asarray(np.reshape(v, (-1,)), np.float32)


class ColToTensor(RowTransformSchema):
    """One column → a size-1 array keyed by ``schema_key`` (reference
    ColToTensor; strings stay string arrays, booleans become 0/1)."""

    def __init__(self, schema_key: str, field):
        if isinstance(field, str):
            super().__init__(schema_key, field_names=[field])
        else:
            super().__init__(schema_key, indices=[int(field)])

    def transform(self, values, fields):
        return _scalar_array(values[0])


class ColsToNumeric(RowTransformSchema):
    """Selected (or all) columns concatenated into one float32 vector
    (reference ColsToNumeric)."""

    def __init__(self, schema_key: str, field_names: Sequence[str] = (),
                 indices: Sequence[int] = ()):
        super().__init__(schema_key, indices=indices,
                         field_names=field_names)

    def transform(self, values, fields):
        parts = [np.asarray(np.reshape(np.asarray(v, np.float32), (-1,)))
                 for v in values]
        return np.concatenate(parts) if parts else np.zeros((0,), np.float32)


class RowTransformer(Transformer):
    """Row iterator → ``Table`` iterator, one keyed entry per schema.

    The output Table carries ``schema_key → np.ndarray`` (the reference
    keys its Table with scalar string tensors; plain string keys are the
    Python-native form)."""

    def __init__(self, schemas: Sequence[RowTransformSchema],
                 row_size: Optional[int] = None):
        keys = [s.schema_key for s in schemas]
        if len(set(keys)) != len(keys):
            dup = sorted({k for k in keys if keys.count(k) > 1})
            raise ValueError(f"Found replicated schemaKey: {dup}")
        if row_size is not None:
            for s in schemas:
                if not s.field_names and any(
                        i < 0 or i >= row_size for i in s.indices):
                    raise ValueError(
                        f"schema {s.schema_key!r}: index out of bound for "
                        f"row size {row_size}: {s.indices}")
        self.schemas = list(schemas)
        self.row_size = row_size

    def transform_row(self, row) -> Table:
        t = Table()
        for s in self.schemas:
            values, fields = s._select(row)
            t[s.schema_key] = s.transform(values, fields)
        return t

    def apply(self, it):
        for row in it:
            yield self.transform_row(row)

    def transform_frame(self, df) -> Dict[str, np.ndarray]:
        """Whole pandas DataFrame (or dict of columns) → stacked feature
        matrices, ready for ``DataSet.from_arrays`` / dlframes."""
        if hasattr(df, "iterrows"):
            rows = (r for _, r in df.iterrows())
        elif isinstance(df, dict):
            cols = list(df)
            n = len(next(iter(df.values()))) if df else 0
            rows = ({c: df[c][i] for c in cols} for i in range(n))
        else:
            rows = iter(df)
        out: Dict[str, list] = {s.schema_key: [] for s in self.schemas}
        for t in self.apply(rows):
            for k in out:
                out[k].append(t[k])
        return {k: np.stack(v) if v else np.zeros((0,), np.float32)
                for k, v in out.items()}

    # -- reference factory surface ------------------------------------
    @staticmethod
    def atomic(fields, row_size: Optional[int] = None) -> "RowTransformer":
        """Each selected column → its own size-1 entry (reference
        RowTransformer.atomic, both overloads)."""
        schemas = [ColToTensor(str(f), f) for f in fields]
        return RowTransformer(schemas, row_size)

    @staticmethod
    def numeric(fields=None, schema_key: str = "all") -> "RowTransformer":
        """All columns → one vector (``numeric()``), or a map of
        ``schema_key → field names`` → one vector each (reference
        RowTransformer.numeric, both overloads)."""
        if fields is None:
            return RowTransformer([ColsToNumeric(schema_key)])
        return RowTransformer(
            [ColsToNumeric(k, field_names=v) for k, v in fields.items()])

    @staticmethod
    def atomic_with_numeric(atomic_fields,
                            numeric_fields) -> "RowTransformer":
        schemas = [ColToTensor(str(f), f) for f in atomic_fields]
        schemas += [ColsToNumeric(k, field_names=v)
                    for k, v in numeric_fields.items()]
        return RowTransformer(schemas)
