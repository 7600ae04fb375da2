"""Typed column schema for the transform plane (counterpart:
``deeplearning4j_tpu/etl/schema.py`` — ``ColumnType``, ``ColumnSpec``,
``Schema`` and ``SchemaBuilder``, DataVec ``Schema`` parity).

An ordered list of typed columns; every ``TransformProcess`` step maps
an input schema to an output schema, so a pipeline's record layout is
checked before any data flows. The JSON form is the JAX package's, key
for key, so either package reads the other's.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


class ColumnType:
    NUMERIC = "numeric"
    INTEGER = "integer"
    CATEGORICAL = "categorical"
    STRING = "string"
    TIME = "time"

    ALL = (NUMERIC, INTEGER, CATEGORICAL, STRING, TIME)


@dataclass
class ColumnSpec:
    """One typed column; ``categories`` is the closed label set for
    CATEGORICAL columns (DataVec ``CategoricalMetaData`` role — one-hot
    needs the full set up front, not whatever values a pass happened to
    see)."""

    name: str
    type: str = ColumnType.NUMERIC
    categories: Optional[List[str]] = field(default=None)

    def __post_init__(self):
        if self.type not in ColumnType.ALL:
            raise ValueError(f"unknown column type {self.type!r}")
        if self.type == ColumnType.CATEGORICAL and not self.categories:
            raise ValueError(
                f"categorical column {self.name!r} needs its category list")

    def to_spec(self) -> Dict:
        out = {"name": self.name, "type": self.type}
        if self.categories is not None:
            out["categories"] = list(self.categories)
        return out

    @staticmethod
    def from_spec(spec: Dict) -> "ColumnSpec":
        return ColumnSpec(spec["name"], spec.get("type", ColumnType.NUMERIC),
                          spec.get("categories"))


class Schema:
    """Ordered, name-indexed column list. Immutable by convention: the
    transform steps derive NEW schemas (``TransformProcess`` folds them
    left-to-right), never mutate one in place."""

    def __init__(self, columns: Sequence[ColumnSpec]):
        self.columns: List[ColumnSpec] = list(columns)
        self._index: Dict[str, int] = {}
        for i, c in enumerate(self.columns):
            if c.name in self._index:
                raise ValueError(f"duplicate column name {c.name!r}")
            self._index[c.name] = i

    # -- queries -----------------------------------------------------------
    def names(self) -> List[str]:
        return [c.name for c in self.columns]

    def num_columns(self) -> int:
        return len(self.columns)

    def has_column(self, name: str) -> bool:
        return name in self._index

    def index_of(self, name: str) -> int:
        if name not in self._index:
            raise KeyError(
                f"no column {name!r}; schema has {self.names()}")
        return self._index[name]

    def column(self, name: str) -> ColumnSpec:
        return self.columns[self.index_of(name)]

    # -- serde -------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"columns": [c.to_spec() for c in self.columns]})

    @staticmethod
    def from_json(s: str) -> "Schema":
        data = json.loads(s)
        return Schema([ColumnSpec.from_spec(c) for c in data["columns"]])

    def __eq__(self, other) -> bool:
        return (isinstance(other, Schema)
                and [c.to_spec() for c in self.columns]
                == [c.to_spec() for c in other.columns])

    def __repr__(self) -> str:
        return f"Schema({[(c.name, c.type) for c in self.columns]})"

    # -- builder (DataVec Schema.Builder idiom) ----------------------------
    @staticmethod
    def builder() -> "SchemaBuilder":
        return SchemaBuilder()


class SchemaBuilder:
    def __init__(self) -> None:
        self._columns: List[ColumnSpec] = []

    def add_numeric_column(self, *names: str) -> "SchemaBuilder":
        for n in names:
            self._columns.append(ColumnSpec(n, ColumnType.NUMERIC))
        return self

    def add_integer_column(self, *names: str) -> "SchemaBuilder":
        for n in names:
            self._columns.append(ColumnSpec(n, ColumnType.INTEGER))
        return self

    def add_categorical_column(self, name: str,
                               categories: Sequence[str]) -> "SchemaBuilder":
        self._columns.append(
            ColumnSpec(name, ColumnType.CATEGORICAL,
                       [str(c) for c in categories]))
        return self

    def add_string_column(self, *names: str) -> "SchemaBuilder":
        for n in names:
            self._columns.append(ColumnSpec(n, ColumnType.STRING))
        return self

    def add_time_column(self, *names: str) -> "SchemaBuilder":
        for n in names:
            self._columns.append(ColumnSpec(n, ColumnType.TIME))
        return self

    def build(self) -> Schema:
        return Schema(self._columns)
