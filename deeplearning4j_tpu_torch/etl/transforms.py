"""TransformProcess: schema-checked record transforms (counterpart:
``deeplearning4j_tpu/etl/transforms.py`` — the steps, ``TransformProcess``
with ``split_for_pipeline``, and ``TransformProcessRecordReader``).

Steps (DataVec's 2016 core): ``remove_columns``, ``math_op`` (named
ops), ``map_column`` (a Python function; not serializable), ``derive``,
``categorical_to_integer``, ``one_hot``, ``string_to_time`` (UTC epoch
seconds), ``condition_filter`` and ``filter_invalid`` (they drop
records), and ``rolling_window`` (stateful over the record stream).
Every step maps an input schema to an output schema, so a mis-typed
pipeline fails when it is built. ``compile()`` folds the steps into one
record function with fresh state for the stateful steps.

``split_for_pipeline`` cuts the process after its last filter or
stateful step: that head runs serially in the input pipeline's
dispatcher, the stateless tail in its workers, and serial(head) then
parallel(tail) equals serial(head then tail). The JSON form is the JAX
package's.
"""

from __future__ import annotations

import calendar
import json
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.etl.schema import ColumnSpec, ColumnType, Schema


def _to_number(v):
    """Numeric coercion matching the reader/iterator plane's float():
    str/int/float -> float; raises ValueError on junk."""
    return float(v)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


class Step:
    """One schema-checked record transform. ``compile`` returns
    fn(record)->record (or None to DROP the record — filters)."""

    #: filters drop records (change downstream batch boundaries)
    is_filter = False
    #: stateful steps carry state across the record stream (windows)
    is_stateful = False

    def output_schema(self, schema: Schema) -> Schema:
        raise NotImplementedError

    def compile(self, schema: Schema) -> Callable[[list], Optional[list]]:
        raise NotImplementedError

    def to_spec(self) -> Dict:
        raise NotImplementedError(
            f"{type(self).__name__} is not serializable")


class RemoveColumns(Step):
    def __init__(self, names: Sequence[str]):
        self.names = [str(n) for n in names]

    def output_schema(self, schema):
        drop = set(self.names)
        for n in self.names:
            schema.index_of(n)  # loud on unknown columns
        return Schema([c for c in schema.columns if c.name not in drop])

    def compile(self, schema):
        keep = [i for i, c in enumerate(schema.columns)
                if c.name not in set(self.names)]

        def fn(rec):
            return [rec[i] for i in keep]

        return fn

    def to_spec(self):
        return {"op": "remove_columns", "names": list(self.names)}


_MATH_OPS = {
    "add": lambda x, k: x + k,
    "sub": lambda x, k: x - k,
    "rsub": lambda x, k: k - x,
    "mul": lambda x, k: x * k,
    "div": lambda x, k: x / k,
    "rdiv": lambda x, k: k / x,
    "pow": lambda x, k: x ** k,
    "min": lambda x, k: min(x, k),
    "max": lambda x, k: max(x, k),
}
_MATH_UNARY = {
    "abs": abs,
    "neg": lambda x: -x,
    "log": __import__("math").log,
    "log1p": __import__("math").log1p,
    "sqrt": __import__("math").sqrt,
}


class MathOp(Step):
    """column <op> operand with a NAMED op (DataVec MathOpTransform /
    MathOp enum) — named ops keep the step JSON-serializable."""

    def __init__(self, column: str, op: str, operand: Optional[float] = None):
        if op in _MATH_OPS:
            if operand is None:
                raise ValueError(f"math op {op!r} needs an operand")
        elif op in _MATH_UNARY:
            operand = None
        else:
            raise ValueError(
                f"unknown math op {op!r}; binary: {sorted(_MATH_OPS)}, "
                f"unary: {sorted(_MATH_UNARY)}")
        self.column, self.op = str(column), str(op)
        self.operand = None if operand is None else float(operand)

    def output_schema(self, schema):
        spec = schema.column(self.column)
        cols = list(schema.columns)
        cols[schema.index_of(self.column)] = ColumnSpec(
            spec.name, ColumnType.NUMERIC)
        return Schema(cols)

    def compile(self, schema):
        i = schema.index_of(self.column)
        if self.op in _MATH_OPS:
            f, k = _MATH_OPS[self.op], self.operand

            def fn(rec):
                rec = list(rec)
                rec[i] = f(_to_number(rec[i]), k)
                return rec
        else:
            f = _MATH_UNARY[self.op]

            def fn(rec):
                rec = list(rec)
                rec[i] = f(_to_number(rec[i]))
                return rec

        return fn

    def to_spec(self):
        out = {"op": "math_op", "column": self.column, "math": self.op}
        if self.operand is not None:
            out["operand"] = self.operand
        return out


class MapColumn(Step):
    """Arbitrary Python fn over one column — the escape hatch DataVec
    lacks. Deliberately NOT serializable (to_spec raises): a closure has
    no stable wire form, and a checkpoint that silently dropped it would
    replay a DIFFERENT pipeline."""

    def __init__(self, column: str, fn: Callable,
                 output_type: str = ColumnType.NUMERIC):
        self.column, self.fn, self.output_type = str(column), fn, output_type

    def output_schema(self, schema):
        cols = list(schema.columns)
        i = schema.index_of(self.column)
        cols[i] = ColumnSpec(self.column, self.output_type,
                             cols[i].categories
                             if self.output_type == ColumnType.CATEGORICAL
                             else None)
        return Schema(cols)

    def compile(self, schema):
        i, f = schema.index_of(self.column), self.fn

        def fn(rec):
            rec = list(rec)
            rec[i] = f(rec[i])
            return rec

        return fn


_DERIVE_OPS = {
    "sum": sum,
    "mean": lambda vs: sum(vs) / len(vs),
    "min": min,
    "max": max,
    "product": lambda vs: __import__("functools").reduce(
        lambda a, b: a * b, vs),
    "diff": lambda vs: vs[0] - sum(vs[1:]),
}


class Derive(Step):
    """Append a numeric column computed from named source columns — a
    named aggregate (serializable) or an arbitrary fn(values)->value."""

    def __init__(self, new_name: str, columns: Sequence[str],
                 op="sum"):
        self.new_name = str(new_name)
        self.columns = [str(c) for c in columns]
        if callable(op):
            self.op, self.fn = None, op
        else:
            if op not in _DERIVE_OPS:
                raise ValueError(
                    f"unknown derive op {op!r}: {sorted(_DERIVE_OPS)}")
            self.op, self.fn = str(op), _DERIVE_OPS[op]

    def output_schema(self, schema):
        for c in self.columns:
            schema.index_of(c)
        return Schema(list(schema.columns)
                      + [ColumnSpec(self.new_name, ColumnType.NUMERIC)])

    def compile(self, schema):
        idx = [schema.index_of(c) for c in self.columns]
        f = self.fn

        def fn(rec):
            return list(rec) + [f([_to_number(rec[i]) for i in idx])]

        return fn

    def to_spec(self):
        if self.op is None:
            raise NotImplementedError(
                "Derive with a Python callable is not serializable; use a "
                f"named op ({sorted(_DERIVE_OPS)})")
        return {"op": "derive", "new_name": self.new_name,
                "columns": list(self.columns), "agg": self.op}


class CategoricalToInteger(Step):
    def __init__(self, column: str):
        self.column = str(column)

    def _categories(self, schema) -> List[str]:
        spec = schema.column(self.column)
        if spec.type != ColumnType.CATEGORICAL:
            raise ValueError(
                f"{self.column!r} is {spec.type}, not categorical")
        return list(spec.categories)

    def output_schema(self, schema):
        self._categories(schema)
        cols = list(schema.columns)
        cols[schema.index_of(self.column)] = ColumnSpec(
            self.column, ColumnType.INTEGER)
        return Schema(cols)

    def compile(self, schema):
        i = schema.index_of(self.column)
        lut = {c: k for k, c in enumerate(self._categories(schema))}

        def fn(rec):
            rec = list(rec)
            v = str(rec[i])
            if v not in lut:
                raise ValueError(
                    f"value {v!r} not in categories of {self.column!r} "
                    f"({sorted(lut)})")
            rec[i] = lut[v]
            return rec

        return fn

    def to_spec(self):
        return {"op": "categorical_to_integer", "column": self.column}


class CategoricalToOneHot(CategoricalToInteger):
    """Replace the column with len(categories) 0/1 numeric columns named
    ``col[cat]`` (DataVec CategoricalToOneHotTransform)."""

    def output_schema(self, schema):
        cats = self._categories(schema)
        i = schema.index_of(self.column)
        cols = (list(schema.columns[:i])
                + [ColumnSpec(f"{self.column}[{c}]", ColumnType.NUMERIC)
                   for c in cats]
                + list(schema.columns[i + 1:]))
        return Schema(cols)

    def compile(self, schema):
        i = schema.index_of(self.column)
        cats = self._categories(schema)
        lut = {c: k for k, c in enumerate(cats)}
        width = len(cats)

        def fn(rec):
            v = str(rec[i])
            if v not in lut:
                raise ValueError(
                    f"value {v!r} not in categories of {self.column!r} "
                    f"({cats})")
            hot = [0.0] * width
            hot[lut[v]] = 1.0
            return list(rec[:i]) + hot + list(rec[i + 1:])

        return fn

    def to_spec(self):
        return {"op": "one_hot", "column": self.column}


class StringToTime(Step):
    """strptime -> epoch SECONDS as float, evaluated against UTC
    (calendar.timegm, not mktime — host-timezone-independent, so the same
    records transform identically on every machine)."""

    def __init__(self, column: str, fmt: str):
        self.column, self.fmt = str(column), str(fmt)

    def output_schema(self, schema):
        cols = list(schema.columns)
        cols[schema.index_of(self.column)] = ColumnSpec(
            self.column, ColumnType.TIME)
        return Schema(cols)

    def compile(self, schema):
        i, fmt = schema.index_of(self.column), self.fmt

        def fn(rec):
            rec = list(rec)
            rec[i] = float(calendar.timegm(time.strptime(str(rec[i]), fmt)))
            return rec

        return fn

    def to_spec(self):
        return {"op": "string_to_time", "column": self.column,
                "format": self.fmt}


_CONDITIONS = {
    "lt": lambda v, k: v < k,
    "le": lambda v, k: v <= k,
    "gt": lambda v, k: v > k,
    "ge": lambda v, k: v >= k,
    "eq": lambda v, k: v == k,
    "ne": lambda v, k: v != k,
    "in": lambda v, k: v in k,
    "not_in": lambda v, k: v not in k,
}


class ConditionFilter(Step):
    """DROP records where column <condition> value holds (DataVec
    ConditionFilter semantics: the condition selects what is REMOVED).
    Numeric conditions coerce both sides to float; eq/ne/in fall back to
    string comparison when coercion fails."""

    is_filter = True

    def __init__(self, column: str, condition: str, value):
        if condition not in _CONDITIONS:
            raise ValueError(
                f"unknown condition {condition!r}: {sorted(_CONDITIONS)}")
        self.column, self.condition, self.value = (
            str(column), str(condition), value)

    def output_schema(self, schema):
        schema.index_of(self.column)
        return schema

    def compile(self, schema):
        i = schema.index_of(self.column)
        cond = _CONDITIONS[self.condition]
        val = self.value

        def fn(rec):
            v = rec[i]
            try:
                matched = cond(_to_number(v),
                               [float(x) for x in val]
                               if isinstance(val, (list, tuple))
                               else float(val))
            except (TypeError, ValueError):
                matched = cond(str(v),
                               [str(x) for x in val]
                               if isinstance(val, (list, tuple))
                               else str(val))
            return None if matched else rec

        return fn

    def to_spec(self):
        val = (list(self.value) if isinstance(self.value, (list, tuple))
               else self.value)
        return {"op": "condition_filter", "column": self.column,
                "condition": self.condition, "value": val}


class FilterInvalid(Step):
    """DROP records whose numeric/integer/time columns fail float()
    (DataVec FilterInvalidValues) — the transform-plane replacement for
    the old reader behavior of exploding mid-assembly."""

    is_filter = True

    def __init__(self, columns: Optional[Sequence[str]] = None):
        self.columns = None if columns is None else [str(c) for c in columns]

    def output_schema(self, schema):
        for c in self.columns or []:
            schema.index_of(c)
        return schema

    def compile(self, schema):
        if self.columns is None:
            idx = [i for i, c in enumerate(schema.columns)
                   if c.type in (ColumnType.NUMERIC, ColumnType.INTEGER,
                                 ColumnType.TIME)]
        else:
            idx = [schema.index_of(c) for c in self.columns]

        def fn(rec):
            for i in idx:
                try:
                    _to_number(rec[i])
                except (TypeError, ValueError):
                    return None
            return rec

        return fn

    def to_spec(self):
        return {"op": "filter_invalid",
                "columns": None if self.columns is None
                else list(self.columns)}


_WINDOW_OPS = {
    "mean": lambda vs: sum(vs) / len(vs),
    "sum": sum,
    "min": min,
    "max": max,
}


class RollingWindow(Step):
    """Append ``col_<op><window>``: the aggregate over the last K records'
    values of ``col`` INCLUDING the current one (the time-window
    transform; shorter at the head of the stream — DataVec's sequence
    window ops restricted to the trailing-window case). Stateful across
    the record stream, so ``compile`` hands out FRESH state and
    ``split_for_pipeline`` keeps it out of record-parallel workers."""

    is_stateful = True

    def __init__(self, column: str, window: int, op: str = "mean"):
        if op not in _WINDOW_OPS:
            raise ValueError(
                f"unknown window op {op!r}: {sorted(_WINDOW_OPS)}")
        if int(window) < 1:
            raise ValueError("window must be >= 1")
        self.column, self.window, self.op = str(column), int(window), str(op)

    @property
    def new_name(self) -> str:
        return f"{self.column}_{self.op}{self.window}"

    def output_schema(self, schema):
        schema.index_of(self.column)
        return Schema(list(schema.columns)
                      + [ColumnSpec(self.new_name, ColumnType.NUMERIC)])

    def compile(self, schema):
        i = schema.index_of(self.column)
        agg = _WINDOW_OPS[self.op]
        buf: deque = deque(maxlen=self.window)

        def fn(rec):
            buf.append(_to_number(rec[i]))
            return list(rec) + [agg(list(buf))]

        return fn

    def to_spec(self):
        return {"op": "rolling_window", "column": self.column,
                "window": self.window, "agg": self.op}


_STEP_FROM_SPEC = {
    "remove_columns": lambda s: RemoveColumns(s["names"]),
    "math_op": lambda s: MathOp(s["column"], s["math"], s.get("operand")),
    "derive": lambda s: Derive(s["new_name"], s["columns"], s["agg"]),
    "categorical_to_integer":
        lambda s: CategoricalToInteger(s["column"]),
    "one_hot": lambda s: CategoricalToOneHot(s["column"]),
    "string_to_time": lambda s: StringToTime(s["column"], s["format"]),
    "condition_filter":
        lambda s: ConditionFilter(s["column"], s["condition"], s["value"]),
    "filter_invalid": lambda s: FilterInvalid(s.get("columns")),
    "rolling_window":
        lambda s: RollingWindow(s["column"], s["window"], s["agg"]),
}


# ---------------------------------------------------------------------------
# TransformProcess
# ---------------------------------------------------------------------------


class TransformProcess:
    """Ordered steps over an initial schema, compiled into ONE executable
    record function (DataVec ``TransformProcess`` parity). Builder-style:
    every step method appends and returns self."""

    def __init__(self, schema: Schema):
        self.initial_schema = schema
        self.steps: List[Step] = []

    # -- builder surface ---------------------------------------------------
    def _add(self, step: Step) -> "TransformProcess":
        step.output_schema(self.final_schema())  # validate NOW, loudly
        self.steps.append(step)
        return self

    def remove_columns(self, *names: str) -> "TransformProcess":
        return self._add(RemoveColumns(names))

    def math_op(self, column: str, op: str,
                operand: Optional[float] = None) -> "TransformProcess":
        return self._add(MathOp(column, op, operand))

    def map_column(self, column: str, fn: Callable,
                   output_type: str = ColumnType.NUMERIC
                   ) -> "TransformProcess":
        return self._add(MapColumn(column, fn, output_type))

    def derive(self, new_name: str, columns: Sequence[str],
               op="sum") -> "TransformProcess":
        return self._add(Derive(new_name, columns, op))

    def categorical_to_integer(self, column: str) -> "TransformProcess":
        return self._add(CategoricalToInteger(column))

    def one_hot(self, column: str) -> "TransformProcess":
        return self._add(CategoricalToOneHot(column))

    def string_to_time(self, column: str, fmt: str) -> "TransformProcess":
        return self._add(StringToTime(column, fmt))

    def condition_filter(self, column: str, condition: str,
                         value) -> "TransformProcess":
        return self._add(ConditionFilter(column, condition, value))

    def filter_invalid(self, columns: Optional[Sequence[str]] = None
                       ) -> "TransformProcess":
        return self._add(FilterInvalid(columns))

    def rolling_window(self, column: str, window: int,
                       op: str = "mean") -> "TransformProcess":
        return self._add(RollingWindow(column, window, op))

    # -- execution ---------------------------------------------------------
    def final_schema(self) -> Schema:
        schema = self.initial_schema
        for step in self.steps:
            schema = step.output_schema(schema)
        return schema

    def compile(self) -> Callable[[list], Optional[list]]:
        """ONE fn(record)->record-or-None folding every step (fresh
        stateful-step state: call once per execution pass)."""
        fns = []
        schema = self.initial_schema
        for step in self.steps:
            fns.append(step.compile(schema))
            schema = step.output_schema(schema)

        def fn(rec):
            for f in fns:
                rec = f(rec)
                if rec is None:
                    return None
            return rec

        return fn

    def execute(self, records):
        """Transform an iterable of records; filtered records are dropped
        from the output stream."""
        fn = self.compile()
        for rec in records:
            out = fn(rec)
            if out is not None:
                yield out

    @property
    def is_record_parallel_safe(self) -> bool:
        """True when NO step filters or carries stream state — such a
        process may run per-record in parallel workers without changing
        batch boundaries or windowed values."""
        return not any(s.is_filter or s.is_stateful for s in self.steps)

    def split_for_pipeline(self):
        """(head, tail): head = everything up to and INCLUDING the last
        filter/stateful step (must run serially, in stream order), tail =
        the pure stateless suffix (safe for record-parallel workers).
        Either part may be None when empty."""
        cut = 0
        for k, step in enumerate(self.steps):
            if step.is_filter or step.is_stateful:
                cut = k + 1
        head = tail = None
        if cut:
            head = TransformProcess(self.initial_schema)
            head.steps = self.steps[:cut]
        if cut < len(self.steps):
            mid_schema = self.initial_schema
            for step in self.steps[:cut]:
                mid_schema = step.output_schema(mid_schema)
            tail = TransformProcess(mid_schema)
            tail.steps = self.steps[cut:]
        return head, tail

    # -- serde -------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "schema": json.loads(self.initial_schema.to_json()),
            "steps": [s.to_spec() for s in self.steps],
        })

    @staticmethod
    def from_json(s: str) -> "TransformProcess":
        data = json.loads(s)
        tp = TransformProcess(Schema.from_json(json.dumps(data["schema"])))
        for spec in data["steps"]:
            op = spec.get("op")
            if op not in _STEP_FROM_SPEC:
                raise ValueError(f"unknown transform step {op!r}")
            tp._add(_STEP_FROM_SPEC[op](spec))
        return tp


class TransformProcessRecordReader:
    """A RecordReader that applies a TransformProcess to a base reader's
    stream (DataVec TransformProcessRecordReader) — the bridge that lets
    the existing ``datasets.records.RecordReaderDataSetIterator`` consume
    transformed records unchanged. Fresh compile per pass, so stateful
    steps (rolling windows) restart with the stream."""

    def __init__(self, reader, transform: TransformProcess):
        self.reader = reader
        self.transform = transform

    def __iter__(self):
        return self.transform.execute(iter(self.reader))

    def reset(self) -> None:
        if hasattr(self.reader, "reset"):
            self.reader.reset()
