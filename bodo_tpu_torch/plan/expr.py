"""Expression nodes and their torch evaluator.

Counterpart of bodo_tpu/plan/expr.py. Every node class of the JAX
package is here, so the SQL planner and its kernel library
(sql/planner.py, sql/kernels.py) build the same trees, with the same
`key()`s. The evaluator covers ColRef, Lit (numbers, strings inside a
string predicate, datetime64 and date literals), DtField, IsIn (numeric,
and over strings as a dictionary predicate), Where, Cast, UnOp, BinOp for
comparisons, boolean `&`/`|` and arithmetic (`+ - * / // % ** max2
min2`), and the dictionary-encoded string nodes: StrPredicate (eq_any,
contains, startswith, endswith, match, fullmatch, lower_eq) is a boolean
lookup table built on the host over the (DictMap-transformed)
dictionary and gathered by code on the device; DictMap (substring,
upper, lower) transforms that dictionary on the host, under a string
predicate or at the top of a projection (relational.assign_columns'
host pass).

Null semantics follow the JAX package: comparisons and arithmetic with a
null are null, filters treat null as False. Arithmetic runs in the dtype
`infer_dtype` gives, both operands cast to it first (jnp's weak-typed
literals and torch's 0-d promotion rules differ, so neither side's
implicit promotion is relied on). The other nodes (RowUDF, MathFn,
ToChar, MaskNull, CodeLUT, StrHostFn, StrConcat, DateTrunc, DateAdd,
DateDiff, StrLen, NestedFn, StrToList, StrCodes), DictMap's other kinds
and decimal arithmetic raise NotImplementedError when evaluated, naming
the node.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from bodo_tpu_torch.ops import datetime as dtops
from bodo_tpu_torch.table import dtypes as dt


class Expr:
    """Base class; all subclasses are frozen/hashable."""

    def _bin(self, op, other, reverse=False):
        o = other if isinstance(other, Expr) else Lit(other)
        return BinOp(op, o, self) if reverse else BinOp(op, self, o)

    def __add__(self, o): return self._bin("+", o)
    def __radd__(self, o): return self._bin("+", o, True)
    def __sub__(self, o): return self._bin("-", o)
    def __rsub__(self, o): return self._bin("-", o, True)
    def __mul__(self, o): return self._bin("*", o)
    def __rmul__(self, o): return self._bin("*", o, True)
    def __truediv__(self, o): return self._bin("/", o)
    def __rtruediv__(self, o): return self._bin("/", o, True)
    def __floordiv__(self, o): return self._bin("//", o)
    def __mod__(self, o): return self._bin("%", o)
    def __pow__(self, o): return self._bin("**", o)
    def __eq__(self, o): return self._bin("==", o)  # type: ignore[override]
    def __ne__(self, o): return self._bin("!=", o)  # type: ignore[override]
    def __lt__(self, o): return self._bin("<", o)
    def __le__(self, o): return self._bin("<=", o)
    def __gt__(self, o): return self._bin(">", o)
    def __ge__(self, o): return self._bin(">=", o)
    def __and__(self, o): return self._bin("&", o)
    def __or__(self, o): return self._bin("|", o)
    def __invert__(self): return UnOp("~", self)
    def __neg__(self): return UnOp("neg", self)
    def __abs__(self): return UnOp("abs", self)
    __hash__ = object.__hash__

    def isna(self): return UnOp("isna", self)
    def notna(self): return UnOp("notna", self)

    def key(self):
        """Structural key (__eq__ is overloaded as the comparison builder,
        so expressions cannot be compared directly)."""
        raise NotImplementedError


def _frozen(cls):
    return dataclass(frozen=True, eq=False, repr=True)(cls)


@_frozen
class ColRef(Expr):
    name: str
    def key(self): return ("col", self.name)


@_frozen
class Lit(Expr):
    value: Any
    def key(self): return ("lit", str(type(self.value).__name__), self.value)


@_frozen
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr
    def key(self): return ("bin", self.op, self.left.key(), self.right.key())


@_frozen
class UnOp(Expr):
    op: str
    operand: Expr
    def key(self): return ("un", self.op, self.operand.key())


@_frozen
class Cast(Expr):
    operand: Expr
    to: dt.DType
    def key(self): return ("cast", self.operand.key(), self.to.name)


@_frozen
class DtField(Expr):
    field: str
    operand: Expr
    def key(self): return ("dtf", self.field, self.operand.key())


@_frozen
class IsIn(Expr):
    operand: Expr
    values: Tuple
    def key(self): return ("isin", self.operand.key(), self.values)


@_frozen
class Where(Expr):
    cond: Expr
    iftrue: Expr
    iffalse: Expr
    def key(self):
        return ("where", self.cond.key(), self.iftrue.key(),
                self.iffalse.key())


@_frozen
class RowUDF(Expr):
    """Element-wise Python UDF (df.apply(axis=1) / Series.map). The
    port keys it like the JAX package; evaluating it is not ported."""
    func: Any
    out_dtype: Any
    operand: Any = None
    def key(self):
        return ("rowudf", _udf_serial(self.func),
                self.out_dtype.name if self.out_dtype else None,
                self.operand.key() if self.operand is not None else None)


_UDF_COUNTER = [0]


def _udf_serial(func) -> int:
    """Stable serial per live callable (id() is reused after GC)."""
    s = getattr(func, "__bodo_tpu_udf_serial__", None)
    if s is None:
        _UDF_COUNTER[0] += 1
        s = _UDF_COUNTER[0]
        func.__bodo_tpu_udf_serial__ = s
    return s


@_frozen
class DictMap(Expr):
    """String->string transform applied to the host dictionary; the device
    only remaps int32 codes through a host-built table. At the top level
    of a projection (relational.assign_columns attaches the new
    dictionary), or under a string predicate."""
    kind: str
    params: Tuple
    operand: Expr
    def key(self):
        return ("dictmap", self.kind, self.params, self.operand.key())

    def apply_host(self, s: str) -> str:
        if self.kind == "substring":
            start, length = self.params
            i = start - 1  # SQL is 1-based
            return s[i:i + length] if length is not None else s[i:]
        if self.kind == "upper":
            return s.upper()
        if self.kind == "lower":
            return s.lower()
        raise NotImplementedError(
            f"the dictionary transform {self.kind!r} (DictMap) is not "
            f"ported yet")


@_frozen
class MathFn(Expr):
    """Element-wise math function (SQL kernel library)."""
    kind: str
    params: Tuple
    operand: Expr
    def key(self): return ("math", self.kind, self.params, self.operand.key())


@_frozen
class ToChar(Expr):
    """TO_CHAR / TO_VARCHAR of a non-string operand."""
    fmt: Optional[str]
    operand: Expr
    def key(self): return ("tochar", self.fmt, self.operand.key())


@_frozen
class MaskNull(Expr):
    """Null out rows where `cond` holds (NULLIF)."""
    cond: Expr
    operand: Expr
    def key(self): return ("masknull", self.cond.key(), self.operand.key())


@_frozen
class CodeLUT(Expr):
    """String column from a small static vocabulary indexed by an integer
    expression (MONTHNAME/DAYNAME)."""
    strings: Tuple
    operand: Expr
    def key(self): return ("codelut", self.strings, self.operand.key())


@_frozen
class StrHostFn(Expr):
    """Numeric function of a string column, evaluated per dictionary
    entry on the host (position, ascii, to_number, to_date, ...)."""
    kind: str
    params: Tuple
    operand: Expr
    def key(self): return ("strhost", self.kind, self.params,
                           self.operand.key())


@_frozen
class StrConcat(Expr):
    """Concatenation of string columns and literal fragments."""
    parts: Tuple
    def key(self):
        return ("strcat", tuple(p if isinstance(p, str) else p.key()
                                for p in self.parts))



@_frozen
class DateTrunc(Expr):
    unit: str
    operand: Expr
    def key(self): return ("dtrunc", self.unit, self.operand.key())


@_frozen
class DateAdd(Expr):
    unit: str
    amount: Expr
    operand: Expr
    def key(self): return ("dadd", self.unit, self.amount.key(),
                           self.operand.key())


@_frozen
class DateDiff(Expr):
    unit: str
    left: Expr
    right: Expr
    def key(self): return ("ddiff", self.unit, self.left.key(),
                           self.right.key())


@_frozen
class StrLen(Expr):
    operand: Expr
    def key(self): return ("strlen", self.operand.key())


@_frozen
class NestedFn(Expr):
    kind: str
    params: Tuple
    operand: Expr
    def key(self): return ("nested", self.kind, self.params,
                           self.operand.key())


@_frozen
class StrToList(Expr):
    params: Tuple
    operand: Expr
    def key(self): return ("strtolist", self.params, self.operand.key())


@_frozen
class StrCodes(Expr):
    operand: Expr
    def key(self): return ("strcodes", self.operand.key())


@_frozen
class StrPredicate(Expr):
    """String predicate evaluated on the host dictionary -> device LUT.
    kind: contains | startswith | endswith | match | fullmatch | eq_any |
    lower_eq"""
    kind: str
    pattern: Tuple
    operand: Expr
    def key(self):
        return ("strp", self.kind, self.pattern, self.operand.key())


# nodes the evaluator does not take yet, by the JAX package's name
_UNPORTED = (RowUDF, MathFn, ToChar, MaskNull, CodeLUT, StrHostFn,
             StrConcat, DateTrunc, DateAdd, DateDiff, StrLen, NestedFn,
             StrToList, StrCodes)

_CMP = {"==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
        ">": torch.gt, ">=": torch.ge}
_ARITH = ("+", "-", "*", "/", "//", "%", "**", "max2", "min2")


def _no_decimal(*types: dt.DType) -> None:
    if any(dt.is_decimal(t) for t in types):
        raise NotImplementedError("decimal arithmetic is not ported yet")


# ---------------------------------------------------------------------------
# schema-level type inference (host side)
# ---------------------------------------------------------------------------

def infer_dtype(e: Expr, schema: Dict[str, dt.DType]) -> dt.DType:
    if isinstance(e, ColRef):
        return schema[e.name]
    if isinstance(e, Lit):
        v = e.value
        if isinstance(v, (bool, np.bool_)):
            return dt.BOOL
        if isinstance(v, (int, np.integer)):
            return dt.INT64
        if isinstance(v, (float, np.floating)):
            return dt.FLOAT64
        if isinstance(v, str):
            return dt.STRING
        if isinstance(v, np.datetime64):
            return dt.DATETIME
        import datetime as _dtmod
        if isinstance(v, _dtmod.date) and not isinstance(v, _dtmod.datetime):
            return dt.DATE
        raise TypeError(f"unsupported literal: {v!r}")
    if isinstance(e, Cast):
        return e.to
    if isinstance(e, DtField):
        return dt.DATE if e.field == "date" else dt.INT64
    if isinstance(e, (IsIn, StrPredicate)):
        return dt.BOOL
    if isinstance(e, (DictMap, CodeLUT, StrConcat, ToChar)):
        return dt.STRING
    if isinstance(e, (StrLen, DateDiff)):
        return dt.INT64
    if isinstance(e, StrCodes):
        return dt.INT32
    if isinstance(e, StrHostFn):
        return {"to_number": dt.FLOAT64,
                "to_date": dt.DATE}.get(e.kind, dt.INT64)
    if isinstance(e, MathFn):
        if e.kind == "sign":
            return dt.INT64
        if e.kind in ("ceil", "floor", "round", "round_even", "trunc"):
            src = infer_dtype(e.operand, schema)
            return src if src.kind in ("i", "u") else dt.FLOAT64
        return dt.FLOAT64
    if isinstance(e, (MaskNull, DateTrunc)):
        return infer_dtype(e.operand, schema)
    if isinstance(e, DateAdd):
        src = infer_dtype(e.operand, schema)
        if src is dt.DATE and e.unit in ("hour", "minute", "second"):
            return dt.DATETIME
        return src
    if isinstance(e, RowUDF):
        return e.out_dtype if e.out_dtype is not None else dt.FLOAT64
    if isinstance(e, (NestedFn, StrToList)):
        raise NotImplementedError(
            f"{type(e).__name__}: nested types (table/nested.py) are not "
            f"ported yet")
    if isinstance(e, UnOp):
        if e.op in ("isna", "notna", "~"):
            return dt.BOOL
        return infer_dtype(e.operand, schema)
    if isinstance(e, Where):
        t = infer_dtype(e.iftrue, schema)
        f = infer_dtype(e.iffalse, schema)
        if t is f:
            return t
        if dt.is_numeric(t) and dt.is_numeric(f):
            return dt.common_numeric(t, f)
        return t
    if isinstance(e, BinOp) and (e.op in _CMP or e.op in ("&", "|")):
        return dt.BOOL
    if isinstance(e, BinOp) and e.op in _ARITH:
        lt = infer_dtype(e.left, schema)
        rt = infer_dtype(e.right, schema)
        _no_decimal(lt, rt)
        if e.op == "/":
            return (dt.FLOAT64 if lt.numpy.itemsize == 8
                    or rt.numpy.itemsize == 8 else dt.FLOAT32)
        if dt.is_numeric(lt) and dt.is_numeric(rt):
            return dt.common_numeric(lt, rt)
        return lt
    raise TypeError(f"cannot infer dtype of {e}")


def expr_columns(e: Expr) -> set:
    """Free column references (for projection pushdown)."""
    if isinstance(e, ColRef):
        return {e.name}
    if isinstance(e, Lit):
        return set()
    if isinstance(e, BinOp):
        return expr_columns(e.left) | expr_columns(e.right)
    if isinstance(e, RowUDF):
        if e.operand is not None:
            return expr_columns(e.operand)
        return {"*"}  # may touch any column: disables pruning above it
    if isinstance(e, (UnOp, Cast, DtField, IsIn, StrPredicate, DictMap,
                      StrLen, MathFn, StrHostFn, CodeLUT, DateTrunc,
                      StrCodes, StrToList, NestedFn, ToChar)):
        return expr_columns(e.operand)
    if isinstance(e, Where):
        return (expr_columns(e.cond) | expr_columns(e.iftrue)
                | expr_columns(e.iffalse))
    if isinstance(e, MaskNull):
        return expr_columns(e.cond) | expr_columns(e.operand)
    if isinstance(e, DateAdd):
        return expr_columns(e.amount) | expr_columns(e.operand)
    if isinstance(e, DateDiff):
        return expr_columns(e.left) | expr_columns(e.right)
    if isinstance(e, StrConcat):
        out = set()
        for p in e.parts:
            if isinstance(p, Expr):
                out |= expr_columns(p)
        return out
    return set()


# fields with fixed output ranges regardless of input
_FIELD_RANGES = {"month": (1, 12), "hour": (0, 23), "day": (1, 31),
                 "dayofweek": (0, 6), "weekday": (0, 6),
                 "quarter": (1, 4), "minute": (0, 59), "second": (0, 59),
                 "week": (1, 53), "weekofyear": (1, 53),
                 "dayofyear": (1, 366)}


def expr_range(e: Expr, columns) -> Optional[tuple]:
    """Host-known (lo, hi, tight) bound on the physical values of `e`, or
    None. `tight`: parquet stats and literals are exact, fixed field
    ranges (month in 1..12) are loose and may be refined on the device."""
    if isinstance(e, ColRef):
        c = columns.get(e.name)
        return c.vrange if c is not None else None
    if isinstance(e, Lit):
        v = e.value
        if isinstance(v, (bool, np.bool_, int, np.integer)):
            return (int(v), int(v), True)
        return None
    if isinstance(e, DtField):
        if e.field in _FIELD_RANGES:
            lo, hi = _FIELD_RANGES[e.field]
            return (lo, hi, False)
        src = expr_range(e.operand, columns)
        if src is None:
            return None
        tight = len(src) > 2 and bool(src[2])
        if e.field == "date":       # monotone in ticks
            return (int(src[0]) // dtops.NS_PER_DAY,
                    int(src[1]) // dtops.NS_PER_DAY, tight)
        if e.field == "year":       # monotone in ticks
            return (int(np.datetime64(int(src[0]), "ns").astype(
                        "datetime64[Y]").astype(int)) + 1970,
                    int(np.datetime64(int(src[1]), "ns").astype(
                        "datetime64[Y]").astype(int)) + 1970, tight)
        return None
    if isinstance(e, Where):
        a = expr_range(e.iftrue, columns)
        b = expr_range(e.iffalse, columns)
        if a is None or b is None:
            return None
        return (min(a[0], b[0]), max(a[1], b[1]),
                (len(a) > 2 and bool(a[2])) and (len(b) > 2 and bool(b[2])))
    if isinstance(e, Cast):
        if e.to.kind in ("i", "u"):
            r = expr_range(e.operand, columns)
            if r is None:
                return None
            # a narrowing cast wraps values outside the target type: the
            # operand's bound holds only when it fits the target
            info = np.iinfo(e.to.numpy)
            if info.min <= r[0] and r[1] <= info.max:
                return r
        return None
    if isinstance(e, MaskNull):
        return expr_range(e.operand, columns)
    return None


# ---------------------------------------------------------------------------
# evaluation (device side)
# ---------------------------------------------------------------------------

def _lit_tensor(v, device) -> torch.Tensor:
    """A literal in the JAX package's physical representation: 64-bit
    numbers, datetime64 as int64 ns ticks, a date as int32 days."""
    if isinstance(v, (bool, np.bool_)):
        return torch.tensor(bool(v), device=device)
    if isinstance(v, (int, np.integer)):
        return torch.tensor(int(v), dtype=torch.int64, device=device)
    if isinstance(v, (float, np.floating)):
        return torch.tensor(float(v), dtype=torch.float64, device=device)
    if isinstance(v, str):
        raise TypeError(
            "string literal outside a string predicate: string comparisons "
            "become StrPredicate (the SQL planner does this)")
    if isinstance(v, np.datetime64):
        return torch.tensor(int(v.astype("datetime64[ns]").astype(np.int64)),
                            dtype=torch.int64, device=device)
    import datetime as _dtmod
    if isinstance(v, _dtmod.date) and not isinstance(v, _dtmod.datetime):
        days = (np.datetime64(v, "D") - np.datetime64(0, "D")).astype(
            np.int64)
        return torch.tensor(int(days), dtype=torch.int32, device=device)
    raise TypeError(f"unsupported literal: {v!r}")


def _dictionary_codes(col: Expr, tree, dicts):
    """(host dictionary after the DictMap chain over `col`, device codes,
    valid) of a string operand: a column under zero or more DictMaps."""
    transforms = []
    while isinstance(col, DictMap):
        transforms.append(col)
        col = col.operand
    if isinstance(col, CodeLUT):
        raise NotImplementedError("CodeLUT (MONTHNAME/DAYNAME) evaluation "
                                  "is not ported yet")
    if not isinstance(col, ColRef):
        raise TypeError("string predicates must apply to a column")
    dic0 = dicts.get(col.name)
    if dic0 is None:
        raise TypeError(f"column {col.name} has no dictionary")
    dic = list(dic0)
    for tr in reversed(transforms):
        dic = [tr.apply_host(s) for s in dic]
    d, v = tree[col.name]
    return dic, d, v


def _str_predicate_lut(e: StrPredicate, dic) -> np.ndarray:
    """The predicate on every dictionary entry (one entry at least)."""
    lut = np.zeros(max(len(dic), 1), dtype=bool)
    pats = list(e.pattern)
    for i, s in enumerate(dic):
        if e.kind == "contains":
            lut[i] = pats[0] in s
        elif e.kind == "startswith":
            lut[i] = s.startswith(tuple(pats))
        elif e.kind == "endswith":
            lut[i] = s.endswith(tuple(pats))
        elif e.kind == "match":
            lut[i] = re.match(pats[0], s) is not None
        elif e.kind == "fullmatch":
            lut[i] = re.fullmatch(pats[0], s) is not None
        elif e.kind == "eq_any":
            lut[i] = s in pats
        elif e.kind == "lower_eq":
            lut[i] = s.lower() == pats[0]
        else:
            raise ValueError(f"unknown str predicate {e.kind}")
    return lut


def eval_expr(e: Expr, tree: Dict[str, Tuple], dicts: Dict[str, np.ndarray],
              schema: Dict[str, dt.DType]):
    """Evaluate to (data, valid_or_None). `tree` maps column name to
    (data, valid); `dicts` holds host dictionaries of string columns."""
    if isinstance(e, ColRef):
        return tree[e.name]
    if isinstance(e, Lit):
        device = next(iter(tree.values()))[0].device
        return _lit_tensor(e.value, device), None
    if isinstance(e, Cast):
        d, v = eval_expr(e.operand, tree, dicts, schema)
        src = infer_dtype(e.operand, schema)
        if e.to is dt.STRING:
            raise TypeError("cast to string not supported on device")
        _no_decimal(src, e.to)
        if src.kind == "f" and e.to.kind in ("i", "u"):
            nan = torch.isnan(d)
            v = (~nan) if v is None else (v & ~nan)
            d = torch.where(nan, 0, d)
        return d.to(e.to.torch), v
    if isinstance(e, UnOp):
        d, v = eval_expr(e.operand, tree, dicts, schema)
        if e.op in ("isna", "notna"):
            isna = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
            if v is not None:
                isna = ~v
            if d.is_floating_point():
                isna = isna | torch.isnan(d)
            return (isna if e.op == "isna" else ~isna), None
        if e.op == "~":
            return torch.logical_not(d), v
        if e.op == "neg":
            return torch.neg(d), v
        if e.op == "abs":
            return torch.abs(d), v
        raise ValueError(f"unknown unop {e.op}")
    if isinstance(e, DtField):
        d, v = eval_expr(e.operand, tree, dicts, schema)
        if infer_dtype(e.operand, schema) is dt.DATE:
            # DATE stores days; the field kernels take ns ticks
            d = d.to(torch.int64) * dtops.NS_PER_DAY
        if e.field not in dtops.FIELDS:
            raise NotImplementedError(f"datetime field {e.field!r} is not "
                                      f"ported yet")
        return dtops.FIELDS[e.field](d), v
    if isinstance(e, IsIn):
        if infer_dtype(e.operand, schema) is dt.STRING:
            return eval_expr(StrPredicate("eq_any", tuple(e.values),
                                          e.operand), tree, dicts, schema)
        d, v = eval_expr(e.operand, tree, dicts, schema)
        acc = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
        for val in e.values:
            acc = acc | (d == val)
        return acc, v
    if isinstance(e, StrPredicate):
        dic, d, v = _dictionary_codes(e.operand, tree, dicts)
        lut = torch.from_numpy(_str_predicate_lut(e, dic)).to(d.device)
        return lut[torch.clamp(d.to(torch.int64), 0, len(dic) - 1
                               if dic else 0)], v
    if isinstance(e, DictMap):
        raise TypeError("a string transform (DictMap) must sit at the top "
                        "level of a projection or under a string predicate")
    if isinstance(e, _UNPORTED):
        raise NotImplementedError(
            f"evaluating {type(e).__name__} (bodo_tpu/plan/expr.py) is not "
            f"ported yet")
    if isinstance(e, Where):
        c, cv = eval_expr(e.cond, tree, dicts, schema)
        t, tv = eval_expr(e.iftrue, tree, dicts, schema)
        f, fv = eval_expr(e.iffalse, tree, dicts, schema)
        rdt = infer_dtype(e, schema)
        if rdt is dt.STRING:
            raise TypeError("string Where requires a dictionary rewrite")
        t = t.to(rdt.torch)
        f = f.to(rdt.torch)
        cond = c if cv is None else (c & cv)
        out = torch.where(cond, t, f)
        valid = None
        if tv is not None or fv is not None:
            ones = torch.ones(out.shape, dtype=torch.bool, device=out.device)
            valid = torch.where(cond, ones if tv is None else tv,
                                ones if fv is None else fv)
        return out, valid
    if isinstance(e, BinOp):
        ld, lv = eval_expr(e.left, tree, dicts, schema)
        rd, rv = eval_expr(e.right, tree, dicts, schema)
        if e.op in ("&", "|"):
            # null-as-False three-valued logic collapse (filter semantics)
            if lv is not None:
                ld = ld & lv
            if rv is not None:
                rd = rd & rv
            return (ld & rd if e.op == "&" else ld | rd), None
        if e.op not in _CMP and e.op not in _ARITH:
            raise ValueError(f"unknown binop {e.op}")
        lt = infer_dtype(e.left, schema)
        rt = infer_dtype(e.right, schema)
        if lt is dt.STRING or rt is dt.STRING:
            raise TypeError("string comparison must be rewritten to "
                            "dictionary codes")
        _no_decimal(lt, rt)
        # DATE (days) vs DATETIME (ns) physical coercion
        if lt is dt.DATE and rt is dt.DATETIME:
            ld = ld.to(torch.int64) * dtops.NS_PER_DAY
        elif lt is dt.DATETIME and rt is dt.DATE:
            rd = rd.to(torch.int64) * dtops.NS_PER_DAY
        valid = None
        if lv is not None or rv is not None:
            valid = (torch.ones(ld.shape, dtype=torch.bool,
                                device=ld.device) if lv is None else lv)
            if rv is not None:
                valid = valid & rv
        if e.op in _CMP:
            return _CMP[e.op](ld, rd), valid
        return _arith(e.op, ld, rd, infer_dtype(e, schema).torch), valid
    raise TypeError(f"cannot evaluate {e}")


def _arith(op: str, ld, rd, rdt: torch.dtype):
    """One arithmetic BinOp with both operands cast to the result dtype.
    `//` and `%` floor (Python/numpy semantics: torch.remainder, not
    fmod) and divide by 1 where the divisor is 0, as the JAX package
    does."""
    ld, rd = ld.to(rdt), rd.to(rdt)
    if op == "+":
        return ld + rd
    if op == "-":
        return ld - rd
    if op == "*":
        return ld * rd
    if op == "/":
        return ld / rd
    if op in ("//", "%"):
        rd = torch.where(rd == 0, torch.ones((), dtype=rdt,
                                             device=rd.device), rd)
        return (torch.floor_divide(ld, rd) if op == "//"
                else torch.remainder(ld, rd))
    if op == "**":
        return torch.pow(ld, rd)
    if op == "max2":   # GREATEST/LEAST: null if either side is null
        return torch.maximum(ld, rd)
    return torch.minimum(ld, rd)
