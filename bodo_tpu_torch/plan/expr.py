"""Expression nodes and their torch evaluator.

Counterpart of bodo_tpu/plan/expr.py for the nodes the relational path
uses: ColRef, Lit, DtField, IsIn, Where, Cast, UnOp, and BinOp for
comparisons, boolean `&`/`|` and arithmetic (`+ - * / // % ** max2
min2`). Expressions are frozen dataclasses with a structural `key()`.
Null semantics follow the JAX package: comparisons and arithmetic with a
null are null, filters treat null as False. Arithmetic runs in the dtype
`infer_dtype` gives, both operands cast to it first (jnp's weak-typed
literals and torch's 0-d promotion rules differ, so neither side's
implicit promotion is relied on). Decimal arithmetic and the remaining
nodes (string and date functions, UDFs) belong to a later slice.
"""

from __future__ import annotations

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


_CMP = {"==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
        ">": torch.gt, ">=": torch.ge}
_ARITH = ("+", "-", "*", "/", "//", "%", "**", "max2", "min2")


def _no_decimal(*types: dt.DType) -> None:
    if any(dt.is_decimal(t) for t in types):
        raise NotImplementedError("decimal arithmetic is not ported yet")


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
        raise NotImplementedError(f"literal {v!r} is not ported yet")
    if isinstance(e, Cast):
        return e.to
    if isinstance(e, DtField):
        return dt.DATE if e.field == "date" else dt.INT64
    if isinstance(e, IsIn):
        return dt.BOOL
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
    raise NotImplementedError(f"expression {e!r} is not ported yet")


# fields with fixed output ranges regardless of input
_FIELD_RANGES = {"month": (1, 12), "hour": (0, 23), "day": (1, 31),
                 "dayofweek": (0, 6), "weekday": (0, 6)}


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
    return None


def _lit_tensor(v, device) -> torch.Tensor:
    """A literal with the JAX package's 64-bit literal types."""
    if isinstance(v, (bool, np.bool_)):
        return torch.tensor(bool(v), device=device)
    if isinstance(v, (int, np.integer)):
        return torch.tensor(int(v), dtype=torch.int64, device=device)
    if isinstance(v, (float, np.floating)):
        return torch.tensor(float(v), dtype=torch.float64, device=device)
    raise NotImplementedError(f"literal {v!r} is not ported yet")


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
            raise NotImplementedError("IsIn over strings is not ported yet")
        d, v = eval_expr(e.operand, tree, dicts, schema)
        acc = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
        for val in e.values:
            acc = acc | (d == val)
        return acc, v
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
    raise NotImplementedError(f"expression {e!r} is not ported yet")


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
