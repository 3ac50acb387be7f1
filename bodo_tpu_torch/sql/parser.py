"""SQL tokenizer + recursive-descent parser → AST.

The port's copy of bodo_tpu/sql/parser.py (pure Python, so both
packages parse a query into the same AST): a self-contained parser
covering the analytical SQL core: SELECT [DISTINCT], FROM with aliases,
subqueries and CTEs (WITH), INNER/LEFT/RIGHT/CROSS JOIN ... ON, WHERE,
GROUP BY, HAVING, ORDER BY [ASC|DESC] [NULLS LAST], LIMIT, CASE WHEN,
BETWEEN, IN (list|subquery), EXISTS, LIKE, IS [NOT] NULL, CAST, EXTRACT,
DATE/INTERVAL literals, and the standard operator precedence chain.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class Select:
    projections: List[Tuple[Any, Optional[str]]]  # (expr, alias)
    from_item: Any = None
    where: Any = None
    group_by: List[Any] = field(default_factory=list)
    having: Any = None
    order_by: List[Tuple[Any, bool]] = field(default_factory=list)
    limit: Optional[int] = None
    distinct: bool = False
    ctes: List[Tuple[str, "Select"]] = field(default_factory=list)


@dataclass
class UnionSel:
    selects: List["Select"]
    alls: List[bool] = field(default_factory=list)  # per UNION operator
    order_by: List[Tuple[Any, bool]] = field(default_factory=list)
    limit: Optional[int] = None


@dataclass
class TableRef:
    name: str
    alias: Optional[str] = None


@dataclass
class SubSelect:
    select: Select
    alias: str


@dataclass
class JoinItem:
    left: Any
    right: Any
    kind: str          # inner/left/right/outer/cross
    on: Any = None
    using: Any = None  # list of column names for JOIN ... USING (a, b)


@dataclass
class Col:
    name: str
    qualifier: Optional[str] = None


@dataclass
class Num:
    value: Any


@dataclass
class Str:
    value: str


@dataclass
class DateLit:
    value: str


@dataclass
class IntervalLit:
    value: int
    unit: str          # year/month/day/hour/minute/second


@dataclass
class BinA:
    op: str
    left: Any
    right: Any


@dataclass
class UnA:
    op: str            # not / neg / isnull / notnull
    operand: Any


@dataclass
class Func:
    name: str
    args: List[Any]
    distinct: bool = False
    star: bool = False  # count(*)


@dataclass
class WindowA:
    """fn(...) OVER (PARTITION BY ... ORDER BY ... [ROWS BETWEEN]).
    frame: None (default), or ("rows", lo, hi) with lo/hi row offsets
    (negative = preceding, None = unbounded on that end)."""
    func: "Func"
    partition_by: List[Any]
    order_by: List[Tuple[Any, bool]]  # (expr, ascending)
    frame: Any = None


@dataclass
class Case:
    whens: List[Tuple[Any, Any]]
    else_: Any = None


@dataclass
class CastA:
    operand: Any
    to: str
    try_: bool = False


@dataclass
class FlattenItem:
    """LATERAL FLATTEN(input => <expr>) [AS] alias — the table function
    form of array explode (reference: BodoSQL lateral.py FLATTEN)."""
    input: Any
    alias: str = "f"
    outer: bool = False


@dataclass
class InList:
    operand: Any
    values: List[Any]
    negated: bool = False


@dataclass
class InSelect:
    operand: Any
    select: Select
    negated: bool = False


@dataclass
class Exists:
    select: Select
    negated: bool = False


@dataclass
class ScalarSubquery:
    select: Select


@dataclass
class Between:
    operand: Any
    lo: Any
    hi: Any
    negated: bool = False


@dataclass
class Like:
    operand: Any
    pattern: str
    negated: bool = False


@dataclass
class Extract:
    field: str
    operand: Any


@dataclass
class SubstringA:
    operand: Any
    start: int
    length: Optional[int]


@dataclass
class StarA:
    qualifier: Optional[str] = None


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*\n?)
  | (?P<num>\d+\.\d*|\.\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qid>"[^"]+")
  | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><>|!=|>=|<=|=>|\|\||[=<>+\-*/%(),.;])
""", re.VERBOSE)


def tokenize(sql: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SyntaxError(f"bad SQL at: {sql[pos:pos+30]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "id":
            out.append(("kw" if text.upper() in _KEYWORDS else "id", text))
        elif kind == "qid":
            out.append(("id", text[1:-1]))
        elif kind == "str":
            out.append(("str", text[1:-1].replace("''", "'")))
        else:
            out.append((kind, text))
    out.append(("eof", ""))
    return out


_KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "AS", "AND", "OR", "NOT", "IN", "IS", "NULL", "LIKE", "BETWEEN",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "ON",
    "CASE", "WHEN", "THEN", "ELSE", "END", "CAST", "TRY_CAST", "DISTINCT",
    "EXISTS", "LATERAL",
    "ASC", "DESC", "DATE", "INTERVAL", "EXTRACT", "WITH", "UNION", "ALL",
    "SUBSTRING", "FOR", "NULLS", "FIRST", "LAST", "TRUE", "FALSE",
    "OVER", "PARTITION",
}


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers ----------------------------------------------------
    def peek(self, k: int = 0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def kw(self, *words) -> bool:
        t, v = self.peek()
        return t == "kw" and v.upper() in words

    def eat_kw(self, *words) -> str:
        if not self.kw(*words):
            raise SyntaxError(f"expected {words}, got {self.peek()}")
        v = self.toks[self.i][1].upper()
        self.i += 1
        return v

    def try_kw(self, *words) -> bool:
        if self.kw(*words):
            self.i += 1
            return True
        return False

    def eat_op(self, op: str):
        t, v = self.peek()
        if t != "op" or v != op:
            raise SyntaxError(f"expected {op!r}, got {self.peek()}")
        self.i += 1

    def try_op(self, op: str) -> bool:
        t, v = self.peek()
        if t == "op" and v == op:
            self.i += 1
            return True
        return False

    def ident(self) -> str:
        t, v = self.peek()
        if t != "id":
            raise SyntaxError(f"expected identifier, got {self.peek()}")
        self.i += 1
        return v

    # -- grammar ----------------------------------------------------------
    def parse(self):
        sel = self.select_stmt()
        self.try_op(";")
        t, _ = self.peek()
        if t != "eof":
            raise SyntaxError(f"trailing tokens at {self.peek()}")
        return sel

    def select_stmt(self):
        ctes = []
        if self.try_kw("WITH"):
            while True:
                name = self.ident()
                self.eat_kw("AS")
                self.eat_op("(")
                ctes.append((name, self.select_stmt()))
                self.eat_op(")")
                if not self.try_op(","):
                    break
        sel = self.select_core()
        sels = [sel]
        alls: List[bool] = []
        while self.kw("UNION"):
            self.eat_kw("UNION")
            alls.append(self.try_kw("ALL"))
            sels.append(self.select_core())
        if len(sels) > 1:
            # ORDER BY / LIMIT written after the chain are consumed by the
            # last arm's select_core — they belong to the whole union
            for arm in sels[:-1]:
                if arm.order_by or arm.limit is not None:
                    raise NotImplementedError(
                        "ORDER BY/LIMIT inside a UNION arm — wrap the arm "
                        "in a subquery")
            last = sels[-1]
            u = UnionSel(sels, alls, order_by=last.order_by,
                         limit=last.limit)
            last.order_by = []
            last.limit = None
            if ctes:
                raise NotImplementedError("WITH + UNION (wrap in subquery)")
            return u
        sel.ctes = ctes
        return sel

    def select_core(self) -> Select:
        self.eat_kw("SELECT")
        distinct = self.try_kw("DISTINCT")
        projs = []
        while True:
            if self.try_op("*"):
                projs.append((StarA(), None))
            elif self.peek()[0] == "id" and self.peek(1)[1] == "." and \
                    self.peek(2)[1] == "*":
                q = self.ident()
                self.eat_op(".")
                self.eat_op("*")
                projs.append((StarA(q), None))
            else:
                e = self.expr()
                alias = None
                if self.try_kw("AS"):
                    alias = self.ident()
                elif self.peek()[0] == "id":
                    alias = self.ident()
                projs.append((e, alias))
            if not self.try_op(","):
                break
        sel = Select(projections=projs, distinct=distinct)
        if self.try_kw("FROM"):
            sel.from_item = self.from_clause()
        if self.try_kw("WHERE"):
            sel.where = self.expr()
        if self.kw("GROUP"):
            self.eat_kw("GROUP")
            self.eat_kw("BY")
            while True:
                sel.group_by.append(self.expr())
                if not self.try_op(","):
                    break
        if self.try_kw("HAVING"):
            sel.having = self.expr()
        if self.kw("ORDER"):
            self.eat_kw("ORDER")
            self.eat_kw("BY")
            while True:
                e = self.expr()
                asc = True
                if self.try_kw("DESC"):
                    asc = False
                else:
                    self.try_kw("ASC")
                if self.try_kw("NULLS"):
                    self.eat_kw("FIRST", "LAST")
                sel.order_by.append((e, asc))
                if not self.try_op(","):
                    break
        if self.try_kw("LIMIT"):
            t, v = self.peek()
            if t != "num":
                raise SyntaxError("LIMIT expects a number")
            self.i += 1
            sel.limit = int(v)
        return sel

    def from_clause(self):
        item = self.table_item()
        while True:
            if self.try_op(","):
                right = self.table_item()
                item = JoinItem(item, right, "cross")
            elif self.kw("JOIN", "INNER", "LEFT", "RIGHT", "CROSS", "FULL"):
                kind = "inner"
                if self.try_kw("INNER"):
                    pass
                elif self.try_kw("LEFT"):
                    self.try_kw("OUTER")
                    kind = "left"
                elif self.try_kw("RIGHT"):
                    self.try_kw("OUTER")
                    kind = "right"
                elif self.try_kw("CROSS"):
                    kind = "cross"
                elif self.try_kw("FULL"):
                    self.try_kw("OUTER")
                    kind = "outer"
                self.eat_kw("JOIN")
                right = self.table_item()
                on = None
                using = None
                if kind != "cross":
                    # USING is not in _KEYWORDS; it tokenizes as an id
                    if (self.peek()[0] == "id" and
                            self.peek()[1].upper() == "USING"):
                        self.i += 1
                        self.eat_op("(")
                        using = [self.ident()]
                        while self.try_op(","):
                            using.append(self.ident())
                        self.eat_op(")")
                    else:
                        self.eat_kw("ON")
                        on = self.expr()
                item = JoinItem(item, right, kind, on, using)
            else:
                return item

    def table_item(self):
        if self.try_op("("):
            sub = self.select_stmt()
            self.eat_op(")")
            self.try_kw("AS")
            alias = self.ident()
            return SubSelect(sub, alias)
        if self.try_kw("LATERAL"):
            return self._flatten_item()
        if self.peek()[0] == "id" and \
                self.peek()[1].upper() in ("FLATTEN", "TABLE") and \
                self.peek(1) == ("op", "("):
            if self.peek()[1].upper() == "TABLE":
                self.i += 1          # TABLE ( FLATTEN (...) ) alias
                self.eat_op("(")
                item = self._flatten_item()
                self.eat_op(")")
                self.try_kw("AS")
                if self.peek()[0] == "id":
                    item.alias = self.ident()
                return item
            return self._flatten_item()
        name = self.ident()
        alias = None
        if self.try_kw("AS"):
            alias = self.ident()
        elif self.peek()[0] == "id" and self.peek()[1].upper() != "USING":
            # USING introduces a join-key list, never a table alias
            alias = self.ident()
        return TableRef(name, alias)

    def _flatten_item(self) -> "FlattenItem":
        """FLATTEN(input => expr [, outer => true|false]) [AS] alias."""
        nm = self.ident()
        if nm.upper() != "FLATTEN":
            raise NotImplementedError(
                f"LATERAL {nm} (only FLATTEN is supported)")
        self.eat_op("(")
        inp = None
        outer = False
        while True:
            t, v = self.peek()
            if t in ("id", "kw") and v.upper() in ("INPUT", "OUTER") and \
                    self.peek(1) == ("op", "=>"):
                key = v.upper()
                self.i += 2
                if key == "INPUT":
                    inp = self.expr()
                else:
                    outer = self.eat_kw("TRUE", "FALSE") == "TRUE"
            else:
                inp = self.expr()
            if not self.try_op(","):
                break
        self.eat_op(")")
        if inp is None:
            raise SyntaxError("FLATTEN requires an input argument")
        self.try_kw("AS")
        alias = "f"
        if self.peek()[0] == "id" and \
                self.peek()[1].upper() != "USING":
            alias = self.ident()
        return FlattenItem(inp, alias, outer)

    # -- expressions (precedence climbing) --------------------------------
    def expr(self):
        return self.or_expr()

    def _over_clause(self, fn: Func) -> WindowA:
        self.eat_kw("OVER")
        self.eat_op("(")
        partition: List[Any] = []
        order: List[Tuple[Any, bool]] = []
        if self.try_kw("PARTITION"):
            self.eat_kw("BY")
            partition.append(self.expr())
            while self.try_op(","):
                partition.append(self.expr())
        if self.try_kw("ORDER"):
            self.eat_kw("BY")
            while True:
                e = self.expr()
                asc = True
                if self.try_kw("DESC"):
                    asc = False
                else:
                    self.try_kw("ASC")
                order.append((e, asc))
                if not self.try_op(","):
                    break
        frame = None
        if self._try_word("ROWS"):
            if not self.try_kw("BETWEEN"):
                # shorthand <bound> = BETWEEN <bound> AND CURRENT ROW;
                # SQL requires the bound not to follow the current row
                lo = self._frame_bound()
                if lo == "unb_foll" or (isinstance(lo, int) and lo > 0):
                    raise SyntaxError(
                        "ROWS <bound> shorthand requires PRECEDING or "
                        "CURRENT ROW (use ROWS BETWEEN ... AND n "
                        "FOLLOWING)")
                frame = ("rows", None if lo == "unb_prec" else lo, 0)
            else:
                lo = self._frame_bound()
                self.eat_kw("AND")
                hi = self._frame_bound()
                if lo == "unb_foll" or hi == "unb_prec":
                    raise SyntaxError(
                        "frame start may not be UNBOUNDED FOLLOWING and "
                        "frame end may not be UNBOUNDED PRECEDING")
                lo = None if lo == "unb_prec" else lo
                hi = None if hi == "unb_foll" else hi
                if lo is not None and hi is not None and lo > hi:
                    raise SyntaxError(
                        f"frame start ({lo}) follows frame end ({hi})")
                frame = ("rows", lo, hi)
        elif self._try_word("RANGE"):
            # only the default RANGE frame shapes are modeled
            if not self.try_kw("BETWEEN"):
                b = self._frame_bound()
                if b != "unb_prec":
                    raise NotImplementedError("RANGE with a value offset")
            else:
                lo = self._frame_bound()
                self.eat_kw("AND")
                hi = self._frame_bound()
                if not (lo == "unb_prec" and hi in (0, "unb_foll")):
                    raise NotImplementedError("RANGE with value offsets")
                if hi == "unb_foll":
                    frame = ("rows", None, None)  # whole partition
        self.eat_op(")")
        return WindowA(fn, partition, order, frame)

    def _try_word(self, word: str) -> bool:
        """Match a non-reserved word token (id or kw) case-insensitively."""
        t, v = self.peek()
        if t in ("id", "kw") and v.upper() == word:
            self.i += 1
            return True
        return False

    def _frame_bound(self):
        """UNBOUNDED PRECEDING/FOLLOWING | CURRENT ROW | n PRECEDING |
        n FOLLOWING → row offset (int, 0 = current row) or the markers
        "unb_prec"/"unb_foll" so the caller can validate direction."""
        if self._try_word("UNBOUNDED"):
            if self._try_word("PRECEDING"):
                return "unb_prec"
            if self._try_word("FOLLOWING"):
                return "unb_foll"
            raise SyntaxError("expected PRECEDING/FOLLOWING")
        if self._try_word("CURRENT"):
            if not self._try_word("ROW"):
                raise SyntaxError("expected CURRENT ROW")
            return 0
        t, v = self.peek()
        if t == "num":
            self.i += 1
            n = int(v)
            if self._try_word("PRECEDING"):
                return -n
            if self._try_word("FOLLOWING"):
                return n
            raise SyntaxError("expected PRECEDING/FOLLOWING")
        raise SyntaxError(f"bad frame bound at {self.peek()}")

    def or_expr(self):
        e = self.and_expr()
        while self.try_kw("OR"):
            e = BinA("|", e, self.and_expr())
        return e

    def and_expr(self):
        e = self.not_expr()
        while self.try_kw("AND"):
            e = BinA("&", e, self.not_expr())
        return e

    def not_expr(self):
        if self.try_kw("NOT"):
            return UnA("not", self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self):
        e = self.concat_expr()
        while True:
            t, v = self.peek()
            if t == "op" and v in ("=", "<>", "!=", "<", "<=", ">", ">="):
                self.i += 1
                op = {"=": "==", "<>": "!="}.get(v, v)
                e = BinA(op, e, self.concat_expr())
            elif self.kw("IS"):
                self.eat_kw("IS")
                neg = self.try_kw("NOT")
                self.eat_kw("NULL")
                e = UnA("notnull" if neg else "isnull", e)
            elif self.kw("BETWEEN") or (self.kw("NOT") and
                                        self.peek(1)[1].upper() == "BETWEEN"):
                neg = self.try_kw("NOT")
                self.eat_kw("BETWEEN")
                lo = self.concat_expr()
                self.eat_kw("AND")
                hi = self.concat_expr()
                e = Between(e, lo, hi, neg)
            elif self.kw("IN") or (self.kw("NOT") and
                                   self.peek(1)[1].upper() == "IN"):
                neg = self.try_kw("NOT")
                self.eat_kw("IN")
                self.eat_op("(")
                if self.kw("SELECT", "WITH"):
                    sub = self.select_stmt()
                    self.eat_op(")")
                    e = InSelect(e, sub, neg)
                else:
                    vals = [self.expr()]
                    while self.try_op(","):
                        vals.append(self.expr())
                    self.eat_op(")")
                    e = InList(e, vals, neg)
            elif self.kw("LIKE") or (self.kw("NOT") and
                                     self.peek(1)[1].upper() == "LIKE"):
                neg = self.try_kw("NOT")
                self.eat_kw("LIKE")
                t2, v2 = self.peek()
                if t2 != "str":
                    raise SyntaxError("LIKE expects a string literal")
                self.i += 1
                e = Like(e, v2, neg)
            else:
                return e

    def concat_expr(self):
        e = self.add_expr()
        while True:
            t, v = self.peek()
            if t == "op" and v == "||":
                self.i += 1
                rhs = self.add_expr()
                # flatten a || b || c into one CONCAT call
                if isinstance(e, Func) and e.name == "concat":
                    e = Func("concat", e.args + [rhs])
                else:
                    e = Func("concat", [e, rhs])
            else:
                return e

    def add_expr(self):
        e = self.mul_expr()
        while True:
            t, v = self.peek()
            if t == "op" and v in ("+", "-"):
                self.i += 1
                e = BinA(v, e, self.mul_expr())
            else:
                return e

    def mul_expr(self):
        e = self.unary_expr()
        while True:
            t, v = self.peek()
            if t == "op" and v in ("*", "/", "%"):
                self.i += 1
                e = BinA(v, e, self.unary_expr())
            else:
                return e

    def unary_expr(self):
        t, v = self.peek()
        if t == "op" and v == "-":
            self.i += 1
            return UnA("neg", self.unary_expr())
        if t == "op" and v == "+":
            self.i += 1
            return self.unary_expr()
        return self.primary()

    def primary(self):
        t, v = self.peek()
        if t == "op" and v == "(":
            self.i += 1
            if self.kw("SELECT", "WITH"):
                sub = self.select_stmt()
                self.eat_op(")")
                return ScalarSubquery(sub)
            e = self.expr()
            self.eat_op(")")
            return e
        if t == "num":
            self.i += 1
            return Num(float(v) if "." in v else int(v))
        if t == "str":
            self.i += 1
            return Str(v)
        if self.kw("TRUE"):
            self.i += 1
            return Num(True)
        if self.kw("FALSE"):
            self.i += 1
            return Num(False)
        if self.kw("NULL"):
            self.i += 1
            return Num(None)
        if self.kw("DATE"):
            self.i += 1
            t2, v2 = self.peek()
            if t2 != "str":
                raise SyntaxError("DATE expects a string literal")
            self.i += 1
            return DateLit(v2)
        if self.kw("INTERVAL"):
            self.i += 1
            t2, v2 = self.peek()
            if t2 != "str":
                raise SyntaxError("INTERVAL expects a quoted quantity")
            self.i += 1
            unit = self.ident().lower().rstrip("s")
            return IntervalLit(int(v2), unit)
        if self.kw("CASE"):
            self.i += 1
            whens = []
            else_ = None
            while self.try_kw("WHEN"):
                c = self.expr()
                self.eat_kw("THEN")
                whens.append((c, self.expr()))
            if self.try_kw("ELSE"):
                else_ = self.expr()
            self.eat_kw("END")
            return Case(whens, else_)
        if self.kw("CAST", "TRY_CAST"):
            is_try = self.peek()[1].upper() == "TRY_CAST"
            self.i += 1
            self.eat_op("(")
            e = self.expr()
            self.eat_kw("AS")
            ty = self.ident()
            # swallow precision args e.g. DECIMAL(12,2)
            if self.try_op("("):
                while not self.try_op(")"):
                    self.i += 1
            self.eat_op(")")
            return CastA(e, ty.lower(), is_try)
        if self.kw("EXTRACT"):
            self.i += 1
            self.eat_op("(")
            fld = self.ident().lower()
            self.eat_kw("FROM")
            e = self.expr()
            self.eat_op(")")
            return Extract(fld, e)
        if self.kw("SUBSTRING"):
            self.i += 1
            self.eat_op("(")
            e = self.expr()
            if not self.try_kw("FROM"):
                self.eat_op(",")
            start = self.expr()
            length = None
            if self.try_kw("FOR") or self.try_op(","):
                length = self.expr()
            self.eat_op(")")
            if not isinstance(start, Num) or (
                    length is not None and not isinstance(length, Num)):
                raise NotImplementedError("non-constant substring bounds")
            return SubstringA(e, int(start.value),
                              int(length.value) if length else None)
        if self.kw("EXISTS"):
            self.i += 1
            self.eat_op("(")
            sub = self.select_stmt()
            self.eat_op(")")
            return Exists(sub)
        # LEFT/RIGHT are join keywords but also scalar functions when
        # immediately followed by an argument list
        if t == "kw" and v.upper() in ("LEFT", "RIGHT") and \
                self.peek(1) == ("op", "("):
            t = "id"
            self.toks[self.i] = ("id", v)
        if t == "id":
            name = self.ident()
            if self.try_op("("):           # function call
                if self.try_op("*"):
                    self.eat_op(")")
                    fn = Func(name.lower(), [], star=True)
                    if self.kw("OVER"):
                        return self._over_clause(fn)
                    return fn
                distinct = self.try_kw("DISTINCT")
                args = []
                if not self.try_op(")"):
                    args.append(self.expr())
                    while self.try_op(","):
                        args.append(self.expr())
                    self.eat_op(")")
                fn = Func(name.lower(), args, distinct=distinct)
                if self.kw("OVER"):
                    return self._over_clause(fn)
                return fn
            if self.try_op("."):
                col = self.ident()
                return Col(col, qualifier=name)
            return Col(name)
        raise SyntaxError(f"unexpected token {self.peek()}")


def parse_sql(sql: str) -> Select:
    return Parser(sql).parse()
