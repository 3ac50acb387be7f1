"""SQL scalar function kernel library.

The port's copy of bodo_tpu/sql/kernels.py: every SQL function lowers to
the hashable expression IR (plan/expr.py) exactly as in the JAX package,
so both planners build the same trees. Numeric and datetime functions
become elementwise arithmetic on the device; string functions become
host-dictionary transforms (DictMap/StrHostFn/StrConcat), so only int32
codes reach the device. Which of these nodes the port can evaluate is
said in plan/expr.py.

The registry maps a lower-cased SQL function name to a lowering callable
taking already-lowered argument expressions. Literal-valued parameters
(pad widths, regexp patterns, date-part names) must be literals in the
query text — they parameterize the host-side dictionary transform and
cannot be data-dependent.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from bodo_tpu_torch.plan.expr import (BinOp, Cast, CodeLUT, DateAdd,
                                      DateDiff, DateTrunc, DictMap, Expr,
                                      Lit, MaskNull, MathFn, StrConcat,
                                      StrHostFn, StrLen, StrPredicate, UnOp,
                                      Where)
from bodo_tpu_torch.table import dtypes as dt

MONTH_NAMES = ("Jan", "Feb", "Mar", "Apr", "May", "Jun",
               "Jul", "Aug", "Sep", "Oct", "Nov", "Dec")
DAY_NAMES = ("Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun")

_DATE_UNITS = {"year": "year", "yy": "year", "yyyy": "year", "y": "year",
               "quarter": "quarter", "q": "quarter", "qtr": "quarter",
               "month": "month", "mm": "month", "mon": "month",
               "week": "week", "wk": "week", "w": "week",
               "day": "day", "dd": "day", "d": "day",
               "hour": "hour", "hh": "hour",
               "minute": "minute", "mi": "minute",
               "second": "second", "ss": "second", "s": "second"}


def _lit(e: Expr, what: str):
    if not isinstance(e, Lit):
        raise NotImplementedError(f"{what} must be a literal")
    return e.value


def _lit_int(e: Expr, what: str) -> int:
    return int(_lit(e, what))


def _lit_str(e: Expr, what: str) -> str:
    v = _lit(e, what)
    if not isinstance(v, str):
        raise NotImplementedError(f"{what} must be a string literal")
    return v


def _unit(e: Expr) -> str:
    u = _lit_str(e, "date part").lower()
    if u not in _DATE_UNITS:
        raise NotImplementedError(f"date part {u!r}")
    return _DATE_UNITS[u]


def _dictmap(kind: str, params, x: Expr) -> Expr:
    return DictMap(kind, tuple(params), x)


def _nargs(args: List[Expr], lo: int, hi: int = None, name: str = "") -> None:
    hi = lo if hi is None else hi
    if not (lo <= len(args) <= hi):
        raise NotImplementedError(
            f"{name} expects {lo}{'' if hi == lo else f'-{hi}'} args, "
            f"got {len(args)}")


# ---------------------------------------------------------------------------
# lowering functions
# ---------------------------------------------------------------------------

def _concat(args: List[Expr]) -> Expr:
    parts = []
    for a in args:
        if isinstance(a, Lit):
            v = a.value
            parts.append(v if isinstance(v, str) else str(v))
        else:
            parts.append(a)
    return StrConcat(tuple(parts))


def _coalesce(args: List[Expr]) -> Expr:
    out = args[-1]
    for a in reversed(args[:-1]):
        out = Where(UnOp("notna", a), a, out)
    return out


def _fold(op: str, args: List[Expr]) -> Expr:
    out = args[0]
    for a in args[1:]:
        out = BinOp(op, out, a)
    return out


def _math(kind: str, n_params: int = 0):
    def lower(args: List[Expr]) -> Expr:
        _nargs(args, 1, 1 + n_params, kind)
        params = tuple(_lit_int(a, f"{kind} parameter") for a in args[1:])
        return MathFn(kind, params, args[0])
    return lower


def _strmap(kind: str, sig: str):
    """DictMap lowering; sig encodes param kinds after the string arg:
    'i' int literal, 's' str literal, '?s' optional str (default below)."""
    def lower(args: List[Expr]) -> Expr:
        want = len([c for c in sig if c in "is"])
        opt = sig.count("?")
        _nargs(args, 1 + want - opt, 1 + want, kind)
        params, i = [], 1
        for c in sig.replace("?", ""):
            if i < len(args):
                params.append(_lit_int(args[i], kind) if c == "i"
                              else _lit_str(args[i], kind))
            i += 1
        if kind in ("lpad", "rpad") and len(params) == 1:
            params.append(" ")
        return _dictmap(kind, params, args[0])
    return lower


def _trim(kind: str):
    def lower(args: List[Expr]) -> Expr:
        _nargs(args, 1, 2, kind)
        params = (_lit_str(args[1], "trim set"),) if len(args) > 1 else ()
        return _dictmap(kind, params, args[0])
    return lower


def _substr(args: List[Expr]) -> Expr:
    _nargs(args, 2, 3, "substr")
    start = _lit_int(args[1], "substr start")
    length = _lit_int(args[2], "substr length") if len(args) > 2 else None
    return _dictmap("substring", (start, length), args[0])


def _position(args: List[Expr]) -> Expr:
    # POSITION/CHARINDEX(needle, haystack) — note INSTR flips the order
    _nargs(args, 2, 2, "position")
    return StrHostFn("position", (_lit_str(args[0], "needle"),), args[1])


def _instr(args: List[Expr]) -> Expr:
    _nargs(args, 2, 2, "instr")
    return StrHostFn("position", (_lit_str(args[1], "needle"),), args[0])


def _log(args: List[Expr]) -> Expr:
    if len(args) == 1:          # LOG(x) = log10 (Snowflake: LOG(base, x))
        return MathFn("log10", (), args[0])
    base = _lit(args[0], "log base")
    if base == 10:
        return MathFn("log10", (), args[1])
    if base == 2:
        return MathFn("log2", (), args[1])
    return BinOp("/", MathFn("ln", (), args[1]),
                 Lit(float(__import__("math").log(base))))


def _nullif(args: List[Expr]) -> Expr:
    _nargs(args, 2, 2, "nullif")
    return MaskNull(BinOp("==", args[0], args[1]), args[0])


def _pos_int(e: Expr, name: str, lo: int = 1) -> int:
    """Literal int argument with a lower bound (Snowflake raises on
    position/occurrence < 1 rather than searching a negative slice)."""
    v = _lit_int(e, name)
    if v < lo:
        raise ValueError(f"{name} must be >= {lo}, got {v}")
    return v


def _re_flags(params: str) -> str:
    """Snowflake regexp parameter string -> inline-flag prefix ('i' case
    insensitive, 'c' sensitive, 's' dotall, 'm' multiline). When both
    'c' and 'i' appear, the LAST one wins (Snowflake rule)."""
    ci = ""
    for ch in params:
        if ch in "ci":
            ci = ch
    out = "i" if ci == "i" else ""
    if "s" in params:
        out += "s"
    if "m" in params:
        out += "m"
    return f"(?{out})" if out else ""


def _regexp_like(args: List[Expr]) -> Expr:
    _nargs(args, 2, 3, "regexp_like")
    pat = _lit_str(args[1], "pattern")
    if len(args) > 2:
        pat = _re_flags(_lit_str(args[2], "parameters")) + pat
    return StrPredicate("fullmatch", (pat,), args[0])


def _regexp_substr(args: List[Expr]) -> Expr:
    # REGEXP_SUBSTR(s, pat[, position[, occurrence[, params[, group]]]])
    _nargs(args, 2, 6, "regexp_substr")
    pat = _lit_str(args[1], "pattern")
    pos = _pos_int(args[2], "position") if len(args) > 2 else 1
    occ = _pos_int(args[3], "occurrence") if len(args) > 3 else 1
    if len(args) > 4:
        pat = _re_flags(_lit_str(args[4], "parameters")) + pat
    grp = _pos_int(args[5], "group", lo=0) if len(args) > 5 else 0
    return _dictmap("regexp_substr", (pat, pos, occ, grp), args[0])


def _regexp_instr(args: List[Expr]) -> Expr:
    # REGEXP_INSTR(s, pat[, position[, occurrence[, option[, params]]]])
    _nargs(args, 2, 6, "regexp_instr")
    pat = _lit_str(args[1], "pattern")
    pos = _pos_int(args[2], "position") if len(args) > 2 else 1
    occ = _pos_int(args[3], "occurrence") if len(args) > 3 else 1
    opt = _lit_int(args[4], "option") if len(args) > 4 else 0
    if len(args) > 5:
        pat = _re_flags(_lit_str(args[5], "parameters")) + pat
    return StrHostFn("regexp_instr", (pat, pos, occ, opt), args[0])


def _regexp_count2(args: List[Expr]) -> Expr:
    _nargs(args, 2, 4, "regexp_count")
    pat = _lit_str(args[1], "pattern")
    pos = _pos_int(args[2], "position") if len(args) > 2 else 1
    if len(args) > 3:
        pat = _re_flags(_lit_str(args[3], "parameters")) + pat
    return StrHostFn("regexp_count", (pat, pos), args[0])


def _json_extract(args: List[Expr]) -> Expr:
    _nargs(args, 2, 2, "json_extract_path_text")
    return _dictmap("json_extract", (_lit_str(args[1], "path"),), args[0])


def _parse_json(args: List[Expr]) -> Expr:
    _nargs(args, 1, 1, "parse_json")
    return _dictmap("json_canon", (), args[0])


def _strtok(args: List[Expr]) -> Expr:
    _nargs(args, 1, 3, "strtok")
    delim = _lit_str(args[1], "delimiters") if len(args) > 1 else " "
    part = _lit_int(args[2], "part") if len(args) > 2 else 1
    return _dictmap("strtok", (delim, part), args[0])


def _insert_fn(args: List[Expr]) -> Expr:
    _nargs(args, 4, 4, "insert")
    return _dictmap("insert",
                    (_lit_int(args[1], "pos"), _lit_int(args[2], "len"),
                     _lit_str(args[3], "repl")), args[0])


def _editdistance(args: List[Expr]) -> Expr:
    _nargs(args, 2, 3, "editdistance")
    params = (_lit_str(args[1], "other"),)
    if len(args) > 2:
        params += (_lit_int(args[2], "max"),)
    return StrHostFn("editdistance", params, args[0])


def _to_char(args: List[Expr]) -> Expr:
    from bodo_tpu_torch.plan.expr import ToChar
    _nargs(args, 1, 2, "to_char")
    fmt = _lit_str(args[1], "format") if len(args) > 1 else None
    return ToChar(fmt, args[0])


def _space(args: List[Expr]) -> Expr:
    _nargs(args, 1, 1, "space")
    return Lit(" " * _lit_int(args[0], "space count"))


def _char_fn(args: List[Expr]) -> Expr:
    _nargs(args, 1, 1, "char")
    return Lit(chr(_lit_int(args[0], "char code")))


def _monthname(args: List[Expr]) -> Expr:
    from bodo_tpu_torch.plan.expr import DtField
    _nargs(args, 1, 1, "monthname")
    return CodeLUT(MONTH_NAMES, BinOp("-", DtField("month", args[0]), Lit(1)))


def _dayname(args: List[Expr]) -> Expr:
    from bodo_tpu_torch.plan.expr import DtField
    _nargs(args, 1, 1, "dayname")
    return CodeLUT(DAY_NAMES, DtField("dayofweek", args[0]))


def _dateadd(args: List[Expr]) -> Expr:
    _nargs(args, 3, 3, "dateadd")
    return DateAdd(_unit(args[0]), args[1], args[2])


def _datediff(args: List[Expr]) -> Expr:
    _nargs(args, 3, 3, "datediff")
    return DateDiff(_unit(args[0]), args[1], args[2])


def _date_trunc(args: List[Expr]) -> Expr:
    _nargs(args, 2, 2, "date_trunc")
    return DateTrunc(_unit(args[0]), args[1])


def _last_day(args: List[Expr]) -> Expr:
    # last day of month = (trunc(month, d) + 1 month) - 1 day
    _nargs(args, 1, 1, "last_day")
    return DateAdd("day", Lit(-1),
                   DateAdd("month", Lit(1), DateTrunc("month", args[0])))


def _to_number(args: List[Expr]) -> Expr:
    _nargs(args, 1, 1, "to_number")
    return StrHostFn("to_number", (), args[0])


def _to_date(args: List[Expr]) -> Expr:
    _nargs(args, 1, 1, "to_date")
    return StrHostFn("to_date", (), args[0])


def _sha2(args: List[Expr]) -> Expr:
    _nargs(args, 1, 2, "sha2")
    bits = _lit_int(args[1], "sha2 bits") if len(args) > 1 else 256
    return _dictmap("sha2", (bits,), args[0])


def _regexp_replace(args: List[Expr]) -> Expr:
    # REGEXP_REPLACE(s, pat[, repl[, position[, occurrence[, params]]]])
    _nargs(args, 2, 6, "regexp_replace")
    pat = _lit_str(args[1], "pattern")
    repl = _lit_str(args[2], "replacement") if len(args) > 2 else ""
    pos = _pos_int(args[3], "position") if len(args) > 3 else 1
    occ = _pos_int(args[4], "occurrence", lo=0) if len(args) > 4 else 0
    if len(args) > 5:
        pat = _re_flags(_lit_str(args[5], "parameters")) + pat
    return _dictmap("regexp_replace", (pat, repl, pos, occ), args[0])


REGISTRY: Dict[str, Callable[[List[Expr]], Expr]] = {
    # ---- string (reference: bodosql/kernels/string_array_kernels.py) ----
    "length": lambda a: StrLen(a[0]),
    "len": lambda a: StrLen(a[0]),
    "char_length": lambda a: StrLen(a[0]),
    "character_length": lambda a: StrLen(a[0]),
    "trim": _trim("strip"),
    "ltrim": _trim("lstrip"),
    "rtrim": _trim("rstrip"),
    "replace": _strmap("replace", "ss"),
    "lpad": _strmap("lpad", "i?s"),
    "rpad": _strmap("rpad", "i?s"),
    "left": _strmap("left", "i"),
    "right": _strmap("right", "i"),
    "reverse": _strmap("reverse", ""),
    "repeat": _strmap("repeat", "i"),
    "split_part": _strmap("split_part", "si"),
    "initcap": _strmap("initcap", ""),
    "translate": _strmap("translate", "ss"),
    "substr": _substr,
    "concat": _concat,
    "concat_ws": None,  # filled below (needs separator weaving)
    "position": _position,
    "charindex": _position,
    "instr": _instr,
    "ascii": lambda a: StrHostFn("ascii", (), a[0]),
    "startswith": lambda a: StrPredicate(
        "startswith", (_lit_str(a[1], "prefix"),), a[0]),
    "endswith": lambda a: StrPredicate(
        "endswith", (_lit_str(a[1], "suffix"),), a[0]),
    "contains": lambda a: StrPredicate(
        "contains", (_lit_str(a[1], "needle"),), a[0]),
    # ---- regexp (reference: bodosql/kernels/regexp_array_kernels.py) ----
    "regexp_like": _regexp_like,
    "rlike": _regexp_like,
    "regexp_replace": _regexp_replace,
    "regexp_substr": _regexp_substr,
    # Spark/Hive signature: REGEXP_EXTRACT(s, pat, group) — arg 3 is a
    # capture-GROUP index (default 1), not Snowflake's position
    "regexp_extract": lambda a: _dictmap(
        "regexp_substr",
        (_lit_str(a[1], "pattern"), 1, 1,
         _lit_int(a[2], "group") if len(a) > 2 else 1), a[0]),
    "regexp_count": _regexp_count2,
    "regexp_instr": _regexp_instr,
    # ---- json / variant (reference: bodosql/kernels/
    # json_array_kernels.py, variant_array_kernels.py) -----------------
    "json_extract_path_text": _json_extract,
    "get_json_object": _json_extract,
    "parse_json": _parse_json,
    "try_parse_json": _parse_json,
    "to_json": _parse_json,
    # CHECK_JSON: NULL for VALID json, parse-error text for invalid
    "check_json": lambda a: _dictmap("check_json", (), a[0]),
    # ---- casting (reference: bodosql/kernels/casting_array_kernels.py) --
    "to_char": _to_char, "to_varchar": _to_char,
    # ---- string breadth --------------------------------------------------
    "strtok": _strtok,
    "insert": _insert_fn,
    "editdistance": _editdistance,
    "space": _space,
    "char": _char_fn, "chr": _char_fn,
    # ---- crypto (reference: bodosql/kernels/crypto_funcs.py) ----
    "md5": _strmap("md5", ""),
    "md5_hex": _strmap("md5", ""),
    "sha1": _strmap("sha1", ""),
    "sha2": _sha2,
    # ---- numeric (reference: bodosql/kernels/numeric_array_kernels.py) --
    "ceil": _math("ceil"), "ceiling": _math("ceil"),
    "floor": _math("floor"),
    "round": _math("round", 1),
    "trunc": _math("trunc", 1), "truncate": _math("trunc", 1),
    "sqrt": _math("sqrt"), "exp": _math("exp"),
    "ln": _math("ln"), "log": _log,
    "sign": _math("sign"),
    "sin": _math("sin"), "cos": _math("cos"), "tan": _math("tan"),
    "asin": _math("asin"), "acos": _math("acos"), "atan": _math("atan"),
    "degrees": _math("degrees"), "radians": _math("radians"),
    "pow": lambda a: BinOp("**", a[0], a[1]),
    "power": lambda a: BinOp("**", a[0], a[1]),
    "mod": lambda a: BinOp("%", a[0], a[1]),
    "square": lambda a: BinOp("*", a[0], a[0]),
    "to_number": _to_number, "try_to_number": _to_number,
    # ---- conditional (reference: bodosql/kernels/cond_fns.py) -----------
    "iff": lambda a: Where(a[0], a[1], a[2]),
    "if": lambda a: Where(a[0], a[1], a[2]),
    "nullif": _nullif,
    "nvl": _coalesce, "ifnull": _coalesce,
    "nvl2": lambda a: Where(UnOp("notna", a[0]), a[1], a[2]),
    "zeroifnull": lambda a: Where(UnOp("isna", a[0]), Lit(0), a[0]),
    "greatest": lambda a: _fold("max2", a),
    "least": lambda a: _fold("min2", a),
    # ---- datetime (reference: bodosql/kernels/datetime_array_kernels.py)
    "date_trunc": _date_trunc,
    "dateadd": _dateadd, "timestampadd": _dateadd,
    "datediff": _datediff, "timestampdiff": _datediff,
    "last_day": _last_day,
    "monthname": _monthname, "dayname": _dayname,
    "week": None, "weekofyear": None,  # DtField — handled by planner
    "to_date": _to_date, "try_to_date": _to_date,
    # ---- semi-structured (reference: bodosql/kernels/
    # semistructured_array_kernels.py) --------------------------------
    "array_size": None, "get": None, "get_path": None,  # filled below
}


def _array_size(args: List[Expr]) -> Expr:
    from bodo_tpu_torch.plan.expr import NestedFn
    _nargs(args, 1, 1, "array_size")
    return NestedFn("list_len", (), args[0])


def _get(args: List[Expr]) -> Expr:
    from bodo_tpu_torch.plan.expr import NestedFn
    _nargs(args, 2, 2, "get")
    v = _lit(args[1], "get key/index")
    if isinstance(v, str):
        return NestedFn("field", (v,), args[0])
    return NestedFn("list_get", (int(v),), args[0])


def _get_path(args: List[Expr]) -> Expr:
    from bodo_tpu_torch.plan.expr import NestedFn
    _nargs(args, 2, 2, "get_path")
    path = _lit_str(args[1], "path")
    parts = [p.strip("'\"") for p in
             path.replace("]", "").replace("[", ".").split(".") if p]
    if len(parts) != 1:
        # nested values hold scalars in this engine (one dict-encoding
        # level); a multi-part path would address nested-of-nested
        raise NotImplementedError(
            f"multi-part GET_PATH {path!r} (nested values are one "
            f"level deep)")
    part = parts[0]
    if part.lstrip("-").isdigit():
        return NestedFn("list_get", (int(part),), args[0])
    return NestedFn("field", (part,), args[0])


def _concat_ws(args: List[Expr]) -> Expr:
    sep = _lit_str(args[0], "separator")
    parts = []
    for i, a in enumerate(args[1:]):
        if i:
            parts.append(Lit(sep))
        parts.append(a)
    return _concat(parts)


REGISTRY["concat_ws"] = _concat_ws
REGISTRY["array_size"] = _array_size
REGISTRY["get"] = _get
REGISTRY["get_path"] = _get_path
REGISTRY = {k: v for k, v in REGISTRY.items() if v is not None}


def lower_func(name: str, args: List[Expr]) -> Expr:
    """Lower a scalar SQL function call; raises NotImplementedError for
    functions outside the library."""
    fn = REGISTRY.get(name)
    if fn is None:
        raise NotImplementedError(f"function {name}")
    return fn(args)


def is_scalar_func(name: str) -> bool:
    return name in REGISTRY
