"""Resolved scalar/predicate expression IR with vectorized torch evaluation.

The IR classes are those of quickstep_tpu/expressions/scalar.py, unchanged: the
resolver types them and the optimizer rewrites them. Only `eval()` differs: it
runs torch ops over whole columns on the device the columns lie on.

Value model: every expression evaluates to (data: tensor over rows, valid) where
valid is None (all valid) or a bool tensor — SQL three-valued logic: predicates
produce (bool data, valid); a row passes WHERE iff data & valid. Literals
evaluate to 0-d tensors that broadcast against row tensors.

Strings never appear at runtime: the resolver lowers string comparisons to ordered
dictionary-code comparisons, LIKE/REGEXP/IN to dictionary bitmaps (DictBitmapProbe),
and SUBSTRING/case-changes to host-side dictionary remaps (see storage/dictionary.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from quickstep_tpu_torch.types import Type, TypeID, INT
from quickstep_tpu_torch.ops.kernels import to_device, torch_dtype

Array = object  # torch tensor
ValuePair = Tuple[Array, Optional[Array]]


class EvalContext:
    """Maps attribute ExprIds -> (data, valid) columns for the current operator
    input. `fetch` is the owning Chunk's materializer. `device` is where
    literals are built, so that they broadcast against the columns."""

    def __init__(self, slots: Dict[int, ValuePair], fetch=None, device="cpu"):
        self.slots = slots
        self.fetch = fetch
        self.device = torch.device(device)

    def lookup(self, expr_id: int) -> ValuePair:
        v = self.slots[expr_id]
        if getattr(v, "lazy", False):
            v = self.fetch(expr_id)
            self.slots[expr_id] = v
        return v


@dataclasses.dataclass
class Expr:
    """Base resolved expression. `type` is the SQL result type."""
    type: Type = dataclasses.field(default=INT, kw_only=True)

    def eval(self, ctx: EvalContext) -> ValuePair:
        raise NotImplementedError

    def children(self) -> List["Expr"]:
        return []

    def referenced_attrs(self) -> set:
        out = set()
        stack = [self]
        while stack:
            e = stack.pop()
            if isinstance(e, Attr):
                out.add(e.expr_id)
            stack.extend(e.children())
        return out

    def key(self) -> tuple:
        """Structural fingerprint for plan caching / common-subexpression detection."""
        return (type(self).__name__,) + tuple(
            c.key() for c in self.children())


@dataclasses.dataclass
class Attr(Expr):
    """Reference to a resolved attribute by global ExprId (the reference's
    AttributeReference, query_optimizer/expressions/AttributeReference.hpp)."""
    expr_id: int = -1
    name: str = ""

    def eval(self, ctx: EvalContext) -> ValuePair:
        return ctx.lookup(self.expr_id)

    def key(self) -> tuple:
        return ("attr", self.expr_id)


@dataclasses.dataclass
class Lit(Expr):
    value: object = None  # python scalar in device encoding; None = NULL literal

    def eval(self, ctx: EvalContext) -> ValuePair:
        dt = torch_dtype(self.type.device_dtype)
        if self.value is None:
            return (torch.zeros((), dtype=dt, device=ctx.device),
                    torch.zeros((), dtype=torch.bool, device=ctx.device))
        # torch.full passes the value to a fill kernel: no host-to-device
        # copy, so no synchronisation with the card
        return torch.full((), self.value, dtype=dt, device=ctx.device), None

    def key(self) -> tuple:
        d = getattr(self, "_dictionary", None)
        # dictionary-coded string literals: the code alone doesn't identify the
        # value — include the decoded string in the fingerprint
        if d is not None and isinstance(self.value, int) and \
                0 <= self.value < len(d.values):
            return ("lit", d.values[self.value], int(self.type.type_id))
        return ("lit", self.value, int(self.type.type_id), self.type.scale)


def _combine_valid(*valids):
    out = None
    for v in valids:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def _scalar_like(x: torch.Tensor, value) -> torch.Tensor:
    """A 0-d tensor of x's dtype and device."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


_ARITH = {
    "+": torch.add,
    "-": torch.sub,
    "*": torch.mul,
}


@dataclasses.dataclass
class Arith(Expr):
    """+ - * / % with SQL numeric promotion (BinaryOperation.hpp:298 analog)."""
    op: str = "+"
    lhs: Expr = None
    rhs: Expr = None

    def children(self):
        return [self.lhs, self.rhs]

    def eval(self, ctx: EvalContext) -> ValuePair:
        a, va = self.lhs.eval(ctx)
        b, vb = self.rhs.eval(ctx)
        dt = torch_dtype(self.type.device_dtype)
        a = a.to(dt)
        b = b.to(dt)
        if self.op == "/":
            safe_b = torch.where(b == 0, torch.ones_like(b), b)
            if self.type.is_integral:
                # SQL integer division truncates toward zero, through f64 as
                # the reference does; /0 yields NULL.
                q = torch.trunc(a.to(torch.float64) / safe_b.to(torch.float64))
                data = q.to(dt)
            else:
                data = a / safe_b
            vb = _combine_valid(vb, b != 0)
        elif self.op == "%":
            # C semantics (ArithmeticBinaryOperators.hpp:143 integer `%`
            # truncated toward zero, :154 std::fmod for floats).
            safe_b = torch.where(b == 0, torch.ones_like(b), b)
            rem = torch.fmod(a, safe_b)
            if not self.type.is_integral:
                # canonicalize fmod's -0.0 (negative operand, zero remainder)
                # to +0.0 as the reference corpus prints
                rem = torch.where(rem == 0, torch.zeros_like(rem), rem)
            data = torch.where(b == 0, torch.zeros_like(a), rem)
            vb = _combine_valid(vb, b != 0)
        else:
            data = _ARITH[self.op](a, b)
        return data, _combine_valid(va, vb)

    def key(self):
        return ("arith", self.op, self.lhs.key(), self.rhs.key())


_CMP = {
    "=": torch.eq,
    "<>": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}


@dataclasses.dataclass
class Cmp(Expr):
    """Comparison predicate (Comparison.hpp:503 analog). Operands are pre-unified by
    the resolver (string comparisons arrive as dictionary-code comparisons)."""
    op: str = "="
    lhs: Expr = None
    rhs: Expr = None

    def children(self):
        return [self.lhs, self.rhs]

    def eval(self, ctx: EvalContext) -> ValuePair:
        a, va = self.lhs.eval(ctx)
        b, vb = self.rhs.eval(ctx)
        if a.dtype != b.dtype:
            common = torch.promote_types(a.dtype, b.dtype)
            a = a.to(common)
            b = b.to(common)
        return _CMP[self.op](a, b), _combine_valid(va, vb)

    def key(self):
        return ("cmp", self.op, self.lhs.key(), self.rhs.key())


@dataclasses.dataclass
class Logical(Expr):
    """AND/OR with Kleene three-valued logic (ConjunctionPredicate analog)."""
    op: str = "AND"
    operands: List[Expr] = dataclasses.field(default_factory=list)

    def children(self):
        return self.operands

    def eval(self, ctx: EvalContext) -> ValuePair:
        datas, valids = [], []
        for o in self.operands:
            d, v = o.eval(ctx)
            datas.append(d)
            valids.append(v)
        if self.op == "AND":
            data = datas[0]
            for d in datas[1:]:
                data = data & d
            # AND is null only if no operand is definitively false and some is null
            if all(v is None for v in valids):
                return data, None
            any_false = torch.zeros_like(data)
            all_known = None
            for d, v in zip(datas, valids):
                if v is None:
                    any_false = any_false | ~d
                else:
                    any_false = any_false | (v & ~d)
                    all_known = v if all_known is None else (all_known & v)
            valid = any_false | (all_known if all_known is not None
                                 else torch.ones_like(data))
            return data, valid
        else:  # OR
            data = datas[0]
            for d in datas[1:]:
                data = data | d
            if all(v is None for v in valids):
                return data, None
            any_true = torch.zeros_like(data)
            all_known = None
            for d, v in zip(datas, valids):
                if v is None:
                    any_true = any_true | d
                else:
                    any_true = any_true | (v & d)
                    all_known = v if all_known is None else (all_known & v)
            valid = any_true | (all_known if all_known is not None
                                else torch.ones_like(data))
            return data, valid

    def key(self):
        return ("logical", self.op) + tuple(o.key() for o in self.operands)


@dataclasses.dataclass
class Not(Expr):
    operand: Expr = None

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        return ~d, v

    def key(self):
        return ("not", self.operand.key())


@dataclasses.dataclass
class IsNull(Expr):
    operand: Expr = None
    negated: bool = False

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        if v is None:
            res = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
        else:
            res = ~v
        if self.negated:
            res = ~res if v is not None else \
                torch.ones(d.shape, dtype=torch.bool, device=d.device)
        return res, None

    def key(self):
        return ("isnull", self.negated, self.operand.key())


@dataclasses.dataclass
class Case(Expr):
    """Searched CASE (ScalarCaseExpression analog). when_clauses: [(pred, result)]."""
    when_clauses: List[Tuple[Expr, Expr]] = dataclasses.field(default_factory=list)
    else_result: Optional[Expr] = None

    def children(self):
        out = []
        for c, r in self.when_clauses:
            out.extend([c, r])
        if self.else_result is not None:
            out.append(self.else_result)
        return out

    def eval(self, ctx: EvalContext) -> ValuePair:
        dt = torch_dtype(self.type.device_dtype)
        if self.else_result is not None:
            data, valid = self.else_result.eval(ctx)
            data = data.to(dt)
        else:
            data = torch.zeros((), dtype=dt, device=ctx.device)
            valid = torch.zeros((), dtype=torch.bool, device=ctx.device)
        # Build from last WHEN to first so earlier WHENs take precedence.
        for cond, res in reversed(self.when_clauses):
            cd, cv = cond.eval(ctx)
            rd, rv = res.eval(ctx)
            rd = rd.to(dt)
            take = cd if cv is None else (cd & cv)
            data, valid = _broadcast_where(take, rd, rv, data, valid)
        return data, valid

    def key(self):
        return ("case",) + tuple((c.key(), r.key()) for c, r in self.when_clauses) + \
            (self.else_result.key() if self.else_result else None,)


def _broadcast_where(cond, a, va, b, vb):
    cond = cond.to(torch.bool)
    data = torch.where(cond, a, b)
    if va is None and vb is None:
        return data, None
    one = torch.ones((), dtype=torch.bool, device=cond.device)
    va_ = va if va is not None else one
    vb_ = vb if vb is not None else one
    return data, torch.where(cond, va_, vb_)


@dataclasses.dataclass
class Cast(Expr):
    """Numeric/date casts (NumericCastOperation analog). Decimal casts
    rescale the integer units representation (types/types.py DECIMAL)."""
    operand: Expr = None

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        src, dst = self.operand.type, self.type
        if src.is_decimal or dst.is_decimal:
            return _decimal_cast(d, src, dst), v
        out = torch_dtype(self.type.device_dtype)
        if d.is_floating_point() and not out.is_floating_point:
            return float_to_int(d, out), v
        return d.to(out), v

    def key(self):
        return ("cast", int(self.type.type_id), self.type.scale,
                self.operand.key())


def _decimal_cast(d, src, dst):
    """Convert between decimal units and other numeric encodings. Integer
    rescales divide with truncation toward zero (C cast semantics)."""
    out = torch_dtype(dst.device_dtype)
    if src.is_decimal and dst.is_decimal:
        if dst.scale == src.scale:
            return d.to(out)
        if dst.scale > src.scale:
            return d.to(torch.int64) * (10 ** (dst.scale - src.scale))
        return torch.div(d.to(torch.int64), 10 ** (src.scale - dst.scale),
                         rounding_mode="trunc").to(out)
    if src.is_decimal:
        if dst.is_floating:
            return d.to(out) * torch.full((), 10.0 ** -src.scale, dtype=out,
                                          device=d.device)
        return torch.div(d.to(torch.int64), 10 ** src.scale,
                         rounding_mode="trunc").to(out)
    # numeric -> decimal
    if src.is_integral:
        return (d.to(torch.int64) * (10 ** dst.scale)).to(out)
    return float_to_int(torch.round(d.to(torch.float64) * (10.0 ** dst.scale)),
                        out)


# the largest double not above each integer dtype's maximum: 2^31 - 1 is a
# double, 2^63 - 1 is not (it rounds up to 2^63, out of range)
_LARGEST_DOUBLE = {torch.int32: float(2**31 - 1),
                   torch.int64: float(2**63 - 1024)}


def float_to_int(d, out):
    """Floats to the integer dtype `out` as XLA's convert (quickstep_tpu's
    astype) does on every backend: truncation toward zero, saturated at
    out's bounds (±inf too), NaN to 0. Tensor.to leaves an out-of-range
    value undefined (INT_MIN on an x86 CPU), so the value is clamped in
    float64 first and a value above the largest double not above the
    maximum becomes the maximum."""
    x = d.to(torch.float64)
    hi = _LARGEST_DOUBLE[out]
    conv = torch.nan_to_num(x, nan=0.0).clamp(float(torch.iinfo(out).min),
                                              hi).to(out)
    top = torch.full((), torch.iinfo(out).max, dtype=out, device=d.device)
    return torch.where(x > hi, top, conv)


@dataclasses.dataclass
class DecimalToDouble(Expr):
    """Decode a decimal (scaled-integer) expression to its DOUBLE value:
    units * 10^-scale. Inserted by the resolver wherever decimal semantics
    must leave the exact integer domain (division, mixed-type arithmetic,
    inexact literals) — everything else stays native int on device."""
    operand: Expr = None

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        s = self.operand.type.scale
        return d.to(torch.float64) * (10.0 ** -s), v

    def key(self):
        return ("dec2f", self.operand.type.scale, self.operand.key())


@dataclasses.dataclass
class ExtractDate(Expr):
    """EXTRACT(field FROM date/datetime) (DateExtractOperation analog).

    DATE packed encoding (y<<9|m<<5|d) makes year/month/day shifts; DATETIME (us since
    epoch) fields go through day-number arithmetic on device.
    """
    field: str = "year"
    operand: Expr = None

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        if self.operand.type.type_id == TypeID.DATE:
            if self.field == "year":
                return (d >> 9).to(torch.int32), v
            if self.field == "month":
                return ((d >> 5) & 0xF).to(torch.int32), v
            if self.field == "day":
                return (d & 0x1F).to(torch.int32), v
            raise ValueError(f"cannot EXTRACT {self.field} from DATE")
        # DATETIME: microseconds since epoch (floor division and modulo)
        us = d
        if self.field == "second":
            return ((us // 1_000_000) % 60).to(torch.int32), v
        if self.field == "minute":
            return ((us // 60_000_000) % 60).to(torch.int32), v
        if self.field == "hour":
            return ((us // 3_600_000_000) % 24).to(torch.int32), v
        days = (us // 86_400_000_000).to(torch.int64)
        year, month, day = _civil_from_days(days)
        if self.field == "year":
            return year.to(torch.int32), v
        if self.field == "month":
            return month.to(torch.int32), v
        if self.field == "day":
            return day.to(torch.int32), v
        raise ValueError(f"cannot EXTRACT {self.field}")

    def key(self):
        return ("extract", self.field, self.operand.key())


@dataclasses.dataclass
class InSet(Expr):
    """operand IN (small literal set) — unrolled equality OR (EqualsAnyConstant
    analog, utility/EqualsAnyConstant.hpp)."""
    operand: Expr = None
    values: Tuple = ()
    negated: bool = False

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        res = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
        for val in self.values:
            res = res | (d == _scalar_like(d, val))
        if self.negated:
            res = ~res
        return res, v

    def key(self):
        return ("inset", self.values, self.negated, self.operand.key())


@dataclasses.dataclass
class DictBitmapProbe(Expr):
    """String predicate evaluated on the ordered dictionary: `bitmap[code]`.

    LIKE / REGEXP / IN-over-strings become a host-computed bool bitmap over dictionary
    codes; on device the probe is a single gather (the analog of the reference
    evaluating comparisons directly on compressed codes,
    compression/CompressionDictionary.hpp:64).
    """
    operand: Expr = None
    bitmap: object = None  # np.ndarray[bool], len == dictionary size
    negated: bool = False

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        bm = to_device(np.asarray(self.bitmap), d.device)
        codes = torch.clamp(d, 0, bm.shape[0] - 1).to(torch.int64)
        res = bm[codes]
        if self.negated:
            res = ~res
        return res, v

    def key(self):
        bm = np.asarray(self.bitmap)
        return ("dictbitmap", hash(bm.tobytes()), self.negated, self.operand.key())


def _days_from_civil(y, m, d):
    """Howard Hinnant's branchless civil-date -> day-number (all int ops,
    floor division for negative years). Day 0 = 1970-01-01."""
    y = y - (m <= 2).to(y.dtype)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    doy = (153 * torch.where(m > 2, m - 3, m + 9) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _civil_from_days(z):
    """Inverse of _days_from_civil; returns (y, m, d)."""
    z = z + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return y + (m <= 2).to(y.dtype), m, d


def _device_days_in_month(y, m):
    lengths = to_device(np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30,
                                  31], dtype=np.int32), m.device)
    base = lengths[torch.clamp(m - 1, 0, 11).to(torch.int64)]
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    return torch.where((m == 2) & leap, _scalar_like(base, 29), base)


@dataclasses.dataclass
class DateArith(Expr):
    """DATE/DATETIME column ± a literal interval, evaluated on device
    (the reference's DateOperatorOverloads.hpp / vectorized
    ArithmeticBinaryOperators applied to Datetime/Date columns)."""
    op: str = "+"            # + | -
    operand: Expr = None     # DATE (packed int32 code) or DATETIME (int64 us)
    months: int = 0          # YEARMONTH_INTERVAL amount
    us: int = 0              # DATETIME_INTERVAL amount

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        sign = 1 if self.op == "+" else -1
        if self.operand.type.type_id == TypeID.DATETIME:
            return d + sign * self.us, v
        # DATE packed code (y<<9 | m<<5 | d)
        y = d >> 9
        m = (d >> 5) & 0xF
        dd = d & 0x1F
        if self.months:
            t = y * 12 + (m - 1) + sign * self.months
            ny = t // 12
            nm = t - ny * 12 + 1
            nd = torch.minimum(dd, _device_days_in_month(ny, nm).to(dd.dtype))
        else:
            days = sign * (self.us // 86_400_000_000)
            z = _days_from_civil(y, m, dd) + days
            ny, nm, nd = _civil_from_days(z)
        return ((ny << 9) | (nm << 5) | nd).to(d.dtype), v

    def key(self):
        return ("datearith", self.op, self.months, self.us, self.operand.key())


@dataclasses.dataclass
class DictMatrixProbe(Expr):
    """Two-column string predicate (e.g. `email LIKE pattern` where both sides
    are dictionary columns): a host-precomputed bool matrix over the two
    dictionaries, probed on device as a flat gather (the analog of the
    reference's per-row re2 matching, PatternMatchingComparison.cpp)."""
    lhs: Expr = None
    rhs: Expr = None
    matrix: object = None  # np.ndarray[bool] shape (|ldict|, |rdict|)
    negated: bool = False

    def children(self):
        return [self.lhs, self.rhs]

    def eval(self, ctx: EvalContext) -> ValuePair:
        ld, lv = self.lhs.eval(ctx)
        rd, rv = self.rhs.eval(ctx)
        mat = np.asarray(self.matrix)
        nrows, ncols = mat.shape
        m = to_device(mat.reshape(-1), ld.device)
        li = torch.clamp(ld, 0, nrows - 1).to(torch.int64)
        ri = torch.clamp(rd, 0, ncols - 1).to(torch.int64)
        res = m[li * ncols + ri]
        if self.negated:
            res = ~res
        return res, _combine_valid(lv, rv)

    def key(self):
        m = np.asarray(self.matrix)
        return ("dictmatrix", hash(m.tobytes()), self.negated,
                self.lhs.key(), self.rhs.key())


@dataclasses.dataclass
class Substr(Expr):
    """SUBSTRING lowered to a dictionary remap: codes pass through remap array
    (host-computed in the resolver via Dictionary.map_values)."""
    operand: Expr = None
    remap: object = None  # np.ndarray[int32] old code -> new code

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        rm = to_device(np.asarray(self.remap), d.device)
        codes = torch.clamp(d, 0, rm.shape[0] - 1).to(torch.int64)
        return rm[codes], v

    def key(self):
        rm = np.asarray(self.remap)
        return ("substr", hash(rm.tobytes()), self.operand.key())


TRUE_PRED = Lit(value=1, type=Type(TypeID.INT))


def make_and(preds: List[Expr]) -> Optional[Expr]:
    preds = [p for p in preds if p is not None]
    if not preds:
        return None
    if len(preds) == 1:
        return preds[0]
    return Logical(op="AND", operands=preds, type=INT)


def split_conjuncts(pred: Optional[Expr]) -> List[Expr]:
    if pred is None:
        return []
    if isinstance(pred, Logical) and pred.op == "AND":
        out = []
        for o in pred.operands:
            out.extend(split_conjuncts(o))
        return out
    return [pred]
