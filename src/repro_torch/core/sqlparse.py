"""Recursive-descent parser for the AISQL dialect (paper §3).

Supported surface:

    SELECT <items> FROM t [AS] a
      [JOIN t2 [AS] b ON <expr>]*
      [WHERE <expr>] [GROUP BY <cols>]
      [ORDER BY <expr> [ASC|DESC], ...] [LIMIT n]

with the AI operators AI_COMPLETE, AI_FILTER, AI_SCORE, AI_CLASSIFY,
AI_EMBED, AI_SIMILARITY, AI_AGG, AI_SUMMARIZE_AGG, the PROMPT(...)
object, FILE utilities
(FL_IS_IMAGE...), BETWEEN/IN/AND/OR/NOT, array literals ['a','b'] for
label sets, and an optional ``model => 'name'`` keyword argument on AI
calls.  ORDER BY accepts structured expressions and AI_SCORE(...) keys
(semantic ordering); LIMIT requires a non-negative integer literal.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Tuple

from repro_torch.core import expr as E


def _locate(source: str, pos: int) -> Tuple[int, int, str]:
    """``(lineno, col, line)`` for a 0-based character offset, clamped
    to the last line: an offset at end-of-source in a newline-terminated
    query (e.g. ``'SELECT a FROM\\n'``) lands one line past
    ``splitlines()``, so point just past the last line instead of
    indexing out of range."""
    lines = source.splitlines() or [""]
    prefix = source[:pos]
    lineno = prefix.count("\n") + 1
    col = pos - (prefix.rfind("\n") + 1)
    if lineno > len(lines):
        lineno = len(lines)
        col = len(lines[-1])
    line = lines[lineno - 1]
    return lineno, min(col, len(line)), line


class ParseError(SyntaxError):
    """Structured parse failure: message + source position + offending
    token.

    Kept a `SyntaxError` subclass for back-compat (every pre-existing
    ``except SyntaxError`` still works), but carries machine-readable
    fields the serving layer maps onto its HTTP 400 body:

      * ``pos``    — 0-based character offset into the source SQL
        (None when the failing construct has no single position);
      * ``token``  — the offending token text (or a description);
      * ``source`` — the full SQL text, for caret rendering.

    The standard `SyntaxError` ``(text, lineno, offset)`` triple is
    populated too, so interpreter tracebacks render the caret for free,
    and ``str()`` includes the `caret()` snippet — which is how
    ``explain`` output and error logs show *where* the query broke.
    """

    def __init__(self, message: str, *, pos: Optional[int] = None,
                 token: Optional[str] = None,
                 source: Optional[str] = None):
        self.message = message
        self.pos = pos
        self.token = token
        self.source = source
        if source is not None and pos is not None:
            lineno, col, line = _locate(source, pos)
            super().__init__(message, (None, lineno, col + 1, line))
        else:
            super().__init__(message)

    def caret(self) -> str:
        """Two-line snippet: the offending source line plus a ``^``
        under the failure position; empty when no position is known."""
        if self.source is None or self.pos is None:
            return ""
        _, col, line = _locate(self.source, self.pos)
        return f"{line}\n{' ' * col}^"

    def __str__(self) -> str:
        head = (self.message if self.pos is None
                else f"{self.message} (at position {self.pos})")
        snippet = self.caret()
        if not snippet:
            return head
        body = "\n".join(f"    {ln}" for ln in snippet.splitlines())
        return f"{head}\n{body}"


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<arrow>=>)
  | (?P<op><=|>=|!=|<>|[=<>+\-*/(),\[\].])
  | (?P<num>\d+(\.\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
""", re.VERBOSE)

_KEYWORDS = {
    "SELECT", "FROM", "JOIN", "ON", "WHERE", "GROUP", "BY", "LIMIT", "AS",
    "AND", "OR", "NOT", "BETWEEN", "IN", "INNER", "LEFT", "ORDER", "ASC",
    "DESC", "TRUE", "FALSE",
}


@dataclasses.dataclass
class Tok:
    kind: str      # op | num | str | ident | kw | arrow | eof
    value: str
    pos: int = -1  # 0-based character offset into the source SQL


def _lex(sql: str) -> List[Tok]:
    out: List[Tok] = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise ParseError(f"cannot tokenize at: {sql[i:i+30]!r}",
                             pos=i, token=sql[i:i + 1], source=sql)
        start = m.start()
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        v = m.group()
        if kind == "ident" and v.upper() in _KEYWORDS:
            out.append(Tok("kw", v.upper(), start))
        else:
            out.append(Tok(kind, v, start))
    out.append(Tok("eof", "", len(sql)))
    return out


@dataclasses.dataclass
class TableRef:
    table: str
    alias: str


@dataclasses.dataclass
class JoinClause:
    ref: TableRef
    on: E.Expr


@dataclasses.dataclass
class OrderItem:
    """One ORDER BY key: an expression plus sort direction."""
    expr: E.Expr
    desc: bool = False


@dataclasses.dataclass
class Query:
    select: List[E.SelectItem]
    table: TableRef
    joins: List[JoinClause]
    where: Optional[E.Expr]
    group_by: List[str]
    limit: Optional[int]
    order_by: List[OrderItem] = dataclasses.field(default_factory=list)


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = _lex(sql)
        self.i = 0

    # ---- token helpers ----
    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def error(self, message: str, tok: Optional[Tok] = None) -> ParseError:
        """A `ParseError` anchored at ``tok`` (default: the lookahead)."""
        tok = tok or self.peek()
        return ParseError(message,
                          pos=tok.pos if tok.pos >= 0 else None,
                          token=tok.value or tok.kind, source=self.sql)

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Tok]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Tok:
        t = self.accept(kind, value)
        if t is None:
            raise self.error(f"expected {value or kind}, got "
                             f"{self.peek().kind}:{self.peek().value!r}")
        return t

    # ---- grammar ----
    def parse(self) -> Query:
        self.expect("kw", "SELECT")
        items = [self.select_item()]
        while self.accept("op", ","):
            items.append(self.select_item())
        self.expect("kw", "FROM")
        table = self.table_ref()
        joins = []
        while True:
            if self.accept("kw", "INNER"):
                self.expect("kw", "JOIN")
            elif not self.accept("kw", "JOIN"):
                break
            ref = self.table_ref()
            self.expect("kw", "ON")
            joins.append(JoinClause(ref, self.expr()))
        where = None
        if self.accept("kw", "WHERE"):
            where = self.expr()
        group_by: List[str] = []
        if self.accept("kw", "GROUP"):
            self.expect("kw", "BY")
            group_by.append(self.qualified_name())
            while self.accept("op", ","):
                group_by.append(self.qualified_name())
        order_by: List[OrderItem] = []
        if self.accept("kw", "ORDER"):
            self.expect("kw", "BY")
            order_by.append(self.order_item())
            while self.accept("op", ","):
                order_by.append(self.order_item())
        limit = None
        if self.accept("kw", "LIMIT"):
            tok = self.expect("num")
            if "." in tok.value:
                raise self.error(
                    f"LIMIT must be an integer, got {tok.value}", tok)
            limit = int(tok.value)
        self.expect("eof")
        return Query(items, table, joins, where, group_by, limit, order_by)

    def order_item(self) -> OrderItem:
        t = self.peek()
        if t.kind in ("eof",) or (t.kind == "op" and t.value == ","):
            raise self.error("ORDER BY requires an expression", t)
        ex = self.expr()
        desc = False
        if self.accept("kw", "DESC"):
            desc = True
        else:
            self.accept("kw", "ASC")
        return OrderItem(ex, desc)

    def select_item(self) -> E.SelectItem:
        if self.accept("op", "*"):
            return E.SelectItem(E.Star())
        ex = self.expr()
        alias = None
        if self.accept("kw", "AS"):
            alias = self.expect("ident").value
        elif self.peek().kind == "ident":
            alias = self.next().value
        return E.SelectItem(ex, alias)

    def table_ref(self) -> TableRef:
        name = self.expect("ident").value
        alias = name
        if self.accept("kw", "AS"):
            alias = self.expect("ident").value
        elif self.peek().kind == "ident":
            alias = self.next().value
        return TableRef(name, alias)

    def qualified_name(self) -> str:
        name = self.expect("ident").value
        while self.accept("op", "."):
            name += "." + self.expect("ident").value
        return name

    # expressions (precedence: OR < AND < NOT < cmp < add < mul < atom)
    def expr(self) -> E.Expr:
        return self.or_expr()

    def or_expr(self) -> E.Expr:
        parts = [self.and_expr()]
        while self.accept("kw", "OR"):
            parts.append(self.and_expr())
        return parts[0] if len(parts) == 1 else E.BoolOp("or", tuple(parts))

    def and_expr(self) -> E.Expr:
        parts = [self.not_expr()]
        while self.accept("kw", "AND"):
            parts.append(self.not_expr())
        return parts[0] if len(parts) == 1 else E.BoolOp("and", tuple(parts))

    def not_expr(self) -> E.Expr:
        if self.accept("kw", "NOT"):
            return E.Not(self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self) -> E.Expr:
        left = self.add_expr()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = "!=" if t.value == "<>" else t.value
            return E.BinOp(op, left, self.add_expr())
        if t.kind == "kw" and t.value == "BETWEEN":
            self.next()
            lo = self.add_expr()
            self.expect("kw", "AND")
            hi = self.add_expr()
            return E.Between(left, lo, hi)
        if t.kind == "kw" and t.value == "IN":
            self.next()
            self.expect("op", "(")
            vals = [self.literal_value()]
            while self.accept("op", ","):
                vals.append(self.literal_value())
            self.expect("op", ")")
            return E.InList(left, tuple(vals))
        return left

    def add_expr(self) -> E.Expr:
        left = self.mul_expr()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                left = E.BinOp(t.value, left, self.mul_expr())
            else:
                return left

    def mul_expr(self) -> E.Expr:
        left = self.atom()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/"):
                self.next()
                left = E.BinOp(t.value, left, self.atom())
            else:
                return left

    def literal_value(self) -> Any:
        t = self.next()
        if t.kind == "num":
            return float(t.value) if "." in t.value else int(t.value)
        if t.kind == "str":
            return t.value[1:-1].replace("''", "'")
        if t.kind == "kw" and t.value in ("TRUE", "FALSE"):
            return t.value == "TRUE"
        raise self.error(f"expected literal, got {t.value!r}", t)

    def atom(self) -> E.Expr:
        t = self.peek()
        if t.kind == "op" and t.value == "(":
            self.next()
            ex = self.expr()
            self.expect("op", ")")
            return ex
        if t.kind == "num":
            self.next()
            return E.Literal(float(t.value) if "." in t.value else int(t.value))
        if t.kind == "str":
            self.next()
            return E.Literal(t.value[1:-1].replace("''", "'"))
        if t.kind == "kw" and t.value in ("TRUE", "FALSE"):
            self.next()
            return E.Literal(t.value == "TRUE")
        if t.kind == "op" and t.value == "[":
            return E.Literal(self.array_literal())
        if t.kind == "ident":
            name = self.next().value
            if self.peek().kind == "op" and self.peek().value == "(":
                return self.call(name, t)
            full = name
            while self.accept("op", "."):
                full += "." + self.expect("ident").value
            return E.Column(full)
        if t.kind == "op" and t.value == "*":
            self.next()
            return E.Star()
        raise self.error(f"unexpected token {t.value!r}", t)

    def array_literal(self) -> Tuple[str, ...]:
        self.expect("op", "[")
        vals = [self.literal_value()]
        while self.accept("op", ","):
            vals.append(self.literal_value())
        self.expect("op", "]")
        return tuple(str(v) for v in vals)

    # ---- calls ----
    def call(self, name: str, tok: Optional[Tok] = None) -> E.Expr:
        uname = name.upper()
        self.expect("op", "(")
        if uname == "COUNT" and self.accept("op", "*"):
            self.expect("op", ")")
            return E.AggCall("COUNT", (E.Star(),))
        args: List[E.Expr] = []
        kwargs = {}
        if not (self.peek().kind == "op" and self.peek().value == ")"):
            while True:
                if (self.peek().kind == "ident"
                        and self.toks[self.i + 1].kind == "arrow"):
                    kw = self.next().value.lower()
                    self.next()  # =>
                    kwargs[kw] = self.literal_value()
                else:
                    args.append(self.expr())
                if not self.accept("op", ","):
                    break
        self.expect("op", ")")
        return self.build_call(uname, args, kwargs, tok)

    def build_call(self, uname, args, kwargs,
                   tok: Optional[Tok] = None) -> E.Expr:
        model = kwargs.get("model")
        if uname == "PROMPT":
            tpl = self._lit_str(args[0], "PROMPT template", tok)
            return E.Prompt(tpl, tuple(args[1:]))
        if uname == "AI_FILTER":
            p = args[0]
            if not isinstance(p, E.Prompt):
                if isinstance(p, E.Literal):
                    p = E.Prompt(str(p.value), tuple(args[1:]))
                else:
                    p = E.Prompt("{0}", (p,))
            return E.AIFilter(p, model=model)
        if uname == "AI_SCORE":
            p = args[0]
            if not isinstance(p, E.Prompt):
                if isinstance(p, E.Literal):
                    p = E.Prompt(str(p.value), tuple(args[1:]))
                else:
                    p = E.Prompt("{0}", (p,))
            return E.AIScore(p, model=model)
        if uname == "AI_EMBED":
            if len(args) != 1:
                raise self.error("AI_EMBED takes exactly one argument", tok)
            return E.AIEmbed(args[0], model=model)
        if uname == "AI_SIMILARITY":
            if len(args) != 2:
                raise self.error("AI_SIMILARITY takes exactly two "
                                 "arguments", tok)
            return E.AISimilarity(args[0], args[1], model=model)
        if uname == "AI_CLASSIFY":
            text = args[0]
            if not isinstance(text, E.Prompt):
                text = (E.Prompt(str(text.value), ())
                        if isinstance(text, E.Literal)
                        else E.Prompt("{0}", (text,)))
            labels: Tuple[str, ...] = ()
            labels_expr = None
            if len(args) > 1:
                second = args[1]
                if isinstance(second, E.Literal) and isinstance(second.value,
                                                                tuple):
                    labels = second.value
                else:
                    labels_expr = second
            return E.AIClassify(text, labels=labels, labels_expr=labels_expr,
                                multi_label=bool(kwargs.get("multi_label",
                                                            False)),
                                model=model)
        if uname == "AI_COMPLETE":
            p = args[0]
            if not isinstance(p, E.Prompt):
                p = (E.Prompt(str(p.value), tuple(args[1:]))
                     if isinstance(p, E.Literal) else E.Prompt("{0}", (p,)))
            return E.AIComplete(p, model=model,
                                max_tokens=int(kwargs.get("max_tokens", 48)))
        if uname == "AI_AGG":
            instr = (self._lit_str(args[1], "AI_AGG instruction", tok)
                     if len(args) > 1 else None)
            return E.AggCall("AI_AGG", (args[0],), instruction=instr)
        if uname == "AI_SUMMARIZE_AGG":
            return E.AggCall("AI_SUMMARIZE_AGG", (args[0],))
        if uname in ("COUNT", "SUM", "AVG", "MIN", "MAX"):
            return E.AggCall(uname, tuple(args))
        return E.FuncCall(uname, tuple(args))

    def _lit_str(self, e: E.Expr, what: str,
                 tok: Optional[Tok] = None) -> str:
        # A bare assert here disappears under ``python -O`` and lets a
        # non-literal template flow into execution; raise a real error.
        if not (isinstance(e, E.Literal) and isinstance(e.value, str)):
            raise self.error(f"{what} must be a string literal", tok)
        return e.value


def parse(sql: str) -> Query:
    return Parser(sql).parse()
