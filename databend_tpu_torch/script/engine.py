"""SQL scripting: LET / IF / WHILE / FOR / LOOP / RETURN.

Reference analog: src/query/script/src/{compiler,executor,ir}.rs (2,542 LoC)
— Databend compiles script blocks to an IR executed over query results.
Here the script is parsed into a statement tree whose embedded SQL is kept
as raw text spans; execution substitutes `:var` placeholders with literal
values and runs statements through the host SessionContext, so every
engine feature (vector search included) is scriptable.

Supported grammar (terminated by ';'):
    LET x := <expr>;                 LET rs RESULTSET := <query>;
    x := <expr>;
    IF <expr> THEN ... [ELSEIF <expr> THEN ...]* [ELSE ...] END IF;
    WHILE <expr> DO ... END WHILE;
    FOR i IN [REVERSE] <expr> TO <expr> DO ... END FOR;
    FOR row IN <rs|(query)> DO ... END FOR;   -- row.col readable as :row.col
    LOOP ... END LOOP;               BREAK; CONTINUE;
    RETURN [<expr>];                 RETURN TABLE(<query>);
    <any SQL statement>;
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from ..errors import DatabendError, _err
from ..sql.tokenizer import tokenize

ScriptError = _err("ScriptError", 1201)

MAX_STEPS = 100_000  # runaway-loop guard (statements executed)


# --------------------------------------------------------------------- parse
class _Tok:
    def __init__(self, text: str):
        self.text = text
        self.toks = [t for t in tokenize(text)]
        self.i = 0

    def peek(self, ahead=0):
        j = min(self.i + ahead, len(self.toks) - 1)
        return self.toks[j]

    def at(self, *words: str) -> bool:
        t = self.peek()
        return t.kind in ("IDENT", "KEYWORD") and t.text.upper() in words

    def accept(self, *words: str) -> bool:
        if self.at(*words):
            self.i += 1
            return True
        return False

    def expect(self, word: str):
        if not self.accept(word):
            t = self.peek()
            raise ScriptError(f"expected {word}, found {t.text!r}")

    def at_op(self, op: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.text == op

    def eof(self) -> bool:
        return self.peek().kind == "EOF"

    def span_until_semicolon(self) -> str:
        """Raw text from the current token to the next top-level ';'."""
        start = self.peek().pos
        depth = 0
        while not self.eof():
            t = self.peek()
            if t.kind == "OP":
                if t.text == "(":
                    depth += 1
                elif t.text == ")":
                    depth -= 1
                elif t.text == ";" and depth == 0:
                    end = t.pos
                    self.i += 1
                    return self.text[start:end].strip()
            self.i += 1
        return self.text[start:].strip()

    def expect_semicolon(self):
        if self.at_op(";"):
            self.i += 1
        elif not self.eof():
            t = self.peek()
            raise ScriptError(f"expected ';', found {t.text!r}")


def _parse_block(tk: _Tok, terminators: Tuple[str, ...]) -> List[tuple]:
    stmts: List[tuple] = []
    while not tk.eof():
        while tk.at_op(";"):
            tk.i += 1
        if tk.eof() or tk.at(*terminators):
            break
        stmts.append(_parse_stmt(tk))
    return stmts


def _parse_stmt(tk: _Tok) -> tuple:
    if tk.accept("LET"):
        name = tk.peek().text
        tk.i += 1
        is_rs = tk.accept("RESULTSET")
        if not (tk.at_op(":=") or tk.at_op("=")):
            raise ScriptError("expected := in LET")
        tk.i += 1
        body = tk.span_until_semicolon()
        return ("let", name.lower(), is_rs, body)
    if tk.accept("RETURN"):
        if tk.at_op(";"):
            tk.i += 1
            return ("return", None)
        if tk.at("TABLE"):
            tk.i += 1
            if not tk.at_op("("):
                raise ScriptError("expected ( after RETURN TABLE")
            body = tk.span_until_semicolon().strip()
            assert body.startswith("(")
            return ("return_table", body[1:body.rfind(")")])
        return ("return", tk.span_until_semicolon())
    if tk.accept("BREAK"):
        tk.expect_semicolon()
        return ("break",)
    if tk.accept("CONTINUE"):
        tk.expect_semicolon()
        return ("continue",)
    if tk.accept("IF"):
        branches = []
        cond = _span_until_kw(tk, ("THEN",))
        tk.expect("THEN")
        body = _parse_block(tk, ("ELSEIF", "ELSE", "END"))
        branches.append((cond, body))
        while tk.accept("ELSEIF"):
            c = _span_until_kw(tk, ("THEN",))
            tk.expect("THEN")
            branches.append((c, _parse_block(tk, ("ELSEIF", "ELSE", "END"))))
        else_body = None
        if tk.accept("ELSE"):
            else_body = _parse_block(tk, ("END",))
        tk.expect("END")
        tk.expect("IF")
        tk.expect_semicolon()
        return ("if", branches, else_body)
    if tk.accept("WHILE"):
        cond = _span_until_kw(tk, ("DO",))
        tk.expect("DO")
        body = _parse_block(tk, ("END",))
        tk.expect("END")
        tk.expect("WHILE")
        tk.expect_semicolon()
        return ("while", cond, body)
    if tk.accept("LOOP"):
        body = _parse_block(tk, ("END",))
        tk.expect("END")
        tk.expect("LOOP")
        tk.expect_semicolon()
        return ("loop", body)
    if tk.accept("FOR"):
        var = tk.peek().text.lower()
        tk.i += 1
        tk.expect("IN")
        reverse = tk.accept("REVERSE")
        span = _span_until_kw(tk, ("DO",))
        tk.expect("DO")
        body = _parse_block(tk, ("END",))
        tk.expect("END")
        tk.expect("FOR")
        tk.expect_semicolon()
        if re.search(r"\bTO\b", span, re.IGNORECASE) and not span.lstrip().startswith("("):
            lo, hi = re.split(r"\bTO\b", span, maxsplit=1, flags=re.IGNORECASE)
            return ("for_range", var, lo.strip(), hi.strip(), reverse, body)
        return ("for_rows", var, span.strip(), body)
    # assignment: ident := expr
    t = tk.peek()
    if t.kind in ("IDENT",) and tk.peek(1).kind == "OP" and tk.peek(1).text == ":=":
        name = t.text.lower()
        tk.i += 2
        return ("assign", name, tk.span_until_semicolon())
    # plain SQL statement
    return ("sql", tk.span_until_semicolon())


def _span_until_kw(tk: _Tok, words: Tuple[str, ...]) -> str:
    start = tk.peek().pos
    depth = 0
    while not tk.eof():
        t = tk.peek()
        if t.kind == "OP":
            depth += 1 if t.text == "(" else (-1 if t.text == ")" else 0)
        if depth == 0 and t.kind in ("IDENT", "KEYWORD") \
                and t.text.upper() in words:
            return tk.text[start:t.pos].strip()
        tk.i += 1
    raise ScriptError(f"expected {'/'.join(words)}")


# ----------------------------------------------------------------- execution
class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Return(Exception):
    def __init__(self, result):
        self.result = result


def _literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_literal(x) for x in v) + "]"
    return repr(v)


_VAR_RE = re.compile(r":([A-Za-z_][A-Za-z0-9_]*)(?:\.([A-Za-z_][A-Za-z0-9_]*))?")


class ScriptRunner:
    def __init__(self, session):
        self.session = session
        self.env: Dict[str, Any] = {}
        self.resultsets: Dict[str, Any] = {}
        self.steps = 0

    def substitute(self, sql: str) -> str:
        def repl(m):
            name, attr = m.group(1).lower(), m.group(2)
            if attr is not None:
                row = self.env.get(name)
                if not isinstance(row, dict) or attr.lower() not in row:
                    raise ScriptError(f"unknown variable :{name}.{attr}")
                return _literal(row[attr.lower()])
            if name not in self.env:
                raise ScriptError(f"unknown variable :{name}")
            v = self.env[name]
            if isinstance(v, dict):  # row variable: first column
                return _literal(next(iter(v.values())))
            return _literal(v)
        return _VAR_RE.sub(repl, sql)

    def eval_expr(self, expr: str):
        res = self.session.sql("SELECT " + self.substitute(expr))
        return res.scalar()

    def run_sql(self, sql: str):
        return self.session.sql(self.substitute(sql))

    def _tick(self):
        self.steps += 1
        if self.steps > MAX_STEPS:
            raise ScriptError(f"script exceeded {MAX_STEPS} steps")

    def exec_block(self, stmts: List[tuple]):
        for st in stmts:
            self._tick()
            op = st[0]
            if op == "let" or op == "assign":
                if op == "let" and st[2]:  # RESULTSET
                    self.resultsets[st[1]] = self.run_sql(st[3])
                else:
                    body = st[3] if op == "let" else st[2]
                    name = st[1]
                    if re.match(r"^\s*(SELECT|WITH)\b", body, re.IGNORECASE):
                        self.env[name] = self.run_sql(body).scalar()
                    else:
                        self.env[name] = self.eval_expr(body)
            elif op == "sql":
                self.run_sql(st[1])
            elif op == "return":
                if st[1] is None:
                    raise _Return(None)
                raise _Return(self.eval_expr(st[1]))
            elif op == "return_table":
                raise _Return(self.run_sql(st[1]))
            elif op == "break":
                raise _Break()
            elif op == "continue":
                raise _Continue()
            elif op == "if":
                done = False
                for cond, body in st[1]:
                    if _truthy(self.eval_expr(cond)):
                        self.exec_block(body)
                        done = True
                        break
                if not done and st[2] is not None:
                    self.exec_block(st[2])
            elif op == "while":
                while _truthy(self.eval_expr(st[1])):
                    self._tick()
                    try:
                        self.exec_block(st[2])
                    except _Break:
                        break
                    except _Continue:
                        continue
            elif op == "loop":
                while True:
                    self._tick()
                    try:
                        self.exec_block(st[1])
                    except _Break:
                        break
                    except _Continue:
                        continue
            elif op == "for_range":
                lo = int(self.eval_expr(st[2]))
                hi = int(self.eval_expr(st[3]))
                rng = range(hi, lo - 1, -1) if st[4] else range(lo, hi + 1)
                for v in rng:
                    self._tick()
                    self.env[st[1]] = v
                    try:
                        self.exec_block(st[5])
                    except _Break:
                        break
                    except _Continue:
                        continue
            elif op == "for_rows":
                src = st[2]
                if src.startswith("("):
                    src = src[1:src.rfind(")")]
                if src.lower() in self.resultsets:
                    res = self.resultsets[src.lower()]
                else:
                    res = self.run_sql(src)
                names = [n.lower() for n in res.column_names]
                for row in res.rows():
                    self._tick()
                    self.env[st[1]] = dict(zip(names, row))
                    try:
                        self.exec_block(st[3])
                    except _Break:
                        break
                    except _Continue:
                        continue
            else:  # pragma: no cover
                raise ScriptError(f"unknown script op {op!r}")


def _truthy(v) -> bool:
    return bool(v) and v is not None


def execute_script_block(session, text: str, env=None):
    """Run a script body; returns a QueryResult (reference executor.rs).
    ``env`` pre-seeds script variables (procedure arguments)."""
    from ..service.session import QueryResult
    from ..expression import Column, DataBlock, DataField
    from ..types import String

    tk = _Tok(text)
    # optional BEGIN ... END wrapper
    if tk.accept("BEGIN"):
        stmts = _parse_block(tk, ("END",))
        tk.expect("END")
    else:
        stmts = _parse_block(tk, ())
    runner = ScriptRunner(session)
    if env:
        runner.env.update({k.lower(): v for k, v in env.items()})
    result = None
    try:
        runner.exec_block(stmts)
    except _Return as r:
        result = r.result
    except (_Break, _Continue):
        raise ScriptError("BREAK/CONTINUE outside a loop")
    if result is None:
        block = DataBlock(["Result"], [Column.from_pylist([], String)], 0)
        return QueryResult(block, [DataField("Result", String)])
    if isinstance(result, QueryResult):
        return result
    from ..expression.evaluator import infer_literal_type
    dt = infer_literal_type(result)
    block = DataBlock(["Result"], [Column.from_pylist([result], dt)], 1)
    return QueryResult(block, [DataField("Result", dt)])
