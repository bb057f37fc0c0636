"""sqllogictest runner.

Reference analog: tests/sqllogictests/src/main.rs (custom Rust runner over
the standard sqllogictest format; suites under tests/sqllogictests/suites).
This runner consumes the same record format so behavioral specs can be
written once and replayed against the engine:

    statement ok
    CREATE TABLE t (a INT)

    statement error <regex>
    SELECT bad syntax

    query I            # column types: I=int, F=float, T=text, B=bool
    SELECT a FROM t ORDER BY a
    ----
    1
    2

``query`` result blocks compare whitespace-normalized cell text; a
``----`` terminated by a blank line. Directives supported: statement
ok/error, query <types> [sort], onlyif/skipif (ignored), halt, include.
"""

from __future__ import annotations

import math
import os
import re
from typing import List, Optional, Tuple

from ..errors import DatabendError, _err

SqlLogicError = _err("SqlLogicError", 1210)


def _fmt_cell(v) -> str:
    import datetime as _dt
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, _dt.datetime):
        # reference always renders 6-digit microseconds
        return v.strftime("%Y-%m-%d %H:%M:%S.%f")
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if v == int(v) and abs(v) < 1e15:
            return f"{v:.1f}"
        return f"{v:.4f}".rstrip("0").rstrip(".") if "." in f"{v:.4f}" else f"{v:.4f}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_fmt_cell(x) for x in v) + "]"
    if isinstance(v, dict):
        import json
        return json.dumps(v, separators=(",", ":"), ensure_ascii=False)
    if v == "":
        return "(empty)"  # standard sqllogictest empty-string rendering
    return str(v)


class _Record:
    def __init__(self, kind, arg, sql, expected, line):
        self.kind = kind          # statement | query | halt
        self.arg = arg            # "ok" | error-regex | type-string
        self.sql = sql
        self.expected = expected  # list of expected lines (query only)
        self.line = line


def _parse_records(text: str, path: str = "<text>") -> List[_Record]:
    lines = text.split("\n")
    records: List[_Record] = []
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        start_line = i + 1
        if line.startswith(("onlyif", "skipif")):
            # conditional on the engine the record targets (standard
            # sqllogictest): we are "databend", so `onlyif mysql` /
            # `onlyif todo` skip the NEXT record, `skipif mysql` runs it
            parts = line.split()
            target = parts[1].lower() if len(parts) > 1 else ""
            skip = (target != "databend") if parts[0] == "onlyif" \
                else (target == "databend")
            i += 1
            if skip:
                # consume the following record without emitting it
                while i < n and lines[i].strip() \
                        and lines[i].strip().startswith(("onlyif", "skipif")):
                    i += 1
                if i < n and lines[i].strip():
                    i += 1                       # directive line
                    while i < n and lines[i].strip():
                        i += 1                   # sql + ---- + expected
            continue
        if line == "halt":
            records.append(_Record("halt", None, None, None, start_line))
            i += 1
            continue
        if line.startswith("include"):
            records.append(_Record("include", line.split(None, 1)[1], None,
                                   None, start_line))
            i += 1
            continue
        if line.startswith("control"):
            # `control sortmode {rowsort|valuesort|nosort}` sets the
            # file-level default sort mode (standard sqllogictest; the
            # reference corpus uses it in query/cte + query/select)
            records.append(_Record("control", line.split(None, 1)[1], None,
                                   None, start_line))
            i += 1
            continue
        if line.startswith("statement"):
            arg = line[len("statement"):].strip()
            i += 1
            sql_lines = []
            while i < n and lines[i].strip() and not lines[i].startswith("----"):
                sql_lines.append(lines[i])
                i += 1
            records.append(_Record("statement", arg, "\n".join(sql_lines),
                                   None, start_line))
            continue
        if line.startswith("query"):
            arg = line[len("query"):].strip()
            i += 1
            sql_lines = []
            while i < n and lines[i].strip() != "----" and lines[i].strip():
                sql_lines.append(lines[i])
                i += 1
            expected = None
            if i < n and lines[i].strip() == "----":
                i += 1
                expected = []
                while i < n and lines[i].strip() != "":
                    expected.append(lines[i].rstrip())
                    i += 1
            records.append(_Record("query", arg, "\n".join(sql_lines),
                                   expected, start_line))
            continue
        raise SqlLogicError(f"{path}:{start_line}: unknown directive {line!r}")
    return records


def _rows_match_numeric(exp: List[str], got: List[str]) -> bool:
    """Cell-wise fallback compare: float cells match within tolerance
    (f32 engines legitimately differ in the last digits; the standard
    sqllogictest runners do typed float comparison too)."""
    if len(exp) != len(got):
        return False
    for e_row, g_row in zip(exp, got):
        ec, gc = e_row.split(" "), g_row.split(" ")
        if len(ec) != len(gc):
            return False
        for e, g in zip(ec, gc):
            if e == g:
                continue
            try:
                ef, gf = float(e), float(g)
            except ValueError:
                return False
            if math.isnan(ef) and math.isnan(gf):
                continue
            if not math.isclose(ef, gf, rel_tol=1e-3, abs_tol=1e-4):
                return False
    return True


def run_text(session, text: str, path: str = "<text>") -> int:
    """Run sqllogictest records against a SessionContext; returns the
    number of records executed. Raises SqlLogicError on first mismatch."""
    executed = 0
    default_sort = "nosort"
    for rec in _parse_records(text, path):
        if rec.kind == "halt":
            break
        if rec.kind == "control":
            parts = rec.arg.split()
            if parts and parts[0] == "sortmode" and len(parts) > 1:
                default_sort = parts[1]
            continue
        if rec.kind == "include":
            base = os.path.dirname(path) if path != "<text>" else "."
            executed += run_file(session, os.path.join(base, rec.arg))
            continue
        executed += 1
        if rec.kind == "statement":
            if rec.arg.startswith("error"):
                pattern = rec.arg[len("error"):].strip()
                try:
                    session.sql(rec.sql)
                except DatabendError as e:
                    if pattern and not re.search(pattern, str(e)):
                        raise SqlLogicError(
                            f"{path}:{rec.line}: error mismatch: "
                            f"expected /{pattern}/, got {e}")
                else:
                    raise SqlLogicError(
                        f"{path}:{rec.line}: expected an error, statement succeeded")
            else:
                try:
                    session.sql(rec.sql)
                except DatabendError as e:
                    raise SqlLogicError(f"{path}:{rec.line}: statement failed: {e}")
        elif rec.kind == "query":
            args = rec.arg.split()
            if "rowsort" in args or "sort" in args:
                mode = "rowsort"
            elif "valuesort" in args:
                mode = "valuesort"
            elif "nosort" in args:
                mode = "nosort"
            else:
                mode = default_sort
            try:
                res = session.sql(rec.sql)
            except DatabendError as e:
                raise SqlLogicError(f"{path}:{rec.line}: query failed: {e}")
            got = [" ".join(_fmt_cell(v) for v in row) for row in res.rows()]
            if mode == "rowsort":
                got = sorted(got)
            if rec.expected is None:
                continue
            exp = [e.strip() for e in rec.expected]
            if mode == "rowsort":
                exp = sorted(exp)
            elif mode == "valuesort":
                # order-insensitive across ALL cells (standard semantics)
                got = sorted(v for g in got for v in g.split())
                exp = sorted(v for e in exp for v in e.split())
            got_n = [re.sub(r"\s+", " ", g).strip() for g in got]
            exp_n = [re.sub(r"\s+", " ", e).strip() for e in exp]
            if got_n != exp_n and not _rows_match_numeric(exp_n, got_n):
                raise SqlLogicError(
                    f"{path}:{rec.line}: result mismatch\n"
                    f"  expected: {exp_n}\n  got:      {got_n}")
    return executed


def run_file(session, path: str) -> int:
    with open(path, "r", encoding="utf-8") as f:
        return run_text(session, f.read(), path)


def run_suite(session_factory, suite_dir: str) -> Tuple[int, List[str]]:
    """Run every .test file under a directory tree. Returns
    (records_executed, failures). Each file gets a fresh session."""
    executed = 0
    failures: List[str] = []
    for root, _, files in os.walk(suite_dir):
        for fn in sorted(files):
            if not fn.endswith(".test"):
                continue
            p = os.path.join(root, fn)
            try:
                executed += run_file(session_factory(), p)
            except DatabendError as e:
                failures.append(f"{p}: {e}")
    return executed, failures
