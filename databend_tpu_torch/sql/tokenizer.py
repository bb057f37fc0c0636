"""SQL tokenizer.

Equivalent of the reference's logos-based tokenizer
(reference: src/query/ast/src/parser/token.rs) as a single compiled regex
scanner. Produces a flat token list the recursive-descent/Pratt parser
walks; every token keeps its source span for error messages.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List

from ..errors import SyntaxException

# Order matters: longest / most specific first.
_TOKEN_RE = re.compile(
    r"""
    (?P<WS>\s+)
  | (?P<LINE_COMMENT>--[^\n]*)
  | (?P<BLOCK_COMMENT>/\*.*?\*/)
  | (?P<FLOAT>(?:\d+\.\d*|\.\d+)(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<INT>\d+)
  | (?P<STRING>'(?:[^'\\]|\\.|'')*')
  | (?P<QUOTED_IDENT>"(?:[^"]|"")*"|`(?:[^`])*`)
  | (?P<PARAM>\$\d+|\?)
  | (?P<VAR>\$[A-Za-z_][A-Za-z0-9_]*)
  | (?P<ATREF>@~(?:/[A-Za-z0-9_./*?-]*)?|@%?[A-Za-z_][A-Za-z0-9_]*(?:/[A-Za-z0-9_./*?-]*)?)
  | (?P<IDENT>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<OP><=>|<>|!=|>=|<=|==|\|\|/|\|/|\|\||<<|>>|->>|->|=>|::|:=|//|[-+*/%(),.;=<>\[\]{}:@^~&|!#])
    """,
    re.X | re.S,
)

KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "OFFSET", "ASC", "DESC", "NULLS", "FIRST", "LAST", "AS", "AND", "OR",
    "NOT", "XOR", "IN", "IS", "NULL", "TRUE", "FALSE", "BETWEEN", "LIKE",
    "ILIKE", "REGEXP", "RLIKE", "EXISTS", "ALL", "ANY", "SOME", "DISTINCT",
    "CASE", "WHEN", "THEN", "ELSE", "END", "CAST", "TRY_CAST", "INTERVAL",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "ON",
    "USING", "UNION", "EXCEPT", "INTERSECT", "WITH", "RECURSIVE",
    "CREATE", "DROP", "ALTER", "TABLE", "DATABASE", "SCHEMA", "VIEW", "DIV",
    "INDEX", "VECTOR", "INVERTED", "NGRAM", "IF", "REPLACE", "RENAME",
    "INSERT", "INTO", "VALUES", "DELETE", "UPDATE", "SET", "TRUNCATE",
    "COPY", "SHOW", "TABLES", "DATABASES", "DESCRIBE", "DESC", "EXPLAIN",
    "ANALYZE", "USE", "OPTIMIZE", "VACUUM", "REFRESH", "SETTINGS",
    "CLUSTER", "PRIMARY", "KEY", "DEFAULT", "COMMENT", "ENGINE",
    "TO", "SYNC", "ASYNC", "COLUMN", "ADD", "MODIFY", "FUNCTION", "STAGE",
    "UNDROP", "FUSE", "SNAPSHOT", "AT", "STREAM", "TASK", "FLASHBACK",
}

NON_RESERVED = {
    # keywords usable as identifiers in most positions
    "COMMENT", "ENGINE", "CLUSTER", "KEY", "FIRST", "LAST", "TABLES",
    "DATABASES", "SETTINGS", "VECTOR", "INVERTED", "NGRAM", "SYNC", "ASYNC",
    "REFRESH", "ANALYZE", "VACUUM", "OPTIMIZE", "STAGE", "SNAPSHOT", "AT",
    "STREAM", "TASK", "COLUMN", "ADD", "MODIFY", "USE", "TO", "FUSE", "DEFAULT",
    "FLASHBACK", "TABLE", "DATABASE", "INDEX",
}


@dataclass
class Token:
    kind: str  # KEYWORD | IDENT | INT | FLOAT | STRING | OP | PARAM | ATREF | EOF
    text: str  # normalized text (keywords upper-cased, strings unquoted)
    pos: int   # byte offset in source

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.kind}:{self.text}"


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    n = len(sql)
    while pos < n:
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SyntaxException(f"unexpected character {sql[pos]!r} at offset {pos}")
        kind = m.lastgroup
        text = m.group()
        if kind in ("WS", "LINE_COMMENT", "BLOCK_COMMENT"):
            pos = m.end()
            continue
        if kind == "IDENT":
            up = text.upper()
            if up in KEYWORDS:
                tokens.append(Token("KEYWORD", up, pos))
            else:
                tokens.append(Token("IDENT", text, pos))
        elif kind == "STRING":
            body = text[1:-1].replace("''", "'")
            body = re.sub(r"\\(.)", lambda mm: {"n": "\n", "t": "\t", "r": "\r",
                                                "'": "'", '"': '"', "\\": "\\"}.get(mm.group(1), mm.group(0)), body)
            tokens.append(Token("STRING", body, pos))
        elif kind == "QUOTED_IDENT":
            q = text[0]
            body = text[1:-1]
            if q == '"':
                body = body.replace('""', '"')
            tokens.append(Token("IDENT", body, pos))
        else:
            tokens.append(Token(kind, text, pos))
        pos = m.end()
    tokens.append(Token("EOF", "", n))
    return tokens
