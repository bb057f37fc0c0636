"""Recursive-descent SQL parser with a Pratt expression parser.

Python re-design of the reference's nom + pratt parser
(reference: src/query/ast/src/parser/{statement,expr,query}.rs). The
grammar covers the warehouse surface the engine executes: DDL (databases,
tables, vector/inverted/ngram indexes), DML (INSERT/DELETE/UPDATE),
queries (joins, group by, set ops, CTEs, subqueries), SHOW/DESCRIBE/
EXPLAIN/SET, and the vector/search SQL functions come through as plain
function calls to be rewritten by the binder.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..errors import SyntaxException
from . import ast as A
from .tokenizer import NON_RESERVED, Token, tokenize

# Pratt binding powers for binary operators
_BIN_POWER = {
    "OR": 10, "XOR": 15, "AND": 20,
    "=": 40, "==": 40, "!=": 40, "<>": 40, "<": 40, "<=": 40, ">": 40,
    ">=": 40, "<=>": 40, "LIKE": 40, "ILIKE": 40, "REGEXP": 40, "RLIKE": 40,
    "||": 50, "|": 51, "#": 51, "&": 52,
    "<<": 58, ">>": 58,
    "->": 55, "->>": 55,
    "+": 60, "-": 60,
    "*": 70, "/": 70, "//": 70, "%": 70, "DIV": 70,
    "^": 80,
}


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.tokens = tokenize(sql)
        self.i = 0
        self.param_count = 0  # `?` placeholders seen (prepared statements)

    # ------------------------------------------------------------- primitives
    def peek(self, ahead: int = 0) -> Token:
        return self.tokens[min(self.i + ahead, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind == "EOF":
            # consuming past the end is always a malformed-input path;
            # returning EOF forever turns `while not at_op(')')` loops
            # into hangs (fuzz finding)
            raise SyntaxException(
                f"unexpected end of input (offset {t.pos})")
        self.i += 1
        return t

    def at_keyword(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "KEYWORD" and t.text in kws

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.text in ops

    def accept_keyword(self, *kws: str) -> Optional[str]:
        if self.at_keyword(*kws):
            return self.next().text
        return None

    def accept_op(self, *ops: str) -> Optional[str]:
        if self.at_op(*ops):
            return self.next().text
        return None

    def expect_keyword(self, kw: str) -> None:
        if not self.accept_keyword(kw):
            self.error(f"expected {kw}")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            self.error(f"expected {op!r}")

    def error(self, msg: str):
        t = self.peek()
        line = self.sql.count("\n", 0, t.pos) + 1
        raise SyntaxException(f"{msg}, found {t.kind} {t.text!r} at line {line} (offset {t.pos})")

    def ident(self) -> str:
        t = self.peek()
        if t.kind == "IDENT":
            return self.next().text
        if t.kind == "KEYWORD" and t.text in NON_RESERVED:
            return self.next().text
        self.error("expected identifier")

    def int_lit(self) -> int:
        """Consume an integer literal; malformed input is a syntax error,
        never a ValueError escaping to the caller (fuzz finding)."""
        t = self.peek()
        try:
            return int(self.next().text)
        except ValueError:
            raise SyntaxException(
                f"expected integer, found {t.kind} {t.text!r}"
                f" (offset {t.pos})")

    def qualified_name(self) -> Tuple[Optional[str], str]:
        first = self.ident()
        if self.accept_op("."):
            return first, self.ident()
        return None, first

    # ------------------------------------------------------------- statements
    def parse_statement(self) -> A.Statement:
        if self._at_word("SETTINGS") and self.peek(1).text == "(":
            # statement-scoped settings prefix (reference sqllogictests:
            # `settings(k=v) SELECT ...` applies for ONE statement)
            self.next()
            self.expect_op("(")
            prefix = {}
            while not self.at_op(")"):
                k = self.next().text
                self.expect_op("=")
                prefix[k.lower()] = self.next().text
                self.accept_op(",")
            self.expect_op(")")
            stmt = self.parse_statement()
            stmt.settings_prefix = prefix
            return stmt
        if self.at_keyword("EXPLAIN"):
            self.next()
            kind = "PLAN"
            if self.accept_keyword("ANALYZE"):
                kind = "ANALYZE"
            elif self._at_word("AST", "SYNTAX"):
                self.next()
                kind = "AST"
            elif self._at_word("RAW", "LOGICAL"):
                self.next()
                kind = "RAW"
            elif self._at_word("PIPELINE"):
                self.next()
                kind = "PIPELINE"
            elif self._at_word("PERF"):
                self.next()
                kind = "PERF"
            elif self._at_word("PLAN"):
                self.next()
            return A.ExplainStmt(self.parse_statement(), kind == "ANALYZE",
                                 kind)
        if self.at_keyword("SELECT", "WITH", "VALUES", "FROM") \
                or self.at_op("("):
            return A.QueryStmt(self.parse_query())
        if self.at_keyword("COMMENT"):
            # COMMENT ON TABLE t IS '...' (reference: comment statement)
            self.next()
            self.expect_keyword("ON")
            self.expect_keyword("TABLE")
            db, name = self.qualified_name()
            self.expect_keyword("IS")
            return A.SetTableComment(name, db, self.next().text)
        if self._at_word("UNSET") and self.peek(1).text.upper() == "VARIABLE":
            self.next()
            self.next()
            return A.UnsetVariable(self.ident())
        if self._at_word("UNSET") and self.peek(1).kind in ("IDENT",
                                                            "KEYWORD"):
            # UNSET <setting>: reset to the default (reference
            # unset_settings interpreter)
            self.next()
            return A.UnsetSetting(self.ident())
        if self.at_keyword("CREATE"):
            return self.parse_create()
        if self.at_keyword("DROP"):
            return self.parse_drop()
        if self.at_keyword("INSERT"):
            return self.parse_insert()
        if self.at_keyword("DELETE"):
            return self.parse_delete()
        if self.at_keyword("UPDATE"):
            return self.parse_update()
        if self.at_keyword("TRUNCATE"):
            self.next()
            self.accept_keyword("TABLE")
            db, name = self.qualified_name()
            return A.TruncateTable(name, db)
        if self.at_keyword("USE"):
            self.next()
            if self._at_word("WAREHOUSE"):
                self.next()
                return A.UseWarehouse(self.ident())
            return A.UseDatabase(self.ident())
        if self._at_word("PREPARE"):
            # PREPARE name FROM '<sql with ? placeholders>'
            self.next()
            name = self.ident()
            self.expect_keyword("FROM")
            t = self.next()
            if t.kind != "STRING":
                self.error("PREPARE expects a quoted SQL string")
            return A.PrepareStmt(name, t.text)
        if self._at_word("EXECUTE") \
                and self.peek(1).text.upper() not in ("IMMEDIATE", "TASK"):
            # EXECUTE name [USING (p1, ...)] — EXECUTE IMMEDIATE is the
            # script-block form handled before parsing
            self.next()
            name = self.ident()
            params: List[A.Expr] = []
            if self._at_word("USING") or self.at_keyword("USING") \
                    or self.at_op("("):
                if not self.at_op("("):
                    self.next()  # USING
                paren = self.accept_op("(")
                if not (paren and self.at_op(")")):
                    params.append(self.parse_expr())
                    while self.accept_op(","):
                        params.append(self.parse_expr())
                if paren:
                    self.expect_op(")")
            return A.ExecutePrepared(name, params)
        if self._at_word("DEALLOCATE"):
            self.next()
            if self._at_word("PREPARE"):
                self.next()
            return A.DeallocateStmt(self.ident())
        if self.at_keyword("SHOW"):
            return self.parse_show()
        if self.at_keyword("DESCRIBE") or self.at_keyword("DESC"):
            self.next()
            if self.accept_keyword("STAGE"):
                return A.DescStage(self.ident())
            if self._at_word("SEQUENCE"):
                self.next()
                return A.DescSequence(self.ident())
            if self._at_word("MASKING") and self.peek(1).text.upper() == "POLICY":
                self.next()
                self.next()
                return A.DescMaskingPolicy(self.ident())
            if self._at_word("NETWORK") and self.peek(1).text.upper() == "POLICY":
                self.next()
                self.next()
                return A.DescNetworkPolicy(self.ident())
            if self._at_word("CONNECTION"):
                self.next()
                return A.DescConnection(self.ident())
            if self._at_word("PASSWORD") and self.peek(1).text.upper() == "POLICY":
                self.next()
                self.next()
                return A.DescPasswordPolicy(self.ident())
            self.accept_keyword("TABLE")
            db, name = self.qualified_name()
            return A.DescribeTable(name, db)
        if self.at_keyword("SET"):
            return self.parse_set()
        if self.at_keyword("REFRESH"):
            return self.parse_refresh()
        if self.at_keyword("OPTIMIZE"):
            self.next()
            self.expect_keyword("TABLE")
            db, name = self.qualified_name()
            action = "COMPACT"
            if self.accept_keyword("ALL"):
                action = "ALL"
            elif self.peek().kind in ("IDENT", "KEYWORD") and self.peek().text.upper() in ("COMPACT", "PURGE", "RECLUSTER"):
                action = self.next().text.upper()
                if action == "RECLUSTER":
                    self._at_word("FINAL") and self.next()
            return A.OptimizeTable(name, db, action)
        if self.at_keyword("ANALYZE"):
            self.next()
            self.expect_keyword("TABLE")
            db, name = self.qualified_name()
            return A.AnalyzeTable(name, db)
        if self.at_keyword("VACUUM"):
            self.next()
            self.expect_keyword("TABLE")
            db, name = self.qualified_name()
            return A.VacuumTable(name, db)
        if self.at_keyword("ALTER"):
            return self.parse_alter()
        if self.at_keyword("COPY"):
            return self.parse_copy()
        if self._at_word("GRANT", "REVOKE"):
            return self.parse_grant_revoke()
        if self._at_word("EXECUTE"):
            self.next()
            self.expect_keyword("TASK")
            return A.ExecuteTask(self.ident())
        if self._at_word("MERGE"):
            return self.parse_merge()
        if self.at_keyword("UNDROP"):
            self.next()
            self.expect_keyword("TABLE")
            db, name = self.qualified_name()
            return A.UndropTable(name, db)
        if self._at_word("LIST") and self.peek(1).kind == "ATREF":
            self.next()
            ref = self.next().text
            pattern = None
            if self._at_word("PATTERN"):
                self.next()
                self.expect_op("=")
                pattern = self.next().text
            return A.ListStage(ref, pattern)
        if self._at_word("REMOVE") and self.peek(1).kind == "ATREF":
            self.next()
            ref = self.next().text
            pattern = None
            if self._at_word("PATTERN"):
                self.next()
                self.expect_op("=")
                pattern = self.next().text
            return A.RemoveStage(ref, pattern)
        if self.at_keyword("REPLACE") and self.peek(1).text.upper() == "INTO":
            self.next()
            self.next()
            db, name = self.qualified_name()
            columns: List[str] = []
            if self.at_op("(") :
                save = self.i
                self.next()
                try:
                    columns = [self.ident()]
                    while self.accept_op(","):
                        columns.append(self.ident())
                    self.expect_op(")")
                except SyntaxException:
                    self.i = save
                    columns = []
            self.expect_keyword("ON")
            self.expect_op("(")
            keys = [self.ident()]
            while self.accept_op(","):
                keys.append(self.ident())
            self.expect_op(")")
            if self.accept_keyword("VALUES"):
                rows = []
                while True:
                    self.expect_op("(")
                    row = [self.parse_expr()]
                    while self.accept_op(","):
                        row.append(self.parse_expr())
                    self.expect_op(")")
                    rows.append(row)
                    if not self.accept_op(","):
                        break
                return A.ReplaceInto(name, db, columns, keys, values=rows)
            return A.ReplaceInto(name, db, columns, keys,
                                 query=self.parse_query())
        if self._at_word("BEGIN"):
            self.next()
            self._at_word("TRANSACTION") and self.next()
            return A.BeginTxn()
        if self._at_word("START") and self.peek(1).text.upper() == "TRANSACTION":
            self.next()
            self.next()
            return A.BeginTxn()
        if self._at_word("COMMIT"):
            self.next()
            return A.CommitTxn()
        if self._at_word("ROLLBACK"):
            self.next()
            return A.RollbackTxn()
        if self._at_word("KILL"):
            self.next()
            target = "QUERY"
            if self._at_word("QUERY", "CONNECTION"):
                target = self.next().text.upper()
            t = self.next()
            if t.kind not in ("STRING", "IDENT", "INT"):
                self.error("KILL expects a query id")
            return A.KillStmt(target, t.text)
        if self._at_word("CALL"):
            self.next()
            self.accept_keyword("PROCEDURE")
            name = self.ident()
            args = []
            if self.accept_op("("):
                while not self.at_op(")"):
                    args.append(self.parse_expr())
                    self.accept_op(",")
                self.expect_op(")")
            return A.CallProcedure(name, args)
        if self._at_word("ATTACH"):
            self.next()
            self.expect_keyword("TABLE")
            db, name = self.qualified_name()
            if self.peek().kind != "STRING":
                self.error("ATTACH TABLE expects a location string")
            return A.AttachTable(name, db, self.next().text)
        if self._at_word("PRESIGN"):
            self.next()
            method = "DOWNLOAD"
            if self._at_word("DOWNLOAD", "UPLOAD"):
                method = self.next().text.upper()
            if self.peek().kind != "ATREF":
                self.error("PRESIGN expects @stage/file")
            ref = self.next().text
            expire = 3600
            if self._at_word("EXPIRE"):
                self.next()
                self.expect_op("=")
                expire = self.int_lit()
            return A.PresignStage(ref, method, expire)
        self.error("expected statement")

    def parse_merge(self):
        """MERGE INTO tgt [AS a] USING src [AS b] ON cond
        WHEN MATCHED [AND c] THEN UPDATE SET ... | DELETE
        WHEN NOT MATCHED [AND c] THEN INSERT [(cols)] VALUES (...)"""
        self.next()  # MERGE
        self.expect_keyword("INTO")
        db, name = self.qualified_name()
        alias = None
        if self.accept_keyword("AS"):
            alias = self.ident()
        elif self.peek().kind == "IDENT" and not self._at_word("USING"):
            alias = self.ident()
        if not self._at_word("USING"):
            self.error("expected USING")
        self.next()
        source = self.parse_table_factor()
        self.expect_keyword("ON")
        on = self.parse_expr()
        clauses = []
        while self._at_word("WHEN"):
            self.next()
            matched = True
            if self.accept_keyword("NOT"):
                matched = False
            if not self._at_word("MATCHED"):
                self.error("expected MATCHED")
            self.next()
            cond = None
            if self.accept_keyword("AND"):
                cond = self.parse_expr()
            if not self._at_word("THEN"):
                self.error("expected THEN")
            self.next()
            if self.accept_keyword("UPDATE"):
                self.expect_keyword("SET")
                assigns = []
                while True:
                    col = self.ident()
                    self.expect_op("=")
                    assigns.append((col, self.parse_expr()))
                    if not self.accept_op(","):
                        break
                clauses.append(A.MergeClause(matched, cond, "update", assigns))
            elif self.accept_keyword("DELETE"):
                clauses.append(A.MergeClause(matched, cond, "delete"))
            elif self.accept_keyword("INSERT"):
                cols = None
                if self.accept_op("("):
                    cols = [self.ident()]
                    while self.accept_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                self.expect_keyword("VALUES")
                self.expect_op("(")
                vals = [self.parse_expr()]
                while self.accept_op(","):
                    vals.append(self.parse_expr())
                self.expect_op(")")
                clauses.append(A.MergeClause(matched, cond, "insert", [],
                                             cols, vals))
            else:
                self.error("expected UPDATE/DELETE/INSERT")
        if not clauses:
            self.error("MERGE requires at least one WHEN clause")
        return A.MergeInto(name, db, alias, source, on, clauses)

    def parse_copy(self):
        """COPY INTO t FROM 'path' | COPY INTO 'path' FROM t|(query),
        with FILE_FORMAT = (TYPE=CSV ...) and PATTERN = '...' options."""
        self.expect_keyword("COPY")
        self.expect_keyword("INTO")
        if self.peek().kind in ("STRING", "ATREF"):
            dst = self.next().text
            self.expect_keyword("FROM")
            table = db = query = None
            if self.at_op("("):
                self.next()
                query = self.parse_query()
                self.expect_op(")")
            else:
                db, table = self.qualified_name()
            fmt = self._parse_copy_options()[0]
            return A.CopyIntoLocation(dst, table, db, query, fmt)
        db, name = self.qualified_name()
        self.expect_keyword("FROM")
        if self.at_op("("):
            # transform-on-load: COPY INTO t FROM (SELECT ... FROM @stage)
            # (reference: copy-with-transform) — an INSERT..SELECT with COPY
            # syntax; the stage scan applies formats/patterns itself
            self.next()
            query = self.parse_query()
            self.expect_op(")")
            self._parse_copy_options()  # options already bound in the query
            return A.Insert(name, db, [], query=query)
        if self.peek().kind not in ("STRING", "ATREF"):
            self.error("COPY INTO <table> FROM expects a path or @stage")
        src = self.next().text
        fmt, pattern, files, force = self._parse_copy_options()
        return A.CopyIntoTable(name, db, src, fmt, pattern, files, force)

    def _parse_copy_options(self):
        fmt: dict = {}
        pattern = None
        files = None
        force = False
        while self.peek().kind in ("IDENT", "KEYWORD"):
            kw = self.peek().text.upper()
            if kw == "FILE_FORMAT":
                self.next()
                self.expect_op("=")
                self.expect_op("(")
                while not self.at_op(")"):
                    k = self.next().text
                    self.expect_op("=")
                    fmt[k.lower()] = self.next().text
                    self.accept_op(",")
                self.expect_op(")")
            elif kw == "PATTERN":
                self.next()
                self.expect_op("=")
                pattern = self.next().text
            elif kw == "FILES":
                self.next()
                self.expect_op("=")
                self.expect_op("(")
                files = []
                while not self.at_op(")"):
                    files.append(self.next().text)
                    self.accept_op(",")
                self.expect_op(")")
            elif kw == "FORCE":
                self.next()
                self.expect_op("=")
                force = self.next().text.upper() == "TRUE"
            else:
                break
        return fmt, pattern, files, force

    def parse(self) -> A.Statement:
        stmt = self.parse_statement()
        self.accept_op(";")
        if self.peek().kind != "EOF":
            self.error("unexpected trailing input")
        return stmt

    # ----------------------------------------------------------------- create
    def parse_create(self):
        self.expect_keyword("CREATE")
        replace = False
        if self.accept_keyword("OR"):
            self.expect_keyword("REPLACE")
            replace = True
        if self.accept_keyword("DATABASE") or self.accept_keyword("SCHEMA"):
            ine = self._if_not_exists()
            return A.CreateDatabase(self.ident(), ine or replace)
        if self._at_word("CATALOG"):
            # CREATE CATALOG c TYPE=ICEBERG CONNECTION=(URL='...') |
            # LOCATION='...' (reference CatalogManager, iceberg catalog)
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            ctype = "ICEBERG"
            opts = {}
            while self.peek().kind in ("IDENT", "KEYWORD") \
                    and self.peek().text.upper() in ("TYPE", "CONNECTION",
                                                     "LOCATION"):
                w = self.next().text.upper()
                self.expect_op("=")
                if w == "TYPE":
                    ctype = self.next().text.upper()
                elif w == "LOCATION":
                    t = self.next()
                    opts["location"] = t.text
                else:  # CONNECTION=(k='v' ...)
                    self.expect_op("(")
                    while not self.at_op(")"):
                        k = self.next().text.lower()
                        self.expect_op("=")
                        opts[k] = self.next().text
                        self.accept_op(",")
                    self.expect_op(")")
            return A.CreateCatalog(name, ctype, opts, ine, replace)
        if self._at_word("WAREHOUSE"):
            # CREATE WAREHOUSE w [WITH k = v ...] (reference
            # management/src/warehouse, resource_management DDL)
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            opts = {}
            if self.accept_keyword("WITH"):
                while self.peek().kind in ("IDENT", "KEYWORD"):
                    k = self.next().text.lower()
                    self.expect_op("=")
                    opts[k] = self.next().text
                    self.accept_op(",")
            return A.CreateWarehouse(name, opts, ine or replace)
        if self._at_word("WORKLOAD"):
            # CREATE WORKLOAD GROUP g [WITH k = v ...] (reference ee
            # resource_management workload groups)
            self.next()
            if not self._at_word("GROUP"):
                self.error("expected GROUP after WORKLOAD")
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            opts = {}
            if self.accept_keyword("WITH"):
                while self.peek().kind in ("IDENT", "KEYWORD"):
                    k = self.next().text.lower()
                    self.expect_op("=")
                    opts[k] = self.next().text
                    self.accept_op(",")
            return A.CreateWorkloadGroup(name, opts, ine or replace)
        if self.at_keyword("TABLE"):
            return self.parse_create_table(replace)
        if self._at_word("TEMP", "TEMPORARY") \
                and self.peek(1).text.upper() == "TABLE":
            self.next()
            return self.parse_create_table(replace, temporary=True)
        if self._at_word("TRANSIENT") and self.peek(1).text.upper() == "TABLE":
            self.next()  # no-history tables: stored as a table option
            st = self.parse_create_table(replace)
            st.options["transient"] = "true"
            return st
        for itype in ("VECTOR", "INVERTED", "NGRAM"):
            if self.at_keyword(itype):
                if self.peek(1).kind == "KEYWORD" and self.peek(1).text == "INDEX":
                    self.next()
                    return self.parse_create_index(itype)
        if self._at_word("AGGREGATING") and self.peek(1).text.upper() == "INDEX":
            self.next()
            return self.parse_create_aggregating_index()
        if self.at_keyword("INDEX"):
            return self.parse_create_index("AGGREGATING")
        if self._at_word("USER"):
            self.next()
            ine = self._if_not_exists()
            name = self._user_name()
            password = None
            if self._at_word("IDENTIFIED"):
                self.next()
                self.expect_keyword("BY")
                password = self.next().text
            return A.CreateUser(name, password, ine)
        if self._at_word("ROLE"):
            self.next()
            ine = self._if_not_exists()
            return A.CreateRole(self._user_name(), ine)
        if self._at_word("MASKING") and self.peek(1).text.upper() == "POLICY":
            self.next()
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            self.expect_keyword("AS")
            self.expect_op("(")
            arg = self.ident()
            arg_t = self.parse_type_name()
            self.expect_op(")")
            if not self._at_word("RETURNS"):
                self.error("expected RETURNS <type>")
            self.next()
            ret_t = self.parse_type_name()
            self.expect_op("->")
            start = self.peek().pos
            self.parse_expr()  # validate the body parses
            end = self.peek().pos if self.peek().kind != "EOF" else len(self.sql)
            body = self.sql[start:end].strip().rstrip(";")
            comment = ""
            if self.accept_keyword("COMMENT"):
                self.expect_op("=")
                comment = self.next().text
            return A.CreateMaskingPolicy(name, arg, arg_t, ret_t, body,
                                         comment, ine, replace)
        if self._at_word("ROW") and self.peek(1).text.upper() == "ACCESS":
            self.next()
            self.next()
            if not self._at_word("POLICY"):
                self.error("expected ROW ACCESS POLICY")
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            self.expect_keyword("AS")
            self.expect_op("(")
            args = [(self.ident(), self.parse_type_name())]
            while self.accept_op(","):
                args.append((self.ident(), self.parse_type_name()))
            self.expect_op(")")
            if not self._at_word("RETURNS"):
                self.error("expected RETURNS BOOLEAN")
            self.next()
            self.parse_type_name()
            self.expect_op("->")
            start = self.peek().pos
            self.parse_expr()
            end = self.peek().pos if self.peek().kind != "EOF" else len(self.sql)
            body = self.sql[start:end].strip().rstrip(";")
            comment = ""
            if self.accept_keyword("COMMENT"):
                self.expect_op("=")
                comment = self.next().text
            return A.CreateRowAccessPolicy(name, args, body, comment, ine,
                                           replace)
        if self._at_word("CONNECTION"):
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            storage_type = "s3"
            params: dict = {}
            while self.peek().kind in ("IDENT", "KEYWORD") \
                    and self.peek(1).kind == "OP" and self.peek(1).text == "=":
                k = self.next().text.lower()
                self.expect_op("=")
                v = self.next().text
                if k == "storage_type":
                    storage_type = v.lower()
                else:
                    params[k] = v
            return A.CreateConnection(name, storage_type, params, ine, replace)
        if self._at_word("NETWORK") and self.peek(1).text.upper() == "POLICY":
            self.next()
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            allowed, blocked, comment = [], [], ""
            while self.peek().kind in ("IDENT", "KEYWORD"):
                kw = self.peek().text.upper()
                if kw in ("ALLOWED_IP_LIST", "BLOCKED_IP_LIST"):
                    self.next()
                    self.expect_op("=")
                    self.expect_op("(")
                    lst = []
                    while not self.at_op(")"):
                        lst.append(self.next().text)
                        self.accept_op(",")
                    self.expect_op(")")
                    (allowed if kw == "ALLOWED_IP_LIST" else blocked).extend(lst)
                elif kw == "COMMENT":
                    self.next()
                    self.expect_op("=")
                    comment = self.next().text
                else:
                    break
            return A.CreateNetworkPolicy(name, allowed, blocked, comment,
                                         ine, replace)
        if self._at_word("PASSWORD") and self.peek(1).text.upper() == "POLICY":
            self.next()
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            opts: dict = {}
            comment = ""
            while self.peek().kind in ("IDENT", "KEYWORD"):
                kw = self.peek().text.upper()
                if kw == "COMMENT":
                    self.next()
                    self.expect_op("=")
                    comment = self.next().text
                elif kw.startswith("PASSWORD_"):
                    self.next()
                    self.expect_op("=")
                    opts[kw.lower()] = self.int_lit()
                else:
                    break
            return A.CreatePasswordPolicy(name, opts, comment, ine, replace)
        if self._at_word("DICTIONARY"):
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            cols = []
            if self.accept_op("("):
                while True:
                    cols.append(self.parse_column_def())
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            pk = ""
            if self.accept_keyword("PRIMARY"):
                self.expect_keyword("KEY")
                pk = self.ident()
            kind = ""
            opts: dict = {}
            if self._at_word("SOURCE"):
                self.next()
                self.expect_op("(")
                kind = self.ident().upper()
                self.expect_op("(")
                while not self.at_op(")"):
                    k = self.next().text
                    self.expect_op("=")
                    opts[k.lower()] = self.next().text
                    self.accept_op(",")
                self.expect_op(")")
                self.expect_op(")")
            comment = ""
            if self.accept_keyword("COMMENT"):
                self.accept_op("=")
                comment = self.next().text
            return A.CreateDictionary(name, cols, pk, kind, opts, comment,
                                      ine, replace)
        if self._at_word("SEQUENCE"):
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            start, step, comment = 1, 1, ""
            while self.peek().kind in ("IDENT", "KEYWORD"):
                kw = self.peek().text.upper()
                if kw == "START":
                    self.next()
                    self.accept_keyword("WITH") or self.accept_op("=")
                    start = self.int_lit()
                elif kw in ("INCREMENT", "STEP"):
                    self.next()
                    self.accept_keyword("BY") or self.accept_op("=")
                    step = self.int_lit()
                elif kw == "COMMENT":
                    self.next()
                    self.expect_op("=")
                    comment = self.next().text
                else:
                    break
            return A.CreateSequence(name, start, step, comment, ine, replace)
        if self.at_keyword("STAGE"):
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            url = None
            fmt: dict = {}
            conn: dict = {}
            comment = ""
            while self.peek().kind in ("IDENT", "KEYWORD"):
                kw = self.peek().text.upper()
                if kw == "URL":
                    self.next()
                    self.expect_op("=")
                    url = self.next().text
                elif kw == "CONNECTION":
                    self.next()
                    self.expect_op("=")
                    self.expect_op("(")
                    while not self.at_op(")"):
                        k = self.next().text
                        self.expect_op("=")
                        conn[k.lower()] = self.next().text
                        self.accept_op(",")
                    self.expect_op(")")
                elif kw == "FILE_FORMAT":
                    self.next()
                    self.expect_op("=")
                    self.expect_op("(")
                    while not self.at_op(")"):
                        k = self.next().text
                        self.expect_op("=")
                        fmt[k.lower()] = self.next().text
                        self.accept_op(",")
                    self.expect_op(")")
                elif kw == "COMMENT":
                    self.next()
                    self.expect_op("=")
                    comment = self.next().text
                else:
                    break
            return A.CreateStage(name, url, fmt, comment, ine, replace,
                                 connection=conn)
        if self.at_keyword("STREAM"):
            self.next()
            ine = self._if_not_exists()
            db, name = self.qualified_name()
            self.expect_keyword("ON")
            self.expect_keyword("TABLE")
            tdb, tname = self.qualified_name()
            return A.CreateStream(name, tname, tdb, db, ine)
        if self.at_keyword("VIEW"):
            self.next()
            ine = self._if_not_exists()
            db, name = self.qualified_name()
            self.expect_keyword("AS")
            start = self.peek().pos
            self.parse_query()  # validate the query parses now
            return A.CreateView(name, self.sql[start:].strip().rstrip(";"),
                                db, replace, ine)
        if self.at_keyword("TASK"):
            # CREATE TASK t [WAREHOUSE='..'] [SCHEDULE = n SECOND|MINUTE |
            # USING CRON '..'] [AFTER t1, t2] [WHEN <cond sql>]
            # [SUSPEND_TASK_AFTER_NUM_FAILURES = n] [COMMENT='..'] AS <sql>
            # (reference: task_support CREATE TASK grammar)
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            secs, warehouse, cron, comment = 0, None, None, None
            after: List[str] = []
            when_sql = None
            suspend_n = None
            while not self.at_keyword("AS"):
                w = self.peek().text.upper()
                if w == "SCHEDULE":
                    self.next()
                    self.expect_op("=")
                    if self._at_word("USING"):
                        self.next()
                        if self._at_word("CRON"):
                            self.next()
                        cron = self.next().text
                        continue
                    secs = self.int_lit()
                    unit = self.next().text.upper()
                    if unit.startswith("MINUTE"):
                        secs *= 60
                    elif unit.startswith("HOUR"):
                        secs *= 3600
                    elif not unit.startswith("SECOND"):
                        self.error("expected SECOND/MINUTE/HOUR")
                elif w == "USING":
                    self.next()
                    if self._at_word("CRON"):
                        self.next()
                    cron = self.next().text
                elif w == "WAREHOUSE":
                    self.next()
                    self.expect_op("=")
                    warehouse = self.next().text
                elif w == "COMMENT":
                    self.next()
                    self.expect_op("=")
                    comment = self.next().text
                elif w == "AFTER":
                    self.next()
                    after.append(self.ident())
                    while self.accept_op(","):
                        after.append(self.ident())
                elif w == "WHEN":
                    self.next()
                    start = self.peek().pos
                    self.parse_expr()
                    when_sql = self.sql[start:self.peek().pos].strip()
                elif w == "SUSPEND_TASK_AFTER_NUM_FAILURES":
                    self.next()
                    self.expect_op("=")
                    suspend_n = self.int_lit()
                else:
                    self.error(f"unknown CREATE TASK option {w!r}")
            self.expect_keyword("AS")
            start = self.peek().pos
            self.parse_statement()  # validate the body parses
            return A.CreateTask(name, secs,
                                self.sql[start:].strip().rstrip(";"), ine,
                                warehouse, cron, comment, after, when_sql,
                                suspend_n, replace)
        if self.at_keyword("FUNCTION"):
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            if self.at_op("("):
                # external UDF-server form: (TYPE, ...) RETURNS TYPE
                # LANGUAGE lang HANDLER='h' ADDRESS='grpc://...'
                # (reference: tests/sqllogictests/suites/udf_server/)
                self.expect_op("(")
                arg_types = []
                if not self.at_op(")"):
                    arg_types.append(self.parse_type_name())
                    while self.accept_op(","):
                        arg_types.append(self.parse_type_name())
                self.expect_op(")")
                if not self._at_word("RETURNS"):
                    self.error("expected RETURNS in external CREATE FUNCTION")
                self.next()
                ret = self.parse_type_name()
                language = handler = address = None
                while self._at_word("LANGUAGE", "HANDLER", "ADDRESS"):
                    w = self.next().text.upper()
                    if w == "LANGUAGE":
                        language = self.next().text
                    else:
                        self.expect_op("=")
                        t = self.next()
                        if t.kind != "STRING":
                            self.error(f"{w} expects a quoted string")
                        if w == "HANDLER":
                            handler = t.text
                        else:
                            address = t.text
                if address is None:
                    self.error("external CREATE FUNCTION requires ADDRESS")
                return A.CreateFunction(
                    name, [], None, "", replace, ine, arg_types, ret,
                    language or "python", handler or name, address)
            self.expect_keyword("AS")
            self.expect_op("(")
            params = []
            if not self.at_op(")"):
                params.append(self.ident())
                while self.accept_op(","):
                    params.append(self.ident())
            self.expect_op(")")
            self.expect_op("->")
            body_start = self.peek().pos
            body = self.parse_expr()
            end = self.peek().pos if self.peek().kind != "EOF" else len(self.sql)
            return A.CreateFunction(name, params, body,
                                    self.sql[body_start:end].strip(),
                                    replace, ine)
        self.error("expected DATABASE/TABLE/INDEX/USER/ROLE/FUNCTION after CREATE")

    def _at_word(self, *words: str) -> bool:
        t = self.peek()
        return t.kind in ("IDENT", "KEYWORD") and t.text.upper() in words

    def _user_name(self) -> str:
        t = self.next()
        return t.text

    def _if_not_exists(self) -> bool:
        if self.accept_keyword("IF"):
            self.expect_keyword("NOT")
            self.expect_keyword("EXISTS")
            return True
        return False

    def _if_exists(self) -> bool:
        if self.accept_keyword("IF"):
            self.expect_keyword("EXISTS")
            return True
        return False

    def parse_create_table(self, replace: bool = False,
                           temporary: bool = False):
        self.expect_keyword("TABLE")
        ine = self._if_not_exists()
        db, name = self.qualified_name()
        if self.accept_keyword("LIKE"):
            src_db, src = self.qualified_name()
            st = A.CreateTable(name, db, [], ine, [], "FUSE", None, {},
                               temporary, replace)
            st.options["like"] = (src_db or "") + "." + src
            return st
        columns: List[A.ColumnDef] = []
        inline_indexes: List[tuple] = []
        if self.accept_op("("):
            while True:
                idx = self._try_parse_inline_index()
                if idx is not None:
                    inline_indexes.append(idx)
                else:
                    columns.append(self.parse_column_def())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        engine = "FUSE"
        cluster_by: List[A.Expr] = []
        options = {}
        as_query = None
        while True:
            if self.accept_keyword("ENGINE"):
                self.expect_op("=")
                engine = self.ident().upper()
            elif self.accept_keyword("CLUSTER"):
                self.expect_keyword("BY")
                self.expect_op("(")
                while True:
                    cluster_by.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            elif self.at_keyword("AS"):
                self.next()
                as_query = self.parse_query()
                break
            elif self.peek().kind == "IDENT" and self.peek(1).kind == "OP" and self.peek(1).text == "=":
                k = self.ident()
                self.expect_op("=")
                t = self.next()
                options[k.lower()] = t.text
            else:
                break
        st = A.CreateTable(name, db, columns, ine, cluster_by, engine,
                           as_query, options, temporary, replace)
        st.inline_indexes = inline_indexes
        return st

    def _try_parse_inline_index(self):
        """[SYNC|ASYNC] (VECTOR|INVERTED|NGRAM) INDEX name (cols) [k=v ...]
        inside a CREATE TABLE column list, or None when not at one."""
        save = self.i
        sync = True
        if self._at_word("SYNC", "ASYNC"):
            sync = self.next().text.upper() == "SYNC"
        if not (self._at_word("VECTOR", "INVERTED", "NGRAM")
                and self.peek(1).text.upper() == "INDEX"):
            self.i = save
            return None
        itype = self.next().text.upper()
        self.next()  # INDEX
        name = self.ident()
        self.expect_op("(")
        cols = [self.ident()]
        while self.accept_op(","):
            cols.append(self.ident())
        self.expect_op(")")
        options = {}
        while (self.peek().kind in ("IDENT", "KEYWORD")
               and self.peek(1).kind == "OP" and self.peek(1).text == "="):
            k = self.next().text
            self.expect_op("=")
            options[k.lower()] = self.next().text
        return (itype, name, cols, options, sync)

    def parse_column_def(self) -> A.ColumnDef:
        name = self.ident()
        type_name = self.parse_type_name()
        nullable = True
        default = None
        comment = None
        computed = None
        while True:
            if self.accept_keyword("NOT"):
                self.expect_keyword("NULL")
                nullable = False
            elif self.accept_keyword("NULL"):
                nullable = True
            elif self.accept_keyword("DEFAULT"):
                default = self.parse_expr()
            elif self.accept_keyword("COMMENT"):
                comment = self.next().text
            elif self.at_keyword("AS") and self.peek(1).text == "(":
                # computed column: c TYPE AS (expr) STORED|VIRTUAL
                self.next()
                self.expect_op("(")
                start = self.peek().pos
                self.parse_expr()  # validate
                end = self.peek().pos
                self.expect_op(")")
                kind = "VIRTUAL"
                if self._at_word("STORED", "VIRTUAL"):
                    kind = self.next().text.upper()
                computed = (self.sql[start:end].strip(), kind)
            else:
                break
        return A.ColumnDef(name, type_name, nullable, default, comment,
                           computed)

    def parse_type_name(self) -> str:
        parts = [self.next().text]
        if self.accept_op("("):
            parts.append("(")
            depth = 1
            while depth:
                t = self.next()
                if t.kind == "EOF":
                    self.error("unterminated type")
                if t.text == "(":
                    depth += 1
                elif t.text == ")":
                    depth -= 1
                    if not depth:
                        parts.append(")")
                        break
                parts.append(t.text if t.kind != "OP" else t.text)
        if self._at_word("UNSIGNED", "SIGNED"):
            parts.append(self.next().text)
        import re as _re
        return _re.sub(r"\s*([(),])\s*", r"\1", " ".join(parts))

    def parse_create_index(self, itype: str):
        self.expect_keyword("INDEX")
        ine = self._if_not_exists()
        name = self.ident()
        self.expect_keyword("ON")
        db, table = self.qualified_name()
        self.expect_op("(")
        cols = [self.ident()]
        while self.accept_op(","):
            cols.append(self.ident())
        self.expect_op(")")
        options = {}
        sync = True
        while True:
            if self.accept_keyword("SYNC"):
                sync = True
            elif self.accept_keyword("ASYNC"):
                sync = False
            elif (self.peek().kind in ("IDENT", "KEYWORD")
                  and self.peek(1).kind == "OP" and self.peek(1).text == "="):
                k = self.next().text
                self.expect_op("=")
                options[k.lower()] = self.next().text
            else:
                break
        return A.CreateIndex(itype, name, table, db, cols, options, ine, sync)

    def parse_create_aggregating_index(self):
        """CREATE AGGREGATING INDEX idx [SYNC|ASYNC] AS SELECT ...
        (reference TableIndexType::Aggregating)."""
        self.expect_keyword("INDEX")
        ine = self._if_not_exists()
        name = self.ident()
        sync = True
        if self.accept_keyword("ASYNC"):
            sync = False
        else:
            self.accept_keyword("SYNC")
        self.expect_keyword("AS")
        start = self.peek().pos
        query = self.parse_query()
        end = self.peek().pos if self.peek().kind != "EOF" else len(self.sql)
        return A.CreateAggregatingIndex(name, query,
                                        self.sql[start:end].strip(), ine, sync)

    # ------------------------------------------------------------------- drop
    def parse_drop(self):
        self.expect_keyword("DROP")
        if self.accept_keyword("DATABASE") or self.accept_keyword("SCHEMA"):
            ie = self._if_exists()
            return A.DropDatabase(self.ident(), ie)
        if self._at_word("CATALOG"):
            self.next()
            ie = self._if_exists()
            return A.DropCatalog(self.ident(), ie)
        if self._at_word("WAREHOUSE"):
            self.next()
            ie = self._if_exists()
            return A.DropWarehouse(self.ident(), ie)
        if self._at_word("WORKLOAD"):
            self.next()
            if not self._at_word("GROUP"):
                self.error("expected GROUP after WORKLOAD")
            self.next()
            ie = self._if_exists()
            return A.DropWorkloadGroup(self.ident(), ie)
        if self.accept_keyword("TABLE"):
            ie = self._if_exists()
            db, name = self.qualified_name()
            all_ = bool(self.accept_keyword("ALL"))
            return A.DropTable(name, db, ie, all_)
        for itype in ("VECTOR", "INVERTED", "NGRAM", "AGGREGATING"):
            if self._at_word(itype) and self.peek(1).text.upper() == "INDEX":
                self.next()
                self.expect_keyword("INDEX")
                ie = self._if_exists()
                name = self.ident()
                table = None
                if self.accept_keyword("ON"):
                    _, table = self.qualified_name()
                return A.DropIndex(itype, name, table, ie)
        if self.accept_keyword("INDEX"):
            ie = self._if_exists()
            return A.DropIndex("AGGREGATING", self.ident(), None, ie)
        if self._at_word("MASKING") and self.peek(1).text.upper() == "POLICY":
            self.next()
            self.next()
            ie = self._if_exists()
            return A.DropMaskingPolicy(self.ident(), ie)
        if self._at_word("ROW") and self.peek(1).text.upper() == "ACCESS":
            self.next()
            self.next()
            if not self._at_word("POLICY"):
                self.error("expected ROW ACCESS POLICY")
            self.next()
            ie = self._if_exists()
            return A.DropRowAccessPolicy(self.ident(), ie)
        if self._at_word("CONNECTION"):
            self.next()
            ie = self._if_exists()
            return A.DropConnection(self.ident(), ie)
        if self._at_word("PROCEDURE"):
            self.next()
            ie = self._if_exists()
            name = self.ident()
            if self.accept_op("("):  # optional arg-type signature
                while not self.at_op(")"):
                    self.next()
                self.expect_op(")")
            return A.DropProcedure(name, ie)
        if self._at_word("NETWORK") and self.peek(1).text.upper() == "POLICY":
            self.next()
            self.next()
            ie = self._if_exists()
            return A.DropNetworkPolicy(self.ident(), ie)
        if self._at_word("PASSWORD") and self.peek(1).text.upper() == "POLICY":
            self.next()
            self.next()
            ie = self._if_exists()
            return A.DropPasswordPolicy(self.ident(), ie)
        if self._at_word("DICTIONARY"):
            self.next()
            ie = self._if_exists()
            return A.DropDictionary(self.ident(), ie)
        if self._at_word("SEQUENCE"):
            self.next()
            ie = self._if_exists()
            return A.DropSequence(self.ident(), ie)
        if self.at_keyword("STAGE"):
            self.next()
            ie = self._if_exists()
            return A.DropStage(self.ident(), ie)
        if self._at_word("USER"):
            self.next()
            ie = self._if_exists()
            return A.DropUser(self._user_name(), ie)
        if self._at_word("ROLE"):
            self.next()
            ie = self._if_exists()
            return A.DropRole(self._user_name(), ie)
        if self.accept_keyword("STREAM"):
            ie = self._if_exists()
            db, name = self.qualified_name()
            return A.DropStream(name, db, ie)
        if self.accept_keyword("VIEW"):
            ie = self._if_exists()
            db, name = self.qualified_name()
            return A.DropView(name, db, ie)
        if self.accept_keyword("TASK"):
            ie = self._if_exists()
            return A.DropTask(self.ident(), ie)
        if self.accept_keyword("FUNCTION"):
            ie = self._if_exists()
            return A.DropFunction(self.ident(), ie)
        self.error("expected DATABASE/TABLE/INDEX/USER/ROLE/FUNCTION after DROP")

    def parse_grant_revoke(self):
        is_grant = self.next().text.upper() == "GRANT"
        kw_to = "TO" if is_grant else "FROM"
        # GRANT ROLE r TO u
        if self._at_word("ROLE"):
            self.next()
            role = self._user_name()
            self.expect_keyword(kw_to)
            user = self._user_name()
            return A.GrantRole(role, user, is_grant)
        privs = [self.next().text.upper()]
        while self.accept_op(","):
            privs.append(self.next().text.upper())
        self.expect_keyword("ON")
        db, table = self._grant_object()
        if is_grant:
            self.expect_keyword("TO")
        else:
            self.expect_keyword("FROM")
        to_role = None
        if self._at_word("ROLE"):
            self.next()
            to_role = self._user_name()
            return A.GrantPrivileges(privs, db, table, None, to_role, is_grant)
        return A.GrantPrivileges(privs, db, table, self._user_name(), None, is_grant)

    def _grant_object(self):
        """*.* | db.* | db.table | table"""
        if self.accept_op("*"):
            self.expect_op(".")
            self.expect_op("*")
            return "*", "*"
        first = self.ident()
        if self.accept_op("."):
            if self.accept_op("*"):
                return first, "*"
            return first, self.ident()
        return None, first  # current database

    def parse_refresh(self):
        self.expect_keyword("REFRESH")
        if self._at_word("VIRTUAL") and self.next():
            if not (self._at_word("COLUMN") and self.next()):
                self.error("expected COLUMN")
            if self._at_word("FOR"):
                self.next()
            _, table = self.qualified_name()
            return A.RefreshVirtualColumn(table)
        for itype in ("VECTOR", "INVERTED", "NGRAM", "AGGREGATING"):
            if self._at_word(itype) and self.next():
                self.expect_keyword("INDEX")
                name = self.ident()
                table = None
                if self.accept_keyword("ON"):
                    _, table = self.qualified_name()
                return A.RefreshIndex(itype, name, table)
        self.error("expected index type after REFRESH")

    def parse_alter(self):
        self.expect_keyword("ALTER")
        if self.accept_keyword("TASK"):
            name = self.ident()
            action = self.next().text.upper()
            if action not in ("SUSPEND", "RESUME"):
                self.error("expected SUSPEND/RESUME")
            return A.AlterTask(name, action)
        if self._at_word("WAREHOUSE"):
            self.next()
            name = self.ident()
            action = self.next().text.upper()
            if action not in ("SUSPEND", "RESUME"):
                self.error("expected SUSPEND/RESUME")
            return A.AlterWarehouse(name, action)
        if self._at_word("WORKLOAD"):
            self.next()
            if not self._at_word("GROUP"):
                self.error("expected GROUP after WORKLOAD")
            self.next()
            name = self.ident()
            self.expect_keyword("SET")
            opts = {}
            while self.peek().kind in ("IDENT", "KEYWORD"):
                k = self.next().text.lower()
                self.expect_op("=")
                opts[k] = self.next().text
                self.accept_op(",")
            return A.AlterWorkloadGroup(name, opts)
        if self._at_word("USER"):
            self.next()
            name = self._user_name()
            password = None
            net, pwp = ..., ...
            self.accept_keyword("WITH")
            while True:
                if self._at_word("IDENTIFIED"):
                    self.next()
                    self.expect_keyword("BY")
                    password = self.next().text
                elif self.at_keyword("SET") or self._at_word("UNSET"):
                    unset = self._at_word("UNSET")
                    self.next()
                    kind = self.next().text.upper()
                    if kind not in ("NETWORK", "PASSWORD"):
                        self.error("expected NETWORK/PASSWORD POLICY")
                    if not self._at_word("POLICY"):
                        self.error("expected POLICY")
                    self.next()
                    val = None
                    if not unset:
                        self.expect_op("=")
                        val = self.next().text
                    if kind == "NETWORK":
                        net = val
                    else:
                        pwp = val
                else:
                    break
            return A.AlterUser(name, password, net, pwp)
        self.expect_keyword("TABLE")
        db, name = self.qualified_name()
        if self.accept_keyword("RENAME"):
            if self.accept_keyword("COLUMN"):
                old = self.ident()
                self.expect_keyword("TO")
                return A.RenameColumn(name, db, old, self.ident())
            self.expect_keyword("TO")
            return A.RenameTable(name, self.ident(), db)
        if self.accept_keyword("FLASHBACK"):
            self.expect_keyword("TO")
            return A.FlashbackTable(name, self.parse_travel_point(), db)
        if self._at_word("RECLUSTER"):
            self.next()
            self._at_word("FINAL") and self.next()
            return A.OptimizeTable(name, db, "RECLUSTER")
        if self.accept_keyword("COMMENT"):
            self.accept_op("=")
            st = A.SetTableComment(name, db, self.next().text)
            return st
        if self.accept_keyword("ADD"):
            if self._at_word("ROW"):
                self.next()
                if not self._at_word("ACCESS"):
                    self.error("expected ROW ACCESS POLICY")
                self.next()
                if not self._at_word("POLICY"):
                    self.error("expected ROW ACCESS POLICY")
                self.next()
                policy = self.ident()
                self.expect_keyword("ON")
                self.expect_op("(")
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
                return A.SetTableRowAccessPolicy(name, db, policy, cols)
            self.accept_keyword("COLUMN")
            ine = self._if_not_exists()
            return A.AddColumn(name, db, self.parse_column_def(), ine)
        if self.accept_keyword("DROP"):
            if self._at_word("ROW"):
                self.next()
                if not (self._at_word("ACCESS")
                        and self.peek(1).text.upper() == "POLICY"):
                    self.error("expected ROW ACCESS POLICY")
                self.next()
                self.next()
                policy = self.ident()
                return A.SetTableRowAccessPolicy(name, db, policy, [], drop=True)
            self.accept_keyword("COLUMN")
            ie = self._if_exists()
            return A.DropColumn(name, db, self.ident(), ie)
        if self.accept_keyword("MODIFY"):
            self.expect_keyword("COLUMN")
            col = self.ident()
            if self.accept_keyword("SET"):
                if not (self._at_word("MASKING")
                        and self.peek(1).text.upper() == "POLICY"):
                    self.error("expected SET MASKING POLICY")
                self.next()
                self.next()
                return A.SetColumnMaskingPolicy(name, db, col, self.ident())
            if self._at_word("UNSET"):
                self.next()
                if not (self._at_word("MASKING")
                        and self.peek(1).text.upper() == "POLICY"):
                    self.error("expected UNSET MASKING POLICY")
                self.next()
                self.next()
                return A.SetColumnMaskingPolicy(name, db, col, None)
            self.error("unsupported MODIFY COLUMN action")
        self.error("unsupported ALTER TABLE action")

    # -------------------------------------------------------------------- dml
    def parse_insert(self):
        self.expect_keyword("INSERT")
        overwrite = bool(self.accept_keyword("OVERWRITE"))
        if self.at_keyword("ALL", "FIRST") or self._at_word("WHEN"):
            return self._parse_multi_insert(overwrite)
        if not overwrite:
            self.expect_keyword("INTO")
        else:
            self.accept_keyword("INTO")
        db, name = self.qualified_name()
        columns: List[str] = []
        if self.at_op("(") :
            # could be column list or VALUES-less subquery paren; look ahead
            save = self.i
            self.next()
            try:
                columns = [self.ident()]
                while self.accept_op(","):
                    columns.append(self.ident())
                self.expect_op(")")
            except SyntaxException:
                self.i = save
                columns = []
        if self.accept_keyword("VALUES"):
            rows = []
            while True:
                self.expect_op("(")
                row = [self.parse_expr()]
                while self.accept_op(","):
                    row.append(self.parse_expr())
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
            return A.Insert(name, db, columns, values=rows, overwrite=overwrite)
        query = self.parse_query()
        return A.Insert(name, db, columns, query=query, overwrite=overwrite)

    def _parse_multi_insert(self, overwrite: bool):
        """INSERT [OVERWRITE] ALL|FIRST [WHEN c THEN] INTO t [(cols)]
        [VALUES (e, ..)] ... [ELSE INTO ..] SELECT .. (reference:
        multi-table insert)."""
        first = bool(self.accept_keyword("FIRST"))
        if not first:
            self.expect_keyword("ALL")
        branches: List[A.MultiInsertBranch] = []
        else_branches: List[A.MultiInsertBranch] = []

        def parse_into(cond):
            self.expect_keyword("INTO")
            db, name = self.qualified_name()
            cols: List[str] = []
            vals = None
            if self.accept_op("("):
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
            if self.accept_keyword("VALUES"):
                self.expect_op("(")
                vals = [self.parse_expr()]
                while self.accept_op(","):
                    vals.append(self.parse_expr())
                self.expect_op(")")
            return A.MultiInsertBranch(cond, name, db, cols, vals)

        while True:
            if self._at_word("WHEN"):
                self.next()
                cond = self.parse_expr()
                if not self._at_word("THEN"):
                    self.error("expected THEN after WHEN condition")
                self.next()
                branches.append(parse_into(cond))
                while self.at_keyword("INTO"):
                    branches.append(parse_into(cond))
            elif self.at_keyword("INTO"):
                branches.append(parse_into(None))
            elif self.accept_keyword("ELSE"):
                else_branches.append(parse_into(None))
                while self.at_keyword("INTO"):
                    else_branches.append(parse_into(None))
            else:
                break
        if not branches:
            self.error("multi-table INSERT needs at least one INTO branch")
        query = self.parse_query()
        return A.MultiInsert(first, branches, else_branches, query,
                             overwrite)

    def parse_delete(self):
        self.expect_keyword("DELETE")
        self.expect_keyword("FROM")
        db, name = self.qualified_name()
        where = None
        if self.accept_keyword("WHERE"):
            where = self.parse_expr()
        return A.Delete(name, db, where)

    def parse_update(self):
        self.expect_keyword("UPDATE")
        db, name = self.qualified_name()
        self.expect_keyword("SET")
        assignments = []
        while True:
            col = self.ident()
            self.expect_op("=")
            assignments.append((col, self.parse_expr()))
            if not self.accept_op(","):
                break
        where = None
        if self.accept_keyword("WHERE"):
            where = self.parse_expr()
        return A.Update(name, db, assignments, where)

    # ------------------------------------------------------------------- misc
    def parse_show(self):
        self.expect_keyword("SHOW")
        if self._at_word("CATALOGS"):
            self.next()
            return A.ShowCatalogs()
        if self.accept_keyword("CREATE"):
            if self._at_word("DICTIONARY"):
                self.next()
                return A.ShowCreateDictionary(self.ident())
            self.expect_keyword("TABLE")
            db, name = self.qualified_name()
            return A.ShowCreateTable(name, db)
        if self.accept_keyword("TABLES"):
            from_db = None
            if self.accept_keyword("FROM") or self.accept_keyword("IN"):
                from_db = self.ident()
            like = self._opt_like()
            return A.ShowStmt("TABLES", from_db, like)
        if self._at_word("VIRTUAL") and self.next():
            if not (self._at_word("COLUMNS") and self.next()):
                self.error("expected COLUMNS")
            from_tbl = None
            if self.accept_keyword("FROM") or self.accept_keyword("IN"):
                _, from_tbl = self.qualified_name()
            return A.ShowStmt("VIRTUAL COLUMNS", from_tbl, self._opt_like())
        if self._at_word("COLUMNS", "FIELDS"):
            self.next()
            if not (self.accept_keyword("FROM") or self.accept_keyword("IN")):
                self.error("expected FROM <table>")
            db, name = self.qualified_name()
            if self.accept_keyword("FROM") or self.accept_keyword("IN"):
                db = self.ident()
            return A.DescribeTable(name, db)
        if self.accept_keyword("DATABASES"):
            return A.ShowStmt("DATABASES", None, self._opt_like())
        if self.accept_keyword("SETTINGS"):
            return A.ShowStmt("SETTINGS", None, self._opt_like())
        if self._at_word("GRANTS"):
            self.next()
            user = None
            if self._at_word("FOR"):
                self.next()
                user = self._user_name()
            return A.ShowGrants(user)
        if self._at_word("NETWORK", "PASSWORD", "MASKING") \
                and self.peek(1).text.upper() == "POLICIES":
            w = self.next().text.upper()
            self.next()
            return A.ShowStmt(w + "_POLICIES", None, self._opt_like())
        if self._at_word("WORKLOAD") \
                and self.peek(1).text.upper() == "GROUPS":
            self.next()
            self.next()
            return A.ShowStmt("WORKLOAD_GROUPS", None, self._opt_like())
        if self._at_word("ROW") and self.peek(1).text.upper() == "ACCESS":
            self.next()
            self.next()
            if self.peek().text.upper() != "POLICIES":
                self.error("expected ROW ACCESS POLICIES")
            self.next()
            return A.ShowStmt("ROW_ACCESS_POLICIES", None, self._opt_like())
        if self.peek().kind in ("IDENT", "KEYWORD"):
            what = self.next().text.upper()
            return A.ShowStmt(what, None, self._opt_like())
        self.error("unsupported SHOW")

    def _parse_star_exclude(self):
        # SELECT * EXCLUDE (a, b) / EXCLUDE a  (reference query.rs)
        if not self._at_word("EXCLUDE"):
            return []
        self.next()
        if self.accept_op("("):
            cols = [self.ident()]
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
            return cols
        return [self.ident()]

    def _parse_star_replace(self):
        # SELECT * REPLACE (expr AS col, ..) (reference query.rs)
        if not self._at_word("REPLACE") or self.peek(1).text != "(":
            return []
        self.next()
        self.expect_op("(")
        out = [(None, None)] * 0
        while True:
            e = self.parse_expr()
            self.expect_keyword("AS")
            out.append((self.ident(), e))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return out

    def _opt_like(self) -> Optional[str]:
        if self.accept_keyword("LIKE"):
            return self.next().text
        return None

    def parse_set(self):
        self.expect_keyword("SET")
        if self._at_word("VARIABLE"):
            self.next()
            name = self.ident()
            self.expect_op("=")
            return A.SetVariable(name, self.parse_expr())
        # GLOBAL is not reserved: only treat it as the scope marker when a
        # setting name follows (SET global = 1 stays a plain assignment)
        is_global = (self._at_word("GLOBAL")
                     and not (self.peek(1).kind == "OP"
                              and self.peek(1).text == "="))
        if is_global:
            self.next()
        name = self.ident()
        self.expect_op("=")
        t = self.next()
        value: Any = t.text
        if t.kind == "INT":
            value = int(t.text)
        elif t.kind == "FLOAT":
            value = float(t.text)
        elif t.kind == "KEYWORD" and t.text in ("TRUE", "FALSE"):
            value = t.text == "TRUE"
        return A.SetSetting(name, value, is_global)

    # ------------------------------------------------------------------ query
    MAX_NEST_DEPTH = 120

    def _enter_nest(self):
        """Bound parser recursion: pathological nesting must fail as a
        clean SyntaxException, not a RecursionError (fuzz finding;
        reference: nom's recursion limits)."""
        self._nest = getattr(self, "_nest", 0) + 1
        if self._nest > self.MAX_NEST_DEPTH:
            self._nest = 0
            raise SyntaxException(
                f"query nesting exceeds {self.MAX_NEST_DEPTH} levels")

    def _exit_nest(self):
        self._nest = max(getattr(self, "_nest", 1) - 1, 0)

    def parse_query(self) -> A.Query:
        self._enter_nest()
        try:
            return self._parse_query_inner()
        finally:
            self._exit_nest()

    def _parse_query_inner(self) -> A.Query:
        ctes: List[Tuple[str, A.Query]] = []
        recursive = False
        if self.accept_keyword("WITH"):
            recursive = bool(self.accept_keyword("RECURSIVE"))
            while True:
                cname = self.ident()
                cte_cols: Optional[List[str]] = None
                if self.accept_op("("):  # WITH t(a, b) AS (...)
                    cte_cols = [self.ident()]
                    while self.accept_op(","):
                        cte_cols.append(self.ident())
                    self.expect_op(")")
                self.expect_keyword("AS")
                self.expect_op("(")
                cq = self.parse_query()
                self.expect_op(")")
                if cte_cols:
                    cq.cte_columns = cte_cols
                ctes.append((cname, cq))
                if not self.accept_op(","):
                    break
        body = self._parse_from_first() if self.at_keyword("FROM") \
            else self.parse_set_expr()
        order_by: List[A.OrderByExpr] = []
        limit = offset = None
        if self.accept_keyword("ORDER"):
            self.expect_keyword("BY")
            while True:
                order_by.append(self.parse_order_by_expr())
                if not self.accept_op(","):
                    break
        if self.accept_keyword("LIMIT"):
            first = self.parse_expr()
            if self.accept_op(","):  # LIMIT off, n (mysql style)
                offset = first
                limit = self.parse_expr()
                if self.at_keyword("OFFSET"):
                    self.error("LIMIT offset, n cannot combine with OFFSET")
            else:
                limit = first
        if self.accept_keyword("OFFSET"):
            offset = self.parse_expr()
        q = A.Query(body, order_by, limit, offset, ctes,
                    recursive)
        if self._at_word("IGNORE_RESULT"):
            # `... IGNORE_RESULT` executes the query and discards rows
            # (reference ast/query.rs ignore_result)
            self.next()
            q.ignore_result = True
        return q

    def parse_order_by_expr(self) -> A.OrderByExpr:
        e = self.parse_expr()
        asc = True
        if self.accept_keyword("ASC"):
            asc = True
        elif self.accept_keyword("DESC"):
            asc = False
        nulls_first = None
        if self.accept_keyword("NULLS"):
            if self.accept_keyword("FIRST"):
                nulls_first = True
            else:
                self.expect_keyword("LAST")
                nulls_first = False
        return A.OrderByExpr(e, asc, nulls_first)

    def parse_set_expr(self):
        left = self.parse_query_primary()
        while self.at_keyword("UNION", "EXCEPT", "INTERSECT"):
            op = self.next().text
            if self.accept_keyword("ALL"):
                op = op + " ALL"
            elif self.accept_keyword("DISTINCT"):
                pass
            right = self.parse_query_primary()
            left = A.SetOp(op, left, right)
        return left

    def parse_query_primary(self):
        if self.accept_op("("):
            q = self.parse_query()
            self.expect_op(")")
            return q
        if self.at_keyword("VALUES"):
            # standalone VALUES (..),(..) (reference: values statement)
            self.next()
            rows = []
            while True:
                self.expect_op("(")
                row = [self.parse_expr()]
                while self.accept_op(","):
                    row.append(self.parse_expr())
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
            vref = A.ValuesRef(rows)
            return A.SelectStmt([A.SelectItem(A.Star(None))], vref)
        return self.parse_select()

    def _parse_from_first(self) -> A.SelectStmt:
        """Leading-FROM query (reference dialect): `FROM t` is
        `SELECT * FROM t`, and `FROM t SELECT a, b` pipes the source into
        a select clause. Exactly one table reference is allowed."""
        self.expect_keyword("FROM")
        ref = self.parse_table_factor()
        if self.at_keyword("SELECT"):
            sel = self.parse_select()
            if sel.from_ is not None:
                self.error("FROM-first query already has a FROM clause")
            sel.from_ = ref
            return sel
        if self.at_op(","):
            self.error("FROM-first query takes a single table reference")
        return A.SelectStmt([A.SelectItem(A.Star(None))], ref)

    def parse_select(self) -> A.SelectStmt:
        self.expect_keyword("SELECT")
        distinct = bool(self.accept_keyword("DISTINCT"))
        self.accept_keyword("ALL")
        items = [self.parse_select_item()]
        while self.accept_op(","):
            items.append(self.parse_select_item())
        from_ = None
        if self.accept_keyword("FROM"):
            from_ = self.parse_table_ref()
        where = None
        if self.accept_keyword("WHERE"):
            where = self.parse_expr()
        group_by: List[A.Expr] = []
        group_sets = None
        group_all = False
        if self.accept_keyword("GROUP"):
            self.expect_keyword("BY")
            if self.accept_keyword("ALL"):
                group_all = True
            elif self._at_word("GROUPING") and self.peek(1).text.upper() == "SETS":
                self.next()
                self.next()
                self.expect_op("(")
                group_sets = []
                while True:
                    if self.accept_op("("):
                        one = []
                        while not self.at_op(")"):
                            one.append(self.parse_expr())
                            self.accept_op(",")
                        self.expect_op(")")
                        group_sets.append(one)
                    else:
                        group_sets.append([self.parse_expr()])
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            elif self._at_word("CUBE") and self.peek(1).text == "(":
                self.next()
                self.expect_op("(")
                cols = [self.parse_expr()]
                while self.accept_op(","):
                    cols.append(self.parse_expr())
                self.expect_op(")")
                group_sets = [[cols[i] for i in range(len(cols))
                               if mask & (1 << i)]
                              for mask in range(1 << len(cols))]
            elif self._at_word("ROLLUP") and self.peek(1).text == "(":
                self.next()
                self.expect_op("(")
                cols = [self.parse_expr()]
                while self.accept_op(","):
                    cols.append(self.parse_expr())
                self.expect_op(")")
                group_sets = [cols[:n] for n in range(len(cols), -1, -1)]
            else:
                while True:
                    group_by.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
        having = None
        if self.accept_keyword("HAVING"):
            having = self.parse_expr()
        named_windows = {}
        while self._at_word("WINDOW") and self.peek(1).kind == "IDENT":
            # WINDOW w AS (PARTITION BY ... ORDER BY ...) [, w2 AS (...)]*
            self.next()
            while True:
                wname = self.ident().lower()
                self.expect_keyword("AS")
                named_windows[wname] = self.parse_window_spec()
                if not self.accept_op(","):
                    break
        qualify = None
        if self._at_word("QUALIFY"):
            self.next()
            qualify = self.parse_expr()
        stmt = A.SelectStmt(items, from_, where, group_by, having, distinct,
                            group_sets, qualify, group_all)
        _resolve_named_windows(stmt, named_windows)
        return stmt

    def parse_select_item(self) -> A.SelectItem:
        if self.at_op("*"):
            self.next()
            return A.SelectItem(A.Star(None, self._parse_star_exclude(),
                                       self._parse_star_replace()))
        # t.* qualified star
        if (self.peek().kind == "IDENT" and self.peek(1).kind == "OP"
                and self.peek(1).text == "." and self.peek(2).kind == "OP"
                and self.peek(2).text == "*"):
            t = self.next().text
            self.next()
            self.next()
            return A.SelectItem(A.Star(t, self._parse_star_exclude(),
                                       self._parse_star_replace()))
        e = self.parse_expr()
        alias = None
        if self.accept_keyword("AS"):
            alias = self.ident()
        elif self.peek().kind == "IDENT":
            alias = self.next().text
        return A.SelectItem(e, alias)

    def parse_table_ref(self) -> A.TableRef:
        # explicit JOINs bind tighter than the comma cross-product:
        # `t0, t1 RIGHT JOIN t2 ON ...` is `t0 CROSS (t1 RIGHT JOIN t2)`
        left = self._parse_join_chain()
        while self.accept_op(","):
            right = self._parse_join_chain()
            left = A.Join("CROSS", left, right)
        return left

    def _parse_join_chain(self) -> A.TableRef:
        left = self.parse_table_factor()
        while True:
            if self.accept_keyword("CROSS"):
                self.expect_keyword("JOIN")
                right = self.parse_table_factor()
                left = A.Join("CROSS", left, right)
                continue
            kind = None
            natural = False
            if self._at_word("NATURAL"):
                natural = True
                self.next()
            if natural or self.at_keyword("INNER", "LEFT", "RIGHT", "FULL",
                                          "JOIN"):
                if self.accept_keyword("INNER"):
                    kind = "INNER"
                elif self.accept_keyword("LEFT"):
                    kind = "LEFT"
                    if self._at_word("SEMI"):
                        self.next()
                        kind = "SEMI"
                    elif self._at_word("ANTI"):
                        self.next()
                        kind = "ANTI"
                    else:
                        self.accept_keyword("OUTER")
                elif self.accept_keyword("RIGHT"):
                    kind = "RIGHT"
                    if self._at_word("SEMI"):
                        self.next()
                        kind = "RSEMI"
                    elif self._at_word("ANTI"):
                        self.next()
                        kind = "RANTI"
                    else:
                        self.accept_keyword("OUTER")
                elif self.accept_keyword("FULL"):
                    kind = "FULL"
                    self.accept_keyword("OUTER")
                else:
                    kind = "INNER"
                self.expect_keyword("JOIN")
                right = self.parse_table_factor()
                cond = None
                using: List[str] = []
                if not natural:
                    if self.accept_keyword("ON"):
                        cond = self.parse_expr()
                    elif self.accept_keyword("USING"):
                        self.expect_op("(")
                        using = [self.ident()]
                        while self.accept_op(","):
                            using.append(self.ident())
                        self.expect_op(")")
                left = A.Join(kind, left, right, cond, using,
                              natural=natural)
                continue
            break
        return left

    def parse_table_factor(self) -> A.TableRef:
        ref = self._parse_table_factor_base()
        if getattr(ref, "alias", None) and self.at_op("(") \
                and self.peek(1).kind == "IDENT" \
                and self.peek(2).text in (",", ")"):
            # column aliases on the table factor: t AS a(x, y)
            self.next()
            cols = [self.ident()]
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
            ref.column_aliases = cols
        while self._at_word("PIVOT", "UNPIVOT") and self.peek(1).text == "(":
            kind = self.next().text.upper()
            self.expect_op("(")
            if kind == "PIVOT":
                agg = self.ident()
                self.expect_op("(")
                value_col = self.ident()
                self.expect_op(")")
                if not self._at_word("FOR"):
                    self.error("expected FOR in PIVOT")
                self.next()
                for_col = self.ident()
                self.expect_keyword("IN")
                self.expect_op("(")
                vals = []
                in_subquery = None
                if self.at_keyword("SELECT", "WITH"):
                    # PIVOT ... IN (SELECT DISTINCT ...): dynamic pivot
                    # columns resolved at bind time
                    in_subquery = self.parse_query()
                else:
                    while not self.at_op(")"):
                        t = self.next()
                        vals.append(int(t.text) if t.kind == "INT"
                                    else t.text)
                        self.accept_op(",")
                self.expect_op(")")
                self.expect_op(")")
                ref = A.PivotRef(ref, agg, value_col, for_col, vals,
                                 self._table_alias())
                if in_subquery is not None:
                    ref.in_subquery = in_subquery
            else:
                value_name = self.ident()
                if not self._at_word("FOR"):
                    self.error("expected FOR in UNPIVOT")
                self.next()
                name_name = self.ident()
                self.expect_keyword("IN")
                self.expect_op("(")
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
                self.expect_op(")")
                ref = A.UnpivotRef(ref, value_name, name_name, cols,
                                   self._table_alias())
        return ref

    def _parse_table_factor_base(self) -> A.TableRef:
        if self._at_word("LATERAL"):
            # LATERAL <subquery or table function> (reference: lateral
            # derived tables / lateral flatten)
            self.next()
            ref = self._parse_table_factor_base()
            if isinstance(ref, (A.SubqueryRef, A.TableFunctionRef)):
                ref.lateral = True
            return ref
        if self.at_op("(") and self.peek(1).kind == "KEYWORD" \
                and self.peek(1).text == "VALUES":
            self.next()
            self.next()
            rows = []
            while True:
                self.expect_op("(")
                row = [self.parse_expr()]
                while self.accept_op(","):
                    row.append(self.parse_expr())
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            alias = None
            cols: list = []
            if self.accept_keyword("AS") or self.peek().kind == "IDENT":
                alias = self.ident()
                if self.accept_op("("):
                    cols = [self.ident()]
                    while self.accept_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
            return A.ValuesRef(rows, alias, cols)
        if self.peek().kind == "ATREF":
            ref = self.next().text
            options: dict = {}
            # @stage (file_format => 'csv', pattern => '*.csv')
            if self.at_op("(") and self.peek(1).kind in ("IDENT", "KEYWORD") \
                    and self.peek(2).kind == "OP" and self.peek(2).text == "=>":
                self.next()
                while not self.at_op(")"):
                    k = self.next().text.lower()
                    self.expect_op("=>")
                    options[k] = self.next().text
                    self.accept_op(",")
                self.expect_op(")")
            return A.StageRef(ref, options, self._table_alias())
        if self.accept_op("("):
            q = self.parse_query()
            self.expect_op(")")
            alias = self._table_alias()
            return A.SubqueryRef(q, alias)
        # table function: ident(...)
        if self.peek().kind == "IDENT" and self.peek(1).kind == "OP" and self.peek(1).text == "(":
            name = self.next().text
            self.expect_op("(")
            args: List[A.Expr] = []
            if not self.at_op(")"):
                args.append(self._parse_tf_arg())
                while self.accept_op(","):
                    args.append(self._parse_tf_arg())
            self.expect_op(")")
            return A.TableFunctionRef(name, args, self._table_alias())
        db, name = self.qualified_name()
        catalog = None
        if db is not None and self.accept_op("."):
            # catalog.db.table (reference multi-catalog name resolution)
            catalog, db, name = db, name, self.ident()
            if db == "":
                # `db`.``.`t`: an empty middle segment collapses to a
                # two-part name (reference quoted-identifier corpus)
                catalog, db = None, catalog
        at_snapshot = None
        if self.accept_keyword("AT"):
            at_snapshot = self.parse_travel_point()
        return A.TableName(name, db, self._table_alias(), at_snapshot,
                           catalog)

    def _parse_tf_arg(self) -> A.Expr:
        # named argument: ident => expr
        if self.peek().kind in ("IDENT", "KEYWORD") \
                and self.peek(1).kind == "OP" and self.peek(1).text == "=>":
            name = self.next().text.lower()
            self.next()
            return A.NamedArg(name, self.parse_expr())
        return self.parse_expr()

    def parse_travel_point(self):
        """AT (SNAPSHOT => 'id' | OFFSET => -n | TIMESTAMP => 'iso')"""
        self.expect_op("(")
        kw = self.next().text.upper()
        self.expect_op("=>")
        if kw == "SNAPSHOT":
            point = ("snapshot", self.next().text)
        elif kw == "OFFSET":
            sign = 1.0
            if self.at_op("-"):
                self.next()
                sign = -1.0
            point = ("offset", sign * float(self.next().text))
        elif kw == "TIMESTAMP":
            import datetime
            ts = datetime.datetime.fromisoformat(self.next().text)
            if ts.tzinfo is None:
                ts = ts.replace(tzinfo=datetime.timezone.utc)
            point = ("timestamp", ts.timestamp())
        else:
            raise self.error(f"expected SNAPSHOT/OFFSET/TIMESTAMP, got {kw}")
        self.expect_op(")")
        return point

    # non-reserved words that end a table factor (never implicit aliases)
    _ALIAS_STOP = {"QUALIFY", "PIVOT", "UNPIVOT", "SAMPLE", "MATCHED",
                   "WINDOW", "NATURAL"}

    def _table_alias(self) -> Optional[str]:
        if self.accept_keyword("AS"):
            return self.ident()
        if self.peek().kind == "IDENT" \
                and self.peek().text.upper() not in self._ALIAS_STOP:
            return self.next().text
        # AT is non-reserved: `(...) AT` is an alias unless it opens a
        # travel point `AT (` (TPC-DS q90 aliases a derived table "at")
        if self.peek().kind == "KEYWORD" and self.peek().text.upper() == "AT" \
                and not (self.peek(1).kind == "OP"
                         and self.peek(1).text == "("):
            return self.next().text
        return None

    # ------------------------------------------------------------ expressions
    def parse_expr(self, min_bp: int = 0) -> A.Expr:
        self._enter_nest()
        try:
            return self._parse_expr_inner(min_bp)
        finally:
            self._exit_nest()

    def _parse_expr_inner(self, min_bp: int = 0) -> A.Expr:
        lhs = self.parse_prefix()
        while True:
            lhs2 = self.parse_postfix(lhs, min_bp)
            if lhs2 is not None:
                lhs = lhs2
                continue
            t = self.peek()
            op = None
            if t.kind == "OP" and t.text in _BIN_POWER:
                op = t.text
            elif t.kind == "KEYWORD" and t.text in _BIN_POWER:
                op = t.text
            if op is None:
                break
            bp = _BIN_POWER[op]
            if bp < min_bp:
                break
            self.next()
            rhs = self.parse_expr(bp + 1)
            lhs = A.BinaryOp(op, lhs, rhs)
        return lhs

    def parse_postfix(self, lhs: A.Expr, min_bp: int) -> Optional[A.Expr]:
        # IS [NOT] NULL | [NOT] IN | [NOT] BETWEEN | [NOT] LIKE | :: | [...]
        if self.at_op("!") and self.peek(1).text != "=":
            self.next()  # postfix factorial (postgres-style `5!`)
            return A.FunctionCall("factorial", [lhs])
        if self.at_op("::"):
            self.next()
            return A.Cast(lhs, self.parse_type_name())
        if self.at_op(":") and isinstance(lhs, (A.ColumnRef, A.MapAccess)) \
                and self.peek(1).kind == "IDENT":
            # variant path sugar: payload:test == payload['test']
            # (reference semi-structured access)
            self.next()
            return A.MapAccess(lhs, A.Literal(self.ident()))
        if self.at_op("["):
            self.next()
            key = self.parse_expr()
            self.expect_op("]")
            return A.MapAccess(lhs, key)
        if self.at_keyword("IS") and min_bp <= 40:
            self.next()
            negated = bool(self.accept_keyword("NOT"))
            self.expect_keyword("NULL")
            return A.IsNull(lhs, negated)
        negated = False
        save = self.i
        if self.at_keyword("NOT") and min_bp <= 40:
            nxt = self.peek(1)
            if nxt.kind == "KEYWORD" and nxt.text in ("IN", "BETWEEN", "LIKE", "ILIKE", "REGEXP", "RLIKE"):
                self.next()
                negated = True
            else:
                return None
        if self.at_keyword("IN") and min_bp <= 40:
            self.next()
            self.expect_op("(")
            if self.at_keyword("SELECT", "WITH"):
                q = self.parse_query()
                self.expect_op(")")
                return A.InSubquery(lhs, q, negated)
            items = [self.parse_expr()]
            while self.accept_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            return A.InList(lhs, items, negated)
        if self.at_keyword("BETWEEN") and min_bp <= 40:
            self.next()
            low = self.parse_expr(41)
            self.expect_keyword("AND")
            high = self.parse_expr(41)
            return A.Between(lhs, low, high, negated)
        if negated and self.at_keyword("LIKE", "ILIKE", "REGEXP", "RLIKE"):
            op = self.next().text
            rhs = self.parse_expr(41)
            return A.UnaryOp("NOT", A.BinaryOp(op, lhs, rhs))
        if negated:
            self.i = save
        return None

    def parse_prefix(self) -> A.Expr:
        if self.at_op("{"):
            # {'k': v, ...} map literal (reference: map expressions)
            self.next()
            keys, values = [], []
            while not self.at_op("}"):
                keys.append(self.parse_expr())
                self.expect_op(":")
                values.append(self.parse_expr())
                if not self.accept_op(","):
                    break
            self.expect_op("}")
            return A.MapExpr(keys, values)
        if self.peek().kind == "VAR":
            name = self.next().text[1:]
            return A.FunctionCall("getvariable",
                                  [A.Literal(name)])
        t = self.peek()
        if t.kind == "INT":
            self.next()
            return A.Literal(int(t.text))
        if t.kind == "FLOAT":
            self.next()
            return A.Literal(float(t.text))
        if t.kind == "STRING":
            self.next()
            return A.Literal(t.text)
        if t.kind == "OP":
            if t.text == "(":
                self.next()
                if self.at_keyword("SELECT", "WITH"):
                    q = self.parse_query()
                    self.expect_op(")")
                    return A.ScalarSubquery(q)
                e = self.parse_expr()
                if self.accept_op(","):
                    items = [e, self.parse_expr()]
                    while self.accept_op(","):
                        items.append(self.parse_expr())
                    self.expect_op(")")
                    return A.Tuple_(items)
                self.expect_op(")")
                return e
            if t.text == "[":
                self.next()
                items: List[A.Expr] = []
                if not self.at_op("]"):
                    items.append(self.parse_expr())
                    while self.accept_op(","):
                        items.append(self.parse_expr())
                self.expect_op("]")
                # array literal: fold literal elements
                if all(isinstance(i, A.Literal) for i in items):
                    return A.Literal([i.value for i in items])
                return A.FunctionCall("array", items)
            if t.text in ("|/", "||/", "@", "~"):
                # postgres-style prefix math: |/ sqrt, ||/ cbrt, @ abs,
                # ~ bitwise not
                self.next()
                fn = {"|/": "sqrt", "||/": "cbrt", "@": "abs",
                      "~": "bit_not"}[t.text]
                return A.FunctionCall(fn, [self.parse_expr(65)])
            if t.text in ("-", "+"):
                self.next()
                operand = self.parse_expr(65)
                if t.text == "-" and isinstance(operand, A.Literal) and isinstance(operand.value, (int, float)):
                    return A.Literal(-operand.value)
                return A.UnaryOp(t.text, operand)
            if t.text == "*":
                self.next()
                return A.Star()
        if t.kind in ("KEYWORD", "IDENT") \
                and t.text.upper() in ("DATE", "TIMESTAMP", "TIMESTAMP_TZ") \
                and self.peek(1).kind == "STRING":
            # typed literals: DATE '2001-02-03' / TIMESTAMP '...' /
            # TIMESTAMP_TZ '...' (reference typed-literal syntax; tz
            # literals normalize to UTC and render with ' +0000')
            kind = self.next().text.upper()
            s = self.next().text
            if kind == "DATE":
                return A.Cast(A.Literal(s), "DATE")
            if kind == "TIMESTAMP":
                return A.Cast(A.Literal(s), "TIMESTAMP")
            return A.BinaryOp(
                "||", A.Cast(A.Cast(A.Literal(s), "TIMESTAMP"), "VARCHAR"),
                A.Literal(" +0000"))
        if t.kind == "KEYWORD":
            if t.text == "NOT":
                self.next()
                return A.UnaryOp("NOT", self.parse_expr(25))
            if t.text == "NULL":
                self.next()
                return A.Literal(None)
            if t.text in ("TRUE", "FALSE"):
                self.next()
                return A.Literal(t.text == "TRUE")
            if t.text in ("CAST", "TRY_CAST"):
                self.next()
                self.expect_op("(")
                e = self.parse_expr()
                self.expect_keyword("AS")
                tn = self.parse_type_name()
                self.expect_op(")")
                return A.Cast(e, tn, is_try=t.text == "TRY_CAST")
            if t.text == "CASE":
                return self.parse_case()
            if t.text == "EXISTS":
                self.next()
                self.expect_op("(")
                q = self.parse_query()
                self.expect_op(")")
                return A.Exists(q)
            if t.text in ("ANY", "ALL", "SOME") and self.peek(1).text == "(":
                self.next()
                self.expect_op("(")
                q = self.parse_query()
                self.expect_op(")")
                return A.AnyAllSubquery("ANY" if t.text != "ALL" else "ALL", q)
            if t.text == "INTERVAL":
                self.next()
                vt = self.next()
                if vt.kind == "STRING" and self.peek().kind != "IDENT":
                    # INTERVAL '1 day' / '2 hours' string form
                    parts = vt.text.split()
                    if len(parts) != 2:
                        self.error("expected INTERVAL '<n> <unit>'")
                    v, unit = parts[0], parts[1].rstrip("sS")
                else:
                    v, unit = vt.text, self.ident()
                return A.FunctionCall("interval", [A.Literal(v), A.Literal(unit)])
            # keywords that double as function names: if(...), left(...), replace(...)
            if (self.peek(1).kind == "OP" and self.peek(1).text == "("
                    and t.text in ("IF", "LEFT", "RIGHT", "REPLACE", "DATABASE",
                                   "VALUES", "INSERT", "LIKE", "ILIKE")):
                return self.parse_ident_expr_from(self.next().text)
            if t.text in NON_RESERVED:
                return self.parse_ident_expr()
        if t.kind == "PARAM" and t.text.startswith("$"):
            # $1, $2 ... positional columns of schemaless stage reads
            self.next()
            return A.ColumnRef(t.text)
        if t.kind == "PARAM" and t.text == "?":
            # positional prepared-statement parameter
            self.next()
            idx = self.param_count
            self.param_count += 1
            return A.Placeholder(idx)
        if t.kind == "IDENT":
            if t.text.upper() == "TRIM" and self.peek(1).text == "(" \
                    and (self.peek(2).text.upper() in ("BOTH", "LEADING",
                                                       "TRAILING")
                         or self.peek(2).kind == "STRING"):
                # ANSI TRIM([BOTH|LEADING|TRAILING] [chars] FROM s)
                save = self.i
                self.next()
                self.expect_op("(")
                kind = "BOTH"
                if self._at_word("BOTH", "LEADING", "TRAILING"):
                    kind = self.next().text.upper()
                chars = None
                if self.peek().kind == "STRING":
                    chars = A.Literal(self.next().text)
                if self._at_word("FROM"):
                    self.next()
                    s = self.parse_expr()
                    self.expect_op(")")
                    fn = {"BOTH": "trim_both", "LEADING": "trim_leading",
                          "TRAILING": "trim_trailing"}[kind]
                    return A.FunctionCall(fn, [s, chars or A.Literal(" ")])
                self.i = save  # plain trim('x') call: normal path
            if t.text.upper() == "POSITION" and self.peek(1).text == "(":
                # POSITION(needle IN haystack) -> position(haystack, needle)
                save = self.i
                self.next()
                self.expect_op("(")
                needle = self.parse_expr(41)  # above IN's binding power (40)
                if self.at_keyword("IN"):
                    self.next()
                    hay = self.parse_expr()
                    self.expect_op(")")
                    return A.FunctionCall("position", [needle, hay])
                self.i = save
            if t.text.upper() in ("EXTRACT", "DATE_PART") \
                    and self.peek(1).text == "(":
                self.next()
                self.expect_op("(")
                unit = self.next().text.lower().strip("'")
                if not self.accept_keyword("FROM"):
                    self.expect_op(",")  # date_part('year', e)
                e = self.parse_expr()
                self.expect_op(")")
                fn = {"year": "to_year", "month": "to_month",
                      "day": "to_day_of_month", "dow": "to_day_of_week",
                      "hour": "to_hour", "minute": "to_minute",
                      "second": "to_second"}.get(unit.strip("'"))
                if fn is None:
                    self.error(f"unsupported EXTRACT unit {unit!r}")
                return A.FunctionCall(fn, [e])
            return self.parse_ident_expr()
        self.error("expected expression")

    def parse_case(self) -> A.Expr:
        self.expect_keyword("CASE")
        operand = None
        if not self.at_keyword("WHEN"):
            operand = self.parse_expr()
        conditions, results = [], []
        while self.accept_keyword("WHEN"):
            conditions.append(self.parse_expr())
            self.expect_keyword("THEN")
            results.append(self.parse_expr())
        else_result = None
        if self.accept_keyword("ELSE"):
            else_result = self.parse_expr()
        self.expect_keyword("END")
        return A.Case(operand, conditions, results, else_result)

    def parse_ident_expr(self) -> A.Expr:
        return self.parse_ident_expr_from(self.ident())

    def parse_ident_expr_from(self, name: str) -> A.Expr:
        if self.at_op("("):
            self.next()
            distinct = bool(self.accept_keyword("DISTINCT"))
            args: List[A.Expr] = []
            if not self.at_op(")"):
                args.append(self.parse_expr())
                while self.accept_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
            params: List[Any] = []
            if self.at_op("("):
                # f(p1, ..)(args): parameterized aggregate, e.g.
                # quantile_cont(0.5)(v) (reference: agg function params)
                params = [a.value if isinstance(a, A.Literal) else a
                          for a in args]
                self.next()
                args = []
                if not self.at_op(")"):
                    args.append(self.parse_expr())
                    while self.accept_op(","):
                        args.append(self.parse_expr())
                self.expect_op(")")
            # agg(args) FILTER (WHERE cond) -> <agg>_if(args..., cond)
            # (reference: the FILTER clause lowered to the IF combinator)
            if self.peek().kind == "IDENT" \
                    and self.peek().text.upper() == "FILTER" \
                    and self.peek(1).text == "(":
                self.next()
                self.expect_op("(")
                self.expect_keyword("WHERE")
                cond = self.parse_expr()
                self.expect_op(")")
                base = name.lower()
                if base.endswith("_if") or base.endswith("_distinct"):
                    from ..errors import SemanticError
                    raise SemanticError(
                        "FILTER clause is not supported for aggregate"
                        " combinator")
                if base == "count":
                    if args and isinstance(args[0], A.Star):
                        args = []
                    return A.FunctionCall("count_if", args + [cond], distinct)
                return A.FunctionCall(base + "_if", args + [cond], distinct)
            window = None
            if self.peek().kind == "IDENT" and self.peek().text.upper() == "OVER":
                self.next()
                if self.peek().kind == "IDENT":
                    # OVER w: named window, resolved against the WINDOW
                    # clause at the end of parse_select
                    window = self.next().text.lower()
                else:
                    window = self.parse_window_spec()
            return A.FunctionCall(name.lower(), args, distinct, params,
                                  window)
        if self.at_op(".") and self.peek(1).kind == "PARAM" \
                and self.peek(1).text.startswith("$"):
            self.next()  # t.$1 positional column
            return A.ColumnRef(self.next().text, table=name)
        if self.peek().kind == "FLOAT" and self.peek().text.startswith("."):
            # `t1.1` — numeric member access is not valid (reference
            # raises a semantic error, not a parse error)
            from ..errors import SemanticError
            raise SemanticError(
                f"cannot access column {self.peek().text[1:]!r} of "
                f"{name!r} by number")
        if self.at_op(".") and (self.peek(1).kind == "IDENT"
                                or (self.peek(1).kind == "KEYWORD"
                                    and self.peek(1).text in NON_RESERVED)):
            self.next()
            col = self.ident()
            if self.at_op(".") and (self.peek(1).kind == "IDENT"
                                    or (self.peek(1).kind == "KEYWORD"
                                        and self.peek(1).text
                                        in NON_RESERVED)):
                # db.table.column (reference three-part column refs)
                self.next()
                c3 = self.ident()
                ref = A.ColumnRef(c3, table=col)
                ref.database = name
                return ref
            return A.ColumnRef(col, table=name)
        return A.ColumnRef(name)

    def parse_window_spec(self) -> A.WindowSpec:
        self.expect_op("(")
        spec = A.WindowSpec()
        if self.peek().kind == "IDENT" and self.peek().text.upper() == "PARTITION":
            self.next()
            self.expect_keyword("BY")
            spec.partition_by.append(self.parse_expr())
            while self.accept_op(","):
                spec.partition_by.append(self.parse_expr())
        if self.accept_keyword("ORDER"):
            self.expect_keyword("BY")
            spec.order_by.append(self.parse_order_by_expr())
            while self.accept_op(","):
                spec.order_by.append(self.parse_order_by_expr())
        if self._at_word("ROWS", "RANGE"):
            spec.frame_kind = self.next().text.lower()
            numeric = spec.frame_kind == "range"
            if self._at_word("BETWEEN"):
                self.next()
                start = self._parse_frame_bound(numeric)
                self.expect_keyword("AND")
                end = self._parse_frame_bound(numeric)
            else:
                start = self._parse_frame_bound(numeric)
                end = 0  # single-bound form: ... AND CURRENT ROW
            spec.frame = (start, end)
        self.expect_op(")")
        return spec

    def _parse_frame_bound(self, numeric: bool = False):
        """UNBOUNDED PRECEDING|FOLLOWING | CURRENT ROW | n PRECEDING|FOLLOWING
        -> None (unbounded) or signed offset (row count for ROWS, ORDER BY
        key delta for RANGE)."""
        if self._at_word("UNBOUNDED"):
            self.next()
            if not self._at_word("PRECEDING", "FOLLOWING"):
                self.error("expected PRECEDING/FOLLOWING")
            self.next()
            return None
        if self._at_word("CURRENT"):
            self.next()
            if not self._at_word("ROW"):
                self.error("expected ROW")
            self.next()
            return 0
        tok = self.next().text
        n = float(tok) if numeric else int(tok)
        if self._at_word("PRECEDING"):
            self.next()
            return -n
        if self._at_word("FOLLOWING"):
            self.next()
            return n
        self.error("expected PRECEDING/FOLLOWING")


def parse_sql(sql: str) -> A.Statement:
    try:
        return Parser(sql).parse()
    except RecursionError:
        # pathological nesting below the explicit nest guard can still
        # exhaust the Python stack (frames-per-level varies by clause);
        # surface it as the same clean syntax error the guard raises
        raise SyntaxException("query nesting too deep")


def parse_statements(sql: str) -> List[A.Statement]:
    """Split on top-level ';' and parse each statement."""
    out = []
    p = Parser(sql)
    try:
        while p.peek().kind != "EOF":
            out.append(p.parse_statement())
            while p.accept_op(";"):
                pass
    except RecursionError:
        raise SyntaxException("query nesting too deep")
    return out


def _resolve_named_windows(obj, windows) -> None:
    """Replace `OVER w` name placeholders with their WINDOW-clause specs
    (reference: named window binding in the select binder)."""
    import dataclasses
    if isinstance(obj, A.FunctionCall) and isinstance(obj.window, str):
        spec = windows.get(obj.window)
        if spec is None:
            raise SyntaxException(f"unknown window: {obj.window}")
        obj.window = spec
    if not dataclasses.is_dataclass(obj) or isinstance(obj, A.Query):
        return
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        vals = v if isinstance(v, (list, tuple)) else [v]
        for x in vals:
            if dataclasses.is_dataclass(x) and not isinstance(x, type):
                _resolve_named_windows(x, windows)
