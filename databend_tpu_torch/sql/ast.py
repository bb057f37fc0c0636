"""AST node definitions (reference: src/query/ast/src/ast/).

Plain dataclasses; statements and scalar expressions only — the binder
turns these into typed plans.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


# ----------------------------------------------------------------- expressions
class Expr:
    pass


@dataclass
class Literal(Expr):
    value: Any  # python int/float/str/bool/None/list

    def __repr__(self):
        return f"Lit({self.value!r})"


@dataclass
class Placeholder(Expr):
    """Positional `?` parameter of a prepared statement (0-based)."""
    index: int

    def __repr__(self):
        return f"Param(?{self.index})"


@dataclass
class ColumnRef(Expr):
    name: str
    table: Optional[str] = None

    def __repr__(self):
        return f"Col({self.table + '.' if self.table else ''}{self.name})"


@dataclass
class Star(Expr):
    table: Optional[str] = None
    exclude: List[str] = field(default_factory=list)  # SELECT * EXCLUDE (..)
    # SELECT * REPLACE (expr AS col, ..): substitute expr for column col
    replace: List[Tuple[str, Expr]] = field(default_factory=list)


@dataclass
class BinaryOp(Expr):
    op: str  # '+', '-', ..., 'AND', 'OR', '=', '<', 'LIKE', ...
    left: Expr
    right: Expr

    def __repr__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass
class UnaryOp(Expr):
    op: str  # '-', '+', 'NOT'
    operand: Expr


@dataclass
class FunctionCall(Expr):
    name: str
    args: List[Expr]
    distinct: bool = False
    params: List[Any] = field(default_factory=list)
    window: Optional["WindowSpec"] = None

    def __repr__(self):
        # DISTINCT must be part of the repr: the binder dedups aggregates
        # by AST repr, and count(x) != count(DISTINCT x)
        d = "DISTINCT " if self.distinct else ""
        return f"{self.name}({d}{', '.join(map(repr, self.args))})"


@dataclass
class WindowSpec:
    partition_by: List[Expr] = field(default_factory=list)
    order_by: List["OrderByExpr"] = field(default_factory=list)
    # frame: (start, end) where each bound is None (unbounded) or an
    # offset (negative = preceding, 0 = current row): row count for ROWS,
    # ORDER BY key delta for RANGE
    frame: Optional[Tuple[Optional[int], Optional[int]]] = None
    frame_kind: str = "rows"  # rows | range


@dataclass
class Cast(Expr):
    expr: Expr
    type_name: str
    is_try: bool = False


@dataclass
class Case(Expr):
    operand: Optional[Expr]
    conditions: List[Expr]
    results: List[Expr]
    else_result: Optional[Expr]


@dataclass
class InList(Expr):
    expr: Expr
    items: List[Expr]
    negated: bool = False


@dataclass
class InSubquery(Expr):
    expr: Expr
    query: "Query"
    negated: bool = False


@dataclass
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class IsNull(Expr):
    expr: Expr
    negated: bool = False


@dataclass
class Exists(Expr):
    query: "Query"
    negated: bool = False


@dataclass
class ScalarSubquery(Expr):
    query: "Query"


@dataclass
class AnyAllSubquery(Expr):
    """RHS of `x <op> ANY/ALL/SOME (subquery)`."""
    kind: str  # ANY | ALL
    query: "Query" = None


@dataclass
class MapExpr(Expr):
    """{'k': v, ...} map literal."""
    keys: List[Expr] = field(default_factory=list)
    values: List[Expr] = field(default_factory=list)


@dataclass
class NamedArg(Expr):
    """name => expr argument (table functions, stage options)."""
    name: str
    expr: Expr = None


@dataclass
class Tuple_(Expr):
    items: List[Expr]


@dataclass
class MapAccess(Expr):
    expr: Expr
    key: Expr  # index/key access a[1], m['k']


# ----------------------------------------------------------------- query parts
@dataclass
class OrderByExpr:
    expr: Expr
    asc: bool = True
    nulls_first: Optional[bool] = None


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class TableRef:
    pass


@dataclass
class TableName(TableRef):
    name: str
    database: Optional[str] = None
    alias: Optional[str] = None
    at_snapshot: Optional[str] = None  # AT (SNAPSHOT => '...')
    catalog: Optional[str] = None      # catalog.db.table (CREATE CATALOG)


@dataclass
class SubqueryRef(TableRef):
    query: "Query"
    alias: Optional[str] = None
    lateral: bool = False


@dataclass
class TableFunctionRef(TableRef):
    name: str
    args: List[Expr]
    alias: Optional[str] = None
    lateral: bool = False


@dataclass
class PivotRef(TableRef):
    """FROM t PIVOT(agg(value_col) FOR for_col IN (v1, v2, ...))"""
    inner: TableRef = None
    agg: str = "sum"
    value_col: str = ""
    for_col: str = ""
    in_values: List[object] = field(default_factory=list)
    alias: Optional[str] = None


@dataclass
class UnpivotRef(TableRef):
    """FROM t UNPIVOT(value_name FOR name_name IN (c1, c2, ...))"""
    inner: TableRef = None
    value_name: str = "value"
    name_name: str = "name"
    columns: List[str] = field(default_factory=list)
    alias: Optional[str] = None


@dataclass
class ValuesRef(TableRef):
    """FROM (VALUES (1,'a'), (2,'b')) AS v(x, y)"""
    rows: List[List[Expr]] = field(default_factory=list)
    alias: Optional[str] = None
    column_names: List[str] = field(default_factory=list)


@dataclass
class Join(TableRef):
    kind: str  # INNER | LEFT | RIGHT | FULL | CROSS
    left: TableRef
    right: TableRef
    condition: Optional[Expr] = None  # ON ...
    using: List[str] = field(default_factory=list)
    natural: bool = False  # NATURAL JOIN: using = common column names


@dataclass
class SelectStmt:
    items: List[SelectItem]
    from_: Optional[TableRef] = None
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    distinct: bool = False
    # GROUP BY GROUPING SETS/CUBE/ROLLUP: list of grouping sets, each a
    # list of exprs; None = plain GROUP BY
    group_sets: Optional[List[List[Expr]]] = None
    # QUALIFY <pred>: filter over window-function results
    qualify: Optional[Expr] = None
    # GROUP BY ALL: group by every non-aggregate select item
    group_all: bool = False


@dataclass
class SetOp:
    op: str  # UNION | UNION ALL | EXCEPT | INTERSECT
    left: "QueryBody"
    right: "QueryBody"


QueryBody = Any  # SelectStmt | SetOp | Query


@dataclass
class Query:
    body: QueryBody
    order_by: List[OrderByExpr] = field(default_factory=list)
    limit: Optional[Expr] = None
    offset: Optional[Expr] = None
    ctes: List[Tuple[str, "Query"]] = field(default_factory=list)
    recursive: bool = False  # WITH RECURSIVE


# ----------------------------------------------------------------- statements
class Statement:
    pass


@dataclass
class QueryStmt(Statement):
    query: Query


@dataclass
class ExplainStmt(Statement):
    inner: Statement
    analyze: bool = False
    kind: str = "PLAN"  # PLAN | ANALYZE | AST | RAW | PIPELINE


@dataclass
class ColumnDef:
    name: str
    type_name: str
    nullable: bool = True
    default: Optional[Expr] = None
    comment: Optional[str] = None
    # computed columns: (expression SQL, "STORED" | "VIRTUAL")
    computed: Optional[tuple] = None


@dataclass
class CreateDatabase(Statement):
    name: str
    if_not_exists: bool = False


@dataclass
class DropDatabase(Statement):
    name: str
    if_exists: bool = False


@dataclass
class UseDatabase(Statement):
    name: str


@dataclass
class CreateTable(Statement):
    name: str
    database: Optional[str]
    columns: List[ColumnDef]
    if_not_exists: bool = False
    cluster_by: List[Expr] = field(default_factory=list)
    engine: str = "FUSE"
    as_query: Optional[Query] = None
    options: Dict[str, str] = field(default_factory=dict)
    temporary: bool = False  # CREATE TEMP TABLE: session-scoped
    or_replace: bool = False  # CREATE OR REPLACE: drop existing first
    # inline index defs in the column list (reference: CREATE TABLE t(
    # ..., VECTOR INDEX idx (col) distance='cosine')): list of
    # (index_type, name, columns, options, sync)
    inline_indexes: List[Tuple] = field(default_factory=list)


@dataclass
class DropTable(Statement):
    name: str
    database: Optional[str] = None
    if_exists: bool = False
    all_: bool = False  # DROP TABLE ... ALL purges history


@dataclass
class TruncateTable(Statement):
    name: str
    database: Optional[str] = None


@dataclass
class RenameTable(Statement):
    name: str
    new_name: str
    database: Optional[str] = None


@dataclass
class FlashbackTable(Statement):
    """ALTER TABLE t FLASHBACK TO (SNAPSHOT => 'id' | OFFSET | TIMESTAMP)"""
    name: str
    point: tuple
    database: Optional[str] = None


@dataclass
class ShowCreateTable(Statement):
    name: str
    database: Optional[str] = None


@dataclass
class UndropTable(Statement):
    name: str
    database: Optional[str] = None


@dataclass
class MergeClause:
    matched: bool                      # WHEN [NOT] MATCHED
    condition: Optional[Expr]          # AND <cond>
    action: str                        # update | delete | insert
    # update: [(col, expr)]; insert: (cols or None, [exprs])
    assignments: List[Tuple[str, Expr]] = field(default_factory=list)
    insert_columns: Optional[List[str]] = None
    insert_values: List[Expr] = field(default_factory=list)


@dataclass
class MergeInto(Statement):
    target: str
    target_database: Optional[str]
    target_alias: Optional[str]
    source: "TableRef"
    on: Expr
    clauses: List[MergeClause] = field(default_factory=list)


@dataclass
class CreateTask(Statement):
    name: str
    schedule_secs: int
    sql_text: str
    if_not_exists: bool = False
    warehouse: Optional[str] = None
    cron: Optional[str] = None
    comment: Optional[str] = None
    after: List[str] = field(default_factory=list)  # task DAG edges
    when: Optional[str] = None  # boolean SQL guard
    suspend_after_failures: Optional[int] = None
    or_replace: bool = False


@dataclass
class DropTask(Statement):
    name: str
    if_exists: bool = False


@dataclass
class AlterTask(Statement):
    name: str
    action: str  # SUSPEND | RESUME


@dataclass
class ExecuteTask(Statement):
    name: str


@dataclass
class CreateView(Statement):
    """CREATE [OR REPLACE] VIEW v AS SELECT ... (stored as SQL text,
    expanded at bind time)."""
    name: str
    query_text: str
    database: Optional[str] = None
    or_replace: bool = False
    if_not_exists: bool = False


@dataclass
class DropView(Statement):
    name: str
    database: Optional[str] = None
    if_exists: bool = False


@dataclass
class CreateStream(Statement):
    """CREATE STREAM s ON TABLE t (CDC; reference src/query/storages/stream)"""
    name: str
    table: str
    table_database: Optional[str] = None
    database: Optional[str] = None
    if_not_exists: bool = False


@dataclass
class DropStream(Statement):
    name: str
    database: Optional[str] = None
    if_exists: bool = False


@dataclass
class CreateFunction(Statement):
    """CREATE FUNCTION f AS (x, y) -> <expr> (lambda UDF, reference
    interpreter_user_defined_function + bendpy UDF surface), or the
    external UDF-server form: CREATE FUNCTION f (INT, ...) RETURNS INT
    LANGUAGE python HANDLER='h' ADDRESS='grpc://...' (reference
    udf_server suites)."""
    name: str
    params: List[str]
    body: Optional["Expr"]
    body_text: str
    or_replace: bool = False
    if_not_exists: bool = False
    # external (UDF server) form
    arg_types: Optional[List[str]] = None
    return_type: Optional[str] = None
    language: Optional[str] = None
    handler: Optional[str] = None
    address: Optional[str] = None


@dataclass
class DropFunction(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CreateUser(Statement):
    name: str
    password: Optional[str] = None
    if_not_exists: bool = False


@dataclass
class DropUser(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CreateRole(Statement):
    name: str
    if_not_exists: bool = False


@dataclass
class DropRole(Statement):
    name: str
    if_exists: bool = False


@dataclass
class GrantRole(Statement):
    role: str
    user: str
    is_grant: bool = True


@dataclass
class GrantPrivileges(Statement):
    privileges: List[str]
    database: Optional[str]  # None = current db; "*" = all
    table: str               # "*" = all
    user: Optional[str] = None
    role: Optional[str] = None
    is_grant: bool = True


@dataclass
class ShowGrants(Statement):
    user: Optional[str] = None


@dataclass
class CopyIntoTable(Statement):
    """COPY INTO t FROM 'path'|@stage FILE_FORMAT=(...) PATTERN='...'"""
    table: str
    database: Optional[str]
    src: str  # filesystem path/glob, or a '@stage[/path]' reference
    file_format: Dict[str, str] = field(default_factory=dict)
    pattern: Optional[str] = None
    files: Optional[List[str]] = None  # FILES=('a.csv', ...)
    force: bool = False  # FORCE=TRUE reloads already-copied stage files


@dataclass
class CopyIntoLocation(Statement):
    """COPY INTO 'path' FROM t | (query) FILE_FORMAT=(...)"""
    dst: str
    table: Optional[str] = None
    database: Optional[str] = None
    query: Optional["Query"] = None
    file_format: Dict[str, str] = field(default_factory=dict)


@dataclass
class CreateIndex(Statement):
    """CREATE [VECTOR|INVERTED|NGRAM] INDEX idx ON t(cols) opt=val ..."""

    index_type: str  # VECTOR | INVERTED | NGRAM
    name: str
    table: str
    database: Optional[str]
    columns: List[str]
    options: Dict[str, str] = field(default_factory=dict)
    if_not_exists: bool = False
    sync: bool = True


@dataclass
class CreateAggregatingIndex(Statement):
    """CREATE AGGREGATING INDEX idx AS SELECT .. GROUP BY ..
    (reference TableIndexType::Aggregating + agg_index pushdown)."""

    name: str
    query: Query
    definition: str  # the AS SELECT text, for SHOW/system.indexes
    if_not_exists: bool = False
    sync: bool = True


@dataclass
class DropIndex(Statement):
    index_type: str
    name: str
    table: Optional[str] = None
    if_exists: bool = False


@dataclass
class RefreshIndex(Statement):
    index_type: str
    name: str
    table: Optional[str] = None


@dataclass
class RefreshVirtualColumn(Statement):
    """REFRESH VIRTUAL COLUMN FOR t (EE; reference
    RefreshVirtualColumnStmt)."""
    table: str


@dataclass
class Insert(Statement):
    table: str
    database: Optional[str]
    columns: List[str]
    values: Optional[List[List[Expr]]] = None
    query: Optional[Query] = None
    overwrite: bool = False


@dataclass
class MultiInsertBranch:
    condition: Optional[Expr]  # None = unconditional / ELSE
    table: str = ""
    database: Optional[str] = None
    columns: List[str] = field(default_factory=list)
    values: Optional[List[Expr]] = None  # None = pass source row through


@dataclass
class MultiInsert(Statement):
    """INSERT ALL/FIRST [WHEN .. THEN] INTO .. SELECT (multi-table
    insert)."""
    first: bool
    branches: List[MultiInsertBranch] = field(default_factory=list)
    else_branches: List[MultiInsertBranch] = field(default_factory=list)
    query: "Query" = None
    overwrite: bool = False


@dataclass
class Delete(Statement):
    table: str
    database: Optional[str] = None
    where: Optional[Expr] = None


@dataclass
class Update(Statement):
    table: str
    database: Optional[str]
    assignments: List[Tuple[str, Expr]]
    where: Optional[Expr] = None


@dataclass
class ShowStmt(Statement):
    what: str  # TABLES | DATABASES | SETTINGS | INDEXES | FUNCTIONS
    from_db: Optional[str] = None
    like: Optional[str] = None


@dataclass
class DescribeTable(Statement):
    name: str
    database: Optional[str] = None


@dataclass
class SetSetting(Statement):
    name: str
    value: Any
    is_global: bool = False


@dataclass
class AnalyzeTable(Statement):
    name: str
    database: Optional[str] = None


@dataclass
class OptimizeTable(Statement):
    name: str
    database: Optional[str] = None
    action: str = "COMPACT"  # COMPACT | PURGE


@dataclass
class VacuumTable(Statement):
    name: str
    database: Optional[str] = None


# -------------------------------------------------------------- alter table
@dataclass
class AddColumn(Statement):
    table: str
    database: Optional[str]
    column: "ColumnDef"
    if_not_exists: bool = False


@dataclass
class DropColumn(Statement):
    table: str
    database: Optional[str]
    column: str
    if_exists: bool = False


@dataclass
class RenameColumn(Statement):
    table: str
    database: Optional[str]
    old: str
    new: str


# ------------------------------------------------------- policies (EE)
@dataclass
class CreateMaskingPolicy(Statement):
    """CREATE MASKING POLICY p AS (val T) RETURNS T -> <expr>"""
    name: str
    arg_name: str
    arg_type: str
    ret_type: str
    body_sql: str
    comment: str = ""
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class DropMaskingPolicy(Statement):
    name: str
    if_exists: bool = False


@dataclass
class DescMaskingPolicy(Statement):
    name: str


@dataclass
class CreateRowAccessPolicy(Statement):
    """CREATE ROW ACCESS POLICY p AS (c1 T1, ...) RETURNS BOOLEAN -> <expr>"""
    name: str
    args: List[tuple] = field(default_factory=list)  # [(name, type_sql)]
    body_sql: str = ""
    comment: str = ""
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class DropRowAccessPolicy(Statement):
    name: str
    if_exists: bool = False


@dataclass
class SetColumnMaskingPolicy(Statement):
    """ALTER TABLE t MODIFY COLUMN c SET MASKING POLICY p | UNSET ..."""
    table: str
    database: Optional[str]
    column: str
    policy: Optional[str]  # None = UNSET


@dataclass
class SetTableRowAccessPolicy(Statement):
    """ALTER TABLE t ADD ROW ACCESS POLICY p ON (c1,...) | DROP ... p"""
    table: str
    database: Optional[str]
    policy: Optional[str]
    columns: List[str] = field(default_factory=list)
    drop: bool = False


@dataclass
class AttachTable(Statement):
    """ATTACH TABLE [db.]name 'location' — read-only view of another
    table's storage (reference EE attach table)."""
    name: str
    database: Optional[str]
    location: str


# ------------------------------------------------- network/password policies
@dataclass
class CreateNetworkPolicy(Statement):
    name: str
    allowed: List[str] = field(default_factory=list)
    blocked: List[str] = field(default_factory=list)
    comment: str = ""
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class DropNetworkPolicy(Statement):
    name: str
    if_exists: bool = False


@dataclass
class DescNetworkPolicy(Statement):
    name: str


@dataclass
class CreatePasswordPolicy(Statement):
    name: str
    options: Dict[str, int] = field(default_factory=dict)
    comment: str = ""
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class DropPasswordPolicy(Statement):
    name: str
    if_exists: bool = False


@dataclass
class DescPasswordPolicy(Statement):
    name: str


@dataclass
class AlterUser(Statement):
    """ALTER USER u [IDENTIFIED BY 'pw'] [WITH SET NETWORK POLICY='np' |
    UNSET NETWORK POLICY | SET PASSWORD POLICY='pp' | UNSET ...]"""
    name: str
    password: Optional[str] = None
    network_policy: object = ...   # ... = unchanged, None = unset
    password_policy: object = ...


@dataclass
class BeginTxn(Statement):
    pass


@dataclass
class CommitTxn(Statement):
    pass


@dataclass
class RollbackTxn(Statement):
    pass


@dataclass
class ReplaceInto(Statement):
    """REPLACE INTO t [(cols)] ON (k1[, k2]) VALUES ... | <query>"""
    table: str
    database: Optional[str] = None
    columns: List[str] = field(default_factory=list)
    on_keys: List[str] = field(default_factory=list)
    values: Optional[List[List[Expr]]] = None
    query: Optional[Query] = None


@dataclass
class CreateConnection(Statement):
    """CREATE CONNECTION c STORAGE_TYPE='s3' <param>=<value> ..."""
    name: str
    storage_type: str = "s3"
    params: Dict[str, str] = field(default_factory=dict)
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class DropConnection(Statement):
    name: str
    if_exists: bool = False


@dataclass
class DescConnection(Statement):
    name: str


@dataclass
class SetVariable(Statement):
    """SET VARIABLE x = <const expr> (session variables, $x access)."""
    name: str
    value: Expr = None


@dataclass
class UnsetVariable(Statement):
    name: str


@dataclass
class UnsetSetting(Statement):
    name: str


@dataclass
class SetTableComment(Statement):
    """ALTER TABLE t COMMENT = '...'"""
    table: str
    database: Optional[str] = None
    comment: str = ""


@dataclass
class CreateCatalog(Statement):
    """CREATE CATALOG c TYPE=ICEBERG CONNECTION=(URL='...') (reference
    CatalogManager + iceberg/hive catalogs, src/query/catalog)."""
    name: str
    catalog_type: str = "ICEBERG"
    options: Dict[str, str] = field(default_factory=dict)
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class DropCatalog(Statement):
    name: str
    if_exists: bool = False


@dataclass
class ShowCatalogs(Statement):
    pass


@dataclass
class KillStmt(Statement):
    """KILL [QUERY|CONNECTION] <id>"""
    target: str  # QUERY | CONNECTION
    object_id: str = ""


# ---------------------------------------------------- prepared statements
@dataclass
class PrepareStmt(Statement):
    """PREPARE name FROM '<sql with ? placeholders>'"""
    name: str
    sql: str


@dataclass
class ExecutePrepared(Statement):
    """EXECUTE name [USING (p1, p2, ...)]"""
    name: str
    params: List[Expr] = field(default_factory=list)


@dataclass
class DeallocateStmt(Statement):
    """DEALLOCATE [PREPARE] name"""
    name: str


# ---------------------------------------------------------------- procedures
@dataclass
class CreateProcedure(Statement):
    """CREATE PROCEDURE p(a INT, ...) AS $$ <script> $$"""
    name: str
    args: List[tuple] = field(default_factory=list)  # [(name, type_sql)]
    body: str = ""
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class DropProcedure(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CallProcedure(Statement):
    name: str
    args: List[Expr] = field(default_factory=list)


# -------------------------------------------------------------- dictionaries
@dataclass
class CreateDictionary(Statement):
    """CREATE DICTIONARY d (cols) PRIMARY KEY k SOURCE(kind(opts))"""
    name: str
    columns: List["ColumnDef"] = field(default_factory=list)
    primary_key: str = ""
    source_kind: str = ""  # TABLE | MYSQL | REDIS
    source_opts: Dict[str, str] = field(default_factory=dict)
    comment: str = ""
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class DropDictionary(Statement):
    name: str
    if_exists: bool = False


@dataclass
class ShowCreateDictionary(Statement):
    name: str


# ---------------------------------------------------------------- sequences
@dataclass
class CreateSequence(Statement):
    """CREATE SEQUENCE s [START = n] [INCREMENT = n] [COMMENT = '...']"""
    name: str
    start: int = 1
    step: int = 1
    comment: str = ""
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class DropSequence(Statement):
    name: str
    if_exists: bool = False


@dataclass
class DescSequence(Statement):
    name: str


# --------------------------------------------------------------- warehouses
@dataclass
class CreateWarehouse(Statement):
    """CREATE WAREHOUSE w [WITH warehouse_size='..' ...] (reference
    src/query/management/src/warehouse, ee resource_management)."""
    name: str
    options: Dict[str, str] = field(default_factory=dict)
    if_not_exists: bool = False


@dataclass
class CreateWorkloadGroup(Statement):
    """CREATE WORKLOAD GROUP g [WITH max_concurrency=.. memory_quota=..
    query_timeout=..] (reference: ee resource_management workload
    groups)."""
    name: str
    options: Dict[str, str] = field(default_factory=dict)
    if_not_exists: bool = False


@dataclass
class AlterWorkloadGroup(Statement):
    name: str
    options: Dict[str, str] = field(default_factory=dict)


@dataclass
class DropWorkloadGroup(Statement):
    name: str
    if_exists: bool = False


@dataclass
class DropWarehouse(Statement):
    name: str
    if_exists: bool = False


@dataclass
class AlterWarehouse(Statement):
    name: str
    action: str  # SUSPEND | RESUME


@dataclass
class UseWarehouse(Statement):
    name: str


# ------------------------------------------------------------------- stages
@dataclass
class CreateStage(Statement):
    """CREATE STAGE s [URL='...'] [CONNECTION=(...)] [FILE_FORMAT=(...)]
    [COMMENT='...']"""
    name: str
    url: Optional[str] = None
    file_format: Dict[str, str] = field(default_factory=dict)
    comment: str = ""
    if_not_exists: bool = False
    or_replace: bool = False
    connection: Dict[str, str] = field(default_factory=dict)


@dataclass
class DropStage(Statement):
    name: str
    if_exists: bool = False


@dataclass
class DescStage(Statement):
    name: str


@dataclass
class ListStage(Statement):
    """LIST @stage[/path] [PATTERN = '...']"""
    ref: str
    pattern: Optional[str] = None


@dataclass
class RemoveStage(Statement):
    ref: str
    pattern: Optional[str] = None


@dataclass
class PresignStage(Statement):
    """PRESIGN [DOWNLOAD|UPLOAD] @stage/file [EXPIRE = n]"""
    ref: str
    method: str = "DOWNLOAD"
    expire_secs: int = 3600


@dataclass
class StageRef(TableRef):
    """SELECT ... FROM @stage[/path] [(file_format => 'csv', ...)]"""
    ref: str
    options: Dict[str, str] = field(default_factory=dict)
    alias: Optional[str] = None
