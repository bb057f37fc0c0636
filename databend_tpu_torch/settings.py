"""Session settings with defaults and ranges.

Analog of the reference's 221-setting registry
(reference: src/query/settings/src/settings_default.rs). The subset here is
what the TPU engine actually consults; unknown settings raise like the
reference's UnknownSetting.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from .errors import UnknownSetting, WrongValueForSetting


@dataclass
class SettingDef:
    name: str
    default: Any
    desc: str
    range: Optional[Tuple[Any, Any]] = None


DEFAULT_SETTINGS: Dict[str, SettingDef] = {
    s.name: s for s in [
        SettingDef("max_threads", 8, "host-side parallelism for IO stages", (1, 1024)),
        SettingDef("max_block_size", 262144, "max rows per processed block", (1, 1 << 24)),
        SettingDef("max_memory_usage", 0, "query memory limit in bytes (0=unlimited)"),
        SettingDef("enable_distributed_pruning", True,
                   "shard segment pruning across the mesh (reference settings_default.rs:1470)"),
        SettingDef("hnsw_ef_search_scale", 4,
                   "ef = scale * limit for HNSW search (reference hnsw.rs:108)", (1, 64)),
        SettingDef("vector_search_mode", "auto",
                   "per-block KNN strategy: auto = exact scan for blocks"
                   " up to vector_exact_scan_max_rows (faster AND exact on"
                   " the card), hnsw = always graph search, exact = always"
                   " scan"),
        SettingDef("vector_exact_scan_max_rows", 1 << 20,
                   "auto mode: blocks with at most this many rows use the"
                   " exact scan instead of HNSW (H100: a top-10 over 1M"
                   " rows in blocks of 65,536 to 1,048,576 takes 9-18 ms"
                   " exact, 71-529 ms through the graphs at ef = 40)",
                   (0, 1 << 40)),
        SettingDef("vector_host_scan_max_rows", 1 << 16,
                   "corpora at or below this many total rows are scored on"
                   " the host (numpy): on an H100 the host scan wins at"
                   " 4,096 rows, splits the runs at 16,384 and loses"
                   " 2.7-3.2x at 65,536", (0, 1 << 40)),
        SettingDef("vector_search_bf16", True,
                   "score candidates in bfloat16 on the MXU (exact rerank keeps recall)"),
        SettingDef("enable_vector_index", True, "use HNSW indexes for KNN queries"),
        SettingDef("enable_inverted_index", True, "use inverted indexes for match()/query()"),
        SettingDef("enable_bloom_filter_index", True, "bloom-prune point predicates"),
        SettingDef("enable_range_index", True, "zone-map pruning"),
        SettingDef("timezone", "UTC", "session timezone"),
        SettingDef("sql_dialect", "databend", "SQL dialect"),
        SettingDef("query_result_cache_ttl_secs", 0, "result cache TTL (0=off)"),
        SettingDef("enable_query_profiling", False, "collect per-operator timings"),
        SettingDef("otlp_export_path", "",
                   "append OTLP/JSON trace requests per query to this file"
                   " (reference src/common/tracing OTLP export; empty=off)"),
        SettingDef("enable_distributed_execution", False,
                   "run group-by/top-n/broadcast-join through the mesh"
                   " exchange operators (reference fragmenter.rs Shuffle/"
                   "Merge/Expansive exchanges as XLA collectives)"),
        SettingDef("enable_device_local_execution", True,
                   "route eligible Scan->Filter->Aggregate fragments onto"
                   " the accelerator as one XLA program over HBM-resident"
                   " table columns (single-chip analog of the reference's"
                   " N-worker pipeline executor, query_pipeline_executor"
                   ".rs:62; see pipeline/device_scan_agg.py)"),
        SettingDef("device_scan_agg_min_rows", 300_000,
                   "table row count below which scan-aggregates stay on the"
                   " host (H100, TPC-H lineitem: from 300k rows the warm"
                   " routed statement beats the host in every shape swept,"
                   " 1.3-7x; at 60k and 120k rows q3 or q10 lost a run)",
                   (0, 1 << 40)),
        SettingDef("device_scan_agg_max_groups", 16,
                   "group-grid ceiling for the mask engine (the grouped-sum"
                   " kernel, MIN/MAX by per-group atomics); above it the"
                   " sort engine takes the grid (H100, 6M rows: at 12-512"
                   " groups the mask engine's MIN/MAX ran 1.3-2.2x slower"
                   " than the sort engine's)", (0, 1 << 20)),
        SettingDef("device_scan_agg_max_groups_matmul", 16,
                   "group-grid ceiling for the matmul engine (the grouped-"
                   "sum kernel over lo/hi value rows, no MIN/MAX) above"
                   " device_scan_agg_max_groups (H100, 6M rows: the sort"
                   " engine was as fast from 12 groups on)", (0, 1 << 24)),
        SettingDef("spill_storage_location", "",
                   "where sort/aggregate/join spills go: '' = local"
                   " tempdir (disk spill); an operator URI prefix"
                   " (s3://bucket/spill, memory://spill) spills through"
                   " the object-store DataOperator instead (reference"
                   " spillers/inner.rs:269 — stateless query nodes)"),
        SettingDef("device_join_build_max_rows", 4_000_000,
                   "row cap for the host-materialized dimension side of"
                   " the device join-aggregate route (J1 enrichment"
                   " LUT builds are O(dim rows))", (0, 1 << 32)),
        SettingDef("device_scan_agg_max_groups_sort", 1 << 22,
                   "group-grid ceiling for the sort grouping engine"
                   " (a device sort by group id + segment prefix-sums;"
                   " covers huge grids, MIN/MAX beyond the mask cap, and"
                   " COUNT(DISTINCT)); H100, 6M rows: at 4,194,304 groups"
                   " it still beats the host 2.4-3.2x", (0, 1 << 24)),
        SettingDef("device_scan_agg_max_pull_mb", 64,
                   "un-fused grid-result transfer budget in MB: a device"
                   " scan/join-aggregate whose [K, G] grid pull would"
                   " exceed this bails to the host (H100: a 64 MB pull at"
                   " 4,194,304 groups still beats the host 2.4-2.7x)."
                   " HAVING/ORDER BY/LIMIT fused finalize (device_fusion)"
                   " is exempt — it only pulls the selected rows. 0"
                   " disables the screen", (0, 1 << 20)),
        SettingDef("enable_cbo", True,
                   "cost-based optimizer: filter pushdown + DP join"
                   " reordering (reference optimizers/{cascades,hyper_dp})"),
        SettingDef("sort_spill_row_threshold", 8_000_000,
                   "rows above which ORDER BY spills sorted runs to disk "
                   "(reference sort_spill.rs); 0 disables spilling", (0, 1 << 40)),
        SettingDef("aggregate_spill_row_threshold", 8_000_000,
                   "buffered input rows above which GROUP BY hash-partitions"
                   " its input to disk and aggregates partition-by-partition"
                   " (reference spillers/inner.rs:269); 0 disables", (0, 1 << 40)),
        SettingDef("window_spill_row_threshold", 8_000_000,
                   "input rows above which window functions hash-partition"
                   " the input to disk on PARTITION BY keys and window each"
                   " partition independently (reference window_partition"
                   " spill); 0 disables", (0, 1 << 40)),
        SettingDef("join_spill_row_threshold", 8_000_000,
                   "build-side rows above which a hash join grace-partitions"
                   " both sides to disk and joins per partition"
                   " (reference spillers/inner.rs:269); 0 disables", (0, 1 << 40)),
        # ---- consulted by the engine (wired) --------------------------------
        SettingDef("max_result_rows", 0,
                   "truncate query results to this many rows (0=unlimited)",
                   (0, 1 << 40)),
        SettingDef("max_execute_time_in_seconds", 0,
                   "abort a query running longer than this (0=unlimited);"
                   " checked between pipeline blocks", (0, 1 << 31)),
        SettingDef("hide_options_in_show_create_table", True,
                   "omit engine/storage options from SHOW CREATE TABLE"),
        SettingDef("disable_join_reorder", False,
                   "keep joins in the written FROM order (skip the CBO's DP"
                   " join reordering)"),
        SettingDef("enable_dphyp", True,
                   "use the DP join reorderer when the CBO is on"
                   " (reference optimizers/hyper_dp)"),
        SettingDef("enable_top_n", True,
                   "allow the TopN block pruner for ORDER BY .. LIMIT"),
        SettingDef("data_retention_time_in_days", 1,
                   "VACUUM keeps snapshots newer than this", (0, 90)),
        SettingDef("max_running_queries", 0,
                   "admission control: queries executing concurrently per"
                   " server (0=unlimited; reference queue_mgr.rs)", (0, 1024)),
        SettingDef("enable_aggregating_index_scan", True,
                   "answer eligible aggregates from the aggregating index"),
        SettingDef("enable_decimal_sum_widening", False,
                   "widen SUM over Decimal(19..38, s) to Decimal(76, s)"
                   " (reference settings_default.rs:1297)"),
        # ---- accepted for client compatibility (reference defaults;"
        # advisory until the matching subsystem consults them) --------------
        SettingDef("max_block_bytes", 50 * 1024 * 1024,
                   "max bytes per processed block", (1, 1 << 40)),
        SettingDef("week_start", 1, "first day of week: 0=Sunday 1=Monday",
                   (0, 1)),
        SettingDef("date_format_style", "mysql",
                   "TO_DATE/TO_TIMESTAMP format style: mysql | oracle"),
        SettingDef("parquet_max_block_size", 8192,
                   "max rows per parquet-read block", (1, 1 << 24)),
        SettingDef("max_storage_io_requests", 48,
                   "concurrent storage IO requests", (1, 1024)),
        SettingDef("storage_read_buffer_size", 1 << 20,
                   "read buffer bytes for storage IO", (1 << 10, 1 << 30)),
        SettingDef("input_read_buffer_size", 4 * 1024 * 1024,
                   "read buffer bytes for COPY input", (1 << 10, 1 << 30)),
        SettingDef("purge_duplicated_files_in_copy", False,
                   "purge duplicated files during COPY"),
        SettingDef("unquoted_ident_case_sensitive", False,
                   "treat unquoted identifiers as case-sensitive"),
        SettingDef("quoted_ident_case_sensitive", True,
                   "treat quoted identifiers as case-sensitive"),
        SettingDef("collation", "utf8", "string collation: utf8 | binary"),
        SettingDef("max_inlist_to_or", 1024,
                   "IN lists up to this length expand to ORs", (1, 1 << 20)),
        SettingDef("enable_cse_optimizer", True,
                   "common-subexpression elimination in the optimizer"),
        SettingDef("force_eager_aggregate", False,
                   "push aggregation below joins when possible"),
        SettingDef("max_push_down_limit", 10000,
                   "largest LIMIT pushed into scans", (0, 1 << 31)),
        SettingDef("prefer_broadcast_join", True,
                   "prefer broadcast over shuffle for small build sides"),
        SettingDef("enforce_broadcast_join", False,
                   "always use broadcast join in distributed plans"),
        SettingDef("enforce_shuffle_join", False,
                   "always use shuffle join in distributed plans"),
        SettingDef("nested_loop_join_threshold", 256,
                   "build-side rows below which nested-loop join is allowed",
                   (0, 1 << 31)),
        SettingDef("enable_bloom_runtime_filter", True,
                   "build bloom runtime filters from join build sides"),
        SettingDef("enable_join_runtime_filter", True,
                   "runtime min/max filters from join build sides"),
        SettingDef("storage_fetch_part_num", 2,
                   "partitions fetched per storage read batch", (1, 64)),
        SettingDef("load_file_metadata_expire_hours", 24,
                   "COPY file-dedup metadata retention", (0, 1 << 16)),
        SettingDef("enable_planner_cache", True,
                   "cache bound plans keyed on SQL + schema versions"),
        SettingDef("enable_query_result_cache", False,
                   "serve identical queries from the result cache"
                   " (query_result_cache_ttl_secs sets freshness)"),
        SettingDef("query_result_cache_max_bytes", 1048576,
                   "per-result cache size ceiling", (0, 1 << 40)),
        SettingDef("query_result_cache_allow_inconsistent", False,
                   "serve cached results even if the table changed"),
        SettingDef("aggregate_spilling_memory_ratio", 0,
                   "percent of memory at which aggregation spills (0=use"
                   " aggregate_spill_row_threshold)", (0, 100)),
        SettingDef("join_spilling_memory_ratio", 60,
                   "percent of memory at which joins spill", (0, 100)),
        SettingDef("sort_spilling_memory_ratio", 60,
                   "percent of memory at which sorts spill", (0, 100)),
        SettingDef("window_partition_spilling_memory_ratio", 60,
                   "percent of memory at which window partitions spill",
                   (0, 100)),
        SettingDef("window_num_partitions", 256,
                   "hash partitions for window spilling", (1, 1 << 16)),
        SettingDef("lazy_read_threshold", 1000,
                   "LIMIT under which non-filter columns are read lazily",
                   (0, 1 << 31)),
        SettingDef("parquet_fast_read_bytes", 16 * 1024 * 1024,
                   "parquet files under this size are read whole",
                   (0, 1 << 40)),
        SettingDef("enable_table_lock", True, "table locks for DML"),
        SettingDef("table_lock_expire_secs", 30,
                   "table lock lease seconds", (1, 1 << 16)),
        SettingDef("acquire_lock_timeout", 30,
                   "seconds to wait for a table lock", (1, 1 << 16)),
        SettingDef("deduplicate_label", "",
                   "idempotency label for INSERT/COPY"),
        SettingDef("enable_distributed_copy_into", True,
                   "distribute COPY across the mesh when available"),
        SettingDef("enable_distributed_merge_into", True,
                   "distribute MERGE INTO when available"),
        SettingDef("enable_distributed_compact", True,
                   "distribute table compaction when available"),
        SettingDef("enable_analyze_histogram", True,
                   "ANALYZE builds equi-height histograms"),
        SettingDef("analyze_histogram_buckets", 100,
                   "buckets per ANALYZE histogram", (1, 1 << 16)),
        SettingDef("max_cte_recursive_depth", 1000,
                   "recursion ceiling for RECURSIVE CTEs", (1, 1 << 20)),
        SettingDef("enable_materialized_cte", True,
                   "materialize WITH subqueries referenced more than once"),
        SettingDef("group_by_shuffle_mode", "before_merge",
                   "distributed GROUP BY shuffle stage: before_partial |"
                   " before_merge"),
        SettingDef("query_tag", "", "free-form tag recorded in query_log"),
        SettingDef("statement_queued_timeout_in_seconds", 60,
                   "seconds a query may wait in the admission queue",
                   (0, 1 << 16)),
        SettingDef("enterprise_license", "builtin-dev",
                   "license key gating EE features (reference license.rs);"
                   " 'builtin-dev' = all features (dev build), '' = none,"
                   " or a comma-separated feature allowlist"),
        # ---- compatibility tranche (reference settings_default.rs): each
        # accepted with the reference's default/range; ones the engine
        # consults say so in the description
        SettingDef("query_result_cache_min_execute_secs", 0,
                   "only cache queries at least this slow", (0, 1 << 20)),
        SettingDef("nulls_last", True, "default NULLS ordering in ORDER BY"),
        SettingDef("join_spilling_partition_bits", 4,
                   "log2 grace-join partitions", (0, 10)),
        SettingDef("sort_spilling_batch_bytes", 8388608,
                   "spill run target bytes", (1 << 10, 1 << 34)),
        SettingDef("force_sort_data_spill", False,
                   "spill every sort run (test hook)"),
        SettingDef("force_aggregate_data_spill", False,
                   "spill every aggregate (test hook)"),
        SettingDef("force_join_data_spill", False,
                   "spill every join build (test hook)"),
        SettingDef("grouping_sets_to_union", False,
                   "rewrite GROUPING SETS to UNION ALL"),
        SettingDef("inlist_to_join_threshold", 1024,
                   "IN lists longer than this become joins", (1, 1 << 31)),
        SettingDef("numeric_cast_option", "rounding",
                   "numeric cast behavior: rounding | truncating"),
        SettingDef("geometry_output_format", "WKT",
                   "geometry render format (WKT here; reference adds WKB/json)"),
        SettingDef("enable_strict_datetime_parser", True,
                   "reject trailing garbage in datetime literals"),
        SettingDef("parse_datetime_ignore_remainder", False,
                   "lenient datetime parsing"),
        SettingDef("format_null_as_str", True,
                   "render NULL as the null_display string in text formats"),
        SettingDef("storage_io_min_bytes_for_seek", 48,
                   "merge reads closer than this", (0, 1 << 20)),
        SettingDef("recluster_block_size", 0,
                   "target bytes per recluster task (0 = auto)", (0, 1 << 40)),
        SettingDef("recluster_timeout_secs", 43200,
                   "OPTIMIZE recluster budget", (1, 1 << 20)),
        SettingDef("enable_distributed_recluster", False,
                   "shard recluster work across the mesh"),
        SettingDef("stream_consume_batch_size_hint", 0,
                   "rows per stream consumption batch (0 = all)",
                   (0, 1 << 31)),
        SettingDef("idle_transaction_timeout_secs", 14400,
                   "abort transactions idle longer than this", (1, 1 << 20)),
        SettingDef("http_handler_result_timeout_secs", 60,
                   "HTTP result pagination expiry (consulted by the HTTP"
                   " server GC)", (1, 1 << 16)),
        SettingDef("script_max_steps", 10000,
                   "SQL script step budget (consulted by script/engine)",
                   (1, 1 << 24)),
        SettingDef("short_sql_max_length", 128,
                   "query_log SQL truncation length", (1, 1 << 20)),
        SettingDef("trace_sample_rate", 100,
                   "percent of queries recording trace spans", (0, 100)),
        SettingDef("random_function_seed", False,
                   "make rand() deterministic per query"),
        SettingDef("ddl_column_type_nullable", True,
                   "columns default to NULL unless NOT NULL is written"),
        SettingDef("efficiently_memory_group_by", False,
                   "trade group-by speed for memory"),
        SettingDef("enable_experimental_aggregate_hashtable", True,
                   "dense group-id hashing aggregate path (always on here)"),
        SettingDef("network_policy", "",
                   "session-level network policy override"),
        SettingDef("warehouse", "default", "warehouse name (single-warehouse"
                   " build; accepted for client compat)"),
        SettingDef("sandbox_tenant", "", "test-isolation tenant tag"),
        SettingDef("enable_optimizer_trace", False,
                   "log optimizer rule applications"),
        SettingDef("optimizer_skip_list", "",
                   "comma-separated optimizer rules to skip (consulted by"
                   " sql/optimizer)"),
        SettingDef("statement_queue_ttl_in_seconds", 15,
                   "admission queue entry TTL", (1, 1 << 16)),
        SettingDef("queries_queue_retry_timeout", 5,
                   "admission retry timeout", (1, 1 << 16)),
        SettingDef("use_legacy_query_executor", False,
                   "no legacy executor exists in this build"),
        SettingDef("analyze_histogram_algorithm", 'kll',
                   "ANALYZE histogram sketch: kll | equi_height"),
        SettingDef("auto_compaction_imperfect_blocks_threshold", 25,
                   "auto-compact after this many small blocks", (1, 1048576)),
        SettingDef("auto_compaction_segments_limit", 3,
                   "segments per auto-compaction", (1, 1024)),
        SettingDef("bloom_runtime_filter_threshold", 1048576,
                   "build sides above this skip bloom runtime filters", (0, 1099511627776)),
        SettingDef("copy_dedup_full_path_by_default", True,
                   "copied-files dedup keys on the full stage path"),
        SettingDef("data_retention_num_snapshots_to_keep", 0,
                   "retain at least this many snapshots in VACUUM (0 = time-based only)", (0, 1048576)),
        SettingDef("default_order_by_null", 'nulls_last',
                   "NULL ordering: nulls_first | nulls_last"),
        SettingDef("disable_variant_check", False,
                   "skip VARIANT validity checks on ingest"),
        SettingDef("dynamic_sample_time_budget_ms", 0,
                   "optimizer sampling time budget", (0, 1048576)),
        SettingDef("enable_auto_analyze", False,
                   "re-ANALYZE after large writes"),
        SettingDef("enable_auto_vacuum", False,
                   "vacuum automatically after commits"),
        SettingDef("enable_compact_after_write", False,
                   "compact small blocks right after writes"),
        SettingDef("enable_distributed_replace_into", True,
                   "shard REPLACE INTO across the mesh"),
        SettingDef("enable_loser_tree_merge_sort", True,
                   "k-way merge via loser tree (always the behavior here)"),
        SettingDef("enable_merge_into_row_fetch", True,
                   "MERGE INTO lazy row fetch"),
        SettingDef("enable_parallel_multi_merge_sort", True,
                   "parallel run merging in external sort"),
        SettingDef("enable_parallel_union_all", True,
                   "execute UNION ALL inputs concurrently"),
        SettingDef("enable_parquet_page_index", True,
                   "parquet page-level pruning metadata"),
        SettingDef("enable_parquet_prewhere", True,
                   "filter-first parquet reads"),
        SettingDef("enable_parquet_rowgroup_pruning", True,
                   "row-group zone-map pruning"),
        SettingDef("enable_prune_cache", True,
                   "cache pruning results per snapshot"),
        SettingDef("enable_prune_pipeline", True,
                   "run pruners as a pipeline"),
        SettingDef("enable_refresh_aggregating_index_after_write", True,
                   "keep aggregating indexes fresh on write (the write path here always does)"),
        SettingDef("enable_result_set_spilling", False,
                   "spill large result sets before pagination"),
        SettingDef("enable_shuffle_sort", True,
                   "distributed sort via shuffle exchange"),
        SettingDef("enable_spatial_join", False,
                   "spatial join operator (bbox pruning exists; join rewrite pending)"),
        SettingDef("enable_table_snapshot_stats", True,
                   "persist table-level stats in snapshots"),
        SettingDef("enforce_local", False,
                   "force local (non-distributed) execution"),
        SettingDef("error_on_nondeterministic_update", True,
                   "error when an UPDATE matches a row twice"),
        SettingDef("flight_client_timeout", 60,
                   "flight RPC timeout seconds", (1, 65536)),
        SettingDef("flight_connection_max_retry_times", 3,
                   "flight connect retries", (0, 64)),
        SettingDef("grouping_sets_channel_size", 2,
                   "grouping-sets branch buffering", (1, 1024)),
        SettingDef("hash_shuffle_rows_threshold", 0,
                   "rows above which joins hash-shuffle (0 = optimizer decides)", (0, 1099511627776)),
        SettingDef("inlist_runtime_filter_threshold", 1024,
                   "IN-set runtime filters up to this many build keys", (0, 1048576)),
        SettingDef("join_runtime_filter_selectivity_threshold", 50,
                   "percent selectivity below which runtime filters apply", (0, 100)),
        SettingDef("max_query_memory_usage", 0,
                   "per-query memory ceiling bytes (0 = max_memory_usage governs)", (0, 281474976710656)),
        SettingDef("max_set_operator_count", 1024,
                   "max set operators per query", (1, 1048576)),
        SettingDef("max_vacuum_temp_files_after_query", 0,
                   "temp files vacuumed after each query (0 = unlimited)", (0, 2147483648)),
        SettingDef("min_max_runtime_filter_threshold", 10485760,
                   "build sides above this skip min/max runtime filters", (0, 281474976710656)),
        SettingDef("prewhere_selectivity_threshold", 80,
                   "percent selectivity above which prewhere is skipped", (0, 100)),
        SettingDef("query_out_of_memory_behavior", 'throw',
                   "on memory limit: throw | spilling"),
        SettingDef("replace_into_bloom_pruning_max_column_number", 4,
                   "bloom-prune REPLACE INTO on up to this many columns", (0, 64)),
        SettingDef("s3_storage_class", 'standard',
                   "S3 storage class for writes"),
        SettingDef("spilling_file_format", 'parquet',
                   "spill run file format"),
        SettingDef("storage_delete_batch_size", 1000,
                   "object deletions per batch", (1, 1048576)),
        SettingDef("window_partition_sort_block_size", 65536,
                   "rows per window partition sort block", (1, 16777216)),
        SettingDef("window_spill_unit_size_mb", 256,
                   "window spill unit size MB", (1, 65536)),
        # ---- remaining reference-parity tranche (round 3): the full
        # 221-setting surface of settings_default.rs, accepted+persisted
        # with reference defaults (engine consults the wired subset)
        SettingDef("allow_query_exceeded_limit", 0,
                   "Allow queries to overshoot the configured memory limit, deferring error notification until memory contention is encou..."),
        SettingDef("analyze_histogram_kll_relative_error", '0.01',
                   "Sets the relative error used by the KLL analyze histogram algorithm."),
        SettingDef("binary_input_format", 'utf-8',
                   "Controls how string literals are interpreted when inserted into BINARY columns (HEX, BASE64, UTF-8, or UTF-8-LOSSY)."),
        SettingDef("binary_output_format", 'hex',
                   "Controls how BINARY columns are rendered (HEX, BASE64, UTF-8, or UTF-8-LOSSY)."),
        SettingDef("compact_max_block_selection", 1000,
                   "Limits the maximum number of imperfect blocks that can be selected during a compact operation.", (2, 1 << 63)),
        SettingDef("cost_factor_aggregate_per_row", 5,
                   "Cost factor of grouping operation for a data row"),
        SettingDef("cost_factor_hash_table_per_row", 10,
                   "Cost factor of building hash table for a data row"),
        SettingDef("cost_factor_network_per_row", 50,
                   "Cost factor of transmit via network for a data row"),
        SettingDef("create_query_flight_client_with_current_rt", 1,
                   "Turns on (1) or off (0) the use of the current runtime for query operations."),
        SettingDef("enable_auto_detect_datetime_format", 0,
                   "Enable auto-detection for non-ISO datetime formats (MM/DD/YYYY, DD-MON-YYYY, RFC 2822, Unix date, epoch numbers). Wor..."),
        SettingDef("enable_auto_fix_missing_bloom_index", 0,
                   "Enables auto fix missing bloom index"),
        SettingDef("enable_auto_materialize_cte", 1,
                   "Enables auto materialize CTE, 0 for disable, 1 for enable"),
        SettingDef("enable_backpressure_spiller", 0,
                   "Use new backpressure spiller."),
        SettingDef("enable_block_stream_write", 1,
                   "Enables block stream write"),
        SettingDef("enable_compact_after_multi_table_insert", 0,
                   "Enables recluster and compact after multi-table insert."),
        SettingDef("enable_dio", 1,
                   "Enables Direct IO."),
        SettingDef("enable_dst_hour_fix", 0,
                   "Time conversion handles invalid DST by adding an hour. Accuracy not guaranteed.(disable by default)"),
        SettingDef("enable_expand_roles", 1,
                   "Enable expand roles when execute show grants statement(enable by default)."),
        SettingDef("enable_experimental_connection_privilege_check", 0,
                   "experiment setting enable connection object privilege check(disable by default)."),
        SettingDef("enable_experimental_new_join", 1,
                   "Enables the experimental new join implement"),
        SettingDef("enable_experimental_procedure", 1,
                   "Enables the experimental feature for 'PROCEDURE'. In default enable the experimental feature"),
        SettingDef("enable_experimental_rbac_check", 1,
                   "experiment setting enable stage and udf privilege check(enable by default)."),
        SettingDef("enable_experimental_row_access_policy", 0,
                   "experiment setting enable row access policy(disable by default)."),
        SettingDef("enable_experimental_sequence_privilege_check", 0,
                   "experiment setting enable sequence object privilege check(disable by default)."),
        SettingDef("enable_experimental_table_ref", 0,
                   "experiment setting enable table ref(disable by default)."),
        SettingDef("enable_experimental_virtual_column", 0,
                   "Enables experimental virtual column"),
        SettingDef("enable_fixed_rows_sort", 1,
                   "Enable fixed rows sort serialize"),
        SettingDef("enable_geo_create_table", 1,
                   "Create and alter table with geometry/geography type"),
        SettingDef("enable_group_by_column_first", 0,
                   "Resolve GROUP BY names to input columns before SELECT aliases. Disabled by default for compatibility."),
        SettingDef("enable_hive_parquet_predict_pushdown", 1,
                   "Enables hive parquet predict pushdown  by setting this variable to 1, default value: 1"),
        SettingDef("enable_last_snapshot_location_hint", 1,
                   "Enables writing last_snapshot_location_hint object"),
        SettingDef("enable_mutation_block_id_repartition", 1,
                   "Enable local block_id repartition before row fetch in join-based mutations (MERGE INTO, UPDATE...FROM) to reduce dupl..."),
        SettingDef("enable_new_copy_for_text_formats", 1,
                   "Use new implementation for loading CSV files."),
        SettingDef("enable_proxy_bloom_pruning", 0,
                   "Enable bloom index pruning during PROXY lightweight route estimation. Disabled by default to keep routing cheap."),
        SettingDef("enable_replace_into_partitioning", 1,
                   "Enables partitioning for replace-into statement (if table has cluster keys)."),
        SettingDef("enable_selector_executor", 1,
                   "Enables selector executor for filter expression"),
        SettingDef("enable_sort_spill_prefetch", 1,
                   "Enable asynchronous restore prefetch for spilled sort blocks"),
        SettingDef("enable_sort_spill_stream_regroup", 1,
                   "Enable regrouping sort spill streams by domain before merge"),
        SettingDef("enable_stream_batch_snapshot_forward_scan", 0,
                   "Enable forward UUID-v7 snapshot scanning when applying a stream batch size hint."),
        SettingDef("external_server_connect_timeout_secs", 10,
                   "Connection timeout to external server", (0, 1 << 63)),
        SettingDef("external_server_request_batch_rows", 65536,
                   "Request batch rows to external server", (1, 1 << 63)),
        SettingDef("external_server_request_max_threads", 256,
                   "Request maximum number of threads to external server", (1, 1 << 63)),
        SettingDef("external_server_request_retry_times", 8,
                   "Request max retry times to external server"),
        SettingDef("external_server_request_timeout_secs", 180,
                   "Request timeout to external server", (0, 1 << 63)),
        SettingDef("flight_client_keep_alive_interval_secs", 0,
                   "Sets the interval in seconds between two flight TCP keepalive probes. 0 disables keepalive.", (0, 1 << 63)),
        SettingDef("flight_client_keep_alive_retries", 0,
                   "Sets the number of TCP keepalive retries for flight connections before declaring the peer unreachable. 0 disables kee...", (0, 1 << 63)),
        SettingDef("flight_client_keep_alive_time_secs", 0,
                   "Sets the idle time in seconds before a flight TCP connection sends keepalive probes. 0 disables keepalive.", (0, 1 << 63)),
        SettingDef("flight_connection_retry_interval", 1,
                   "The retry interval of cluster flight is in seconds."),
        SettingDef("force_aggregate_shuffle_mode", 'String::from("auto',
                   "For testing only. Shuffle mode for aggregation. Options are 'auto', 'row', 'bucket'. Default is 'auto'."),
        SettingDef("force_materialized_cte_spill", 0,
                   "For testing only. materialized CTE data will be forcibly spilled to external storage if enabled"),
        SettingDef("force_window_data_spill", 0,
                   "For testing only. window data will be forcibly spilled to external storage if enabled"),
        SettingDef("hash_shuffle_bytes_threshold", 4194304,
                   "Sets the max bytes threshold for hash shuffle block partition stream.", (0, 1 << 63)),
        SettingDef("hive_parquet_chunk_size", 16384,
                   "The max number of rows each read from parquet to databend processor", (0, 1 << 63)),
        SettingDef("http_json_result_mode", 'display',
                   "Controls how HTTP query JSON data is encoded (display or driver)."),
        SettingDef("inlist_runtime_bloom_prune_threshold", 64,
                   "Sets the maximum number of values in an IN list for runtime block bloom pruning.", (0, 1 << 63)),
        SettingDef("join_spilling_buffer_threshold_per_proc_mb", 512,
                   "Set the spilling buffer threshold (MB) for each join processor.", (0, 1 << 63)),
        SettingDef("lazy_read_across_join_threshold", 10,
                   "Sets the maximum LIMIT in a query to enable lazy read across joins. Setting it to 0 disables the optimization.", (0, 1 << 63)),
        SettingDef("materialized_cte_spilling_memory_ratio", 60,
                   "Sets the maximum memory ratio in bytes that materialized CTE execution can use before spilling data to storage, 0 is ..."),
        SettingDef("max_aggregate_spill_level", 3,
                   "Maximum recursion depth for the aggregate spill. Each recursion level repartition data into 4 smaller parts to ensure..."),
        SettingDef("max_hash_join_spill_level", 1,
                   "Maximum recursion depth for the hash join spill. Each recursion level repartition data into 16 smaller parts to ensur..."),
        SettingDef("max_public_keys_per_user", 10,
                   "Maximum number of public keys allowed per user for key-pair authentication"),
        SettingDef("max_vacuum_threads", 1,
                   "Sets the maximum number of threads to execute vacuum operation."),
        SettingDef("parquet_rowgroup_hint_bytes", 134217728,
                   "Parquet file is very large, we will divide it into multiple rowgroups to read, the config is the hint bytes of each r..."),
        SettingDef("persist_materialized_cte", 1,
                   "Decides if materialized CTEs should be persisted to disk."),
        SettingDef("proxy_routing_model", 'statistics',
                   "Controls how PROXY chooses a target table. 'statistics' estimates route cost with lightweight pruning; 'prefix' match..."),
        SettingDef("query_flight_compression", 'String::from("LZ4',
                   "flight compression method"),
        SettingDef("replace_into_shuffle_strategy", 0,
                   "Choose shuffle strategy: 0 for Block, 1 for Segment level."),
        SettingDef("spatial_join_max_build_rows", 1000000,
                   "Maximum estimated rows allowed on the spatial join build side.", (0, 1 << 63)),
        SettingDef("spill_writer_memory_pool_size_mb", 20,
                   "Set the memory pool size (MB) for each spill writer.", (1, 1 << 63)),
        SettingDef("spilling_to_disk_vacuum_unknown_temp_dirs_limit", 1 << 63,
                   "Set the maximum number of directories to clean up. If there are some temporary dirs when another query is unexpectedl..."),
        SettingDef("storage_io_max_page_bytes_for_read", 524288,
                   "Sets the maximum byte size of data pages that can be read from storage in a single I/O operation.", (0, 1 << 63)),
        SettingDef("system_tables_count_db_concurrency", 16,
                   "Sets the DB-level concurrency used by system.tables count optimization."),
        SettingDef("udf_cloud_import_presign_expire_secs", 259200,
                   "Presign expiry for cloud UDF stage imports", (1, 1 << 63)),
        SettingDef("use_parquet2", 0,
                   "This setting is deprecated"),
    ]
}


class Settings:
    def __init__(self):
        self._values: Dict[str, Any] = {}
        self._globals: Dict[str, Any] = {}

    def get(self, name: str) -> Any:
        key = name.lower()
        if key in self._values:
            return self._values[key]
        if key in self._globals:
            return self._globals[key]
        if key not in DEFAULT_SETTINGS:
            raise UnknownSetting(f"unknown setting {name!r}")
        return DEFAULT_SETTINGS[key].default

    def set(self, name: str, value: Any, is_global: bool = False) -> None:
        key = name.lower()
        if key not in DEFAULT_SETTINGS:
            raise UnknownSetting(f"unknown setting {name!r}")
        d = DEFAULT_SETTINGS[key]
        if isinstance(d.default, bool) and not isinstance(value, bool):
            value = str(value).lower() in ("1", "true", "on")
        elif isinstance(d.default, int) and not isinstance(value, bool):
            try:
                value = int(value)
            except (TypeError, ValueError):
                raise WrongValueForSetting(f"{name} expects an integer, got {value!r}")
            if d.range and not (d.range[0] <= value <= d.range[1]):
                raise WrongValueForSetting(
                    f"{name}={value} outside range {d.range}")
        (self._globals if is_global else self._values)[key] = value

    def unset(self, name: str) -> None:
        """UNSET <setting>: revert to the default (session scope)."""
        key = name.lower()
        if key not in DEFAULT_SETTINGS:
            raise UnknownSetting(f"unknown setting {name!r}")
        self._values.pop(key, None)

    def all(self):
        out = []
        for key in sorted(DEFAULT_SETTINGS):
            d = DEFAULT_SETTINGS[key]
            out.append((key, self.get(key), d.default, d.desc))
        return out
