"""Planner replay: golden optimized-plan regression harness.

Reference: src/tests/planner_replay — captured plans replayed against the
optimizer so plan-shape regressions (lost pushdowns, changed join orders)
fail loudly instead of silently slowing queries.

Usage:
    replay(session, queries, golden_dir, update=False)
-> [(name, expected, actual)] mismatches (empty = green). ``update=True``
rewrites the goldens (run deliberately after a planned optimizer change).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple


def plan_text(session, sql: str) -> str:
    """EXPLAIN output with volatile bits (ids, timings) scrubbed."""
    rows = session.sql("EXPLAIN " + sql).rows()
    text = "\n".join(r[0] for r in rows)
    text = re.sub(r"0x[0-9a-f]+", "0x·", text)
    return text.strip() + "\n"


def replay(session, queries: Dict[str, str], golden_dir: str,
           update: bool = False) -> List[Tuple[str, str, str]]:
    os.makedirs(golden_dir, exist_ok=True)
    mismatches = []
    for name, sql in sorted(queries.items()):
        actual = plan_text(session, sql)
        path = os.path.join(golden_dir, name + ".plan")
        if update or not os.path.exists(path):
            with open(path, "w") as f:
                f.write(actual)
            continue
        expected = open(path).read()
        if expected != actual:
            mismatches.append((name, expected, actual))
    return mismatches
