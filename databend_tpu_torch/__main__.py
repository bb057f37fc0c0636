"""Unified binary entrypoint: ``python -m databend_tpu_torch <subcommand>``.

Reference analog: src/binaries — the databend-query / databend-meta /
databend-metactl / bendsave binaries (src/binaries/query/entry.rs,
src/meta/binaries). One Python entrypoint dispatches to the same
process mains; ``--version`` mirrors the vergen build-info output
(src/common/building).
"""

from __future__ import annotations

import sys


def _usage() -> str:
    return (
        "usage: python -m databend_tpu_torch <command> [args]\n\n"
        "commands:\n"
        "  query      start the HTTP query server (databend-query)\n"
        "  meta       start the meta service (databend-meta)\n"
        "  mysql      start the MySQL-wire server\n"
        "  flight     start the Flight SQL server\n"
        "  metactl    meta export/import/status (databend-metactl)\n"
        "  bendsave   backup/restore (bendsave)\n"
        "  sqllogic   run sqllogictest suites\n"
        "  version    print version info\n")


def _cmd_sqllogic(argv) -> int:
    import argparse

    from .service.session import SessionContext
    from .testing.sqllogic import run_suite
    p = argparse.ArgumentParser(prog="databend_tpu_torch sqllogic")
    p.add_argument("suite_dir", help="directory of .test files")
    p.add_argument("--data-root", default=None,
                   help="data root (default: a temp dir per run)")
    a = p.parse_args(argv)
    import tempfile
    root = a.data_root or tempfile.mkdtemp(prefix="dbtpu_slt_")

    def factory():
        return SessionContext(data_root=root)

    n, failures = run_suite(factory, a.suite_dir)
    for f in failures:
        print("FAIL:", f)
    print(f"{n} statements, {len(failures)} failures")
    return 1 if failures else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_usage())
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd in ("version", "--version", "-V"):
        import platform

        from .version import __version__
        print(f"databend_tpu_torch v{__version__} "
              f"(python {platform.python_version()}, "
              f"{platform.machine()})")
        return 0
    if cmd == "query":
        sys.argv = ["databend_tpu_torch-query"] + rest
        from .service.http.server import main as qmain
        qmain()
        return 0
    if cmd == "meta":
        from .meta.server import main as mmain
        mmain(rest)
        return 0
    if cmd == "mysql":
        sys.argv = ["databend_tpu_torch-mysql"] + rest
        from .service.mysql.server import main as mymain
        mymain()
        return 0
    if cmd == "flight":
        sys.argv = ["databend_tpu_torch-flight"] + rest
        from .service.flight.server import main as fmain
        fmain()
        return 0
    if cmd == "metactl":
        from .tools.metactl import main as ctlmain
        return int(ctlmain(rest) or 0)
    if cmd == "bendsave":
        from .tools.bendsave import main as bsmain
        return int(bsmain(rest) or 0)
    if cmd == "sqllogic":
        return _cmd_sqllogic(rest)
    print(f"unknown command {cmd!r}\n\n" + _usage(), file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
