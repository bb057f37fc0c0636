"""Test harnesses: sqllogictest runner."""

from .sqllogic import run_file, run_text, SqlLogicError

__all__ = ["run_file", "run_text", "SqlLogicError"]
