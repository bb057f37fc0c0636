"""SQL scripting engine (EXECUTE IMMEDIATE $$ ... $$)."""

from .engine import ScriptError, execute_script_block

__all__ = ["execute_script_block", "ScriptError"]
