"""Operational tools: backup/restore (bendsave-equivalent)."""
