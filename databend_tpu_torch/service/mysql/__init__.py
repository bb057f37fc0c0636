"""MySQL wire protocol handler (reference MySQLHandler,
src/query/service/src/servers/mysql/)."""

from .server import MySQLServer

__all__ = ["MySQLServer"]
