"""Arrow Flight SQL endpoint (reference: FlightSQL handler + the Arrow
Flight exchange data plane, src/query/service/src/servers/flight/)."""

from .server import FlightSQLServer

__all__ = ["FlightSQLServer"]
