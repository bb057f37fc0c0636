"""HTTP query protocol (the reference's poem-based /v1/query handler family,
src/query/service/src/servers/http/v1/)."""
