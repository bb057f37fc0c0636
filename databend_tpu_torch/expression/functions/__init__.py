from .registry import FunctionRegistry, ScalarFunction, registry

# importing these modules registers their functions
from . import arithmetic, comparison, math_fns, string_fns, string_more, hash_url_fns, datetime_fns, vector_fns, conditional, array_fns, variant_fns, variant_more, geo_fns, map_fns  # noqa: F401
from .aggregates import AGGREGATE_FUNCTIONS, AggregateFunction, create_aggregate

__all__ = [
    "FunctionRegistry",
    "ScalarFunction",
    "registry",
    "AGGREGATE_FUNCTIONS",
    "AggregateFunction",
    "create_aggregate",
]
