"""Error taxonomy for databend_tpu.

Mirrors the reference's ``ErrorCode`` taxonomy (reference:
src/common/exception/src/exception_code.rs) with the subset of codes the
TPU-native engine actually raises. Each error carries a numeric code so the
HTTP/JSON surface can report machine-readable errors like the reference.
"""

from __future__ import annotations


class DatabendError(Exception):
    """Base error. ``code`` mirrors the reference's ErrorCode numbering."""

    code: int = 1001  # Internal

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message

    def __str__(self) -> str:  # pragma: no cover - trivial
        return f"{type(self).__name__}(code={self.code}): {self.message}"


def _err(name: str, code: int) -> type:
    return type(name, (DatabendError,), {"code": code})


# Parser / planner (reference exception_code.rs: 1005, 1006, 1058, 1065)
SyntaxException = _err("SyntaxException", 1005)
SemanticError = _err("SemanticError", 1065)
BadArguments = _err("BadArguments", 1006)
UnknownFunction = _err("UnknownFunction", 1008)
InvalidArgument = _err("InvalidArgument", 1022)
TypeMismatch = _err("TypeMismatch", 1007)
NumberOverflow = _err("NumberOverflow", 1049)
BadDataValueType = _err("BadDataValueType", 1010)
UnsupportedFeature = _err("UnsupportedFeature", 1002)

# Catalog / schema (reference: 1003, 1004, 1025, 1020)
UnknownDatabase = _err("UnknownDatabase", 1003)
UnknownTable = _err("UnknownTable", 1025)
UnknownColumn = _err("UnknownColumn", 1058)
UnknownIndex = _err("UnknownIndex", 1118)
DatabaseAlreadyExists = _err("DatabaseAlreadyExists", 2301)
TableAlreadyExists = _err("TableAlreadyExists", 2302)
IndexAlreadyExists = _err("IndexAlreadyExists", 2306)
UnknownCatalog = _err("UnknownCatalog", 1119)

# Storage / transaction (reference: TableVersionMismatched 2009 etc.)
TableVersionMismatched = _err("TableVersionMismatched", 2009)
StorageOther = _err("StorageOther", 4000)
UnresolvableConflict = _err("UnresolvableConflict", 4001)

# Vector / index errors (reference exception_into.rs HNSW conversions)
VectorError = _err("VectorError", 1123)
IndexError = _err("IndexError", 1124)

# Stages / sequences / policies (reference: UnknownStage 2501,
# UnknownSequence 3101, UnknownMaskingPolicy/RowAccessPolicy 2604/2612,
# LicenseKeyInvalid 1402, UnknownDictionary 3114)
UnknownStage = _err("UnknownStage", 2501)
UnknownSequence = _err("UnknownSequence", 3101)
SequenceError = _err("SequenceError", 3102)
UnknownPolicy = _err("UnknownPolicy", 2604)
UnknownDictionary = _err("UnknownDictionary", 3114)
LicenseKeyInvalid = _err("LicenseKeyInvalid", 1402)

# Session / settings
UnknownSetting = _err("UnknownSetting", 2801)
WrongValueForSetting = _err("WrongValueForSetting", 2803)

# Runtime / resource limits (reference: PanicError 1104 family;
# AbortedQuery 1043; memory guard in src/common/base/src/runtime/memory/)
MemoryLimitExceeded = _err("MemoryLimitExceeded", 1108)
QueueTimeout = _err("QueueTimeout", 2504)
# external UDF server failures (reference UDFServerConnectError 2604 /
# UDFRuntimeError 1810 family collapsed into one client-visible code)
UDFServerError = _err("UDFServerError", 2604)
AbortedQuery = _err("AbortedQuery", 1043)

__all__ = [
    "DatabendError",
    "SyntaxException",
    "SemanticError",
    "BadArguments",
    "UnknownFunction",
    "InvalidArgument",
    "TypeMismatch",
    "NumberOverflow",
    "BadDataValueType",
    "UnsupportedFeature",
    "UnknownDatabase",
    "UnknownTable",
    "UnknownColumn",
    "UnknownIndex",
    "DatabaseAlreadyExists",
    "TableAlreadyExists",
    "IndexAlreadyExists",
    "UnknownCatalog",
    "TableVersionMismatched",
    "StorageOther",
    "UnresolvableConflict",
    "VectorError",
    "IndexError",
    "UnknownStage",
    "UnknownSequence",
    "SequenceError",
    "UnknownPolicy",
    "UnknownDictionary",
    "LicenseKeyInvalid",
    "UnknownSetting",
    "WrongValueForSetting",
    "MemoryLimitExceeded",
    "QueueTimeout",
    "AbortedQuery",
    "UDFServerError",
]
