"""Enterprise feature gating.

Reference: src/common/license/src/license.rs (Feature enum, JWT license)
and src/query/ee_features (per-feature gates consulted by interpreters).

This build ships with a built-in development license (all features on),
mirroring how the reference's test fixtures run EE paths. Setting the
``enterprise_license`` session setting to '' (or any string that names a
feature subset, comma-separated) enforces gating — the mechanism, checks
and error code (LicenseKeyInvalid 1402) match the reference; only the JWT
signature validation is replaced by the explicit allowlist.
"""

from __future__ import annotations

from .errors import LicenseKeyInvalid

# Feature enum (reference license.rs:25-50)
FEATURES = {
    "vacuum",
    "data_mask",
    "row_access_policy",
    "attach_table",
    "computed_column",
    "aggregating_index",
    "inverted_index",
    "vector_index",
    "ngram_index",
    "virtual_column",
    "stream",
    "storage_encryption",
    "license_info",
    "workload_group",
}

_DEV_LICENSE = "builtin-dev"  # grants every feature (OSS/dev build default)


def licensed_features(license_key: str) -> set:
    key = (license_key or "").strip()
    if key == _DEV_LICENSE:
        return set(FEATURES)
    if not key:
        return set()
    # explicit allowlist: "vacuum,data_mask"
    return {f.strip().lower() for f in key.split(",") if f.strip()}


def check_feature(session, feature: str) -> None:
    """Raise LicenseKeyInvalid when the session's license does not cover
    ``feature`` (reference: LicenseManagerSwitch::check_enterprise_enabled)."""
    if feature not in FEATURES:
        raise LicenseKeyInvalid(f"unknown enterprise feature {feature!r}")
    key = str(session.settings.get("enterprise_license") or "")
    if feature not in licensed_features(key):
        raise LicenseKeyInvalid(
            f"enterprise feature {feature!r} requires a license; current "
            f"license covers {sorted(licensed_features(key)) or 'nothing'}")
