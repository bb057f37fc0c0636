"""RBAC: users, roles, grants.

Reference analog: src/query/users (UserApiProvider, role cache, grant
checks — 6,881 LoC) and src/meta/app user/role types. Users and roles live
in the meta KV under ``users/`` and ``roles/``; passwords are sha256
(double-sha mirrors MySQL-compatible auth in the reference).

Privileges: SELECT, INSERT, DELETE, UPDATE, CREATE, DROP, ALTER, SUPER,
ALL. Objects: global ``*.*``, database ``db.*``, table ``db.t``. The
built-in ``root`` user and ``account_admin`` role hold ALL on ``*.*``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .errors import _err

AuthenticateFailure = _err("AuthenticateFailure", 1045)
UnknownUser = _err("UnknownUser", 2201)
UnknownRole = _err("UnknownRole", 2204)
PermissionDenied = _err("PermissionDenied", 1063)
IllegalGrant = _err("IllegalGrant", 2218)

PRIVILEGES = {"SELECT", "INSERT", "DELETE", "UPDATE", "CREATE", "DROP",
              "ALTER", "SUPER", "ALL"}
BUILTIN_ADMIN_ROLE = "account_admin"


def hash_password(pw: str) -> str:
    return hashlib.sha256(pw.encode("utf-8")).hexdigest()


@dataclass
class GrantEntry:
    privileges: Set[str]
    database: str  # "*" = all
    table: str     # "*" = all

    def covers(self, priv: str, db: str, table: str) -> bool:
        if priv not in self.privileges and "ALL" not in self.privileges:
            return False
        if self.database != "*" and self.database.lower() != db.lower():
            return False
        if self.table != "*" and self.table.lower() != table.lower():
            return False
        return True

    def to_dict(self):
        return {"privileges": sorted(self.privileges),
                "database": self.database, "table": self.table}

    @staticmethod
    def from_dict(d):
        return GrantEntry(set(d["privileges"]), d["database"], d["table"])


@dataclass
class UserInfo:
    name: str
    password_sha256: Optional[str] = None
    roles: List[str] = field(default_factory=list)
    grants: List[GrantEntry] = field(default_factory=list)
    network_policy: Optional[str] = None
    password_policy: Optional[str] = None

    def to_dict(self):
        return {"name": self.name, "password_sha256": self.password_sha256,
                "roles": self.roles,
                "grants": [g.to_dict() for g in self.grants],
                "network_policy": self.network_policy,
                "password_policy": self.password_policy}

    @staticmethod
    def from_dict(d):
        return UserInfo(d["name"], d.get("password_sha256"),
                        list(d.get("roles", [])),
                        [GrantEntry.from_dict(g) for g in d.get("grants", [])],
                        d.get("network_policy"), d.get("password_policy"))


@dataclass
class RoleInfo:
    name: str
    grants: List[GrantEntry] = field(default_factory=list)

    def to_dict(self):
        return {"name": self.name, "grants": [g.to_dict() for g in self.grants]}

    @staticmethod
    def from_dict(d):
        return RoleInfo(d["name"],
                        [GrantEntry.from_dict(g) for g in d.get("grants", [])])


class UserManager:
    """CRUD + grant checks over the meta KV (reference UserApiProvider)."""

    def __init__(self, meta):
        self.meta = meta
        if self.get_role(BUILTIN_ADMIN_ROLE) is None:
            self._put_role(RoleInfo(BUILTIN_ADMIN_ROLE,
                                    [GrantEntry({"ALL"}, "*", "*")]))
        if self.get_user("root") is None:
            self.meta.upsert("users/root", UserInfo(
                "root", None, [BUILTIN_ADMIN_ROLE]).to_dict())

    # ------------------------------------------------------------- users
    def create_user(self, name: str, password: Optional[str],
                    if_not_exists: bool = False):
        key = f"users/{name.lower()}"
        cur, _ = self.meta.get(key)
        if cur is not None:
            if if_not_exists:
                return
            raise IllegalGrant(f"user {name!r} already exists")
        pw = hash_password(password) if password else None
        self.meta.upsert(key, UserInfo(name.lower(), pw).to_dict())

    def drop_user(self, name: str, if_exists: bool = False):
        key = f"users/{name.lower()}"
        cur, _ = self.meta.get(key)
        if cur is None:
            if if_exists:
                return
            raise UnknownUser(f"unknown user {name!r}")
        if name.lower() == "root":
            raise IllegalGrant("cannot drop the root user")
        self.meta.delete(key)

    def get_user(self, name: str) -> Optional[UserInfo]:
        v, _ = self.meta.get(f"users/{name.lower()}")
        return UserInfo.from_dict(v) if v is not None else None

    def list_users(self) -> List[UserInfo]:
        return [UserInfo.from_dict(v) for _, v, _ in self.meta.list_prefix("users/")]

    def alter_user(self, name: str, password: Optional[str] = None,
                   network_policy=..., password_policy=...):
        """ALTER USER: update password and/or attached policies. Ellipsis
        = leave unchanged; None = UNSET."""
        u = self.get_user(name)
        if u is None:
            raise UnknownUser(f"unknown user {name!r}")
        if password_policy is not ...:
            if password_policy is not None:
                self.get_password_policy(password_policy)  # validates
            u.password_policy = password_policy
        if network_policy is not ...:
            if network_policy is not None:
                self.get_network_policy(network_policy)  # validates
            u.network_policy = network_policy
        if password is not None:
            if u.password_policy:
                self.validate_password(u.password_policy, password)
            u.password_sha256 = hash_password(password)
        self.meta.upsert(f"users/{name.lower()}", u.to_dict())

    def authenticate(self, name: str, password: Optional[str],
                     client_ip: Optional[str] = None) -> UserInfo:
        u = self.get_user(name)
        if u is None:
            raise AuthenticateFailure(f"unknown user {name!r}")
        if u.password_sha256 is not None:
            if password is None or hash_password(password) != u.password_sha256:
                raise AuthenticateFailure(f"wrong password for {name!r}")
        if u.network_policy and client_ip is not None:
            self.check_network(u, client_ip)
        return u

    # ------------------------------------------- network/password policies
    # Reference: src/query/users/src/{network_policy,password_policy}.rs +
    # enforcement in the auth manager / user-mgmt interpreters.
    def create_network_policy(self, name: str, allowed: List[str],
                              blocked: List[str], comment: str = "",
                              if_not_exists=False, or_replace=False):
        key = f"network_policies/{name.lower()}"
        v, _ = self.meta.get(key)
        if v is not None and not or_replace:
            if if_not_exists:
                return
            raise IllegalGrant(f"network policy {name!r} already exists")
        import ipaddress
        for cidr in list(allowed) + list(blocked):
            ipaddress.ip_network(cidr, strict=False)  # validates
        self.meta.upsert(key, {"name": name, "allowed": list(allowed),
                               "blocked": list(blocked), "comment": comment})

    def drop_network_policy(self, name: str, if_exists=False):
        key = f"network_policies/{name.lower()}"
        v, _ = self.meta.get(key)
        if v is None:
            if if_exists:
                return
            raise UnknownRole(f"unknown network policy {name!r}")
        for u in self.list_users():
            if (u.network_policy or "").lower() == name.lower():
                raise IllegalGrant(
                    f"network policy {name!r} is in use by user {u.name!r}")
        self.meta.delete(key)

    def get_network_policy(self, name: str) -> dict:
        v, _ = self.meta.get(f"network_policies/{name.lower()}")
        if v is None:
            raise UnknownRole(f"unknown network policy {name!r}")
        return v

    def list_network_policies(self) -> List[dict]:
        return sorted((v for _, v, _ in self.meta.list_prefix("network_policies/")),
                      key=lambda p: p["name"])

    def check_network(self, u: UserInfo, client_ip: str):
        import ipaddress
        try:
            ip = ipaddress.ip_address(client_ip)
        except ValueError:
            return  # unix sockets / test doubles: no IP to check
        p = self.get_network_policy(u.network_policy)
        for cidr in p.get("blocked", []):
            if ip in ipaddress.ip_network(cidr, strict=False):
                raise AuthenticateFailure(
                    f"client {client_ip} blocked by network policy {p['name']!r}")
        allowed = p.get("allowed", [])
        if allowed and not any(ip in ipaddress.ip_network(c, strict=False)
                               for c in allowed):
            raise AuthenticateFailure(
                f"client {client_ip} not in the allowed list of network"
                f" policy {p['name']!r}")

    def create_password_policy(self, name: str, opts: Dict[str, int],
                               comment: str = "", if_not_exists=False,
                               or_replace=False):
        key = f"password_policies/{name.lower()}"
        v, _ = self.meta.get(key)
        if v is not None and not or_replace:
            if if_not_exists:
                return
            raise IllegalGrant(f"password policy {name!r} already exists")
        policy = {"name": name, "comment": comment,
                  "min_length": int(opts.get("password_min_length", 8)),
                  "max_length": int(opts.get("password_max_length", 256)),
                  "min_upper_case_chars": int(opts.get("password_min_upper_case_chars", 1)),
                  "min_lower_case_chars": int(opts.get("password_min_lower_case_chars", 1)),
                  "min_numeric_chars": int(opts.get("password_min_numeric_chars", 1)),
                  "min_special_chars": int(opts.get("password_min_special_chars", 0))}
        self.meta.upsert(key, policy)

    def drop_password_policy(self, name: str, if_exists=False):
        key = f"password_policies/{name.lower()}"
        v, _ = self.meta.get(key)
        if v is None:
            if if_exists:
                return
            raise UnknownRole(f"unknown password policy {name!r}")
        for u in self.list_users():
            if (u.password_policy or "").lower() == name.lower():
                raise IllegalGrant(
                    f"password policy {name!r} is in use by user {u.name!r}")
        self.meta.delete(key)

    def get_password_policy(self, name: str) -> dict:
        v, _ = self.meta.get(f"password_policies/{name.lower()}")
        if v is None:
            raise UnknownRole(f"unknown password policy {name!r}")
        return v

    def list_password_policies(self) -> List[dict]:
        return sorted((v for _, v, _ in self.meta.list_prefix("password_policies/")),
                      key=lambda p: p["name"])

    def validate_password(self, policy_name: str, password: str):
        p = self.get_password_policy(policy_name)
        n = len(password)
        if n < p["min_length"] or n > p["max_length"]:
            raise AuthenticateFailure(
                f"password length {n} outside [{p['min_length']},"
                f" {p['max_length']}] (policy {p['name']!r})")
        counts = {
            "min_upper_case_chars": sum(c.isupper() for c in password),
            "min_lower_case_chars": sum(c.islower() for c in password),
            "min_numeric_chars": sum(c.isdigit() for c in password),
            "min_special_chars": sum(not c.isalnum() for c in password),
        }
        for k, have in counts.items():
            if have < p[k]:
                raise AuthenticateFailure(
                    f"password needs at least {p[k]} {k[4:]} "
                    f"(policy {p['name']!r})")

    # ------------------------------------------------------------- roles
    def _put_role(self, role: RoleInfo):
        self.meta.upsert(f"roles/{role.name.lower()}", role.to_dict())

    def create_role(self, name: str, if_not_exists: bool = False):
        v, _ = self.meta.get(f"roles/{name.lower()}")
        if v is not None:
            if if_not_exists:
                return
            raise IllegalGrant(f"role {name!r} already exists")
        self._put_role(RoleInfo(name.lower()))

    def drop_role(self, name: str, if_exists: bool = False):
        if name.lower() == BUILTIN_ADMIN_ROLE:
            raise IllegalGrant("cannot drop built-in role")
        v, _ = self.meta.get(f"roles/{name.lower()}")
        if v is None:
            if if_exists:
                return
            raise UnknownRole(f"unknown role {name!r}")
        self.meta.delete(f"roles/{name.lower()}")

    def get_role(self, name: str) -> Optional[RoleInfo]:
        v, _ = self.meta.get(f"roles/{name.lower()}")
        return RoleInfo.from_dict(v) if v is not None else None

    def list_roles(self) -> List[RoleInfo]:
        return [RoleInfo.from_dict(v) for _, v, _ in self.meta.list_prefix("roles/")]

    # ------------------------------------------------------------- grants
    def grant(self, privileges: Set[str], db: str, table: str,
              to_role: Optional[str] = None, to_user: Optional[str] = None):
        bad = privileges - PRIVILEGES
        if bad:
            raise IllegalGrant(f"unknown privileges {sorted(bad)}")
        entry = GrantEntry(privileges, db, table)
        if to_role is not None:
            role = self.get_role(to_role)
            if role is None:
                raise UnknownRole(f"unknown role {to_role!r}")
            role.grants.append(entry)
            self._put_role(role)
        else:
            user = self.get_user(to_user)
            if user is None:
                raise UnknownUser(f"unknown user {to_user!r}")
            user.grants.append(entry)
            self.meta.upsert(f"users/{user.name}", user.to_dict())

    def grant_role(self, role: str, to_user: str):
        if self.get_role(role) is None:
            raise UnknownRole(f"unknown role {role!r}")
        user = self.get_user(to_user)
        if user is None:
            raise UnknownUser(f"unknown user {to_user!r}")
        if role.lower() not in user.roles:
            user.roles.append(role.lower())
            self.meta.upsert(f"users/{user.name}", user.to_dict())

    def revoke(self, privileges: Set[str], db: str, table: str,
               from_role: Optional[str] = None, from_user: Optional[str] = None):
        def strip(grants):
            out = []
            for g in grants:
                if g.database == db and g.table == table:
                    g = GrantEntry(g.privileges - privileges, g.database, g.table)
                    if "ALL" in privileges:
                        continue
                if g.privileges:
                    out.append(g)
            return out
        if from_role is not None:
            role = self.get_role(from_role)
            if role is None:
                raise UnknownRole(f"unknown role {from_role!r}")
            role.grants = strip(role.grants)
            self._put_role(role)
        else:
            user = self.get_user(from_user)
            if user is None:
                raise UnknownUser(f"unknown user {from_user!r}")
            user.grants = strip(user.grants)
            self.meta.upsert(f"users/{user.name}", user.to_dict())

    def effective_grants(self, user: UserInfo) -> List[GrantEntry]:
        out = list(user.grants)
        for r in user.roles:
            role = self.get_role(r)
            if role is not None:
                out.extend(role.grants)
        return out

    def check(self, user: UserInfo, priv: str, db: str, table: str = "*"):
        for g in self.effective_grants(user):
            if g.covers(priv, db, table):
                return
        raise PermissionDenied(
            f"user {user.name!r} lacks {priv} on {db}.{table}")
