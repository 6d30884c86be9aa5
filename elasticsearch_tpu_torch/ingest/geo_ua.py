"""geoip + user_agent ingest processors.

Counterpart of ``elasticsearch_tpu/ingest/geo_ua.py``, a copy but for its
imports.

Role models: ``plugins/ingest-geoip`` (GeoIpProcessor over a MaxMind
database) and ``plugins/ingest-user-agent`` (UserAgentProcessor over the
ua-parser regex set). Like the reference — whose MaxMind .mmdb ships as a
separate download — the geoip database here is pluggable: a small builtin
range table covers well-known public resolver/documentation ranges, and
``database_file`` points at a JSON list of
``{"cidr": ..., "country_iso_code": ..., ...}`` entries for real data.
"""

from __future__ import annotations

import ipaddress
import json
import re
from typing import List, Optional

from elasticsearch_tpu_torch.common.errors import IllegalArgumentException

# builtin stand-in "database": well-known public ranges (documentation +
# public resolvers), enough to exercise every property end-to-end
_BUILTIN_DB = [
    {"cidr": "8.8.8.0/24", "country_iso_code": "US",
     "country_name": "United States", "continent_name": "North America",
     "city_name": "Mountain View", "region_name": "California",
     "location": {"lat": 37.386, "lon": -122.0838}, "timezone": "America/Los_Angeles"},
    {"cidr": "1.1.1.0/24", "country_iso_code": "AU",
     "country_name": "Australia", "continent_name": "Oceania",
     "city_name": "Sydney", "region_name": "New South Wales",
     "location": {"lat": -33.8688, "lon": 151.2093}, "timezone": "Australia/Sydney"},
    {"cidr": "81.2.69.0/24", "country_iso_code": "GB",
     "country_name": "United Kingdom", "continent_name": "Europe",
     "city_name": "London", "region_name": "England",
     "location": {"lat": 51.5142, "lon": -0.0931}, "timezone": "Europe/London"},
    {"cidr": "2001:4860:4860::/48", "country_iso_code": "US",
     "country_name": "United States", "continent_name": "North America",
     "location": {"lat": 37.751, "lon": -97.822}},
]

_DEFAULT_GEOIP_PROPS = ["continent_name", "country_iso_code", "region_name",
                        "city_name", "location"]

_db_cache: dict = {}


def _load_db(path: Optional[str]) -> List[tuple]:
    """Parsed [(network, entry)] list, cached per database (CIDR parsing
    happens once per db, never per document)."""
    key = path or "__builtin__"
    parsed = _db_cache.get(key)
    if parsed is None:
        if path is None:
            entries = _BUILTIN_DB
        else:
            with open(path, encoding="utf-8") as f:
                entries = json.load(f)
        parsed = _db_cache[key] = [
            (ipaddress.ip_network(e["cidr"]), e) for e in entries
        ]
    return parsed


def geoip_processor(cfg: dict, doc) -> None:
    """GeoIpProcessor: field (required), target_field (default 'geoip'),
    properties, ignore_missing."""
    field = cfg.get("field")
    if field is None:
        raise IllegalArgumentException("[geoip] [field] required property is missing")
    value = doc.get(field)
    if value is None:
        if cfg.get("ignore_missing"):
            return
        raise IllegalArgumentException(f"field [{field}] not present as part of path [{field}]")
    try:
        addr = ipaddress.ip_address(str(value))
    except ValueError as e:
        raise IllegalArgumentException(f"[geoip] '{value}' is not an IP string") from e
    nets = _load_db(cfg.get("database_file"))
    hit = None
    for net, entry in nets:
        if addr.version == net.version and addr in net:
            hit = entry
            break
    if hit is None:
        return  # unresolvable addresses add nothing (reference behavior)
    props = cfg.get("properties", _DEFAULT_GEOIP_PROPS)
    data = {p: hit[p] for p in props if p in hit}
    if data:
        doc.set(cfg.get("target_field", "geoip"), data)


# --- user agent ------------------------------------------------------------

_UA_BROWSERS = [
    # Edge + Opera carry a Chrome/ token too — they must match first
    ("Edge", re.compile(r"Edge?/(\d+)\.(\d+)")),
    ("Opera", re.compile(r"OPR/(\d+)\.(\d+)")),
    ("Chrome", re.compile(r"Chrome/(\d+)\.(\d+)")),
    ("Firefox", re.compile(r"Firefox/(\d+)\.(\d+)")),
    ("Safari", re.compile(r"Version/(\d+)\.(\d+).*Safari/")),
    ("IE", re.compile(r"MSIE (\d+)\.(\d+)")),
    ("IE", re.compile(r"Trident/.*rv:(\d+)\.(\d+)")),
    ("curl", re.compile(r"curl/(\d+)\.(\d+)")),
]

_UA_OS = [
    ("Windows 10", re.compile(r"Windows NT 10\.0")),
    ("Windows 7", re.compile(r"Windows NT 6\.1")),
    ("Windows", re.compile(r"Windows NT")),
    ("Android", re.compile(r"Android (\d+)")),
    ("iOS", re.compile(r"iPhone OS (\d+)|CPU OS (\d+)")),
    ("Mac OS X", re.compile(r"Mac OS X (\d+)[._](\d+)")),
    ("Linux", re.compile(r"Linux")),
]


def _parse_user_agent(ua: str) -> dict:
    out = {"name": "Other", "device": {"name": "Other"}}
    for name, rx in _UA_BROWSERS:
        m = rx.search(ua)
        if m:
            out["name"] = name
            groups = [g for g in m.groups() if g is not None]
            if groups:
                out["major"] = groups[0]
                if len(groups) > 1:
                    out["minor"] = groups[1]
                out["version"] = ".".join(groups[:2])
            break
    for os_name, rx in _UA_OS:
        m = rx.search(ua)
        if m:
            out["os"] = {"name": os_name, "full": os_name}
            groups = [g for g in m.groups() if g is not None]
            if groups:
                out["os"]["version"] = groups[0]
                out["os"]["full"] = f"{os_name} {groups[0]}"
            break
    if "Mobile" in ua or "iPhone" in ua or "Android" in ua:
        out["device"] = {"name": "Smartphone" if "iPhone" not in ua else "iPhone"}
    return out


def user_agent_processor(cfg: dict, doc) -> None:
    """UserAgentProcessor: field (required), target_field (default
    'user_agent'), properties, ignore_missing."""
    field = cfg.get("field")
    if field is None:
        raise IllegalArgumentException(
            "[user_agent] [field] required property is missing")
    value = doc.get(field)
    if value is None:
        if cfg.get("ignore_missing"):
            return
        raise IllegalArgumentException(
            f"field [{field}] not present as part of path [{field}]")
    parsed = _parse_user_agent(str(value))
    props = cfg.get("properties")
    if props:
        parsed = {k: v for k, v in parsed.items() if k in props}
    doc.set(cfg.get("target_field", "user_agent"), parsed)
