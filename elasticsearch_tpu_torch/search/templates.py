"""Search templates: mustache-rendered search bodies.

Counterpart of ``elasticsearch_tpu/search/templates.py``, copied but for
its imports: ``render_template`` fills ``{{var}}`` (a dotted path into
the params; a string as is, anything else as JSON, a missing one as an
empty string) and ``{{#toJson}}var{{/toJson}}``, then parses the result
as the search body; ``resolve_template`` takes an inline ``source`` (or
``inline``) or a stored script's ``id`` from the cluster state.
"""

from __future__ import annotations

import json
import re
from typing import Optional

from elasticsearch_tpu_torch.common.errors import (
    ParsingException,
    ResourceNotFoundException,
)

_TOJSON_RE = re.compile(r"\{\{#toJson\}\}(\w+)\{\{/toJson\}\}")
_VAR_RE = re.compile(r"\{\{([\w.]+)\}\}")


def render_template(source, params: Optional[dict]) -> dict:
    params = params or {}
    if isinstance(source, dict):
        template = json.dumps(source)
    else:
        template = str(source)

    def tojson(m):
        name = m.group(1)
        return json.dumps(params.get(name))

    template = _TOJSON_RE.sub(tojson, template)

    def sub(m):
        path = m.group(1)
        node = params
        for part in path.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                return ""
        if isinstance(node, str):
            return node
        return json.dumps(node)

    rendered = _VAR_RE.sub(sub, template)
    try:
        return json.loads(rendered)
    except json.JSONDecodeError as e:
        raise ParsingException(
            f"rendered search template is not valid JSON: {e}: {rendered[:200]}"
        ) from e


def resolve_template(node, body: dict):
    """The rendered search body of an inline or a stored template."""
    params = body.get("params") or {}
    if "source" in body or "inline" in body:
        return render_template(body.get("source") or body.get("inline"), params)
    if "id" in body:
        stored = node.cluster_service.state.stored_scripts.get(body["id"])
        if stored is None:
            raise ResourceNotFoundException(
                f"unable to find script [{body['id']}]"
            )
        return render_template(stored.get("source") or stored.get("inline"), params)
    raise ParsingException("search template requires [source] or [id]")
