"""Minimal JSON-schema validator for the checked-in obs schemas (port of
``repro.obs.schema``).

No ``jsonschema`` package is needed: the metrics schema check ships its
own validator.  ``schemas/metrics.schema.json`` and
``schemas/trace.schema.json`` are copies of the reference's, so one
document passes both packages' validators.  It supports exactly the
keywords the schemas under ``obs/schemas/`` use:

    type (incl. union lists, "number" accepting ints, "null"),
    required, properties, additionalProperties (bool only),
    items (single-schema form), enum, const, minItems.

``validate`` returns a list of error strings ("path: message"); an empty
list means the document conforms.
"""
from __future__ import annotations

import json
import os

_SCHEMA_DIR = os.path.join(os.path.dirname(__file__), "schemas")

_TYPES = {
    "object": (dict,),
    "array": (list,),
    "string": (str,),
    "number": (int, float),
    "integer": (int,),
    "boolean": (bool,),
    "null": (type(None),),
}


def load_schema(name: str) -> dict:
    """Load a checked-in schema by name ("metrics", "trace")."""
    with open(os.path.join(_SCHEMA_DIR, f"{name}.schema.json")) as f:
        return json.load(f)


def _type_ok(value, tname: str) -> bool:
    py = _TYPES[tname]
    if not isinstance(value, py):
        return False
    # bool is an int subclass in Python; keep JSON semantics strict
    if tname in ("number", "integer") and isinstance(value, bool):
        return False
    return True


def validate(value, schema: dict, path: str = "$") -> list:
    """Validate ``value`` against ``schema``; return a list of errors."""
    errs: list[str] = []

    if "const" in schema:
        if value != schema["const"]:
            errs.append(f"{path}: expected const {schema['const']!r}, "
                        f"got {value!r}")
            return errs

    if "enum" in schema:
        if value not in schema["enum"]:
            errs.append(f"{path}: {value!r} not in enum {schema['enum']!r}")
            return errs

    t = schema.get("type")
    if t is not None:
        types = t if isinstance(t, list) else [t]
        if not any(_type_ok(value, tn) for tn in types):
            errs.append(f"{path}: expected type {t}, "
                        f"got {type(value).__name__}")
            return errs

    if isinstance(value, dict):
        for req in schema.get("required", ()):
            if req not in value:
                errs.append(f"{path}: missing required key {req!r}")
        props = schema.get("properties", {})
        for key, sub in props.items():
            if key in value:
                errs.extend(validate(value[key], sub, f"{path}.{key}"))
        if schema.get("additionalProperties") is False:
            for key in value:
                if key not in props:
                    errs.append(f"{path}: unexpected key {key!r}")

    if isinstance(value, list):
        if "minItems" in schema and len(value) < schema["minItems"]:
            errs.append(f"{path}: expected >= {schema['minItems']} items, "
                        f"got {len(value)}")
        items = schema.get("items")
        if items is not None:
            for i, item in enumerate(value):
                errs.extend(validate(item, items, f"{path}[{i}]"))

    return errs
