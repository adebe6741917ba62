"""JSON schema → regex lowering for constrained decoding (counterpart of
paddle_tpu/inference/structured/schema.py; the same regex strings).

A restricted JSON Schema subset lowers to a single regex in the dialect
`compiler.compile_regex` accepts (also a python ``re`` subset, so output
can be checked with ``re.fullmatch`` + ``json.loads``). The emitted
grammar is CANONICAL JSON: no whitespace, object properties in schema
declaration order, every declared property present — a small DFA that
still guarantees the output parses and type-checks.

Supported: ``object`` (properties, declaration order), ``string``
(optionally ``enum`` or ``pattern``), ``integer``, ``number``,
``boolean``, ``null``, bounded ``array`` (``minItems``/``maxItems``),
and top-level/nested ``enum`` of JSON scalars. Anything else raises
``GrammarError`` naming the unsupported construct, at submit time.
"""
import json

from .compiler import GrammarError

__all__ = ["schema_to_regex"]

_META = set("\\.[](){}*+?|^$")

# string contents when the schema gives no pattern/enum: printable
# ASCII minus '"' and '\' so no JSON escaping is ever needed
_STRING_BODY = r'[ !#-\[\]-~]*'

_INT = r"-?(0|[1-9][0-9]*)"
_NUMBER = _INT + r"(\.[0-9]+)?"


def _esc(s):
    return "".join("\\" + c if c in _META else c for c in s)


def _scalar_literal(v):
    """One JSON scalar as an exact-match regex fragment."""
    if isinstance(v, bool) or v is None or isinstance(v, (int, float)):
        return _esc(json.dumps(v))
    if isinstance(v, str):
        return _esc(json.dumps(v))
    raise GrammarError(
        f"json_schema: enum values must be JSON scalars, got {v!r}")


def _lower(schema, path):
    if not isinstance(schema, dict):
        raise GrammarError(
            f"json_schema: expected an object at {path}, got "
            f"{type(schema).__name__}")
    if "enum" in schema:
        vals = schema["enum"]
        if not isinstance(vals, (list, tuple)) or not vals:
            raise GrammarError(
                f"json_schema: enum at {path} must be a non-empty list")
        return "(" + "|".join(_scalar_literal(v) for v in vals) + ")"
    typ = schema.get("type")
    if typ is None and "properties" in schema:
        typ = "object"
    if typ == "object":
        props = schema.get("properties", {})
        if not isinstance(props, dict) or not props:
            raise GrammarError(
                f"json_schema: object at {path} needs non-empty "
                "'properties' (free-form objects are unsupported)")
        fields = ",".join(
            _esc(json.dumps(str(k))) + ":" + _lower(v, f"{path}.{k}")
            for k, v in props.items())
        return r"\{" + fields + r"\}"
    if typ == "string":
        pat = schema.get("pattern")
        if pat is not None:
            if not isinstance(pat, str) or not pat:
                raise GrammarError(
                    f"json_schema: pattern at {path} must be a "
                    "non-empty string")
            return '"(' + pat + ')"'
        return '"' + _STRING_BODY + '"'
    if typ == "integer":
        return "(" + _INT + ")"
    if typ == "number":
        return "(" + _NUMBER + ")"
    if typ == "boolean":
        return "(true|false)"
    if typ == "null":
        return "null"
    if typ == "array":
        items = schema.get("items")
        if items is None:
            raise GrammarError(
                f"json_schema: array at {path} needs 'items'")
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", 8))
        if lo < 0 or hi < lo:
            raise GrammarError(
                f"json_schema: bad minItems/maxItems at {path}")
        if hi > 64:
            raise GrammarError(
                f"json_schema: maxItems at {path} capped at 64 "
                "(DFA budget); pass an explicit grammar= for more")
        item = _lower(items, f"{path}[]")
        if hi == 0:
            return r"\[\]"
        body = item + "(," + item + "){0,%d}" % (hi - 1)
        if lo == 0:
            return r"\[(" + body + r")?\]"
        if lo > 1:
            body = item + "(," + item + "){%d,%d}" % (lo - 1, hi - 1)
        return r"\[" + body + r"\]"
    raise GrammarError(
        f"json_schema: unsupported type {typ!r} at {path} (supported: "
        "object, string, integer, number, boolean, null, array, enum)")


def schema_to_regex(schema):
    """Lower one JSON schema (dict) to the canonical-JSON regex the
    grammar compiler consumes. Raises ``GrammarError`` for anything
    outside the supported subset, naming the offending path."""
    if not isinstance(schema, dict):
        raise GrammarError(
            "json_schema= must be a dict (a parsed JSON schema), got "
            f"{type(schema).__name__}")
    return _lower(schema, "$")
