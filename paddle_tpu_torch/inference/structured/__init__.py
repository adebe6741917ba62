"""Structured decoding (counterpart of paddle_tpu/inference/structured):
grammar-constrained generation, n-gram speculation, and the per-request
constraint surface.

* `compiler` / `schema` — host-side grammar compilation: a regex (or a
  JSON schema lowered through `schema_to_regex`) becomes a token-level
  DFA (`CompiledGrammar`) whose tables the engine's `GrammarArena` keeps
  on the device, so constrained rows are masked inside the k=1 tick, the
  fused window's CUDA graph and the speculative verify.
* `arena` — the fixed device-table arena (mask-identity row 0).
* `ngram` — `NgramSpeculator`, prompt-lookup speculation through the
  verify step (`LLMEngineConfig(spec_mode="ngram")`).

`validate_constraints` is the submit-time gate `LLMServer.submit` and
`LLMEngine.add_request` run, so a malformed constraint kwarg raises at
submit() with the offending name instead of inside the serve loop.

`NgramSpeculator` is not imported here: ngram pulls in the speculative /
engine stack, which imports this package for validation.
"""
from .arena import GrammarArena
from .compiler import CompiledGrammar, GrammarError, compile_regex
from .schema import schema_to_regex

__all__ = [
    "CompiledGrammar", "GrammarArena", "GrammarError", "SPEC_MODES",
    "compile_regex", "schema_to_regex", "validate_constraints",
]

SPEC_MODES = ("off", "draft", "ngram")


def validate_constraints(grammar=None, json_schema=None, spec_mode=None):
    """Structural validation of the per-request constraint kwargs, at
    submit() time, naming the offending kwarg. The checks that need the
    engine (token_strs configured, spec_mode matching the engine's, the
    compile itself) run in the engine's `_resolve_constraint`."""
    if grammar is not None and json_schema is not None:
        raise ValueError(
            "grammar=/json_schema=: pass ONE constraint per request, "
            "not both")
    if grammar is not None and not isinstance(
            grammar, (str, CompiledGrammar)):
        raise ValueError(
            "grammar= must be a regex string or a CompiledGrammar, "
            f"got {type(grammar).__name__}")
    if isinstance(grammar, str) and not grammar:
        raise ValueError("grammar= must be a non-empty regex string")
    if json_schema is not None and not isinstance(json_schema, dict):
        raise ValueError(
            "json_schema= must be a dict (a parsed JSON schema), got "
            f"{type(json_schema).__name__}")
    if spec_mode is not None and spec_mode not in SPEC_MODES:
        raise ValueError(
            f"spec_mode= must be one of {SPEC_MODES} or None, got "
            f"{spec_mode!r}")
