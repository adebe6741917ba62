"""Grammar compiler: regex → token-level DFA for constrained decoding
(counterpart of paddle_tpu/inference/structured/compiler.py; host Python
and numpy, its tables byte-equal to the reference's).

Per grammar, two dense host tables:

* ``trans``  int32 ``[n_states, vocab]`` — grammar-LOCAL next state for
  emitting token ``t`` in state ``q``, ``-1`` where the token is
  disallowed;
* ``accept`` bool ``[n_states]`` — states where the output so far is a
  complete match (the ONLY states where the request's eos token is
  unmasked).

A restricted regex (literals, escapes, ``.``, ``[...]`` classes, groups,
alternation, ``* + ? {m,n}`` — a subset that python's ``re`` also
accepts) is parsed to an AST, compiled to a Thompson NFA, determinized by
subset construction over the CHARACTER alphabet the tokenizer uses, and
closed over the token vocabulary: token ``t`` is allowed in state ``q``
iff running its string through the char DFA from ``q`` never dies, and
the token-level transition is the char path's end state. Multi-character
tokens constrain exactly like their character expansion.

A grammar whose DFA exceeds ``max_states`` raises ``GrammarError`` during
the subset walk, never after. The reference's process-wide counters
(compiles, rejects, resident states) belong to its metrics registry
(ROADMAP A10); the engine keeps its own counts (`arena.GrammarCache`).
"""
import hashlib

import numpy as np

__all__ = ["CompiledGrammar", "GrammarError", "compile_regex"]


class GrammarError(ValueError):
    """A constraint the engine refuses loudly at submit/compile time:
    unsupported syntax, a DFA over the state budget, an unsatisfiable
    pattern, or a full grammar arena."""


# ---- regex AST ----
# nodes: ("chars", frozenset) | ("cat", [n..]) | ("alt", [n..]) |
#        ("star", n) | ("plus", n) | ("opt", n) | ("rep", n, lo, hi)

_SPECIALS = set("\\.[](){}*+?|^$")
_ESC_CLASSES = {
    "d": frozenset("0123456789"),
    "w": frozenset("abcdefghijklmnopqrstuvwxyz"
                   "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
    "s": frozenset(" \t\n\r\f\v"),
}
_ESC_LITERALS = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v"}


class _Parser:
    """Recursive-descent parser for the supported regex subset. The
    alphabet is the TOKENIZER's character set: classes are materialized
    against it, so ``.`` and negated classes stay finite."""

    def __init__(self, pattern, alphabet):
        self.p = pattern
        self.i = 0
        self.alphabet = alphabet

    def error(self, msg):
        raise GrammarError(
            f"grammar=: {msg} at position {self.i} in {self.p!r}")

    def peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            self.error(f"unexpected {self.p[self.i]!r}")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self.peek() == "|":
            self.i += 1
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        parts = []
        while self.peek() not in (None, "|", ")"):
            parts.append(self._rep())
        if not parts:
            return ("cat", [])      # empty branch: matches ""
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _rep(self):
        node = self._atom()
        ch = self.peek()
        if ch == "*":
            self.i += 1
            return ("star", node)
        if ch == "+":
            self.i += 1
            return ("plus", node)
        if ch == "?":
            self.i += 1
            return ("opt", node)
        if ch == "{":
            return self._bounds(node)
        return node

    def _bounds(self, node):
        j = self.p.find("}", self.i)
        if j < 0:
            self.error("unterminated {m,n} quantifier")
        body = self.p[self.i + 1:j]
        self.i = j + 1
        parts = body.split(",")
        try:
            lo = int(parts[0])
            if len(parts) == 1:
                hi = lo
            elif parts[1] == "":
                hi = None           # {m,} — unbounded tail
            else:
                hi = int(parts[1])
        except ValueError:
            self.error(f"malformed quantifier {{{body}}}")
        if lo < 0 or (hi is not None and hi < lo):
            self.error(f"malformed quantifier {{{body}}}")
        return ("rep", node, lo, hi)

    def _atom(self):
        ch = self.peek()
        if ch is None:
            self.error("dangling quantifier or empty atom")
        if ch == "(":
            self.i += 1
            if self.p[self.i:self.i + 2] == "?:":
                self.i += 2         # non-capturing groups: same thing
            node = self._alt()
            if self.peek() != ")":
                self.error("unterminated group")
            self.i += 1
            return node
        if ch == "[":
            return self._char_class()
        if ch == ".":
            self.i += 1
            return ("chars", frozenset(self.alphabet) - {"\n"})
        if ch == "\\":
            return self._escape()
        if ch in "*+?{":
            self.error(f"quantifier {ch!r} with nothing to repeat")
        if ch in ")]":
            self.error(f"unmatched {ch!r}")
        if ch in "^$":
            self.error(f"anchors are implicit (whole-output match); "
                       f"{ch!r} unsupported")
        self.i += 1
        return ("chars", frozenset((ch,)))

    def _escape(self):
        self.i += 1
        ch = self.peek()
        if ch is None:
            self.error("dangling backslash")
        self.i += 1
        if ch in _ESC_CLASSES:
            return ("chars", _ESC_CLASSES[ch] & self.alphabet)
        if ch in ("D", "W", "S"):
            return ("chars",
                    self.alphabet - _ESC_CLASSES[ch.lower()])
        if ch in _ESC_LITERALS:
            return ("chars", frozenset((_ESC_LITERALS[ch],)))
        return ("chars", frozenset((ch,)))

    def _char_class(self):
        self.i += 1                  # past '['
        negate = self.peek() == "^"
        if negate:
            self.i += 1
        chars = set()
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                self.error("unterminated character class")
            if ch == "]" and not first:
                self.i += 1
                break
            first = False
            if ch == "\\":
                node = self._escape()
                chars |= set(node[1])
                continue
            self.i += 1
            if (self.peek() == "-" and self.i + 1 < len(self.p)
                    and self.p[self.i + 1] != "]"):
                self.i += 1
                hi = self.p[self.i]
                self.i += 1
                for o in range(ord(ch), ord(hi) + 1):
                    chars.add(chr(o))
            else:
                chars.add(ch)
        if negate:
            return ("chars", self.alphabet - chars)
        return ("chars", frozenset(chars) & self.alphabet
                if chars & self.alphabet or not chars
                else frozenset(chars) & self.alphabet)


# ---- Thompson NFA ----

class _NFA:
    """States are dicts {"eps": [ids], "edges": [(frozenset, id)]};
    fragments carry one start and one end id (epsilon-linked), so
    {m,n} expansion can recompile the same AST node repeatedly."""

    def __init__(self):
        self.states = []

    def new(self):
        self.states.append({"eps": [], "edges": []})
        return len(self.states) - 1

    def build(self, node):
        kind = node[0]
        if kind == "chars":
            s, e = self.new(), self.new()
            if node[1]:              # empty class: no edge = dead atom
                self.states[s]["edges"].append((node[1], e))
            return s, e
        if kind == "cat":
            if not node[1]:
                s = self.new()
                return s, s
            s, e = self.build(node[1][0])
            for sub in node[1][1:]:
                s2, e2 = self.build(sub)
                self.states[e]["eps"].append(s2)
                e = e2
            return s, e
        if kind == "alt":
            s, e = self.new(), self.new()
            for sub in node[1]:
                s2, e2 = self.build(sub)
                self.states[s]["eps"].append(s2)
                self.states[e2]["eps"].append(e)
            return s, e
        if kind == "star":
            s, e = self.new(), self.new()
            s2, e2 = self.build(node[1])
            self.states[s]["eps"] += [s2, e]
            self.states[e2]["eps"] += [s2, e]
            return s, e
        if kind == "plus":
            s2, e2 = self.build(node[1])
            e = self.new()
            self.states[e2]["eps"] += [s2, e]
            return s2, e
        if kind == "opt":
            s, e = self.new(), self.new()
            s2, e2 = self.build(node[1])
            self.states[s]["eps"] += [s2, e]
            self.states[e2]["eps"].append(e)
            return s, e
        if kind == "rep":
            _, sub, lo, hi = node
            parts = [sub] * lo
            if hi is None:
                parts.append(("star", sub))
            else:
                parts += [("opt", sub)] * (hi - lo)
            return self.build(("cat", parts))
        raise GrammarError(f"grammar=: internal: unknown node {kind!r}")


def _eps_closure(states, seed):
    out = set(seed)
    stack = list(seed)
    while stack:
        for t in states[stack.pop()]["eps"]:
            if t not in out:
                out.add(t)
                stack.append(t)
    return frozenset(out)


def _char_dfa(pattern, alphabet, max_states):
    """Subset construction → (trans {state: {char: next}}, accept set).
    Aborts with GrammarError the moment the DFA exceeds max_states —
    the budget check runs DURING the walk, not after."""
    ast = _Parser(pattern, frozenset(alphabet)).parse()
    nfa = _NFA()
    start, end = nfa.build(ast)
    st = nfa.states
    d0 = _eps_closure(st, {start})
    index = {d0: 0}
    queue = [d0]
    trans = {0: {}}
    accept = set()
    if end in d0:
        accept.add(0)
    while queue:
        cur = queue.pop(0)
        ci = index[cur]
        for ch in alphabet:
            nxt = set()
            for sid in cur:
                for cs, t in st[sid]["edges"]:
                    if ch in cs:
                        nxt.add(t)
            if not nxt:
                continue
            closed = _eps_closure(st, nxt)
            ni = index.get(closed)
            if ni is None:
                if len(index) >= max_states:
                    raise GrammarError(
                        f"grammar=: DFA for {pattern!r} exceeds the "
                        f"state budget ({max_states}); raise "
                        "LLMEngineConfig(grammar_states=...) or "
                        "simplify the grammar")
                ni = index[closed] = len(index)
                trans[ni] = {}
                if end in closed:
                    accept.add(ni)
                queue.append(closed)
            trans[ci][ch] = ni
    return trans, accept


class CompiledGrammar:
    """One grammar's token-level DFA (module docstring). Immutable
    after construction; shared freely across requests and threads."""

    def __init__(self, pattern, trans, accept, eos_id, vocab_fp):
        self.pattern = pattern
        self.trans = trans                 # int32 [n_states, vocab]
        self.accept = accept               # bool [n_states]
        self.eos_id = eos_id
        self.n_states = int(trans.shape[0])
        self.vocab = int(trans.shape[1])
        self._allowed = trans >= 0         # bool [n_states, vocab]
        h = hashlib.sha1()
        h.update(pattern.encode("utf-8"))
        h.update(str(eos_id).encode())
        h.update(vocab_fp)
        self.hash = h.hexdigest()

    def advance(self, state, token):
        """Host-side replay of ONE emitted token — the engine keeps
        each constrained request's DFA state as a pure function of its
        generated tokens, so preemption replay is correct for free.
        A disallowed token (impossible under in-executable masking;
        defensive) leaves the state unchanged."""
        ns = int(self.trans[int(state), int(token)])
        return ns if ns >= 0 else int(state)

    def replay(self, tokens, state=0):
        """DFA state after emitting `tokens` from `state` — the
        reference the preemption test pins the live state against."""
        for t in tokens:
            if self.eos_id is not None and int(t) == self.eos_id:
                break
            state = self.advance(state, t)
        return state

    def allowed_np(self, state):
        """bool [vocab] mask for one state — the HOST tick's masking
        row (the single-tick path masks logits before argmax/sampling
        on the host; the fused/verify executables use the arena
        bitsets instead)."""
        return self._allowed[int(state)]

    def is_complete(self, state):
        return bool(self.accept[int(state)])


def compile_regex(pattern, token_strs, eos_id=None, max_states=128):
    """Compile one regex into a token-level `CompiledGrammar` over the
    engine's vocabulary. ``token_strs[t]`` is token ``t``'s surface
    string; empty strings (specials, padding ids) are disallowed in
    every state. ``eos_id`` (required by the engine for constrained
    requests) is allowed exactly in accepting states, as a self-loop —
    generation ends there anyway, the self-loop just keeps `advance`
    total. Raises `GrammarError` over ``max_states``."""
    if not isinstance(pattern, str) or not pattern:
        raise GrammarError(
            "grammar=: expected a non-empty regex string, got "
            f"{pattern!r}")
    vocab = len(token_strs)
    alphabet = sorted({ch for s in token_strs for ch in s})
    ctrans, caccept = _char_dfa(pattern, alphabet, int(max_states))
    n = len(ctrans)
    trans = np.full((n, vocab), -1, np.int32)
    for t, s in enumerate(token_strs):
        if not s or (eos_id is not None and t == eos_id):
            continue
        # run the token's character path from every state; surviving
        # paths define the token-level transition
        for q in range(n):
            cur = q
            for ch in s:
                cur = ctrans[cur].get(ch)
                if cur is None:
                    break
            else:
                trans[q, t] = cur
    accept = np.zeros((n,), bool)
    for q in caccept:
        accept[q] = True
    if eos_id is not None:
        if not 0 <= int(eos_id) < vocab:
            raise GrammarError(
                f"grammar=: eos_token_id {eos_id} outside the "
                f"vocabulary [0, {vocab})")
        for q in range(n):
            if accept[q]:
                trans[q, int(eos_id)] = q
    if not (trans[0] >= 0).any():
        raise GrammarError(
            f"grammar=: {pattern!r} is unsatisfiable over this "
            "vocabulary (no token is allowed in the start state)")
    vocab_fp = hashlib.sha1(
        "\x00".join(token_strs).encode("utf-8")).digest()
    return CompiledGrammar(pattern, trans, accept,
                           None if eos_id is None else int(eos_id),
                           vocab_fp)
