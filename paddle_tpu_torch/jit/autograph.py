"""AutoGraph: tensor-dependent python control flow under `@to_static`
(counterpart of paddle_tpu/jit/autograph.py; reference
python/paddle/fluid/dygraph/dygraph_to_static/convert_operators.py
`convert_ifelse` / `convert_while_loop`, ifelse_transformer.py,
loop_transformer.py, return_transformer.py).

The AST transformers are the reference's, unchanged: `if` / `elif` /
`else`, guard-clause returns, `while`, `for … in range(n)`, `for x in
tensor`, and `break` / `continue` / `return` inside loops rewritten
into boolean flags threaded through the loop carry. What does not
convert runs unconverted with a warning, and error locations map back
to the user's file and line (the transformed code compiles against the
original filename and line offsets).

Only the runtime dispatchers differ. The reference runs them inside a
jax trace; PyTorch runs eagerly, so a dispatcher looks at what the
condition is:

* a concrete tensor (or a python value): python's own semantics — one
  `bool()` of the condition (one host read on the card), the taken arm
  or the loop runs in python and autograd sees exactly the ops that ran;
* a fake tensor, which is what a condition is while `jit.save` exports
  (`torch.export`) or `static.Program.freeze` traces (`make_fx`): the
  dispatcher emits `torch.cond`, `torch._higher_order_ops.while_loop`
  or `scan`, under the reference's rules — both arms must leave the
  same structure, and a slot one arm leaves unbound (UNDEF) or a python
  scalar the other turns into a tensor is promoted to a tensor
  (`_unify`, the counterpart of `_dispatch_if_promote`). The arms are
  probed first with the tracer's proxy mode off (shapes only, nothing
  recorded), so their side effects run once more, as the reference's
  abstract evaluation runs them.

In eager mode only the taken arm runs, so arms of unequal structure do
not raise there (the reference traces both at every call); `jit.save`
of such a function still raises. An eager `while` over a tensor test is
differentiable, where the reference's `lax.while_loop` is not.
"""
import ast
import contextlib
import copy
import functools
import inspect
import textwrap
import types
import warnings

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["maybe_convert", "convert"]


# --------------------------------------------------------------- runtime

class _Undef:
    """Placeholder for a variable not yet bound on the current path."""

    __slots__ = ()

    def __repr__(self):
        return "<autograph: unbound variable>"

    def _raise(self, name="a variable"):
        raise NameError(
            f"to_static autograph: {name} is used before assignment on "
            "this path")

    def __getattr__(self, k):
        self._raise()

    def __bool__(self):
        self._raise()


UNDEF = _Undef()


def capture(*thunks):
    """Current values of the threaded variables; UNDEF when unbound."""
    out = []
    for th in thunks:
        try:
            out.append(th())
        except NameError:
            out.append(UNDEF)
    return tuple(out)


def _is_traced(v):
    """A fake tensor: a value seen while `torch.export` or `make_fx`
    traces, which has no data to branch on."""
    if not isinstance(v, torch.Tensor):
        return False
    if torch.compiler.is_compiling():
        # inside the body of a higher-order op, which torch traces with
        # dynamo: every tensor there is symbolic
        return True
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(v)


@contextlib.contextmanager
def _no_record(*like):
    """Run ops on fake tensors without recording them in the graph (the
    shape probe of an arm or a loop body). Symbols a data-dependent op
    creates there (a tensor index's `item()`) are dropped with it."""
    if torch.compiler.is_compiling():
        # under dynamo (a nested op's body) the probe's ops are dead code
        # that the captured graph drops
        yield
        return
    from torch._guards import detect_fake_mode
    from torch.fx.experimental.proxy_tensor import \
        disable_proxy_modes_tracing

    mode = detect_fake_mode([t for t in like if isinstance(t, torch.Tensor)])
    env = getattr(mode, "shape_env", None)
    with disable_proxy_modes_tracing(), (
            env.ignore_fresh_unbacked_symbols() if env is not None
            else contextlib.nullcontext()):
        yield


def _as_pred(pv, where):
    if not isinstance(pv, torch.Tensor):
        pv = torch.full((), bool(pv), dtype=torch.bool)
    if pv.dim() != 0:
        raise ValueError(
            f"to_static autograph: condition in {where} has shape "
            f"{tuple(pv.shape)}; a tensor condition must be a scalar")
    return pv if pv.dtype == torch.bool else pv != 0


def _truth(v):
    """Python truth of a concrete condition (one host read for a CUDA
    tensor)."""
    return bool(v)


# -- control-flag runtime for rewritten break/continue/return ----------
# (reference: dygraph_to_static/break_continue_transformer.py:1 and
# return_transformer.py:1 rewrite loop control into boolean variables;
# here the flags are python booleans until a traced branch makes them
# tensors)

def false_():
    # a python bool, not a tensor: concrete flags keep python-mode break
    # semantics; a traced branch promotes them (see _unify)
    return False


def true_():
    return True


def _flag_tensor(f, like):
    # `full`, not `tensor`: a tensor constant inside a loop body cannot
    # be serialized with the program
    return f if isinstance(f, torch.Tensor) else torch.full(
        (), bool(f), dtype=torch.bool, device=like.device)


def no_flag(*flags):
    """True when NO control flag is set — the guard predicate wrapped
    around statements that follow a rewritten break/continue/return.
    numpy on concrete flags, a tensor once any flag is traced."""
    traced = [f for f in flags if _is_traced(f)]
    if traced:
        out = None
        for f in flags:
            f = _flag_tensor(f, traced[0])
            out = f if out is None else torch.logical_or(out, f)
        return torch.logical_not(out)
    return not any(_truth(f) for f in flags)


def loop_and(ok, test_thunk):
    """Short-circuit `ok and test()` for rewritten loop conditions:
    python-lazy when `ok` is concrete (a set break flag must not
    re-evaluate a side-effecting test — exact python `break`
    semantics), logical_and under trace."""
    if not _is_traced(ok):
        if not _truth(ok):
            return False
        return test_thunk()
    t = _as_pred(test_thunk(), "<loop condition>")
    return torch.logical_and(ok, t)


class _Dyn:
    """A tensor leaf's slot in a structure signature."""

    __slots__ = ()


_DYN = _Dyn()


def _split_leaves(out):
    """(treedef, static_sig, dyn_leaves): tensors are dynamic,
    everything else is trace-time static."""
    leaves, treedef = pytree.tree_flatten(out)
    sig, dyn = [], []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            dyn.append(leaf)
            sig.append(_DYN)
        else:
            sig.append(leaf)
    return treedef, sig, dyn


def _join_leaves(treedef, sig, dyn):
    it = iter(dyn)
    leaves = [next(it) if s is _DYN else s for s in sig]
    return pytree.tree_unflatten(leaves, treedef)


def _static_eq(a, b):
    if a is b:
        return True
    if type(a) is not type(b):
        return False
    try:
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        return bool(a == b)
    except Exception:
        return False


def _promotable_static(s):
    """Static leaves a traced branch/loop may legally turn dynamic:
    UNDEF (the return-value slot) and plain python/numpy scalars
    (control flags, loop counters)."""
    return s is UNDEF or isinstance(
        s, (bool, int, float, np.bool_, np.integer, np.floating))


def _scalar_dtype(s):
    if isinstance(s, (bool, np.bool_)):
        return torch.bool
    if isinstance(s, (int, np.integer)):
        return torch.int64
    return torch.get_default_dtype()


def _meta_eq(a, b):
    return a.shape == b.shape and a.dtype == b.dtype


def _unify(sig_a, dyn_a, sig_b, dyn_b):
    """The unified signature of two structures that differ at most by
    promotable leaves: a list of (kind, payload) per leaf — ("static",
    value), or ("dyn", (shape, dtype)) — or None when they genuinely
    mismatch."""
    uni = []
    ia, ib = iter(dyn_a), iter(dyn_b)
    for sa, sb in zip(sig_a, sig_b):
        ta = next(ia) if sa is _DYN else None
        tb = next(ib) if sb is _DYN else None
        if ta is not None and tb is not None:
            if not _meta_eq(ta, tb):
                return None
            uni.append(("dyn", (ta.shape, ta.dtype)))
        elif ta is not None or tb is not None:
            t, other = (ta, sb) if ta is not None else (tb, sa)
            if not _promotable_static(other):
                return None
            uni.append(("dyn", (t.shape, t.dtype)))
        elif _static_eq(sa, sb):
            uni.append(("static", sa))
        elif _promotable_static(sa) and _promotable_static(sb) \
                and sa is not UNDEF and sb is not UNDEF:
            # e.g. a control flag: True in one arm, False in the other
            dt = torch.promote_types(_scalar_dtype(sa), _scalar_dtype(sb))
            uni.append(("dyn", (torch.Size([]), dt)))
        else:
            return None
    return uni


def _emit(sig, dyn, uni, device, operands):
    """The tensors one arm hands to the higher-order op under the
    unified signature: its own tensors (cloned where they alias an
    operand, which the ops refuse), zeros for an UNDEF slot, a promoted
    python scalar as a tensor."""
    out = []
    it = iter(dyn)
    for s, (kind, payload) in zip(sig, uni):
        own = next(it) if s is _DYN else None
        if kind != "dyn":
            continue
        shape, dtype = payload
        if own is not None:
            if any(own is o for o in operands):
                own = own.clone()
            out.append(own)
        elif s is UNDEF:
            out.append(torch.zeros(shape, dtype=dtype, device=device))
        else:
            out.append(torch.full(shape, s, dtype=dtype, device=device))
    return tuple(out)


def _rebuild_from_uni(treedef, uni, dyn):
    it = iter(dyn)
    leaves = [next(it) if kind == "dyn" else payload
              for kind, payload in uni]
    return pytree.tree_unflatten(leaves, treedef)


def _mismatch(where, err=None):
    return ValueError(
        f"to_static autograph: the two branches of the tensor `if` in "
        f"{where} produce different structures/python values — every "
        "variable assigned under a tensor condition must leave both "
        "branches with the same type and structure")


def _dispatch_if(pred, true_fn, false_fn, vals, where):
    if not _is_traced(pred):
        return true_fn(*vals) if _truth(pred) else false_fn(*vals)
    pv = _as_pred(pred, where)
    dyn_idx = [i for i, v in enumerate(vals) if isinstance(v, torch.Tensor)]
    operands = tuple(vals[i] for i in dyn_idx)

    def local(ops):
        out = list(vals)
        for k, i in enumerate(dyn_idx):
            out[i] = ops[k]
        return out

    # NO try/except around the probe: a user bug inside an arm must
    # surface as itself, not as a structure-mismatch report
    with _no_record(pv, *operands):
        td_t, sig_t, dyn_t = _split_leaves(true_fn(*vals))
        td_f, sig_f, dyn_f = _split_leaves(false_fn(*vals))
    if td_t != td_f or len(sig_t) != len(sig_f):
        raise _mismatch(where)
    uni = _unify(sig_t, dyn_t, sig_f, dyn_f)
    if uni is None:
        raise _mismatch(where)
    if not any(kind == "dyn" for kind, _ in uni):
        return _rebuild_from_uni(td_t, uni, [])

    def arm(branch):
        def pure(*ops):
            _, sig, dyn = _split_leaves(branch(*local(ops)))
            return _emit(sig, dyn, uni, pv.device, ops)

        return pure

    res = torch.cond(pv, arm(true_fn), arm(false_fn), operands)
    return _rebuild_from_uni(td_t, uni, list(res))


def run_ifelse(pred, true_fn, false_fn, vals, names, where="<if>"):
    """Non-terminal if: branch fns take and return the assigned-name
    tuple."""
    return _dispatch_if(pred, true_fn, false_fn, vals, where)


def run_terminal_if(pred, true_fn, false_fn, vals=(), where="<if>"):
    """Terminal if: both arms end in `return`; result is the value.
    `vals` threads the names assigned in either arm (as parameters, so
    fall-through code moved into an arm can rebind them)."""
    return _dispatch_if(pred, true_fn, false_fn, vals, where)


def _stabilize_carry(body_fn, vals, device, rounds=3):
    """Make the loop carry's structure a fixpoint of the body: probe
    the body without recording it, and wherever the body turns a static
    leaf dynamic, promote the INIT leaf too — UNDEF becomes zeros of the
    discovered shape (the return-value slot, never observed:
    flag-guarded), a python/numpy scalar becomes a tensor of its value
    (control flags, counters). Reference: loop_transformer.py promotes
    loop vars into Variables the same way. Leaves anything it can't
    promote for the standard structure error to report."""
    for _ in range(rounds):
        td0, sig0, dyn0 = _split_leaves(tuple(vals))
        try:
            with _no_record(*dyn0):
                td1, sig1, dyn1 = _split_leaves(tuple(body_fn(*vals)))
        except Exception:
            return vals   # let the standard structure error fire
        if td1 != td0 or len(sig1) != len(sig0):
            return vals
        leaves, it0, it1 = [], iter(dyn0), iter(dyn1)
        changed = False
        for s0, s1 in zip(sig0, sig1):
            t0 = next(it0) if s0 is _DYN else None
            t1 = next(it1) if s1 is _DYN else None
            if t1 is not None and t0 is None and _promotable_static(s0):
                leaves.append(
                    torch.zeros(t1.shape, dtype=t1.dtype, device=device)
                    if s0 is UNDEF else
                    torch.full(t1.shape, s0, dtype=t1.dtype, device=device))
                changed = True
            elif t0 is None and t1 is None and s0 is UNDEF \
                    and _promotable_static(s1) and s1 is not UNDEF:
                # body leaves the slot a CONSTANT (e.g. a continue flag
                # reset at body top): settle the unbound init on it
                leaves.append(s1)
                changed = True
            else:
                leaves.append(t0 if t0 is not None else s0)
        if not changed:
            return vals
        vals = tuple(pytree.tree_unflatten(leaves, td0))
    return vals


def _checked(where, td0, sig0):
    def check(out):
        td, sig, dyn = _split_leaves(tuple(out))
        if td != td0 or not all(_static_eq(a, b) for a, b in zip(sig, sig0)):
            raise ValueError(
                f"to_static autograph: a loop variable in {where} "
                "changed type/structure across iterations (e.g. a "
                "python value became a Tensor) — initialize it as a "
                "tensor of the final dtype before the loop")
        return dyn

    return check


def _fresh(dyn, operands):
    """Carry outputs that alias a carry input are cloned (the loop ops
    refuse aliasing outputs)."""
    return tuple(t.clone() if any(t is o for o in operands)
                 else t for t in dyn)


def run_while(test_fn, body_fn, vals, names, where="<while>"):
    t0 = test_fn(*vals)
    if not _is_traced(t0):
        # reuse t0 for the first decision: re-evaluating the test would
        # run its side effects one extra time vs the original loop
        t = t0
        while _truth(t):
            vals = body_fn(*vals)
            t = test_fn(*vals)
        return vals
    from torch._higher_order_ops.while_loop import while_loop

    vals = _stabilize_carry(body_fn, vals, t0.device)
    td0, sig0, dyn0 = _split_leaves(tuple(vals))
    check = _checked(where, td0, sig0)

    def rebuild(carry):
        return _join_leaves(td0, sig0, list(carry))

    def cond(*carry):
        return _as_pred(test_fn(*rebuild(carry)), where)

    def body(*carry):
        return _fresh(check(body_fn(*rebuild(carry))), carry)

    return rebuild(while_loop(cond, body, tuple(dyn0)))


def _exit_flag_idx(names):
    """Positions of rewritten break/return flags in the carry — the
    concrete (python-mode) loop paths honor them for EARLY EXIT, so a
    rewritten `for ...: break` over a concrete range keeps python's
    stop-now semantics instead of no-opping the remaining iterations."""
    return [k for k, n in enumerate(names)
            if n.startswith("__ag_brk") or n == "__ag_ret"]


def _exit_requested(vals, exit_idx):
    for k in exit_idx:
        v = vals[k]
        if not _is_traced(v) and v is not UNDEF and _truth(v):
            return True
    return False


def run_for_range(range_args, body_fn, vals, names, where="<for>"):
    traced = [a for a in range_args if _is_traced(a)]
    if not traced:
        exit_idx = _exit_flag_idx(names)
        for i in range(*(int(a) for a in range_args)):
            vals = body_fn(i, *vals)
            if exit_idx and _exit_requested(vals, exit_idx):
                break
        return vals
    from torch._higher_order_ops.while_loop import while_loop

    if len(range_args) == 1:
        start, stop, step = 0, range_args[0], 1
    elif len(range_args) == 2:
        start, stop, step = range_args[0], range_args[1], 1
    else:
        start, stop, step = range_args
    if _is_traced(step):
        raise ValueError(
            f"to_static autograph: range() step in {where} must be a "
            "python int when start/stop are tensors")
    step = int(step)
    if step == 0:
        raise ValueError("range() arg 3 must not be zero")
    device = traced[0].device
    i0 = (start.to(torch.int64) if isinstance(start, torch.Tensor)
          else torch.full((), int(start), dtype=torch.int64, device=device))
    vals = _stabilize_carry(lambda *vs: body_fn(i0, *vs), vals, device)
    td0, sig0, dyn0 = _split_leaves(tuple(vals))
    check = _checked(where, td0, sig0)

    def rebuild(carry):
        return _join_leaves(td0, sig0, list(carry))

    def cond(i, *carry):
        return i < stop if step > 0 else i > stop

    def body(i, *carry):
        out = check(body_fn(i.clone(), *rebuild(carry)))
        return (i + step,) + _fresh(out, carry)

    _, *res = while_loop(cond, body, (i0,) + tuple(dyn0))
    return rebuild(res)


def run_for_iter(it, body_fn, vals, names, where="<for>"):
    if not _is_traced(it):
        if isinstance(it, torch.Tensor):          # concrete tensor: rows
            it = [it[k] for k in range(it.shape[0])]
        exit_idx = _exit_flag_idx(names)
        for x in it:
            vals = body_fn(x, *vals)
            if exit_idx and _exit_requested(vals, exit_idx):
                break
        return vals
    from torch._higher_order_ops.scan import scan

    if it.shape[0] > 0:   # a 0-length scan has no row to probe with
        row0 = it[0]
        vals = _stabilize_carry(lambda *vs: body_fn(row0, *vs), vals,
                                it.device)
    td0, sig0, dyn0 = _split_leaves(tuple(vals))
    check = _checked(where, td0, sig0)

    def step(carry, row):
        out = _fresh(check(body_fn(row, *_join_leaves(td0, sig0,
                                                      list(carry)))),
                     carry)
        return out, ()

    # scan (a static trip count) over a contiguous copy: the op refuses
    # a view as its xs
    res, _ = scan(step, tuple(dyn0), it.clone())
    return _join_leaves(td0, sig0, list(res))


# ----------------------------------------------------------- AST analysis

class _Unsupported(Exception):
    pass


class _NameCollector(ast.NodeVisitor):
    """Names assigned by a statement list. def/class names are NOT
    collected: threading function objects through torch.cond is
    impossible (never equal across branches), and the generated
    __ag_* scaffolding itself must stay out of the enclosing
    analysis — so a def inside a converted tensor branch is
    branch-local by design."""

    def __init__(self):
        self.names = set()

    def visit_FunctionDef(self, node):
        pass  # name deliberately not threaded; skip body

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        pass

    def visit_Lambda(self, node):
        pass

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.names.add(node.id)

    def visit_Global(self, node):
        raise _Unsupported("global statement in a converted block")

    def visit_Nonlocal(self, node):
        raise _Unsupported("nonlocal statement in a converted block")


def _assigned_names(stmts):
    c = _NameCollector()
    for s in stmts:
        c.visit(s)
    return sorted(c.names)


class _StmtFinder(ast.NodeVisitor):
    def __init__(self, kinds):
        self.kinds = kinds
        self.found = False

    def generic_visit(self, node):
        if isinstance(node, self.kinds):
            self.found = True
        super().generic_visit(node)

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass


def _contains(node_or_list, kinds):
    f = _StmtFinder(kinds)
    for n in (node_or_list if isinstance(node_or_list, list)
              else [node_or_list]):
        f.visit(n)
    return f.found


def _contains_return(node_or_list):
    return _contains(node_or_list, ast.Return)


def _contains_raise(node_or_list):
    return _contains(node_or_list, ast.Raise)


class _BreakFinder(ast.NodeVisitor):
    """break/continue bound to the CURRENT loop (not nested loops)."""

    def __init__(self):
        self.found = False

    def visit_Break(self, node):
        self.found = True

    def visit_Continue(self, node):
        self.found = True

    def visit_While(self, node):
        pass

    def visit_For(self, node):
        pass

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef


def _has_own_break(body):
    f = _BreakFinder()
    for s in body:
        f.visit(s)
    return f.found


def _terminates(stmts):
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, (ast.Return, ast.Raise)):
        return True
    if isinstance(last, ast.If):
        return _terminates(last.body) and _terminates(last.orelse)
    return False


def _normalize_returns(block):
    """Guard-clause normalization (reference return_transformer.py): any
    `if` containing a `return` absorbs the statements after it into its
    non-returning arm, so converted ifs are either return-free or
    terminal (both arms end in return). Returns inside loops / with /
    try are unsupported (the caller falls back). Each arm is normalized
    EXACTLY ONCE, with its continuation already appended — normalizing
    an arm twice would re-move trailing statements into nested arms and
    duplicate side effects."""
    out = []
    i = 0
    while i < len(block):
        st = block[i]
        if isinstance(st, (ast.While, ast.For, ast.With, ast.Try)):
            if _contains_return(st):
                raise _Unsupported(
                    "return inside a loop/with/try under to_static "
                    "autograph — restructure to return after the block")
            out.append(st)
            i += 1
            continue
        if isinstance(st, ast.If) and _contains_return(st):
            rest = block[i + 1:]
            # raw (pre-normalization) _terminates is conservative-safe:
            # True only for tail returns, which stay terminating
            body_src = (st.body if _terminates(st.body)
                        else st.body + copy.deepcopy(rest))
            else_src = (st.orelse if _terminates(st.orelse)
                        else st.orelse + rest)
            st.body = _normalize_returns(body_src)
            st.orelse = _normalize_returns(else_src)
            out.append(st)
            return out  # everything after is inside the if now
        out.append(st)
        i += 1
    return out


# ---------------------------------------------- loop-control rewrite

def _stmt_ast(src, loc):
    mod = ast.parse(textwrap.dedent(src))
    for n in ast.walk(mod):
        ast.copy_location(n, loc)
    return mod.body


def _expr_ast(src, loc):
    return _stmt_ast(src, loc)[0].value


def _bc_under_with_try(body):
    """break/continue/return nested under With/Try inside this loop —
    kept as python (the rewrite can't guard across those scopes)."""
    for st in body:
        for n in ast.walk(st):
            if isinstance(n, (ast.With, ast.AsyncWith, ast.Try)):
                for m in ast.walk(n):
                    if isinstance(m, (ast.Break, ast.Continue,
                                      ast.Return)):
                        return True
    return False


class _LoopControlTransformer(ast.NodeTransformer):
    """Rewrite `break`/`continue`/`return` INSIDE loops into boolean
    control flags threaded through the loop carry (reference:
    dygraph_to_static/break_continue_transformer.py:1,
    return_transformer.py:1 — the same predicate-rewriting recipe
    targeting loop carries instead of static-graph Variables):

      break    → __ag_brkN = true()      continue → __ag_cntN = true()
      return e → __ag_ret = true(); __ag_rv = e

    every statement after a (possibly nested-in-`if`) flag set is
    guarded by `if no_flag(...)`; a while-test becomes
    `loop_and(no_flag(brk, ret), lambda: test)` (short-circuit — a set
    break flag never re-evaluates a side-effecting test); a loop that
    rewrote a return is followed by `if __ag_ret: return __ag_rv`,
    which the return normalizer + torch.cond machinery then convert. The
    return-value slot starts UNDEF; the runtime promotes it to zeros of
    the bound arm's aval (see _dispatch_if_promote /
    _discover_undef_init). `for` loops are rewritten only over range()
    (a generator iterated to exhaustion would change consumption
    semantics); break/continue under With/Try stay python."""

    def __init__(self):
        self._n = 0
        self.uses_ret = False

    def visit_FunctionDef(self, node):
        return node   # nested defs keep python semantics

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return node

    def visit_While(self, node):
        self.generic_visit(node)
        return self._rewrite(node, is_for=False)

    def visit_For(self, node):
        self.generic_visit(node)
        is_range = (isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range")
        if not is_range:
            return node
        return self._rewrite(node, is_for=True)

    def _rewrite(self, node, is_for):
        sets_ret_inner = any(getattr(n, "_ag_sets_ret", False)
                             for n in ast.walk(node))
        has_bc = _has_own_break(node.body)
        has_ret = _contains_return(node.body)
        if not (has_bc or has_ret or sets_ret_inner):
            return node
        if node.orelse or _bc_under_with_try(node.body):
            return node   # python fallback (honest warning downstream)
        self._n += 1
        uid = self._n
        brk, cnt = f"__ag_brk{uid}", f"__ag_cnt{uid}"
        loop_ret = {"used": has_ret or sets_ret_inner}
        new_body, _ = self._rw_body(node.body, brk, cnt, loop_ret, node)
        rt = "__paddle_tpu_autograph__"
        exit_flags = [brk] + (["__ag_ret"] if loop_ret["used"] else [])
        if is_for:
            # a `for` has no condition to stop it: once break/return
            # fires, every REMAINING iteration's whole body must no-op
            wrap = _stmt_ast(
                f"if {rt}.no_flag({', '.join(exit_flags)}):\n    pass",
                node)[0]
            wrap.body = new_body
            new_body = [wrap]
        new_body = _stmt_ast(f"{cnt} = {rt}.false_()", node) + new_body
        node.body = new_body
        if not is_for:
            test_holder = _expr_ast(
                f"{rt}.loop_and({rt}.no_flag({', '.join(exit_flags)}), "
                f"lambda: None)", node)
            test_holder.args[1].body = node.test
            node.test = test_holder
        out = _stmt_ast(
            f"{brk} = {rt}.false_()\n{cnt} = {rt}.false_()", node)
        out.append(node)
        if loop_ret["used"]:
            self.uses_ret = True
            node._ag_sets_ret = True
            post = _stmt_ast("if __ag_ret:\n    return __ag_rv", node)
            out.extend(post)
        return out

    def _rw_body(self, stmts, brk, cnt, loop_ret, loc):
        """Returns (rewritten statements, any-flag-setter)."""
        rt = "__paddle_tpu_autograph__"
        out = []
        any_setter = False
        for i, st in enumerate(stmts):
            new, setter = self._rw_stmt(st, brk, cnt, loop_ret, loc)
            out.extend(new)
            any_setter = any_setter or setter
            if setter and i + 1 < len(stmts):
                rest, _ = self._rw_body(stmts[i + 1:], brk, cnt,
                                        loop_ret, loc)
                flags = [brk, cnt] + (["__ag_ret"] if loop_ret["used"]
                                      else [])
                guard = _stmt_ast(
                    f"if {rt}.no_flag({', '.join(flags)}):\n    pass",
                    loc)[0]
                guard.body = rest
                out.append(guard)
                return out, True
        return out, any_setter

    def _rw_stmt(self, st, brk, cnt, loop_ret, loc):
        rt = "__paddle_tpu_autograph__"
        if isinstance(st, ast.Break):
            return _stmt_ast(f"{brk} = {rt}.true_()", st), True
        if isinstance(st, ast.Continue):
            return _stmt_ast(f"{cnt} = {rt}.true_()", st), True
        if isinstance(st, ast.Return):
            loop_ret["used"] = True
            stmts = _stmt_ast(
                f"__ag_ret = {rt}.true_()\n__ag_rv = None", st)
            if st.value is not None:
                stmts[1].value = st.value
            return stmts, True
        if isinstance(st, ast.If):
            body, s1 = self._rw_body(st.body, brk, cnt, loop_ret, loc)
            orelse, s2 = self._rw_body(st.orelse, brk, cnt, loop_ret,
                                       loc)
            st.body = body
            st.orelse = orelse
            return [st], s1 or s2
        if isinstance(st, (ast.While, ast.For)):
            # inner loop (already rewritten): it re-raises only the
            # function-level return flag
            return [st], getattr(st, "_ag_sets_ret", False)
        return [st], False


# -------------------------------------------------------- AST transforms

def _names_tuple_src(names):
    return "(" + ", ".join(names) + ("," if len(names) == 1 else "") + ")"


def _capture_src(names):
    return "__paddle_tpu_autograph__.capture(" + ", ".join(
        f"(lambda: {n})" for n in names) + ")"


class _CFTransformer(ast.NodeTransformer):
    def __init__(self, where):
        self._n = 0
        self._where = where

    def _uid(self):
        self._n += 1
        return self._n

    def visit_FunctionDef(self, node):
        return node  # nested defs keep python semantics

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return node

    def _scaffold(self, src, loc):
        mod = ast.parse(textwrap.dedent(src))
        for n in ast.walk(mod):
            ast.copy_location(n, loc)
        return mod.body

    def visit_If(self, node):
        self.generic_visit(node)
        if _contains_raise(node):
            # the export traces BOTH arms: a raise in either would fire at
            # trace time regardless of the predicate. Leave python
            # semantics (a traced tensor test then gets torch.s data-dependent
            # error, which names the offending line).
            return node
        uid = self._uid()
        where = f"{self._where}:{node.lineno}"
        try:
            names = _assigned_names(node.body + node.orelse)
        except _Unsupported:
            return node  # global/nonlocal: leave this if as python
        if _contains_return(node):
            # terminal: both arms end in return (normalization ensured).
            # Assigned names are threaded as PARAMETERS so fall-through
            # code moved into an arm can reassign variables bound before
            # the if (a bare nested def would make them locals and raise
            # UnboundLocalError on first read).
            params = ", ".join(names)
            stmts = self._scaffold(f"""
def __ag_t{uid}({params}):
    pass
def __ag_f{uid}({params}):
    pass
return __paddle_tpu_autograph__.run_terminal_if(__AG_TEST__, __ag_t{uid}, __ag_f{uid},
                              {_capture_src(names)}, {where!r})
""", node)
            stmts[0].body = node.body
            stmts[1].body = node.orelse or [ast.copy_location(
                ast.Return(value=ast.Constant(value=None)), node)]
            stmts[2].value.args[0] = node.test
            return stmts
        if not names:
            # pure side-effect-free branch? keep original python `if`
            # (a traced tensor test on it raises torch.s data-dependent error)
            return node
        params = ", ".join(names)
        ret = _names_tuple_src(names)
        stmts = self._scaffold(f"""
def __ag_t{uid}({params}):
    return {ret}
def __ag_f{uid}({params}):
    return {ret}
{ret} = __paddle_tpu_autograph__.run_ifelse(__AG_TEST__, __ag_t{uid}, __ag_f{uid},
                          {_capture_src(names)}, {names!r}, {where!r})
""", node)
        stmts[0].body = node.body + [stmts[0].body[-1]]
        stmts[1].body = (node.orelse or []) + [stmts[1].body[-1]]
        stmts[2].value.args[0] = node.test
        return stmts

    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse or _has_own_break(node.body) or \
                _contains_return(node.body) or \
                _contains_raise(node.body):
            return node
        try:
            names = _assigned_names(node.body)
        except _Unsupported:
            return node
        if not names:
            return node
        uid = self._uid()
        where = f"{self._where}:{node.lineno}"
        params = ", ".join(names)
        ret = _names_tuple_src(names)
        stmts = self._scaffold(f"""
def __ag_c{uid}({params}):
    return __AG_TEST__
def __ag_b{uid}({params}):
    return {ret}
{ret} = __paddle_tpu_autograph__.run_while(__ag_c{uid}, __ag_b{uid},
                         {_capture_src(names)}, {names!r}, {where!r})
""", node)
        stmts[0].body[0].value = node.test
        stmts[1].body = node.body + [stmts[1].body[-1]]
        return stmts

    def visit_For(self, node):
        self.generic_visit(node)
        if node.orelse or _has_own_break(node.body) or \
                _contains_return(node.body) or \
                _contains_raise(node.body) or \
                not isinstance(node.target, ast.Name):
            return node
        try:
            names = _assigned_names(node.body)
        except _Unsupported:
            return node
        names = sorted(set(names) - {node.target.id})
        if not names:
            # side-effect-only body (e.g. list.append): a scan carry of
            # () would leak loop tracers into the appended objects —
            # keep python iteration
            return node
        tgt = node.target.id
        uid = self._uid()
        where = f"{self._where}:{node.lineno}"
        params = ", ".join([tgt] + names) if names else tgt
        ret = _names_tuple_src(names)
        is_range = (isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range"
                    and not node.iter.keywords
                    and 1 <= len(node.iter.args) <= 3
                    and not any(isinstance(a, ast.Starred)
                                for a in node.iter.args))
        runner = "run_for_range" if is_range else "run_for_iter"
        assign = (f"{ret} = " if names else "")  # `() = …` is a syntax
        stmts = self._scaffold(f"""
def __ag_b{uid}({params}):
    return {ret}
{assign}__paddle_tpu_autograph__.{runner}(__AG_ITER__, __ag_b{uid},
                        {_capture_src(names)}, {names!r}, {where!r})
""", node)
        stmts[0].body = node.body + [stmts[0].body[-1]]
        call = stmts[1].value
        if is_range:
            call.args[0] = ast.copy_location(
                ast.Tuple(elts=list(node.iter.args), ctx=ast.Load()),
                node)
        else:
            call.args[0] = node.iter
        return stmts


# ------------------------------------------------------------ conversion

# weak keys: functions and code objects are weakref-able, and the cached
# converted function must not pin dead closures (or their captured
# Layers/Parameters) for the life of the process
import weakref

_CACHE = weakref.WeakKeyDictionary()
_FAILED = weakref.WeakSet()


def convert(fn):
    """AST-convert `fn`; raises on unsupported constructs."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError) as e:
        raise _Unsupported(f"source unavailable: {e}")
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        raise _Unsupported("not a plain function")
    fdef.decorator_list = []
    if not _terminates(fdef.body):
        fdef.body.append(ast.Return(value=ast.Constant(value=None)))
    # loop-control pre-pass: break/continue/return inside loops become
    # carried flags BEFORE return normalization (which otherwise
    # rejects return-in-loop) and before the cond/while conversion
    lct = _LoopControlTransformer()
    body = []
    for s in fdef.body:
        r = lct.visit(s)
        body.extend(r if isinstance(r, list) else [r])
    if lct.uses_ret:
        body = _stmt_ast(
            "__ag_ret = __paddle_tpu_autograph__.false_()\n"
            "__ag_rv = __paddle_tpu_autograph__.UNDEF", fdef) + body
    fdef.body = body
    fdef.body = _normalize_returns(fdef.body)
    where = f"{fn.__module__}.{fn.__qualname__}"
    tf = _CFTransformer(where)
    fdef.body = [tf.visit(s) for s in fdef.body]
    fdef.body = [s for sub in fdef.body
                 for s in (sub if isinstance(sub, list) else [sub])]
    ast.fix_missing_locations(tree)
    ast.increment_lineno(tree, fn.__code__.co_firstlineno - 1)

    freevars = fn.__code__.co_freevars
    # The runtime is injected as a CLOSURE CELL, not a global: the
    # converted body is always nested in an __ag_outer__ whose params
    # are the original free variables plus __paddle_tpu_autograph__, so
    # exec runs against the user's REAL module globals untouched —
    # `global x` writes keep mutating the module (STORE_GLOBAL bypasses
    # dict-subclass overrides, so a chained-dict shim cannot provide
    # that), and converting a function never adds a binding to it.
    outer = ast.FunctionDef(
        name="__ag_outer__",
        args=ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=n) for n in freevars]
            + [ast.arg(arg="__paddle_tpu_autograph__")],
            vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
            defaults=[]),
        body=[fdef, ast.Return(value=ast.Name(id=fdef.name,
                                              ctx=ast.Load()))],
        decorator_list=[])
    tree.body = [outer]
    ast.fix_missing_locations(tree)
    ast.increment_lineno(tree, 0)
    code = compile(tree, filename=fn.__code__.co_filename, mode="exec")
    localns = {}
    exec(code, fn.__globals__, localns)
    cells = ([c.cell_contents for c in fn.__closure__]
             if freevars else [])
    new_fn = localns["__ag_outer__"](*cells, _runtime_module())
    new_fn.__defaults__ = fn.__defaults__
    new_fn.__kwdefaults__ = fn.__kwdefaults__
    functools.update_wrapper(new_fn, fn)
    # update_wrapper pins the original via __wrapped__ — drop it so the
    # weak conversion cache can collect dead closures
    del new_fn.__wrapped__
    return new_fn


def _runtime_module():
    import sys

    return sys.modules[__name__]


def maybe_convert(fn):
    """Convert-with-fallback, weakly cached per function object."""
    if getattr(fn, "_not_to_static", False):
        return fn
    if inspect.ismethod(fn):
        # convert the underlying function, re-bind to the same instance
        # (compiling the source yields an UNBOUND function — calling it
        # in the bound method's place would drop `self`)
        conv = maybe_convert(fn.__func__)
        if conv is fn.__func__:
            return fn
        return types.MethodType(conv, fn.__self__)
    # closures bake cell CONTENTS at conversion time — key per function
    # object, not per code object, so distinct closures convert apart
    key = (fn if getattr(fn, "__closure__", None)
           else getattr(fn, "__code__", fn))
    try:
        if key in _FAILED:
            return fn
        cached = _CACHE.get(key)
    except TypeError:  # non-weakref-able callable: convert uncached
        cached = None
    if cached is not None:
        return cached
    try:
        conv = convert(fn)
    except Exception as e:
        warnings.warn(
            f"to_static autograph: leaving {getattr(fn, '__name__', fn)} "
            f"unconverted ({e}); tensor-dependent python control flow "
            "in it will not compile", stacklevel=3)
        try:
            _FAILED.add(key)
        except TypeError:
            pass
        return fn
    try:
        _CACHE[key] = conv
    except TypeError:
        pass
    return conv
