"""Filter-expression compiler: the paper's "filter expression" web-form field.

GEPS users submit jobs with a filter expression over event variables (paper
section 5, Fig 4).  We compile a small expression language to a PyTorch
predicate over an EventBatch of tensors, evaluated in float32 on the
batch's own device, so the same user-facing query runs over the
device-resident bricks.

Grammar (precedence low->high):
    expr    := or
    or      := and ("||" and)*
    and     := cmp ("&&" cmp)*
    cmp     := sum (("<"|"<="|">"|">="|"=="|"!=") sum)?
    sum     := prod (("+"|"-") prod)*
    prod    := unary (("*"|"/") unary)*
    unary   := "-" unary | "!" unary | atom
    atom    := NUMBER | IDENT | AGG "(" IDENT ")" | "(" expr ")"
    AGG     := "sum" | "max" | "min" | "count" | "mean"

IDENT resolves scalar variables by name (events.SCALAR_VARS) or, inside an
aggregation, track variables (events.TRACK_VARS); ``n_tracks`` is built in.
Aggregations reduce over the valid tracks of each event, e.g.::

    "pt_lead > 50 && count(pt > 20) >= 2 && sum(pt) < 500"
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Optional, Sequence, Union

import torch

from repro_torch.core import events as ev

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?)|(?P<id>[A-Za-z_]\w*)"
    r"|(?P<op>&&|\|\||<=|>=|==|!=|[-+*/<>!()]))"
)

AGGS = ("sum", "max", "min", "count", "mean")


class QueryError(ValueError):
    """Malformed or schema-invalid filter expression."""


def tokenize(src: str) -> List[str]:
    """Split an expression into number/identifier/operator tokens."""
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m or m.end() == pos:
            if src[pos:].strip():
                raise QueryError(f"bad token at: {src[pos:]!r}")
            break
        out.append(m.group(m.lastgroup))
        pos = m.end()
    return out


# ---------------------------- AST ---------------------------------------- #
@dataclasses.dataclass
class Num:
    """AST leaf: a numeric literal."""
    value: float


@dataclasses.dataclass
class Var:
    """AST leaf: a scalar/track variable reference (resolved at eval)."""
    name: str


@dataclasses.dataclass
class Agg:
    """AST node: a track aggregation (sum/max/min/count/mean) over the
    valid tracks of each event."""
    fn: str
    arg: "Node"


@dataclasses.dataclass
class Unary:
    """AST node: unary negation (``-``) or logical not (``!``)."""
    op: str
    arg: "Node"


@dataclasses.dataclass
class Bin:
    """AST node: binary arithmetic / comparison / logic operator."""
    op: str
    lhs: "Node"
    rhs: "Node"


Node = Union[Num, Var, Agg, Unary, Bin]


class _Parser:
    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self, expect: Optional[str] = None) -> str:
        tok = self.peek()
        if tok is None or (expect is not None and tok != expect):
            raise QueryError(f"expected {expect!r}, got {tok!r}")
        self.i += 1
        return tok

    def parse(self) -> Node:
        node = self.or_()
        if self.peek() is not None:
            raise QueryError(f"trailing tokens: {self.toks[self.i:]}")
        return node

    def or_(self):
        node = self.and_()
        while self.peek() == "||":
            self.take()
            node = Bin("||", node, self.and_())
        return node

    def and_(self):
        node = self.cmp()
        while self.peek() == "&&":
            self.take()
            node = Bin("&&", node, self.cmp())
        return node

    def cmp(self):
        node = self.sum_()
        if self.peek() in ("<", "<=", ">", ">=", "==", "!="):
            op = self.take()
            node = Bin(op, node, self.sum_())
        return node

    def sum_(self):
        node = self.prod()
        while self.peek() in ("+", "-"):
            node = Bin(self.take(), node, self.prod())
        return node

    def prod(self):
        node = self.unary()
        while self.peek() in ("*", "/"):
            node = Bin(self.take(), node, self.unary())
        return node

    def unary(self):
        if self.peek() in ("-", "!"):
            return Unary(self.take(), self.unary())
        return self.atom()

    def atom(self):
        tok = self.peek()
        if tok == "(":
            self.take()
            node = self.or_()
            self.take(")")
            return node
        tok = self.take()
        if re.fullmatch(r"\d+\.?\d*(?:[eE][+-]?\d+)?", tok):
            return Num(float(tok))
        if tok in AGGS and self.peek() == "(":
            self.take("(")
            arg = self.or_()
            self.take(")")
            return Agg(tok, arg)
        return Var(tok)


def parse(src: str) -> Node:
    """Parse a filter expression into its AST (QueryError on bad input)."""
    return _Parser(tokenize(src)).parse()


def unparse(node: Node) -> str:
    """Deterministic fully-parenthesized rendering of an AST."""
    if isinstance(node, Num):
        return repr(node.value)
    if isinstance(node, Var):
        return node.name
    if isinstance(node, Agg):
        return f"{node.fn}({unparse(node.arg)})"
    if isinstance(node, Unary):
        return f"{node.op}({unparse(node.arg)})"
    if isinstance(node, Bin):
        return f"({unparse(node.lhs)} {node.op} {unparse(node.rhs)})"
    raise QueryError(f"bad node {node}")


def canonical_expr(src: str) -> str:
    """Canonical form of a filter expression: whitespace, redundant parens
    and number spellings ("3" vs "3.0") are normalized away, so textually
    different but identical queries share one result-cache key."""
    return unparse(parse(src))


def validate_expr(src: str, schema: ev.EventSchema) -> Node:
    """Parse + resolve every variable against the schema (admission-time
    check: a bad query must be rejected at submit, not on a grid node)."""
    ast = parse(src)

    def walk(node: Node, track_ctx: bool):
        if isinstance(node, Var):
            if node.name == "n_tracks":
                return
            if track_ctx and node.name in ev.TRACK_VARS:
                return
            try:
                if schema.scalar_index(node.name) >= schema.n_scalars:
                    raise ValueError
            except ValueError:
                raise QueryError(f"unknown variable {node.name!r}") from None
        elif isinstance(node, Agg):
            walk(node.arg, True)
        elif isinstance(node, Unary):
            walk(node.arg, track_ctx)
        elif isinstance(node, Bin):
            walk(node.lhs, track_ctx)
            walk(node.rhs, track_ctx)

    walk(ast, False)
    return ast


# ---------------------------- compiler ----------------------------------- #
def eval_node(node: Node, batch, schema: ev.EventSchema,
              track_ctx: bool = False, memo: Optional[dict] = None):
    """Evaluate one AST node over an EventBatch.

    This is the single source of truth for query semantics: ``compile_query``
    calls it without a memo (one evaluation per node *occurrence*, the
    unshared behaviour) and the fragment planner calls it with a shared ``memo`` dict
    keyed on ``(id(node), track_ctx)`` so interned common subexpressions are
    evaluated ONCE across a whole dispatch window.  Memoization reuses the
    exact arrays an unmemoized walk would recompute from identical inputs,
    so per-query outputs are bit-identical either way.
    """
    if memo is not None:
        key = (id(node), track_ctx)
        hit = memo.get(key)
        if hit is not None:
            return hit
    val = _eval_node_raw(node, batch, schema, track_ctx, memo)
    if memo is not None:
        memo[key] = val
    return val


def _eval_node_raw(node: Node, batch, schema: ev.EventSchema,
                   track_ctx: bool, memo: Optional[dict]):
    dev = batch["scalars"].device
    if isinstance(node, Num):
        # a 0-d float32 tensor on the batch's device broadcasts against
        # any operand shape, like the reference's jnp.float32 literal
        return torch.tensor(node.value, dtype=torch.float32, device=dev)
    if isinstance(node, Var):
        if node.name == "n_tracks":
            return batch["n_tracks"].float()
        if track_ctx:
            try:
                idx = schema.track_index(node.name)
                return batch["tracks"][..., idx]
            except ValueError:
                pass
        try:
            idx = schema.scalar_index(node.name)
        except ValueError:
            raise QueryError(f"unknown variable {node.name!r}") from None
        if idx >= schema.n_scalars:
            raise QueryError(f"variable {node.name!r} outside schema")
        val = batch["scalars"][..., idx]
        if track_ctx:
            val = val[..., None]  # broadcast over tracks
        return val
    if isinstance(node, Agg):
        inner = eval_node(node.arg, batch, schema, True, memo)  # (N, T)
        if inner.dim() == 0:
            # an argument with no variable at all has no track axis to
            # reduce over (the reference raises IndexError here)
            raise QueryError(
                f"{node.fn}() needs a track or scalar variable in its "
                f"argument, got {unparse(node.arg)!r}")
        t = torch.arange(inner.shape[-1], device=dev)
        valid = t[None, :] < batch["n_tracks"][:, None]
        if node.fn == "count":
            return torch.sum(torch.where(valid, (inner != 0).float(), 0.0),
                             dim=-1)
        if node.fn == "sum":
            return torch.sum(torch.where(valid, inner, 0.0), dim=-1)
        if node.fn == "mean":
            s = torch.sum(torch.where(valid, inner, 0.0), dim=-1)
            return s / torch.clamp(batch["n_tracks"].float(), min=1)
        if node.fn == "max":
            return torch.amax(torch.where(valid, inner, -torch.inf), dim=-1)
        if node.fn == "min":
            return torch.amin(torch.where(valid, inner, torch.inf), dim=-1)
        raise QueryError(node.fn)
    if isinstance(node, Unary):
        val = eval_node(node.arg, batch, schema, track_ctx, memo)
        return -val if node.op == "-" else (val == 0).float()
    if isinstance(node, Bin):
        a = eval_node(node.lhs, batch, schema, track_ctx, memo)
        b = eval_node(node.rhs, batch, schema, track_ctx, memo)
        ops = {
            "+": lambda: a + b,
            "-": lambda: a - b,
            "*": lambda: a * b,
            "/": lambda: a / torch.where(b == 0, 1e-30, b),
            "<": lambda: (a < b).float(),
            "<=": lambda: (a <= b).float(),
            ">": lambda: (a > b).float(),
            ">=": lambda: (a >= b).float(),
            "==": lambda: (a == b).float(),
            "!=": lambda: (a != b).float(),
            "&&": lambda: ((a != 0) & (b != 0)).float(),
            "||": lambda: ((a != 0) | (b != 0)).float(),
        }
        if node.op not in ops:
            raise QueryError(node.op)
        return ops[node.op]()
    raise QueryError(f"bad node {node}")


def compile_query(src: str, schema: ev.EventSchema) -> Callable:
    """Compile to ``fn(batch) -> (N,) f32`` (bool predicates return 0/1)."""
    ast = parse(src)

    def fn(batch):
        return eval_node(ast, batch, schema, False)

    return fn


# ---------------------------- fragment plans ------------------------------ #
def node_key(node: Node) -> str:
    """Canonical string identity of a subexpression (the fragment key used
    by the planner and the fragment-level result cache).  Two ASTs with the
    same ``node_key`` evaluate identically on every batch."""
    return unparse(node)


class Interner:
    """Hash-conses ASTs so structurally identical subexpressions across a
    window of queries become the SAME node object; shared identity is what
    lets a memoized :func:`eval_node` walk evaluate each unique fragment
    exactly once."""

    def __init__(self):
        self._table: dict = {}

    def intern(self, node: Node) -> Node:
        """Return the canonical shared instance of ``node``'s structure
        (recursively interning children first)."""
        if isinstance(node, Num):
            key = ("num", node.value)
        elif isinstance(node, Var):
            key = ("var", node.name)
        elif isinstance(node, Agg):
            arg = self.intern(node.arg)
            key = ("agg", node.fn, id(arg))
            node = Agg(node.fn, arg)
        elif isinstance(node, Unary):
            arg = self.intern(node.arg)
            key = ("unary", node.op, id(arg))
            node = Unary(node.op, arg)
        elif isinstance(node, Bin):
            lhs, rhs = self.intern(node.lhs), self.intern(node.rhs)
            key = ("bin", node.op, id(lhs), id(rhs))
            node = Bin(node.op, lhs, rhs)
        else:
            raise QueryError(f"bad node {node}")
        return self._table.setdefault(key, node)

    def __len__(self) -> int:
        return len(self._table)


def count_occurrences(node: Node) -> int:
    """Total node *occurrences* in a tree — the number of evaluations an
    unmemoized walk (a per-query compile) performs."""
    if isinstance(node, (Num, Var)):
        return 1
    if isinstance(node, (Agg, Unary)):
        return 1 + count_occurrences(node.arg)
    if isinstance(node, Bin):
        return 1 + count_occurrences(node.lhs) + count_occurrences(node.rhs)
    raise QueryError(f"bad node {node}")


def _reachable(node: Node, track_ctx: bool, seen: set):
    """Walk unique (interned node, context) pairs reachable from ``node``."""
    key = (id(node), track_ctx)
    if key in seen:
        return
    seen.add(key)
    if isinstance(node, Agg):
        _reachable(node.arg, True, seen)
    elif isinstance(node, Unary):
        _reachable(node.arg, track_ctx, seen)
    elif isinstance(node, Bin):
        _reachable(node.lhs, track_ctx, seen)
        _reachable(node.rhs, track_ctx, seen)


def is_boolean(node: Node) -> bool:
    """True when the node's value is a 0/1 mask (comparison, logic, not)."""
    if isinstance(node, Bin):
        return node.op in ("<", "<=", ">", ">=", "==", "!=", "&&", "||")
    return isinstance(node, Unary) and node.op == "!"


@dataclasses.dataclass
class FragmentPlan:
    """Deduplicated execution plan for a window of queries.

    ``roots`` are the per-query interned ASTs; structurally identical
    subexpressions are the same object, so :meth:`evaluate` with one shared
    memo computes each unique fragment once per batch and reassembles every
    query's predicate from fragment outputs.  ``materialize`` lists extra
    shared fragments whose masks the executor should surface as first-class
    results (fed to the fragment-level cache by the service).

    ``unique_fragments`` (evaluations this plan performs per batch) vs.
    ``unshared_evals`` (evaluations K independent compiles would perform)
    is the factoring win the planner benchmark measures.  ``shared=False``
    disables cross-query memo sharing — the unshared baseline semantics.
    """
    exprs: List[str]
    roots: List[Node]
    unique_fragments: int
    unshared_evals: int
    shared: bool = True
    materialize: List[Node] = dataclasses.field(default_factory=list)

    @property
    def evals_per_batch(self) -> int:
        """Fragment evaluations this plan performs on one resident batch."""
        return self.unique_fragments if self.shared else self.unshared_evals

    def targets(self) -> List[Node]:
        """Everything the executor surfaces: roots, then materialized
        shared fragments."""
        return list(self.roots) + list(self.materialize)

    def materialize_keys(self) -> List[str]:
        """Canonical cache keys of the materialized shared fragments."""
        return [node_key(m) for m in self.materialize]

    def evaluate(self, batch, schema: ev.EventSchema) -> List:
        """Evaluate every root (then every materialized fragment) on one
        batch; returns a list of (N,) arrays, roots first.  In unshared
        mode no memo is used at all, so the work performed matches
        ``unshared_evals`` exactly (one evaluation per node occurrence)."""
        memo: Optional[dict] = {} if self.shared else None
        return [eval_node(tgt, batch, schema, False, memo)
                for tgt in self.targets()]


def unique_aggregates(roots: Sequence[Node]) -> int:
    """Number of distinct interned :class:`Agg` nodes reachable from
    ``roots`` — the track sweeps one fragment-factored pass performs per
    resident batch (the cost-model calibration's per-packet feature)."""
    return sum(1 for _, node in _id_nodes(roots) if isinstance(node, Agg))


def _id_nodes(roots: Sequence[Node]):
    """Unique (id, node) pairs reachable from ``roots`` (helper for
    counting by node type)."""
    out: dict = {}

    def walk(node):
        if id(node) in out:
            return
        out[id(node)] = node
        if isinstance(node, (Agg, Unary)):
            walk(node.arg)
        elif isinstance(node, Bin):
            walk(node.lhs)
            walk(node.rhs)

    for r in roots:
        walk(r)
    return out.items()


def build_fragment_plan(exprs: Sequence[str], *, shared: bool = True,
                        interner: Optional[Interner] = None) -> FragmentPlan:
    """Canonicalize + hash-cons every subexpression of each query into a
    deduplicated fragment plan (the planner's common-subexpression
    factoring).  Near-duplicate queries (same aggregates under different
    outer filters) end up sharing fragment objects, hence compute.

    Pass a pre-seeded ``interner`` (the fabric's fragment registry seeds
    one with cross-window hot fragments) so fragments already interned
    share node identity with this window's queries; seeding never changes
    the plan's results, only what the planner can recognize by ``id()``."""
    interner = interner if interner is not None else Interner()
    roots = [interner.intern(parse(e)) for e in exprs]
    seen: set = set()
    for r in roots:
        _reachable(r, False, seen)
    return FragmentPlan(
        exprs=[node_key(r) for r in roots],
        roots=roots,
        unique_fragments=len(seen),
        unshared_evals=sum(count_occurrences(r) for r in roots),
        shared=shared,
    )


def compile_query_batch(exprs: Sequence[str],
                        schema: ev.EventSchema) -> Callable:
    """Stack K predicates into ONE fused, fragment-factored pass.

    Returns ``fn(batch) -> (K, N) f32``.  The window is compiled through a
    :class:`FragmentPlan`, so common subexpressions (scalar loads, validity
    masks, shared track aggregates like ``count(pt > 30)``) are evaluated
    once per sweep and reused by every query that references them.
    Per-query rows are bit-identical to K independent ``compile_query``
    evaluations."""
    plan = build_fragment_plan(exprs)

    def fn(batch):
        return torch.stack(plan.evaluate(batch, schema), dim=0)

    return fn


def calibrate(batch, iters: int = 4):
    """The paper's per-event "calibration procedure" (section 4.1): an
    iterative refinement over track parameters — the compute-heavy part of
    event processing.  Returns a new float32 tracks tensor on the batch's
    device; each step rounds to float32 on its own, in the reference's
    operation order."""
    trk = batch["tracks"].float()
    for _ in range(iters):
        pt = trk[..., 0:1]
        corr = 1.0 + 0.01 * torch.tanh(trk) * torch.rsqrt(1.0 + pt * pt)
        trk = trk * corr
    return trk
