"""The port's query compiler against the JAX package's: the parser, its
canonical strings, masks of the compiled predicates, fragment plans, and
calibration, on the same numpy events."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import query as ref_q
from repro_torch.core import query as port_q
from test_torch_parity import REF_SCHEMA, SCHEMA, stores

EXPRS = [
    "e_total > 40",
    "count(pt > 15) >= 2 && sum(pt) < 800 || n_tracks == 1",
    "e_total + 2 * e_t_miss > 100",
    "e_total > 40 && count(pt > 15) >= 2",
    "e_t_miss > 25 && count(pt > 15) >= 2",
    "pt_lead > 60 || n_tracks >= 8",
    "e_total > 55 && sum(pt) < 400",
    "e_total + 2 * e_t_miss > 120",
    "mean(pt) > 9.5 && max(eta) < 2.0",
    "min(phi) > -1.5 || !(count(pt > 30) >= 1)",
    "-(e_total) / 3 < -10.25 && e_total != 0",
    "sum(pt * (eta > 0)) / (1 + n_tracks) > 4",
    "count(e_total > 40) >= 1",
    "e_total / 0 > 1",
]


def _batches(n_events=96, seed=7):
    ref, port = stores(n_events=n_events, seed=seed)
    from repro.core.brick import gather_store
    host = gather_store(ref)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    tb = {k: torch.from_numpy(v) for k, v in host.items()}
    return host, jb, tb


@pytest.mark.parametrize("expr", EXPRS + [
    "e_total>40&&count(pt>15)>=2", "((e_total)) > 40.0", "e_total > 4e1"])
def test_parse_unparse_canonical_identical(expr):
    assert port_q.tokenize(expr) == ref_q.tokenize(expr)
    assert port_q.unparse(port_q.parse(expr)) == \
        ref_q.unparse(ref_q.parse(expr))
    assert port_q.canonical_expr(expr) == ref_q.canonical_expr(expr)


@pytest.mark.parametrize("bad", ["e_total >", "nonsense_var > 1",
                                 "count(pt > 1", "e_total > 1 ) ", "pt > 3"])
def test_parse_and_validate_errors_match(bad):
    def outcome(mod, schema):
        try:
            mod.validate_expr(bad, schema)
        except mod.QueryError as e:
            return "QueryError", str(e)
        return "ok", None
    assert outcome(port_q, SCHEMA) == outcome(ref_q, REF_SCHEMA)


@pytest.mark.parametrize("expr", EXPRS)
def test_compiled_masks_equal_at_calib_0(expr):
    _, jb, tb = _batches()
    want = np.asarray(ref_q.compile_query(expr, REF_SCHEMA)(jb))
    got = port_q.compile_query(expr, SCHEMA)(tb)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_plan_matches_reference_and_singles():
    _, jb, tb = _batches()
    want = np.asarray(ref_q.compile_query_batch(EXPRS, REF_SCHEMA)(jb))
    got = port_q.compile_query_batch(EXPRS, SCHEMA)(tb)
    np.testing.assert_array_equal(got.numpy(), want)
    for row, expr in zip(got, EXPRS):
        assert torch.equal(row, port_q.compile_query(expr, SCHEMA)(tb))
    ref_plan = ref_q.build_fragment_plan(EXPRS)
    plan = port_q.build_fragment_plan(EXPRS)
    assert plan.materialize_keys() == ref_plan.materialize_keys()
    assert (plan.evals_per_batch, plan.unshared_evals) == \
        (ref_plan.evals_per_batch, ref_plan.unshared_evals)
    assert [port_q.unparse(t) for t in plan.targets()] == \
        [ref_q.unparse(t) for t in ref_plan.targets()]


@pytest.mark.parametrize("iters", [1, 4])
def test_calibrated_tracks_match_within_rtol(iters):
    host, jb, tb = _batches(n_events=64)
    want = np.asarray(ref_q.calibrate(jb, iters))
    got = port_q.calibrate(tb, iters)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # calibration never touches the input batch
    np.testing.assert_array_equal(tb["tracks"].numpy(), host["tracks"])


@pytest.mark.parametrize("expr", ["sum(3.0) > 1", "count(-(2.0)) >= 1",
                                  "mean(1 + 2) > 0"])
def test_aggregate_over_a_bare_number_raises_query_error(expr):
    # the reference admits these and then fails with IndexError on
    # evaluation; the port rejects them as a query error
    port_q.validate_expr(expr, SCHEMA)
    _, _, tb = _batches(n_events=16)
    with pytest.raises(port_q.QueryError, match="needs a track or scalar"):
        port_q.compile_query(expr, SCHEMA)(tb)


def _ast_strategy(mod, aggs):
    """Random filter ASTs of ``mod`` (the strategies of the reference's
    planner property) over the aggregates ``aggs``, without aggregates
    whose argument holds no variable: the reference cannot evaluate
    those."""
    st = pytest.importorskip("hypothesis").strategies
    num = st.builds(mod.Num, st.floats(min_value=0.0, max_value=100.0,
                                       allow_nan=False).map(
        lambda x: round(x, 2)))
    scalar_var = st.builds(mod.Var, st.sampled_from(
        ("e_total", "e_t_miss", "pt_lead", "n_tracks")))
    track_var = st.builds(mod.Var, st.sampled_from(
        ("pt", "eta", "phi", "e_total")))
    ops = st.sampled_from(("+", "-", "*", "/", "<", "<=", ">", ">=",
                           "==", "!=", "&&", "||"))
    unary_ops = st.sampled_from(("-", "!"))

    def grow(children):
        return (st.builds(mod.Bin, ops, children, children)
                | st.builds(mod.Unary, unary_ops, children))

    def has_var(node):
        if isinstance(node, mod.Unary):
            return has_var(node.arg)
        if isinstance(node, mod.Bin):
            return has_var(node.lhs) or has_var(node.rhs)
        return isinstance(node, mod.Var)

    track = st.recursive(num | track_var, grow, max_leaves=6).filter(has_var)
    agg = st.builds(mod.Agg, st.sampled_from(aggs), track)
    return st.recursive(num | scalar_var | agg, grow, max_leaves=10)


def _check_random_asts(aggs, against_reference):
    hypothesis = pytest.importorskip("hypothesis")
    _, jb, tb = _batches(n_events=48, seed=3)

    @hypothesis.settings(max_examples=40, deadline=None, derandomize=True)
    @hypothesis.given(hypothesis.strategies.lists(_ast_strategy(port_q, aggs),
                                                  min_size=2, max_size=5))
    def check(asts):
        exprs = [port_q.unparse(a) for a in asts]
        plan = port_q.build_fragment_plan(exprs)
        outs = plan.evaluate(tb, SCHEMA)
        for expr, out in zip(exprs, outs):
            assert torch.equal(out, port_q.compile_query(expr, SCHEMA)(tb)), \
                expr
            if against_reference:
                want = np.asarray(ref_q.compile_query(expr, REF_SCHEMA)(jb))
                np.testing.assert_array_equal(out.numpy(), want,
                                              err_msg=expr)

    check()


def test_property_plan_bit_identical_to_single_queries():
    """The planner's guarantee inside the port, over every aggregate."""
    _check_random_asts(port_q.AGGS, against_reference=False)


def test_property_order_free_asts_match_reference_exactly():
    """Against the reference, over the aggregates whose value does not
    depend on summation order (count, max, min) and IEEE elementwise
    arithmetic: equal bits.  ``sum`` and ``mean`` reduce in another order
    in each framework, so they are held to the fixed expressions above."""
    _check_random_asts(("count", "max", "min"), against_reference=True)
