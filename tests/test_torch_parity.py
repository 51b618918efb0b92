"""Shared parity helpers for the PyTorch port's tests, and the parity of
the port's storage layer with the JAX package.

Both packages get the same inputs: numpy arrays from ``host_events`` /
``create_store`` with one seed, handed to JAX as ``jnp`` arrays and to the
port as CPU tensors.  Other ``test_torch_*`` files import the helpers
from here (``tests/`` is on ``sys.path`` under pytest's default import
mode).

The band rule: a mask computed through calibration (tanh, rsqrt) or a
``sum(pt)`` cap may differ between the packages only on *band events*,
events whose calibrated pt or ``sum(pt)`` lies within ``BAND_RTOL`` of a
threshold it is compared with; the two frameworks round those values at
different places.  Everywhere else masks must be equal.
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.geps_events import reduced
from repro.core import brick as ref_brick
from repro.core import events as ref_ev
from repro_torch.core import brick as port_brick
from repro_torch.core import events as port_ev
from repro_torch.core import merge as port_merge

CFG = reduced()
REF_SCHEMA = ref_ev.EventSchema.from_config(CFG)
SCHEMA = port_ev.EventSchema.from_config(CFG)
BAND_RTOL = 1e-5


def ref_store(n_events=192, n_nodes=4, seed=7, replication=2):
    """The JAX package's numpy brick store at the reduced config."""
    return ref_brick.create_store(REF_SCHEMA, n_events=n_events,
                                  n_nodes=n_nodes,
                                  events_per_brick=CFG.events_per_brick,
                                  replication=replication, seed=seed)


def stores(n_events=192, n_nodes=4, seed=7):
    """(reference store, the port's CPU store over the same bricks)."""
    ref = ref_store(n_events, n_nodes, seed)
    return ref, port_brick.store_from_reference(ref, device="cpu")


def operands(rng, n, t, v, s=8):
    """numpy event operands shaped like the store's (exponential pt,
    ragged n_tracks)."""
    scalars = np.abs(rng.normal(size=(n, s)) * 50).astype(np.float32)
    tracks = rng.normal(size=(n, t, v)).astype(np.float32)
    tracks[:, :, 0] = rng.exponential(size=(n, t)) * 10
    n_tracks = rng.integers(1, t + 1, size=(n,)).astype(np.int32)
    return scalars, tracks, n_tracks


def as_jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def as_torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def calibrated_pt(tracks, n_tracks, calib_iters):
    """(pt (N, T) float64 after calibration, valid (N, T)) — numpy, from
    the port's plain calibration, for locating band events."""
    from repro_torch.kernels.event_filter.ref import calibrate_tracks
    pt = calibrate_tracks(torch.from_numpy(tracks), calib_iters)[..., 0]
    pt = pt.double().numpy()
    valid = np.arange(pt.shape[1])[None, :] < n_tracks[:, None]
    return pt, valid


def band_events(tracks, n_tracks, thresholds, calib_iters):
    """(N,) bool: events whose outcome rides on rounding — a valid
    calibrated pt within BAND_RTOL of a pt threshold, or ``sum(pt)``
    within BAND_RTOL of an enabled sum cap.  ``thresholds`` is (4, K)."""
    thresholds = np.asarray(thresholds, np.float64).reshape(4, -1)
    pt, valid = calibrated_pt(tracks, n_tracks, calib_iters)
    b, d = thresholds[1], thresholds[3]
    near = np.abs(pt[..., None] - b) <= BAND_RTOL * np.abs(b)
    band = (near & valid[..., None]).any(axis=(1, 2))
    ssum = np.where(valid, pt, 0.0).sum(-1)
    near_sum = (np.abs(ssum[:, None] - d) <= BAND_RTOL * np.abs(d)) & (d > 0)
    return band | near_sum.any(axis=1)


def assert_masks_band_equal(got, want, band, *, exact, max_band):
    """Masks equal, or — unless ``exact`` — differing only on band events,
    with at most ``max_band`` band events in the inputs."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    assert int(band.sum()) <= max_band, f"{int(band.sum())} band events"
    rows = (got != want).reshape(got.shape[0], -1).any(axis=1)
    assert not (rows & ~band).any(), \
        f"masks differ outside the band on rows {np.flatnonzero(rows & ~band)}"


def same_result(ref_result, port_result) -> bool:
    """``results_identical`` across the packages (the port's predicate on
    the reference's QueryResult read through its fields)."""
    return port_merge.results_identical(
        port_merge.QueryResult(ref_result.n_selected, ref_result.n_processed,
                               ref_result.sum_var, ref_result.hist,
                               ref_result.selected_ids), port_result)


# ----------------------------------------------------------------------- #
# storage parity
# ----------------------------------------------------------------------- #
def test_create_store_is_byte_equal_to_the_reference():
    ref = ref_store(n_events=100, n_nodes=3, seed=11)
    port = port_brick.create_store(SCHEMA, n_events=100, n_nodes=3,
                                   events_per_brick=CFG.events_per_brick,
                                   replication=2, seed=11, device="cpu")
    assert port.device == torch.device("cpu")
    assert sorted(port.bricks) == sorted(ref.bricks)
    for bid, batch in ref.bricks.items():
        for key, arr in batch.items():
            got = port.bricks[bid][key]
            assert got.device.type == "cpu"
            assert got.numpy().dtype == arr.dtype
            assert got.numpy().tobytes() == arr.tobytes()
        assert port.specs[bid] == port_brick.BrickSpec(
            *(getattr(ref.specs[bid], f) for f in
              ("brick_id", "node", "replicas", "n_events", "id_range")))
    assert port.n_events == ref.n_events == 100


def test_store_from_reference_carries_bricks_and_specs():
    ref, port = stores(n_events=80, n_nodes=4, seed=3)
    assert port.n_nodes == ref.n_nodes
    for bid in ref.bricks:
        assert port.owners(bid) == ref.owners(bid)
        for key, arr in ref.bricks[bid].items():
            assert port.bricks[bid][key].numpy().tobytes() == arr.tobytes()
    for node in range(ref.n_nodes):
        assert port.bricks_on_node(node, True) == \
            ref.bricks_on_node(node, True)
    gathered = port_brick.gather_store(port)
    want = ref_brick.gather_store(ref)
    for key in want:
        np.testing.assert_array_equal(gathered[key].numpy(), want[key])


def test_host_events_same_bytes_for_one_seed():
    a = ref_ev.host_events(np.random.default_rng(5), REF_SCHEMA, 33, 7)
    b = port_ev.host_events(np.random.default_rng(5), SCHEMA, 33, 7)
    for key in a:
        assert a[key].tobytes() == b[key].tobytes()


def test_concat_and_abstract_events_keep_shapes():
    gen = torch.Generator().manual_seed(0)
    a = port_ev.synthetic_events(gen, SCHEMA, 5, device="cpu")
    b = port_ev.synthetic_events(gen, SCHEMA, 3, id_offset=5, device="cpu")
    both = port_ev.concat_batches([a, b])
    shapes = {k: tuple(v.shape) for k, v in port_ev.abstract_events(
        SCHEMA, 8).items()}
    assert {k: tuple(v.shape) for k, v in both.items()} == shapes
    assert both["event_id"].tolist() == list(range(8))
    assert bool((both["n_tracks"] >= 1).all())
    assert bool((both["tracks"][..., 0] >= 0).all())


# ----------------------------------------------------------------------- #
# merge and catalogue parity (copied modules)
# ----------------------------------------------------------------------- #
def _partials(merge, rng, n_parts):
    var = (rng.exponential(size=(n_parts, 40)) * 60).astype(np.float32)
    masks = rng.random(size=(n_parts, 40)) < 0.4
    ids = np.arange(n_parts * 40, dtype=np.int32).reshape(n_parts, 40)
    return [merge.from_mask(m.astype(np.float32), v, i)
            for m, v, i in zip(masks, var, ids)]


def test_merge_fuzz_matches_the_reference():
    from repro.core import merge as ref_merge
    for seed in range(12):
        n = 1 + seed % 7
        ref_parts = _partials(ref_merge, np.random.default_rng(seed), n)
        parts = _partials(port_merge, np.random.default_rng(seed), n)
        for a, b in zip(ref_parts, parts):
            assert same_result(a, b)
        assert same_result(ref_merge.tree_merge(ref_parts),
                           port_merge.tree_merge(parts))
        assert same_result(ref_parts[0] if n == 1 else
                           ref_merge.merge2(ref_parts[0], ref_parts[1]),
                           parts[0] if n == 1 else
                           port_merge.merge2(parts[0], parts[1]))
        acc_ref, acc = ref_merge.MergeAccumulator(), \
            port_merge.MergeAccumulator()
        for k, (a, b) in enumerate(zip(ref_parts, parts)):
            acc_ref.add(a, brick_id=k % 3)
            acc.add(b, brick_id=k % 3)
            assert same_result(acc_ref.snapshot(), acc.snapshot())


def test_catalog_json_loads_in_either_package():
    from repro.core.catalog import MetadataCatalog as RefCatalog
    from repro_torch.core.catalog import MetadataCatalog
    ref = RefCatalog(4)
    jid = ref.submit("e_total > 1", 2, (0, 1))
    ref.update(jid, status="DONE", events_processed=32)
    ref.mark_dead(3)
    port = MetadataCatalog.from_json(ref.to_json())
    assert port.to_json() == ref.to_json()
    assert RefCatalog.from_json(port.to_json()).to_json() == ref.to_json()
