"""The port's launch-shape autotuner (``kernels/event_filter/tune.py``)
against the reference's block-shape autotuner, on the CPU.

The sweep itself times the CUDA kernel, so here it runs with a fake timer
(``tune._time_once`` monkeypatched) on stand-in operands that claim a
CUDA device and are never launched: what is tested is the arithmetic
(``roofline_point`` equals the reference's), the cache key, the candidate
set, the cache, and the wiring into ``SpmdBackend`` and the launcher.
The sweep on the card is in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""
import types

import numpy as np
import pytest
import torch

from repro.kernels.event_filter import tune as ref_tune
from repro_torch.core.backend import SpmdBackend
from repro_torch.core.catalog import MetadataCatalog
from repro_torch.kernels.event_filter import kernel as ef_kernel
from repro_torch.kernels.event_filter import ops as ef_ops
from repro_torch.kernels.event_filter import tune
from repro_torch.launch import serve as port_serve
from test_torch_parity import operands, stores

FAKE_MS = {128: 0.30, 256: 0.20, 512: 0.40}


@pytest.mark.parametrize("args", [(64, 4096, 63, 64, 6, 0, 0.00868),
                                  (37, 1000, 63, 8, 17, 4, 0.5),
                                  (1, 1, 1, 1, 1, 0, 1e-12)])
def test_roofline_point_equals_the_reference(args):
    assert tune.roofline_point(*args) == ref_tune.roofline_point(*args)


def test_shape_key_separates_every_field():
    base = (64, 4096, 63, 64, 6, 0, "NVIDIA H100 80GB HBM3")
    key = tune.shape_key(*base)
    assert key == tune.shape_key(*base)
    for i in range(len(base)):
        other = list(base)
        other[i] = other[i] + "x" if isinstance(other[i], str) \
            else other[i] + 1
        assert tune.shape_key(*other) != key, i


def test_candidates_are_the_kernel_launches_with_the_default():
    assert tune.CANDIDATES == ef_kernel.LAUNCH_THREADS == (128, 256, 512)
    assert tune.DEFAULT_SHAPE == ef_kernel.DEFAULT_THREADS == 512
    assert tune.DEFAULT_SHAPE in tune.CANDIDATES


def _standins(n=64, t=4096, v=63, s=64, k=6):
    """Operands that claim a CUDA device: the sweep reads their shapes
    and device, and only the (faked) timer would launch them."""
    dev = torch.device("cuda", 0)

    def op(*shape):
        return types.SimpleNamespace(shape=shape, device=dev)
    return op(n, s), op(n, t, v), op(n), op(4, k), op(k)


@pytest.fixture
def fake_timer(monkeypatch):
    """tune._time_once replaced: returns FAKE_MS for the candidate's
    block size and records every candidate it was asked to time."""
    timed = []

    def time_once(fn, repeats):
        threads = fn.args[0]
        timed.append(threads)
        return FAKE_MS[threads]

    monkeypatch.setattr(tune, "_time_once", time_once)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "fake card")
    tune.clear_cache()
    yield timed
    tune.clear_cache()


def test_sweep_times_each_candidate_once_and_picks_the_fastest(fake_timer):
    tuned = tune.autotune_block_shapes(*_standins(), calib_iters=0)
    assert fake_timer == [128, 256, 512]
    assert tuned.threads == 256
    assert (tuned.best_ms, tuned.default_ms) == (0.20, 0.40)
    assert tuned.speedup_vs_default == pytest.approx(2.0)
    assert tuned.measurements == ((128, 0.30), (256, 0.20), (512, 0.40))
    assert tuned.roofline == tune.roofline_point(64, 4096, 63, 64, 6, 0,
                                                 0.20)


def test_sweep_dedups_candidates_and_always_times_the_default(fake_timer):
    tuned = tune.autotune_block_shapes(*_standins(), calib_iters=0,
                                       candidates=(128, 128, 128))
    assert fake_timer == [128, 512]
    assert tuned.threads == 128 and tuned.default_ms == 0.40
    assert tuned.speedup_vs_default >= 1.0


def test_sweep_rejects_a_candidate_the_kernel_does_not_take(fake_timer):
    with pytest.raises(ValueError, match="threads"):
        tune.autotune_block_shapes(*_standins(), calib_iters=0,
                                   candidates=(64, 512))
    assert fake_timer == []


def test_in_process_cache_and_clear_cache(fake_timer):
    first = tune.autotune_block_shapes(*_standins(), calib_iters=0)
    again = tune.autotune_block_shapes(*_standins(), calib_iters=0)
    assert again is first and len(fake_timer) == 3
    # another shape class (K, calib, chunk) sweeps again
    tune.autotune_block_shapes(*_standins(k=7), calib_iters=0)
    tune.autotune_block_shapes(*_standins(), calib_iters=4)
    assert len(fake_timer) == 9
    snap = tune.cached_shapes()
    assert len(snap) == 3
    assert tune.shape_key(64, 4096, 63, 64, 6, 0, "fake card") in snap
    # a caller's own cache leaves the module's alone
    mine = {}
    tune.autotune_block_shapes(*_standins(n=8), calib_iters=0, cache=mine)
    assert len(mine) == 1 and len(tune.cached_shapes()) == 3
    tune.clear_cache()
    assert tune.cached_shapes() == {}
    tune.autotune_block_shapes(*_standins(), calib_iters=0)
    assert len(fake_timer) == 15


def test_as_dict_has_the_reference_keys_apart_from_the_shape_fields():
    ref = ref_tune.TunedShape(
        block_e=128, block_t=512, best_ms=0.2, default_ms=0.4,
        measurements=((128, 512, 0.4),), roofline={"ms": 0.2}).as_dict()
    ours = tune.TunedShape(
        threads=256, best_ms=0.2, default_ms=0.4,
        measurements=((256, 0.2), (512, 0.4)),
        roofline={"ms": 0.2}).as_dict()
    assert set(ours) - {"threads"} == set(ref) - {"block_e", "block_t"}
    assert ours["speedup_vs_default"] == ref["speedup_vs_default"] == 2.0
    assert ours["measurements"] == [[256, 0.2], [512, 0.4]]


def test_sweep_refuses_cpu_tensors():
    sc, tr, nt = (torch.from_numpy(a) for a in
                  operands(np.random.default_rng(0), 8, 16, 3))
    th = torch.tensor([[40.0], [15.0], [2.0], [-1.0]])
    vi = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel's launch"):
        tune.autotune_block_shapes(sc, tr, nt, th, vi, calib_iters=0)


@pytest.mark.parametrize("threads", ef_kernel.LAUNCH_THREADS)
def test_plain_version_takes_every_launch_shape(threads):
    sc, tr, nt = (torch.from_numpy(a) for a in
                  operands(np.random.default_rng(1), 16, 40, 3))
    th = torch.tensor([[40.0, 10.0], [15.0, 5.0], [2.0, 1.0],
                       [-1.0, 300.0]])
    vi = torch.tensor([0, 2], dtype=torch.int32)
    want = ef_ops.event_filter_batch(sc, tr, nt, th, vi, calib_iters=2)
    got = ef_ops.event_filter_batch(sc, tr, nt, th, vi, calib_iters=2,
                                    threads=threads)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("threads", [64, 1024, 0, True, 512.5])
def test_launch_shape_outside_the_set_is_rejected(threads):
    sc, tr, nt = (torch.from_numpy(a) for a in
                  operands(np.random.default_rng(1), 4, 8, 3))
    th = torch.tensor([[40.0], [15.0], [2.0], [-1.0]])
    vi = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(ValueError, match="threads a block"):
        ef_ops.event_filter_batch(sc, tr, nt, th, vi, calib_iters=0,
                                  threads=threads)


def test_backend_launches_every_kernel_chunk_with_the_winner(monkeypatch):
    """The wiring of ``_maybe_autotune``: a window with kernel targets
    sweeps once on a sample chunk of its first brick (chunk_events
    events) and every kernel chunk launches with the winner; the gauge
    ``spmd.autotune.threads`` carries it.  On the CPU the sweep is faked
    and the backend's device check is passed by setting ``autotune``
    after construction."""
    from repro_torch.obs import Observability
    _, store = stores(n_events=96)
    backend = SpmdBackend(MetadataCatalog(store.n_nodes), store,
                          use_pallas=True, chunk_events=16, device="cpu")
    backend.autotune = True
    backend.obs = Observability(origin="fe0")
    winner = tune.TunedShape(threads=128, best_ms=0.1, default_ms=0.2,
                             measurements=((128, 0.1), (512, 0.2)),
                             roofline={})
    sweeps, launches = [], []
    monkeypatch.setattr(tune, "autotune_block_shapes",
                        lambda *a, **kw: sweeps.append(a) or winner)
    dispatch = ef_ops.event_filter_batch

    def recording(*a, threads=None, **kw):
        launches.append(threads)
        return dispatch(*a, threads=threads, **kw)

    monkeypatch.setattr(ef_ops, "event_filter_batch", recording)
    exprs = ["e_total > 40 && count(pt > 15) >= 2", "e_t_miss > 30"]
    jids = [backend.catalog.submit(e, 0, tuple(sorted(store.bricks)))
            for e in exprs]
    _, stats = backend.run_batch(jids)
    assert len(sweeps) == 1 and sweeps[0][0].shape[0] == 16
    assert launches and launches == [128] * stats.packets
    assert backend.last_autotune is winner
    snap = backend.obs.metrics.snapshot().to_dict()
    assert "spmd.autotune.threads" in str(snap)
    # without autotune the kernel takes its default launch
    backend.autotune, launches[:] = False, []
    jids = [backend.catalog.submit(e, 0, tuple(sorted(store.bricks)))
            for e in exprs]
    backend.run_batch(jids)
    assert launches and set(launches) == {None} and len(sweeps) == 1


@pytest.mark.parametrize("argv", [
    ["--backend", "spmd", "--use-pallas", "--autotune"],
    ["--backend", "spmd", "--use-pallas", "--autotune", "--fleet", "4"],
])
def test_serve_autotune_on_a_cpu_store_raises_with_its_reason(argv):
    with pytest.raises(ValueError, match="CUDA kernel's launch shape"):
        port_serve.main(argv + ["--device", "cpu", "--queries", "4",
                                "--n-events", "32"])


def test_serve_autotune_needs_the_spmd_backend():
    with pytest.raises(SystemExit, match="--autotune requires --backend"):
        port_serve.main(["--autotune", "--device", "cpu"])
