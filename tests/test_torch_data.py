"""The port's brick data pipeline against the JAX package's, on the CPU:
``TokenBrickStore.read`` and ``BrickDataPipeline.next_batch`` give the
same bytes (the streams are numpy, seeded per brick row), with all nodes
alive and with a data node dead from some batch on (its packets fail
over to replica owners, whose bricks are byte-identical);
``next_device_batch`` hands the batch over as int64 tokens on the
pipeline's device.

With bricks of a whole global batch (the trainer's layout,
``seqs_per_brick = global_batch``) a dead node changes who reads, not
what is read: every batch equals the calm run's.  With bricks of 6 rows
under batches of 8 the packets after the failure regroup the rows, in the
reference as in the port (C-ref12: the reference's "global batch content
is unchanged" holds only for the first layout)."""
import numpy as np
import pytest
import torch

from repro.core.catalog import MetadataCatalog as JaxCatalog
from repro.data import pipeline as jax_pipeline
from repro_torch.core.catalog import MetadataCatalog
from repro_torch.data import pipeline

STORE = dict(vocab_size=512, seq_len=32, n_bricks=8, seqs_per_brick=6,
             n_nodes=4)
WHOLE = dict(STORE, seqs_per_brick=8)


def test_read_is_byte_equal():
    ours = pipeline.TokenBrickStore(**STORE)
    ref = jax_pipeline.TokenBrickStore(**STORE)
    for brick, start, count in [(0, 0, 6), (3, 2, 3), (7, 5, 1)]:
        got, want = ours.read(brick, start, count), ref.read(brick, start,
                                                             count)
        assert got.dtype == want.dtype == np.int32
        assert got.tobytes() == want.tobytes()
        assert ours.owners(brick) == ref.owners(brick)
    with pytest.raises(ValueError, match="outside brick"):
        ours.read(0, 4, 3)


@pytest.mark.parametrize("store", ["whole", "ragged"])
@pytest.mark.parametrize("kill", [None, (3, 1), (0, 2)])
def test_batches_are_byte_equal(kill, store):
    """Ten global batches of 8, node ``kill[1]`` marked dead before batch
    ``kill[0]`` (as the trainer's failure hook does)."""
    spec = WHOLE if store == "whole" else STORE
    ours = pipeline.BrickDataPipeline(
        pipeline.TokenBrickStore(**spec), MetadataCatalog(4),
        global_batch=8, device="cpu")
    ref = jax_pipeline.BrickDataPipeline(
        jax_pipeline.TokenBrickStore(**spec), JaxCatalog(4), global_batch=8)
    calm = pipeline.BrickDataPipeline(
        pipeline.TokenBrickStore(**spec), MetadataCatalog(4),
        global_batch=8, device="cpu")
    regrouped = 0
    for i in range(10):
        if kill is not None and i == kill[0]:
            for p in (ours, ref):
                p.catalog.mark_dead(kill[1])
                p.sched.requeue_node(kill[1])
        got, want = ours.next_batch(), ref.next_batch()
        assert got.shape == (8, 32) and got.tobytes() == want.tobytes(), i
        regrouped += got.tobytes() != calm.next_batch().tobytes()
    # a dead node changes who reads, not what is read, when a brick holds
    # a whole batch; with ragged bricks the failure regroups the rows
    assert regrouped == (0 if store == "whole" or kill is None else
                         {3: 4, 0: 3}[kill[0]])


def test_next_device_batch_is_int64_on_the_device():
    p = pipeline.BrickDataPipeline(pipeline.TokenBrickStore(**STORE),
                                   MetadataCatalog(4), global_batch=4,
                                   device="cpu")
    want = pipeline.BrickDataPipeline(pipeline.TokenBrickStore(**STORE),
                                      MetadataCatalog(4), global_batch=4,
                                      device="cpu").next_batch()
    batch = p.next_device_batch()
    assert batch["tokens"].dtype == torch.int64
    assert batch["tokens"].device == torch.device("cpu")
    assert batch["labels"] is batch["tokens"]
    assert np.array_equal(batch["tokens"].numpy(), want)
