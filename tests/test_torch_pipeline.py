"""The port's streaming feed (``repro_torch.data.pipeline``) against the
reference's behaviour (``tests/test_binning_blocked.py``,
``tests/test_engine.py``, ``tests/test_fault.py``,
``tests/test_integrity.py``), on the CPU: block lists and their
refusals, the ``BlockFeeder``'s bounded retry, ``FeedError`` with the
thread joined, close and context manager, a stuck producer escalated,
knob validation, validator quarantine, a fully quarantined feed, and the
placements: a device, a mesh placement's ``local(block, index)``, and the
refusal of anything else (a bare callable, the reference's multi-process
form, is a ``local`` here: ``tests/test_torch_multiproc.py``). The fault
hook is a plain deterministic callable."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.data.pipeline import (
    BlockFeeder, BlockValidator, DataIntegrityError, FeedError, sample_blocks, stream_blocks,
)

CPU = torch.device("cpu")


def _no_feeder_thread():
    return not any(t.name == "prf-block-feeder" and t.is_alive() for t in threading.enumerate())


def test_sample_blocks_keeps_ndarray_identity_and_views(tmp_path):
    arr_blocks = [np.arange(6, dtype=np.float32).reshape(3, 2), np.ones((2, 2), np.float32)]
    out = sample_blocks(arr_blocks)
    assert out[0] is arr_blocks[0] and out[1] is arr_blocks[1]
    mixed = sample_blocks([arr_blocks[0], [[1.0, 2.0]]])
    assert mixed[0] is arr_blocks[0] and isinstance(mixed[1], np.ndarray)

    p = tmp_path / "src.f32"
    mm = np.memmap(p, np.float32, "w+", shape=(10, 2))
    mm[:] = np.arange(20).reshape(10, 2)
    mm.flush()
    src = np.memmap(p, np.float32, "r", shape=(10, 2))
    views = sample_blocks(src, 4)
    assert len(views) == 3 and views[-1].shape == (2, 2)
    assert all(np.shares_memory(v, src) for v in views)


@pytest.mark.parametrize("row_range", [None, (3, 8), (0, 10), (5, 5), (9, 30)])
@pytest.mark.parametrize("listed", [False, True])
def test_sample_blocks_matches_reference(row_range, listed):
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    src = [x[:4], x[4:7], x[7:]] if listed else x
    want = jpipe.sample_blocks(src, 4, row_range=row_range)
    got = sample_blocks(src, 4, row_range=row_range)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.shape == w.shape


def test_stream_blocks_behaviour_and_refusals():
    x = np.zeros((10, 2), np.uint8)
    assert [b.shape[0] for b in stream_blocks(x, 4, what="t")] == [4, 4, 2]
    blocks = [x[:6], x[6:]]
    assert stream_blocks(blocks, 0, what="t", n_y=10, n_w=10) == blocks   # a list passes through
    with pytest.raises(ValueError, match="sample_block > 0"):
        stream_blocks(x, 0, what="t")
    with pytest.raises(ValueError, match="empty block sequence"):
        stream_blocks([], 4, what="t")
    with pytest.raises(ValueError, match="empty block sequence"):
        stream_blocks(x[:0], 4, what="t")
    with pytest.raises(ValueError, match="cover 10 samples"):
        stream_blocks(x, 4, what="t", n_y=9)


@pytest.mark.parametrize("prefetch", [0, 1, 3])
def test_feeder_delivers_every_block_in_order(prefetch):
    rng = np.random.default_rng(0)
    blocks = [rng.integers(0, 255, (n, 5), dtype=np.uint8) for n in (7, 7, 7, 3)]
    with BlockFeeder(blocks, placement=CPU, prefetch=prefetch) as feeder:
        got = list(feeder.sweep())
        again = list(feeder.sweep())
    for g, a, b in zip(got, again, blocks):
        np.testing.assert_array_equal(g.numpy(), b)
        np.testing.assert_array_equal(a.numpy(), b)
        assert g.numpy().base is not b            # a copy, never a view of the host block
    assert feeder.wait_s >= 0.0 and _no_feeder_thread()
    assert torch.equal(feeder.pin(np.arange(3)), torch.arange(3))


def test_feeder_retries_transient_faults_then_delivers():
    blocks = [np.full((4, 2), i, np.uint8) for i in range(5)]
    calls = []

    def hook(site):                # fails the first two attempts at every other site
        calls.append(site)
        if calls.count(site) <= 2 and site in ("block[1]", "block[3]", "pin"):
            raise OSError(f"flaky page-in at {site}")

    feeder = BlockFeeder(blocks, placement=CPU, prefetch=2, fault_hook=hook, backoff=1e-4)
    assert int(feeder.pin(np.array([7]))[0]) == 7
    got = [int(b[0, 0]) for b in feeder.sweep()]
    assert got == [0, 1, 2, 3, 4] and feeder.retries == 6


def test_feeder_exhausted_retries_raise_feed_error_and_join_thread():
    blocks = [np.zeros((32, 4), np.uint8) for _ in range(3)]

    def always_fail(site):
        raise RuntimeError(f"permanent @ {site}")

    feeder = BlockFeeder(blocks, placement=CPU, prefetch=2, fault_hook=always_fail,
                         max_retries=2, backoff=1e-4)
    with pytest.raises(FeedError, match="failed permanently after 2 retries"):
        list(feeder.sweep())
    feeder.close()
    assert _no_feeder_thread(), "feeder thread leaked after FeedError"
    sync = BlockFeeder(blocks, placement=CPU, prefetch=0, fault_hook=always_fail,
                       max_retries=1, backoff=1e-4)
    with pytest.raises(FeedError, match="block\\[0\\]"):
        next(iter(sync.sweep()))
    with pytest.raises(FeedError):
        sync.pin(np.zeros(2))


def test_feeder_non_retryable_error_is_not_retried():
    def bad(site):
        raise KeyError(site)

    feeder = BlockFeeder([np.zeros((2, 2), np.uint8)], placement=CPU, prefetch=1,
                         fault_hook=bad)
    with pytest.raises(KeyError):
        list(feeder.sweep())
    assert feeder.retries == 0 and _no_feeder_thread()


def test_feeder_sweep_close_and_context_manager_join_thread():
    blocks = [np.zeros((32, 4), np.uint8) for _ in range(6)]
    feeder = BlockFeeder(blocks, placement=CPU, prefetch=2)
    sweep = feeder.sweep()
    next(sweep)
    sweep.close()                       # abandon mid-sweep
    assert list(sweep) == []
    with BlockFeeder(blocks, placement=CPU, prefetch=2) as f2:
        assert sum(1 for _ in f2.sweep()) == len(blocks)
    with BlockFeeder(blocks, placement=CPU, prefetch=2) as f3:
        next(f3.sweep())                # left open: __exit__ closes it
    assert _no_feeder_thread(), "feeder thread leaked after close"


def test_sweep_close_escalates_stuck_thread_to_feed_error():
    blocks = [np.zeros((8, 2), np.uint8) for _ in range(3)]
    feeder = BlockFeeder(blocks, placement=CPU, prefetch=1, join_timeout=0.05)
    sweep = feeder.sweep()
    next(sweep)
    stuck = threading.Thread(target=lambda: time.sleep(0.5), daemon=True, name="prf-block-feeder")
    stuck.start()
    sweep._thread = stuck               # a producer that ignores cancellation
    feeder._last_site = "block[1]"
    with pytest.raises(FeedError, match=r"wedged at site 'block\[1\]'"):
        sweep.close()
    feeder.close()                      # the sweep deregistered itself: still safe
    stuck.join(timeout=5)
    assert not stuck.is_alive()


def test_feeder_knobs_validated():
    blocks = [np.zeros((8, 2), np.uint8)]
    for kw in (dict(max_retries=-1), dict(backoff=-1.0), dict(max_backoff=-1.0),
               dict(backoff_factor=0.5), dict(join_timeout=0)):
        with pytest.raises(ValueError):
            BlockFeeder(blocks, placement=CPU, **kw)
    with pytest.raises(ValueError, match="at least one sample block"):
        BlockFeeder([], placement=CPU)
    with pytest.raises(ValueError, match="out of range"):
        BlockFeeder(blocks, placement=CPU, quarantined=[5])


def test_feeder_placements_not_ported_and_device_rule(monkeypatch):
    blocks = [np.arange(16, dtype=np.uint8).reshape(8, 2)]
    for other in (lambda a, i: a, object()):
        with pytest.raises(ValueError, match="placement"):
            BlockFeeder(blocks, placement=other)

    class FirstRows:                    # a mesh placement: this rank's slice of each block
        device = CPU

        @staticmethod
        def local(block, index):
            assert index == 0
            return block[:4, 1:]

    for prefetch in (0, 2):
        with BlockFeeder(blocks, placement=FirstRows(), prefetch=prefetch) as feeder:
            got = list(feeder.sweep())
            assert torch.equal(feeder.pin(blocks[0]), torch.from_numpy(blocks[0]))   # pins are whole
        assert len(got) == 1 and torch.equal(got[0], torch.from_numpy(blocks[0][:4, 1:]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockFeeder(blocks)             # the port's default device is the card


def test_feeder_quarantines_shape_drift_and_skips_blocks():
    blocks = [
        np.zeros((16, 4), np.float32),
        np.zeros((16, 9), np.float32),         # drifted width
        np.full((16, 4), np.inf),              # poisoned
        np.zeros((16, 4), np.float32),
    ]
    feeder = BlockFeeder(blocks, placement=CPU, prefetch=2,
                         validator=BlockValidator("quarantine"))
    ref = jpipe.BlockFeeder(blocks, prefetch=2, validator=jpipe.BlockValidator("quarantine"))
    assert feeder.quarantined == ref.quarantined == (1, 2)
    assert feeder.live_blocks == ref.live_blocks == (0, 3)
    with feeder:
        got = list(feeder.sweep())
    assert len(got) == 2                       # quarantined blocks never transferred
    assert feeder.report.counters() == ref.report.counters()
    assert feeder.report.counters()["blocks_quarantined"] == 2


def test_feeder_refuses_fully_quarantined_feed():
    blocks = [np.full((8, 2), np.nan) for _ in range(2)]
    with pytest.raises(DataIntegrityError, match="every block quarantined"):
        BlockFeeder(blocks, placement=CPU, validator=BlockValidator("quarantine"))
    with pytest.raises(DataIntegrityError, match="every block quarantined"):
        BlockFeeder(blocks, placement=CPU, quarantined=[0, 1])
