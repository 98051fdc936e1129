"""The port's spans and counters (``graphconvgeo_torch/utils/profiling.py``):
what a span records, its range in a profiler's trace, the spans of
``Trainer.fit`` and of the operand builds, and the streamed head's block
counter in each epoch's history. All on the CPU except the ``cuda`` test,
which reads a span's device time on the card and skips here:

    python -m pytest --noconftest tests/test_torch_spans.py -m cuda

(this file imports no JAX, so it runs without the repository's conftest).
"""

import functools
import json
import math
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graphconvgeo_torch.data import pipeline
from graphconvgeo_torch.data.synthetic import make_synthetic_dumps
from graphconvgeo_torch.models import gcn
from graphconvgeo_torch.ops import ce_stream
from graphconvgeo_torch.sparse.formats import SparseGraph
from graphconvgeo_torch.train.trainer import TrainConfig, Trainer
from graphconvgeo_torch.utils import profiling
from graphconvgeo_torch.utils.profiling import span

FIT_PARTS = ("fit.step", "fit.predict", "fit.eval", "fit.record")


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("synthetic"))
    make_synthetic_dumps(path, n_users=600, n_clusters=6, seed=0)
    pcfg = pipeline.PreprocessConfig(bucket_size=30, min_df=2, celebrity_threshold=10)
    return pipeline.preprocess(path, pcfg, use_cache=False)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return "cuda"


def _trainer(ds, device="cpu", **tcfg):
    cfg = gcn.GCNConfig(n_features=ds.x.shape[1], n_classes=ds.n_classes, hidden=(16, 16))
    model = gcn.HighwayGCN(cfg, SparseGraph(csr=ds.x), SparseGraph(csr=ds.adj, symmetric=True),
                           device=device)
    return Trainer(model, TrainConfig(verbose=False, **tcfg))


def _fit(trainer, ds):
    return trainer.fit(ds.y, ds.train_idx, ds.dev_idx, lat=ds.lat, lon=ds.lon,
                       class_lat_median=ds.class_lat_median,
                       class_lon_median=ds.class_lon_median)


def test_span_records_name_parent_epoch_and_host_seconds():
    profiling.reset_spans()
    with span("outer", epoch=3):
        with span("inner"):
            time.sleep(0.01)
    with span("alone"):
        pass
    outer, inner, alone = profiling.span_records()
    assert (outer.name, outer.parent, outer.epoch) == ("outer", None, 3)
    assert (inner.name, inner.parent, inner.epoch) == ("inner", "outer", 3)
    assert (alone.name, alone.parent, alone.epoch) == ("alone", None, None)
    assert inner.host_s >= 0.01 and outer.host_s >= inner.host_s and alone.host_s >= 0.0
    assert all(r.device_s is None for r in (outer, inner, alone))
    profiling.reset_spans()
    assert profiling.span_records() == []


def test_span_is_a_range_in_the_profiler_trace():
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("spans.probe"):
            torch.ones(8).sum()
    assert "spans.probe" in {e.name for e in prof.events()}
    (rec,) = profiling.span_records()
    assert rec.device_s is None  # no card


def test_fit_leaves_one_span_of_each_part_an_epoch(ds):
    trainer = _trainer(ds, epochs=3, patience=3, min_epochs=3)
    profiling.reset_spans()
    out = _fit(trainer, ds)
    recs = profiling.span_records()
    for name in FIT_PARTS:
        assert [r.epoch for r in recs if r.name == name] == [0, 1, 2], name
    best = [r for r in recs if r.name == "fit.best_state"]
    # the clone before epoch 0, one an improving epoch, the final load
    assert best[0].epoch is None and best[-1].epoch is None and 3 <= len(best) <= 5
    assert all(r.parent is None for r in recs if r.name.startswith("fit."))
    assert all(r.host_s > 0.0 and r.device_s is None for r in recs)
    assert [h["counters"] for h in out["history"]] == [{"head_blocks": 0, "dense_fallback": 0,
                                                        "attn_rest_edges": 0,
                                                        "dot_attn_edges": 0}] * 3


def test_fit_profile_dir_trace_holds_the_fit_ranges(ds, tmp_path):
    trainer = _trainer(ds, epochs=3, patience=3, min_epochs=3, profile_dir=str(tmp_path),
                       profile_start=1, profile_stop=3)
    _fit(trainer, ds)
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    assert set(FIT_PARTS) <= {e.get("name") for e in events}


def test_head_blocks_counted_in_each_epoch(ds, monkeypatch):
    row_block = 128
    monkeypatch.setattr(gcn, "streamed_rows_threshold", lambda: 0)
    monkeypatch.setattr(ce_stream, "streamed_rows_threshold", lambda: 0)
    monkeypatch.setattr(gcn, "masked_ce_sums",
                        functools.partial(ce_stream.masked_ce_sums, row_block=row_block))
    monkeypatch.setattr(ce_stream, "streamed_argmax",
                        functools.partial(ce_stream.streamed_argmax, row_block=row_block))
    trainer = _trainer(ds, epochs=2, patience=2, min_epochs=2)
    n = int(trainer.model.x.shape[0])
    assert n > 2 * row_block
    before = profiling.counters["head_blocks"]
    out = _fit(trainer, ds)
    # the loss's blocks, their recompute in the backward, the predict's blocks
    want = 3 * math.ceil(n / row_block)
    assert [h["counters"]["head_blocks"] for h in out["history"]] == [want, want]
    assert profiling.counters["head_blocks"] - before == 2 * want
    profiling.reset_counters()
    assert profiling.counters == {"head_blocks": 0, "dense_fallback": 0, "attn_rest_edges": 0,
                                  "dot_attn_edges": 0}


def test_operand_builds_leave_one_record_each(ds):
    profiling.reset_spans()
    ds.factorized_adjacency()
    gcn.build_input_operands(SparseGraph(csr=ds.x))
    recs = profiling.span_records()
    assert [(r.name, r.parent, r.epoch) for r in recs] == [
        ("operands.adjacency", None, None), ("operands.input", None, None)]
    assert all(r.host_s > 0.0 and r.device_s is None for r in recs)


@pytest.mark.cuda
def test_step_span_reads_the_card_under_the_profiler(ds, card):
    trainer = _trainer(ds, device=card)
    y = torch.as_tensor(np.asarray(ds.y), dtype=torch.int64, device=card)
    mask = torch.zeros(len(ds.y), device=card)
    mask[torch.as_tensor(np.asarray(ds.train_idx), device=card)] = 1.0
    trainer.train_step(y, mask)  # warm-up
    profiling.reset_spans()
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for epoch in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with span("fit.step", epoch=epoch):
                trainer.train_step(y, mask)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    recs = profiling.span_records()
    assert [r.epoch for r in recs] == [0, 1, 2]
    for rec, wall in zip(recs, walls):
        assert 0.0 < rec.device_s <= wall, (rec, wall)
