"""The port's telemetry (``matcha_tpu_torch/telemetry.py``) on the CPU.

Units, spans, syncs and counts: spans nest (a span's self time leaves out
what is nested in it), each lands in its thread's innermost unit, and a unit
opened inside another carries its id.  With no profiler running no
``record_function`` is entered on the step or request path.  Under a CPU
``torch.profiler`` over one seeded training step and one scoring call, the
Chrome trace holds every ``matcha:`` range inside its unit's range, with
the ring's durations.  A step counts one sync per size and per phase-2
round run, and an epoch one per size for its indices and one fetch.  The
benchmark's readers of these units (``portbench/metrics``) read nothing
without their kind, skip profiled units and take the means and medians
they name.
"""

import json
import statistics
import threading
import time

import numpy as np
import pytest
import torch

from matcha_tpu_torch import telemetry
from matcha_tpu_torch.apps.predict import predict_logits
from matcha_tpu_torch.data.batcher import BucketedBatcher
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.sampler.bloom import build_bloom_dict
from matcha_tpu_torch.sampler.negative import ChromTable
from matcha_tpu_torch.train import runtime as tr
from portbench.core import registry

KS = (2, 3, 4)
# one candidate a row in phase 1, so that phase 2 runs rounds
SETTINGS = dict(alpha=1.0, beta=0.001, neg_num=3, max_trials=1,
                max_probes=1, max_probes_k2=1, extra_rounds=32,
                token_stream="merged")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(21)
    genome = GenomeBins(["chr1", "chr2"], [20_000_000, 14_000_000],
                        1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)
    dims = th.ModelDims(dim=16, n_head=4, num_chroms=2, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    buckets = {}
    for k in KS:
        e = np.stack([np.sort(rng.choice(np.arange(1, n + 1), k,
                                         replace=False))
                      for _ in range(60)]).astype(np.int32)
        buckets[k] = (e, rng.random(60).astype(np.float32) + 0.5)
    return {"params": th.init_model(torch.Generator().manual_seed(0), dims,
                                    sizes, device="cpu"),
            "frozen": th.build_frozen_tables(genome, intra, inter,
                                             device="cpu"),
            "dims": dims, "train": buckets,
            "table": ChromTable.from_genome(genome, device="cpu"),
            "blooms": build_bloom_dict({k: e for k, (e, _) in
                                        buckets.items()}, device="cpu")}


def _trainer(p):
    return tr.Trainer(p["params"], p["frozen"], p["dims"], p["table"],
                      tr.TrainSettings(**SETTINGS), blooms=p["blooms"],
                      seed=3)


def _batch(p, rows=16):
    return {k: (torch.as_tensor(e[:rows]), torch.as_tensor(w[:rows]))
            for k, (e, w) in p["train"].items()}


def _samples(p):
    return ([list(r) for r in p["train"][3][0][:10]]
            + [list(r) for r in p["train"][2][0][:7]])


# ---------------------------------------------------------------- the module
def test_spans_nest_and_carry_their_unit():
    telemetry.reset()
    into = {}
    with telemetry.span("outside", into=into):
        pass
    with telemetry.unit("epoch", index=4) as ep:
        with telemetry.unit("step") as st:
            with telemetry.span("a"):
                with telemetry.span("b"):
                    time.sleep(0.003)
                with telemetry.sync("w"):
                    time.sleep(0.002)
                time.sleep(0.001)
            with telemetry.span("a"):
                pass
            telemetry.count("rounds", 2)
            telemetry.count("rounds")
        with telemetry.sync("fetch"):
            pass
    assert set(into) == {"outside_s"} and into["outside_s"] >= 0
    assert telemetry.units("epoch") == [ep]
    assert telemetry.units("step") == [st]
    assert (ep.kind, ep.index, ep.parent) == ("epoch", 4, None)
    assert (st.kind, st.index, st.parent) == ("step", None, ep.id)
    assert st.id != ep.id and not st.profiled
    assert ep.children == 1 and ep.child_s == st.seconds
    assert ep.own_s() == pytest.approx(ep.seconds - st.seconds)
    assert set(st.spans) == {"a", "b"} and "outside" not in st.spans
    assert st.spans["a"] >= st.spans["b"] + st.sync_s["w"] + 0.001
    assert st.self_s["a"] == pytest.approx(
        st.spans["a"] - st.spans["b"] - st.sync_s["w"])
    assert st.self_s["b"] == st.spans["b"] >= 0.003
    assert st.syncs == {"w": 1} and st.sync_s["w"] >= 0.002
    assert st.counts == {"rounds": 3}
    assert ep.syncs == {"fetch": 1} and ep.spans == {}


def test_another_threads_spans_stay_out_of_the_unit():
    telemetry.reset()
    with telemetry.unit("request") as u:
        t = threading.Thread(target=lambda: telemetry.span("t").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join()
        with telemetry.span("here"):
            pass
    assert set(u.spans) == {"here"}


def test_the_rings_keep_the_recent_units():
    telemetry.reset()
    for _ in range(telemetry.KEEP["epoch"] + 3):
        with telemetry.unit("epoch"):
            pass
    got = telemetry.units("epoch")
    assert len(got) == telemetry.KEEP["epoch"]
    assert [u.id for u in got] == sorted(u.id for u in got)


# -------------------------------------------------------- on the program
def test_no_record_function_without_a_profiler(problem, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    telemetry.reset()
    _trainer(problem).train_step(_batch(problem))
    predict_logits(problem["params"], problem["frozen"], problem["dims"],
                   _samples(problem), batch_size=4)
    step, = telemetry.units("step")
    req, = telemetry.units("request")
    assert not step.profiled and not req.profiled
    assert set(step.spans) == {"optimizer", "encode", "sample", "forward",
                               "recon", "loss", "backward", "recon_backward"}
    assert set(req.spans) == {"convert", "encode", "forward", "fetch"}
    # 10 rows of size 3 and 7 of size 2 in chunks of 4 (3 + 2 forward
    # calls): one copy to the device, not waited for, and one fetch
    assert req.syncs == {"fetch": 1}
    assert req.counts == {"convert.ragged": 1, "copies": 1}


def _matcha_events(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("matcha:")]


def test_the_profiler_trace_holds_every_span_in_its_unit(problem, tmp_path):
    trainer = _trainer(problem)
    trainer.train_step(_batch(problem))          # warm
    telemetry.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.train_step(_batch(problem))
        predict_logits(trainer.params, problem["frozen"], problem["dims"],
                       _samples(problem), batch_size=4)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = _matcha_events(path)
    outer = {e["name"]: e for e in events
             if e["name"] in ("matcha:step", "matcha:request")}
    assert set(outer) == {"matcha:step", "matcha:request"}
    inner = [e for e in events if e["name"] not in outer]
    assert {e["name"] for e in inner} >= {
        "matcha:sample", "matcha:forward", "matcha:backward",
        "matcha:sync:round", "matcha:sync:fetch", "matcha:convert"}

    def within(e, o):
        return (o["ts"] - 1 <= e["ts"]
                and e["ts"] + e["dur"] <= o["ts"] + o["dur"] + 1)
    for e in inner:
        assert any(within(e, o) for o in outer.values()), e["name"]

    for u, o in ((telemetry.units("step")[-1], outer["matcha:step"]),
                 (telemetry.units("request")[-1], outer["matcha:request"])):
        assert u.profiled
        assert o["dur"] == pytest.approx(1e6 * u.seconds, rel=0.1,
                                         abs=200)
        ring = {f"matcha:{n}": s for n, s in u.spans.items()}
        ring.update({f"matcha:sync:{n}": s for n, s in u.sync_s.items()})
        # each occurrence within 10% or 0.2 ms: their sums within 10% or
        # 0.2 ms per occurrence
        traced, seen = {}, {}
        for e in inner:
            if within(e, o):
                traced[e["name"]] = traced.get(e["name"], 0.0) + e["dur"]
                seen[e["name"]] = seen.get(e["name"], 0) + 1
        assert set(traced) == set(ring)
        for name, s in ring.items():
            assert traced[name] == pytest.approx(
                1e6 * s, rel=0.1, abs=200 * seen[name]), name


def test_a_step_syncs_once_per_size_and_round(problem):
    trainer = _trainer(problem)
    telemetry.reset()
    for _ in range(3):
        trainer.train_step(_batch(problem))
    steps = telemetry.units("step")
    assert len(steps) == 3
    assert sum(u.counts.get("rounds", 0) for u in steps) > 0
    for u in steps:
        assert u.syncs == {"round": len(KS) + u.counts.get("rounds", 0)}


def test_an_epoch_unit_holds_its_steps(problem):
    trainer = _trainer(problem)
    batcher = BucketedBatcher(problem["train"], 16, 3, seed=1)
    trainer.pin_base_buckets(batcher)
    telemetry.reset()
    res = [trainer.train_epoch_indexed(batcher) for _ in range(2)]
    epochs, steps = telemetry.units("epoch"), telemetry.units("step")
    assert [u.index for u in epochs] == [0, 1]
    assert trainer.last_epoch is epochs[-1]
    for ep in epochs:
        mine = [u for u in steps if u.parent == ep.id]
        assert len(mine) == ep.children == 3
        assert ep.syncs == {"indices": len(KS), "fetch": 1}
        assert ep.own_s() > 0
        # the CPU takes the plain versions: no kernel launches
        assert ep.counts == {f"launches.{k}": 0
                             for k in telemetry.kernel_launches()}
    split = telemetry.epoch_split(epochs[-1])
    mine = [u for u in steps if u.parent == epochs[-1].id]
    assert split["steps"] == 3
    assert split["syncs_per_step"] == pytest.approx(
        statistics.fmean(sum(u.syncs.values()) for u in mine)
        + (len(KS) + 1) / 3)
    assert split["rounds_per_step"] == pytest.approx(
        statistics.fmean(u.counts.get("rounds", 0) for u in mine))
    assert split["ms_per_step"]["backward"] == pytest.approx(
        1e3 * statistics.fmean(u.spans["backward"] for u in mine))
    assert split["ms_per_step"]["epoch"] == pytest.approx(
        1e3 * epochs[-1].own_s() / 3)
    assert set(res[0]) == set(res[1])


def test_a_step_counts_its_recon_blocks(problem, monkeypatch):
    trainer = _trainer(problem)
    telemetry.reset()
    trainer.train_step(_batch(problem))
    # the node rows decoded (N + 1) over the rows a block takes at the
    # drawn chromosome's width
    rows = problem["frozen"].chrom_of_node.shape[0]
    widths = [f.shape[1] for f in problem["frozen"].features]
    budget = 4 * max(widths) * 5
    monkeypatch.setattr(th, "RECON_BLOCK_BYTES", budget)
    trainer.train_step(_batch(problem))
    one, blocked = telemetry.units("step")
    assert one.counts["recon_blocks"] == 1
    assert blocked.counts["recon_blocks"] in {
        -(-rows // (budget // (4 * w))) for w in widths}
    # one block or several, the recon runs through _ReconBlocks; the CPU
    # runs the backward on the step's thread: its span lands there
    assert "recon" in one.spans and "recon_backward" in one.spans
    assert "recon" in blocked.spans and "recon_backward" in blocked.spans
    assert blocked.spans["forward"] >= blocked.spans["recon"] > 0


def _collective_rank(rank, dev, tmp):
    """Two steps of a Trainer on a 1 x 2 gloo mesh; saves each step unit's
    collective counts and what the shapes say they should be."""
    from matcha_tpu_torch.parallel import mesh as pm
    rng = np.random.default_rng(21)
    genome = GenomeBins(["chr1", "chr2"], [20_000_000, 14_000_000],
                        1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    inter = rng.random((n, n)).astype(np.float32)
    dims = th.ModelDims(dim=16, n_head=4, num_chroms=2, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    params = th.init_model(torch.Generator().manual_seed(0), dims, sizes,
                           device="cpu")
    buckets = {k: (np.stack([np.sort(rng.choice(np.arange(1, n + 1), k,
                                                replace=False))
                             for _ in range(16)]).astype(np.int32),
                   np.ones(16, np.float32)) for k in KS}
    trainer = tr.Trainer(params, th.build_frozen_tables(
        genome, intra + intra.T, inter, device="cpu"), dims,
        ChromTable.from_genome(genome, device="cpu"),
        tr.TrainSettings(**SETTINGS), seed=3, mesh=pm.make_mesh(1, 2))
    telemetry.reset()
    batch = {k: (torch.as_tensor(e), torch.as_tensor(w))
             for k, (e, w) in buckets.items()}
    for _ in range(2):
        trainer.train_step(batch)
    d, f32 = dims.dim, 4
    # encode: each rank's (C x R, d) rows, R the largest block of rows
    rows = max(-(-s // 2) for s in sizes)
    encode = 2 * len(sizes) * rows * d * f32
    # the logits: each rank's rows of every size padded to the largest
    per_k = 16 * (1 + SETTINGS["neg_num"])
    logits = 2 * (len(KS) * per_k // 2) * f32
    loss = 2 * f32                           # the recon loss's partials
    counts = n + 1                           # the token counts' sum
    grads = sum(t.numel() for t in tr._leaves(trainer.params))
    want = {"all_gather": (3, encode + logits + loss),
            "reduce_scatter": (3, encode + logits + loss),
            "all_reduce": (2, f32 * (counts + grads))}
    got = [{op: (u.counts.get(f"collective.{op}", 0),
                 u.counts.get(f"collective_bytes.{op}", 0)) for op in want}
           for u in telemetry.units("step")]
    spans = [sorted(k for k in u.spans if k.startswith("collective."))
             for u in telemetry.units("step")]
    torch.save({"want": want, "got": got, "spans": spans},
               f"{tmp}/rank{rank}.pt")


def test_mesh_collectives_are_counted_per_step(tmp_path):
    from matcha_tpu_torch.parallel import distributed as pd
    pd.spawn(_collective_rank, 2, str(tmp_path))
    for r in range(2):
        out = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert len(out["got"]) == 2
        for got, spans in zip(out["got"], out["spans"]):
            # the reduce-scatters are the all-gathers' backward: counted
            # from the forward's shapes, as on the card, where autograd
            # runs them on its own thread
            assert got == out["want"]
            assert spans == ["collective.all_gather",
                             "collective.all_reduce"]


# ------------------------------------------------------- the benchmark's
MESH_CELL_READS = ("forward_ms_per_step.train", "backward_ms_per_step.train",
                   "optimizer_ms_per_step.train", "epoch_ms_per_step.train",
                   "host_syncs_per_step.train",
                   "sync_wait_ms_per_step.train")
NEW = {
    "forward_ms_per_step.train": "train",
    "backward_ms_per_step.train": "train",
    "optimizer_ms_per_step.train": "train",
    "epoch_ms_per_step.train": "train",
    "host_syncs_per_step.train": "train",
    "sync_wait_ms_per_step.train": "train",
    "convert_ms_per_request.score": "score",
    "forward_ms_per_request.score": "score",
    "sync_wait_ms_per_request.score": "score",
    "host_syncs_per_request.score": "score",
}


def _unit(kind, profiled=False, index=None, scale=1.0, children=0):
    u = telemetry.Unit(kind, index, None)
    u.profiled = profiled
    if kind == "epoch":
        u.children, u.seconds = children, 2.0 * scale
        u.child_s = 1.5 * scale
        u.syncs, u.sync_s = {"indices": 4, "fetch": 1}, {"fetch": 0.01
                                                         * scale}
        return u
    names = (("encode", "sample", "forward", "loss", "backward",
              "optimizer") if kind == "step"
             else ("convert", "encode", "forward", "fetch"))
    u.spans = {n: scale * 1e-3 * (i + 1) for i, n in enumerate(names)}
    u.syncs = {"round": 5} if kind == "step" else {"chunk": 4, "fetch": 1}
    u.sync_s = {"round": 0.004 * scale} if kind == "step" else {
        "chunk": 0.002 * scale, "fetch": 0.001 * scale}
    return u


def _synthetic():
    """Two old steps and requests (outside the last 128), 128 plain ones
    and 5 profiled ones; epochs: the Trainer's first, a profiled one and
    three plain ones (100 steps each; own 0.5, 1.0 and 1.5 s)."""
    out = {}
    for kind in ("step", "request"):
        out[kind] = ([_unit(kind, scale=100.0) for _ in range(2)]
                     + [_unit(kind) for _ in range(64)]
                     + [_unit(kind, profiled=True, scale=50.0)
                        for _ in range(5)]
                     + [_unit(kind) for _ in range(64)])
    out["epoch"] = ([_unit("epoch", index=0, scale=9.0, children=100),
                     _unit("epoch", index=1, profiled=True, scale=7.0,
                           children=100)]
                    + [_unit("epoch", index=i + 2, scale=s, children=100)
                       for i, s in enumerate((1.0, 2.0, 3.0))])
    return out


EXPECTED = {   # step spans 1..6 ms; request spans 1..4 ms
    "forward_ms_per_step.train": 1.0 + 3.0 + 4.0,
    "backward_ms_per_step.train": 5.0,
    "optimizer_ms_per_step.train": 6.0,
    "epoch_ms_per_step.train": 1e3 * 1.0 / 100,
    "host_syncs_per_step.train": 5 + 5 / 100,
    "sync_wait_ms_per_step.train": 4.0 + 1e3 * 0.02 / 100,
    "convert_ms_per_request.score": 1.0,
    "forward_ms_per_request.score": 2.0 + 3.0,
    "sync_wait_ms_per_request.score": 3.0,
    "host_syncs_per_request.score": 5,
}


def test_the_new_metrics_are_in_the_benchmark():
    bench = registry.benchmark()
    got = {m["name"]: m for m in bench["per_layer"]}
    for name, kind in NEW.items():
        m = got[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        want = (["score_1mb"] if kind == "score" else
                ["train_100kb_b96", "train_1mb_b2048"])
        if name in MESH_CELL_READS:
            want = want + ["train_10kb_m4_b96"]
        assert m["workloads"] == want


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_reader_of_the_program_spans(name, monkeypatch):
    reader = registry.load_module("metrics", name)
    kind = NEW[name]
    other = "score" if kind == "train" else "train"
    units = _synthetic()
    monkeypatch.setattr(telemetry, "units", lambda k: list(units[k]))
    assert reader.read({}) is None
    assert reader.read({"kind": other}) is None
    assert reader.read({"kind": kind}) == pytest.approx(EXPECTED[name])
    for u in units["step"] + units["request"] + units["epoch"]:
        u.profiled = True
    assert reader.read({"kind": kind}) is None
