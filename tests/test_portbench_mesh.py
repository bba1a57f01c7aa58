"""The benchmark's mesh cell on the CPU: its driver
(``portbench/drivers/train_epochs_mesh.py``), the blocked reference
(``portbench/reference/blocked.py``) and the readers it adds.

* A rank's blocks of the tables, drawn keyed by blocks of rows, are the
  same rows at one, two and four ranks, in ``core/inputs.py``'s layout;
* ``RankKeep`` keeps a rank's rows of a feature-dropout draw as packed
  keep bits, and its check refuses a draw that is not uniform;
* the blocked reference on a gloo world of two ranks, each holding its
  blocks, equals ``reference/follow.py`` on the whole tables (rtol 1e-5:
  f32 sums in another order), and so does one rank holding them whole;
* the driver on a 1 x 4 gloo mesh of the CPU (the port's plain versions in
  f32) trains, records and meets the blocked reference: pred1_gap under
  1e-5, grad_gap and change_gap under 1e-4, bce_gap under 1e-6 (f32
  rounding only); a traced run gives the mesh's records, and a calibration
  of two seeds in one world gives the control and the planted faults
  (among them the gradients' exchange between the ranks left out), which
  fail by far;
* the recorder keeps a per-chromosome feature draw as a ``RankKeep``;
* the recon loss's work counts the rows of rank 0's block that carry
  weight;
* the readers of the collectives and the recon loss.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from matcha_tpu_torch.parallel import distributed as pd  # noqa: E402
from matcha_tpu_torch.parallel.mesh import frozen_row_blocks  # noqa: E402
from portbench.core import inputs as I  # noqa: E402
from portbench.core import registry  # noqa: E402
from portbench.reference import blocked as B  # noqa: E402
from portbench.reference import follow as F  # noqa: E402
from portbench.reference import judge as J  # noqa: E402
from portbench.reference.layout import layout  # noqa: E402

TINY = ROOT / "portbench" / "tests" / "fixtures" / "tiny.json"
CELL = "train_10kb_m4_b96"
SEED = 3100000321


def _driver():
    import portbench.drivers.train_epochs_mesh as D
    return D


def _config(one_chrom=False):
    cfg = json.loads(TINY.read_text())
    cfg["model"]["compute_dtype"] = "float32"
    cfg["mesh"] = {"data": 1, "model": 4}
    if one_chrom:
        # one chromosome: the encode draws its feature dropout per
        # chromosome, as at 10 kb, and the recorder keeps RankKeep
        cfg["genome"].update(chrom_names=["c1"], chrom_sizes=[90_000_000])
        cfg["positives_per_k"] = 300
        cfg["model"]["kmer_size"] = [2, 3]
    return cfg


def _cell(one_chrom=False):
    cell = registry.cell(CELL, registry.benchmark())
    cell["config"] = _config(one_chrom)
    # the profiled stretch in the window's first epoch, which every window
    # runs however slow the host
    cell["traffic"] = {"driver": "train_epochs_mesh", "batch_size": 16,
                       "steps_per_epoch": 6, "check_steps": 3,
                       "profile_from": 1, "profile_steps": 2}
    return cell


def _whole(lay, parts, m):
    """The whole tables from every rank's blocks."""
    feats = []
    for c, b in enumerate(lay.bins):
        feats.append(torch.cat([p.features[c] for p in parts])[:b])
    inter = torch.cat([p.inter_z for p in parts])[:lay.n_nodes + 1]
    return feats, inter


def test_rank_tables_are_the_same_rows_at_any_rank_count(monkeypatch):
    D = _driver()
    monkeypatch.setattr(D, "ROWS", 8)      # several keyed blocks a table
    lay = layout(_config())
    cpu = torch.device("cpu")
    got = {}
    for m in (1, 2, 4):
        parts = [D.rank_tables(lay, torch.float32, cpu, SEED,
                               frozen_row_blocks(lay.bins, lay.n_nodes + 1,
                                                 m, i)) for i in range(m)]
        got[m] = _whole(lay, parts, m)
        assert all(p.inter_z.shape[1] == lay.n_nodes + lay.f_max
                   for p in parts)
    ref = I.make_tables(lay, torch.float32, cpu, SEED)
    for m in (2, 4):
        for a, b in zip(got[1][0], got[m][0]):
            assert torch.equal(a, b)
        assert torch.equal(got[1][1], got[m][1])
    feats, inter = got[1]
    for f, b in zip(feats, lay.bins):
        assert f.shape == (b, b) and torch.equal(f.diagonal(),
                                                 torch.ones(b))
        assert f.abs().max() <= 1.0
    assert inter[0].abs().sum() == 0
    assert inter[:, lay.n_nodes:].abs().sum() == 0
    assert abs(float(inter[1:, :lay.n_nodes].std()) - 1.0) < 0.05
    part = D.rank_tables(lay, torch.float32, cpu, SEED,
                         frozen_row_blocks(lay.bins, lay.n_nodes + 1, 4, 1))
    for name in ("attr_table", "chrom_of_node", "chrom_bounds"):
        assert torch.equal(getattr(part, name), getattr(ref, name))


def test_rank_keep_packs_its_rows_and_checks_the_draw():
    u = torch.rand((37, 37), generator=torch.Generator().manual_seed(2))
    rk = B.RankKeep(u, (5, 17), 0.2)
    assert rk.shape == (37, 37)
    assert torch.equal(rk.cpu().keep(), u[5:17] < 0.8)
    big = torch.rand((400, 400), generator=torch.Generator().manual_seed(3))
    assert B.RankKeep(big, (0, 400), 0.2).check() == []
    assert B.RankKeep(big * 0.5, (0, 400), 0.2).check()      # not uniform
    skew = B.RankKeep(big, (0, 400), 0.2)
    skew.rate = 0.5        # rows kept at 0.8, judged against 0.5
    assert skew.check() and "keep share" in skew.check()[0]


def _steps(lay, d, rng, n_steps=2):
    """Rows, weights, dropout uniforms and recon chromosomes of a few
    steps, drawn here."""
    steps = []
    for _ in range(n_steps):
        xs, n_pos, ws = {}, {}, {}
        for k in (2, 3):
            x = np.sort(rng.integers(1, lay.n_nodes + 1, (40, k)), axis=1)
            xs[k] = torch.as_tensor(x, dtype=torch.int32)
            n_pos[k] = 10
            ws[k] = torch.as_tensor(rng.random(10) + 0.5, dtype=torch.float32)
        g = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
        draws = [torch.rand((b, b), generator=g) for b in lay.bins]
        draws += [torch.rand((40, k, d), generator=g) for k in (2, 3)]
        draws.append(torch.rand((40 * 5, d), generator=g))
        steps.append({"xs": xs, "n_pos": n_pos, "ws": ws, "draws": draws,
                      "r": int(rng.integers(lay.n_chroms))})
    return steps


def _reference_problem():
    cfg = _config()
    lay = layout(cfg)
    cpu = torch.device("cpu")
    tables = I.make_tables(lay, torch.float32, cpu, SEED)
    params = I.make_params(lay, cfg["model"], cpu, SEED)
    return cfg, lay, tables, params, _steps(lay, 64,
                                            np.random.default_rng(4))


def _cut(tables, lay, m, i):
    rows = frozen_row_blocks(lay.bins, lay.n_nodes + 1, m, i)

    def cut(a, lo, hi):
        out = torch.zeros((hi - lo,) + tuple(a.shape[1:]), dtype=a.dtype)
        out[:max(0, min(hi, a.shape[0]) - lo)] = a[lo:hi]
        return out
    return tables._replace(
        features=tuple(cut(f, lo, hi) for f, (lo, hi) in
                       zip(tables.features, rows["features"])),
        inter_z=cut(tables.inter_z, *rows["inter_z"])), rows


def _with_keeps(steps, lay, rows, rate):
    out = []
    for st in steps:
        draws = list(st["draws"])
        for c, b in enumerate(lay.bins):
            lo, hi = rows["features"][c]
            draws[c] = B.RankKeep(draws[c], (min(lo, b), min(hi, b)), rate)
        out.append({**st, "draws": draws})
    return out


def _blocked_rank(rank, dev, tmp):
    torch.set_num_threads(1)
    cfg, lay, tables, params, steps = _reference_problem()
    mine, rows = _cut(tables, lay, 2, rank)
    rate = cfg["model"]["dropout_feature"]
    got = B.follow(params, mine, lay, cfg["model"],
                   _with_keeps(steps, lay, rows, rate), rows)
    torch.save(got, f"{tmp}/rank{rank}.pt")


def _close(a, b, rtol=1e-5, atol=1e-7):
    """Losses, probabilities and each step's gradient norms alike; the
    changes of the leaves the reference moves (``judge.moved_leaves``:
    AdamW's first step moves an element whose gradient is nought to
    rounding by the learning rate either way)."""
    for key in ("loss", "bce", "recon"):
        np.testing.assert_allclose(a[key], b[key], rtol=rtol, atol=atol)
    for p, q in zip(a["pred"], b["pred"]):
        torch.testing.assert_close(p, q, rtol=rtol, atol=atol)
    for g, h in zip(a["grad_norms"], b["grad_norms"]):
        for n in g:
            np.testing.assert_allclose(g[n], h[n], rtol=1e-4, atol=1e-7)
    for n in J.moved_leaves(a["grad_norms"]):
        np.testing.assert_allclose(a["change"][n], b["change"][n],
                                   rtol=1e-4, atol=1e-7)


def test_the_blocked_reference_equals_the_reference(tmp_path):
    cfg, lay, tables, params, steps = _reference_problem()
    ref = F.follow(params, tables, lay, cfg["model"], steps)
    assert ref["recon"][0] > 0 and ref["bce"][0] > 0
    # one rank holding the tables whole
    whole = {"features": [(0, b) for b in lay.bins],
             "inter_z": (0, lay.n_nodes + 1)}
    _close(ref, B.follow(params, tables, lay, cfg["model"], steps, whole))
    # two ranks of a gloo world, each on its blocks and its rows' keeps
    pd.spawn(_blocked_rank, 2, str(tmp_path))
    for r in range(2):
        _close(ref, torch.load(tmp_path / f"rank{r}.pt", weights_only=False))


def test_the_mesh_driver_meets_the_blocked_reference():
    D = _driver()
    out, = D.run_seeds(_cell(), [SEED], 0.5, True, torch.device("cpu"))
    gaps = out["check"]["gaps"]
    assert out["check"]["inputs"] == []
    assert gaps["pred1_gap"] < 1e-5 and gaps["bce_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4
    assert out["attempted"] >= 6 and out["failed"] == 0
    assert len(out["rank_peak_bytes"]) == 4
    rec = out["records"]
    assert rec["kind"] == "train" and rec["units"] == 2
    assert rec["collective_s"] == 0.0       # the CPU launches no kernel
    assert len(rec["recon_calls"]) == 2
    assert {c["width"] for c in rec["recon_calls"]} <= set(
        layout(_config()).bins)
    # a step's 16 x (2 + 3) positive tokens and their negatives weight some
    # of rank 0's rows, never more than it decodes
    assert all(0 < c["rows"] < c["decoded"] for c in rec["recon_calls"])


def test_the_recon_calls_count_the_rows_that_carry_weight():
    D = _driver()
    lay = layout(_config())
    lo, hi = 2, lay.n_nodes + 1
    calls = D._ReconCalls(lay, lo, hi, 64, 2)
    cnt = torch.zeros(lay.n_nodes + 1)
    r = 1
    first = lay.starts[r]              # r's first node id (0 is the pad)
    on_r = [first, first + 1]
    off_r = [1, 2, 3, lay.starts[r] + lay.bins[r]]
    cnt[on_r + off_r] = torch.tensor([3.0, 1.0, 2.0, 5.0, 1.0, 4.0])
    cnt[0] = 7.0
    calls._held = [(cnt, r)]
    call, = calls.calls
    # node 1 lies before the block, r's nodes and the pad carry no weight
    assert call["rows"] == 3 and call["decoded"] == hi - lo
    assert call["width"] == lay.bins[r]


def test_a_calibration_of_two_seeds_in_one_world():
    D = _driver()
    outs = D.run_seeds(_cell(one_chrom=True), [SEED, SEED + 1], 0.5, False,
                       torch.device("cpu"), calibrate=True)
    assert len(outs) == 2
    for out in outs:
        chk = out["check"]
        assert chk["inputs"] == []
        assert chk["gaps"]["pred1_gap"] < 1e-5
        assert chk["gaps"]["grad_gap"] < 1e-4
        # the control in float8 and the planted faults fail by far
        assert chk["control"]["pred1_gap"] > 100 * chk["gaps"]["pred1_gap"]
        assert chk["faults"]["half_batch"]["bce_gap"] > 1e-3
        assert chk["faults"]["state_unchanged"]["change_gap"] == 1.0
        # each rank stepping on its own part of the gradient
        assert chk["faults"]["exchange_left_out"]["grad_gap"] > 0.1
    assert outs[0]["check"]["gaps"] != outs[1]["check"]["gaps"]


def test_the_recorder_keeps_a_per_chromosome_draw_as_rank_keep():
    D = _driver()
    from matcha_tpu_torch.data.batcher import BucketedBatcher
    from matcha_tpu_torch.models.hypersagnn import FrozenTables
    from matcha_tpu_torch.sampler.negative import ChromTable
    from matcha_tpu_torch.train.runtime import Trainer
    import portbench.drivers.train_epochs as TE
    cfg = _config(one_chrom=True)
    lay = layout(cfg)
    cpu = torch.device("cpu")
    blocks = frozen_row_blocks(lay.bins, lay.n_nodes + 1, 1, 0)
    tables = D.rank_tables(lay, torch.float32, cpu, SEED, blocks)
    params = I.make_params(lay, cfg["model"], cpu, SEED)
    trainer = Trainer(params, FrozenTables(*tables),
                      TE.dims_of(cfg["model"], lay),
                      ChromTable.from_genome(TE.program_genome(cfg, lay),
                                             device=cpu),
                      TE.program_settings(cfg["model"]), seed=SEED)
    pos = I.positives(lay, cfg["model"]["kmer_size"], 300, SEED)
    batcher = BucketedBatcher(pos, 16, 2, seed=SEED)
    rec = D.MeshRecorder(trainer, params, 2, lay, blocks, 0.2).install()
    try:
        trainer.train_epoch(batcher)
    finally:
        rec.remove()
    for st in rec.steps:
        first = st["draws"][0]
        assert isinstance(first, B.RankKeep)
        assert first.shape == (lay.bins[0],) * 2 and first.check() == []
        assert all(isinstance(u, torch.Tensor) for u in st["draws"][1:])


def test_device_extras_read_the_collectives_and_the_recon_ranges():
    D = _driver()

    def x(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "tid": tid, "args": {}}
        if corr is not None:
            e["args"]["correlation"] = corr
        return e
    events = [
        x("user_annotation", "matcha:recon", 100, 50),
        x("user_annotation", "matcha:recon_backward", 400, 50, tid=2),
        x("cuda_runtime", "cudaLaunchKernel", 110, 2, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 410, 2, tid=2, corr=2),
        x("cuda_runtime", "cudaLaunchKernel", 300, 2, corr=3),
        x("kernel", "gemm", 120, 30, tid=7, corr=1),
        x("kernel", "elementwise", 420, 20, tid=7, corr=2),
        x("kernel", "ncclDevKernel_AllGather_RING_LL", 310, 40, tid=8,
          corr=3),
    ]
    got = D.device_extras(events)
    assert got["collective_s"] == pytest.approx(40e-6)
    assert got["recon_device_s"] == pytest.approx(50e-6)


def test_the_mesh_readers(monkeypatch):
    from matcha_tpu_torch import telemetry

    def read(name, rec):
        return registry.load_module("metrics", name).read(rec)
    call = {"rows": 75_785, "width": 24_897, "d": 64, "elem": 2,
            "dtype": "float32"}
    rec = {"kind": "train", "units": 2, "busy_s": 0.1, "collective_s": 0.004,
           "recon_device_s": 0.05, "recon_calls": [call, call]}
    assert read("collective_ms_per_step.train", rec) == pytest.approx(2.0)
    share = read("recon_roofline_pct.train", rec)
    least = 2 * 6 * 75_785 * 64 * 24_897 / 67e12
    assert share == pytest.approx(100 * least / 0.05) and 0 < share < 100
    for name in ("collective_ms_per_step.train", "recon_roofline_pct.train",
                 "collective_mb_per_step.train", "recon_ms_per_step.train"):
        assert read(name, {}) is None
        assert read(name, {"kind": "score"}) is None
    units = []
    for i in range(3):
        u = telemetry.Unit("step", None, None)
        u.counts = {"collective_bytes.all_gather": 1_000_000 * (i + 1),
                    "collective_bytes.all_reduce": 500_000, "rounds": 4}
        u.spans = {"recon": 0.002 * (i + 1)}
        units.append(u)
    monkeypatch.setattr(telemetry, "units", lambda kind: list(units))
    assert read("collective_mb_per_step.train",
                {"kind": "train"}) == pytest.approx(2.5)
    assert read("recon_ms_per_step.train",
                {"kind": "train"}) == pytest.approx(4.0)


def test_the_mesh_cell_is_in_the_benchmark():
    bench = registry.benchmark()
    cell = registry.cell(CELL, bench)
    assert cell["workload"]["chips"] == 4
    assert cell["config"]["mesh"] == {"data": 1, "model": 4}
    assert cell["traffic"]["driver"] == "train_epochs_mesh"
    assert {m["name"] for m in cell["end_to_end"]} == {
        "train_hyperedges_per_s", "setup_s"}
    names = {m["name"] for m in cell["per_layer"]}
    assert {"collective_ms_per_step.train", "collective_mb_per_step.train",
            "recon_roofline_pct.train", "recon_ms_per_step.train",
            "device_idle_pct.train", "mfu_pct.train",
            "ops_per_step.train"} <= names
    lay = layout(cell["config"])
    assert (lay.n_nodes, lay.f_max) == (303_137, 24_897)
