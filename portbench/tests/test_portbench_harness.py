"""The harness on the CPU: cells, mixes, metrics and limits found by name
from files; runs without a card or without the program give no result; the
modules a run loads; a sound run is correct, and a run with the timed path
broken underneath is not (each fault a cell can have); the control (the
reference in float8 in the program's place) fails the committed limits."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, run_cell, tiny_cell
from portbench.core import registry

BENCH = registry.benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_from_files(name):
    cell = registry.cell(name, BENCH)
    registry.load_module("drivers", cell["traffic"]["driver"])
    assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())
    assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_is_found_and_reads_nothing_from_nothing(name):
    reader = registry.load_module("metrics", name)
    assert reader.read({}) is None


def test_readers_on_a_stretch():
    rec = {"kind": "train", "units": 10, "window_s": 0.5, "busy_s": 0.05,
           "unit_s": 0.025,
           "device_ops": 18_000, "flops_per_unit": 1e9, "dtype": "bfloat16",
           "sampler_ms_per_step": 7.5,
           "calls": {"attn_fwd": [{"i": 0, "E": 384, "L": 3, "d": 64,
                                   "hd": 512, "elem": 2,
                                   "dtype": "bfloat16"}]},
           "ranges": {"portbench:attn_fwd:0": 1e-5}}

    def read(name):
        return registry.load_module("metrics", name).read(rec)
    assert read("device_idle_pct.train") == pytest.approx(80.0)
    assert read("ops_per_step.train") == 1_800
    assert read("mfu_pct.train") == pytest.approx(100 * 1e9 / 0.025 / 989e12)
    assert read("sampler_ms_per_step.train") == 7.5
    share = read("attn_fwd_roofline_pct.train")
    assert 0 < share < 100
    assert read("attn_fwd_roofline_pct.score") is None
    assert read("scatter_roofline_pct.train") is None
    assert read("request_ms_p95.score") is None
    rec.update(kind="score", request_ms_p95=48.5)
    assert read("request_ms_p95.score") == 48.5
    assert read("device_idle_pct.score") == pytest.approx(80.0)


def test_run_without_a_card_gives_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "train_100kb_b96", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_run_without_the_program_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "train_100kb_b96", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import io, contextlib\n"
        "from conftest import tiny_cell\n"
        "import torch\n"
        "from portbench import run\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    run.main(['--workload', 'x', '--seed', '1', '--seconds', '0.2',"
        " '--trace', '0'], cell=tiny_cell('train'),"
        " device=torch.device('cpu'))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))"
        % (str(ROOT), str(ROOT / "portbench" / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=600).stdout
    tops = set(eval(out.strip().splitlines()[-1]))
    assert "matcha_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "matcha_tpu"}


@pytest.mark.parametrize("kind", ["train", "score"])
def test_a_sound_run_is_correct(kind, capsys):
    line = run_cell(tiny_cell(kind), capsys)
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"


def _half_batch_loss(logits, batch, ws, ns=1):
    """The step's BCE over the first half of each size's positives and of
    its negatives only."""
    total, preds = 0.0, []
    for k in sorted(batch):
        n_pos = batch[k][0].shape[0]
        lg = logits[k]
        n = lg.shape[0]
        y = torch.cat([torch.ones(n_pos), torch.zeros(n - n_pos)])[:, None]
        w = torch.cat([ws[k].reshape(-1).float(),
                       torch.ones(n - n_pos)])[:, None]
        keep = torch.cat([torch.arange(n_pos // 2),
                          n_pos + torch.arange((n - n_pos) // 2)])
        bce = torch.nn.functional.binary_cross_entropy_with_logits(
            lg[keep], y[keep], reduction="none")
        total = total + (w[keep] * bce).mean()
        preds.append(torch.sigmoid(lg).reshape(-1))
    return total / len(batch), torch.cat(preds)


def _alter_one_answer(monkeypatch):
    from matcha_tpu_torch.apps import predict
    forward = predict.forward

    def altered(*a, **kw):
        out = forward(*a, **kw).clone()
        out[0] += 2.0
        return out
    monkeypatch.setattr(predict, "forward", altered)


@pytest.mark.parametrize("kind,fault", [
    ("train", "state_unchanged"), ("train", "half_batch"),
    ("score", "answer_altered")])
def test_a_broken_timed_path_is_not_correct(kind, fault, capsys,
                                            monkeypatch):
    from matcha_tpu_torch.train import runtime
    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.AdamW, "step",
                            lambda self, closure=None: None)
    elif fault == "half_batch":
        monkeypatch.setattr(runtime, "_bucket_bce_and_preds",
                            _half_batch_loss)
    else:
        _alter_one_answer(monkeypatch)
    line = run_cell(tiny_cell(kind), capsys)
    assert line["correct"] is False


def test_the_window_keeps_a_seeded_uniform_sample_of_answers():
    """The score window keeps ``k`` answers, the same for a seed, each
    request about as likely as any other to be among them."""
    from portbench.drivers.score_requests import Reservoir

    def kept(seed, n=1_000, k=4):
        r = Reservoir(k, seed)
        for i in range(n):
            r.offer(i, i)
        assert len(r.kept) == k and all(i == a for i, a in r.kept.items())
        return sorted(r.kept)
    assert kept(2**31 + 5) == kept(2**31 + 5) != kept(2**31 + 6)
    seen = [i for s in range(400) for i in kept(s, n=100)]
    halves = sum(i < 50 for i in seen), sum(i >= 50 for i in seen)
    assert abs(halves[0] - halves[1]) < 0.15 * len(seen)


def _nan_window_epoch(monkeypatch):
    """The first epoch after set-up's reports a loss that is not finite."""
    from matcha_tpu_torch.train.runtime import Trainer
    epoch = Trainer.train_epoch_indexed
    calls = {"n": 0}

    def nan_epoch(self, *a, **kw):
        res = epoch(self, *a, **kw)
        calls["n"] += 1
        return dict(res, bce=float("nan")) if calls["n"] == 2 else res
    monkeypatch.setattr(Trainer, "train_epoch_indexed", nan_epoch)


def _raising_request(monkeypatch):
    """The first request of the window raises; every other is sound."""
    from matcha_tpu_torch.apps import predict
    proba = predict.predict_proba
    calls = {"n": 0}

    def raising(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("planted")
        return proba(*a, **kw)
    monkeypatch.setattr(predict, "predict_proba", raising)


@pytest.mark.parametrize("kind,plant", [("train", _nan_window_epoch),
                                        ("score", _raising_request)])
def test_failed_work_is_not_correct_and_not_counted(kind, plant, capsys,
                                                    monkeypatch):
    from portbench.core.registry import load_module
    plant(monkeypatch)
    line = run_cell(tiny_cell(kind), capsys, seconds=1.5)
    assert line["failed"] > 0 and line["correct"] is False
    assert line["checks"]["failed"] == {"value": line["failed"], "limit": 0}
    monkeypatch.undo()
    plant(monkeypatch)
    cell = tiny_cell(kind)
    D = load_module("drivers", cell["traffic"]["driver"])
    out = D.run(cell, 2**31 + 11, 1.5, False, torch.device("cpu"))
    assert out["attempted"] > out["failed"] > 0
    rate, = out["e2e"].values() if kind == "train" else \
        [out["e2e"]["score_hyperedges_per_s"]]
    tr, model = cell["traffic"], cell["config"]["model"]
    per_unit = (D.hyperedges_per_step(tr, model) if kind == "train"
                else int(tr["per_k"]) * len(model["kmer_size"]))
    assert rate * out["window_s"] == pytest.approx(
        (out["attempted"] - out["failed"]) * per_unit)


@pytest.mark.parametrize("kind", ["train", "score"])
def test_the_control_fails_the_limits(kind):
    """The reference in float8 e4m3 in the program's place, at the tiny
    size: at least one number over its committed limit."""
    from portbench.core.registry import load_module
    cell = tiny_cell(kind)
    D = load_module("drivers", cell["traffic"]["driver"])
    got = D.run(cell, 2**31 + 21, 0.5, False, torch.device("cpu"),
                calibrate=True)
    control = got["check"]["control"]
    over = {n: v for n, v in control.items()
            if n in cell["limits"] and v > cell["limits"][n]}
    assert over, (control, cell["limits"])


def test_benchmark_file_keeps_the_contract():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(cuda_device):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "train_1mb_b2048", "--seed", "2147483999",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
