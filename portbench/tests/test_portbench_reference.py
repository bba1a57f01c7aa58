"""The f32 reference against the port's plain path on the CPU, given the
same inputs: the training step's loss, first gradient and AdamW update
(the port's Trainer, its draws recorded), and the scoring forward's
probabilities.  The port is imported by the test, never by the reference."""

import subprocess
import sys

import pytest
import torch

from conftest import ROOT, tiny_cell


@pytest.mark.parametrize("steps", [1, 3])
def test_training_reference_follows_the_port(steps):
    from portbench.drivers import train_epochs as D
    cell = tiny_cell("train", compute="float32")
    cell["traffic"]["check_steps"] = steps
    st = D.setup(cell, 2**31 + 5, torch.device("cpu"))
    D.free_program(st)
    got = D.check(st, cell, torch.device("cpu"))
    assert got["inputs"] == []
    # f32 on both sides: summation order only
    assert got["gaps"]["loss_gap"] < 1e-6
    assert got["gaps"]["grad_gap"] < 1e-5
    assert got["gaps"]["change_gap"] < 1e-4
    assert got["gaps"]["pred1_gap"] < 1e-5


def test_the_compared_probabilities_are_the_first_steps():
    from portbench.reference import judge as J
    steps = [{"rows": {2: 4}, "n_pos": {2: 1}, "ws": {2: [1.0]}}] * 2
    norms = {"a": 1.0, "b": 2.0}
    ref = {"loss": [0.7, 0.7], "bce": [0.7, 0.7], "grad_norms": [norms] * 2,
           "change": norms,
           "pred": [torch.full((4,), 0.5), torch.full((4,), 0.5)]}

    def gaps(first, later):
        pred = [ref["pred"][0] + first, ref["pred"][1] + later]
        return J.train_gaps({**ref, "pred": pred}, ref, steps)

    got = gaps(0.001, 0.2)
    assert got["pred1_gap"] == pytest.approx(0.001, rel=1e-3)
    assert got["pred_gap"] == pytest.approx(0.2, rel=1e-3)
    assert gaps(0.2, 0.0)["pred1_gap"] == pytest.approx(0.2, rel=1e-3)


def test_scoring_reference_matches_the_port():
    from portbench.drivers import score_requests as D
    cell = tiny_cell("score", compute="float32")
    st = D.setup(cell, 2**31 + 6, torch.device("cpu"))
    answers = {i: st["call"](s) for i, s in enumerate(st["pool"])}
    got = D.check(st, cell, answers)
    assert got["inputs"] == [] and len(got["checked"]) == 3
    assert got["gaps"]["proba_gap"] < 1e-5


def test_a_wrong_negative_is_refused():
    """A negative that is a positive, beyond the sampler's fallback count,
    and one moved off its chromosome are both found."""
    import numpy as np
    from portbench.reference import judge as J
    chrom = np.array([0, 0, 0, 0, 1, 1, 1])
    index = {2: {(1, 2): 1.0, (4, 5): 0.5}}
    step = {"xs": {2: np.array([[1, 2], [4, 5], [1, 3], [4, 6]])},
            "n_pos": {2: 2}, "ws": {2: np.array([1.0, 0.5])},
            "fallback": 0}
    assert J.check_rows(step, index, chrom, 1) == []
    step["xs"][2] = np.array([[1, 2], [4, 5], [4, 5], [4, 6]])
    bad = J.check_rows(step, index, chrom, 1)
    assert any("off its chromosome" in b for b in bad)
    assert any("are positives" in b for b in bad)


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.model, portbench.reference.follow\n"
            "import portbench.reference.judge, portbench.reference.layout\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    tops = set(eval(out))
    assert not tops & {"matcha_tpu_torch", "matcha_tpu", "jax", "jaxlib",
                       "flax"}
