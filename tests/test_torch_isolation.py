"""matcha_tpu_torch imports neither jax nor anything of matcha_tpu, nor the
packages the machine with the card lacks (scikit-learn, optax, orbax), nor
h5py and matplotlib (only reading or writing an .mcool file and plotting
need them, inside the functions that do)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, json, pkgutil, sys
import matcha_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    matcha_tpu_torch.__path__, "matcha_tpu_torch."))
for m in mods:
    importlib.import_module(m)
banned = ("jax", "jaxlib", "matcha_tpu", "sklearn", "optax", "orbax",
          "h5py", "matplotlib")
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in banned)
print(json.dumps({"modules": mods, "leaked": leaked}))
"""


def test_port_imports_no_jax_and_nothing_of_matcha_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert "matcha_tpu_torch.ops.hyperedge_attention" in report["modules"]
    assert "matcha_tpu_torch.apps.predict_multiway" in report["modules"]
    for mod in ("ops.propose", "ops.fused_tail", "train.metrics",
                "train.logging", "config", "pipeline", "data.store",
                "data.kmers", "data.mcool", "native.kmer_native",
                "data.legacy", "apps.pairwise_fast", "apps.denoise_contact",
                "apps.outlier", "apps.analysis_bands",
                "apps.plot_embedding", "utils", "ops.incidence",
                "walks.alias", "walks.clique", "walks.hyper",
                "walks.skipgram", "walks.pretrain", "data.generic",
                "parallel.mesh", "parallel.stream", "parallel.distributed",
                "train.checkpoint"):
        assert f"matcha_tpu_torch.{mod}" in report["modules"]
    assert report["leaked"] == []


def test_chip_smoke_imports_no_jax_and_nothing_of_matcha_tpu():
    """The GPU smoke script imports the port alone (its main() runs only
    as a script)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = ("import json, sys\nimport chip_smoke\n"
             "banned = ('jax', 'jaxlib', 'matcha_tpu', 'sklearn', 'optax', "
             "'orbax')\n"
             "print(json.dumps(sorted(n for n in sys.modules "
             "if n.split('.')[0] in banned)))\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
