"""matcha_tpu_torch imports neither jax nor anything of matcha_tpu."""

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
leaked = sorted(n for n in sys.modules
                if n == "jax" or n.startswith(("jax.", "jaxlib"))
                or n == "matcha_tpu" or n.startswith("matcha_tpu."))
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
    assert report["leaked"] == []
