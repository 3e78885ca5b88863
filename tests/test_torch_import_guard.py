"""The port imports torch and numpy, never JAX and nothing of the JAX
package — checked in a fresh interpreter that imports every port module
and ``chip_smoke.py``."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import distributedtensorflowexample_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
banned = ("jax", "jaxlib", "flax", "optax", "orbax",
          "distributedtensorflowexample_tpu")
hits = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), hits)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, hits = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20
    assert hits == "[]"
