"""No module the benchmark loads is JAX's or the JAX package's (top-level
names compared whole), and the reference loads nothing of the port."""

import subprocess
import sys
from pathlib import Path

from portbench.harness import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["warpdrive_tpu_torch", "warpdrive_tpu_torch.ops",
                              "numpy", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["warpdrive_tpu.ops.knn_obs", "jax.numpy",
                              "optax"]) == ["jax", "optax", "warpdrive_tpu"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "optax",
                              "warpdrive_tpu"}


def _child(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_of_each_cell_loads_no_jax():
    code = (
        "import json, sys\n"
        "from portbench import harness\n"
        "from portbench.tests.conftest import SMALL, SEED\n"
        "for cell in SMALL:\n"
        "    harness.execute(cell, SEED, 1.0, True, device='cpu',\n"
        "                    overrides=SMALL[cell], settle=False)\n"
        "import portbench.calibrate\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    assert _child(code) == "[]"


def test_the_reference_loads_nothing_of_the_port():
    code = (
        "import json, sys\n"
        "import portbench.reference.tagenv, portbench.reference.a2c\n"
        "import portbench.reference.training\n"
        "import portbench.reference.simulation, portbench.measure\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0].startswith('warpdrive'))))\n")
    assert _child(code) == "[]"
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "import warpdrive" not in text, path
        assert "from warpdrive" not in text, path
