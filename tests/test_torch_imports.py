"""The port stands alone: it never imports ``jax`` or the reference
package ``repro``, at import time, while it serves AlexNet or a dense LM
or while it trains either or a recurrent LM (RWKV6, RG-LRU)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "ab_smoke.py",
                                      ROOT / "kernel_sweep.py"]

# `import jax`, `from jax`, `import repro[.]`, `from repro[. ]` — but not
# the port's own `repro_torch`
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)(\.|\s|,|$)|from\s+(jax|repro)(\.|\s))",
    re.MULTILINE)

CHILD = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.launch import serve, train
serve.main(["--arch", "alexnet", "--smoke", "--device", "cpu",
            "--requests", "3", "--slots", "2"])
serve.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
            "--requests", "3", "--slots", "2", "--capacity", "64",
            "--max-new", "4", "--block-size", "16"])
train.main(["--arch", "alexnet", "--smoke", "--faithful", "--device", "cpu",
            "--steps", "2", "--batch", "4", "--replicas", "2",
            "--image-size", "48", "--staging", "queue", "--eval-every", "1",
            "--eval-batches", "1"])
train.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "4", "--replicas", "2", "--seq-len", "32",
            "--eval-every", "1", "--eval-batches", "1"])
for arch, layers in (("rwkv6-7b", "1"), ("recurrentgemma-9b", "4")):
    train.main(["--arch", arch, "--smoke", "--layers", layers,
                "--d-model", "64", "--device", "cpu", "--steps", "2",
                "--batch", "4", "--replicas", "2", "--seq-len", "16"])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print("imported", len(names), "modules")
"""


def test_port_never_imports_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", CHILD], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("serve OK") == 2
    assert "arch=olmo-1b-smoke family=dense" in proc.stdout
    assert proc.stdout.count("done: steps 0 -> 2") == 4
    assert "arch=recurrentgemma-9b-smoke" in proc.stdout
    assert "arch=olmo-1b-smoke" in proc.stdout
    n = int(re.search(r"imported (\d+) modules", proc.stdout).group(1))
    assert n == len([f for f in FILES if f.parent != ROOT]) - 1


@pytest.mark.parametrize("path", FILES,
                         ids=[str(f.relative_to(ROOT)) for f in FILES])
def test_source_has_no_forbidden_import(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import x",
                "from repro.models import alexnet", "from repro import models",
                "import repro.kernels", "  import jax"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("from repro_torch import models", "import repro_torch.kernels",
               "# jax is the reference", "import jaxlib_free_thing"):
        assert not FORBIDDEN.search(ok), ok
