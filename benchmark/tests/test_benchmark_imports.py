"""Nothing a run loads is JAX or the JAX package, the plain reference
loads nothing of the port, and run.py refuses to run without a card."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny  # noqa: E402

from harness import runner  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "shgan_tpu"}


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_forbidden_names_compare_whole_top_level_names():
    mods = ["shgan_torch.serve", "shgan_torch", "jaxtyping", "flax_like",
            "shgan_tpu_x.y", "numpy"]
    assert runner.forbidden_modules(mods) == []
    assert runner.forbidden_modules(mods + ["jax.numpy", "shgan_tpu"]) == [
        "jax.numpy", "shgan_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run of every driver in a fresh process: afterwards
    sys.modules holds no module whose top-level name is JAX's or the JAX
    package's (the port's own name begins with the JAX package's)."""
    code = f"""
import json, sys
sys.path.insert(0, {str(tiny.BENCH / 'tests')!r})
import tiny, torch
torch.set_num_threads(2)
from harness import runner
root, man = tiny.tree({str(tmp_path)!r})
for name in ("tiny-stream", "tiny-interactive", "tiny-train"):
    runner.execute(runner.Cell(man, name, 3, 0.5, 0, torch.device("cpu"),
                               root=root), log=lambda s: None)
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=_env(), cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "shgan_torch.serve" in mods
    assert not {m.split(".")[0] for m in mods} & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for path in (tiny.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"shgan_torch"}, \
                    (path.name, n)
    code = f"""
import sys
sys.path.insert(0, {str(tiny.BENCH)!r})
import reference.generator, reference.training, reference.seeds
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert "shgan_torch" not in out.stdout and "jax" not in out.stdout


def test_run_refuses_without_a_card(tmp_path):
    """On a machine without CUDA run.py exits non-zero and prints no
    result; it does not fall back to the CPU."""
    out = subprocess.run(
        [sys.executable, str(tiny.BENCH / "run.py"), "--workload",
         "g512-stream-b8", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tiny.ROOT, env=_env())
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
