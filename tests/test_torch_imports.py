"""Import hygiene of the port, and its device contract.

The port (``src/repro_torch``) and ``chip_smoke.py`` import torch, numpy
and scipy — never JAX and never the reference package ``repro``.  Its entry
points run on the GPU unless asked for the CPU, and raise without one.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _banned(node.module or ""):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and _banned(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    mods = sorted(".".join(("repro_torch",) + tuple(
        part for part in p.relative_to(PORT).with_suffix("").parts
        if part != "__init__")) for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "import repro_torch.api.registry as r\n"
            "for reg in (r.AFFINITY, r.PARTITIONER, r.PIPELINE, r.PAIRWISE,"
            " r.OPTIMIZER):\n"
            "    [reg.get(n) for n in reg.names()]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.api import Experiment, ExperimentConfig, run
    from repro_torch.core.ssl_loss import SSLHyper
    from repro_torch.device import resolve_device
    from repro_torch.models.dnn import DNNConfig
    from repro_torch.train.trainer import train_dnn_ssl

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment(ExperimentConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_dnn_ssl(lambda: iter(()), cfg=DNNConfig(), hyper=SSLHyper())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["--epochs", "0"])
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resolve_device("meta")
    assert resolve_device("cpu").type == "cpu"
    assert Experiment(ExperimentConfig(), device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without CUDA,
    and alone in a directory without the package."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
