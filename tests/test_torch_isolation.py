"""The port stands alone: it imports neither JAX, the JAX package nor
``ml_dtypes`` (present here through JAX, absent on the card's machine), it
loads no kernel library and no ``triton`` when imported, and it never
lands on the CPU unless asked to."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import CLapp, DeviceTraits, DeviceType, NoMatchingDeviceError

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _port_files():
    """The package, chip_smoke.py and the port's measurement scripts."""
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("*.py")))


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_kernel_library_or_triton():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
        "from repro_torch.kernels import _build\n"
        f"bad = [m for m in {FORBIDDEN + ('triton',)!r} if m in sys.modules]\n"
        "print('LIB', _build._LIB is None, 'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "LIB True BAD []" in r.stdout, r.stdout


def test_default_traits_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoMatchingDeviceError):
        CLapp().init()
    with pytest.raises(NoMatchingDeviceError):
        CLapp().init(device_traits=DeviceTraits(type=DeviceType.GPU))
    assert CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU)).device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env,
                       capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
