"""The PyTorch port stands alone: no module of ``src/repro_torch`` and no
line of ``chip_smoke.py`` imports ``jax`` or the ``repro`` package (whose
``__init__`` installs the jax shims), and its entry points default to the
CUDA device instead of falling back to the CPU."""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            arg = node.args[0]
            head = arg.value if isinstance(arg, ast.Constant) else \
                "".join(v.value for v in arg.values if isinstance(v, ast.Constant))
            yield head


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for name in _imported(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for required in ("src/repro_torch/core/rollout.py", "src/repro_torch/kernels/ops.py",
                     "src/repro_torch/models/transformer.py", "src/repro_torch/core/trainer.py",
                     "src/repro_torch/optim/adam.py", "src/repro_torch/core/ppo.py",
                     "chip_smoke.py"):
        assert required in names


def test_entry_points_default_to_cuda():
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import LM

    cfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")), vocab_size=64)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        RolloutEngine(build_model(cfg, device="cpu"))
