"""The port stands alone: no file of brief_pytorch_tpu_torch/ or
chip_smoke.py imports jax, optax or anything of brief_pytorch_tpu, and an
entry point asked for no device raises when CUDA is absent instead of
running on the host."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "brief_pytorch_tpu")


def _files():
    files = sorted((ROOT / "brief_pytorch_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_package_has_files():
    names = {p.relative_to(ROOT).as_posix() for p in _files()}
    assert "brief_pytorch_tpu_torch/ops/fused_train.py" in names
    assert "brief_pytorch_tpu_torch/train/fit.py" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("name", [
    "train/checkpoint.py", "cli/main.py", "cli/multitask.py",
    "sched/tasks.py", "sched/multitask.py", "post/deblock.py",
    "core/typing.py", "utils/profiling.py"])
def test_package_has_the_cli_resume_multitask_deblock(name):
    """The modules of the CLI, resume, MultiTask and deblock are among
    those whose imports test_no_jax_imports reads."""
    names = {p.relative_to(ROOT).as_posix() for p in _files()}
    assert f"brief_pytorch_tpu_torch/{name}" in names


@pytest.mark.parametrize("path", _files(), ids=lambda p: p.name)
def test_no_jax_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path}: imports {mod}"


def test_entry_points_raise_without_cuda(monkeypatch):
    from brief_pytorch_tpu_torch.core import config as cfglib
    from brief_pytorch_tpu_torch.core.device import resolve_device
    from brief_pytorch_tpu_torch.eval.metrics import cal_ssim
    from brief_pytorch_tpu_torch.train.fit import NFGR
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = cfglib.load(str(ROOT / "opt/SingleTask/default.yaml"))
    with pytest.raises(RuntimeError, match="CUDA"):
        NFGR(opt.CompressFramework)
    with pytest.raises(RuntimeError, match="CUDA"):
        NFGR.decompress(opt.CompressFramework, "no/module", "no/side.yaml")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("0")
    import numpy as np
    with pytest.raises(RuntimeError, match="CUDA"):
        cal_ssim(np.zeros((4, 4, 1)), np.zeros((4, 4, 1)), 1.0)
    assert resolve_device("cpu").type == "cpu"
    assert NFGR(opt.CompressFramework, device="cpu").device.type == "cpu"


def test_cli_without_device_flag_targets_the_card(monkeypatch):
    from brief_pytorch_tpu_torch.cli import main as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-p", str(ROOT / "opt/SingleTask/default.yaml")])


def test_multitask_without_device_flag_targets_the_card(monkeypatch,
                                                        tmp_path):
    """MultiTask's in-process experiments run the port's cli.main.run on
    card 0 unless -g says cpu: without CUDA every task errors (none runs
    on the host) and temp_opt_<project>/ is removed."""
    import shutil
    from brief_pytorch_tpu_torch.cli import main as cli
    from brief_pytorch_tpu_torch.cli import multitask as mcli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    run = cli.run
    monkeypatch.setattr(cli, "run", lambda *a: calls.append(a) or run(*a))
    yaml_path = tmp_path / "default.yaml"
    shutil.copy(ROOT / "opt/MultiTask/default.yaml", yaml_path)
    queue = mcli.main(["-p", str(yaml_path)])
    assert len(calls) == 8 and not queue.finish_list
    assert [t.status for t in queue.error_list] == ["error"] * 2
    assert not (tmp_path / "temp_opt_multi").exists()
