"""The port's CLIs (brief_pytorch_tpu_torch/cli/main.py, cli/multitask.py)
against the JAX package's flag surface: every flag the JAX parsers define
parses with the same default; the flags of a run across hosts raise
NotImplementedError instead of being accepted and ignored; -profile -g cpu
writes a torch.profiler trace under the run dir.
"""
import ast
import json
import os

import numpy as np
import pytest
import torch

from brief_pytorch_tpu_torch.cli import main as cli
from brief_pytorch_tpu_torch.core import config as tcfg
from brief_pytorch_tpu_torch.io.image import save_img

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = {"store_true": [], "store_false": [], str: ["x"], int: ["3"],
          float: ["0.5"], None: ["1"]}


def _jax_flags(module):
    """(flag, action or type, default) of every add_argument in the JAX
    package's module, read from its source."""
    path = os.path.join(ROOT, "brief_pytorch_tpu", "cli", f"{module}.py")
    out = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            kind = kw["action"].value if "action" in kw else \
                {"str": str, "int": int, "float": float}.get(
                    getattr(kw.get("type"), "id", None))
            default = kw["default"] if "default" in kw else None
            if isinstance(default, ast.Constant):
                default = default.value
            elif default is not None:
                default = ast.unparse(default)
            out.append((node.args[0].value, kind, default))
    return out


MAIN_FLAGS = _jax_flags("main")
MULTI_FLAGS = _jax_flags("multitask")
HOSTS = ("-coordinator", "-nprocs", "-procid")


def test_the_jax_surfaces_were_read():
    assert len(MAIN_FLAGS) == 15 and len(MULTI_FLAGS) == 9
    assert {f for f, _, _ in MAIN_FLAGS} >= {"-p", "-g", "-resume",
                                             "-profile", *HOSTS}


@pytest.mark.parametrize("flag,kind,default", MAIN_FLAGS,
                         ids=[f for f, _, _ in MAIN_FLAGS])
def test_every_jax_flag_parses(flag, kind, default):
    p = cli.parser()
    dest = flag.lstrip("-")
    if default is not None and not str(default).startswith("os.path"):
        assert getattr(p.parse_args([]), dest) == default
    args = p.parse_args([flag] + SAMPLE[kind])
    if kind == "store_true":
        assert getattr(args, dest) is True
    elif kind == "store_false":
        assert getattr(args, dest) is False
    else:
        assert str(getattr(args, dest)) == SAMPLE[kind][0]


@pytest.mark.parametrize("flag,kind,default", MULTI_FLAGS,
                         ids=[f for f, _, _ in MULTI_FLAGS])
def test_every_jax_multitask_flag_parses(flag, kind, default, monkeypatch):
    from brief_pytorch_tpu_torch.cli import multitask as mcli
    seen = {}

    def fake_run(path, stp, **kw):
        seen.update(path=path, stp=stp, **kw)

        class Q:
            def status_table(self):
                return ""
        return Q()

    monkeypatch.setattr(mcli, "run_multitask", fake_run)
    value = SAMPLE[kind] if flag != "-g" else ["0,1"]
    mcli.main([flag] + value)
    assert seen["path"] == ("x" if flag == "-p"
                            else "opt/MultiTask/default.yaml")
    if flag == "-g":
        assert seen["device"] == "0"
    if flag == "-m":
        assert seen["max_task"] == 3


def test_multitask_subprocess_pins_every_listed_device(monkeypatch):
    from brief_pytorch_tpu_torch.cli import multitask as mcli
    seen = {}
    monkeypatch.setattr(mcli, "run_multitask",
                        lambda *a, **kw: seen.update(kw) or
                        type("Q", (), {"status_table": lambda s: ""})())
    mcli.main(["-subprocess", "-g", "0,cpu", "-m", "2"])
    assert seen["device_list"] == ["0", "cpu"] and seen["max_task"] == 2
    mcli.main(["-subprocess", "-g", "0,cpu", "-onebyone"])
    assert seen["device_list"] == ["0"] and seen["max_task"] == 1


@pytest.mark.parametrize("flag,value", [("-coordinator", "host:1234"),
                                        ("-nprocs", "2"), ("-procid", "0")])
def test_multihost_flags_raise(flag, value, tmp_path, monkeypatch):
    """Each of -coordinator -nprocs -procid alone raises ValueError (they
    go together); the three reach parallel/mesh.multihost_init with their
    values and -g's device, and the run goes on as that rank."""
    with pytest.raises(ValueError, match="go together"):
        cli.main(["-p", str(tmp_path / "never_read.yaml"), "-g", "cpu",
                  flag, value])
    seen = {}
    monkeypatch.setattr(cli.mesh, "multihost_init",
                        lambda *a, **kw: seen.update(args=a, **kw) or True)
    monkeypatch.setattr(cli.mesh, "shutdown", lambda: seen.update(down=1))
    monkeypatch.setattr(cli, "run", lambda p, args: {"g": args.g})
    flags = {"-coordinator": "host:1234", "-nprocs": "2", "-procid": "1"}
    flags[flag] = {"-nprocs": "3", "-procid": "0"}.get(flag, value)
    out = cli.main(["-p", "x.yaml", "-g", "cpu"]
                   + [t for kv in flags.items() for t in kv])
    assert seen["args"] == ("host:1234", int(flags["-nprocs"]),
                            int(flags["-procid"]))
    assert seen["device"] == torch.device("cpu") and seen["down"] == 1
    assert out == {"g": "cpu"}


def test_profile_writes_a_trace(tmp_path):
    """-profile -g cpu: the run's torch.profiler trace lands in
    <run dir>/profile/trace.json (Chrome trace format) beside the run's
    artifacts."""
    rng = np.random.default_rng(0)
    data = str(tmp_path / "vol8.tif")
    save_img(data, rng.integers(0, 60000, (8, 8, 8, 1)).astype(np.uint16))
    opt = tcfg.load(os.path.join(ROOT, "opt", "SingleTask", "default.yaml"))
    opt.Dataset.data_path = data
    opt.Log.update(outputs_dir=str(tmp_path), project_name="prof",
                   stdlog=False, tensorboard=False, time=False)
    c = opt.CompressFramework
    c.Compress.max_steps = 3
    c.Compress.checkpoints = "none"
    c.Compress.param.filesize_ratio = 0
    c.Compress.param.given_size = 4 * (3 * 4 + 4 + 4 * 4 + 4 + 4 + 1)
    c.Module.phi.layers = 3
    c.Decompress.mip = False
    path = str(tmp_path / "prof.yaml")
    tcfg.save(opt, path)
    summary = cli.main(["-p", path, "-g", "cpu", "-profile", "-gc", "1",
                        "-debug", "-substore", "-dropslice"])
    assert summary["steps"] == 3
    trace = tmp_path / "prof" / "profile" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert (tmp_path / "prof" / "performance.csv").exists()


def test_profile_warns_when_the_trace_holds_no_device_kernel(tmp_path,
                                                             capsys):
    """utils/profiling.trace counts the trace's device kernels into
    kernels.json; a trace without one (here: the CPU) is said so on
    standard error and in the run's log instead of being written
    silently."""
    import torch
    from brief_pytorch_tpu_torch.utils.profiling import trace
    log = tmp_path / "stderr.log"
    with trace(str(tmp_path / "profile"), str(log)):
        (torch.ones(64) * 2).sum()
    err = capsys.readouterr().err
    assert "WARNING profile" in err and "no device kernel" in err
    assert "no device kernel" in log.read_text()
    assert json.loads((tmp_path / "profile" / "kernels.json").read_text()) \
        == {}
    assert (tmp_path / "profile" / "trace.json").exists()
