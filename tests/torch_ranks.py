"""Run a Python snippet as n ranks of a gloo process group on the host.

Each rank is a fresh interpreter (`python -c <script> <coordinator> <n>
<rank> <args...>`) with torch pinned to one thread; JOIN joins the
group.  A rank that fails or outlives the timeout fails the test, and the
others are killed: a dead rank must not hang the suite.
"""
import os
import subprocess
import sys
import tempfile
import textwrap

from brief_pytorch_tpu_torch.parallel.mesh import free_port, wait_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PREAMBLE = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from brief_pytorch_tpu_torch.parallel import mesh
    COORD, WORLD, RANK = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    ARGS = sys.argv[4:]
""")
JOIN = """
mesh.multihost_init(COORD, WORLD, RANK, device="cpu")
assert mesh.world() == WORLD and mesh.rank() == RANK
"""


def run_ranks(script: str, n: int, *args, timeout: float = 120.0,
              join: bool = True):
    """stdout of every rank of `script` (after PREAMBLE, and JOIN unless
    the script joins the group itself), in rank order."""
    coord = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    code = PREAMBLE + (JOIN if join else "") + textwrap.dedent(script)
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(n)]
        try:
            procs = [subprocess.Popen(
                [sys.executable, "-c", code, coord, str(n), str(r)]
                + [str(a) for a in args], stdout=logs[r],
                stderr=subprocess.STDOUT, text=True, env=env)
                for r in range(n)]
            error = None
            try:
                wait_ranks(procs, timeout)
            except RuntimeError as e:
                error = e
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
        finally:
            for f in logs:
                f.close()
    assert error is None, f"{error}:\n" + "\n".join(
        f"--- rank {r}:\n{out[-3000:]}" for r, out in enumerate(outs))
    return outs


def lines(out: str, tag: str):
    """The values after `tag` on each line of out that starts with it."""
    return [l.split(" ", 1)[1] for l in out.splitlines()
            if l.startswith(tag + " ")]
