"""The port's task queue (brief_pytorch_tpu_torch/sched/tasks.py): the
cases of tests/test_sched.py, parametrised where they repeat: retries up
to a bound, callable and subprocess tasks, the status table, concurrency,
device slots and subprocess timeouts.  Device pinning is the port's one
way: `-g <slot>` appended and BRIEF_DEVICE set, CUDA_VISIBLE_DEVICES
inherited unchanged.
"""
import os
import sys
import threading
import time

import pytest

from brief_pytorch_tpu_torch.sched.tasks import Queue, Task


def _flaky(fails: int):
    attempts = {"n": 0}
    lock = threading.Lock()

    def flaky():
        with lock:
            attempts["n"] += 1
            if attempts["n"] <= fails:
                raise RuntimeError("transient")
        return "ok"
    return flaky, attempts


@pytest.mark.parametrize("max_task", [1, 2])
def test_flaky_task_retries_then_finishes(max_task):
    flaky, attempts = _flaky(2)
    others = [Task("true", f"ok{i}") for i in range(max_task)]
    q = Queue([Task(flaky, "flaky")] + others)
    q.start(max_task=max_task)
    assert attempts["n"] == 3
    assert len(q.finish_list) == 1 + len(others) and not q.error_list
    task = next(t for t in q.finish_list if t.name == "flaky")
    assert task.result == "ok" and task.ets == 2


@pytest.mark.parametrize("max_retries,attempts", [(0, 1), (2, 3)])
def test_permanent_failure_lands_in_error_list(max_retries, attempts):
    def bad():
        raise RuntimeError("always")

    q = Queue([Task(bad, "bad")], max_retries=max_retries)
    q.start()
    assert not q.finish_list
    assert len(q.error_list) == 1 and q.error_list[0].ets == attempts
    assert q.error_list[0].status == "error"


@pytest.mark.parametrize("command,status,ok", [
    ("true", "finish", True), ("false", "error", False)])
def test_subprocess_task_status(command, status, ok):
    t = Task(command, "t")
    q = Queue([t], max_retries=0)
    q.start()
    assert t.status == status and (t.returncode == 0) == ok
    assert (q.finish_list if ok else q.error_list) == [t]


def test_subprocess_tasks_keep_their_order():
    q = Queue([Task("true", "t_ok"), Task("false", "t_bad")], max_retries=0)
    q.start()
    assert [t.name for t in q.finish_list] == ["t_ok"]
    assert [t.name for t in q.error_list] == ["t_bad"]


def test_status_table_lists_all_tasks():
    q = Queue([Task("true", "alpha"), Task("false", "beta")], max_retries=1)
    q.start()
    table = q.status_table().splitlines()
    assert table[0].split() == ["name", "status", "retries"]
    assert table[1].split() == ["alpha", "finish", "0"]
    assert table[2].split() == ["beta", "error", "2"]


def test_max_task_runs_concurrently():
    def slow():
        time.sleep(0.5)
        return 1

    q = Queue([Task(slow, f"t{i}") for i in range(4)])
    t0 = time.perf_counter()
    q.start(max_task=4)
    dt = time.perf_counter() - t0
    assert len(q.finish_list) == 4 and not q.error_list
    assert dt < 1.5, dt   # serial would be ~2.0s


def test_subprocess_tasks_pinned_to_distinct_devices(tmp_path, monkeypatch):
    """Two concurrent children get different slots of device_list, each as
    -g <slot> and BRIEF_DEVICE, with CUDA_VISIBLE_DEVICES as the parent
    has it (the child numbers the cards as the parent does); the slots go
    back to the pool."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    out = tmp_path / "devs.txt"
    script = tmp_path / "child.py"
    script.write_text(
        "import sys, os, time\n"
        "with open(sys.argv[1], 'a') as f:\n"
        "    f.write(sys.argv[sys.argv.index('-g') + 1] + ',' +\n"
        "            os.environ.get('BRIEF_DEVICE', '?') + ',' +\n"
        "            os.environ.get('CUDA_VISIBLE_DEVICES', '?') + '\\n')\n"
        "time.sleep(0.4)\n")
    tasks = [Task(f"{sys.executable} {script} {out}", f"t{i}")
             for i in range(2)]
    q = Queue(tasks, device_list=[0, "cpu"])
    q.start(max_task=2, debug=True)
    lines = sorted(out.read_text().strip().splitlines())
    assert lines == ["0,0,0,1", "cpu,cpu,0,1"], lines
    assert all(t.device is None for t in tasks)


def test_max_task_clamped_to_the_device_slots(tmp_path):
    out = tmp_path / "n.txt"
    script = tmp_path / "count.py"
    script.write_text(
        "import sys, time\n"
        "open(sys.argv[1], 'a').write('x')\n"
        "time.sleep(0.2)\n")
    tasks = [Task(f"{sys.executable} {script} {out}", f"t{i}")
             for i in range(3)]
    q = Queue(tasks, device_list=[0])
    q.start(max_task=3)
    assert len(q.finish_list) == 3 and out.read_text() == "xxx"


def test_commands_without_device_list_are_untouched(tmp_path):
    out = tmp_path / "argv.txt"
    script = tmp_path / "argv.py"
    script.write_text(
        "import sys, os\n"
        "open(sys.argv[1], 'w').write(' '.join(sys.argv[2:]) + '|' +\n"
        "                             os.environ.get('BRIEF_DEVICE', '-'))\n")
    q = Queue([Task(f"{sys.executable} {script} {out} a b", "t")])
    q.start()
    assert out.read_text() == "a b|-"


@pytest.mark.parametrize("command,timeout_s,status,returncode", [
    ("sleep 30", 1.0, "error", 124), ("true", 30.0, "finish", 0)])
def test_subprocess_timeout(command, timeout_s, status, returncode):
    """A hung child is bounded by Task.timeout_s: its whole process group
    is killed, the task errors with 124 and the retry accounting applies;
    a child within its time finishes."""
    t = Task(command, name="t", timeout_s=timeout_s)
    q = Queue([t], max_retries=0)
    t0 = time.time()
    q.start()
    assert time.time() - t0 < 10
    assert t.status == status and t.returncode == returncode
