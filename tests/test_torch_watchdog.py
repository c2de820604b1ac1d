"""A hang watchdog for the port's test files.

A port test module that starts threads (the training loader), runs a CLI
in-process, or runs a Pallas kernel in interpret mode can hang: a thread
that never returns, or an interpreted kernel that never completes (the
JAX package's interpret mode keeps one simulated device memory per
process). Under xdist one hung test stops the whole run at its time limit,
and the run then reports only what finished before. Such a module takes
`watchdog()` as an autouse module fixture: if the module has not finished
within `WATCHDOG_S`, faulthandler prints every thread's traceback and ends
the worker, which xdist reports as a crashed test, and the run goes on.
"""

import faulthandler
import os
import subprocess
import sys

import pytest

# Longer than any port module takes on a loaded worker (the slowest, the
# variants and the float64 steps, take 2-4 minutes alone), far below the
# run's limit.
WATCHDOG_S = 900


def watchdog(seconds: float = WATCHDOG_S):
    """An autouse module fixture arming the watchdog for the module."""
    @pytest.fixture(scope="module", autouse=True)
    def hang_watchdog(request):
        # The tracebacks go to the process's own stderr: pytest captures
        # fd 2 while a test runs, and a capture dies with the process.
        capman = request.config.pluginmanager.getplugin("capturemanager")
        if capman is None:
            fd = os.dup(2)
        else:
            with capman.global_and_fixture_disabled():
                fd = os.dup(2)
        faulthandler.dump_traceback_later(seconds, exit=True, file=fd)
        yield
        faulthandler.cancel_dump_traceback_later()
        os.close(fd)
    return hang_watchdog


def run_pytest(tmp_path, modules):
    """pytest in a subprocess on the given {name: source} modules, which
    import `watchdog` from this file."""
    for name, src in modules.items():
        (tmp_path / name).write_text(src)
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-o", "addopts=",
         "--noconftest", "-p", "no:randomly", *sorted(modules)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__))))


WATCHED = "from test_torch_watchdog import watchdog\nhang_watchdog = watchdog({s})\n"


def test_watchdog_ends_a_hung_module_with_its_tracebacks(tmp_path):
    out = run_pytest(tmp_path, {"test_a.py": WATCHED.format(s=1) + (
        "import threading, time\n"
        "def test_hangs():\n"
        "    threading.Thread(target=time.sleep, args=(60,), daemon=True).start()\n"
        "    time.sleep(60)\n")})
    assert out.returncode != 0
    assert "Timeout" in out.stderr and out.stderr.count("Thread 0x") >= 2
    assert "test_hangs" in out.stderr


def test_watchdog_is_disarmed_when_its_module_ends(tmp_path):
    out = run_pytest(tmp_path, {
        "test_a.py": WATCHED.format(s=1) + "def test_quick():\n    pass\n",
        "test_b.py": "import time\ndef test_after():\n    time.sleep(2)\n"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "2 passed" in out.stdout
