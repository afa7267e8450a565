"""tools/torch_serve_concurrency_smoke.py on the CPU (its --toy mode: a
2-block, 16-feature daemon at batch 4, T = 8): two clients' concurrent
requests against a fresh daemon's serial replay, byte for byte, in both
phases; and the tool's cleanup of a daemon that does not come up."""
import json
import os
import subprocess
import sys

import pytest

from tools import torch_serve_concurrency_smoke as smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_toy_concurrent_requests_equal_the_serial_replay(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "tools/torch_serve_concurrency_smoke.py", "--toy",
                        "--device", "cpu", "--workdir", str(tmp_path)],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["ok"] and rec["card"] == "cpu" and rec["batch"] == 4
    for phase in ("ddrm", "cond"):
        out = rec[phase]
        assert sorted(out["order"]) == ["r0", "r1", "r2", "r3"]
        assert len(out["concurrent_wall_s"]) == len(out["solo_wall_s"]) == 4
        assert out["launches_concurrent"] == {"fused_resblock": 0, "fused_posterior_step": 0}
    assert r.stdout.count("byte-equal to the serial replay") == 2
    assert not list(tmp_path.glob("*.sock"))  # both daemons shut down


def _daemons_on(sock):
    """Processes whose command line names `sock`."""
    found = []
    for pid in os.listdir("/proc"):
        if pid.isdigit():
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    if sock.encode() in f.read():
                        found.append(int(pid))
            except OSError:
                pass
    return found


@pytest.mark.parametrize("args,timeout,error", [
    (["--device", "cuda:7"], 120, RuntimeError),        # the daemon exits with an error
    (["--blocks", "2", "--features", "16", "--device", "cpu"], 0.2, TimeoutError),  # too slow
])
def test_a_daemon_that_does_not_come_up_is_killed(tmp_path, args, timeout, error):
    sock = str(tmp_path / "never.sock")
    with pytest.raises(error):
        smoke.start_daemon(args, sock, str(tmp_path / "daemon.log"), timeout=timeout)
    assert not _daemons_on(sock)
