"""The port's launchers (``byteps_tpu_torch/launcher/``), mirroring
tests/test_launcher.py: role dispatch, the worker's environment, the
server, scheduler and joint roles on the port's server, and the ssh plan
with servers against the JAX launcher's."""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from byteps_tpu.launcher import dist_launcher as JDL
from byteps_tpu.launcher import launch as JL
from byteps_tpu_torch.core import build
from byteps_tpu_torch.launcher import dist_launcher as DL
from byteps_tpu_torch.launcher import launch as L

from testutil import free_port
from torch_port_ps import REPO, server_env, wait_closed, wait_listening

LAUNCH = [sys.executable, "-m", "byteps_tpu_torch.launcher.launch"]


def test_worker_env_defaults():
    env = L.build_worker_env({"DMLC_NUM_WORKER": "4"})
    assert env["BYTEPS_LOCAL_RANK"] == "0" and env["BYTEPS_LOCAL_SIZE"] == "1"
    assert "BYTEPS_TPU_JAX_DIST" not in env   # no JAX rendezvous here
    assert L.build_worker_env({"BYTEPS_LOCAL_RANK": "3"})[
        "BYTEPS_LOCAL_RANK"] == "3"


def test_worker_command_gdb_wrap():
    assert L.worker_command(["python", "t.py"], {"BYTEPS_ENABLE_GDB": "1"})[0] \
        == "gdb"
    assert L.worker_command(["python", "t.py"], {}) == ["python", "t.py"]


def test_server_commands_are_the_references():
    for role in ("server", "scheduler", "joint"):
        want = [w.replace("byteps_tpu.server", "byteps_tpu_torch.server")
                for w in JL.server_command(role)]
        assert L.server_command(role) == want


def test_launch_worker_role_runs_command(tmp_path):
    out = tmp_path / "out.txt"
    rc = subprocess.call(
        LAUNCH + [sys.executable, "-c", f"open(r'{out}', 'w').write('ran')"],
        env=dict(os.environ, DMLC_ROLE="worker", PYTHONPATH=REPO))
    assert rc == 0 and out.read_text() == "ran"


def test_launch_no_command_fails():
    rc = subprocess.call(LAUNCH, env=dict(os.environ, DMLC_ROLE="worker",
                                          PYTHONPATH=REPO))
    assert rc == 2


@pytest.mark.parametrize("role,offset", [("server", 1), ("scheduler", 0)])
def test_server_and_scheduler_roles_serve(role, offset):
    """The server listens on the root port + 1 + DMLC_SERVER_ID, the
    scheduler on the root port itself."""
    build.build()
    root = free_port()
    # Its own process group: the launcher waits on the server it starts,
    # and both go at the end.
    proc = subprocess.Popen(LAUNCH, env=server_env(
        root + 1, 1, {"DMLC_ROLE": role}), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, start_new_session=True)
    try:
        wait_listening(root + offset, proc)
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    assert wait_closed(root + offset)


def test_launch_joint_role_runs_server_beside_worker(tmp_path):
    """DMLC_ROLE=joint starts the port's server on this host AND runs the
    training command, a PS-mode training run through the Horovod face,
    then tears the server down when training exits."""
    build.build()
    port = free_port()
    env = server_env(port, 1, {
        "DMLC_ROLE": "joint", "BYTEPS_TPU_PS_MODE": "1",
        "DMLC_NUM_SERVER": "1", "BYTEPS_TPU_SIGNAL_WINDOW_S": "0"})
    prefix = str(tmp_path / "joint")
    rc = subprocess.call(LAUNCH + [
        sys.executable, os.path.join(REPO, "tests", "torch_port_ps_worker.py"),
        "train", prefix], env=env, timeout=120)
    assert rc == 0
    res = np.load(prefix + ".0.npz")
    np.testing.assert_array_equal(res["rank_size"], [0, 1])
    assert res["ps"]          # the joint host's worker is in PS mode
    assert np.all(np.isfinite(res["losses"]))
    assert wait_closed(port), "joint-role server still alive after trainer exit"


def test_dist_launcher_plan_with_servers(tmp_path):
    """With servers: the JAX launcher's plan (scheduler on the first
    server host, one server per host, the workers), package swapped, and
    the workers in PS mode."""
    wf = tmp_path / "workers.txt"
    sf = tmp_path / "servers.txt"
    wf.write_text("w0\nw1\n")
    sf.write_text("s0\n")
    argv = ["--num-workers", "2", "--num-servers", "1",
            "--worker-hostfile", str(wf), "--server-hostfile", str(sf),
            "--log-dir", str(tmp_path / "logs"),
            "python", "train.py", "--lr", "0.1"]
    got = DL.launch(DL.parse_args(argv), dry_run=True)
    want = JDL.launch(JDL.parse_args(argv), dry_run=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = [t.replace("byteps_tpu.launcher", "byteps_tpu_torch.launcher")
             for t in w]
        if "DMLC_ROLE=worker" in w[-1]:
            w[-1] = w[-1].replace("; python -m",
                                  " BYTEPS_TPU_PS_MODE=1; python -m")
        assert g == w
    joined = [" ".join(c) for c in got]
    assert any("DMLC_ROLE=scheduler" in c and "s0" in c for c in joined)
    assert all("DMLC_PS_ROOT_URI=s0" in c for c in joined)
