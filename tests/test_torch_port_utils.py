"""byteps_tpu_torch's callbacks, checkpointing, data helpers and launchers
against the JAX package's.

The warmup schedule against optax's over 0..2 warmup, alone and joined to
a decay; the EF LR rescale; checkpoint save/restore and latest_step_dir
on the same directory layout; host_shard against JAX's; prefetch; and the
launchers' environment and ssh dry-run commands against the JAX
launcher's with the package name swapped.
"""

import argparse
import os

import numpy as np
import optax
import pytest
import torch

from byteps_tpu import callbacks as jcb
from byteps_tpu.launcher import dist_launcher as JDL
from byteps_tpu.launcher import launch as JL
from byteps_tpu.utils import checkpoint as jckpt
from byteps_tpu.utils import data as jdata
import byteps_tpu_torch as bps
from byteps_tpu_torch import callbacks as cb
from byteps_tpu_torch.launcher import dist_launcher as DL
from byteps_tpu_torch.launcher import launch as L
from byteps_tpu_torch.utils import checkpoint as ckpt
from byteps_tpu_torch.utils import data
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def initialized():
    bps.init()
    yield
    bps.shutdown()


@pytest.mark.parametrize("warmup,factor", [(10, 1 / 3), (7, 0.1), (0, 0.5)])
def test_warmup_schedule_matches_optax(warmup, factor):
    want = jcb.warmup_schedule(0.4, warmup, warmup_init_factor=factor)
    got = cb.warmup_schedule(0.4, warmup, warmup_init_factor=factor)
    after_j = jcb.warmup_schedule(0.4, warmup, optax.linear_schedule(
        0.4, 0.0, 5), warmup_init_factor=factor)
    after_t = cb.warmup_schedule(0.4, warmup, cb._linear(0.4, 0.0, 5),
                                 warmup_init_factor=factor)
    for step in range(2 * warmup + 6):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6)
        assert after_t(step) == pytest.approx(float(after_j(step)),
                                              rel=1e-6, abs=1e-7)


def test_ef_lr_scale_callback_rescales_once_per_change():
    state = {"ef": {"lr_scale": torch.ones(()), "error": torch.ones(3)}}
    sched = cb.warmup_schedule(1.0, 4, warmup_init_factor=0.5)
    call = cb.EFLRScaleCallback(sched)
    scales = []
    for step in range(7):
        state = call.on_step(step, state)
        scales.append(float(state["ef"]["lr_scale"]))
    # 0.5 -> 0.625 -> 0.75 -> 0.875 -> 1.0, then constant
    want = np.cumprod([1, 0.5 / 0.625, 0.625 / 0.75, 0.75 / 0.875,
                       0.875 / 1.0, 1, 1])
    np.testing.assert_allclose(scales, want, rtol=1e-6)
    assert torch.equal(state["ef"]["error"], torch.ones(3))


def test_metric_and_broadcast_callbacks_at_world_one(initialized):
    assert cb.MetricAverageCallback().on_epoch_end({"loss": 2.5}) == {
        "loss": 2.5}
    state = {"w": torch.ones(2)}
    assert cb.BroadcastGlobalVariablesCallback().on_train_begin(state) \
        is state
    assert cb.scaled_lr(0.1) == 0.1 and cb.scaled_lr(0.1, 8) == 0.8
    assert cb.Callback().on_epoch_end({"a": 1}) == {"a": 1}


def test_checkpoint_round_trip_and_latest_step_dir(tmp_path, initialized):
    """save -> restore with and without a template (dtype and structure
    from the template), the async saver, and latest_step_dir on one
    step-numbered layout against the JAX package's."""
    state = {"params": {"w": torch.randn(3, 4), "b": torch.zeros(4)},
             "opt": [torch.tensor(3), torch.ones(2, dtype=torch.bfloat16)]}
    ckpt.save(str(tmp_path / "1"), state)
    got = ckpt.restore(str(tmp_path / "1"))
    for a, b in zip(bps.common.tree.tree_leaves(got),
                    bps.common.tree.tree_leaves(state)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    template = {"params": {"w": torch.zeros(3, 4, dtype=torch.float64),
                           "b": torch.zeros(4)},
                "opt": [torch.tensor(0), torch.zeros(2,
                                                     dtype=torch.bfloat16)]}
    got = ckpt.restore(str(tmp_path / "1"), template)
    assert got["params"]["w"].dtype == torch.float64
    torch.testing.assert_close(got["params"]["w"].float(),
                               state["params"]["w"])
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path / "1"), {"w": torch.zeros(1)})
    saver = ckpt.AsyncSaver()
    for step in (2, 10, 9):
        saver.save(str(tmp_path / str(step)), state)
    saver.close()
    (tmp_path / "notastep").mkdir()
    assert ckpt.latest_step_dir(str(tmp_path)) == str(tmp_path / "10")
    assert jckpt.latest_step_dir(str(tmp_path)) == str(tmp_path / "10")
    assert ckpt.latest_step_dir(str(tmp_path / "missing")) is None
    assert ckpt.restore(str(tmp_path / "9"))["opt"][0] == 3


@pytest.mark.parametrize("rank,size", [(0, 1), (1, 2), (2, 4)])
def test_host_shard_matches_jax(rank, size):
    rng = np.random.RandomState(rank)
    batch = {"x": rng.randn(8, 3).astype(np.float32),
             "y": rng.randint(0, 9, size=(8,))}
    want = jdata.host_shard(batch, rank=rank, size=size)
    got = data.host_shard({k: torch.from_numpy(v) for k, v in batch.items()},
                          rank=rank, size=size)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="divisible"):
        data.host_shard((torch.zeros(6),), rank=0, size=4)


def test_prefetch_and_synthetic_batches(initialized):
    make = lambda i: (torch.full((2,), float(i)), torch.tensor([i]))
    got = list(data.prefetch_to_device(data.synthetic_batches(make, 5),
                                       size=2, device="cpu"))
    assert [int(b[1]) for b in got] == [0, 1, 2, 3, 4]
    assert torch.equal(got[3][0], torch.full((2,), 3.0))
    x = (torch.arange(4.0),)
    assert data.global_batch_from_local(x) is x
    assert torch.equal(data.shard_batch(x, device="cpu")[0], x[0])


def test_launch_worker_env_and_command():
    env = L.build_worker_env({"DMLC_NUM_WORKER": "4"})
    jenv = JL.build_worker_env({"DMLC_NUM_WORKER": "4"})
    assert env["BYTEPS_LOCAL_RANK"] == jenv["BYTEPS_LOCAL_RANK"] == "0"
    assert env["BYTEPS_LOCAL_SIZE"] == jenv["BYTEPS_LOCAL_SIZE"] == "1"
    for e in ({"BYTEPS_ENABLE_GDB": "1"}, {}):
        assert L.worker_command(["python", "t.py"], e) == \
            JL.worker_command(["python", "t.py"], e)
    for role in ("server", "scheduler", "joint"):
        with pytest.raises(NotImplementedError, match="item 6"):
            L.server_command(role)


def test_launch_worker_role_runs_command(tmp_path):
    import subprocess
    import sys
    out = tmp_path / "out.txt"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DMLC_ROLE="worker", PYTHONPATH=repo)
    # the worker and the (refused) server role side by side
    worker = subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch",
         sys.executable, "-c", f"open(r'{out}', 'w').write('ran')"],
        env=env)
    server = subprocess.Popen([sys.executable, "-m",
                               "byteps_tpu_torch.launcher.launch"],
                              env=dict(env, DMLC_ROLE="server"),
                              stderr=subprocess.DEVNULL)
    try:
        assert worker.wait(timeout=60) == 0 and out.read_text() == "ran"
        assert server.wait(timeout=60) != 0
    finally:
        for p in (worker, server):
            if p.poll() is None:
                p.kill()
                p.wait()


def test_dist_launcher_dry_run_matches_jax(tmp_path):
    """The ssh plan for three workers: the JAX launcher's worker commands
    with the package name swapped (no scheduler process: worker 0 serves
    the rendezvous), and servers refused."""
    hosts = tmp_path / "workers"
    hosts.write_text("# hosts\nw0\nw1\nw2\nw3\n")
    argv = ["--num-workers", "3", "--worker-hostfile", str(hosts),
            "--log-dir", str(tmp_path / "log"), "python", "train.py",
            "--lr", "0.1 x"]
    got = DL.launch(DL.parse_args(argv), dry_run=True)
    want = JDL.launch(JDL.parse_args(argv), dry_run=True)
    workers = [c for c in want if "DMLC_ROLE=worker" in c[-1]]
    assert len(got) == len(workers) == 3
    assert got == [[w.replace("byteps_tpu.launcher", "byteps_tpu_torch."
                              "launcher") for w in c] for c in workers]
    with pytest.raises(NotImplementedError, match="item 6"):
        DL.launch(DL.parse_args(["--num-servers", "1", *argv]), dry_run=True)
    assert isinstance(DL.parse_args(argv), argparse.Namespace)
