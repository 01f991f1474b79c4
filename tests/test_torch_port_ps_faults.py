"""Three faults of the port's PS mode against the JAX package, repaired:

  - the crash flush of the trace: with ``BYTEPS_TRACE_ON`` a worker that
    exits without ``shutdown()`` still writes ``comm.json`` (the JAX
    package's atexit guard), in PS mode and without it;
  - the order of the cast in PS mode: the pulled float32 sum is cast to
    the pushed wire dtype, decompressed, then averaged, as the JAX package
    does, so three workers under ``Compression.fp16`` get float32
    ``bf16(sum) / 3`` and a bfloat16 tensor ``bf16(bf16(sum) / 3)``;
  - the Horovod face's key plan in PS mode: ``step()`` sends every
    gradient as one ``push_pull_tree`` with the JAX package's names, so
    the port's face and the reference's send the same client->server
    frames on the ``tiny`` transformer.

Workers are subprocesses of ``tests/torch_port_ps_modes_worker.py``.
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops.compression import Compression as RCompression

from testutil import free_port
from torch_port_ps import (  # noqa: F401  (fixtures)
    RecordingProxy, port_server, run_workers, worker_env)
from torch_port_ps_modes_worker import avg_inputs


# ---------------------------------------------------------------------------
# Fault 1: the trace is flushed at exit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ps", [True, False], ids=["ps", "collective"])
def test_trace_flushed_at_exit_without_shutdown(ps, port_server, tmp_path):
    port = port_server(num_workers=1) if ps else free_port()
    run_workers("trace_exit", [("port", str(tmp_path / "unused"), worker_env(
        port, ps=ps, extra={
            "BYTEPS_TRACE_ON": 1, "BYTEPS_TRACE_START_STEP": 0,
            "BYTEPS_TRACE_END_STEP": 100,
            "BYTEPS_TRACE_DIR": tmp_path / "trace"}))])
    doc = json.loads((tmp_path / "trace" / "0" / "comm.json").read_text())
    spans = [e for e in doc["traceEvents"]
             if e["name"] == "traced.before.exit"]
    assert spans and all(e["ph"] == "X" for e in spans)


# ---------------------------------------------------------------------------
# Fault 2: cast to the wire dtype, decompress, then average
# ---------------------------------------------------------------------------
def test_ps_average_casts_before_dividing(port_server, tmp_path):
    n = 3
    port = port_server(num_workers=n)
    outs = [str(tmp_path / f"avg{w}.npz") for w in range(n)]
    run_workers("avg", [("port", out, worker_env(port, w, n))
                        for w, out in enumerate(outs)])
    xs = [avg_inputs(w) for w in range(n)]
    total = xs[0] + xs[1] + xs[2]                  # exact in float32
    # The JAX package's order (common/api.py): the session hands back the
    # sum in the pushed dtype, then decompress, then / size().
    wire, ctx = RCompression.fp16.compress(jnp.asarray(xs[0]))
    want_fp16 = np.asarray(RCompression.fp16.decompress(
        jnp.asarray(total).astype(wire.dtype), ctx) / n)
    want_bf16 = np.asarray((jnp.asarray(total).astype(jnp.bfloat16) / n
                            ).astype(jnp.float32))
    # The two orders disagree on these inputs, so the check can fail.
    bf16_of_avg = torch.from_numpy(total / np.float32(n)).to(
        torch.bfloat16).float().numpy()
    assert not np.array_equal(want_fp16, bf16_of_avg)
    assert not np.array_equal(want_bf16, bf16_of_avg)
    for out in outs:
        got = np.load(out)
        assert got["fp16"].dtype == np.float32
        np.testing.assert_array_equal(got["fp16"], want_fp16)
        assert str(got["bf16_dtype"]) == "torch.bfloat16"
        np.testing.assert_array_equal(got["bf16"], want_bf16)


# ---------------------------------------------------------------------------
# Fault 3: the face's key plan in PS mode is the JAX package's
# ---------------------------------------------------------------------------
def test_face_ps_frames_equal_reference(port_server, tmp_path):
    sides = ("ref", "port")
    proxies = {side: RecordingProxy(port) for side, port in
               zip(sides, port_server.many(2))}
    try:
        run_workers("face_sync", [
            (side, str(tmp_path / f"{side}.npz"), worker_env(
                proxies[side].port, extra={"BYTEPS_TPU_FUSION_BYTES": 4096,
                                           "BYTEPS_PARTITION_BYTES": 65536}))
            for side in sides])
        time.sleep(0.2)                # the last bytes through the pumps
        frames = {side: [f for conn in p.frames() for f in conn]
                  for side, p in proxies.items()}
    finally:
        for p in proxies.values():
            p.close()
    params = {side: np.load(tmp_path / f"{side}.npz") for side in sides}
    pushes = [f for f in frames["port"] if f[0] == 2]
    assert len({f[4] >> 16 for f in pushes}) > 1
    assert sorted(frames["port"]) == sorted(frames["ref"])
    for k in params["ref"].files:
        np.testing.assert_array_equal(params["port"][k], params["ref"][k],
                                      err_msg=k)
