"""byteps_tpu_torch's collective plane vs the JAX package's.

The bucket planner and the bucket plan of the flagship parameter tree must
be the JAX package's exactly (computed from shapes; nothing allocated);
``bucketed_tree_all_reduce`` must reproduce leaves exactly through its
``bucket_transform`` hook and put each element in the bucket JAX puts it
in; and a 2-rank gloo world must train as one process does on the same
global batch.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.common import fusion as jfusion
from byteps_tpu.models import transformer as jtfm
from byteps_tpu.ops import collectives as jcoll
from byteps_tpu_torch.common import fusion
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.models import transformer as tfm
from byteps_tpu_torch.ops import collectives
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_dist_worker.py")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("reverse", [True, False])
def test_plan_segments_matches_jax(seed, reverse):
    rng = np.random.RandomState(seed)
    sizes = [int(x) for x in rng.randint(1, 5000, size=rng.randint(1, 40))]
    cap = int(rng.randint(1, 8000))
    before = fusion.get_stats()
    got = fusion.plan_segments(sizes, cap, reverse)
    assert got == jfusion.plan_segments(sizes, cap, reverse)
    after = fusion.get_stats()
    assert after["ingraph_plans"] == before["ingraph_plans"] + 1
    assert after["ingraph_buckets"] == before["ingraph_buckets"] + len(got)


def test_flagship_bucket_plan_matches_jax():
    """The flagship tree (bert_large geometry, vocab 32768, seq 512): the
    same leaf order and sizes, hence the same 4 MiB bucket plan."""
    kw = dict(causal=True, vocab_size=32768, max_seq_len=512,
              ce_chunk_rows=2048, attn_impl="flash")
    jcfg = jtfm.get_config("bert_large", **kw)
    tcfg = tfm.get_config("bert_large", **kw)
    jshapes = jax.eval_shape(lambda: jtfm.init_params(jax.random.key(0),
                                                      jcfg))
    jsizes = tuple(int(np.prod(s.shape)) for s in jax.tree.leaves(jshapes))
    tsizes = tuple(int(np.prod(s)) for s in
                   tree_leaves(tfm.param_shapes(tcfg)))
    assert tsizes == jsizes
    assert sum(tsizes) == 336390144
    pb = 4 * 1024 * 1024
    got = collectives._plan_cache(tsizes, pb, 4, True)
    want = jcoll._plan_cache(jsizes, pb, 4, True)
    assert got.buckets == want.buckets
    assert got.num_buckets() == want.num_buckets() == 321


def _tree(rng):
    return {"b": rng.randn(7).astype(np.float32),
            "a": [rng.randn(300, 5).astype(np.float32),
                  rng.randn(0).astype(np.float32)],
            "c": {"w": rng.randn(41, 9).astype(np.float32)}}


def test_bucketed_all_reduce_transforms_match_jax():
    """Identity and scaling transforms reproduce the leaves exactly; a
    transform that scales bucket i by (i + 1) tags every element with its
    bucket, and the result equals the JAX package's."""
    tree = _tree(np.random.RandomState(0))
    ttree = {"b": torch.from_numpy(tree["b"]),
             "a": [torch.from_numpy(x) for x in tree["a"]],
             "c": {"w": torch.from_numpy(tree["c"]["w"])}}
    seen = []

    def ident(buf, i):
        seen.append((i, buf.numel()))
        return buf

    with collectives.local_mode():
        out = collectives.bucketed_tree_all_reduce(
            ttree, partition_bytes=256, bucket_transform=ident)
        doubled = collectives.bucketed_tree_all_reduce(
            ttree, partition_bytes=256,
            bucket_transform=lambda buf, i: buf * 2)
        tagged = collectives.bucketed_tree_all_reduce(
            ttree, partition_bytes=256,
            bucket_transform=lambda buf, i: buf * (i + 1))
        # No transform in local mode: the identity, the tree itself.
        assert collectives.bucketed_tree_all_reduce(ttree) is ttree
    for a, b in zip(tree_leaves(out), tree_leaves(ttree)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(doubled), tree_leaves(ttree)):
        assert torch.equal(a, b * 2)
    assert [i for i, _ in seen] == list(range(len(seen)))
    assert all(n <= 64 for _, n in seen)
    with jcoll.local_mode():
        jtagged = jcoll.bucketed_tree_all_reduce(
            jax.tree.map(jnp.asarray, tree), partition_bytes=256,
            bucket_transform=lambda buf, i: buf * (i + 1))
    for a, b in zip(tree_leaves(tagged), jax.tree.leaves(jtagged)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bucketed_all_reduce_keeps_dtypes_and_names_buckets():
    """Mixed dtypes ride a common wire dtype and come back in their own;
    each bucket runs in a ``byteps.bucket<N>`` profiler range."""
    tree = [torch.ones(10, dtype=torch.bfloat16), torch.arange(6.0)]
    with collectives.local_mode():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = collectives.bucketed_tree_all_reduce(
                tree, partition_bytes=32, bucket_transform=lambda b, i: b)
    assert [t.dtype for t in out] == [torch.bfloat16, torch.float32]
    for a, b in zip(out, tree):
        assert torch.equal(a, b)
    names = {e.key for e in prof.key_averages()}
    assert {"byteps.bucket0", "byteps.bucket1"} <= names


def test_hierarchical_reduce_in_local_mode_and_its_mesh_check():
    """Under local_mode() the hierarchical reduce returns its input as it
    is; outside it, a mesh without the two levels is refused (the gloo and
    JAX parity is tests/test_torch_port_mesh.py)."""
    tree = {"a": torch.randn(5), "b": torch.randn(3, 7, dtype=torch.bfloat16)}
    x = torch.randn(6)
    with collectives.local_mode():
        assert collectives.hierarchical_tree_all_reduce(tree) is tree
        assert collectives.hierarchical_all_reduce(x, average=True) is x

    class FlatMesh:
        mesh_dim_names = ("pp", "dp", "ep", "sp", "tp")
    with pytest.raises(ValueError, match="dcn_dp"):
        collectives.hierarchical_all_reduce(x, FlatMesh())
    with pytest.raises(ValueError, match="ici_dp"):
        collectives.hierarchical_tree_all_reduce(tree, FlatMesh())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_worlds(*worlds):
    """Each ``(world, out)``'s ranks, all worlds at once; the npz files."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for world, out in worlds:
        port = _free_port()
        procs += [subprocess.Popen([sys.executable, WORKER, str(r),
                                    str(world), str(port), str(out)],
                                   env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for r in range(world)]
    try:
        logs = [p.communicate(timeout=50)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [np.load(out) for _, out in worlds]


def test_two_rank_gloo_step_equals_single_process(tmp_path):
    """Two gloo ranks, each on half the global batch, reduce gradients in
    buckets and end where one process on the whole batch ends."""
    dist, single = _run_worlds((2, tmp_path / "dist.npz"),
                               (1, tmp_path / "single.npz"))
    np.testing.assert_allclose(dist["losses"], single["losses"], rtol=1e-5)
    keys = [k for k in single.files if k.startswith("p")]
    assert keys and set(keys) == {k for k in dist.files if k.startswith("p")}
    for k in keys:
        diff = np.linalg.norm(dist[k] - single[k])
        assert diff <= 1e-5 * np.linalg.norm(single[k]) + 1e-7, k
