#!/usr/bin/env python3
"""Smoke run of byteps_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which must pass:

1. Build the package's CUDA kernels from ``byteps_tpu_torch/csrc/`` (one
   nvcc per source, all started together; sm_90a) and print the toolchain
   and each kernel's ptxas report (no tensor-core kernel may spill).
   Count the HMMA (tensor-core MMA) instructions of each flash kernel in
   the library's SASS (cuobjdump): every bf16 and float16 instantiation of
   the two forward and four backward kernels, at every head dim (16, 32,
   64, 128, 256) and of the wide kernels (D above 256), must have them, and
   so must every float32 kernel, 3xTF32: the 8 forward and 16 backward
   instantiations at D = 16-128 (one CTA a tile), the only float32
   instantiations the library holds, and the two wide forward and four
   wide backward kernels (clusters), which also run D = 256.  The bf16
   and float16 forward and backward above D = 256 run as split-D clusters
   too (flash_fwd{,_str}_wide16_kernel<bf16|f16> and
   flash_bwd_{dq,dkv}{,_str}_wide16_kernel<bf16|f16>, with the backward's
   <bf16|f16,multi> instances for more slices than CTAs).  The float32
   tensor-core kernels and the 16-bit wide forward and backward must spill
   nothing; their ptxas registers and the cluster sizes at each head dim
   are printed.
2. Hold each flash kernel against its plain PyTorch version on the card:
   the flagship attention shape [8*16, 512, 64] bf16, causal and not, and
   a small float32 shape through the autograd op with block_q != block_k.
   Time kernel, plain version and, as yardsticks only, PyTorch's
   scaled_dot_product_attention forward (and the forward kernel's ratio
   to it) and its backward (dQ, dK and dV in one call, set beside the sum
   of the two backward kernels, and their ratio); each kernel's TFLOP/s
   (bound_ms's FLOPs over its time), and the forward's TFLOP/s of the
   tensor-core work it issues (P enters P V as a hi/lo pair).  Every
   element is held to |kernel - plain| <= rtol |plain| + atol: one bf16
   step (2^-7) for bf16 outputs, 1e-4 for float32 ones, 1e-5 for LSE and
   delta, with an atol three orders below a typical element.
2s. The streaming flash kernels against their plain versions on the card,
   elementwise as in phase 2, at the long shape [16, 32768, 64] bf16,
   causal (8 splits of 4,096 keys), each run twice and the two results
   compared bit for bit; a non-causal bf16 shape [16, 8192, 64]; and a
   float32 shape [2, 16384, 64] through the autograd op with
   streaming=True, block_q != block_k and 4 splits.  Timed at the long
   shape: kernel (and its TFLOP/s, for the forward also of its MMA work),
   plain version and, as yardsticks, SDPA forward and backward (and the
   forward's and the backward pair's ratios to them) and the
   resident kernels forced with streaming=False.  Then
   [16, 131072, 64] bf16 causal (8 splits of 16,384): peak memory of the
   three calls against their outputs plus the dK/dV workspaces, and the
   rows that depend only on the first (or last) 8,192 positions against
   the plain versions.
2b. The sign-bit kernels against their plain versions, bit for bit, at
   n = 1,048,576 (the flagship's bucket), 845,824 (its ragged bucket),
   4096*33, 5000, 100 and 1, on inputs with +-0.0, +-inf and NaNs of both
   signs, sign_unpack on 1 and 2 rows; timed at n = 1,048,576, sign_unpack
   also on 2 rows, beside the byte bound and two floors: PyTorch's fill_ of
   the same output and of one float.
2c. Onebit and dithering (s = 127 and 15) on one flagship-size bucket:
   the CUDA run (kernels) against the same compressor on a CPU copy (plain
   versions) from the same state, two rounds: words and levels
   bit-identical, floats within 1e-6 relative.
3. Small-input reference: the tiny transformer's loss and gradients with
   flash attention (the kernels) against dense attention, on the card.
4. The main path: the flagship configuration (bert_large geometry, causal,
   vocab 32768, seq 512, batch 8, bf16 over f32 masters, per-layer remat,
   streamed LM head, flash attention) trained for 5 steps with
   DistributedOptimizer(AdamW) + build_train_step.  Every loss must be
   finite, the last below the first, and each step must launch flash_fwd
   48 times and flash_bwd_dq / flash_bwd_dkv 24 times each.  One more
   step then runs under torch.profiler for the device-time breakdown.
4b. The compressed main path: the same flagship under
   DistributedOptimizer(AdamW, inter_compressor=onebit + EF + Nesterov)
   for 5 steps.  First, on the first step's gradients, the compressed
   reduction on the card against the same reduction on a CPU copy: every
   bucket's sign words equal, reduced values within 1e-6 relative.  Then
   finite, falling losses; exactly 642 sign_pack and 1,284 sign_unpack
   launches per step (2 and 4 for each of the 321 buckets) with the flash
   launches still 48/24/24; step time, peak memory and a profiled step.
5. The long-context path: llama_300m (24 layers, d_model 1024, 16 heads,
   4 kv heads, head_dim 64, d_ff 2816, vocab 32768, RMSNorm, SwiGLU,
   RoPE) at seq 32,768, batch 1, causal, bf16 over f32 masters, per-layer
   remat, streamed LM head, flash attention, which the selection rule
   sends to the streaming family: 3 steps of DistributedOptimizer(AdamW) +
   build_train_step with finite, falling losses and exactly 48
   flash_fwd_str and 24 flash_bwd_dq_str / flash_bwd_dkv_str launches per
   step (resident 0; the flagship phases show the reverse), then a
   profiled step.
6. Ulysses at world 1: make_ulysses_attn_fn(attn="flash") forward and
   backward on [1, 16, 32768, 64] bf16 launches each streaming kernel once
   and no resident kernel, and equals the streaming forward called
   directly, bit for bit.
7. Coverage (this slice's path): a non-strict flash_attention_fn forward
   and backward on the card at [8, 16, 512, D] causal for D = 8, 24, 40,
   48, 56, 80, 96, 112 and 256 (zero-padded to an instantiated head dim),
   bf16 and float32, in both families (streaming with the resident budget
   at 0); float16 at D = 64 and 128 there and at [1, 16, 32768, 64]; and
   B*H = 65,600 at S = 64, D = 16 (two launches of each kernel), with
   four seeds.  Each case launches its family's kernels, no plain version,
   and holds O, dQ, dK and dV to the elementwise gates against the plain
   versions: float16 to its own step (2^-10 |plain| + 1e-5), which a
   control (the inputs rounded to bf16 through the bf16 kernels) must
   miss; float32 to 1e-4 |plain| + 1e-5; 16-bit cases also print the most
   rounding steps apart where the gate's relative term rules.
8. Three training steps of a 2-layer transformer at bert_base width with
   8 heads of 96 (padded to 128), seq 512, batch 8, in bf16 and then in
   float16: finite, falling losses, 4/2/2 resident launches a step.
9. The new instantiations <bf16, 256> and <f16, 64> of each flash kernel
   against their plain versions and timed, the resident ones at the
   flagship shape, the streaming ones at the long shape, beside SDPA's
   forward and backward there.  Each must have been launched by phases 7-8.
10. Head dims above 256 (the wide kernels): flash_attention_fn forward and
   backward at [8, 16, 512, D] for D = 264, 384 and 512 and at
   [1, 4, 512, D] for D = 1024 and 1152 (9 slices: 5 CTAs of two, the
   backward's multi-slice instances), float32, bf16 and float16, each in
   both families,
   held to the plain versions as in phase 7 (float16 with its bf16
   control), the float32 forward's launches by instantiation one a case of
   its family (printed with the cluster size: 3 CTAs at D = 264 and 384, 4
   at 512, 8 at 1024), and so must the bf16 and float16 forward's (the
   split-D cluster kernels, the library's only 16-bit forward above
   D = 256), printed with their cluster size (3, 4 and 8 CTAs at
   D = 384, 512 and 1024), ptxas registers and spills, HMMA count and the
   clusters the card holds at once (cudaOccupancyMaxActiveClusters); the
   same for the bf16 and float16 backward's (dQ and dK/dV, resident and
   streaming: the split-D cluster kernels, their launches by
   instantiation one a case of their family, and the clusters of dQ and
   of dK/dV held at once); then
   each kernel at D = 384 and 512 in the three dtypes
   against its plain version and timed (resident at [128, 512, D],
   streaming at [16, 8192, D]) beside its bound (float32's at the 3xTF32
   ceiling of 165 TFLOP/s, the bound at 67 outside the tensor cores
   printed beside it), its TFLOP/s and SDPA's
   forward and backward, naming the SDPA backend that ran.  Every timed
   instantiation must have been launched by the coverage run.  Then the
   float32 instantiations <f32,64>, <f32,128> and <f32,256> timed the same
   way, at the flagship shape and at [16, 8192, D], beside SDPA (launched
   by phase 7), with the float32 forward's and backward's cluster size,
   each of their kernels' ptxas registers, spills and HMMA count at those
   head dims, and the forward's times beside its bound and SDPA's: no
   spills, HMMA in each, a cluster of 1 CTA up to D = 128 and 2 at 256, and
   every float32 launch of phase 7 at those head dims counted by
   instantiation (phase 1's census leaves the library no other float32
   kernel for them to reach).
11. ResNet-50 (224 x 224 x 3, 1000 classes, float32, batch 64, one fixed
   synthetic batch, cuDNN deterministic, no TF32): 5 steps of SGD (lr 0.1,
   momentum 0.9) through DistributedOptimizer + build_train_step with
   cnn_loss_fn (finite, falling losses; step ms, images/s, peak memory; a
   profiled step), then the same weights through the Horovod face
   (broadcast_parameters, DistributedOptimizer, broadcast_optimizer_state,
   zero_grad/backward/step): 161 push_pull_async handles a step, all
   synchronized before the inner step, and parameters within relative L2
   1e-5 of the functional path's.
12. The eager API on CUDA tensors: push_pull, push_pull_async + poll +
   synchronize, and push_pull_tree over ResNet-50's gradients, its bucket
   count equal to the fusion planner's plan.
13. The flagship for 3 steps under each remat policy ("none", "proj",
   "dots", "dots_no_batch"): flash launches 48/24/24 a step under every
   policy, losses equal across policies, step ms and peak memory each.
14. The two-level mesh and the cross-barrier drivers on the card.
   14b: CrossBarrierDriver around phase 4's flagship step, max_in_flight
   1 and 2, 8 steps each after a warm-up step from the same weights: the
   losses within 1e-6 relative of a plain loop's (bit-equality printed),
   flash launches 48/24/24 a step, step ms and the device's idle share of
   each setting (no claim).  14c: the native examples
   (byteps_tpu_torch.examples) on the card: train_mnist's accuracy above
   chance, train_mnist_fp16's falling loss under
   HalfPrecisionDistributedOptimizer, benchmark_cross_barrier's two rates
   and its CrossBarrier and DistributedOptimizer params within 1e-5
   relative.  14a, last, so that no earlier phase sees a process group: a
   world-of-one NCCL group (file:// rendezvous in a temporary directory),
   make_hierarchical_mesh(1) on CUDA, the flagship's gradient tree through
   hierarchical_tree_all_reduce over NCCL (NCCL kernels counted), equal
   bit for bit to bucketed_tree_all_reduce under local_mode() and in as
   many buckets as the plan; then 5 flagship steps under
   DistributedOptimizer(hierarchical=True) outside local_mode(): finite,
   falling losses, flash launches 48/24/24 a step, step ms and idle share
   beside phase 4's; the group destroyed at the end.
15. Parallelism beyond DP, after 14a, on a world-of-one group (NCCL for
   CUDA tensors, gloo for CPU ones; file:// rendezvous): every mesh axis
   is 1 on one card, so gpipe_spmd, the all-to-alls and the TP
   collectives are identities here and their parity across ranks is the
   CPU tests'.  15a: the flagship of phase 4 (its params and batch)
   through build_sharded_train_step on make_mesh() three ways (the
   Megatron param_specs, zero1=True, fsdp_param_specs over them), 5
   AdamW steps each: losses within 1e-3 relative of phase 4's (the
   largest gap and bit-equality printed), flash launches 48/24/24 a step
   (the kernels under DTensor, through local_map), step ms, idle share
   and peak memory beside phase 4's.  15b: the hybrid transformer at the
   flagship's width (24 layers, d_model 1024, 16 heads, d_ff 4096, vocab
   32768, seq 512, float32, batch 8), 3 AdamW steps (finite, falling
   losses; step ms, idle share, peak), then a 2-layer cut at batch 1, one
   step on the card and on the CPU from the same params and tokens: loss
   within 1e-4 relative, each gradient within 1e-4 relative L2, TF32 off.
   15c: Switch-MoE at the same width, 4 layers, 8 experts, capacity
   factor 2, aux weight 0.01, 3 steps: finite, falling losses, a nonzero
   gate_w gradient, the tokens dropped past capacity and the step ms.
16. Sequence parallelism and the example/jax/* counterparts.  16a, on
   the world-of-one group of phase 15: llama_300m at seq 32,768, batch 1,
   bf16 (phase 5's config, params and batch from the same seeds), one
   forward and backward through make_ulysses_attn_fn(the mesh's sp group,
   attn="flash"), the adaptor's block 0 of 1: loss within 1e-6 and every
   gradient within 1e-5 relative L2 of the unsharded forward and
   backward (bit-equality printed), exactly 48/24/24 streaming launches,
   both passes' ms and peak memory; then ring over the same group at seq
   4,096 in float32, the final hidden states within 1e-4 relative L2 of
   the unsharded forward with flash and with dense attention.  16b: the
   seven native counterparts of example/jax/* through main() with the
   JAX scripts' defaults, except train_llama at llama_300m width
   (--attn flash --seq-len 512 --batch-size 8 --steps 3, then also
   --fsdp) and train_long_context's ring over sp = 1 (and its flash
   branch); each one's lines, seconds and launches (counters set to 0
   just before each and read just after): train_llama's must include
   rows 1-3, train_compressed's (onebit) rows 7-8; losses finite and
   falling, the benchmark's rates positive, elastic_benchmark's keys 0
   and 1 after resume.
17. The worker-local observability planes on phase 4's flagship.  17a:
   BYTEPS_TPU_DEVPROF=1 with BYTEPS_TPU_DEVICE_PLATFORM=gpu, a 0.5 s
   signal window, the metrics endpoint on a free port and its JSONL log,
   a two-step trace window and postmortem bundles, all in a temporary
   directory; at least 6 steps (until two windows have closed and the
   last carries an MFU), counters set to 0 just before: the device
   profile says gpu, no fallback, every step run either timed or counted
   (the first, under the FLOP counter), an MFU in (0, 1), the counted
   FLOPs within 10% of the model's analytic count (flagship_flops); a
   scrape of /metrics carries bps_mfu and bps_device_step_ms, /diagnosis
   has no open device_fallback, comm.json has device-lane events (pid
   >= 20000), a capture() of one more step names the three flash
   kernels, 48/24/24 launches every step; then the same steps unarmed
   from the same seeds: losses and parameters bit-equal; step ms armed
   and unarmed, the idle share (the capture's device time) and the MFU
   printed.  17b: BYTEPS_TPU_DEVICE_PLATFORM=tpu, one window roll opens a
   CRITICAL device_fallback, and a bundle dumped then carries the device
   and diagnosis sections.
18. The base of the PS worker plane (host code; no kernel).  18a: the
   native host core, built with the machine's g++ from
   byteps_tpu_torch/core/{core,server}.cc (byte-identical copies of the
   JAX package's) in a thread started before phase 1, beside the CUDA
   builds: the g++ version, the build's seconds and the library's path,
   and get_native_core() a _CCore.  The flagship's parameter names in
   phase 4's order, then its 321 gradient buckets, declared on the native
   core and on the Python Core: equal keys, partition bounds of each
   bucket at 4 MiB, key_to_server under djb2, sdbm, mixed and naive at 1,
   2, 4 and 8 servers, and the order a ScheduledQueue with a credit of 4
   partitions gives out every bucket partition at its bucket's priority.
   18b: every partition key on a 4-server ring of 64 virtual nodes:
   RingTable.owner equal to the library's bps_ring_owner; a fifth server
   moves keys only to itself.  18c: one forward and backward of phase 4's
   flagship at full width and depth; its float32 gradient buckets as
   phase 4b forms them (321, 1.3 GB) copied to the host once (ms printed);
   then, for onebit (scaled, EF, momentum 0.9; two rounds), topk and
   randomk (1% of each bucket), dithering s = 15 dense and elias, and
   qblock 8 and 4 bits in blocks of 256, every bucket encoded and then
   decoded through a CompressionPool of 4 threads (queued in a shuffled
   order while its threads are held; the order it takes them must be
   priority desc, key asc) and copied back to the card: the C codec in
   use, every payload within wire_cap_bytes, onebit's decodes +-scale and
   its EF residuals exactly the corrected input less the decode, the
   numpy codec's bytes, EF and momentum state and decode equal the C
   codec's on three buckets (a full one, the ragged one, the middle one),
   and a truncated payload raising ValueError; encode, decode and
   copy-back ms a step's gradients and wire/raw bytes printed with the
   card's name and power limit.  18d: python -m byteps_tpu_torch.server
   on a free port accepts a TCP connection within 30 s and maps the
   port's library; then it is terminated.
19. PS-mode training on the card (BYTEPS_TPU_PS_MODE=1).  19a: the port's
   server started through the launcher's server role, then two worker
   processes (DMLC_NUM_WORKER=2, ids 0 and 1, this script with
   --ps-worker), both on cuda:0: each builds phase 4's flagship from the
   same parameters with its own batch (seeds 1 and 2) and takes 3 AdamW
   steps through the Horovod face's DistributedOptimizer, its gradients
   summed by the server.  Each saves its float32 local gradients of the
   first step (to a temporary directory, deleted after), worker 0 the
   averages it pulled and worker 1 their SHA-256: every pulled element
   must equal (g0 + g1) / 2 bit for bit;
   the two workers' parameters after step 3 bit-equal; the losses finite
   and within 1e-3 relative of a one-process control here that averages
   the two batches' gradients itself; 48/24/24 flash launches a step on
   each worker.  Step ms (median of steps 2-3) beside phase 4's, the
   staging copies' ms to and from the host, the bytes on the lanes and at
   the server a step, and the server's rounds are printed.  19b: the same
   two workers with onebit (phase 18c's kwargs) registered on the PS wire
   for every gradient of at least BYTEPS_MIN_COMPRESS_BYTES: finite
   losses, bit-equal parameters, the compressed keys' wire/raw at the
   server within 2% of phase 18c's 0.031252; step ms and host encode ms.
   19c (run beside 19a's checks, which are not timed): DMLC_ROLE=joint
   python -m byteps_tpu_torch.launcher.launch python <a 2-step tiny PS
   script> exits 0 and its server is gone after.  The face's PS step sends
   every gradient as one push_pull_tree (the JAX package's key plan).
20. The PS training modes on the card: two servers through the launcher
   (A with BYTEPS_ENABLE_ASYNC=1, B synchronous) and two worker processes
   on cuda:0 (this script with --ps-modes-worker), each with phase 4's
   flagship from the same parameters and its own batch.  20a, async on A:
   3 steps of the Horovod face's DistributedOptimizer(AdamW,
   enable_async=True), then 2 pipelined steps of AsyncPSTrainer over the
   same tree under other keys (its local step AdamW): finite losses,
   48/24/24 flash launches a step; after each part both workers drain,
   meet at a barrier and pull the stores: bit-equal weights on both; the
   final weights within (additions / 2) float32 ulps of |seed| + the sum
   of |deltas| of the seed plus every delta either worker pushed, summed
   in float64 (10 additions: 2 workers x 5 steps).  20b, ServerOptTrainer
   on B over the flagship's 336,390,144 parameters as one tree, Adam lr
   1e-4, grad_scale 1/2, each worker's phase 4 gradients: 3 rounds in
   server mode and 3 in local mode (the step on the card): the parameters
   of the two modes bit-equal after each round, on both workers; step ms,
   opt_state_bytes of each mode and the server's opt_slot_bytes printed.
   20c, EmbeddingTable on B: 10,000,000 x 64 float32 rows (zero-initial),
   server-side Adagrad lr 0.01; 3 rounds in which each worker looks up
   100,000 Zipf-skewed ids (a = 1.05, duplicates included), runs a
   dot-product logistic model on the card (summed loss) and pushes the
   row gradients:
   the pulled rows bit-equal a float32 replay of the server's Adagrad
   (worker 0 replays both workers' pushes), the wire bytes a round within
   5% of the touched rows' (rows and indices, both legs, plus headers), a
   warm lookup sends no frame; rows/s of push_pull and lookup printed.

Prints a ``{"kernels": [...]}`` line (each entry also naming the CUDA
kernels it launches, ``cuda_kernels``), the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
without that line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# float32-accurate products on the tensor cores: 3xTF32, three TF32 MMAs
# (495 TFLOP/s dense) for each product, the least a float32 kernel can take
TF32X3_FLOPS_PER_S = 495e12 / 3

FLASH_SOURCE = "byteps_tpu_torch/csrc/flash_attention.cu"
BITPACK_SOURCE = "byteps_tpu_torch/csrc/bitpack.cu"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "flash_fwd": (FLASH_SOURCE, "byteps_tpu/ops/flash_attention.py:142"),
    "flash_bwd_dq": (FLASH_SOURCE, "byteps_tpu/ops/flash_attention.py:168"),
    "flash_bwd_dkv": (FLASH_SOURCE, "byteps_tpu/ops/flash_attention.py:192"),
    "flash_fwd_str": (FLASH_SOURCE, "byteps_tpu/ops/flash_attention.py:221"),
    "flash_bwd_dq_str": (FLASH_SOURCE,
                         "byteps_tpu/ops/flash_attention.py:250"),
    "flash_bwd_dkv_str": (FLASH_SOURCE,
                          "byteps_tpu/ops/flash_attention.py:275"),
    "sign_pack": (BITPACK_SOURCE, "byteps_tpu/ops/compressor/bitpack.py:83"),
    "sign_unpack": (BITPACK_SOURCE,
                    "byteps_tpu/ops/compressor/bitpack.py:95"),
}
FLAGSHIP = dict(batch=8, heads=16, seq=512, head_dim=64)
STEPS = 5
LONG = dict(batch=1, heads=16, seq=32768, head_dim=64)   # llama_300m
LONG_STEPS = 3
RESIDENT = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
STREAMING = ("flash_fwd_str", "flash_bwd_dq_str", "flash_bwd_dkv_str")
BUCKET = 1048576              # elements of the flagship's 4 MiB buckets
RAGGED_BUCKET = 845824        # its one smaller bucket
COMPRESSOR = {"compressor": "onebit", "ef": "vanilla", "momentum": "nesterov"}
FLAGSHIP_BUCKETS = 321
# Head dims the JAX adapter runs flash at that the kernels pad (all of them
# multiples of 8 up to 256, 256 itself instantiated).
COVER_DIMS = (8, 24, 40, 48, 56, 80, 96, 112, 256)
# bert_base width with 8 heads of 96, cut to 2 layers.
HD96 = dict(batch=8, seq=512, d_model=768, heads=8, layers=2, d_ff=3072)
HD96_STEPS = 3
# New instantiations timed at the flagship and long shapes.
NEW_INSTANCES = (("bf16", 256), ("f16", 64))
# Head dims above 256 (the wide kernels, D padded to a multiple of 128):
# covered at the flagship's [8, 16, 512, D], D = 1024 and 1152 at
# [1, 4, 512, D]; timed at D = 384 and 512, the streaming family at
# WIDE_LONG.
WIDE_DIMS = (264, 384, 512)
WIDE_TIMED = (384, 512)
WIDE_LONG = dict(batch=1, heads=16, seq=8192)
# The float32 wide kernels, clusters on the tensor cores in 3xTF32 (their
# SASS labels); the float32 instantiations at D <= 256 timed in phase 10.
F32_WIDE_FWD = ("flash_fwd_wide_kernel<f32>",
                "flash_fwd_str_wide_kernel<f32>")
F32_WIDE_BWD = ("flash_bwd_dq_wide_kernel<f32>",
                "flash_bwd_dq_str_wide_kernel<f32>",
                "flash_bwd_dkv_wide_kernel<f32>",
                "flash_bwd_dkv_str_wide_kernel<f32>")
F32_WIDE = F32_WIDE_FWD + F32_WIDE_BWD
# The bf16 and float16 forward and backward above D = 256: split-D
# clusters of split_ctas(D) CTAs (their SASS labels; the backward's
# ",multi" instances run D above 1024, more slices than CTAs), and that
# size at some D.
WIDE16_FWD = tuple(f"flash_fwd{k}_wide16_kernel<{t}>"
                   for k in ("", "_str") for t in ("bf16", "f16"))
WIDE16_BWD = tuple(f"flash_bwd_{f}{k}_wide16_kernel<{t}{m}>"
                   for f in ("dq", "dkv") for k in ("", "_str")
                   for t in ("bf16", "f16") for m in ("", ",multi"))
WIDE16_CLUSTER = {384: 3, 512: 4, 1024: 8}
# The float32 forward and backward at D <= 128: one CTA a tile, 3xTF32.
F32_TC_DIMS = (16, 32, 64, 128)
F32_TC_FWD = tuple(f"flash_fwd{k}_tc_kernel<f32,{d}>"
                   for k in ("", "_str") for d in F32_TC_DIMS)
F32_TC_BWD = tuple(f"flash_bwd_{k}_tc_kernel<f32,{d}>"
                   for k in ("dq", "dq_str", "dkv", "dkv_str")
                   for d in F32_TC_DIMS)
F32_INSTANCES = (64, 128, 256)
# bench.py's CNN row: ResNet-50, 224 x 224 x 3, 1000 classes, float32,
# batch 64, SGD lr 0.1 momentum 0.9, 5 steps on one fixed batch.
CNN = dict(name="resnet50", image=224, classes=1000, batch=64, lr=0.1,
           momentum=0.9, steps=5)
RESNET50_PARAMS = 161
REMAT_POLICIES = ("none", "proj", "dots", "dots_no_batch")
REMAT_STEPS = 3
DRIVER_STEPS = 8
# Phase 17: a signal window short enough that several close during the
# armed flagship steps (150-330 ms each), and the step count's range.
OBS_WINDOW_S = 0.5
OBS_MIN_STEPS = 6
OBS_MAX_STEPS = 40
# Phase 18: the PS wire configurations (name, kwargs, rounds: the stateful
# one runs two, so that EF and momentum carry over; topk and randomk keep
# 1% of each bucket), the codec pool's threads, the sampled buckets the
# numpy codec is held to, the placement hashes and server counts, the ring
# and the queue's credit (4 partitions of 4 MiB).
PS_WIRE_CONFIGS = (
    ("onebit", {"compressor": "onebit", "ef": "vanilla",
                "momentum": "nesterov", "momentum_mu": "0.9"}, 2),
    ("topk", {"compressor": "topk"}, 1),
    ("randomk", {"compressor": "randomk"}, 1),
    ("dithering", {"compressor": "dithering", "k": "15"}, 1),
    ("dithering_elias", {"compressor": "dithering", "k": "15",
                         "coding": "elias"}, 1),
    ("qblock8", {"compressor": "qblock", "bits": "8", "block": "256"}, 1),
    ("qblock4", {"compressor": "qblock", "bits": "4", "block": "256"}, 1),
)
PS_POOL_THREADS = 4
PS_SAMPLED = 3
PS_HASHES = ("djb2", "sdbm", "mixed", "naive")
PS_SERVERS = (1, 2, 4, 8)
PS_RING = dict(servers=4, vnodes=64)
PS_QUEUE_CREDIT = 4 * 4 * 1024 * 1024
PS_TRAIN_STEPS = 3
PS_WORKERS = 2
PS_ONEBIT_RATIO = 0.031252    # phase 18c's onebit wire/raw (measured on one H100)
PS_ASYNC_STEPS = (3, 2)       # 20a: face steps, then AsyncPSTrainer steps
PS_OPT_ROUNDS = 3             # 20b: rounds in each mode
PS_OPT = {"opt": "adam", "lr": 1e-4}
PS_EMBED = dict(rows=10_000_000, width=64, ids=100_000, zipf=1.05, rounds=3,
                opt={"opt": "adagrad", "lr": 0.01})


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=120).stdout.strip()


def time_ms(fn, reps=20, rounds=5):
    """Median over rounds of the mean time per call (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def time_graph_ms(fn, reps=50, rounds=5):
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed; median over rounds.  Leaves out the host's launch overhead,
    which ``time_ms`` includes when a call is shorter than its launch."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def max_err(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def rel_err(a, b):
    return max_err(a, b) / (float(b.detach().float().abs().max()) + 1e-12)


# Elementwise gates |kernel - plain| <= rtol * |plain| + atol.  A bf16
# output may differ from the plain version's by one bf16 step, at most
# 2^-7 of its value; atol only covers values near zero, three orders below
# a typical |O| or gradient element at row 32,768 (about 0.01).
BF16_GATE = (2 ** -7, 1e-5)
# float16's own step, 8x finer: a float16 kernel that rounded its inputs or
# its P/dS pair to bf16 would miss it (phase 7 reads such a control).
FP16_GATE = (2 ** -10, 1e-5)
F32_GATE = (1e-4, 1e-5)           # float32 outputs (O, dQ, dK, dV)
ROWS_GATE = (1e-5, 1e-6)          # LSE and delta, float32 in every dtype


def steps_apart(got, want, tol):
    """The most rounding steps of the output dtype (bf16 or float16, at the
    plain value's binade) between a kernel's output and the plain
    version's, over the elements where the gate's relative term is the
    larger (rtol |plain| >= atol).  Two roundings of nearly equal values
    one step apart just above a power of two read close to 1 on the gate;
    2 steps or more would be a fault."""
    import torch
    rtol, atol = tol
    mant = 7 if want.dtype == torch.bfloat16 else 10
    g, w = got.detach().float(), want.detach().float()
    big = w.abs() * rtol >= atol
    if not bool(big.any()):
        return 0.0
    step = torch.exp2(torch.floor(torch.log2(w[big].abs())) - mant)
    return float(((g[big] - w[big]).abs() / step).max())


def gate(got, want, tol):
    """(every element within rtol * |want| + atol, the worst element's
    error over its limit)."""
    rtol, atol = tol
    g, w = got.detach().float(), want.detach().float()
    worst = float(((g - w).abs() / (w.abs() * rtol + atol)).max())
    return worst <= 1.0, worst


def gates(pairs, check, what):
    """``pairs``: (name, got, want, tol).  One check over all of them,
    printing each tensor's worst error/limit ratio (<= 1 passes)."""
    res = {name: gate(got, want, tol) for name, got, want, tol in pairs}
    check(all(ok for ok, _ in res.values()),
          f"{what}: worst |err| / (rtol |plain| + atol) " + ", ".join(
              f"{n} {w:.3g}" for n, (_, w) in res.items()) + " (<= 1)")


class Checks:
    def __init__(self):
        self.failures = []

    def __call__(self, ok, what):
        print(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failures.append(what)


def work(name, bh, s, d, itemsize, causal):
    """(bytes, FLOPs) of one call: each input read and each output written
    once; the products' FLOPs, counting only the visible logits under
    causal masking."""
    n = bh * s * d
    rows = bh * s * 4                      # one float32 per row (lse/delta)
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    name = name.removesuffix("_str")       # the streaming family: the same
    if name == "flash_fwd":                # q,k,v -> o, lse
        return 4 * n * itemsize + rows, 4 * pairs * d
    if name == "flash_bwd_dq":             # q,k,v,o,dO,lse -> dq, delta
        return 6 * n * itemsize + 2 * rows, 6 * pairs * d
    return 6 * n * itemsize + 2 * rows, 8 * pairs * d  # -> dk, dv


def tflops(name, bh, s, d, causal, ms):
    """The function's FLOPs (as in bound_ms) over the measured time."""
    return work(name, bh, s, d, 2, causal)[1] / (ms * 1e-3) / 1e12


# Tensor-core FLOPs the bf16 forward issues per FLOP of the function: Q K^T
# once (2 per pair and head-dim element), P V twice, P as its hi/lo pair
# (4), against the function's 2 + 2.
FWD_MMA_PER_FLOP = 6 / 4


def fwd_report(name, ms, lib_ms, bh, s, d):
    """The forward kernel's TFLOP/s of the function's work and of the MMA
    work it issues, and its time over SDPA's forward; printed and
    returned for the metrics line."""
    rate = tflops(name, bh, s, d, True, ms)
    res = {"tflops": rate, "mma_tflops": rate * FWD_MMA_PER_FLOP,
           "over_sdpa": ms / lib_ms}
    print(f"  {name}: {res['tflops']:.2f} TFLOP/s of the function's work, "
          f"{res['mma_tflops']:.2f} of MMA work; {res['over_sdpa']:.2f}x "
          f"SDPA's forward ({lib_ms:.4f} ms)")
    return res


def bound_ms(name, bh, s, d, itemsize, causal,
             f32_peak=TF32X3_FLOPS_PER_S):
    """Least time for the work: its bytes over HBM bandwidth or its FLOPs
    over the peak for the inputs' type, the larger: the bf16/float16
    tensor cores, or for float32 the 3xTF32 ceiling (any float32 product
    can run so on this card; ``f32_peak=F32_FLOPS_PER_S`` gives the bound
    outside the tensor cores)."""
    nbytes, flops = work(name, bh, s, d, itemsize, causal)
    peak = f32_peak if itemsize == 4 else BF16_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_build(mods, build_mod, torch, gpu, check):
    """One nvcc per source, all started together, then load each; the
    ptxas reports and the flash library's HMMA census (``mods[0]`` is the
    flash module).  Returns the flash library's ptxas reports by kernel
    (empty when an earlier run built it) and its HMMA counts."""
    import re
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda m: build_mod.build(m.SOURCE), mods))
    for m in mods:
        m.build()
    secs = time.perf_counter() - t0
    nvcc = sh([build_mod.nvcc_path(), "--version"]).splitlines()
    release = next((l for l in nvcc if "release" in l), "")
    print(f"toolchain: torch {torch.__version__} cuda {torch.version.cuda} "
          f"| nvcc: {nvcc[0] if nvcc else '?'} | {release} "
          f"| build {secs:.1f} s | {gpu}")
    mma = []
    f32 = dict(ptxas_reports(build_mod.build_logs.get(mods[0].SOURCE, "")))
    for m in mods:
        for kernel, report in ptxas_reports(build_mod.build_logs.get(
                m.SOURCE, "")):
            print(f"  ptxas {m.SOURCE} {kernel}: {report}")
            if "_mma_kernel" in kernel:
                mma.append(report)
    if mma:       # no report when the library was built by an earlier run
        # 6 kernels, bf16 and f16, at each head dim
        want = 6 * len(mods[0].HEAD_DIMS) * 2
        check(len(mma) == want and all(
            re.search(r"\b0 bytes spill stores", r) for r in mma),
              f"ptxas: no spills in the {len(mma)} tensor-core kernels "
              f"(want {want})")
        for what, names in (("float32 wide forward", F32_WIDE_FWD),
                            ("float32 wide backward", F32_WIDE_BWD),
                            ("float32 forward (D <= 128)", F32_TC_FWD),
                            ("float32 backward (D <= 128)", F32_TC_BWD),
                            ("bf16 and float16 wide forward", WIDE16_FWD),
                            ("bf16 and float16 wide backward", WIDE16_BWD)):
            check(all(re.search(r"\b0 bytes spill stores", f32.get(k, ""))
                      for k in names),
                  f"ptxas: no spills in the {len(names)} {what} "
                  f"kernels: " + "; ".join(
                      f"{k} {f32.get(k, 'not built')}" for k in names))
    lib = mods[0]._lib()
    dims = (16, 32, 64, 128, 256, 384, 512, 640, 768, 896, 1024, 1152)
    print("  float32 cluster (CTAs, forward and backward) by head dim: "
          + ", ".join(f"D {d}: {lib.bps_flash_f32_cluster(d)}"
                      for d in dims))
    print("  bf16 and float16 forward cluster (CTAs) by head dim: "
          + ", ".join(f"D {d}: {lib.bps_flash_fwd16_cluster(d)}"
                      for d in dims))
    print("  bf16 and float16 backward cluster (CTAs, dQ and dK/dV) by head "
          "dim: " + ", ".join(f"D {d}: {lib.bps_flash_bwd16_cluster(d)}"
                              for d in dims))
    counts = hmma_census(build_mod, build_mod.build(mods[0].SOURCE),
                         len(mods[0].HEAD_DIMS), check)
    return f32, counts


def kernel_label(mangled):
    """'flash_bwd_dq_mma_kernel<bf16,64>' from a mangled kernel name."""
    import re
    name = re.search(r"\d+((?:flash|sign)\w*?_kernel)", mangled)
    dims = re.search(r"Li(\d+)E", mangled)
    dtype = ("bf16" if "bfloat16" in mangled
             else "f16" if "__half" in mangled else "f32")
    label = name.group(1) if name else mangled
    if dims:
        return label + f"<{dtype},{dims.group(1)}>"
    if "Lb1E" in mangled:  # a kMulti instance (more slices than CTAs)
        return label + f"<{dtype},multi>"
    return label + (f"<{dtype}>" if "_wide" in label else "")


def ptxas_reports(log):
    """(kernel, 'N registers, spills') for each entry function ptxas
    compiled, the kernel named from its mangled name."""
    import re
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = kernel_label(m.group(1))
            spills = ""
        elif "spill" in line:
            spills = line.split(":", 1)[-1].strip()
        elif "registers" in line and kernel:
            regs = re.search(r"Used (\d+) registers", line)
            out.append((kernel, f"{regs.group(1) if regs else '?'} "
                                f"registers; {spills}"))
            kernel = None
    return out


def hmma_census(build_mod, lib, n_dims, check):
    """HMMA (tensor-core MMA) instructions per kernel in the built
    library's SASS (cuobjdump): every bf16 and float16 instantiation of the
    forward (resident, streaming) and backward (dQ, dK/dV of both families)
    kernels, at each of the ``n_dims`` head dims, has them; so does every
    float32 forward and backward kernel (3xTF32; the instantiations at
    D <= 128 are all the float32 ones, D = 256 runs the wide kernels, as
    every D above it does); the merge and sum passes are not counted.
    Returns the counts by kernel."""
    import re
    cuobjdump = os.path.join(os.path.dirname(build_mod.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    counts, label = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            label = kernel_label(m.group(1))
            counts[label] = 0
        elif label and re.search(r"\bHMMA\b", line):
            counts[label] += 1
    print("  HMMA per kernel (SASS): " + ", ".join(
        f"{k} {n}" for k, n in sorted(counts.items()) if "flash" in k))
    for what, prefixes, n, f32_want in (
            ("forward", ("flash_fwd_mma_kernel", "flash_fwd_str_mma_kernel",
                         "flash_fwd_tc_kernel", "flash_fwd_str_tc_kernel"),
             2 * n_dims, F32_TC_FWD),
            ("backward", ("flash_bwd_dq", "flash_bwd_dkv"), 4 * n_dims,
             F32_TC_BWD)):
        kernels = [k for k in counts
                   if k.startswith(prefixes) and "_wide" not in k]
        tc = [k for k in kernels if "bf16" in k or "f16" in k]
        f32 = [k for k in kernels if "f32" in k]
        check(len(tc) == 2 * n and all(counts[k] > 0 for k in tc),
              f"SASS: HMMA in all {len(tc)} bf16 and float16 {what} "
              f"instantiations (min "
              f"{min((counts[k] for k in tc), default=0)}; want {2 * n})")
        check(sorted(f32) == sorted(f32_want)
              and all(counts[k] > 0 for k in f32),
              f"SASS: HMMA in every float32 {what} instantiation, all of "
              f"them the 3xTF32 kernels at D <= 128 ("
              + ", ".join(f"{k} {counts[k]}" for k in sorted(f32)) + ")")
    wide = [k for k in counts if "_wide" in k and not any(
        s in k for s in ("merge", "delta", "sum_splits"))]
    tc = [k for k in wide if "bf16" in k or "f16" in k]
    f32 = [k for k in wide if "f32" in k]
    check(sorted(tc) == sorted(WIDE16_FWD + WIDE16_BWD)
          and all(counts[k] > 0 for k in tc),
          f"SASS: HMMA in all {len(tc)} bf16 and float16 wide (D > 256) "
          f"kernels, the forward's and the backward's split-D clusters: "
          + ", ".join(f"{k} {counts.get(k, 0)}"
                      for k in WIDE16_FWD + WIDE16_BWD))
    check(sorted(f32) == sorted(F32_WIDE) and all(counts[k] > 0 for k in f32),
          f"SASS: HMMA in the {len(f32)} float32 wide forward and backward "
          f"kernels (3xTF32: " + ", ".join(f"{k} {counts[k]}" for k in f32)
          + ")")
    return counts


def cuda_kernels(key):
    """The CUDA kernel(s) (SASS labels) behind an entry of the kernels
    line: a flash function at <dtype, D> ("flash_fwd" alone is the
    flagship's <bf16,64>), or a sign kernel; the merge, delta and sum
    passes of the streaming family are left out."""
    name, _, inst = key.partition("<")
    if name.startswith("sign_"):
        return [f"{name}_kernel"]
    tag, d = (inst[:-1].split(",") if inst else ("bf16", "64"))
    d = int(d)
    if tag != "f32":
        if d > 256:
            multi = ",multi" if name.startswith("flash_bwd") and d > 1024 \
                else ""
            return [f"{name}_wide16_kernel<{tag}{multi}>"]
        return [f"{name}_mma_kernel<{tag},{d}>"]
    if d in F32_TC_DIMS:
        return [f"{name}_tc_kernel<f32,{d}>"]
    return [f"{name}_wide_kernel<f32>"]


def phase_kernels(fa, torch, check):
    """Kernel vs plain version; returns per-kernel numbers (causal)."""
    import torch.nn.functional as F
    B, H, S, D = (FLAGSHIP[k] for k in ("batch", "heads", "seq", "head_dim"))
    BH = B * H
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = (rnd(BH, S, D) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    out, yardsticks = {}, {}
    for causal in (True, False):
        tag = f"[{BH},{S},{D}] bf16 causal={causal}"
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        o_k, lse_k = fa.flash_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        e_o, e_lse = max_err(o_k, o_p), max_err(lse_k, lse_p)
        gates([("O", o_k, o_p, BF16_GATE), ("LSE", lse_k, lse_p, ROWS_GATE)],
              check, f"flash_fwd {tag}")
        dq_p, delta_p = fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do,
                                              causal, scale)
        dq_k, delta_k = fa.flash_bwd_dq(q, k, v, o_p, lse_p, do, causal,
                                        scale)
        torch.cuda.synchronize()
        e_delta = max_err(delta_k, delta_p)
        gates([("dQ", dq_k, dq_p, BF16_GATE),
               ("delta", delta_k, delta_p, ROWS_GATE)], check,
              f"flash_bwd_dq {tag}")
        dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta_p,
                                            causal, scale)
        dk_k, dv_k = fa.flash_bwd_dkv(q, k, v, do, lse_p, delta_p, causal,
                                      scale)
        torch.cuda.synchronize()
        gates([("dK", dk_k, dk_p, BF16_GATE), ("dV", dv_k, dv_p, BF16_GATE)],
              check, f"flash_bwd_dkv {tag}")
        if not causal:
            continue
        q4, k4, v4 = (t.view(B, H, S, D) for t in (q, k, v))
        timings = {
            "flash_fwd": (
                lambda: fa.flash_fwd(q, k, v, True, scale),
                lambda: fa.flash_fwd_plain(q, k, v, True, scale),
                lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       is_causal=True),
                max(e_o, e_lse)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq(q, k, v, o_p, lse_p, do, True, scale),
                lambda: fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, True,
                                              scale),
                None, max(max_err(dq_k, dq_p), e_delta)),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse_p, delta_p, True,
                                         scale),
                lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta_p,
                                               True, scale),
                None, max(max_err(dk_k, dk_p), max_err(dv_k, dv_p))),
        }
        for name, (kern, plain, lib, err) in timings.items():
            b_ms, b_by = bound_ms(name, BH, S, D, 2, True)
            out[name] = {
                "max_abs_err": err,
                "ms": time_ms(kern),
                "plain_ms": time_ms(plain, reps=5),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": time_ms(lib) if lib is not None else None,
            }
            print(f"  {name}: kernel {out[name]['ms']:.4f} ms "
                  f"({tflops(name, BH, S, D, True, out[name]['ms']):.2f} "
                  f"TFLOP/s), plain {out[name]['plain_ms']:.4f} ms, library "
                  f"{out[name]['library_ms']} ms, bound {b_ms:.4f} ms "
                  f"({b_by})")
        yardsticks["flash_fwd_rates"] = fwd_report(
            "flash_fwd", out["flash_fwd"]["ms"],
            out["flash_fwd"]["library_ms"], BH, S, D)
        # Yardstick for the two backward kernels together: SDPA's backward
        # computes dQ, dK and dV in one call from its own saved forward.
        q4g, k4g, v4g = (t.detach().clone().requires_grad_()
                         for t in (q4, k4, v4))
        o4g = F.scaled_dot_product_attention(q4g, k4g, v4g, is_causal=True)
        do4 = do.view(B, H, S, D)
        yardsticks["sdpa_backward_ms"] = time_ms(
            lambda: torch.autograd.grad(o4g, (q4g, k4g, v4g), do4,
                                        retain_graph=True))
        yardsticks["flash_bwd_dq_plus_dkv_ms"] = (
            out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"])
        yardsticks["bwd_over_sdpa_bwd"] = (
            yardsticks["flash_bwd_dq_plus_dkv_ms"]
            / yardsticks["sdpa_backward_ms"])
        print(f"  SDPA backward (dQ+dK+dV, one call) "
              f"{yardsticks['sdpa_backward_ms']:.4f} ms vs flash_bwd_dq + "
              f"flash_bwd_dkv {yardsticks['flash_bwd_dq_plus_dkv_ms']:.4f} ms"
              f": {yardsticks['bwd_over_sdpa_bwd']:.2f}x SDPA's")

    # Small float32 shape through the autograd op, block_q != block_k.
    for causal in (True, False):
        qs, ks, vs, dos = (rnd(4, 256, 64, dtype=torch.float32)
                           for _ in range(4))
        qs.requires_grad_()
        ks.requires_grad_()
        vs.requires_grad_()
        o = fa.flash_attention(qs, ks, vs, causal, None, 64, 128)
        gq, gk, gv = torch.autograd.grad(o, (qs, ks, vs), dos)
        torch.cuda.synchronize()
        sc = 1.0 / math.sqrt(64)
        with torch.no_grad():
            o_p, lse_p = fa.flash_fwd_plain(qs, ks, vs, causal, sc)
            pq, delta = fa.flash_bwd_dq_plain(qs, ks, vs, o_p, lse_p, dos,
                                              causal, sc)
            pk, pv = fa.flash_bwd_dkv_plain(qs, ks, vs, dos, lse_p, delta,
                                            causal, sc)
        gates([("O", o, o_p, (1e-4, 2e-5)), ("dQ", gq, pq, F32_GATE),
               ("dK", gk, pk, F32_GATE), ("dV", gv, pv, F32_GATE)], check,
              f"flash_attention [4,256,64] f32 causal={causal} block_q=64 "
              f"block_k=128")
    return out, yardsticks


def phase_streaming(fa, torch, check):
    """Streaming kernels vs plain versions; returns per-kernel numbers at
    the long shape and the yardsticks there."""
    import torch.nn.functional as F
    B, H, S, D = (LONG[k] for k in ("batch", "heads", "seq", "head_dim"))
    BH = B * H
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def compare(q, k, v, do, causal, tag, twice):
        """Each kernel against its plain version (backward kernels on the
        plain forward's O and LSE); with ``twice``, a second call of each
        kernel must give the same bits.  Returns the max abs errors."""
        scale = 1.0 / math.sqrt(q.shape[-1])
        o_p, lse_p = fa.flash_fwd_str_plain(q, k, v, causal, scale)
        o_k, lse_k = fa.flash_fwd_str(q, k, v, causal, scale)
        torch.cuda.synchronize()
        e_o, e_lse = max_err(o_k, o_p), max_err(lse_k, lse_p)
        gates([("O", o_k, o_p, BF16_GATE), ("LSE", lse_k, lse_p, ROWS_GATE)],
              check, f"flash_fwd_str {tag}")
        del lse_k
        dq_p, delta_p = fa.flash_bwd_dq_str_plain(q, k, v, o_p, lse_p, do,
                                                  causal, scale)
        dq_k, delta_k = fa.flash_bwd_dq_str(q, k, v, o_p, lse_p, do, causal,
                                            scale)
        torch.cuda.synchronize()
        e_delta = max_err(delta_k, delta_p)
        gates([("dQ", dq_k, dq_p, BF16_GATE),
               ("delta", delta_k, delta_p, ROWS_GATE)], check,
              f"flash_bwd_dq_str {tag}")
        dk_p, dv_p = fa.flash_bwd_dkv_str_plain(q, k, v, do, lse_p, delta_p,
                                                causal, scale)
        dk_k, dv_k = fa.flash_bwd_dkv_str(q, k, v, do, lse_p, delta_p,
                                          causal, scale)
        torch.cuda.synchronize()
        gates([("dK", dk_k, dk_p, BF16_GATE), ("dV", dv_k, dv_p, BF16_GATE)],
              check, f"flash_bwd_dkv_str {tag}")
        # The bf16 backward kernels sum on the tensor cores, P and dS as
        # hi/lo pairs, in another order than cuBLAS does the plain
        # products: dQ, dK and dV differ from the plain version in some
        # elements, each within the gates above.
        print(f"  elements differing from the plain version of "
              f"{o_p.numel()}: O {int((o_k != o_p).sum())}, dQ "
              f"{int((dq_k != dq_p).sum())}, dK {int((dk_k != dk_p).sum())}"
              f", dV {int((dv_k != dv_p).sum())}")
        errs = {"flash_fwd_str": max(e_o, e_lse),
                "flash_bwd_dq_str": max(max_err(dq_k, dq_p), e_delta),
                "flash_bwd_dkv_str": max(max_err(dk_k, dk_p),
                                         max_err(dv_k, dv_p))}
        if twice:
            runs = [(fa.flash_fwd_str(q, k, v, causal, scale),
                     fa.flash_bwd_dq_str(q, k, v, o_p, lse_p, do, causal,
                                         scale),
                     fa.flash_bwd_dkv_str(q, k, v, do, lse_p, delta_p,
                                          causal, scale)) for _ in range(2)]
            torch.cuda.synchronize()
            same = all(torch.equal(a, b)
                       for x, y in zip(*runs) for a, b in zip(x, y))
            check(same, f"streaming kernels {tag}: two calls bit-identical "
                        f"(O, LSE, dQ, delta, dK, dV)")
        return errs, (o_p, lse_p, delta_p)

    q, k, v, do = (rnd(BH, S, D) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    errs, (o_p, lse_p, delta_p) = compare(
        q, k, v, do, True, f"[{BH},{S},{D}] bf16 causal, {splits(fa, S)}",
        twice=True)

    q4, k4, v4 = (t.view(B, H, S, D) for t in (q, k, v))
    timings = {
        "flash_fwd_str": (
            lambda: fa.flash_fwd_str(q, k, v, True, scale),
            lambda: fa.flash_fwd_str_plain(q, k, v, True, scale),
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=True)),
        "flash_bwd_dq_str": (
            lambda: fa.flash_bwd_dq_str(q, k, v, o_p, lse_p, do, True,
                                        scale),
            lambda: fa.flash_bwd_dq_str_plain(q, k, v, o_p, lse_p, do, True,
                                              scale), None),
        "flash_bwd_dkv_str": (
            lambda: fa.flash_bwd_dkv_str(q, k, v, do, lse_p, delta_p, True,
                                         scale),
            lambda: fa.flash_bwd_dkv_str_plain(q, k, v, do, lse_p, delta_p,
                                               True, scale), None),
    }
    out = {}
    for name, (kern, plain, lib) in timings.items():
        b_ms, b_by = bound_ms(name, BH, S, D, 2, True)
        # Up to a few hundred ms a call at this shape: few calls.
        out[name] = {"max_abs_err": errs[name],
                     "ms": time_ms(kern, reps=2, rounds=3),
                     "plain_ms": time_ms(plain, reps=1, rounds=2),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": time_ms(lib) if lib is not None else None}
        print(f"  {name}: kernel {out[name]['ms']:.3f} ms "
              f"({tflops(name, BH, S, D, True, out[name]['ms']):.2f} "
              f"TFLOP/s), plain {out[name]['plain_ms']:.3f} ms, library "
              f"{out[name]['library_ms']} ms, bound {b_ms:.4f} ms ({b_by})")
    fwd_rates = fwd_report("flash_fwd_str", out["flash_fwd_str"]["ms"],
                           out["flash_fwd_str"]["library_ms"], BH, S, D)
    q4g, k4g, v4g = (t.detach().clone().requires_grad_()
                     for t in (q4, k4, v4))
    o4g = F.scaled_dot_product_attention(q4g, k4g, v4g, is_causal=True)
    do4 = do.view(B, H, S, D)
    yard = {"long_sdpa_backward_ms": time_ms(
        lambda: torch.autograd.grad(o4g, (q4g, k4g, v4g), do4,
                                    retain_graph=True), reps=5)}
    del q4g, k4g, v4g, o4g
    # The resident kernels (rows 1-3) at the same shape, streaming=False.
    for name, fn in (
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v, True, scale)),
            ("flash_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, o_p, lse_p, do,
                                                     True, scale)),
            ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(
                q, k, v, do, lse_p, delta_p, True, scale))):
        yard[f"long_resident_{name}_ms"] = time_ms(fn, reps=1, rounds=2)
    pair = out["flash_bwd_dq_str"]["ms"] + out["flash_bwd_dkv_str"]["ms"]
    ratio = pair / yard["long_sdpa_backward_ms"]
    print("  yardsticks at the long shape: " + ", ".join(
        f"{n} {t:.3f} ms" for n, t in yard.items())
        + f"; streaming dq + dkv {pair:.3f} ms: {ratio:.2f}x SDPA's backward")
    yard["long_bwd_over_sdpa_bwd"] = ratio
    yard["flash_fwd_str_rates"] = fwd_rates
    del q, k, v, do, q4, k4, v4, o_p, lse_p, delta_p, timings
    torch.cuda.empty_cache()

    # Non-causal, 2 splits.
    q, k, v, do = (rnd(BH, 8192, D) for _ in range(4))
    compare(q, k, v, do, False, f"[{BH},8192,{D}] bf16 non-causal, "
                                f"{splits(fa, 8192)}", twice=False)
    del q, k, v, do
    # Float32 through the autograd op, block_q != block_k, 4 splits.
    S32 = 16384
    for causal in (True, False):
        qs, ks, vs, dos = (rnd(2, S32, 64, dtype=torch.float32)
                           for _ in range(4))
        for t in (qs, ks, vs):
            t.requires_grad_()
        before = dict(fa.launches)
        o = fa.flash_attention(qs, ks, vs, causal, None, 64, 128,
                               streaming=True)
        gq, gk, gv = torch.autograd.grad(o, (qs, ks, vs), dos)
        torch.cuda.synchronize()
        ran = {n: fa.launches[n] - before[n] for n in before}
        check(all(ran[n] == 1 for n in STREAMING)
              and not any(ran[n] for n in RESIDENT),
              f"flash_attention(streaming=True) f32: launches {ran}")
        sc = 1.0 / math.sqrt(64)
        with torch.no_grad():
            o_p, lse_p = fa.flash_fwd_str_plain(qs, ks, vs, causal, sc)
            pq, delta = fa.flash_bwd_dq_str_plain(qs, ks, vs, o_p, lse_p,
                                                  dos, causal, sc)
            pk, pv = fa.flash_bwd_dkv_str_plain(qs, ks, vs, dos, lse_p,
                                                delta, causal, sc)
        gates([("O", o, o_p, (1e-4, 2e-5)), ("dQ", gq, pq, F32_GATE),
               ("dK", gk, pk, F32_GATE), ("dV", gv, pv, F32_GATE)], check,
              f"flash_attention(streaming=True) [2,{S32},64] f32 causal="
              f"{causal} block_q=64 block_k=128, {splits(fa, S32)}")
        del qs, ks, vs, dos, o, gq, gk, gv, o_p, lse_p, pq, delta, pk, pv
    phase_workspace(fa, torch, check, rnd)
    return out, yard


def splits(fa, s):
    tiles, n = fa._split_tiles(s)
    return f"{n} splits of {tiles * fa.TILE}"


def phase_workspace(fa, torch, check, rnd):
    """Beyond the path's length: [16, 131072, 64] bf16 causal, where the
    split rule takes 8 splits of 16,384 (at most MAX_SPLITS at any S).  The
    three streaming calls' peak memory over their inputs, against the
    outputs plus the largest workspace; O/LSE and dQ/delta of the first
    8,192 rows, and dK/dV of the last 8,192 keys (under causal masking
    they depend only on those rows), against the plain versions."""
    BH, S, D, T = 16, 131072, 64, 8192
    q, k, v, do = (rnd(BH, S, D) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    tiles, n = fa._split_tiles(S)
    out_bytes = BH * S * D * 2
    ws_bytes = 2 * n * BH * S * D * 4            # dK and dV partials
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    o, lse = fa.flash_fwd_str(q, k, v, True, scale)
    dq, delta = fa.flash_bwd_dq_str(q, k, v, o, lse, do, True, scale)
    dk, dv = fa.flash_bwd_dkv_str(q, k, v, do, lse, delta, True, scale)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    limit = 4 * out_bytes + 2 * BH * S * 4 + ws_bytes
    print(f"  [{BH},{S},{D}] bf16 causal, {splits(fa, S)}: the three calls "
          f"{secs:.2f} s; peak {peak / 2**30:.3f} GiB over the inputs, "
          f"of which the dK+dV workspaces {ws_bytes / 2**30:.3f} GiB "
          f"({ws_bytes // (2 * out_bytes)}x the bf16 dK+dV); 4,096-key "
          f"splits would need {S // 4096} splits and "
          f"{ws_bytes * (S // 4096) / n / 2**30:.3f} GiB")
    check((tiles * fa.TILE, n) == (16384, 8) and peak <= limit,
          f"[{BH},{S},{D}]: {n} splits of {tiles * fa.TILE}, peak "
          f"{peak / 2**30:.3f} <= {limit / 2**30:.3f} GiB (outputs + dK/dV "
          f"workspaces)")
    head, tail = slice(0, T), slice(S - T, S)
    o_p, lse_p = fa.flash_fwd_str_plain(q[:, head], k[:, head], v[:, head],
                                        True, scale)
    dq_p, delta_p = fa.flash_bwd_dq_str_plain(
        q[:, head], k[:, head], v[:, head], o[:, head], lse[:, head],
        do[:, head], True, scale)
    dk_p, dv_p = fa.flash_bwd_dkv_str_plain(
        q[:, tail], k[:, tail], v[:, tail], do[:, tail], lse[:, tail],
        delta[:, tail], True, scale)
    gates([("O", o[:, head], o_p, BF16_GATE),
           ("LSE", lse[:, head], lse_p, ROWS_GATE),
           ("dQ", dq[:, head], dq_p, BF16_GATE),
           ("delta", delta[:, head], delta_p, ROWS_GATE),
           ("dK", dk[:, tail], dk_p, BF16_GATE),
           ("dV", dv[:, tail], dv_p, BF16_GATE)], check,
          f"[{BH},{S},{D}] first {T} rows (O, LSE, dQ, delta) and last {T} "
          f"keys (dK, dV) vs the plain versions")
    del q, k, v, do, o, lse, dq, delta, dk, dv
    torch.cuda.empty_cache()


def signs_input(torch, n, seed):
    """Normal floats with +-0.0, +-inf and NaNs of both signs mixed in."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=gen, device="cuda")
    specials = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                             float("nan"), -float("nan")], device="cuda")
    at = torch.randint(0, n, (min(n, 4096),), generator=gen, device="cuda")
    x[at] = specials[torch.arange(at.numel(), device="cuda") % 6]
    return x


def bitpack_bound_ms(bp, n):
    """Least time for one pack or unpack of n elements: 4n float bytes and
    4 * words_len(n) word bytes over HBM bandwidth (no arithmetic to
    speak of)."""
    return (4 * n + 4 * bp.words_len(n)) / HBM_BYTES_PER_S * 1e3


def phase_bitpack(bp, torch, check):
    """The sign kernels against their plain versions, bit for bit."""
    out = {}
    for n in (BUCKET, RAGGED_BUCKET, 4096 * 33, 5000, 100, 1):
        x = signs_input(torch, n, n)
        w_k, w_p = bp.pack_signs(x), bp.pack_signs_plain(x)
        s_k, s_p = bp.unpack_signs(w_k, n), bp.unpack_signs_plain(w_k, n)
        rows = torch.stack([w_k, w_p.flip(0)])
        r_k, r_p = bp.unpack_signs(rows, n), bp.unpack_signs_plain(rows, n)
        torch.cuda.synchronize()
        ok = (w_k.shape == (bp.words_len(n),) and torch.equal(w_k, w_p)
              and torch.equal(s_k, s_p) and torch.equal(r_k, r_p)
              and torch.equal(s_k, torch.where(x < 0, -1.0, 1.0)))
        check(ok, f"sign_pack/sign_unpack n={n}: words, signs and 2-row "
                  f"unpack bit-identical to the plain versions (+-0, +-inf, "
                  f"NaN of both signs in the input)")
        if n != BUCKET:
            continue
        b_ms = bitpack_bound_ms(bp, n)
        for name, kern, plain, err in (
                ("sign_pack", lambda: bp.pack_signs(x),
                 lambda: bp.pack_signs_plain(x),
                 float((w_k.long() - w_p.long()).abs().max())),
                ("sign_unpack", lambda: bp.unpack_signs(w_k, n),
                 lambda: bp.unpack_signs_plain(w_k, n), max_err(s_k, s_p))):
            # Device times from CUDA-graph replay, for kernel and plain
            # version alike; the eager call time beside them is the host's.
            out[name] = {"max_abs_err": err, "ms": time_graph_ms(kern),
                         "plain_ms": time_graph_ms(plain, reps=10),
                         "bound_ms": b_ms, "bound_by": "bytes",
                         "library_ms": None}   # no PyTorch call packs bits
            eager = time_ms(kern, reps=100)
            print(f"  {name} n={n}: kernel {out[name]['ms']:.5f} ms, plain "
                  f"{out[name]['plain_ms']:.5f} ms (device, graph replay), "
                  f"bound {b_ms:.5f} ms (bytes), library none; eager call "
                  f"{eager:.5f} ms")
        floors = unpack_floors(bp, torch, w_k, n)
    return out, floors


def unpack_floors(bp, torch, words, n):
    """sign_unpack at n on one row and on the 2-row batched shape, device
    time from graph replay, beside the byte bound and two floors: PyTorch's
    fill_ of the same float32 output (4n bytes written, nothing read), and
    of one float (a launch that moves nothing)."""
    tiny = torch.empty(1, device="cuda")
    launch_floor = time_graph_ms(lambda: tiny.fill_(1.0))
    out = {"launch_floor_ms": launch_floor}
    for rows in (1, 2):
        w = words if rows == 1 else torch.stack([words, words.flip(0)])
        b_ms = rows * bitpack_bound_ms(bp, n)
        fill = torch.empty(tuple(w.shape[:-1]) + (n,), device="cuda")
        ms = time_graph_ms(lambda: bp.unpack_signs(w, n))
        floor = time_graph_ms(lambda: fill.fill_(1.0))
        out[f"{rows}_row"] = {"ms": ms, "bound_ms": b_ms,
                              "fill_floor_ms": floor}
        print(f"  sign_unpack {rows} x {n} (graph replay): {ms:.5f} ms, "
              f"{b_ms / ms:.3f} of the bound {b_ms:.5f} ms; fill_ of the "
              f"output {floor:.5f} ms; empty launch {launch_floor:.5f} ms")
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if hasattr(tree, "to") else tree


def _compare(torch, got, want, what, check):
    """Payload or state dicts: int32 leaves bit-identical, floats within
    1e-6 relative (a mean over the bucket sums in another order)."""
    for key in sorted(want):
        g, w = got[key], want[key]
        if isinstance(w, dict):
            _compare(torch, g, w, f"{what}.{key}", check)
            continue
        g = g.cpu()
        if w.dtype == torch.int32:
            check(torch.equal(g, w), f"{what}.{key}: {tuple(w.shape)} int32 "
                                     f"bit-identical")
        else:
            r = rel_err(g, w)
            check(r <= 1e-6, f"{what}.{key}: rel err {r:.3g} (tol 1e-6)")


def phase_compressors(C, torch, check):
    """Onebit and dithering on one flagship-size bucket: CUDA (kernels)
    against a CPU copy (plain versions), from the same state."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    xs = [torch.randn(BUCKET, generator=gen, device="cuda") * (r + 1)
          for r in range(2)]
    for kw in ({"compressor": "dithering", "k": 127},
               {"compressor": "dithering", "k": 15},
               {"compressor": "onebit"}):
        comp = C.create(kw)
        st_c = comp.init_state(BUCKET, device=torch.device("cuda"))
        st_h = _to(st_c, "cpu")
        for r, x in enumerate(xs):
            p_c, st_c = comp.compress(x, st_c)
            p_h, st_h = comp.compress(x.cpu(), st_h)
            tag = f"{kw} round {r}"
            _compare(torch, p_c, p_h, f"{tag} payload", check)
            if st_h:
                _compare(torch, st_c, st_h, f"{tag} state", check)
            d_c, d_h = comp.decompress(p_c, BUCKET), comp.decompress(p_h,
                                                                    BUCKET)
            r_err = rel_err(d_c.cpu(), d_h)
            check(r_err <= 1e-6, f"{tag} decompress rel err {r_err:.3g} "
                                 f"(tol 1e-6)")


def phase_small_model(tfm, torch, check):
    """The tiny transformer: flash (kernels) vs dense, loss and grads, at
    the JAX package's own end-to-end tolerance (loss 2e-3, grads 5e-3)."""
    from byteps_tpu_torch.common.tree import tree_leaves
    cfg_f = tfm.get_config("tiny", causal=True, attn_impl="flash")
    cfg_d = tfm.get_config("tiny", causal=True, attn_impl="dense")
    gen = torch.Generator().manual_seed(0)
    params = tfm.init_params(gen, cfg_f)
    batch = tfm.synthetic_batch(gen, 4, 128, cfg_f)

    def loss_grads(cfg):
        loss = tfm.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        return float(loss.detach()), grads

    lf, gf = loss_grads(cfg_f)
    ld, gd = loss_grads(cfg_d)
    gerr = max(max_err(a, b) for a, b in zip(gf, gd))
    check(math.isfinite(lf) and abs(lf - ld) < 2e-3 and gerr < 5e-3,
          f"tiny transformer flash vs dense: loss {lf:.6f} vs {ld:.6f}, "
          f"max grad err {gerr:.3g}")


def flagship_model(tfm, torch, remat_policy="none", batch_seed=1):
    """The flagship's config, params (seed 0) and batch (``batch_seed``)."""
    B, S = FLAGSHIP["batch"], FLAGSHIP["seq"]
    # bench.py:299-302 with its flagship defaults: flash attention with the
    # auto block (512 at S=512), remat "none", 2048-row streamed LM head.
    cfg = tfm.get_config("bert_large", causal=True, vocab_size=32768,
                         max_seq_len=S, ce_chunk_rows=2048,
                         attn_impl="flash",
                         attn_block=tfm.flash_auto_block(S),
                         remat_policy=remat_policy)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = tfm.synthetic_batch(torch.Generator().manual_seed(batch_seed),
                                B, S, cfg)
    return cfg, params, batch


def flagship(tfm, bps, torch, inter_compressor=None, remat_policy="none"):
    """The flagship's config, params, batch, optimizer and step (the
    compressed variant with ``inter_compressor``)."""
    from byteps_tpu_torch.common.tree import tree_leaves
    cfg, params, batch = flagship_model(tfm, torch, remat_policy)
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(tree_leaves(params), lr=1e-4, weight_decay=1e-4),
        inter_compressor=inter_compressor)
    step = bps.build_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt)
    return cfg, params, batch, opt, step


def train(step, params, batch, counters, torch, check, gpu, want,
          steps=STEPS, losses_out=None, key=None):
    """``steps`` steps with every launch counter set to 0 just before and
    read just after; checks losses and that each step launched ``want``
    (the losses also go to ``losses_out[key]``)."""
    B, S = batch[0].shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    for c in counters:
        c.reset_launches()

    def snapshot():
        return {n: v for c in counters for n, v in c.launches.items()}
    for _ in range(steps):
        before = snapshot()
        t0 = time.perf_counter()
        loss = float(step(params, batch))     # waits for the step
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        after = snapshot()
        per_step.append({n: after[n] - before[n] for n in want})
    launches = snapshot()
    if losses_out is not None:
        losses_out[key] = losses
    steady = statistics.median(step_ms[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  losses {losses}")
    print(f"  step ms {[round(t, 3) for t in step_ms]}; steady median "
          f"{steady:.3f} ms = {B * S / steady * 1e3:.1f} tokens/s; peak "
          f"memory {peak:.2f} GiB ({gpu})")
    check(all(math.isfinite(l) for l in losses), "every loss is finite")
    check(losses[-1] < losses[0],
          f"loss falls: {losses[0]:.5f} -> {losses[-1]:.5f}")
    check(all(p == want for p in per_step),
          f"launches per step {per_step[-1]} == {want} in every step")
    check(all(launches[n] > 0 for n, w in want.items() if w),
          f"main-path launches {launches}")
    return launches, steady, peak


def flash_want(fwd, bwd, streaming):
    """Flash launches per step: ``fwd``/``bwd`` of the family the path
    takes, none of the other."""
    on, off = (STREAMING, RESIDENT) if streaming else (RESIDENT, STREAMING)
    return {on[0]: fwd, on[1]: bwd, on[2]: bwd, **{n: 0 for n in off}}


def phase_flagship(bps, tfm, fa, torch, check, gpu, record=None):
    """Phase 4; ``record`` (a dict) gets its losses and peak GiB."""
    cfg, params, batch, opt, step = flagship(tfm, bps, torch)
    print(f"  flagship: {tfm.num_params(params)} params, batch "
          f"{FLAGSHIP['batch']} x seq {FLAGSHIP['seq']}, remat={cfg.remat}/"
          f"{cfg.remat_policy}, ce_chunk_rows={cfg.ce_chunk_rows}, attn="
          f"{cfg.attn_impl}/{cfg.attn_block}")
    want = flash_want(48, 24, streaming=False)
    record = {} if record is None else record
    launches, steady, record["peak"] = train(
        step, params, batch, [fa], torch, check, gpu, want,
        losses_out=record, key="losses")
    busy = phase_profile(step, params, batch, torch, steady)
    return launches, steady, busy


def phase_long(bps, tfm, fa, torch, check, gpu):
    """llama_300m at seq 32,768 (bench.py's BENCH_MODEL=llama_300m
    BENCH_SEQ=32768 with BENCH_ATTN=flash), batch 1, on the streaming
    family."""
    from byteps_tpu_torch.common.tree import tree_leaves
    B, S = LONG["batch"], LONG["seq"]
    cfg = tfm.get_config("llama_300m", causal=True, max_seq_len=S,
                         ce_chunk_rows=2048, attn_impl="flash",
                         attn_block=tfm.flash_auto_block(S))
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = tfm.synthetic_batch(torch.Generator().manual_seed(1), B, S, cfg)
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(tree_leaves(params), lr=1e-4, weight_decay=1e-4))
    step = bps.build_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt)
    print(f"  llama_300m: {tfm.num_params(params)} params, batch {B} x seq "
          f"{S}, {cfg.num_layers} layers, remat={cfg.remat}/"
          f"{cfg.remat_policy}, ce_chunk_rows={cfg.ce_chunk_rows}, attn="
          f"{cfg.attn_impl}/{cfg.attn_block}")
    want = flash_want(2 * cfg.num_layers, cfg.num_layers, streaming=True)
    launches, steady, peak = train(step, params, batch, [fa], torch, check,
                                   gpu, want, steps=LONG_STEPS)
    phase_profile(step, params, batch, torch, steady)
    return launches, steady, peak


def phase_ulysses(fa, torch, check):
    """Ulysses at world 1 with the flash inner on the long shape."""
    from byteps_tpu_torch.ops import ring_attention as ra
    B, H, S, D = (LONG[k] for k in ("batch", "heads", "seq", "head_dim"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    fa.reset_launches()
    out = ra.make_ulysses_attn_fn(attn="flash")(q, k, v, True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    ran = dict(fa.launches)
    direct, _ = fa.flash_fwd_str(*(t.detach().reshape(B * H, S, D)
                                   for t in (q, k, v)), True,
                                 1.0 / math.sqrt(D))
    torch.cuda.synchronize()
    check(ran == flash_want(1, 1, streaming=True),
          f"Ulysses (world 1, flash) [{B},{H},{S},{D}] bf16 causal, forward "
          f"and backward: launches {ran}")
    check(torch.equal(out.detach().reshape(B * H, S, D), direct)
          and all(bool(torch.isfinite(g).all()) for g in grads),
          "Ulysses output equals flash_fwd_str called directly, bit for "
          "bit; gradients finite")


def check_compressed_reduce(C, comp, opt, grads, torch, check):
    """The compressed reduction of the first step's gradients on the card
    against the same reduction on a CPU copy, from the optimizer's initial
    state: every sign word the two runs pack equal, reduced values within
    1e-6 relative (each bucket's onebit scale is a mean, summed in another
    order on the two devices)."""
    from byteps_tpu_torch.ops import collectives
    from byteps_tpu_torch.ops.compressor import onebit
    real = onebit.pack_signs

    def reduce(tree, state):
        words = []

        def record(x):
            w = real(x)
            words.append(w.cpu())
            return w
        onebit.pack_signs = record
        try:
            with collectives.local_mode():
                out, _ = C.compressed_tree_all_reduce(tree, comp, state)
        finally:
            onebit.pack_signs = real
        return [o.cpu() for o in out], words

    t0 = time.perf_counter()
    out_c, words_c = reduce(grads, opt.compression_state)
    torch.cuda.synchronize()
    out_h, words_h = reduce([g.cpu() for g in grads],
                            _to(opt.compression_state, "cpu"))
    same = len(words_c) == len(words_h) == 2 * FLAGSHIP_BUCKETS and all(
        torch.equal(a, b) for a, b in zip(words_c, words_h))
    check(same, f"compressed reduce, first step's gradients: all "
                f"{len(words_c)} packed word arrays (worker and server leg "
                f"of {FLAGSHIP_BUCKETS} buckets) equal on CUDA and CPU")
    worst = max(rel_err(a, b) for a, b in zip(out_c, out_h))
    check(worst <= 1e-6, f"compressed reduce: reduced leaves CUDA vs CPU max "
                         f"rel err {worst:.3g} (tol 1e-6) "
                         f"({time.perf_counter() - t0:.1f} s)")


def phase_flagship_compressed(bps, tfm, fa, bp, torch, check, gpu,
                              plain_steady):
    from byteps_tpu_torch.common.tree import tree_leaves
    C = bps.compressor
    comp = C.create(COMPRESSOR)
    cfg, params, batch, opt, step = flagship(tfm, bps, torch, comp)
    leaves = tree_leaves(params)
    sizes = C.reduce._bucket_sizes(leaves, None)
    compressed = [n for n in sizes if comp.payload_bytes(n) < 4 * n]
    state_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(opt.compression_state))
    print(f"  compressor {COMPRESSOR}: {len(sizes)} buckets, "
          f"{len(compressed)} compressed, sizes {sorted(set(sizes))}; "
          f"state {state_bytes / 2**30:.2f} GiB")
    check(len(compressed) == len(sizes) == FLAGSHIP_BUCKETS
          and RAGGED_BUCKET in sizes,
          f"{FLAGSHIP_BUCKETS} buckets, all compressed, the ragged one "
          f"({RAGGED_BUCKET}) among them")
    loss = tfm.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    check_compressed_reduce(C, comp, opt, list(grads), torch, check)
    del loss, grads
    torch.cuda.empty_cache()

    want = {**flash_want(48, 24, streaming=False),
            "sign_pack": 2 * len(compressed),
            "sign_unpack": 4 * len(compressed)}
    check(want["sign_pack"] == 642 and want["sign_unpack"] == 1284,
          f"expected bitpack launches per step {want}")
    launches, steady, peak = train(step, params, batch, [fa, bp], torch,
                                   check, gpu, want)
    print(f"  compressed step {steady:.3f} ms vs uncompressed "
          f"{plain_steady:.3f} ms (+{steady - plain_steady:.3f} ms)")
    bound = 6 * sum(bitpack_bound_ms(bp, n) for n in compressed)
    print(f"  bitpack bound per step: {bound:.4f} ms ({want['sign_pack']} "
          f"packs + {want['sign_unpack']} unpacks at their byte bounds)")
    phase_profile(step, params, batch, torch, steady, bitpack_bound=bound)
    return launches, steady, peak


def _leaves(state):
    if isinstance(state, dict):
        return [l for v in state.values() for l in _leaves(v)]
    if isinstance(state, (tuple, list)):
        return [l for v in state for l in _leaves(v)]
    return [] if state is None else [state]


def phase_profile(step, params, batch, torch, steady_ms, bitpack_bound=None):
    """One more flagship step under torch.profiler: device time by kernel
    group and of each flash kernel, and the device's idle share of the
    unprofiled step time."""
    import re
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms in kernels)
    if not kernels:
        print("  profile: no device time recorded (not measured)")
        return None
    groups = {"flash kernels": 0.0, "bitpack kernels": 0.0, "matmul": 0.0,
              "other": 0.0}
    for name, ms in kernels:
        low = name.lower()
        if "flash_" in low and "kernel" in low:
            groups["flash kernels"] += ms
        elif "sign_pack" in low or "sign_unpack" in low:
            groups["bitpack kernels"] += ms
        elif any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    print(f"  profiled step: wall {wall_ms:.3f} ms with the profiler on; "
          f"device busy {busy:.3f} ms; idle share of the unprofiled "
          f"{steady_ms:.3f} ms step {1 - busy / steady_ms:.4f}")
    print("  by group: " + ", ".join(f"{g} {ms:.3f} ms ({ms / busy:.4f})"
                                     for g, ms in groups.items()))
    flash = sorted(((m[0], ms) for name, ms in kernels
                    if (m := re.search(r"flash\w*?_kernel(<[^>]*>)?", name))),
                   key=lambda r: -r[1])
    print("  flash kernels: " + ", ".join(f"{n} {ms:.3f} ms"
                                          for n, ms in flash))
    if bitpack_bound is not None:
        print(f"  bitpack kernels {groups['bitpack kernels']:.3f} ms of "
              f"device time vs their {bitpack_bound:.4f} ms byte bound")
        host = sorted((e for e in prof.key_averages()
                       if e.self_cpu_time_total > 0),
                      key=lambda e: -e.self_cpu_time_total)[:10]
        print("  host time by op (self CPU ms, calls): " + ", ".join(
            f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ({e.count})"
            for e in host))
    for name, ms in sorted(kernels, key=lambda r: -r[1])[:8]:
        print(f"    {ms:9.3f} ms  {name[:100]}")
    return busy


@contextlib.contextmanager
def plain_calls(fa):
    """The names of the flash plain versions called while the block runs."""
    calls = []
    real = {n: getattr(fa, n) for n in dir(fa) if n.endswith("_plain")}
    for n, fn in real.items():
        setattr(fa, n, lambda *a, _f=fn, _n=n: calls.append(_n) or _f(*a))
    try:
        yield calls
    finally:
        for n, fn in real.items():
            setattr(fa, n, fn)


def cover_case(fa, tfm, torch, check, gen, dtype, shape, force_streaming):
    """flash_attention_fn forward and backward on the card at [B, H, S, D]
    causal: each kernel of the family the rule picks (every family with
    the budget at 0) launched once a B*H slice, the other family and every
    plain version not at all; O against the plain forward, dQ, dK, dV
    against the plain backward on the kernels' own O and the plain LSE,
    elementwise."""
    B, H, S, D = shape
    q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    budget = fa.RESIDENT_VMEM_BUDGET
    if force_streaming:
        fa.RESIDENT_VMEM_BUDGET = 0
    try:
        streaming = fa._use_streaming(q.detach().reshape(B * H, S, D), None)
        before = dict(fa.launches)
        with plain_calls(fa) as calls:
            out = tfm.flash_attention_fn(q, k, v, True)
            grads = torch.autograd.grad(out, (q, k, v), do)
            torch.cuda.synchronize()
    finally:
        fa.RESIDENT_VMEM_BUDGET = budget
    ran = {n: fa.launches[n] - before[n] for n in before}
    on, off = (STREAMING, RESIDENT) if streaming else (RESIDENT, STREAMING)
    slices = -(-B * H // fa.MAX_LAUNCH_BH)
    tag = (f"[{B * H},{S},{D}] {fa._DTYPE_NAMES[dtype]} causal, "
           f"{'streaming' if streaming else 'resident'}")
    check(all(ran[n] == slices for n in on) and not any(ran[n] for n in off)
          and not calls,
          f"flash_attention_fn {tag}: launches {[ran[n] for n in on]} (want "
          f"{slices} each), other family {[ran[n] for n in off]}, plain "
          f"versions run {len(calls)}")

    def fold(t):
        return t.detach().reshape(B * H, S, D)
    qf, kf, vf, dof, of = (fold(t) for t in (q, k, v, do, out))
    fwd_p, dq_p, dkv_p = (getattr(fa, n + "_plain") for n in on)
    scale = D ** -0.5
    with torch.no_grad():
        o_p, lse_p = fwd_p(qf, kf, vf, True, scale)
        dq_r, delta_r = dq_p(qf, kf, vf, of, lse_p, dof, True, scale)
        dk_r, dv_r = dkv_p(qf, kf, vf, dof, lse_p, delta_r, True, scale)
    o_gate, g_gate = {torch.float32: (F32_GATE, F32_GATE),
                      torch.bfloat16: (BF16_GATE, BF16_GATE),
                      torch.float16: (FP16_GATE, FP16_GATE)}[dtype]
    got = [("O", of, o_p), ("dQ", fold(grads[0]), dq_r),
           ("dK", fold(grads[1]), dk_r), ("dV", fold(grads[2]), dv_r)]
    gates([(n, g, w, o_gate if n == "O" else g_gate) for n, g, w in got],
          check, f"flash_attention_fn {tag} vs the plain versions")
    if dtype == torch.float32:
        return
    print("    most steps apart: " + ", ".join(
        f"{n} {steps_apart(g, w, g_gate):.3g}" for n, g, w in got))
    if dtype != torch.float16:
        return
    # Control: the same inputs rounded to bf16 through the bf16 kernels,
    # the outputs cast to float16, against the same plain outputs.
    ctl = [t.detach().to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
    out_c = tfm.flash_attention_fn(*ctl, True)
    got_c = (out_c, *torch.autograd.grad(out_c, ctl, do.to(torch.bfloat16)))
    res = {n: gate(fold(x).to(dtype), w, FP16_GATE)[1]
           for (n, _, w), x in zip(got, got_c)}
    check(all(r > 1.0 for r in res.values()),
          f"flash_attention_fn {tag}: the control (inputs rounded to bf16, "
          f"the bf16 kernels) misses the float16 gate: " + ", ".join(
              f"{n} {r:.3g}" for n, r in res.items()) + " (> 1)")


def phase_coverage(fa, tfm, torch, check):
    """This slice's path: flash_attention_fn (non-strict) on the kernels at
    every padded head dim in bf16 and float32, both families, at the
    flagship's [8, 16, 512, D]; float16 at D = 64 and 128 there and at the
    long [1, 16, 32768, 64]; and B*H = 65,600.  Returns the launches by
    instantiation."""
    B, H, S = (FLAGSHIP[k] for k in ("batch", "heads", "seq"))
    cases = [(dtype, (B, H, S, d), force)
             for dtype in (torch.bfloat16, torch.float32)
             for d in COVER_DIMS for force in (False, True)]
    cases += [(torch.float16, (B, H, S, 64), False),
              (torch.float16, (B, H, S, 128), False),
              (torch.float16, (LONG["batch"], LONG["heads"], LONG["seq"],
                               LONG["head_dim"]), False),
              (torch.bfloat16, (4100, 16, 64, 16), False)]
    gen = torch.Generator(device="cuda").manual_seed(6)
    fa.reset_launches()
    t0 = time.perf_counter()
    for dtype, shape, force in cases:
        cover_case(fa, tfm, torch, check, gen, dtype, shape, force)
        torch.cuda.empty_cache()
    print("  B*H = 65,600 again, three more seeds:")
    for seed in (1, 2, 3):
        cover_case(fa, tfm, torch, check,
                   torch.Generator(device="cuda").manual_seed(seed),
                   torch.bfloat16, (4100, 16, 64, 16), False)
    cases += [cases[-1]] * 3
    launches = dict(fa.instance_launches)
    print(f"  {len(cases)} cases in {time.perf_counter() - t0:.1f} s; "
          f"launches by instantiation {launches}")
    return launches


def phase_hd96(bps, tfm, fa, torch, check, gpu):
    """A transformer at bert_base width with 8 heads of 96 (padded to 128
    in the kernels), 2 layers, causal, seq 512, batch 8: 3 steps in bf16,
    then 3 in float16, each with finite, falling losses and 4/2/2 resident
    launches a step.  Returns the launches by instantiation."""
    from byteps_tpu_torch.common.tree import tree_leaves
    launches = {}
    for dtype in (torch.bfloat16, torch.float16):
        cfg = tfm.TransformerConfig(
            num_layers=HD96["layers"], d_model=HD96["d_model"],
            num_heads=HD96["heads"], d_ff=HD96["d_ff"],
            max_seq_len=HD96["seq"], causal=True, dtype=dtype,
            attn_impl="flash", ce_chunk_rows=2048)
        params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
        batch = tfm.synthetic_batch(torch.Generator().manual_seed(1),
                                    HD96["batch"], HD96["seq"], cfg)
        opt = bps.DistributedOptimizer(torch.optim.AdamW(
            tree_leaves(params), lr=1e-3, weight_decay=1e-4))
        step = bps.build_train_step(lambda p, b, c=cfg: tfm.loss_fn(p, b, c),
                                    opt)
        print(f"  {fa._DTYPE_NAMES[dtype]}: head_dim {cfg.head_dim}, "
              f"{tfm.num_params(params)} params")
        want = flash_want(2 * cfg.num_layers, cfg.num_layers,
                          streaming=False)
        train(step, params, batch, [fa], torch, check, gpu, want,
              steps=HD96_STEPS)
        for key, n in fa.instance_launches.items():
            launches[key] = launches.get(key, 0) + n
        check(set(fa.instance_launches) == {
            f"{n}<{fa._DTYPE_NAMES[dtype]},128>" for n in RESIDENT},
              f"head dim 96 ran the D = 128 instantiations: "
              f"{dict(fa.instance_launches)}")
        del params, batch, opt, step
        torch.cuda.empty_cache()
    return launches


def sdpa_backend(torch, q, k, v):
    """The backend PyTorch's dispatcher picks for SDPA on these [B, H, S, D]
    inputs, causal (its own choice function)."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True)).name


def phase_instances(fa, torch, check, tag, d, long_shape=LONG):
    """The instantiation <tag, d> of each flash kernel against its plain
    version (the backward ones on the plain forward's O and LSE),
    elementwise, and timed: the resident family at the flagship shape
    [128, 512, d], the streaming one at ``long_shape`` (the long
    [16, 32768, d] by default), beside their bounds and SDPA's forward and
    backward at the same shapes, with the SDPA backend that ran."""
    import torch.nn.functional as F
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16,
             "f32": torch.float32}[tag]
    gate16 = F32_GATE if dtype == torch.float32 else BF16_GATE
    itemsize = 4 if dtype == torch.float32 else 2
    out, yard = {}, {}
    for shape, names in ((FLAGSHIP, RESIDENT), (long_shape, STREAMING)):
        B, H, S = (shape[k] for k in ("batch", "heads", "seq"))
        BH, long = B * H, names is STREAMING
        gen = torch.Generator(device="cuda").manual_seed(d)
        q, k, v, do = (torch.randn(BH, S, d, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        scale = d ** -0.5
        kern = [getattr(fa, n) for n in names]
        plain = [getattr(fa, n + "_plain") for n in names]
        o_p, lse_p = plain[0](q, k, v, True, scale)
        dq_p, delta_p = plain[1](q, k, v, o_p, lse_p, do, True, scale)
        dk_p, dv_p = plain[2](q, k, v, do, lse_p, delta_p, True, scale)
        o_k, lse_k = kern[0](q, k, v, True, scale)
        dq_k, delta_k = kern[1](q, k, v, o_p, lse_p, do, True, scale)
        dk_k, dv_k = kern[2](q, k, v, do, lse_p, delta_p, True, scale)
        torch.cuda.synchronize()
        what = f"<{tag},{d}> [{BH},{S},{d}] causal"
        gates([("O", o_k, o_p, gate16), ("LSE", lse_k, lse_p, ROWS_GATE),
               ("dQ", dq_k, dq_p, gate16),
               ("delta", delta_k, delta_p, ROWS_GATE),
               ("dK", dk_k, dk_p, gate16), ("dV", dv_k, dv_p, gate16)],
              check, f"{names[0]} family {what} vs the plain versions")
        errs = [max(max_err(o_k, o_p), max_err(lse_k, lse_p)),
                max(max_err(dq_k, dq_p), max_err(delta_k, delta_p)),
                max(max_err(dk_k, dk_p), max_err(dv_k, dv_p))]
        del o_k, lse_k, dq_k, delta_k, dk_k, dv_k, dq_p, dk_p, dv_p
        q4, k4, v4 = (t.view(B, H, S, d) for t in (q, k, v))
        calls = (
            (lambda: kern[0](q, k, v, True, scale),
             lambda: plain[0](q, k, v, True, scale),
             lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                    is_causal=True)),
            (lambda: kern[1](q, k, v, o_p, lse_p, do, True, scale),
             lambda: plain[1](q, k, v, o_p, lse_p, do, True, scale), None),
            (lambda: kern[2](q, k, v, do, lse_p, delta_p, True, scale),
             lambda: plain[2](q, k, v, do, lse_p, delta_p, True, scale),
             None))
        backend = sdpa_backend(torch, q4, k4, v4)
        for name, err, (kfn, pfn, lib) in zip(names, errs, calls):
            b_ms, b_by = bound_ms(name, BH, S, d, itemsize, True)
            key = f"{name}<{tag},{d}>"
            out[key] = {
                "max_abs_err": err,
                "ms": time_ms(kfn, reps=2, rounds=3) if long else time_ms(kfn),
                "plain_ms": (time_ms(pfn, reps=1, rounds=2) if long
                             else time_ms(pfn, reps=5)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(lib) if lib is not None else None}
            cores = bound_ms(name, BH, S, d, 4, True, F32_FLOPS_PER_S)[0]
            cores = (f", {cores:.4f} ms outside the tensor cores"
                     if itemsize == 4 else "")
            print(f"  {key} [{BH},{S},{d}]: kernel {out[key]['ms']:.4f} ms "
                  f"({tflops(name, BH, S, d, True, out[key]['ms']):.2f} "
                  f"TFLOP/s), plain {out[key]['plain_ms']:.4f} ms, library "
                  f"{out[key]['library_ms']} ms (SDPA {backend}), bound "
                  f"{b_ms:.4f} ms ({b_by}{cores})")
        q4g, k4g, v4g = (t.detach().clone().requires_grad_()
                         for t in (q4, k4, v4))
        o4g = F.scaled_dot_product_attention(q4g, k4g, v4g, is_causal=True)
        do4 = do.view(B, H, S, d)
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(
            o4g, (q4g, k4g, v4g), do4, retain_graph=True),
            reps=5 if long else 20)
        pair = out[f"{names[1]}<{tag},{d}>"]["ms"] + out[
            f"{names[2]}<{tag},{d}>"]["ms"]
        where = "long" if long else "flagship"
        yard[f"sdpa_backward_ms<{tag},{d},{where}>"] = sdpa_bwd
        yard[f"sdpa_backend<{tag},{d},{where}>"] = backend
        print(f"  SDPA backward <{tag},{d}> at the {where} shape "
              f"{sdpa_bwd:.4f} ms vs the backward pair {pair:.4f} ms "
              f"({pair / sdpa_bwd:.2f}x)")
        del q, k, v, do, q4, k4, v4, o_p, lse_p, delta_p, q4g, k4g, v4g, o4g
        torch.cuda.empty_cache()
    return out, yard


def phase_wide(fa, tfm, torch, check, ptxas, hmma):
    """Part A: flash_attention_fn on the card above D = 256 (the wide
    kernels): D = 264, 384 and 512 at [8, 16, 512, D], and 1024 and 1152
    at [1, 4, 512, D], in float32, bf16 and float16, resident and streaming,
    forward and both gradients, each held to the plain versions under the
    elementwise gates (float16 to its own step, with the bf16 control).
    The launches by instantiation of the forward and of the backward pair
    must be one a case of their family in each dtype, and in bf16 one more
    resident launch for each float16 case's control (the library holds no
    wide kernel but the cluster kernels, phase 1), printed with their
    cluster size; the bf16 and float16 forward's and backward's cluster
    kernels with their ptxas registers and spills (``ptxas``, when this
    run built the library), HMMA count (``hmma``) and the clusters the
    card holds at once.  Returns the launches by instantiation."""
    import re
    B, H, S = (FLAGSHIP[k] for k in ("batch", "heads", "seq"))
    cases = [(dtype, (B, H, S, d), force)
             for dtype in (torch.float32, torch.bfloat16, torch.float16)
             for d in WIDE_DIMS for force in (False, True)]
    cases += [(dtype, (1, 4, S, d), force)
              for dtype in (torch.float32, torch.bfloat16, torch.float16)
              for d in (1024, 1152) for force in (False, True)]
    gen = torch.Generator(device="cuda").manual_seed(7)
    fa.reset_launches()
    t0 = time.perf_counter()
    for dtype, shape, force in cases:
        cover_case(fa, tfm, torch, check, gen, dtype, shape, force)
        torch.cuda.empty_cache()
    launches = dict(fa.instance_launches)
    print(f"  {len(cases)} cases in {time.perf_counter() - t0:.1f} s; "
          f"launches by instantiation {launches}")
    check(all(n > 256 and n % 128 == 0 for n in
              (int(k.split(",")[1][:-1]) for k in launches)),
          "every launch ran a wide instantiation (D a multiple of 128 "
          "above 256)")
    lib = fa._lib()
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16"),
                       (torch.float16, "f16")):
        for fam, cluster in (
                ((RESIDENT[0], STREAMING[0]), lib.bps_flash_fwd16_cluster),
                (RESIDENT[1:] + STREAMING[1:], lib.bps_flash_bwd16_cluster)):
            if dtype == torch.float32:
                cluster = lib.bps_flash_f32_cluster
            want = {}
            for dt, shape, force in cases:
                d = fa.kernel_head_dim(shape[3])
                names = STREAMING if force else RESIDENT
                if dt == dtype:
                    for n in names:
                        if n in fam:
                            want[f"{n}<{tag},{d}>"] = want.get(
                                f"{n}<{tag},{d}>", 0) + 1
                if dt == torch.float16 and dtype == torch.bfloat16:
                    # each float16 case's control: the bf16 kernels, resident
                    for n in RESIDENT:
                        if n in fam:
                            want[f"{n}<bf16,{d}>"] = want.get(
                                f"{n}<bf16,{d}>", 0) + 1
            got = {k: n for k, n in launches.items()
                   if k.split("<")[0] in fam and f"<{tag}," in k}
            ctas = {k: cluster(int(k.split(",")[1][:-1])) for k in got}
            what = "forward" if fam[0] == RESIDENT[0] else "backward"
            check(got == want,
                  f"{fa._DTYPE_NAMES[dtype]} wide {what} launches by "
                  f"instantiation " + ", ".join(
                      f"{k} {n} (cluster of {ctas[k]} CTAs)"
                      for k, n in sorted(got.items())) + f" (want {want})")
    for d, want_ctas in WIDE16_CLUSTER.items():
        ctas = lib.bps_flash_fwd16_cluster(d)
        held = {t: lib.bps_flash_fwd16_max_clusters(d, code)
                for t, code in (("bf16", 1), ("f16", 2))}
        check(ctas == want_ctas and all(n > 0 for n in held.values()),
              f"bf16 and float16 wide forward at D {d}: a cluster of {ctas} "
              f"CTAs (want {want_ctas}); clusters the card holds at once "
              f"(cudaOccupancyMaxActiveClusters, resident) {held}")
        ctas = lib.bps_flash_bwd16_cluster(d)
        held = {f"{kern}<{t}>": lib.bps_flash_bwd16_max_clusters(d, code, i)
                for t, code in (("bf16", 1), ("f16", 2))
                for i, kern in enumerate(("dQ", "dK/dV"))}
        check(ctas == want_ctas and all(n > 0 for n in held.values()),
              f"bf16 and float16 wide backward at D {d}: a cluster of {ctas} "
              f"CTAs (want {want_ctas}); clusters the card holds at once "
              f"(cudaOccupancyMaxActiveClusters, resident) {held}")
    for what, names in (("forward", WIDE16_FWD), ("backward", WIDE16_BWD)):
        check(all(hmma.get(k, 0) > 0 for k in names) and (not ptxas or all(
            re.search(r"\b0 bytes spill stores", ptxas.get(k, ""))
            for k in names)),
              f"bf16 and float16 wide {what} kernels: " + "; ".join(
                  f"{k} {ptxas.get(k, 'no ptxas report')}, HMMA "
                  f"{hmma.get(k, 0)}" for k in names))
    return launches


def f32_kernels(d, direction):
    """The float32 forward or backward kernels (SASS labels) that run at
    head dim d."""
    if d in F32_TC_DIMS:
        names = F32_TC_FWD if direction == "forward" else F32_TC_BWD
        return [k for k in names if k.endswith(f",{d}>")]
    return list(F32_WIDE_FWD if direction == "forward" else F32_WIDE_BWD)


def f32_report(fa, path, ptxas, hmma, numbers, yard, check):
    """At each of F32_INSTANCES, for the float32 forward and backward: the
    cluster size, the ptxas registers, spills and HMMA count of each
    kernel that runs there, and the coverage path's launches by
    instantiation; the forward's times (phase 10's ``numbers``) beside its
    bound and SDPA's forward, the backward pair's beside SDPA's backward
    (``yard``).  Checks a cluster of 1 CTA up to D = 128 and 2 at 256, no
    spills (when this run built the library), HMMA in each kernel and
    every launch counted."""
    import re
    lib = fa._lib()
    for d in F32_INSTANCES:
        ctas = lib.bps_flash_f32_cluster(d)
        for direction, names in (("forward", (RESIDENT[0], STREAMING[0])),
                                 ("backward", RESIDENT[1:] + STREAMING[1:])):
            kernels = f32_kernels(d, direction)
            launched = {f"{n}<f32,{d}>": path.get(f"{n}<f32,{d}>", 0)
                        for n in names}
            print(f"  float32 {direction} at D {d}: cluster of {ctas} "
                  f"CTA(s); launches {launched}; " + "; ".join(
                      f"{k} {ptxas.get(k, 'no ptxas report')}, HMMA "
                      f"{hmma.get(k, 0)}" for k in kernels))
            check(ctas == (1 if d <= 128 else 2)
                  and all(n > 0 for n in launched.values())
                  and all(hmma.get(k, 0) > 0 for k in kernels)
                  and (not ptxas or all(
                      re.search(r"\b0 bytes spill stores", ptxas.get(k, ""))
                      for k in kernels)),
                  f"float32 {direction} at D {d}: {ctas} CTA(s) a cluster, "
                  f"launches {launched}, kernels {kernels} with HMMA and no "
                  f"spills")
        for name, shape in ((RESIDENT[0], FLAGSHIP),
                            (STREAMING[0], WIDE_LONG)):
            got = numbers[f"{name}<f32,{d}>"]
            bh, s = shape["batch"] * shape["heads"], shape["seq"]
            print(f"  float32 forward {name}<f32,{d}> [{bh},{s},{d}] "
                  f"causal: {got['ms']:.4f} ms "
                  f"({tflops(name, bh, s, d, True, got['ms']):.2f} TFLOP/s), "
                  f"bound {got['bound_ms']:.4f} ms "
                  f"({got['ms'] / got['bound_ms']:.1f}x), SDPA forward "
                  f"{got['library_ms']:.4f} ms "
                  f"({got['ms'] / got['library_ms']:.2f}x)")
        for names, where in ((RESIDENT, "flagship"), (STREAMING, "long")):
            pair = sum(numbers[f"{n}<f32,{d}>"]["ms"] for n in names[1:])
            sdpa = yard[f"sdpa_backward_ms<f32,{d},{where}>"]
            print(f"  float32 backward pair {names[1]} + {names[2]} "
                  f"<f32,{d}>: {pair:.4f} ms, SDPA backward {sdpa:.4f} ms "
                  f"({pair / sdpa:.2f}x)")


def phase_eager(bps, torch, check, grads):
    """The eager API on CUDA tensors at world 1: push_pull, push_pull_async
    + poll + synchronize (a used handle refused), and push_pull_tree over
    ResNet-50's gradients (``grads``, a tree), whose bucket count must be
    the fusion planner's plan for the same leaves."""
    from byteps_tpu_torch.common import fusion
    from byteps_tpu_torch.common.tree import tree_leaves
    bps.init()
    x = torch.randn(4096, device="cuda")
    y = bps.push_pull(x, name="smoke.x")
    h = bps.push_pull_async(x, name="smoke.xa")
    while not bps.poll(h):
        pass
    z = bps.synchronize(h)
    try:
        bps.synchronize(h)
        refused = False
    except ValueError:
        refused = True
    check(y.is_cuda and torch.equal(y, x) and torch.equal(z, x) and refused,
          "push_pull and push_pull_async + poll + synchronize on CUDA "
          "tensors: the identity at world 1, a used handle refused")
    leaves = tree_leaves(grads)
    fb = bps.common.config.get_config().fusion_bytes
    plan = fusion.plan_buckets(tuple(
        (i, l.numel(), str(l.dtype).removeprefix("torch."),
         l.element_size()) for i, l in enumerate(leaves)), fb)
    before = fusion.get_stats()["buckets_built"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bps.push_pull_tree(grads, name="smoke.resnet50")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    built = fusion.get_stats()["buckets_built"] - before
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(out), leaves))
    check(same and built == len(plan.buckets) and len(plan.buckets) > 1,
          f"push_pull_tree over ResNet-50's {len(leaves)} gradients on the "
          f"card: {built} buckets (the planner's plan: {len(plan.buckets)} "
          f"buckets, {len(plan.solo)} solo leaves at {fb} bytes), values "
          f"unchanged at world 1, {ms:.3f} ms")
    bps.shutdown()


def phase_cnn(bps, torch, check, gpu):
    """Part B's path at full width: ResNet-50, 224 x 224 x 3, 1000 classes,
    float32, batch 64, one fixed synthetic batch; SGD (lr 0.1, momentum
    0.9) through DistributedOptimizer + build_train_step with cnn_loss_fn,
    5 steps (finite, falling losses; step ms, images/s, peak memory; one
    profiled step); then the same model from the same weights through the
    Horovod face (broadcast_parameters, DistributedOptimizer,
    broadcast_optimizer_state, zero_grad/backward/step with the
    BatchNorms on their running statistics, as cnn_loss_fn runs them):
    one push_pull_async a parameter and step (161), all synchronized
    before the inner step, and parameters within relative L2 1e-5 of the
    functional path's.  cuDNN runs deterministic algorithms and no TF32
    (stated with the numbers).  Returns ResNet-50's gradients, for the
    eager phase."""
    import byteps_tpu_torch.torch as hvd
    from byteps_tpu_torch.common.tree import tree_leaves
    from byteps_tpu_torch.models import cnn
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    tf32 = (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
            f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
            f"cudnn.deterministic=True")
    model = cnn.create_cnn(CNN["name"], num_classes=CNN["classes"],
                           dtype=torch.float32, seed=0)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    images = torch.rand(CNN["batch"], CNN["image"], CNN["image"], 3,
                        generator=gen, device="cuda")
    labels = torch.randint(0, CNN["classes"], (CNN["batch"],),
                           generator=gen, device="cuda")
    batch = (images, labels)
    params = cnn.cnn_variables(model)["params"]
    n_params = len(tree_leaves(params))
    check(n_params == RESNET50_PARAMS,
          f"ResNet-50 has {n_params} parameter tensors")
    opt = bps.DistributedOptimizer(torch.optim.SGD(
        tree_leaves(params), lr=CNN["lr"], momentum=CNN["momentum"]))
    step = bps.build_train_step(cnn.cnn_loss_fn(model), opt)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(CNN["steps"]):
        t0 = time.perf_counter()
        losses.append(float(step(params, batch)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    steady = statistics.median(step_ms[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  functional path: losses {losses}")
    print(f"  step ms {[round(t, 3) for t in step_ms]}; steady median "
          f"{steady:.3f} ms = {CNN['batch'] / steady * 1e3:.1f} images/s; "
          f"peak {peak:.2f} GiB ({tf32}; {gpu})")
    check(all(math.isfinite(l) for l in losses) and losses[-1] < losses[0],
          f"ResNet-50 functional path: finite losses, falling "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}")
    functional = {k: v.detach().clone() for k, v in
                  model.state_dict().items()}
    phase_profile(step, params, batch, torch, steady)

    # The Horovod face, from the same weights.
    hvd.init()
    model.load_state_dict(start)
    sgd = torch.optim.SGD(model.parameters(), lr=CNN["lr"],
                          momentum=CNN["momentum"])
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hopt = hvd.DistributedOptimizer(
        sgd, named_parameters=model.named_parameters())
    hvd.broadcast_optimizer_state(hopt, root_rank=0)
    launched, synced, pending_at_inner = [], [], []
    real_async, real_sync = hvd.push_pull_async, hvd.synchronize
    real_inner = hopt._inner.step

    def count_async(*a, **kw):
        launched[-1] += 1
        return real_async(*a, **kw)

    def count_sync(h):
        synced[-1] += 1
        return real_sync(h)

    def inner_step(*a, **kw):
        pending_at_inner.append(len(hopt._pending))
        return real_inner(*a, **kw)
    hvd.push_pull_async, hvd.synchronize = count_async, count_sync
    hopt._inner.step = inner_step
    h_losses, h_ms = [], []
    model.eval()
    try:
        for _ in range(CNN["steps"]):
            launched.append(0)
            synced.append(0)
            t0 = time.perf_counter()
            hopt.zero_grad()
            loss = torch.nn.functional.cross_entropy(model(images), labels)
            loss.backward()
            hopt.step()
            h_losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            h_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        hvd.push_pull_async, hvd.synchronize = real_async, real_sync
        hopt._inner.step = real_inner
        model.train()
    h_steady = statistics.median(h_ms[1:])
    print(f"  Horovod face: losses {h_losses}; step ms "
          f"{[round(t, 3) for t in h_ms]}; steady median {h_steady:.3f} ms "
          f"= {CNN['batch'] / h_steady * 1e3:.1f} images/s ({tf32})")
    check(launched == synced == [RESNET50_PARAMS] * CNN["steps"]
          and pending_at_inner == [0] * CNN["steps"],
          f"Horovod face: push_pull_async handles per step {launched}, "
          f"synchronized {synced}, pending at the inner step "
          f"{pending_at_inner} (want {RESNET50_PARAMS}, {RESNET50_PARAMS}, "
          f"0)")
    num = sum(float((model.state_dict()[k].double() - v.double())
                    .pow(2).sum()) for k, v in functional.items())
    den = sum(float(v.double().pow(2).sum()) for v in functional.values())
    rel = math.sqrt(num / den)
    check(rel <= 1e-5, f"Horovod face vs functional path after "
          f"{CNN['steps']} steps: parameters within relative L2 {rel:.3g} "
          f"(<= 1e-5); losses {h_losses[-1]:.6f} vs {losses[-1]:.6f}")
    hvd.shutdown()
    grads = cnn.cnn_variables(model)["params"]
    grads = _grad_tree(grads)
    return grads, {"cnn_step_ms": steady,
                   "cnn_images_per_s": CNN["batch"] / steady * 1e3,
                   "cnn_peak_gib": peak, "cnn_hvd_step_ms": h_steady,
                   "cnn_hvd_rel_l2": rel, "cnn_tf32": tf32}


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    return tree.grad.detach().clone()


def phase_remat(bps, tfm, fa, torch, check, gpu):
    """The flagship (bert_large geometry, 8 x 512, flash) for 3 steps under
    each remat policy, from the same weights and batch: the flash launches
    48/24/24 a step under every policy (the recompute reruns the flash
    autograd op, which no selective policy sees), the losses of every
    policy equal to "none"'s (the largest relative difference printed),
    and step ms and peak memory per policy."""
    from byteps_tpu_torch.common.tree import tree_leaves
    res, losses = {}, {}
    for policy in REMAT_POLICIES:
        cfg, params, batch, opt, step = flagship(tfm, bps, torch,
                                                 remat_policy=policy)
        print(f"  remat_policy={cfg.remat_policy}:")
        want = flash_want(48, 24, streaming=False)
        _, ms, peak = train(step, params, batch, [fa], torch, check, gpu,
                            want, steps=REMAT_STEPS, losses_out=losses,
                            key=policy)
        res[policy] = {"step_ms": ms, "peak_gib": peak}
        del params, batch, opt, step
        torch.cuda.empty_cache()
    worst = max(abs(a - b) / abs(b) for p in REMAT_POLICIES[1:]
                for a, b in zip(losses[p], losses["none"]))
    check(worst <= 1e-6, f"remat losses equal across policies: largest "
          f"relative difference from 'none' {worst:.3g} (<= 1e-6); "
          f"bit-equal: {[losses[p] == losses['none'] for p in REMAT_POLICIES]}")
    print("  remat: " + ", ".join(
        f"{p} {r['step_ms']:.3f} ms {r['peak_gib']:.2f} GiB"
        for p, r in res.items()))
    return res


def idle(busy, step_ms):
    return None if busy is None else 1 - busy / step_ms


def phase_driver(bps, tfm, fa, torch, check, gpu):
    """CrossBarrierDriver (max_in_flight 1 and 2) around the flagship step
    against a plain loop, each from the same weights and batch after one
    warm-up step; the device's idle share from one profiled plain step's
    busy time."""
    res = {}
    losses = {}
    want = flash_want(48, 24, streaming=False)
    for setting in ("plain", 1, 2):
        cfg, params, batch, opt, step = flagship(tfm, bps, torch)
        step(params, batch)                       # warm-up
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        if setting == "plain":
            losses[setting] = [float(step(params, batch))
                               for _ in range(DRIVER_STEPS)]
        else:
            drv = bps.CrossBarrierDriver(step, params, max_in_flight=setting)
            for _ in range(DRIVER_STEPS):
                drv.submit(batch)
            check(drv.finish() is params, f"max_in_flight={setting}: "
                  f"finish() returns the params")
            losses[setting] = drv.losses()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / DRIVER_STEPS
        got = {n: fa.launches[n] for n in want}
        check(got == {n: w * DRIVER_STEPS for n, w in want.items()},
              f"{setting}: flash launches {got} over {DRIVER_STEPS} steps")
        if setting == "plain":
            busy = phase_profile(step, params, batch, torch, ms)
        res[str(setting)] = {"step_ms": ms, "idle_share": idle(busy, ms)}
        print(f"  {setting}: {ms:.3f} ms a step, device idle share "
              f"{res[str(setting)]['idle_share']} ({gpu})")
        del params, batch, opt, step
        torch.cuda.empty_cache()
    for setting in (1, 2):
        worst = max(abs(a - b) / abs(b)
                    for a, b in zip(losses[setting], losses["plain"]))
        check(len(losses[setting]) == DRIVER_STEPS and worst <= 1e-6,
              f"max_in_flight={setting}: losses within {worst:.3g} relative "
              f"of the plain loop's (<= 1e-6); bit-equal: "
              f"{losses[setting] == losses['plain']}")
    print(f"  plain losses {losses['plain']}")
    return res


def phase_examples(torch, check, gpu):
    """The native examples with small arguments, on CUDA (their default)."""
    from byteps_tpu_torch.examples import (benchmark_cross_barrier,
                                           train_mnist, train_mnist_fp16)
    mnist = train_mnist.main(["--epochs", "1", "--batch-size", "512"])
    check(mnist["acc"] > 0.5, f"train_mnist: acc={mnist['acc']:.3f} above "
          f"chance (0.1)")
    fp16 = train_mnist_fp16.main(["--steps", "30"])
    check(fp16["last_loss"] < fp16["first_loss"],
          f"train_mnist_fp16: loss {fp16['first_loss']:.4f} -> "
          f"{fp16['last_loss']:.4f}")
    bench = benchmark_cross_barrier.main(["--steps", "30"])
    check(bench["params_rel_diff"] <= 1e-5,
          f"benchmark_cross_barrier: CrossBarrier vs DistributedOptimizer "
          f"params within {bench['params_rel_diff']:.3g} relative (<= 1e-5)")
    print(f"  benchmark_cross_barrier: baseline "
          f"{bench['baseline_steps_per_s']:.1f} steps/s, cross-barrier "
          f"{bench['cross_barrier_steps_per_s']:.1f} steps/s ({gpu})")
    return {"mnist": mnist, "fp16": fp16, "cross_barrier": bench}


def phase_hierarchical(bps, tfm, fa, torch, check, gpu, flagship_ms,
                       flagship_busy):
    """A world-of-one NCCL group and a (1, 1) two-level mesh: the
    flagship's gradient tree through the hierarchical reduce, then 5
    flagship steps under DistributedOptimizer(hierarchical=True)."""
    import tempfile
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.common.tree import tree_leaves
    from byteps_tpu_torch.ops import collectives
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdzv",
                                world_size=1, rank=0)
        try:
            mesh = bps.make_hierarchical_mesh(1)
            check(mesh.mesh_dim_names == ("dcn_dp", "ici_dp")
                  and tuple(mesh.shape) == (1, 1)
                  and mesh.device_type == "cuda",
                  f"make_hierarchical_mesh(1): {mesh}")
            cfg, params, batch, opt, step = flagship(tfm, bps, torch)
            tfm.loss_fn(params, batch, cfg).backward()
            grads = [p.grad.detach().clone() for p in tree_leaves(params)]
            del opt, step
            for p in tree_leaves(params):
                p.grad = None
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = collectives.hierarchical_tree_all_reduce(grads, mesh)
                torch.cuda.synchronize()
            events = prof.key_averages()
            # each bucket's range, by name (the profiler also lists its
            # annotation on the device)
            buckets = len({e.key for e in events
                           if e.key.startswith("byteps.bucket")})
            nccl = {f"{e.key[:60]} ({e.device_type.name})": e.count
                    for e in events if "nccl" in e.key.lower()}
            with collectives.local_mode():
                ref = collectives.bucketed_tree_all_reduce(grads)
            plan = collectives._plan_cache(
                tuple(g.numel() for g in grads),
                get_config().partition_bytes, 4, True).num_buckets()
            check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                  "hierarchical_tree_all_reduce over NCCL equals "
                  "bucketed_tree_all_reduce under local_mode() bit for bit")
            backends = {dist.get_backend(mesh.get_group(a))
                        for a in mesh.mesh_dim_names}
            check(buckets == plan and backends == {"nccl"},
                  f"{buckets} buckets == the plan's {plan}, over groups of "
                  f"backend {backends}; NCCL events {nccl}")
            del grads, out, ref
            opt = bps.DistributedOptimizer(
                torch.optim.AdamW(tree_leaves(params), lr=1e-4,
                                  weight_decay=1e-4),
                hierarchical=True, mesh=mesh)
            step = bps.build_train_step(lambda p, b: tfm.loss_fn(p, b, cfg),
                                        opt)
            check(not collectives.is_local() and opt.hierarchical,
                  "the hierarchical steps run outside local_mode()")
            want = flash_want(48, 24, streaming=False)
            _, steady, _ = train(step, params, batch, [fa], torch, check,
                                 gpu, want)
            busy = phase_profile(step, params, batch, torch, steady)
            res = {"buckets": buckets, "nccl_events": nccl,
                   "step_ms": steady, "idle_share": idle(busy, steady),
                   "flagship_step_ms": flagship_ms,
                   "flagship_idle_share": idle(flagship_busy, flagship_ms)}
            print(f"  hierarchical step {steady:.3f} ms, idle share "
                  f"{res['idle_share']} beside phase 4's {flagship_ms:.3f} "
                  f"ms, idle share {res['flagship_idle_share']} ({gpu})")
            del params, batch, opt, step
        finally:
            dist.destroy_process_group()
    return res


@contextlib.contextmanager
def world_of_one(torch):
    """A world-of-one process group, NCCL for CUDA tensors and gloo for CPU
    ones (file:// rendezvous in a temporary directory, gloo on loopback),
    destroyed on the way out."""
    import tempfile
    import torch.distributed as dist
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("cpu:gloo,cuda:nccl",
                                init_method=f"file://{tmp}/rdzv",
                                world_size=1, rank=0)
        try:
            yield dist
        finally:
            dist.destroy_process_group()


def phase_sharded(bps, tfm, fa, torch, check, gpu, flag4, flagship_ms,
                  flagship_busy):
    """15a: the flagship through build_sharded_train_step on make_mesh()
    (every axis 1), three ways, each 5 AdamW steps from phase 4's params
    and batch, held to phase 4's losses."""
    from byteps_tpu_torch.common.tree import tree_leaves
    mesh = bps.make_mesh()
    check(mesh.device_type == "cuda" and set(mesh.shape) == {1}
          and mesh.mesh_dim_names == ("pp", "dp", "ep", "sp", "tp"),
          f"make_mesh(): {mesh} (every axis 1 on one card)")
    want = flash_want(48, 24, streaming=False)

    def make(leaves):
        return torch.optim.AdamW(leaves, lr=1e-4, weight_decay=1e-4)
    res = {"flagship": {"step_ms": flagship_ms,
                        "idle_share": idle(flagship_busy, flagship_ms),
                        "peak_gib": flag4["peak"]}}
    for way in ("param_specs", "zero1", "fsdp"):
        cfg, params, batch, opt, step = flagship(tfm, bps, torch)
        del opt, step
        specs = tfm.param_specs(cfg)
        if way == "fsdp":
            specs = bps.fsdp_param_specs(params, mesh, base_specs=specs)
        params = bps.shard_params(params, mesh, specs)
        if way == "zero1":
            opt = bps.zero1_init(make, params, mesh, specs)
        elif way == "fsdp":
            opt = bps.fsdp_init(make, params, mesh, specs)
        else:
            opt = make(tree_leaves(params))
        step = bps.build_sharded_train_step(
            lambda p, b: tfm.loss_fn(p, b, cfg), opt, mesh, specs,
            zero1=way == "zero1", params=params)
        print(f"  {way}: {len(tree_leaves(params))} DTensor leaves on "
              f"{tree_leaves(params)[0].device_mesh}")
        losses = {}
        _, steady, peak = train(step, params, batch, [fa], torch, check, gpu,
                                want, losses_out=losses, key=way)
        busy = phase_profile(step, params, batch, torch, steady)
        gap = max(abs(a - b) / abs(b)
                  for a, b in zip(losses[way], flag4["losses"]))
        check(gap <= 1e-3, f"{way}: losses within {gap:.3g} relative of "
              f"phase 4's (<= 1e-3); bit-equal: "
              f"{losses[way] == flag4['losses']}")
        res[way] = {"step_ms": steady, "idle_share": idle(busy, steady),
                    "peak_gib": peak, "max_rel_gap": gap,
                    "bit_equal": losses[way] == flag4["losses"]}
        print(f"  {way}: {steady:.3f} ms a step, idle share "
              f"{res[way]['idle_share']}, peak {peak:.2f} GiB beside phase "
              f"4's {flagship_ms:.3f} ms, idle share "
              f"{res['flagship']['idle_share']}, peak {flag4['peak']:.2f} "
              f"GiB ({gpu})")
        del params, batch, opt, step
        torch.cuda.empty_cache()
    return res


def hybrid_flagship(hybrid, **over):
    """The hybrid config at the flagship's width (bert_large geometry,
    vocab 32768, seq 512, the streamed LM head), float32."""
    import dataclasses
    cfg = hybrid.HybridConfig(vocab_size=32768, num_layers=24, d_model=1024,
                              num_heads=16, d_ff=4096, max_seq_len=512,
                              ce_chunk_rows=2048)
    return dataclasses.replace(cfg, **over)


def hybrid_batch(torch, cfg, batch, seed=1):
    toks = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1),
                         generator=torch.Generator().manual_seed(seed))
    return toks[:, :-1], toks[:, 1:]


def phase_hybrid(bps, torch, check, gpu):
    """15b: the hybrid step at the flagship's width on make_mesh(), 3
    AdamW steps; then a 2-layer cut, one step at batch 1, on the card and
    on the CPU from the same params and tokens."""
    from byteps_tpu_torch.common.tree import tree_leaves, tree_paths
    from byteps_tpu_torch.models import hybrid

    def make(leaves):
        return torch.optim.AdamW(leaves, lr=1e-4, weight_decay=1e-4)
    cfg = hybrid_flagship(hybrid)
    mesh = bps.make_mesh()
    step, init_fn = hybrid.build_hybrid_train_step(cfg, make, mesh)
    params = init_fn(torch.Generator(mesh.device_type).manual_seed(0))
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"  hybrid: {n} params, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, batch 8 x seq {cfg.max_seq_len}, float32, ring "
          f"attention over sp=1, ce_chunk_rows={cfg.ce_chunk_rows}")
    batch = hybrid_batch(torch, cfg, 8)
    _, steady, peak = train(step, params, batch, [], torch, check, gpu, {},
                            steps=3)
    busy = phase_profile(step, params, batch, torch, steady)
    res = {"params": n, "step_ms": steady, "peak_gib": peak,
           "idle_share": idle(busy, steady)}
    del params, step
    torch.cuda.empty_cache()

    cut = hybrid_flagship(hybrid, num_layers=2)
    whole = hybrid.init_params(torch.Generator().manual_seed(2), cut,
                               device="cpu")
    batch = hybrid_batch(torch, cut, 1, seed=3)
    runs = {}
    for dev in (mesh.device_type, "cpu"):
        m = bps.make_mesh(device_type=dev)
        st, ini = hybrid.build_hybrid_train_step(cut, make, m)
        p = ini(whole)
        loss = float(st(p, batch))
        runs[dev] = (loss, [q.grad.detach().cpu() for q in tree_leaves(p)])
    (lc, gc), (lh, gh) = runs[mesh.device_type], runs["cpu"]
    rel = abs(lc - lh) / abs(lh)
    worst = max(((float((a - b).norm() / b.norm()), path) for a, b, path in
                 zip(gc, gh, tree_paths(whole))), key=lambda r: r[0])
    check(torch.backends.cuda.matmul.allow_tf32 is False and rel <= 1e-4
          and worst[0] <= 1e-4,
          f"2-layer cut, batch 1, one step, card vs CPU (TF32 off): loss "
          f"{lc:.6f} vs {lh:.6f} ({rel:.3g} relative), worst gradient "
          f"{worst[0]:.3g} relative L2 at {worst[1]} (<= 1e-4)")
    res.update({"cut_loss_rel": rel, "cut_grad_rel_l2": worst[0]})
    print(f"  hybrid step {steady:.3f} ms, idle share {res['idle_share']}, "
          f"peak {peak:.2f} GiB ({gpu})")
    return res


def phase_moe(bps, torch, check, gpu):
    """15c: Switch-MoE (8 experts, capacity factor 2, aux weight 0.01) at
    the flagship's width, 4 layers, 3 AdamW steps; the router's tokens
    past capacity counted."""
    from byteps_tpu_torch.models import hybrid
    from byteps_tpu_torch.parallel import expert

    def make(leaves):
        return torch.optim.AdamW(leaves, lr=1e-4, weight_decay=1e-4)
    cfg = hybrid_flagship(hybrid, num_layers=4, num_experts=8,
                          capacity_factor=2.0, aux_loss_weight=0.01)
    mesh = bps.make_mesh()
    step, init_fn = hybrid.build_hybrid_train_step(cfg, make, mesh)
    params = init_fn(torch.Generator(mesh.device_type).manual_seed(0))
    routed = []
    real = expert._dispatch_masks

    def counted(logits, e, c):
        out = real(logits, e, c)
        routed.append((logits.shape[0], out[0].sum()))
        return out
    batch = hybrid_batch(torch, cfg, 8)
    expert._dispatch_masks = counted
    try:
        _, steady, peak = train(step, params, batch, [], torch, check, gpu,
                                {}, steps=3)
    finally:
        expert._dispatch_masks = real
    busy = phase_profile(step, params, batch, torch, steady)
    tokens = sum(t for t, _ in routed)
    kept = int(sum(float(k) for _, k in routed))
    gate = float(params["layers"]["gate_w"].grad.abs().sum())
    check(gate > 0 and math.isfinite(gate),
          f"gate_w gradient |g|_1 = {gate:.4g} (nonzero, finite)")
    print(f"  MoE: {tokens - kept} of {tokens} tokens routed in 3 steps "
          f"({len(routed)} routings) dropped past capacity; step "
          f"{steady:.3f} ms, idle share {idle(busy, steady)}, peak "
          f"{peak:.2f} GiB ({gpu})")
    return {"dropped": tokens - kept, "routed": tokens, "step_ms": steady,
            "idle_share": idle(busy, steady), "peak_gib": peak,
            "gate_grad_l1": gate}


def rel_l2(a, b):
    """|a - b| / |b| in float64 over all elements."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def phase_sp(bps, tfm, fa, torch, check, gpu):
    """16a: llama_300m at seq 32,768 (phase 5's config, params and batch
    from the same seeds) through make_ulysses_attn_fn(sp group,
    attn="flash") on make_mesh() of a world of one: one forward and
    backward, its loss and gradients against the unsharded ones (the
    forward and backward of phase 5's step), its streaming launches, ms
    and peak; then ring at seq 4,096 against the unsharded forward."""
    from byteps_tpu_torch.common.tree import tree_leaves, tree_paths
    from byteps_tpu_torch.ops import ring_attention as ra
    B, S = LONG["batch"], LONG["seq"]
    cfg = tfm.get_config("llama_300m", causal=True, max_seq_len=S,
                         ce_chunk_rows=2048, attn_impl="flash",
                         attn_block=tfm.flash_auto_block(S))
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = tfm.synthetic_batch(torch.Generator().manual_seed(1), B, S, cfg)
    leaves = tree_leaves(params)
    group = bps.make_mesh().get_group("sp")
    uly = ra.make_ulysses_attn_fn(group, attn="flash")
    check(uly.sp_index == 0 and uly.sp_size == 1,
          f"the Ulysses adaptor on the sp group: block {uly.sp_index} of "
          f"{uly.sp_size}")

    def loss_and_grads(attn_fn):
        for p in leaves:
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.perf_counter()
        loss = tfm.loss_fn(params, batch, cfg, attn_fn=attn_fn)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return (float(loss.detach()), [p.grad.detach().clone()
                                       for p in leaves], ms,
                dict(fa.launches),
                torch.cuda.max_memory_allocated() / 2**30)
    lw, gw, ms_w, _, peak_w = loss_and_grads(None)
    lu, gu, ms_u, ran, peak_u = loss_and_grads(uly)
    bit = lu == lw and all(torch.equal(a, b) for a, b in zip(gu, gw))
    worst = max((rel_l2(a, b), path) for a, b, path in
                zip(gu, gw, tree_paths(params)))
    want = flash_want(2 * cfg.num_layers, cfg.num_layers, streaming=True)
    check({n: ran[n] for n in want} == want,
          f"Ulysses + flash, llama_300m [{B}, {S}] bf16, forward and "
          f"backward: launches {ran} (phase 5's a step: {want})")
    check(math.isfinite(lu) and abs(lu - lw) <= 1e-6 * abs(lw)
          and worst[0] <= 1e-5,
          f"Ulysses step vs the unsharded one: loss {lu!r} vs {lw!r}, "
          f"largest gradient relative L2 {worst[0]:.3g} at {worst[1]} "
          f"(<= 1e-5); bit-equal: {bit}")
    print(f"  Ulysses forward+backward {ms_u:.3f} ms, peak {peak_u:.2f} "
          f"GiB; unsharded {ms_w:.3f} ms, peak {peak_w:.2f} GiB ({gpu})")
    res = {"bit_equal": bit, "max_grad_rel_l2": worst[0],
           "launches": {n: ran[n] for n in want}, "ulysses_ms": ms_u,
           "unsharded_ms": ms_w, "ulysses_peak_gib": peak_u,
           "unsharded_peak_gib": peak_w}
    del gw, gu
    for p in leaves:
        p.grad = None
    torch.cuda.empty_cache()

    # Ring's blocks are dense: at S = 32,768 one layer's logits alone would
    # be 64 GiB.  In float32, so that bf16's rounding hides no fault.
    S2 = 4096
    cfg32 = tfm.get_config("llama_300m", causal=True, max_seq_len=S,
                           ce_chunk_rows=2048, attn_impl="flash",
                           dtype=torch.float32)
    toks = batch[0][:, :S2]
    ring = ra.make_ring_attn_fn(group)
    with torch.no_grad():
        hid = {name: tfm.forward_hidden(params, toks, cfg32, attn_fn=fn)
               for name, fn in (("ring", ring), ("flash", None),
                                ("dense", tfm.dense_attention))}
    to_dense = rel_l2(hid["ring"], hid["dense"])
    to_flash = rel_l2(hid["ring"], hid["flash"])
    flash_dense = rel_l2(hid["flash"], hid["dense"])
    check(all(bool(torch.isfinite(h).all()) for h in hid.values())
          and to_dense <= 1e-4 and to_flash <= 1e-4,
          f"ring (sp group of one), llama_300m [{B}, {S2}] float32, final "
          f"hidden states vs the unsharded forward: relative L2 "
          f"{to_flash:.3g} to flash, {to_dense:.3g} to dense attention "
          f"(flash to dense {flash_dense:.3g}; <= 1e-4)")
    res.update({"ring_vs_flash_rel_l2": to_flash,
                "ring_vs_dense_rel_l2": to_dense,
                "flash_vs_dense_rel_l2": flash_dense})
    del params, batch, hid
    return res


def phase_jax_examples(fa, bp, torch, check, gpu):
    """16b: the native counterparts of example/jax/* on the card, each
    main() with the JAX script's defaults except where one card needs
    otherwise: train_llama at llama_300m width (and again with --fsdp),
    train_long_context's ring over sp = 1 (the default 8 needs 8 ranks).
    The launch counters are set to 0 just before each and read just
    after."""
    from byteps_tpu_torch.core import native
    from byteps_tpu_torch.examples import (
        benchmark, elastic_benchmark, train_compressed,
        train_hybrid_parallel, train_imagenet_resnet, train_llama,
        train_long_context)
    llama = ["--model", "llama_300m", "--attn", "flash", "--seq-len", "512",
             "--batch-size", "8", "--steps", "3"]
    runs = [
        ("train_llama", train_llama, llama, RESIDENT),
        ("train_llama --fsdp", train_llama, llama + ["--fsdp"], RESIDENT),
        ("train_hybrid_parallel", train_hybrid_parallel, [], ()),
        ("train_long_context --sp 1", train_long_context, ["--sp", "1"], ()),
        ("train_long_context --attn flash", train_long_context,
         ["--attn", "flash"], ()),
        ("train_compressed", train_compressed, ["--compressor", "onebit"],
         ("sign_pack", "sign_unpack")),
        ("train_imagenet_resnet", train_imagenet_resnet, [], ()),
        ("benchmark", benchmark, [], ()),
        ("elastic_benchmark", elastic_benchmark, [], ()),
    ]
    res = {}
    for name, mod, args, needs in runs:
        if mod is elastic_benchmark:
            # its keys are a fresh process's: a fresh name registry
            native._core = None
        print(f"  -- {name}: main({args})")
        fa.reset_launches()
        bp.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mod.main(args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: v for n, v in {**fa.launches, **bp.launches}.items()
                    if v}
        if mod is benchmark:
            values, what = out["rates"], "rates finite and positive"
            ok = min(values) > 0
        elif mod is elastic_benchmark:
            values = [out["phase1_loss"], out["phase2_loss"]]
            what = "losses finite, falling across the resume"
            ok = values[1] < values[0]
        else:
            values, what = out["losses"], "losses finite, falling"
            ok = values[-1] < values[0]
        check(ok and all(math.isfinite(v) for v in values)
              and all(launches.get(n, 0) > 0 for n in needs),
              f"{name}: {secs:.3f} s, {what}; launches {launches}")
        res[name] = {"seconds": secs, "launches": launches}
    print(f"  examples on {gpu}")
    return res


def flagship_flops(cfg, batch, seq):
    """The flagship step's FLOPs, from the model: every matrix product
    forward, again in the recompute of each checkpointed block (torch's
    early stop leaves out the block's last product, mlp_out, whose output
    no backward needs), and twice in backward (the input's and the
    weight's gradient); the attention by its visible pairs (causal),
    4 · pairs · D forward (twice: forward and recompute), 6 for dQ and 8
    for dK/dV; the streamed LM head [N, D] x [D, V] forward, in its
    chunks' recompute and twice in backward."""
    n = batch * seq
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.head_dim
    qkv = 2 * n * d * (cfg.num_heads + 2 * cfg.kv_heads) * dh
    proj = 2 * n * cfg.num_heads * dh * d
    up = 2 * n * d * f
    down = 2 * n * f * d
    fwd = qkv + proj + up + down
    matmuls = cfg.num_layers * (fwd + (fwd - down) + 2 * fwd)
    pairs = batch * cfg.num_heads * seq * (seq + 1) // 2
    attn = cfg.num_layers * (2 * 4 + 6 + 8) * pairs * dh
    head = 4 * 2 * n * d * cfg.vocab_size
    return {"matmuls": matmuls, "attention": attn, "lm_head": head,
            "total": matmuls + attn + head}


@contextlib.contextmanager
def env_vars(**values):
    """``os.environ`` with ``values`` set, restored on the way out."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(port, route):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=10) as r:
        return r.read().decode()


def phase_observability(bps, tfm, fa, torch, check, gpu):
    """17a: the flagship of phase 4 under every worker-local plane
    (device plane, signal plane + doctor, metrics endpoint and log, a
    two-step trace window, postmortem bundles), then the same steps
    unarmed from the same seeds; 17b: the sentinel's negative control."""
    import tempfile
    from byteps_tpu_torch.common import devprof, flightrec, signals
    from byteps_tpu_torch.common.tree import tree_leaves
    B, S = FLAGSHIP["batch"], FLAGSHIP["seq"]
    want = flash_want(48, 24, streaming=False)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        s0 = bps.current_step()
        with env_vars(BYTEPS_TPU_DEVPROF=1, BYTEPS_TPU_DEVICE_PLATFORM="gpu",
                      BYTEPS_TPU_SIGNAL_WINDOW_S=OBS_WINDOW_S,
                      BYTEPS_TPU_METRICS_PORT=port,
                      BYTEPS_TPU_METRICS_LOG=f"{tmp}/metrics.jsonl",
                      BYTEPS_TRACE_ON=1, BYTEPS_TRACE_START_STEP=s0 + 2,
                      BYTEPS_TRACE_END_STEP=s0 + 3,
                      BYTEPS_TRACE_DIR=f"{tmp}/trace",
                      BYTEPS_TPU_POSTMORTEM_DIR=f"{tmp}/pm"):
            cfg, params, batch, opt, step = flagship(tfm, bps, torch)
            analytic = flagship_flops(cfg, B, S)
            bps.init()
            fa.reset_launches()
            losses, step_ms, per_step = [], [], []
            windows = []
            while len(losses) < OBS_MAX_STEPS:
                before = dict(fa.launches)
                t0 = time.perf_counter()
                loss = float(step(params, batch))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                bps.mark_step()
                losses.append(loss)
                per_step.append({n: fa.launches[n] - before[n] for n in want})
                prof = bps.get_device_profile()
                last = prof["last_window"] or {}
                if len(losses) == 1:
                    first = bps.get_key_signals()["window"]
                windows = bps.get_key_signals()["window"] - first
                if len(losses) >= OBS_MIN_STEPS and windows >= 2 \
                        and last.get("mfu") is not None:
                    break
            armed = [p.detach().clone() for p in tree_leaves(params)]
            n = len(losses)
            prof = bps.get_device_profile()
            mfu = prof["mfu"]
            cache = prof["cost_cache"]
            counted = cache["flops"][0] if cache["flops"] else None
            metrics = http_get(port, "/metrics")
            diag = json.loads(http_get(port, "/diagnosis"))
            dev_route = json.loads(http_get(port, "/device"))
            # One more step under torch.profiler, not part of the
            # comparison below.
            cap = devprof.active().capture(fn=lambda: step(params, batch))
            bps.shutdown()
            flightrec.disarm_postmortem()
            with open(f"{tmp}/trace/0/comm.json") as f:
                lanes = [e for e in json.load(f)["traceEvents"]
                         if e.get("ph") == "X" and e["pid"] >= 20000]
        steady_armed = statistics.median(step_ms[1:])
        ratio = counted / analytic["total"] if counted else float("nan")
        print(f"  armed: {n} steps, losses {losses}; windows closed "
              f"{windows}; step ms {[round(t, 3) for t in step_ms]}")
        print(f"  FLOPs a step: counted {counted}, analytic "
              f"{analytic['total']} (matmuls {analytic['matmuls']}, "
              f"attention {analytic['attention']}, LM head "
              f"{analytic['lm_head']}); counted/analytic {ratio:.6f}")
        check(prof["platform"] == "gpu"
              and not (prof["probe"] or {}).get("fallback")
              and prof["steps_total"] + cache["misses"] == n
              and cache["misses"] == 1 and cache["hits"] == n - 1,
              f"device profile: platform {prof['platform']} "
              f"({(prof['probe'] or {}).get('kind')}), fallback "
              f"{(prof['probe'] or {}).get('fallback')}, {prof['steps_total']}"
              f" timed steps + {cache['misses']} counted = {n} run")
        check(mfu is not None and 0.0 < mfu < 1.0,
              f"MFU {mfu} in (0, 1) on {gpu} (peak {prof['peak_flops']})")
        check(counted is not None and abs(ratio - 1.0) <= 0.10,
              f"counted FLOPs within 10% of the analytic count "
              f"({ratio:.6f})")
        check("bps_mfu{" in metrics and "bps_device_step_ms{" in metrics
              and dev_route.get("armed") is True,
              "/metrics carries bps_mfu and bps_device_step_ms; /device "
              "serves the profile")
        check(not any(f["rule"] == "device_fallback"
                      for f in diag.get("open", [])),
              f"/diagnosis: no open device_fallback (open: "
              f"{[f['rule'] for f in diag.get('open', [])]})")
        check(len(lanes) > 0, f"comm.json: {len(lanes)} device-lane events "
                              f"(pid >= 20000)")
        names = [e["name"] for e in cap["events"]]
        flash = {k: sum(k in nm for nm in names)
                 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        check(cap["ok"] and all(flash.values()),
              f"capture of one step: {len(names)} device events, flash "
              f"kernels {flash} ({cap['note'] or 'ok'})")
        check(all(p == want for p in per_step),
              f"launches per step {per_step[-1]} == {want} in every armed "
              f"step")
        busy = sum(e["dur_us"] for e in cap["events"]) / 1e3
        # The same steps unarmed, from the same seeds.
        del params, opt, step
        torch.cuda.empty_cache()
        cfg, params, batch, opt, step = flagship(tfm, bps, torch)
        plain = {}
        _, steady_plain, _ = train(step, params, batch, [fa], torch, check,
                                   gpu, want, steps=n, losses_out=plain,
                                   key="losses")
        same_params = all(torch.equal(a, b)
                          for a, b in zip(armed, tree_leaves(params)))
        check(plain["losses"] == losses and same_params,
              f"armed vs unarmed: losses bit-equal "
              f"{plain['losses'] == losses}, parameters bit-equal "
              f"{same_params}")
        print(f"  step ms armed {steady_armed:.3f} vs unarmed "
              f"{steady_plain:.3f} ({steady_armed / steady_plain - 1:+.2%});"
              f" device busy {busy:.3f} ms in the captured step, idle share"
              f" of the armed step {1 - busy / steady_armed:.4f}")
        print(f"  MFU {mfu} on {gpu}")
        res.update(steps=n, armed_ms=steady_armed, unarmed_ms=steady_plain,
                   busy_ms=busy, idle_share=1 - busy / steady_armed, mfu=mfu,
                   flops_counted=counted, flops_analytic=analytic["total"],
                   flops_ratio=ratio, device_lane_events=len(lanes))
        del params, opt, step, armed
        torch.cuda.empty_cache()

        print("== phase 17b: the sentinel's negative control")
        with env_vars(BYTEPS_TPU_DEVPROF=1, BYTEPS_TPU_DEVICE_PLATFORM="tpu",
                      BYTEPS_TPU_SIGNAL_WINDOW_S=3600,
                      BYTEPS_TPU_POSTMORTEM_DIR=f"{tmp}/pm2"):
            bps.init()
            signals.plane().roll()
            diag = bps.get_diagnosis()
            path = flightrec.dump_bundle("negative_control")
            bps.shutdown()
            flightrec.disarm_postmortem()
            with open(path) as f:
                extra = json.load(f)["extra"]
        crit = [f for f in diag["open"] if f["rule"] == "device_fallback"
                and f["severity"] == "critical"]
        check(len(crit) == 1, f"intended tpu on {gpu}: CRITICAL "
                              f"device_fallback ({crit[0]['summary'][:90]}"
                              f"...)" if crit else "no device_fallback")
        bundle_open = [f["rule"] for f in
                       (extra.get("diagnosis") or {}).get("open", [])]
        check(((extra.get("device") or {}).get("probe") or {}).get("fallback")
              is True and "device_fallback" in bundle_open,
              f"bundle carries the device section (fallback convicted) and "
              f"the diagnosis (open {bundle_open})")
    return res


def start_native_build():
    """Start the native host core's g++ build (phase 18a) in a thread
    beside the CUDA builds; returns a dict the thread fills with the
    library's path, its seconds and any error."""
    import threading
    from byteps_tpu_torch.core import build
    res = {}

    def run():
        t0 = time.perf_counter()
        try:
            res["path"] = build.build()
        except Exception as e:          # reported by phase 18a
            res["error"] = e
        res["seconds"] = time.perf_counter() - t0
    res["thread"] = threading.Thread(target=run, name="native-core-build")
    res["thread"].start()
    return res


def phase_ps_build(ps_build, check):
    """18a, first part: the native library of the port's copy of the C++
    sources, and the process's native core on it."""
    from byteps_tpu_torch.core import build, native
    ps_build["thread"].join()
    print(f"  {sh(['g++', '--version']).splitlines()[0]}; "
          f"flags {' '.join(build.CXX_FLAGS + build.LIB_FLAGS)}")
    err = ps_build.get("error")
    check(err is None and ps_build.get("path") == build.lib_path()
          and os.path.isfile(build.lib_path()),
          f"native core built from byteps_tpu_torch/core/{{core,server}}.cc "
          f"in {ps_build['seconds']:.1f} s (compile "
          f"{build.last_build_seconds} s, beside the CUDA builds) -> "
          f"{ps_build.get('path')}" + (f": {err}" if err else ""))
    if err is not None:
        return None
    core = native.get_native_core()
    check(isinstance(core, native._CCore) and native.is_native(),
          f"get_native_core() is {type(core).__name__}")
    return core


def flagship_buckets(bps, tfm, fa, torch, check):
    """One forward and backward of phase 4's flagship; its float32
    gradient buckets as phase 4b's compressed reduce forms them (the
    bucketed reduce's buffers, captured by its bucket transform), each
    with its priority (the highest leaf index among its members: the
    last leaves, which the backward pass gives first, go first)."""
    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.common.tree import tree_leaves, tree_paths
    from byteps_tpu_torch.ops import collectives
    cfg, params, batch, _, _ = flagship(tfm, bps, torch)
    names = tree_paths(params)
    leaves = tree_leaves(params)
    fa.reset_launches()
    loss = tfm.loss_fn(params, batch, cfg)
    grads = list(torch.autograd.grad(loss, leaves))
    launches = {n: fa.launches[n] for n in RESIDENT}
    bufs = []

    def capture(buf, bi):
        bufs.append(buf)
        return buf
    with collectives.local_mode():
        collectives.bucketed_tree_all_reduce(grads, bucket_transform=capture)
    sizes = [b.numel() for b in bufs]
    plan = collectives._plan_cache(tuple(g.numel() for g in grads),
                                   get_config().partition_bytes, 4, True)
    prios = [max(li for li, _, _ in b) for b in plan.buckets]
    print(f"  flagship forward and backward: loss {float(loss.detach()):.5f}, "
          f"{len(leaves)} leaves, flash launches {launches}; "
          f"{len(bufs)} float32 buckets, "
          f"{sum(sizes) * 4 / 2**30:.3f} GiB")
    check(len(bufs) == FLAGSHIP_BUCKETS and sizes == bps.compressor.reduce
          ._bucket_sizes(leaves, None) and all(b.dtype == torch.float32
                                               for b in bufs)
          and RAGGED_BUCKET in sizes and len(prios) == len(bufs),
          f"{FLAGSHIP_BUCKETS} float32 buckets as phase 4b forms them, the "
          f"ragged one ({RAGGED_BUCKET}) among them")
    check(all(launches[n] > 0 for n in RESIDENT)
          and math.isfinite(float(loss.detach())),
          "the gradients came through the flash kernels, loss finite")
    del loss, grads, params
    return names, [tuple(l.shape) for l in leaves], bufs, prios


def ps_partition_keys(core, names, shapes, sizes):
    """Declare the flagship's parameter names (phase 4's order), then its
    buckets; every 4 MiB partition of each becomes a partition key.
    Returns (declared keys, param partition keys, bucket partition keys
    as (key, bytes, bucket index), the buckets' partition bounds)."""
    part = 4 * 1024 * 1024
    core.reset_registry()
    declared = [core.declare_tensor(n) for n in names]
    declared += [core.declare_tensor(f"flagship.bucket{i}")
                 for i in range(len(sizes))]
    pkeys = []
    for k, shp in zip(declared, shapes):
        nbytes = 4 * math.prod(shp)
        pkeys += [core.encode_key(k, p) for p, _ in
                  enumerate(core.partition_bounds(nbytes, part))]
    bounds = [core.partition_bounds(4 * n, part) for n in sizes]
    bkeys = [(core.encode_key(declared[len(names) + i], p), ln, i)
             for i, bs in enumerate(bounds) for p, (_, ln) in enumerate(bs)]
    return declared, pkeys, bkeys, bounds


def drain_queue(core, bkeys, prios, credit):
    """The order a ScheduledQueue with ``credit`` bytes gives out the
    bucket partitions ``bkeys`` (at their bucket's priority), each
    partition finishing in the order it went out."""
    import collections
    q = core.queue_create(credit_bytes=credit)
    for key, nbytes, i in bkeys:
        q.add(key, prios[i], nbytes)
    order, inflight = [], collections.deque()
    while True:
        t = q.get()
        if t is None:
            if not inflight:
                return order
            q.report_finish(inflight.popleft())
            continue
        order.append(t[0])
        inflight.append(t[2])


def phase_ps_core(ccore, names, shapes, sizes, prios, check):
    """18a, second part: the native core and the Python core on the
    flagship's names and buckets.  18b: the ring on every partition key."""
    from byteps_tpu_torch.common import ring
    from byteps_tpu_torch.core import native
    pcore = native.Core()
    got = {}
    for label, core in (("native", ccore), ("python", pcore)):
        t0 = time.perf_counter()
        declared, pkeys, bkeys, bounds = ps_partition_keys(
            core, names, shapes, sizes)
        keys = pkeys + [k for k, _, _ in bkeys]
        hashes = {(h, n): [core.key_to_server(k, n, h) for k in keys]
                  for h in PS_HASHES for n in PS_SERVERS}
        order = drain_queue(core, bkeys, prios, PS_QUEUE_CREDIT)
        got[label] = (declared, keys, bounds, hashes, order, bkeys)
        print(f"  {label} core: {len(declared)} declared, {len(keys)} "
              f"partition keys, queue of {len(bkeys)} at a credit of "
              f"{PS_QUEUE_CREDIT >> 20} MiB ({time.perf_counter() - t0:.2f} "
              f"s)")
    n, p = got["native"], got["python"]
    for i, what in enumerate(("declared keys", "partition keys",
                              "the buckets' partition bounds at 4 MiB",
                              "key_to_server (djb2, sdbm, mixed, naive at "
                              "1, 2, 4, 8 servers)",
                              "the queue's order (credit of 4 partitions)")):
        check(n[i] == p[i], f"native core == Python core: {what}")
    keys, order = n[1], n[4]
    spread = {h: [n[3][(h, 4)].count(s) for s in range(4)]
              for h in PS_HASHES}
    print(f"  keys per server at 4 servers: {spread}")
    check(sorted(order) == sorted(k for k, _, _ in n[5]),
          f"the queue gave out every bucket partition once ({len(order)})")

    members = list(range(PS_RING["servers"]))
    table = ring.RingTable([(i, "127.0.0.1", 0) for i in members],
                           PS_RING["vnodes"])
    owners = [table.owner(k) for k in keys]
    check(owners == [ccore.ring_owner(k, members, PS_RING["vnodes"])
                     for k in keys],
          f"18b: RingTable.owner == bps_ring_owner for all {len(keys)} "
          f"partition keys ({PS_RING['servers']} servers, "
          f"{PS_RING['vnodes']} vnodes; keys per server "
          f"{[owners.count(s) for s in members]})")
    grown = table.with_server(len(members), "127.0.0.1", 0)
    moved = [k for k, o in zip(keys, owners) if grown.owner(k) != o]
    check(moved and all(grown.owner(k) == len(members) for k in moved),
          f"18b: a fifth server takes {len(moved)} keys "
          f"({len(moved) / len(keys):.3f} of them), every one of them moved "
          f"to the joiner")
    return keys


def ps_wire_kwargs(kwargs, n):
    """A config's kwargs for an n-element bucket (topk and randomk keep
    1% of it)."""
    if kwargs["compressor"] in ("topk", "randomk"):
        return {**kwargs, "k": str(max(1, n // 100))}
    return dict(kwargs)


class PopRecorder:
    """Stands in for ``heapq`` in the codec pool's module: records the
    (priority, key) of each job the pool takes off its heap, under the
    pool's lock, so the record is the order the jobs start in."""

    def __init__(self, log):
        import heapq
        self.log = log
        self._heapq = heapq
        self.heappush = heapq.heappush

    def heappop(self, heap):
        item = self._heapq.heappop(heap)
        if item[1] >= 0:                  # not a gate job
            self.log.append((-item[0], item[1]))
        return item


def run_pool(pool, jobs, order_out):
    """Run ``jobs`` ((priority, key, fn)) on ``pool``: its threads are held
    by gate jobs while every job is queued (in the given order), then
    released; returns the seconds from the release to the last job's end,
    and appends each job's (priority, key) to ``order_out`` as the pool
    takes it."""
    import threading
    from byteps_tpu_torch.server import codec_pool
    gate, held = threading.Event(), threading.Semaphore(0)
    done = threading.Semaphore(0)

    def gate_job():
        held.release()
        gate.wait(60)

    def wrap(fn):
        def run():
            try:
                fn()
            finally:
                done.release()
        return run
    for _ in range(pool.num_threads):
        pool.submit(1 << 30, -1, gate_job)
    for _ in range(pool.num_threads):
        held.acquire()
    for prio, key, fn in jobs:
        pool.submit(prio, key, wrap(fn))
    recorder = PopRecorder(order_out)
    codec_pool.heapq = recorder
    try:
        t0 = time.perf_counter()
        gate.set()
        for _ in jobs:
            done.acquire()
        secs = time.perf_counter() - t0
    finally:
        codec_pool.heapq = recorder._heapq
    return secs


def phase_ps_wire(torch, check, gpu, bufs, prios):
    """18c: each wire configuration on the flagship's gradient buckets,
    encoded and decoded through a CompressionPool, against the numpy
    codec on sampled buckets."""
    import random
    import struct
    import numpy as np
    from byteps_tpu_torch.core import native
    from byteps_tpu_torch.server import wire
    from byteps_tpu_torch.server.codec_pool import CompressionPool
    wire._CWIRE = False
    lib = wire._c_wire()
    check(wire.native_codec() and lib is native.get_native_core()._lib,
          "the wire runs the C codec of the port's library")
    if lib is None:
        return {}
    sizes = [b.numel() for b in bufs]
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + n)
    flat = torch.cat(bufs)
    cuda = flat.is_cuda
    host = torch.empty(flat.numel(), dtype=torch.float32, pin_memory=cuda)
    out_host = torch.empty_like(host, pin_memory=cuda)
    back = torch.empty_like(flat)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    host.copy_(flat, non_blocking=cuda)
    if cuda:
        torch.cuda.synchronize()
    d2h_ms = (time.perf_counter() - t0) * 1e3
    raw = flat.numel() * 4
    print(f"  {len(bufs)} buckets, {raw / 1e9:.3f} GB to the host in "
          f"{d2h_ms:.3f} ms ({raw / d2h_ms / 1e6:.1f} GB/s) ({gpu})")
    xs = [host.numpy()[offs[i]:offs[i + 1]] for i in range(len(sizes))]
    outs = [out_host.numpy()[offs[i]:offs[i + 1]] for i in range(len(sizes))]
    ragged = sizes.index(RAGGED_BUCKET)
    sampled = sorted({0, ragged, len(sizes) // 2})
    check(len(sampled) >= PS_SAMPLED and BUCKET in [sizes[i] for i in sampled],
          f"sampled buckets {sampled} (sizes {[sizes[i] for i in sampled]})")
    shuffled = list(range(len(sizes)))
    random.Random(0).shuffle(shuffled)
    want_order = sorted(((prios[i], i) for i in range(len(sizes))),
                        key=lambda pk: (-pk[0], pk[1]))
    pool = CompressionPool(PS_POOL_THREADS)
    res = {"d2h_ms": d2h_ms, "gb": raw / 1e9}
    try:
        for name, kwargs, rounds in PS_WIRE_CONFIGS:
            comps = [wire.WireCompressor(ps_wire_kwargs(kwargs, n))
                     for n in sizes]
            blobs = [None] * len(sizes)
            kept = {i: [] for i in sampled}
            enc_s, dec_s, h2d_s = [], [], []
            prev_err, orders, cap_ok, pm_ok, ef_ok = {}, [], True, True, True
            for r in range(rounds):
                prev_err = {i: c._err.get(i) for i, c in enumerate(comps)}

                def enc(i):
                    def run():
                        t = time.perf_counter()
                        blobs[i] = comps[i].encode(i, xs[i])
                        pool.record("ENCODE", int((time.perf_counter() - t)
                                                  * 1e6))
                    return run

                def dec(i):
                    def run():
                        t = time.perf_counter()
                        wire.decode(blobs[i], sizes[i], out=outs[i])
                        pool.record("DECODE", int((time.perf_counter() - t)
                                                  * 1e6))
                    return run
                order = []
                enc_s.append(run_pool(pool, [(prios[i], i, enc(i))
                                             for i in shuffled], order))
                orders.append(order)
                dec_s.append(run_pool(pool, [(prios[i], i, dec(i))
                                             for i in shuffled], []))
                t = time.perf_counter()
                back.copy_(out_host, non_blocking=cuda)
                if cuda:
                    torch.cuda.synchronize()
                h2d_s.append(time.perf_counter() - t)
                for i in sampled:
                    kept[i].append(blobs[i])
                cap_ok &= all(len(b) <= c.wire_cap_bytes(n) for b, c, n in
                              zip(blobs, comps, sizes))
                if kwargs["compressor"] == "onebit":
                    mu = np.float32(comps[0].momentum_mu)
                    for i, (b, d) in enumerate(zip(blobs, outs)):
                        (scale,) = struct.unpack_from("<f", b, 5)
                        pm_ok &= bool(np.all(np.abs(d) == np.float32(scale)))
                        corr = xs[i] + mu * comps[i]._mom[i]
                        if prev_err[i] is not None:
                            corr = corr + prev_err[i]
                        ef_ok &= bool(np.array_equal(comps[i]._err[i],
                                                     corr - d))
            wire_bytes = sum(len(b) for b in blobs)
            for k, order in enumerate(orders):
                check(order == want_order,
                      f"{name} round {k + 1}: the pool ({PS_POOL_THREADS} "
                      f"threads) took all {len(order)} encodes, queued in a "
                      f"shuffled order, by (priority desc, key asc)")
            check(cap_ok, f"{name}: every payload within wire_cap_bytes")
            check(torch.equal(back.cpu() if cuda else back,
                              out_host), f"{name}: decodes back on the card")
            if kwargs["compressor"] == "onebit":
                check(pm_ok, f"{name}: every decode is +-scale elementwise")
                check(ef_ok, f"{name}: every EF residual is exactly the "
                             f"corrected input (x + mu m + e) - decode, "
                             f"{rounds} rounds")
            # The numpy codec against the C codec on the sampled buckets.
            parity = True
            for i in sampled:
                kw = ps_wire_kwargs(kwargs, sizes[i])
                wire._CWIRE = None
                try:
                    c_np = wire.WireCompressor(kw)
                    blobs_np = [c_np.encode(i, xs[i]) for _ in range(rounds)]
                    dec_np = wire._decode_py(kept[i][-1], sizes[i])
                finally:
                    wire._CWIRE = lib
                dec_c = wire.decode(kept[i][-1], sizes[i])
                same = blobs_np == kept[i] and np.array_equal(
                    dec_np, dec_c, equal_nan=True)
                for st_np, st_c in ((c_np._err, comps[i]._err),
                                    (c_np._mom, comps[i]._mom)):
                    same &= sorted(st_np) == sorted(st_c) and all(
                        np.array_equal(st_np[k], st_c[k]) for k in st_np)
                parity &= same
            check(parity, f"{name}: numpy codec == C codec on buckets "
                          f"{sampled}: bytes of {rounds} round(s), EF and "
                          f"momentum state, decode, bit for bit")
            try:
                wire.decode(blobs[0][:len(blobs[0]) // 2], sizes[0])
                truncated = False
            except ValueError:
                truncated = True
            check(truncated, f"{name}: a truncated payload makes decode "
                             f"raise ValueError")
            enc_ms = statistics.median(enc_s) * 1e3
            dec_ms = statistics.median(dec_s) * 1e3
            h2d_ms = statistics.median(h2d_s) * 1e3
            ratio = wire_bytes / raw
            median = f"median of {rounds} rounds; " if rounds > 1 else ""
            print(f"  {name}: encode {enc_ms:.3f} ms, decode {dec_ms:.3f} "
                  f"ms, back to the card {h2d_ms:.3f} ms a step's gradients "
                  f"({PS_POOL_THREADS} pool threads; {median}"
                  f"rounds {[round(s * 1e3, 3) for s in enc_s]} / "
                  f"{[round(s * 1e3, 3) for s in dec_s]}); wire/raw "
                  f"{ratio:.6f} ({wire_bytes} of {raw} bytes) ({gpu})")
            res[name] = {"encode_ms": enc_ms, "decode_ms": dec_ms,
                         "h2d_ms": h2d_ms, "wire_over_raw": ratio}
        stats = pool.stats()
        print(f"  pool stats {stats}")
    finally:
        pool.close()
    return res


def phase_ps_server(check):
    """18d: ``python -m byteps_tpu_torch.server`` on a free port accepts a
    connection and runs the port's library."""
    import socket
    from byteps_tpu_torch.core import build
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, DMLC_PS_ROOT_PORT=str(port - 1),
               DMLC_SERVER_ID="0", DMLC_NUM_WORKER="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "byteps_tpu_torch.server"],
                            env=env, cwd=root, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        ok = False
        while time.perf_counter() - t0 < 30 and proc.poll() is None:
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                ok = True
                break
            except OSError:
                time.sleep(0.1)
        secs = time.perf_counter() - t0
        with open(f"/proc/{proc.pid}/maps") as f:
            libs = sorted({line.split()[-1] for line in f
                           if "libbyteps_core" in line})
        check(ok, f"18d: the port's server accepted a connection on port "
                  f"{port} after {secs:.2f} s")
        check(libs == [build.lib_path()],
              f"18d: the server runs the port's library {libs}")
    finally:
        proc.terminate()
        try:
            proc.wait(10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(10)
    err = proc.stderr.read().decode(errors="replace").strip()
    proc.stderr.close()
    if err:
        print(f"  server stderr: {err[-500:]}")


def phase_ps(bps, tfm, fa, torch, check, gpu, ps_build):
    """Phase 18: the base of the PS worker plane on the card machine."""
    t0 = time.perf_counter()
    print("== phase 18a: native core build; native == Python core on the "
          "flagship's names and buckets")
    ccore = phase_ps_build(ps_build, check)
    if ccore is None:
        return {}
    names, shapes, bufs, prios = flagship_buckets(bps, tfm, fa, torch,
                                                  check)
    sizes = [b.numel() for b in bufs]
    phase_ps_core(ccore, names, shapes, sizes, prios, check)
    print("== phase 18c: the PS wire on the flagship's gradients")
    res = phase_ps_wire(torch, check, gpu, bufs, prios)
    del bufs
    print("== phase 18d: the PS server entry")
    phase_ps_server(check)
    res["seconds"] = time.perf_counter() - t0
    print(f"  phase 18 in {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 19: PS-mode training on the card
# ---------------------------------------------------------------------------
def ps_named(params):
    from byteps_tpu_torch.common.tree import tree_leaves, tree_paths
    return list(zip(tree_paths(params), tree_leaves(params)))


def flat_host(tensors):
    """Every tensor as float32, in order, in one host array."""
    import torch
    return torch.cat([t.detach().reshape(-1).float() for t in tensors]
                     ).cpu().numpy()


def digest(arr):
    import hashlib
    return hashlib.sha256(arr.tobytes()).hexdigest()


def ps_worker(outdir: str, mode: str) -> int:
    """One PS-mode worker of phase 19 (``chip_smoke.py --ps-worker OUTDIR
    plain|onebit``; the job comes from the environment): phase 4's
    flagship with this worker's batch (seed 1 + rank), 3 AdamW steps
    through the Horovod face's DistributedOptimizer.  Writes
    ``result<rank>.json``; in ``plain`` mode also the first step's local
    gradients and pulled averages (``local<rank>.npz``,
    ``pulled<rank>.npz``)."""
    t_start = time.perf_counter()
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import byteps_tpu_torch as bps
    import byteps_tpu_torch.torch as hvd
    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.models import transformer as tfm
    from byteps_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()        # the CUDA context
    t_cuda = time.perf_counter()
    bps.init()
    t_init = time.perf_counter()
    rank = bps.rank()
    cfg, params, batch = flagship_model(tfm, torch, batch_seed=1 + rank)
    named = ps_named(params)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=1e-4, weight_decay=1e-4),
        named_parameters=named)
    sess = bps.get_ps_session()
    comp = {}        # declared key -> bytes of the compressed gradient
    if mode == "onebit":
        kwargs = {n: kw for n, kw, _ in PS_WIRE_CONFIGS}["onebit"]
        floor = get_config().min_compress_bytes
        comp = {bps.register_compressor("Gradient." + n, kwargs):
                p.numel() * 4 for n, p in named if p.numel() * 4 >= floor}
    res = {"rank": rank, "size": bps.size(), "mode": mode,
           "process_group": torch.distributed.is_initialized(),
           "compressed_keys": len(comp), "steps": [],
           "seconds": {"imports_cuda": t_cuda - t_start,
                       "init": t_init - t_cuda}}
    fa.reset_launches()
    for step in range(PS_TRAIN_STEPS):
        before = (dict(fa.launches), bps.get_staging_stats(),
                  bps.get_transport_stats()["lane_bytes_total"],
                  bps.get_codec_stats())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = tfm.loss_fn(params, batch, cfg)
        loss.backward()
        if step == 0 and mode == "plain":
            torch.cuda.synchronize()
            t_save = time.perf_counter()
            flat_host(p.grad for _, p in named).tofile(
                os.path.join(outdir, f"local{rank}.f32"))
            t0 += time.perf_counter() - t_save       # not the step's
        opt.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if step == 0 and mode == "plain":
            pulled = flat_host(p.grad for _, p in named)
            res["pulled_digest"] = digest(pulled)
            if rank == 0:
                pulled.tofile(os.path.join(outdir, "pulled0.f32"))
            del pulled
        st, cs = bps.get_staging_stats(), bps.get_codec_stats()
        res["steps"].append({
            "loss": float(loss), "ms": ms,
            "launches": {n: fa.launches[n] - before[0][n]
                         for n in RESIDENT},
            "to_host_ms": st["to_host_ms"] - before[1]["to_host_ms"],
            "to_device_ms": st["to_device_ms"] - before[1]["to_device_ms"],
            "staged_bytes": st["to_host_bytes"]
            - before[1]["to_host_bytes"],
            "lane_bytes": bps.get_transport_stats()["lane_bytes_total"]
            - before[2],
            "encode_ms": (cs["encode_busy_us"]
                          - before[3]["encode_busy_us"]) / 1e3,
            "decode_ms": (cs["decode_busy_us"]
                          - before[3]["decode_busy_us"]) / 1e3})
    stats = bps.get_server_stats()
    res["server"] = {"bytes_in": stats["bytes_in"],
                     "bytes_out": stats["bytes_out"],
                     "rounds": {k: v["completed_round"]
                                for k, v in stats["keys"].items()}}
    if comp:
        # Wire/raw of the compressed keys at the server: their pushed
        # bytes over the raw bytes of the same pushes.
        raw = wire = 0
        for dk, nbytes in comp.items():
            for pkey, _, ln, _ in sess._plan(dk, nbytes):
                row = stats["keys"].get(pkey) or {}
                wire += int(row.get("bytes", 0))
                raw += int(row.get("pushes", 0)) * ln
        res["wire_raw"] = wire / raw if raw else None
    res["digest"] = digest(flat_host(p for _, p in named))
    t_shut = time.perf_counter()
    bps.shutdown()
    res["seconds"]["shutdown"] = time.perf_counter() - t_shut
    res["seconds"]["total"] = time.perf_counter() - t_start
    with open(os.path.join(outdir, f"result{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def launch_ps_server(root_port, num_workers, extra=None):
    """The port's server through the launcher's server role, in its own
    process group (the launcher waits on the server it starts)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **(extra or {}), DMLC_ROLE="server",
               DMLC_SERVER_ID="0",
               DMLC_NUM_SERVER="1", DMLC_NUM_WORKER=str(num_workers),
               DMLC_PS_ROOT_PORT=str(root_port), PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch"], env=env,
        cwd=here, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)


def stop_group(proc):
    import signal
    try:
        os.killpg(proc.pid, signal.SIGTERM)
        proc.wait(15)
    except (ProcessLookupError, subprocess.TimeoutExpired):
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(15)


def wait_port(port, timeout=30.0, proc=None):
    import socket
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if proc is not None and proc.poll() is not None:
            return None
        try:
            socket.create_connection(("127.0.0.1", port), 1).close()
            return time.perf_counter() - t0
        except OSError:
            time.sleep(0.1)
    return None


def port_closed(port, timeout=15.0):
    import socket
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        try:
            socket.create_connection(("127.0.0.1", port), 0.5).close()
            time.sleep(0.2)
        except OSError:
            return True
    return False


def run_ps_workers(outdir, mode, check):
    """19a/19b: a server through the launcher, then the two workers;
    returns their results (None when a process failed)."""
    root_port = free_port()
    server = launch_ps_server(root_port, PS_WORKERS)
    try:
        up = wait_port(root_port + 1, proc=server)
        check(up is not None, f"{mode}: the launcher's server role listens "
                              f"on {root_port + 1}" + (
                                  f" after {up:.2f} s" if up else ""))
        if up is None:
            return None
        return spawn_ps_workers(outdir, ["--ps-worker", outdir, mode],
                                root_port, mode, check)
    finally:
        stop_group(server)


def spawn_ps_workers(outdir, args, root_port, tag, check, timeout=300):
    """PS_WORKERS processes of this script with ``args``, in PS mode on the
    server at ``root_port`` + 1; their ``<result|modes><rank>.json``, or
    None when one failed."""
    here = os.path.abspath(__file__)
    procs = []
    for wid in range(PS_WORKERS):
        env = dict(os.environ, BYTEPS_TPU_PS_MODE="1",
                   DMLC_NUM_WORKER=str(PS_WORKERS),
                   DMLC_WORKER_ID=str(wid), DMLC_NUM_SERVER="1",
                   DMLC_PS_ROOT_URI="127.0.0.1",
                   DMLC_PS_ROOT_PORT=str(root_port),
                   BYTEPS_TPU_SIGNAL_WINDOW_S="0",
                   BYTEPS_TPU_BARRIER_TIMEOUT_S="300",
                   BYTEPS_TPU_SPARSE_CACHE_ROWS="1000000",
                   BYTEPS_TPU_SPARSE_CACHE_TTL_MS="600000")
        log = open(os.path.join(outdir, f"{tag}{wid}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, here, *args], env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    ok = True
    for wid, (p, log) in enumerate(procs):
        try:
            rc = p.wait(timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        log.close()
        if rc != 0:
            ok = False
            with open(os.path.join(outdir, f"{tag}{wid}.log")) as f:
                print(f"  worker {wid} ({tag}) rc {rc}:\n{f.read()[-3000:]}")
        check(rc == 0, f"{tag}: worker {wid} exited 0")
    if not ok:
        return None
    name = "modes" if tag == "modes" else "result"
    out = []
    for wid in range(PS_WORKERS):
        with open(os.path.join(outdir, f"{name}{wid}.json")) as f:
            out.append(json.load(f))
    return out


def ps_report(mode, res, check, gpu, flagship_ms):
    """Checks and prints what both phase 19 modes share."""
    want = {"flash_fwd": 48, "flash_bwd_dq": 24, "flash_bwd_dkv": 24}
    for r in res:
        steps = r["steps"]
        ms = statistics.median(s["ms"] for s in steps[1:])
        losses = [s["loss"] for s in steps]
        check((r["rank"], r["size"], r["process_group"])
              == (res.index(r), PS_WORKERS, False),
              f"{mode}: worker {r['rank']} of {r['size']}, no process "
              f"group ({r['process_group']})")
        check(all(math.isfinite(l) for l in losses),
              f"{mode}: worker {r['rank']} losses finite {losses}")
        check(all(s["launches"] == want for s in steps),
              f"{mode}: worker {r['rank']} flash launches a step "
              f"{[s['launches'] for s in steps]} == {want}")
        secs = {k: round(v, 2) for k, v in r["seconds"].items()}
        print(f"  {mode} worker {r['rank']}: seconds {secs}; step ms "
              f"{[round(s['ms'], 3) for s in steps]}, median of steps 2-3 "
              f"{ms:.3f} (phase 4's {flagship_ms:.3f}); staging to host "
              f"{[round(s['to_host_ms'], 3) for s in steps]} ms, to the "
              f"card {[round(s['to_device_ms'], 3) for s in steps]} ms, "
              f"{steps[-1]['staged_bytes']} bytes staged a step; lane bytes "
              f"a step {[s['lane_bytes'] for s in steps]}; host encode "
              f"{[round(s['encode_ms'], 3) for s in steps]} ms, decode "
              f"{[round(s['decode_ms'], 3) for s in steps]} ms ({gpu})")
    rounds = sorted(set(res[0]["server"]["rounds"].values()))
    print(f"  {mode} server: {res[-1]['server']['bytes_in']} bytes in, "
          f"{res[-1]['server']['bytes_out']} out over {PS_TRAIN_STEPS} "
          f"steps of {PS_WORKERS} workers ("
          f"{res[-1]['server']['bytes_in'] / PS_TRAIN_STEPS / PS_WORKERS:.0f}"
          f" in a worker-step); completed rounds per key {rounds} over "
          f"{len(res[0]['server']['rounds'])} partition keys")
    check(rounds == [PS_TRAIN_STEPS],
          f"{mode}: every key completed {PS_TRAIN_STEPS} rounds")
    check(res[0]["digest"] == res[1]["digest"],
          f"{mode}: the two workers' parameters after step "
          f"{PS_TRAIN_STEPS} bit-equal")
    return {"step_ms": [statistics.median(s["ms"] for s in r["steps"][1:])
                        for r in res],
            "losses": [[s["loss"] for s in r["steps"]] for r in res],
            "to_host_ms": [r["steps"][-1]["to_host_ms"] for r in res],
            "to_device_ms": [r["steps"][-1]["to_device_ms"] for r in res],
            "lane_bytes": res[0]["steps"][-1]["lane_bytes"],
            "server_bytes_in": res[-1]["server"]["bytes_in"],
            "encode_ms": [r["steps"][-1]["encode_ms"] for r in res]}


def ps_pulled_exact(outdir, res, check):
    """19a: the pulled gradients of the first step are (g0 + g1) / 2 of the
    two workers' float32 local gradients, bit for bit: worker 0's held
    element by element, worker 1's by their digest."""
    import numpy as np

    def load(name):
        return np.fromfile(os.path.join(outdir, name), np.float32)
    want = (load("local0.f32") + load("local1.f32")) / np.float32(2)
    got = load("pulled0.f32")
    bad = int(np.count_nonzero(got != want)) if got.size == want.size \
        else -1
    check(got.size > 0 and bad == 0,
          f"19a: worker 0's {got.size} pulled gradient elements equal "
          f"(g0 + g1) / 2 bit for bit ({bad} differ)")
    check(res[1]["pulled_digest"] == res[0]["pulled_digest"] == digest(want),
          "19a: worker 1 pulled the same bits (SHA-256)")


def ps_control(tfm, torch, check, res):
    """19a's one-process control: the same params, both batches' gradients
    averaged here, AdamW; each worker's losses within 1e-3 relative of
    the control's on its batch."""
    cfg, params, b0 = flagship_model(tfm, torch, batch_seed=1)
    b1 = flagship_model(tfm, torch, batch_seed=2)[2]
    named = ps_named(params)
    leaves = [p for _, p in named]
    opt = torch.optim.AdamW(leaves, lr=1e-4, weight_decay=1e-4)
    losses = [[], []]
    for _ in range(PS_TRAIN_STEPS):
        grads = []
        for w, b in enumerate((b0, b1)):
            for p in leaves:
                p.grad = None
            loss = tfm.loss_fn(params, b, cfg)
            loss.backward()
            losses[w].append(float(loss))
            grads.append([p.grad for p in leaves])
        for p, g0, g1 in zip(leaves, *grads):
            p.grad = (g0 + g1) / 2
        opt.step()
    torch.cuda.synchronize()
    for w in range(PS_WORKERS):
        got = res["losses"][w]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, losses[w]))
        check(rel <= 1e-3,
              f"19a: worker {w} losses {got} within 1e-3 relative of the "
              f"control's {losses[w]} ({rel:.2e})")
    del params, opt


TINY_PS_SCRIPT = """
import time
t0 = time.perf_counter()
import torch
import byteps_tpu_torch as bps
import byteps_tpu_torch.torch as hvd
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.models import transformer as tfm
torch.zeros(1, device="cuda")
t1 = time.perf_counter()
bps.init()
t2 = time.perf_counter()
assert bps.get_ps_session() is not None
cfg = tfm.get_config("tiny")
params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
opt = hvd.DistributedOptimizer(torch.optim.AdamW(tree_leaves(params)))
batch = tfm.synthetic_batch(torch.Generator().manual_seed(1), 4, 64, cfg)
losses = []
for _ in range(2):
    opt.zero_grad()
    loss = tfm.loss_fn(params, batch, cfg)
    loss.backward()
    opt.step()
    losses.append(float(loss))
t3 = time.perf_counter()
bps.shutdown()
t4 = time.perf_counter()
assert all(l == l for l in losses), losses
print("tiny PS losses", losses, "seconds: imports and CUDA", round(t1 - t0, 2),
      "init", round(t2 - t1, 2), "steps", round(t3 - t2, 2), "shutdown",
      round(t4 - t3, 2))
"""


def start_ps_joint(outdir):
    """19c, started: the joint role running the server beside a 2-step
    tiny PS script (in the background of 19a's checks, which are not
    timed)."""
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(outdir, "tiny_ps.py")
    with open(script, "w") as f:
        f.write(TINY_PS_SCRIPT)
    root_port = free_port()
    env = dict(os.environ, DMLC_ROLE="joint", BYTEPS_TPU_PS_MODE="1",
               DMLC_NUM_WORKER="1", DMLC_NUM_SERVER="1",
               DMLC_PS_ROOT_PORT=str(root_port),
               BYTEPS_TPU_SIGNAL_WINDOW_S="0",
               PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch",
         sys.executable, script], env=env, cwd=here,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    return proc, root_port, time.perf_counter()


def finish_ps_joint(joint, check):
    """19c, checked: the script exited 0 and the joint role stopped its
    server."""
    proc, root_port, t0 = joint
    try:
        out, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        stop_group(proc)
        out = ""
    secs = time.perf_counter() - t0
    lines = [l for l in out.splitlines() if "tiny PS losses" in l]
    print(f"  joint role: rc {proc.returncode} in {secs:.1f} s; "
          f"{lines[-1] if lines else out[-1500:]}")
    check(proc.returncode == 0 and lines,
          "19c: DMLC_ROLE=joint ran the tiny PS script to exit 0")
    check(port_closed(root_port + 1),
          "19c: the joint role's server is gone after the script exits")


def phase_ps_train(tfm, torch, check, gpu, flagship_ms):
    """Phase 19: PS-mode training on the card."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    outdir = tempfile.mkdtemp(prefix="bps_ps_")
    out = {}
    try:
        print("== phase 19a: two PS workers on the card, the flagship "
              "through the Horovod face, summed by the port's server")
        res = run_ps_workers(outdir, "plain", check)
        print("== phase 19c: the joint role (beside 19a's checks)")
        joint = start_ps_joint(outdir)
        if res is not None:
            ps_pulled_exact(outdir, res, check)
            for name in ("local0.f32", "local1.f32", "pulled0.f32"):
                os.remove(os.path.join(outdir, name))
            out["plain"] = ps_report("plain", res, check, gpu, flagship_ms)
            ps_control(tfm, torch, check, out["plain"])
            torch.cuda.empty_cache()
        finish_ps_joint(joint, check)
        print("== phase 19b: the same with onebit on the PS wire")
        res = run_ps_workers(outdir, "onebit", check)
        if res is not None:
            out["onebit"] = ps_report("onebit", res, check, gpu,
                                      flagship_ms)
            ratio = res[0]["wire_raw"]
            out["onebit"]["wire_raw"] = ratio
            check(res[0]["compressed_keys"] > 0 and ratio is not None
                  and abs(ratio / PS_ONEBIT_RATIO - 1) <= 0.02,
                  f"19b: {res[0]['compressed_keys']} compressed keys, "
                  f"wire/raw {ratio} within 2% of phase 18c's "
                  f"{PS_ONEBIT_RATIO}")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 19 in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 20: the PS training modes on the card
# ---------------------------------------------------------------------------
def delta_recorder(sess, acc, absacc, ranges, spent):
    """Wrap ``sess``'s push calls so that every delta pushed on a key of
    ``ranges`` (declared key -> [(a, b)] in the flat parameter vector) is
    summed into ``acc`` (float64) and its magnitude into ``absacc``; the
    seconds this takes are added to ``spent["s"]``."""
    import numpy as np
    push_async, push_group = sess.push_pull_async, sess.push_pull_group

    def note(key, arr):
        t0 = time.perf_counter()
        off = 0
        for a, b in ranges.get(key, ()):
            d = np.asarray(arr, np.float32).ravel()[off:off + b - a]
            acc[a:b] += d
            absacc[a:b] += np.abs(d)
            off += b - a
        spent["s"] += time.perf_counter() - t0

    def push_pull_async(key, tensor, *args, seed=False, **kw):
        if not seed:
            note(key, tensor)
        return push_async(key, tensor, *args, seed=seed, **kw)

    def push_pull_group(items, *args, seed=False, **kw):
        if not seed:
            for key, arr, _ in items:
                note(key, arr)
        return push_group(items, *args, seed=seed, **kw)
    sess.push_pull_async = push_pull_async
    sess.push_pull_group = push_pull_group


def pull_async_stores(sess, keys, leaves):
    """Each leaf's async store (a zero delta pushed), adopted in place."""
    import numpy as np
    import torch
    handles = [(p, sess.push_pull_async(k, np.zeros(p.numel(), np.float32)))
               for k, p in zip(keys, leaves)]
    with torch.no_grad():
        for p, h in handles:
            p.copy_(torch.from_numpy(np.asarray(h.wait(), np.float32)
                                     ).reshape(p.shape))


def within_ulps(final, seed, accs, absaccs, additions, chunk=1 << 24):
    """The largest |final - (seed + sum of accs)| in float32 ulps of
    |seed| + the sum of absaccs, element by element (float64 sums);
    rounding ``additions`` times at most half an ulp each bounds it by
    additions / 2."""
    import numpy as np
    worst = 0.0
    for a in range(0, final.size, chunk):
        b = min(final.size, a + chunk)
        want = seed[a:b].astype(np.float64)
        mag = np.abs(want)
        for acc, absacc in zip(accs, absaccs):
            want += acc[a:b]
            mag += absacc[a:b]
        ulp = np.spacing(mag.astype(np.float32)).astype(np.float64)
        worst = max(worst, float(np.max(np.abs(final[a:b] - want) / ulp)))
    return worst


def async_part(tag, res, step, spent, torch, fa):
    """20a: ``step()`` (returning its loss) timed PS_ASYNC_STEPS-many
    times, less the delta accounting's ``spent["s"]``, with its flash
    launches."""
    steps = []
    for _ in range(PS_ASYNC_STEPS[tag == "trainer"]):
        before, acct = dict(fa.launches), spent["s"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        acct = spent["s"] - acct
        steps.append({"loss": loss, "accounting_ms": acct * 1e3,
                      "ms": (time.perf_counter() - t0 - acct) * 1e3,
                      "launches": {n: fa.launches[n] - before[n]
                                   for n in RESIDENT}})
    res[tag] = {"steps": steps}


def ps_modes_worker(outdir: str, sync_port: str) -> int:
    """One worker of phase 20 (``chip_smoke.py --ps-modes-worker OUTDIR
    SYNC_PORT``; the job, on the async server, comes from the
    environment; SYNC_PORT is the synchronous server's).  Writes
    ``modes<rank>.json``; worker 1 also its delta sums and embedding
    pushes for worker 0's checks."""
    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("phase 20 worker: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import byteps_tpu_torch as bps
    import byteps_tpu_torch.torch as hvd
    from byteps_tpu_torch.common.tree import tree_leaves, tree_unflatten
    from byteps_tpu_torch.models import transformer as tfm
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.server.client import _REQ, _RESP, PSSession
    from byteps_tpu_torch.server.wire import SPARSE_HDR
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bps.init()
    rank, sess = bps.rank(), bps.get_ps_session()
    res = {"rank": rank, "server_async": sess.server_async,
           "seconds": {"init": time.perf_counter() - t_start}}
    cfg, params, batch = flagship_model(tfm, torch, batch_seed=1 + rank)
    named = ps_named(params)
    leaves = [p for _, p in named]
    offs = np.concatenate([[0], np.cumsum([p.numel() for p in leaves])])
    seed = flat_host(leaves)
    acc = np.zeros(seed.size, np.float64)
    absacc = np.zeros(seed.size, np.float64)
    face_keys = [bps.declare("AsyncParam." + n) for n, _ in named]
    spent = {"s": 0.0}
    delta_recorder(sess, acc, absacc, {
        k: [(int(offs[i]), int(offs[i + 1]))]
        for i, k in enumerate(face_keys)}, spent)

    def loss_backward():
        loss = tfm.loss_fn(params, batch, cfg)
        loss.backward()
        return float(loss)

    # 20a, the face
    t0 = time.perf_counter()
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(leaves, lr=1e-4, weight_decay=1e-4),
        named_parameters=named, enable_async=True)
    fa.reset_launches()

    def face_step():
        opt.zero_grad()
        loss = loss_backward()
        opt.step()
        return loss
    async_part("face", res, face_step, spent, torch, fa)
    sess.barrier(1)
    pull_async_stores(sess, face_keys, leaves)
    res["face"]["digest"] = digest(flat_host(leaves))
    # 20a, AsyncPSTrainer over the same tree (its local step AdamW)
    trainer = bps.AsyncPSTrainer(sess, params, name="flagship")
    opt2 = torch.optim.AdamW(leaves, lr=1e-4, weight_decay=1e-4)

    def trainer_step():
        view = tree_leaves(trainer.params)
        with torch.no_grad():
            for p, v in zip(leaves, view):
                p.copy_(v)
        opt2.zero_grad()
        loss = loss_backward()
        opt2.step()
        t0 = time.perf_counter()
        d = flat_host([p.detach() - v for p, v in zip(leaves, view)])
        np.add(acc, d, out=acc)
        np.add(absacc, np.abs(d), out=absacc)
        spent["s"] += time.perf_counter() - t0
        trainer.step(params)
        return loss
    async_part("trainer", res, trainer_step, spent, torch, fa)
    trainer.finalize()
    if rank == 1:
        acc.tofile(os.path.join(outdir, "acc1.f64"))
        absacc.tofile(os.path.join(outdir, "abs1.f64"))
    sess.barrier(2)
    trainer.step(trainer.params)             # a zero delta: the store
    with torch.no_grad():                    # 20b starts from it
        for p, v in zip(leaves, tree_leaves(trainer.finalize())):
            p.copy_(v)
    final = flat_host(leaves)
    res["trainer"]["digest"] = digest(final)
    if rank == 0:
        res["trainer"]["ulps"] = within_ulps(
            final, seed, [acc, np.fromfile(os.path.join(
                outdir, "acc1.f64"), np.float64)],
            [absacc, np.fromfile(os.path.join(outdir, "abs1.f64"),
                                 np.float64)], 2 * sum(PS_ASYNC_STEPS))
    del acc, absacc, seed, final, trainer, opt, opt2
    res["seconds"]["20a"] = time.perf_counter() - t0

    # 20b, the server-resident optimizer on the synchronous server
    t0 = time.perf_counter()
    sync = PSSession(["127.0.0.1"], [int(sync_port)], worker_id=rank,
                     num_servers=1)
    for p in leaves:
        p.grad = None
    loss_backward()
    grads = tree_unflatten(params, [p.grad.detach() for p in leaves])
    res["serveropt"] = {}
    for mode in ("server", "local"):
        tr = bps.ServerOptTrainer(sync, params, PS_OPT, name=f"flag.{mode}",
                                  mode=mode, grad_scale=0.5)
        rounds = []
        for _ in range(PS_OPT_ROUNDS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = tr.step(grads)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            rounds.append({"ms": ms, "digest": digest(flat_host(
                tree_leaves(out)))})
        res["serveropt"][mode] = {
            "rounds": rounds, "opt_state_bytes": tr.opt_state_bytes(),
            "device": str(tr.device)}
        del tr, out
    stats = sync.server_stats()
    res["serveropt"]["opt_slot_bytes"] = sum(
        int(d.get("opt_slot_bytes", 0)) for d in stats["servers"].values())
    del grads
    res["seconds"]["20b"] = time.perf_counter() - t0

    # 20c, the embedding table on the synchronous server
    t0 = time.perf_counter()
    E = PS_EMBED
    table = bps.EmbeddingTable(sync, E["rows"], E["width"], name="emb",
                               opt_kwargs=E["opt"])
    frames = []
    request = sync._embed_request

    def counted(cmd, pkey, payload, *args, **kw):
        resp = request(cmd, pkey, payload, *args, **kw)
        frames.append(len(payload) + len(resp))
        return resp
    sync._embed_request = counted
    hot = np.random.default_rng(20).permutation(E["rows"])
    w = torch.randn(E["width"], generator=torch.Generator().manual_seed(21)
                    ).cuda() * 0.1
    rounds, pushed, pulled = [], {}, {}
    for r in range(E["rounds"]):
        rng = np.random.default_rng(1000 + 10 * rank + r)
        ids = hot[(rng.zipf(E["zipf"], E["ids"]) - 1) % E["rows"]]
        y = torch.from_numpy(rng.random(E["ids"]) < 0.5).float().cuda()
        t1 = time.perf_counter()
        rows = table.lookup(ids)
        t_lookup = time.perf_counter() - t1
        e = torch.from_numpy(rows).cuda().requires_grad_()
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            e @ w, y, reduction="sum")
        loss.backward()
        g = e.grad.cpu().numpy()
        del frames[:]
        t1 = time.perf_counter()
        out = table.push_pull(ids, g)
        t_pp = time.perf_counter() - t1
        uniq = int(np.unique(ids).size)
        heads = len(frames) * (_REQ.size + _RESP.size)
        rounds.append({
            "loss": float(loss), "lookup_s": t_lookup, "push_pull_s": t_pp,
            "touched": uniq, "frames": len(frames),
            "wire_bytes": sum(frames) + heads,
            # rows and indices both ways, the sparse headers, the version
            "want_bytes": uniq * 2 * (E["width"] * 4 + 4)
            + 2 * SPARSE_HDR.size + 8 + heads})
        pushed[f"ids{r}"], pushed[f"g{r}"], pulled[r] = ids, g, out
    del frames[:]
    t1 = time.perf_counter()
    warm = table.lookup(ids)
    res["embed"] = {"rounds": rounds, "warm_frames": len(frames),
                    "warm_lookup_s": time.perf_counter() - t1,
                    "warm_equal": bool(np.array_equal(warm, out)),
                    "table_bytes": table.table_bytes}
    if rank == 1:
        np.savez(os.path.join(outdir, "embed1.npz"), **pushed)
    sync.barrier(3)
    if rank == 0:
        res["embed"]["replay_equal"] = embed_replay(
            pushed, np.load(os.path.join(outdir, "embed1.npz")), pulled)
    stats = sync.server_stats()
    res["embed"]["server_table_bytes"] = int(stats["embed_table_bytes"])
    res["embed"]["opt_slot_bytes"] = sum(
        int(d.get("opt_slot_bytes", 0)) for d in stats["servers"].values())
    res["seconds"]["20c"] = time.perf_counter() - t0
    sync.close()
    bps.shutdown()
    res["seconds"]["total"] = time.perf_counter() - t_start
    with open(os.path.join(outdir, f"modes{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def embed_replay(mine, theirs, pulled):
    """20c: the server's row-wise Adagrad (EmbedUpdateStage, zero-initial
    rows) replayed in float32 over both workers' pushes, round by round;
    per round, whether worker 0's pulled rows equal the replay's."""
    import numpy as np
    kw = PS_EMBED["opt"]
    nlr = np.float32(-1.0 * kw["lr"])
    eps, acc0 = np.float32(1e-7), np.float32(0.1)
    width = PS_EMBED["width"]
    every = np.unique(np.concatenate(
        [src[f"ids{r}"] for src in (mine, theirs)
         for r in range(PS_EMBED["rounds"])]))
    P = np.zeros((every.size, width), np.float32)
    V = np.full((every.size, width), acc0, np.float32)
    equal = []
    for r in range(PS_EMBED["rounds"]):
        G = np.zeros_like(P)
        hit = np.zeros(every.size, bool)
        for src in (mine, theirs):
            # The client's wire form: unique rows, duplicates summed.
            uniq, inv = np.unique(src[f"ids{r}"], return_inverse=True)
            rows = np.zeros((uniq.size, width), np.float32)
            np.add.at(rows, inv, src[f"g{r}"])
            slot = np.searchsorted(every, uniq)
            G[slot] += rows
            hit[slot] = True
        s = V[hit] + G[hit] * G[hit]
        V[hit] = s
        scale = np.where(s > 0, np.float32(1.0) / np.sqrt(s + eps),
                         np.float32(0.0)).astype(np.float32)
        P[hit] = P[hit] + nlr * (scale * G[hit])
        got = pulled[r]
        equal.append(bool(np.array_equal(
            got, P[np.searchsorted(every, mine[f"ids{r}"])])))
    return equal


def phase_ps_modes(torch, check, gpu, flagship_ms):
    """Phase 20: the PS training modes on the card."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    outdir = tempfile.mkdtemp(prefix="bps_modes_")
    root_a = root_b = free_port()
    while abs(root_b - root_a) < 2:
        root_b = free_port()
    servers = [launch_ps_server(root_a, PS_WORKERS,
                                {"BYTEPS_ENABLE_ASYNC": "1"}),
               launch_ps_server(root_b, PS_WORKERS)]
    out = {}
    try:
        for root, srv in zip((root_a, root_b), servers):
            check(wait_port(root + 1, proc=srv) is not None,
                  f"20: a server listens on {root + 1}")
        res = spawn_ps_workers(outdir, ["--ps-modes-worker", outdir,
                                        str(root_b + 1)], root_a, "modes",
                               check, timeout=900)
        if res is not None:
            out = ps_modes_report(res, check, gpu, flagship_ms)
    finally:
        for srv in servers:
            stop_group(srv)
        shutil.rmtree(outdir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 20 in {out['seconds']:.1f} s")
    return out


def ps_modes_report(res, check, gpu, flagship_ms):
    """Phase 20's gates and numbers from the two workers' results."""
    want = {"flash_fwd": 48, "flash_bwd_dq": 24, "flash_bwd_dkv": 24}
    out = {}
    check(all(r["server_async"] for r in res),
          "20a: both sessions see BYTEPS_ENABLE_ASYNC servers")
    for part in ("face", "trainer"):
        for r in res:
            steps = r[part]["steps"]
            losses = [s["loss"] for s in steps]
            check(all(math.isfinite(l) for l in losses),
                  f"20a {part}: worker {r['rank']} losses finite {losses}")
            check(all(s["launches"] == want for s in steps),
                  f"20a {part}: worker {r['rank']} flash launches a step "
                  f"{[s['launches'] for s in steps]} == {want}")
            print(f"  20a {part} worker {r['rank']}: step ms "
                  f"{[round(s['ms'], 3) for s in steps]} (less the delta "
                  f"accounting's {[round(s['accounting_ms'], 3) for s in steps]}"
                  f"; phase 4's "
                  f"{flagship_ms:.3f}), losses {losses} ({gpu})")
        check(res[0][part]["digest"] == res[1][part]["digest"],
              f"20a {part}: both workers hold bit-equal weights after the "
              f"barrier")
        out[part + "_ms"] = [[s["ms"] for s in r[part]["steps"]]
                             for r in res]
    bound = sum(PS_ASYNC_STEPS)
    ulps = res[0]["trainer"]["ulps"]
    check(ulps <= bound,
          f"20a: the final weights are within {ulps:.3f} float32 ulps of "
          f"the seed plus every pushed delta summed in float64 (bound "
          f"{bound}: {2 * bound} additions, half an ulp each)")
    out["async_ulps"] = ulps
    so = [r["serveropt"] for r in res]
    for r, s in zip(res, so):
        for i in range(PS_OPT_ROUNDS):
            check(s["server"]["rounds"][i]["digest"]
                  == s["local"]["rounds"][i]["digest"],
                  f"20b: worker {r['rank']} round {i + 1}: server-mode and "
                  f"local-mode parameters bit-equal")
        check(s["local"]["device"].startswith("cuda")
              and s["server"]["opt_state_bytes"] == 0,
              f"20b: worker {r['rank']} local mode on {s['local']['device']}"
              f", server mode holds no optimizer state")
        print(f"  20b worker {r['rank']}: step ms server "
              f"{[round(x['ms'], 3) for x in s['server']['rounds']]}, local "
              f"{[round(x['ms'], 3) for x in s['local']['rounds']]}; "
              f"opt_state_bytes server {s['server']['opt_state_bytes']}, "
              f"local {s['local']['opt_state_bytes']}; server "
              f"opt_slot_bytes {s['opt_slot_bytes']} ({gpu})")
    check(so[0]["server"]["rounds"][-1]["digest"]
          == so[1]["server"]["rounds"][-1]["digest"],
          "20b: both workers hold the same parameters")
    out["serveropt_ms"] = {m: [[x["ms"] for x in s[m]["rounds"]]
                               for s in so] for m in ("server", "local")}
    out["opt_state_bytes"] = so[0]["local"]["opt_state_bytes"]
    out["opt_slot_bytes"] = so[0]["opt_slot_bytes"]
    E = PS_EMBED
    for r in res:
        em = r["embed"]
        for i, rd in enumerate(em["rounds"]):
            got, want_bytes = rd["wire_bytes"], rd["want_bytes"]
            check(abs(got / want_bytes - 1) <= 0.05 and rd["frames"] == 2,
                  f"20c: worker {r['rank']} round {i + 1}: {got} wire bytes "
                  f"in {rd['frames']} round trips for {rd['touched']} "
                  f"touched rows, within 5% of {want_bytes}")
        check(em["warm_frames"] == 0 and em["warm_equal"],
              f"20c: worker {r['rank']}'s warm lookup sent "
              f"{em['warm_frames']} frames")
        rates = [(E["ids"] / rd["push_pull_s"], E["ids"] / rd["lookup_s"])
                 for rd in em["rounds"]]
        print(f"  20c worker {r['rank']}: touched rows a round "
              f"{[rd['touched'] for rd in em['rounds']]}; push_pull rows/s "
              f"{[round(a) for a, _ in rates]}, lookup rows/s "
              f"{[round(b) for _, b in rates]} (first cold), warm lookup "
              f"{E['ids'] / max(em['warm_lookup_s'], 1e-9):.0f} rows/s; "
              f"losses {[rd['loss'] for rd in em['rounds']]}; "
              f"server table {em['server_table_bytes']} bytes, slots "
              f"{em['opt_slot_bytes']} ({gpu})")
        out.setdefault("embed_rows_s", []).append(rates)
    check(res[0]["embed"]["replay_equal"] == [True] * E["rounds"],
          f"20c: worker 0's pulled rows equal the float32 Adagrad replay "
          f"each round {res[0]['embed']['replay_equal']}")
    for r in res:
        print(f"  worker {r['rank']} seconds "
              f"{ {k: round(v, 2) for k, v in r['seconds'].items()} }")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import transformer as tfm
    from byteps_tpu_torch.ops import _build, flash_attention as fa
    from byteps_tpu_torch.ops.compressor import bitpack as bp

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    gpu = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    check = Checks()
    t_start = time.perf_counter()
    ps_build = start_native_build()

    print("== phase 1: build")
    f32_ptxas, hmma = phase_build([fa, bp], _build, torch, gpu, check)
    print("== phase 2: flash kernels vs plain versions")
    numbers, yardsticks = phase_kernels(fa, torch, check)
    print("== phase 2s: streaming flash kernels vs plain versions")
    s_numbers, s_yardsticks = phase_streaming(fa, torch, check)
    numbers.update(s_numbers)
    yardsticks.update(s_yardsticks)
    print("== phase 2b: sign-bit kernels vs plain versions")
    b_numbers, yardsticks["sign_unpack_floors"] = phase_bitpack(bp, torch,
                                                              check)
    numbers.update(b_numbers)
    print("== phase 2c: compressors, CUDA vs CPU copy")
    phase_compressors(bps.compressor, torch, check)
    print("== phase 3: tiny transformer, flash vs dense")
    phase_small_model(tfm, torch, check)
    print("== phase 4: flagship training (main path)")
    flag4 = {}
    launches, steady, busy = phase_flagship(bps, tfm, fa, torch, check,
                                            gpu, flag4)
    torch.cuda.empty_cache()
    print("== phase 4b: compressed flagship training (main path)")
    c_launches, c_steady, c_peak = phase_flagship_compressed(
        bps, tfm, fa, bp, torch, check, gpu, steady)
    launches.update({n: c_launches[n] for n in bp.launches})
    torch.cuda.empty_cache()
    print("== phase 5: llama_300m at seq 32768 (long-context main path)")
    l_launches, l_steady, l_peak = phase_long(bps, tfm, fa, torch, check,
                                              gpu)
    launches.update({n: l_launches[n] for n in STREAMING})
    torch.cuda.empty_cache()
    print("== phase 6: Ulysses at world 1, flash inner, seq 32768")
    phase_ulysses(fa, torch, check)
    torch.cuda.empty_cache()
    print("== phase 7: flash_attention_fn at every head dim, float16, "
          "B*H > 65,535 (coverage path)")
    path = phase_coverage(fa, tfm, torch, check)
    torch.cuda.empty_cache()
    print("== phase 8: bert_base width with head dim 96, bf16 and float16 "
          "(coverage path)")
    for key, n in phase_hd96(bps, tfm, fa, torch, check, gpu).items():
        path[key] = path.get(key, 0) + n
    print("== phase 9: the new instantiations against their plain versions, "
          "timed")
    new_kernels = []
    for tag, d in NEW_INSTANCES:
        i_numbers, i_yard = phase_instances(fa, torch, check, tag, d)
        numbers.update(i_numbers)
        yardsticks.update(i_yard)
        new_kernels += list(i_numbers)
    check(all(path.get(key, 0) > 0 for key in new_kernels),
          f"the coverage path launched every new instantiation: "
          f"{ {key: path.get(key, 0) for key in new_kernels} }")
    torch.cuda.empty_cache()
    print("== phase 10: flash above D = 256 (the wide kernels), float32, "
          "bf16, float16, both families")
    wide = phase_wide(fa, tfm, torch, check, f32_ptxas, hmma)
    wide_kernels = []
    for tag in ("bf16", "f16", "f32"):
        for d in WIDE_TIMED:
            i_numbers, i_yard = phase_instances(fa, torch, check, tag, d,
                                                long_shape=WIDE_LONG)
            numbers.update(i_numbers)
            yardsticks.update(i_yard)
            wide_kernels += list(i_numbers)
            torch.cuda.empty_cache()
    check(all(wide.get(key, 0) > 0 for key in wide_kernels),
          f"the wide path launched every timed instantiation: "
          f"{ {key: wide.get(key, 0) for key in wide_kernels} }")
    path.update(wide)
    new_kernels += wide_kernels
    f32_kernels = []
    for d in F32_INSTANCES:
        i_numbers, i_yard = phase_instances(fa, torch, check, "f32", d,
                                            long_shape=WIDE_LONG)
        numbers.update(i_numbers)
        yardsticks.update(i_yard)
        f32_kernels += list(i_numbers)
        torch.cuda.empty_cache()
    check(all(path.get(key, 0) > 0 for key in f32_kernels),
          f"the coverage path launched every timed float32 instantiation: "
          f"{ {key: path.get(key, 0) for key in f32_kernels} }")
    f32_report(fa, path, f32_ptxas, hmma, numbers, yardsticks, check)
    new_kernels += f32_kernels
    print("== phase 11: ResNet-50 training through DistributedOptimizer + "
          "build_train_step and through the Horovod face")
    grads, cnn_numbers = phase_cnn(bps, torch, check, gpu)
    yardsticks.update(cnn_numbers)
    torch.cuda.empty_cache()
    print("== phase 12: the eager API on CUDA tensors")
    phase_eager(bps, torch, check, grads)
    del grads
    torch.cuda.empty_cache()
    print("== phase 13: remat policies on the flagship")
    yardsticks["remat"] = phase_remat(bps, tfm, fa, torch, check, gpu)
    torch.cuda.empty_cache()
    print("== phase 14b: CrossBarrierDriver around the flagship step")
    yardsticks["cross_barrier_driver"] = phase_driver(bps, tfm, fa, torch,
                                                      check, gpu)
    torch.cuda.empty_cache()
    print("== phase 14c: the native examples on the card")
    yardsticks["examples"] = phase_examples(torch, check, gpu)
    torch.cuda.empty_cache()
    print("== phase 14a: hierarchical reduce over a world-of-one NCCL "
          "group, the flagship under DistributedOptimizer(hierarchical=True)")
    yardsticks["hierarchical"] = phase_hierarchical(
        bps, tfm, fa, torch, check, gpu, steady, busy)
    torch.cuda.empty_cache()
    print("== phase 15: parallelism beyond DP on a world-of-one group "
          "(every mesh axis 1 on one card: gpipe_spmd, the all-to-alls and "
          "the TP collectives are identities here; their parity across "
          "ranks is the CPU tests')")
    with world_of_one(torch):
        print("== phase 15a: the sharded step (DTensor) on the flagship")
        yardsticks["sharded"] = phase_sharded(bps, tfm, fa, torch, check,
                                              gpu, flag4, steady, busy)
        torch.cuda.empty_cache()
        print("== phase 15b: the hybrid step at the flagship's width")
        yardsticks["hybrid"] = phase_hybrid(bps, torch, check, gpu)
        torch.cuda.empty_cache()
        print("== phase 15c: Switch-MoE at the flagship's width")
        yardsticks["moe"] = phase_moe(bps, torch, check, gpu)
        torch.cuda.empty_cache()
        print("== phase 16a: sequence parallelism at llama_300m width "
              "(Ulysses + flash at seq 32768, ring at seq 4096)")
        yardsticks["sp"] = phase_sp(bps, tfm, fa, torch, check, gpu)
    torch.cuda.empty_cache()
    print("== phase 16b: the native counterparts of example/jax/*")
    yardsticks["jax_examples"] = phase_jax_examples(fa, bp, torch, check,
                                                    gpu)
    torch.cuda.empty_cache()
    print("== phase 17a: the observability planes armed on the flagship")
    yardsticks["observability"] = phase_observability(bps, tfm, fa, torch,
                                                      check, gpu)
    torch.cuda.empty_cache()
    yardsticks["ps"] = phase_ps(bps, tfm, fa, torch, check, gpu, ps_build)
    torch.cuda.empty_cache()
    yardsticks["ps_train"] = phase_ps_train(tfm, torch, check, gpu, steady)
    torch.cuda.empty_cache()
    print("== phase 20: the PS training modes (async PS, the server-resident "
          "optimizer, the embedding table)")
    yardsticks["ps_modes"] = phase_ps_modes(torch, check, gpu, steady)
    print(f"total {time.perf_counter() - t_start:.1f} s")

    if check.failures:
        print(f"chip_smoke: {len(check.failures)} check(s) failed:",
              file=sys.stderr)
        for f in check.failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                **numbers[name], "cuda_kernels": cuda_kernels(name)}
               for name, (source, replaces) in KERNELS.items()]
    kernels += [{"name": key, "route": "cuda", "source": FLASH_SOURCE,
                 "replaces": KERNELS[key.split("<")[0]][1],
                 "launches": path[key], **numbers[key],
                 "cuda_kernels": cuda_kernels(key)}
                for key in new_kernels]
    tokens = FLAGSHIP["batch"] * FLAGSHIP["seq"]
    l_tokens = LONG["batch"] * LONG["seq"]
    shapes = {**{n: FLAGSHIP for n in RESIDENT},
              **{n: LONG for n in STREAMING}}
    rates = {n: tflops(n, sh["batch"] * sh["heads"], sh["seq"],
                       sh["head_dim"], True, numbers[n]["ms"])
             for n, sh in shapes.items()}
    print(json.dumps({"flagship_step_ms": steady,
                      "flagship_tokens_per_s": tokens / steady * 1e3,
                      "compressed_step_ms": c_steady,
                      "compressed_tokens_per_s": tokens / c_steady * 1e3,
                      "compressed_peak_gib": c_peak,
                      "long_step_ms": l_steady,
                      "long_tokens_per_s": l_tokens / l_steady * 1e3,
                      "long_peak_gib": l_peak, "flash_tflops": rates,
                      **yardsticks}))
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ps-worker"]:
        sys.exit(ps_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--ps-modes-worker"]:
        sys.exit(ps_modes_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
