"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--phases device,build,kernels,...]

Phases, in order; each prints one JSON line and any failure ends the run
with a non-zero exit code:

  device   the card's name, and its name and power limit from nvidia-smi
  build    build the CUDA kernels from ``src/repro_torch/csrc`` into one
           library (one nvcc per source, started together, then a link)
  fsdp     (run right after build, while the card is empty) FSDP over
           "data": command-r-35b at full width in float32 on a (2, 1)
           mesh of 2 gloo ranks, one step's loss and grad norm at 1
           unit and the prefill at 2 units against one rank's; three
           dry-run cells in subprocesses that leave CUDA uninitialized;
           flash and its backward at the ranks' shape
  kernels  each CUDA kernel against its plain torch version on the card,
           bit for bit, over lengths, modes, counter offsets near 2^32
           and vote copies with and without a majority; the Montgomery
           multiply at L in {8, 32, 128, 256} limbs and 1..1024 rows with
           edge operands (some also against Python ints), at odd L of
           513 and 1021 (past the ladder's 511) in batches 1 and 7, and
           ``modexp_ints`` against ``pow`` at L = 128; the one-launch
           ladder ``mont_exp`` against the plain ladder and ``pow`` at L
           in {8, 32, 128, 256} and an odd L in batches 1, 7, 58, and at
           L = 128 with exponents of 0, 1, 64 and (against ``pow``) 2,374
           bits; flash
           attention in float32 (the CUDA-core kernel) and bf16 (the
           tensor-core kernel) (GQA groups 1, 2, 8, causal or not, window
           128, Sq = Skv in {77, 512, 2048}, Sq != Skv, qwen3's prefill
           shape and command-r's / qwen1.5's, 64 query heads over 8 KV
           heads, qwen3-moe's 64 over 4, jamba's 32 over 8,
           llama4-maverick's 40 over 8 at 12,288 tokens with its window
           of 8,192, hubert-xlarge's bidirectional 16 heads at head dim
           80 and ragged hd 80 cases, llama-3.2-vision's cross-attention
           of 2,048 queries over 4,096 media tokens at 64 over 8 heads and
           a ragged cross case) and the SSD scan (the kernel tests'
           shapes, S ragged against the kernel's 256-row chunk and S
           below one chunk, N in {8, 13, 128}, mamba2's prefill shape
           with B and C shared,
           jamba's 4 x 128 heads of N = 16 per head and in the model form,
           the model form also from a carried state h0) within FLASH_TOL
           / SSD_TOL of their plain versions
  main     the secure allreduce at full width -- n = 64 nodes, clusters
           of 4, ring schedule, r = 3, global masking, T = 2^22 float32
           per node -- through ``SecureAggregator.allreduce`` on the card:
           equal to the plain reference sum and to the plain-version run,
           executed wire bytes equal to ``cost``, kernel launch counts;
           then the digest transport and a flip adversary
  batched  ``allreduce_batched`` with S = 64 sessions of n = 16, T = 2^16
  service  the multi-session service on the card.  (a) the steady
           stream: 256 sessions of T = 2^16 a node at the main cell's
           protocol (n = 64, c = 4, ring, r = 3, global masking), batches
           of 16 rows, 4 GiB of contributions, sealed and pumped through
           the admission queue at depth 2 (the launch counts are read on
           this run: 1 / 15 / 1 a batch), then at depth 1 and on the
           plain versions -- every session equal across the three, a
           sample equal to a one-shot ``allreduce`` of its payload and
           seed, wire bytes equal to ``cost`` times the rows; sessions/s,
           the stage means of the obs registry, peak memory and the busy
           share of one profiled batch.  (b) mixed traffic: T in {1,000;
           5,000; 2^16; 2^20} with rows of 2^16 (the 2^20 session chunks
           across 16 rows and equals the monolithic allreduce bit for
           bit), pairwise-masked and digest sessions under their own
           batch keys, a Byzantine flip and an epoch advance while
           sessions are queued.  (c) dispatch chaos at p = 0.35 under
           seeds 0, 1, 2 and a poison session bisected out, at n = 8, T =
           16, S = 8, on the card and on the CPU: equal dead letters,
           quarantines and TickClock trace sha256, every revealed session
           equal to the fault-free run
  funcs    the secure functions and the tuner on the card.  (a) the verbs
           at the main cell's protocol (n = 64, values from the seed):
           ``histogram`` at 4,096 bins, ``median`` / ``minimum`` /
           ``maximum`` / ``quantile(q=0.9)`` on 65,536 grid steps (16
           bisection rounds) and ``topk(k=8)`` on 4,096 steps (12 rounds
           and a 4,096-wide readout), each equal to the numpy oracle on
           the quantized domain and to the plain-version run, executed
           bytes equal to ``cost(fn=...)``; ms and launches a round (the
           launch counts are read on these verbs).  (b) the polling
           deployment of ``launch.secure_polling``: 256 concurrent median
           polls on 1,024 steps and 64 histograms of 4,096 bins over
           ``build_overlay(256, 0.2, seed=42)`` in batches of 16 rows, 8
           joins and 8 leaves after the second round, on the card and on
           the CPU: every result equal to the oracle and to the CPU's,
           the same shared batches; function sessions/s, stage means, one
           profiled round.  (c) the tuner: the three decision signatures
           of ``BENCH_secure_agg.json`` through the service tuned and on
           the ring / full default (bytes equal to the rows and to the
           executed account; the digest vote's share of a tuned
           dispatch), the main cell's workload tuned (bytes equal to
           ``cost``, the sum equal to the plain reference sum) beside the
           untuned one, and ``tune="probe"`` at one signature.  (d)
           ``launch.secure_polling`` at its defaults and ``launch.serve_agg
           --fn median`` / ``--tune auto`` in this process, each with its
           own checks
  mesh     the distributed transports: 16 rank processes on the card over
           a gloo group (every wire staged through pinned host memory,
           the kernels in every rank), after the parent's port sim on the
           card: (a) ``SecureAggregator`` on the ``mesh`` backend at n =
           16, c = 4, ring, r = 3, global masking, T = 2^22 a node, each
           rank's row equal to the sim's by sha256, within the
           quantization bound of the plain sum, executed bytes equal to
           ``cost``, launches 1 / 3 / 1; (b) the ``manual`` backend on a
           rank-local dict of 2^22 elements in 64 chunks; (c) the digest
           transport with flips on nodes 0, 4, 8, 12, exact, and with
           flips on two members of every cluster (past what r = 3
           absorbs), equal to the sim under the same flips and unequal
           to the honest sum, which shows the flips reach the ranks; (d)
           ``allreduce_batched`` of S = 16 sessions of T = 2^16 by the
           distributed reveal; (e) the service on the mesh transport,
           every rank its own copy over the same calls: 4 batches of 16
           sessions of T = 2^16 at depth 2, every rank's rows equal to the
           parent's sim service by sha256, a hop fault recovered bit for
           bit, and dispatch chaos on the mesh tripping the breaker so the
           batch runs degraded on the sim; the slowest rank's seconds a
           batch; (f) a ``median`` on 1,024 steps and a ``histogram`` of 64
           bins on the ``mesh`` backend, every rank's result equal to the
           parent's sim on the card; (g) expert parallelism in its own
           spawn of 2 ranks: one MoE layer of qwen3-moe-235b at full
           width in float32, 64 experts a rank, ``moe_distributed`` on
           each rank's 2 x 512 tokens (two ``all_to_all`` exchanges of
           168 MB) and ``moe_distributed_replicated`` on one token (a
           float32 all-reduce), each rank's output within EP_TOL = 2e-4
           of ``moe_local`` over all 128 experts on the card, the bytes
           of each exchange; (g2) in the same spawn, the layer's backward
           at capacity 16 (nothing drops): the gradient of a seeded
           cotangent's loss with respect to each rank's tokens and its 64
           experts' three stacks, through ``moe_distributed`` and the
           exchange's backward, against ``moe_local`` over all 128 experts
           on both ranks' tokens, within EP_TOL of max(1, the largest
           |entry|).  Medians of 5 warm runs of (a) and (b) as
           the slowest rank's wall ms, each rank's wire ms and profiled
           kernel ms, peak memory per rank
  paillier threshold Paillier at full width (1024-bit n, fixed committed
           safe primes): 512 encrypted votes summed, partial decryption
           of c_t = 69 shares' first 58 on the card equal to Python
           ``pow`` and combined to the sum, with one ``mont_exp`` launch
           (the ladder) and one ``mont_mul`` (leaving the Montgomery
           domain); then the paper's DA protocol over a 512-node overlay
           with Step 4 on the card, exact and equal in every account to
           the ``pow`` run
  serve    ``repro_torch.launch.serve.serve`` at full width for
           qwen3-1.7b, mamba2-370m, command-r-35b, qwen1.5-110b, the MoE
           models qwen3-moe-235b-a22b, llama4-maverick-400b-a17b and
           jamba-v0.1-52b, and llama-3.2-vision-90b (its prompts with
           4,096 seeded media tokens, a cross-attention layer every
           fifth) (bf16, random weights from the seed, cast as drawn, an
           MoE layer's experts one at a time, qwen1.5's QKV biases seeded
           nonzero; command-r at all 40 units, qwen1.5 cut to 20 of its
           80, qwen3-moe to 12 of 94, llama4 to 1 of 12, jamba to 2 of 4,
           llama-vision to 6 of 20, SERVE_UNITS; the float32 check on the
           first 8 / 4 / 2 / 0 / 1 / 2 of them, SERVE_CHECK_UNITS): batch
           4, prompt 2048, 32 tokens; prefill seconds, decode tokens/s,
           peak memory of the kernel run and of the plain run; exactly
           one ``flash_attention`` call an attention layer (cross layers
           included) and one ``ssd`` call a Mamba2 layer in the prefill
           (28 for qwen3, 48 ``ssd`` for mamba2, 2 and 14 for jamba, 30
           for llama-vision) and none in decode; a float32 prefill
           through the kernels against the plain versions (last logits
           within LOGIT_TOL_F32) and its peak memory; the bf16 run on the
           plain versions (its logit error and token agreement); the
           cross layers' attention spans in the prefill's profile; for
           the MoE models, layer by layer, the share of (token, choice)
           pairs the kernel run and the plain run route alike, each run's
           dropped pairs and the router-logit gap at every flip, in bf16
           and float32; the MoE's spans in the prefill's profile; then
           hubert-xlarge, encoder-only, through ``launch.serve.encode``
           at all 48 units on 4 x 2,048 seeded frames (48
           ``flash_attention`` calls at head dim 80), its float32 forward
           at all 48 units against the plain versions within
           LOGIT_TOL_F32 over every position; the config widths against
           the reference's config files
  train    training on the card.  (a) the flash backward kernel against
           ``attention_bwd_ref`` on the same q, k, v, dO, o and L, the
           forward kernel's L against the plain L, and autograd through
           both kernels against autograd of ``attention_ref``, in float32
           and bf16 over GQA groups 1, 2 and 8, causal or not, window
           128, ragged Sq = Skv = 77, Sq = Skv in {512, 2048}, Sq != Skv
           qwen3's training shape, hubert-xlarge's (16 heads at hd 80,
           bidirectional), a ragged hd 80 case, llama-3.2-vision's cross
           shape (2,048 queries over 4,096 keys, 64 / 8 heads, no mask),
           a ragged non-causal case with Sq < Skv and qwen3-moe's
           training shape (64 / 4 heads, a GQA group of 16), within
           FLASH_BWD_TOL, each output's largest error beside its plain
           version's mean and largest |entry|; at the ragged windowed
           case and qwen3's, hubert's and the cross shape the kernel
           twice on the same inputs, bit-equal (FLASH_BWD_REPEAT).  (b) ``train_loop`` on qwen3-1.7b at full
           width (bf16 compute, float32 weights and AdamW moments,
           remat), batch 4 x 2,048 tokens: 4 plain steps, then 4 secure
           steps from the same init on a one-rank mesh (train_loop's
           default sync, the reference's single-device secure mode: n =
           4, clip 8, derived to n = 1; chunks of 2^22), each step's loss
           and seconds, tokens/s, each run's launches (a step: flash
           forward 56 with remat, backward 28, mask and unmask one a
           chunk) and peak memory, the secure losses within
           TRAIN_LOSS_TOL of the plain ones, one more secure step
           profiled (busy share, top kernels, the backward's three
           kernels by name, the sync's share of the
           step from their record_function spans on the device, no
           device-to-host copy of gradient size), and one step's local
           gradients synced through the kernels and through the plain
           versions, bit for bit.  (c) ``launch.byzantine_training`` at 8
           gloo ranks on the card (olmo-1b smoke, clusters of 4, r = 3,
           ranks 1 and 5 corrupt): the secure losses within 5e-3 of the
           baseline with ``vote_combine`` launched, the r = 1 control
           printed.  (d) the qwen3 smoke crashed at step 10 after a
           checkpoint at 8 and resumed: the last loss equal to the
           uninterrupted run's within 1e-5 relative.  (e) the SSD
           backward kernel against ``ssd_chunked_bwd_ref`` in float64 on
           the same card inputs and the forward kernel's y (SSD_BWD_CASES:
           S ragged against the 256-row chunk and below one chunk, N in
           {8, 13, 128}, P in {16, 32, 64}, with and without h0 and a
           final state's gradient, mamba2's training shape and jamba's
           128 heads of N = 16), each of
           dx, ddt, da, dB, dC and dinit within SSD_BWD_TOL of its largest
           |entry| (da, a cancelling sum, also within SSD_BWD_DA_UNIT of
           its summands' magnitude); two cases run twice, bit-equal
           (SSD_BWD_REPEAT).  (f)
           ``train_loop`` on mamba2-370m at full width (bf16 compute,
           float32 weights and AdamW moments, remat), batch 4 x 2,048: 3
           plain steps, then 3 secure steps from the same init on the
           one-rank mesh, each step's loss and seconds, tokens/s, peak
           memory and launches (a step: ``ssd`` 96 with remat, ``ssd_bwd``
           48), the secure losses within TRAIN_LOSS_TOL of the plain ones,
           one more plain step profiled (busy share, each SSD kernel by
           name, each of the backward's own kernels seen in it).  (g)
           ``train_loop`` on hubert-xlarge at full width and depth (48
           units, hd 80) on the stream's frames, and (i) on
           qwen3-moe-235b-a22b at full width, 1 of its 94 units
           (TRAIN_MOE_UNITS), capacity 1.25: 4 plain steps, then 4
           secure steps from the same init, batch 4 x 2,048, each step's
           loss and seconds, tokens/s, peak memory and launches (a step:
           one flash backward and two forwards an attention layer, mask
           and unmask one a chunk of the synced leaves; on one rank an
           expert stack syncs over no axis), hubert's secure losses
           within TRAIN_LOSS_TOL of the plain ones; then the first
           step's loss and gradients on the seeded weights and the first
           batch through the kernels and through the plain versions
           (``impl="torch"``, which launches no kernel) and through the
           plain versions in float32 compute: the loss and grad norm
           within TRAIN_LOSS_TOL relative, each attention layer's wq, wk
           and wv gradients (hubert's first and last unit) within the
           larger of TRAIN_LEAF_TOL and twice the plain bf16 run's own
           error against float32, as shares of their largest |entry|;
           qwen3-moe's at batch 2 (TRAIN_MOE_CHECK_BATCH), its later
           steps finite and reported, not gated; (i) runs with expandable
           allocator segments.  (h) llama-3.2-vision-90b at full width, 1
           of its 20 units (4 self layers and a cross layer to 4,096
           seeded media tokens): the loss and gradients of one step at
           batch 4 x 2,048 (twice, the second timed; 5 backward and 10
           forward flash calls), then the same comparison at batch 1,
           the cross layer's and the first self layer's wq, wk and wv
           leaf by leaf (the plain version's score tensors do not fit at
           batch 4)
  tp2      sequence parallelism, the vocabulary-parallel loss and the
           padded head split on gloo ranks of the card.  (d) one
           baseline step (AdamW) of qwen3-1.7b and of mamba2-370m at
           full width, 2 units, float32, 4 x 1,024 tokens, on a (1, 2)
           mesh with ``seq_parallel=True`` (the sequence's all-gathers
           and reduce-scatters and the loss's three all-reduces in the
           collective tally, no gather of the logits) and without it,
           loss and grad norm within TRAIN_LOSS_TOL relative of the
           one-rank step, each run's peak a rank; (e) llama4-maverick's
           two attention layers (attn_chunked, then attn) at full width
           in float32 on a (1, 16) mesh of 16 ranks, its 40 query heads
           padded to 48 (3 a rank): output and input gradient on 1 x
           2,048 seeded positions equal on every rank and within
           LOGIT_TOL_F32 of the unpadded layers on one rank, 2 flash
           and 2 backward launches a rank; flash and its backward at
           that rank shape (window 8,192 and full mask) against their
           plain versions and timed beside SDPA, the SSD scan at (d)'s
           mamba2 rank; (f) the same two layers' prefill of 1 x 10,240
           seeded positions and 16 decode steps through the serving
           path's unit prefill and decode, float32, on (1, 16), the KV
           cache cut on its positions over "model" (the reference's
           layout: every KV head, 1/16 of the positions a rank), against
           one rank with the whole cache within LOGIT_TOL_F32 of the
           largest entry, equal on every rank, a rank's cache bytes
           1/16 of one rank's, the cut's collectives by kind.  Where the
           mesh phase runs too, its 16 ranks run (e) and (f); where the
           tp phase runs, its 2 ranks run (d)
  launch   (a) ``launch.serve_agg --transport mesh`` at --overlay-n 192:
           16 rank processes on the card, 64 additive sessions of 2^16 and
           16 medians on 1,024 steps in batches of 16, each beside the
           same load on ``--transport sim`` in this process: every
           session exact, equal batch sizes and wire bytes, mask, unmask
           and vote launched in rank 0 and in the sim; (b)
           ``launch.quickstart.main`` on the card at its 60 steps: the
           loss falls, the tokens are in the vocabulary, mask, unmask and
           both flash kernels launched
  timing   CUDA-event medians of each kernel and its plain version at
           the main paths' shapes (the Montgomery multiply at the
           decryption's rows x 128 limbs and at 1056 x 128; the ladder at
           the decryption's rows, 128 limbs and exponent bits, beside the
           host loop of two ``mont_mul`` launches a bit it replaced, in
           turns, every row held against Python ``pow``, and its plain
           version over the first 64 exponent bits, held equal to the
           kernel over the same bits, its time scaled to the whole; flash
           attention and the SSD scan at the two models' prefill shapes
           (flash attention also at command-r's and qwen1.5's, H 64, the
           MoE models', H 64 over K 4, 32 over 8, 40 over 8, hubert's 16
           heads at hd 80, bidirectional, and llama-vision's cross
           attention, 2,048 queries over 4,096 keys, no mask; the SSD
           scan also at jamba's 128 heads of N = 16),
           with ``scaled_dot_product_attention`` timed beside flash
           attention as the library yardstick, the forward also with L
           written, the SSD scan also from a carried state, the flash
           backward at qwen3's, hubert's and the cross shape beside
           SDPA's backward, and
           the SSD backward at mamba2's training shape, for which no
           PyTorch call exists), and the end-to-end allreduce time

The last lines are the card's name and power limit, one JSON object
describing every kernel (``max_abs_err`` from the kernels phase,
``launches`` on its phase's path, ``mesh_launches_per_rank`` in the mesh
phase's (a), ``service_launches`` on the service phase's depth-2 stream,
``funcs_launches`` on the funcs phase's verbs,
``train_launches_secure_run`` on the train phase's (b) secure run,
``mamba2_train_launches_secure_run`` on (f)'s,
``serve_agg_mesh_rank0_launches`` on the launch phase's (a) mesh rank 0,
``quickstart_launches`` on its (b), the tp, tp2 and fsdp phases' rank
shapes, errors and launches a rank (tp2: flash and its backward timed
at its padded llama4 rank shape);
each null where its phase did not run; the two backwards' ``launches``
and ``max_abs_err`` come from the train phase, the SSD backward's
launches from (f)'s secure run),
and ``{"ok": true, "device": {...}}``.  Without
a CUDA device the script fails before printing any result.  Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import hashlib
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
# the kernels' work counts (bytes, operations) live in the package, so the
# kernel table's bounds and the dry run count the same work
from repro_torch.roofline.counts import (  # noqa: E402
    flash_bwd_work, flash_fwd_work, mask_work, mont_exp_work,
    mont_mul_work, ssd_bwd_bytes, ssd_bwd_flops, ssd_bwd_flops_at,
    ssd_bytes, ssd_flops, unmask_work, vote_work)

T_START = time.perf_counter()
PHASES = ("device", "build", "kernels", "main", "batched", "service",
          "funcs", "mesh", "paillier", "serve", "train", "tp", "tp2",
          "fsdp", "launch", "timing")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
# 32-bit lane operations issued per second: 132 SMs x 128 lanes x
# 1.98 GHz, half the 67 TFLOP/s float32 FMA rate (an FMA counts two FLOPs)
LANE_OPS_PER_S = 67e12 / 2
# 32-bit integer add, logical, shift and multiply on sm_90: 64 results
# per clock per SM, half the lane rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9
F32_FLOPS_PER_S = 67e12       # float32 FMA outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # dense bf16 on the tensor cores
# float32 products on the tensor cores in 3xTF32: three TF32 products
# (495 TFLOP/s dense) for each float32 one
F32_3XTF32_FLOPS_PER_S = 495e12 / 3
N_MAIN, C_MAIN, T_MAIN = 64, 4, 1 << 22
# mesh: one rank process per node of n = 16 on the one card (the
# reference's selftest size); (a)'s payload is the main cell's width, (b)
# chunks it at 2^16, (d) is S sessions of T_batch; (c) flips MESH_FLIP,
# one member a cluster, which the vote absorbs, and MESH_FLIP_OVER, two
# members a cluster, which it cannot
N_MESH = 16
MESH_SHAPE = {"T": 1 << 22, "chunk": 1 << 16, "S": 16, "T_batch": 1 << 16,
              "runs": 5, "svc_S": 16, "svc_T": 1 << 16, "svc_batches": 4,
              "svc_pool": 1 << 22, "f_steps": 1024, "f_bins": 64,
              "ep_ranks": 2, "ep_B": 2, "ep_S": 512}
# mesh (g): expert parallelism of one MoE layer of EP_ARCH at full width in
# float32 (64 experts a rank), each rank's output within EP_TOL of
# moe_local over all 128 experts (the reference's
# tests/test_distributed.py::test_moe_distributed_matches_local_2dev)
EP_ARCH = "qwen3-moe-235b-a22b"
EP_TOL = 2e-4
# mesh (g2)'s capacity factor: nothing drops, so a token's expert outputs
# do not depend on which rank's buffer it shares
EP_GRAD_CF = 16.0
MESH_FLIP = (0, 4, 8, 12)
MESH_FLIP_OVER = (0, 1, 4, 5, 8, 9, 12, 13)
# Two 512-bit safe primes, drawn once with the port's gen_safe_prime and
# checked with _is_probable_prime (p, q and (p-1)/2, (q-1)/2), so the
# full-width key's shapes are the same in every run
P_FULL = int("111531299176384119993107029701011476323755920436567491832802"
             "959801994646988251383599881439615493711226029845013473845590"
             "00205001755194658642705468360451339")
Q_FULL = int("878186117668736310300858909383076763157932463076984285209715"
             "629955658355845996269498822573048365775560191735401017213724"
             "2788396693560907591948552415465603")
N_OVERLAY, TAU_OVERLAY, KEY_BITS = 512, 0.3, 1024
C_THRESHOLD = 69              # threshold cluster of build_overlay(512, 0.3, 0)
N_DECRYPT = 58                # decryptors of a threshold decryption
# exponent bits of 2 Delta s_i at c_t = 69 and 1024-bit n (a share lies
# below n m): the ladder's length when the paillier phase does not run
DECRYPT_BITS = 1 + (math.factorial(C_THRESHOLD)).bit_length() + 2046
# serve: the repo's prefill_32k / decode_32k shapes cut in traffic, not in
# width, to fit one run beside the other phases
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
# widths of the reference's config files (src/repro/configs/qwen3_1p7b.py,
# mamba2_370m.py, command_r_35b.py, qwen15_110b.py, qwen3_moe_235b.py,
# llama4_maverick.py, jamba_v01_52b.py, llama32_vision_90b.py,
# hubert_xlarge.py), hard-coded: this script imports nothing of the
# package.  ``moe`` and ``ssm`` are the sub-configs' fields, ``pattern``
# the unit's (mixer, mlp) kinds
REFERENCE_WIDTHS = {
    "qwen3-1.7b": dict(d_model=2048, n_heads=16, n_kv_heads=8, hd=128,
                       d_ff=6144, vocab_size=151936, n_units=28, ssm=None,
                       qk_norm=True, tie_embeddings=True,
                       rope_theta=1_000_000.0, dtype="bfloat16"),
    "mamba2-370m": dict(d_model=1024, n_heads=16, n_kv_heads=16, hd=64,
                        d_ff=0, vocab_size=50280, n_units=48,
                        ssm=dict(d_state=128, d_conv=4, expand=2,
                                 head_dim=64, chunk=256),
                        tie_embeddings=True, dtype="bfloat16"),
    "command-r-35b": dict(d_model=8192, n_heads=64, n_kv_heads=8, hd=128,
                          d_ff=22528, vocab_size=256000, n_units=40,
                          ssm=None, norm="layernorm", attn_bias=False,
                          tie_embeddings=True, rope_theta=4_000_000.0,
                          dtype="bfloat16"),
    "qwen1.5-110b": dict(d_model=8192, n_heads=64, n_kv_heads=8, hd=128,
                         d_ff=49152, vocab_size=152064, n_units=80,
                         ssm=None, norm="rmsnorm", attn_bias=True,
                         tie_embeddings=False, rope_theta=1_000_000.0,
                         dtype="bfloat16", opt_state_dtype="bfloat16"),
    "qwen3-moe-235b-a22b": dict(
        d_model=4096, n_heads=64, n_kv_heads=4, hd=128, d_ff=1536,
        vocab_size=151936, n_units=94, pattern=[("attn", "moe")],
        qk_norm=True, tie_embeddings=False, rope_theta=1_000_000.0,
        ssm=None, moe=dict(n_experts=128, top_k=8, d_expert=1536,
                           capacity_factor=1.25, router_jitter=0.0,
                           n_shared_experts=0, d_shared=0,
                           dispatch_dtype=""),
        dtype="bfloat16", opt_state_dtype="bfloat16"),
    "llama4-maverick-400b-a17b": dict(
        d_model=5120, n_heads=40, n_kv_heads=8, hd=128, d_ff=8192,
        vocab_size=202048, n_units=12,
        pattern=[("attn_chunked", "dense"), ("attn_chunked", "moe"),
                 ("attn_chunked", "dense"), ("attn", "moe")],
        attn_window=8192, tie_embeddings=False, rope_theta=500_000.0,
        ssm=None, moe=dict(n_experts=128, top_k=1, d_expert=8192,
                           capacity_factor=1.25, router_jitter=0.0,
                           n_shared_experts=0, d_shared=8192,
                           dispatch_dtype=""),
        dtype="bfloat16", opt_state_dtype="bfloat16"),
    "jamba-v0.1-52b": dict(
        d_model=4096, n_heads=32, n_kv_heads=8, hd=128, d_ff=14336,
        vocab_size=65536, n_units=4,
        pattern=[("attn" if i == 3 else "mamba2",
                  "moe" if i % 2 == 1 else "dense") for i in range(8)],
        tie_embeddings=False,
        ssm=dict(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=256),
        moe=dict(n_experts=16, top_k=2, d_expert=14336,
                 capacity_factor=1.25, router_jitter=0.0,
                 n_shared_experts=0, d_shared=0, dispatch_dtype=""),
        dtype="bfloat16", opt_state_dtype="bfloat16"),
    "llama-3.2-vision-90b": dict(
        d_model=8192, n_heads=64, n_kv_heads=8, hd=128, d_ff=28672,
        vocab_size=128256, n_units=20,
        pattern=[("attn", "dense")] * 4 + [("cross_attn", "dense")],
        rope_theta=500_000.0, tie_embeddings=False, ssm=None, moe=None,
        frontend="vision_patches", n_media_tokens=4096, causal=True,
        decoder=True, dtype="bfloat16", opt_state_dtype="bfloat16"),
    "hubert-xlarge": dict(
        d_model=1280, n_heads=16, n_kv_heads=16, hd=80, d_ff=5120,
        vocab_size=504, n_units=48, pattern=[("attn", "dense")],
        causal=False, decoder=False, norm="layernorm", mlp_gated=False,
        attn_bias=True, frontend="audio_frames", n_media_tokens=0,
        ssm=None, moe=None, dtype="bfloat16"),
}
# the MoE archs, whose serve also reports how the kernel run and the
# plain run route
MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
             "jamba-v0.1-52b")
# depth cuts of the serve phase (units of the full config's 40 / 80; the
# widths stay the published ones).  The bf16 serve draws its weights cast
# unit by unit (``init_params(cast=True)``): command-r's 40 units are
# 60.6 GB, qwen1.5's 2.72 GB a unit beside 4.98 GB of table and head, so
# 20 units (59.3 GB) leave room for the plain run's float32 scores (4.3
# GB a tensor at 64 heads x 2,048^2).  The float32 check holds float32
# masters (2.89 / 5.50 GB a unit) and float32 scores, so it runs the
# first SERVE_CHECK_UNITS of the same units
# first SERVE_CHECK_UNITS of the same units.  The MoE models' bf16
# weights a unit: qwen3-moe 2.49 B params (its 12 units and 2.49 GB of
# table and head, 62.2 GB), llama4-maverick 32.97 B (one unit, 70.1 GB
# with its 4.1 GB of table and head; each MoE layer's expert stacks are
# drawn an expert at a time), jamba 12.73 B (2 units, 52.0 GB).  Their
# float32 checks: qwen3-moe 2 units (24.9 GB), jamba 1 (~53 GB);
# llama4-maverick none (one MoE layer's float32 stacks alone are 128 x 3
# x 5120 x 8192 x 4 B = 64.4 GB), so its kernels meet their plain versions
# in bf16 here and in float32 at its attention shape in the kernels phase
# llama-3.2-vision-90b: 4.28 B params a unit (8.56 GB in bf16: four
# self-attention layers and a cross-attention layer), 4.20 GB of table and
# head; the plain run's cross-attention holds two float32 score tensors
# of (4, 64, 2,048, 4,096), 8.6 GB each, at once.  6 of its 20 units
# (55.5 GB) leave ~7 GB of the card beside those 17.2 GB, the caches
# and the activations; 7 would not fit.  Its float32 check holds 17.1 GB
# of masters a unit and 8.4 GB of table and head: 2 units (42.6 GB and
# the same scores).  hubert-xlarge (0.95 B params) serves whole, its
# float32 check too.
SERVE_UNITS = {"command-r-35b": 40, "qwen1.5-110b": 20,
               "qwen3-moe-235b-a22b": 12, "llama4-maverick-400b-a17b": 1,
               "jamba-v0.1-52b": 2, "llama-3.2-vision-90b": 6}
SERVE_CHECK_UNITS = {"command-r-35b": 8, "qwen1.5-110b": 4,
                     "qwen3-moe-235b-a22b": 2,
                     "llama4-maverick-400b-a17b": 0, "jamba-v0.1-52b": 1,
                     "llama-3.2-vision-90b": 2}
# the QKV biases, zeros as drawn, are overwritten with seeded N(0, s^2)
# values before a serve (from their own generator, unit by unit, so the
# float32 check's units carry the served ones' biases), so the bias add
# runs on nonzero values
SERVE_BIAS_STD = 0.5
# train: qwen3-1.7b at full width on the serve phase's batch x tokens,
# train_loop for TRAIN_STEPS plain steps then as many secure ones from the
# same init; the secure sync is train_loop's default, the reference's
# single-device secure mode (n = 4, clip 8, derived to one node: mask,
# quantize and unmask active) in chunks of 2^22 elements; the secure
# losses within TRAIN_LOSS_TOL of the plain ones (the reference's
# tolerance, tests/test_train_e2e.py); (c) the
# byzantine training at BYZ_RANKS gloo ranks for BYZ_STEPS steps; (d) a
# crash at step 10 after a checkpoint at 8, resumed within RESTART_RTOL
TRAIN_STEPS = 4
MAMBA_STEPS = 3
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)
TRAIN_LOSS_TOL = 2e-3
TRAIN_MOE_UNITS = 1           # train (i): qwen3-moe units (of 94)
TRAIN_VISION_CHECK_BATCH = 1  # train (h): the batch of its plain check
TRAIN_MOE_CHECK_BATCH = 2     # train (i): the batch of its plain check
# (g)-(i): one step's gradients through the kernels against the plain
# versions, leaf by leaf for attention layers' wq, wk and wv: max |a - b|
# as a share of the plain leaf's largest |entry|, within the larger of
# TRAIN_LEAF_TOL and twice the plain bf16 run's own share against the
# plain run in float32 compute on the same weights and batch (if the
# kernels are no further from float32 than the plain versions, the two
# bf16 runs differ by at most twice that).  In bf16 compute each
# attention output and input gradient is rounded to bf16 (2^-8
# relative) in both runs, differently; wv's gradient sums those over the
# tokens (2e-2 is five bf16 ulps of its largest entry), but wq's and
# wk's pass through dS = P (dP - delta), which at a near-uniform softmax
# cancels, so their rounding shares are larger (1.9-4.8% at hubert's
# first and last unit, my chip run 7).  A wrong dQ, dK or dV moves a
# leaf by its own scale.
TRAIN_LEAF_TOL = 2e-2
BYZ_RANKS, BYZ_STEPS = 8, 4
RESTART_RTOL = 1e-5
# Tolerances of the float kernels against their plain versions on the
# card (max |a - b| <= atol + rtol |b|).  Flash attention: 1e-5 in float32
# -- both compute in float32, but the kernel's online softmax rescales its
# sums once per kv tile (up to 32 at S = 2048) and adds in another order
# than cuBLAS; 2e-2 in bf16, one bf16 rounding of the output (the kernel
# tests' tolerance).  SSD: the kernel tests' 5e-4 / 1e-3 (chunks of 256
# in the kernel, of the caller's chunk in the plain version, products in
# 3xTF32 on the tensor cores: other sums, at float32 accuracy).
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SSD_TOL = (5e-4, 1e-3)
# launch: ``serve_agg --transport mesh`` at --overlay-n 192 (16 slots: 16
# rank processes, mesh (e)'s count), an additive load of ``sessions`` of
# ``elems`` and a median load, each beside the same load on the sim; then
# the quickstart at its 60 steps
LAUNCH_SHAPE = {"overlay_n": 192, "batch": 16, "sessions": 64,
                "elems": 1 << 16, "median_sessions": 16, "steps": 1024,
                "quickstart_steps": 60}
# the full-width float32 prefill: last-position logits (of unit scale)
# through the kernels against the plain versions, after 28 or 48 layers
# whose residual streams carry the kernels' float32 rounding differences
LOGIT_TOL_F32 = 2e-3
# the timing phase's plain ladder runs over the first this many exponent
# bits of the decryption's (58 x 128 limbs), its time scaled to the whole
# (a host loop of the same two products a bit, so 64 bits give its rate;
# 256 took 27-36 s of the script)
PLAIN_LADDER_BITS = 64


def emit(obj) -> None:
    """Print one JSON line; a phase's line gets ``at_s``, the seconds
    since the script started, so each phase's share of the run shows."""
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|: int32 words compare as uint32 values."""
    if a.numel() == 0:
        return 0.0
    if a.dtype == torch.int32:
        a, b = a.to(torch.int64) & 0xFFFFFFFF, b.to(torch.int64) & 0xFFFFFFFF
    return float((a.double() - b.double()).abs().max())


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def words(rng, shape, dev) -> torch.Tensor:
    a = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(dev)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs a GPU")
    return {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi_line(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def phase_build() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.lib()
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "compiled": build.build_seconds is not None,
            "library": build.library_path().name,
            "sources": [src.name for src in build.SOURCES],
            "ptxas": build.build_log.strip().splitlines()}


def phase_kernels(rng, dev, errs: dict) -> dict:
    """Every kernel against its plain version on the same card inputs."""
    from repro_torch.kernels.secure_agg import ops
    scale, clip = 2.0 ** 20, 1.0
    checks = 0
    for T in (1, 77, 8193, 1 << 22):
        B = 2
        x = torch.from_numpy((rng.standard_normal((B, T), np.float32)
                              * 0.7)).to(dev)
        edges = torch.tensor([0.5, 1.5, -0.5, -2.5], device=dev) / scale
        x[:, :min(T, 4)] = edges[:min(T, 4)]
        seeds = rng.integers(0, 2 ** 32, size=B, dtype=np.uint32)
        agg = words(rng, (B, T), dev)
        for off in (0, 2 ** 32 - 50):
            offs = np.full(B, off, np.uint32)
            for mode, c, nids in (("mask", 0, [3, 9]), ("quantize", 0, [0, 1]),
                                  ("pairwise", 2, [0, 5]),
                                  ("pairwise", 4, [6, 13])):
                got = ops.mask_encrypt_batch_fn(x, nids, seeds, scale, clip,
                                                mode=mode, offsets=offs,
                                                cluster_size=c)
                want = ops.mask_encrypt_batch_fn(x, nids, seeds, scale, clip,
                                                 mode=mode, offsets=offs,
                                                 cluster_size=c,
                                                 impl="torch")
                errs["mask_encrypt"] = max(errs["mask_encrypt"],
                                           max_abs_err(got, want))
                check(torch.equal(got, want),
                      f"mask_encrypt T={T} mode={mode} c={c} off={off}")
                checks += 1
            for mode, n in (("mask", 1), ("mask", 64), ("dequantize", 64)):
                got = ops.unmask_decrypt_batch_fn(agg, n, seeds, scale,
                                                  mode=mode, offsets=offs)
                want = ops.unmask_decrypt_batch_fn(agg, n, seeds, scale,
                                                   mode=mode, offsets=offs,
                                                   impl="torch")
                errs["unmask_decrypt"] = max(errs["unmask_decrypt"],
                                             max_abs_err(got, want))
                check(torch.equal(got, want),
                      f"unmask_decrypt T={T} mode={mode} n={n} off={off}")
                checks += 1
        if T >= 8:
            checks += _check_nonfinite(x, seeds, scale, clip, errs)
        for r in (1, 3, 5):
            for majority in (False, True):
                copies = [words(rng, (B, T), dev) for _ in range(r)]
                if majority:
                    copies[:r // 2 + 1] = [copies[0]] * (r // 2 + 1)
                acc = words(rng, (B, T), dev)
                got = ops.vote_combine_batch_fn(copies, acc)
                want = ops.vote_combine_batch_fn(copies, acc, impl="torch")
                errs["vote_combine"] = max(errs["vote_combine"],
                                           max_abs_err(got, want))
                check(torch.equal(got, want),
                      f"vote_combine T={T} r={r} majority={majority}")
                checks += 1
    checks += _check_mont_mul(rng, dev, errs)
    flash = _check_flash(rng, dev, errs)
    ssd = _check_ssd(rng, dev, errs)
    torch.cuda.synchronize()
    return {"phase": "kernels", "checks": checks + flash + ssd,
            "equal": True, "flash_attention_checks": flash,
            "ssd_checks": ssd, "allow_tf32": False,
            "flash_tol": {str(k): v for k, v in FLASH_TOL.items()},
            "ssd_tol": SSD_TOL, "max_abs_err": errs}


def _check_nonfinite(x, seeds, scale: float, clip: float, errs: dict
                     ) -> int:
    """NaN, +-Inf and -0.0 elements, in every encrypt mode: the kernel
    equals its plain version on the card, and a NaN quantizes as 0 does
    (the reference's XLA conversion sends NaN to 0)."""
    from repro_torch.kernels.secure_agg import ops
    edge = torch.tensor([math.nan, math.inf, -math.inf, -0.0, math.nan,
                         0.25, math.nan, 0.0], device=x.device)
    x = x.clone()
    x[:, :8] = edge
    zeroed = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    checks = 0
    for mode, c, nids in (("mask", 0, [3, 9]), ("quantize", 0, [0, 1]),
                          ("pairwise", 4, [6, 13])):
        def enc(v, impl=None):
            return ops.mask_encrypt_batch_fn(v, nids, seeds, scale, clip,
                                             mode=mode, cluster_size=c,
                                             impl=impl)
        got = enc(x)
        want = enc(x, "torch")
        errs["mask_encrypt"] = max(errs["mask_encrypt"],
                                   max_abs_err(got, want))
        check(torch.equal(got, want), f"mask_encrypt NaN/Inf mode={mode}")
        check(torch.equal(got, enc(zeroed)), f"NaN quantizes to 0 ({mode})")
        if mode == "quantize":
            check(got[:, :8].tolist() == [[0, int(clip * scale),
                                           -int(clip * scale), 0, 0,
                                           int(0.25 * scale), 0, 0]] * 2,
                  "quantize of NaN / Inf / -0.0")
        checks += 2
    return checks


def within(got: torch.Tensor, want: torch.Tensor, atol: float,
           rtol: float) -> bool:
    g, w = got.double(), want.double()
    return bool(torch.isfinite(g).all()) and \
        bool(((g - w).abs() <= atol + rtol * w.abs()).all())


# (B, Sq, Skv, H, K, hd, causal, window): the kernel tests' shapes, then
# GQA groups 1, 2 and 8, causal or not, window 128, Sq = Skv in {77, 512,
# 2048}, Sq != Skv both ways (a window chunk past the keys leaves rows with
# no allowed key), qwen3-1.7b's prefill and the prefill of command-r-35b
# and qwen1.5-110b (64 query heads over 8 KV heads), then the MoE
# models': qwen3-moe-235b's (GQA group 16: 64 over 4), jamba's (32 over
# 8), and llama4-maverick's (GQA group 5: 40 over 8, window 8,192) at
# the serve's shape, where the window masks nothing, and at 12,288 tokens,
# where it masks (the plain version's float32 scores there are 24.2 GB a
# copy, two alive at once); then the frontend models': hubert-xlarge's
# bidirectional prefill at head dim 80 (B 4, S 2,048, 16 heads), ragged
# hd 80 cases (GQA 1 and 2, causal, bidirectional, windowed with Sq !=
# Skv), llama-3.2-vision's cross-attention (2,048 queries over 4,096
# media tokens, 64 / 8 heads, no mask; the plain version's float32 scores
# are 8.6 GB a copy) and a ragged cross case
FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, True, 0), (1, 128, 128, 2, 2, 32, False, 0),
    (1, 512, 512, 4, 1, 64, True, 128), (2, 128, 384, 2, 1, 32, True, 0),
    (1, 256, 256, 8, 8, 16, True, 0),
    (2, 77, 77, 8, 8, 128, True, 0), (2, 77, 77, 8, 4, 128, False, 0),
    (2, 77, 77, 8, 1, 128, True, 128), (2, 512, 512, 16, 16, 128, False, 0),
    (2, 512, 512, 16, 8, 128, True, 128), (1, 512, 512, 16, 2, 128, True, 0),
    (1, 2048, 2048, 16, 8, 128, True, 0), (1, 2048, 2048, 8, 1, 128, False, 0),
    (1, 2048, 2048, 16, 16, 128, True, 128), (2, 200, 77, 4, 2, 64, True, 64),
    (4, 2048, 2048, 16, 8, 128, True, 0),
    (4, 2048, 2048, 64, 8, 128, True, 0),
    (4, 2048, 2048, 64, 4, 128, True, 0),
    (4, 2048, 2048, 32, 8, 128, True, 0),
    (4, 2048, 2048, 40, 8, 128, True, 8192),
    (1, 12288, 12288, 40, 8, 128, True, 8192),
    (4, 2048, 2048, 16, 16, 80, False, 0),
    (2, 77, 77, 4, 4, 80, True, 0), (2, 77, 77, 4, 2, 80, False, 0),
    (2, 200, 77, 4, 2, 80, True, 64),
    (4, 2048, 4096, 64, 8, 128, False, 0),
    (2, 77, 200, 8, 2, 128, False, 0),
]


def _check_flash(rng, dev, errs: dict) -> int:
    """``flash_attention`` against its plain version on the card."""
    from repro_torch.kernels.flash_attention import flash_attention
    checks = 0
    by_dtype = errs.setdefault("flash_attention_by_dtype", {})
    for B, Sq, Skv, H, K, hd, causal, window in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (B, S, n, hd), np.float32)).to(dev, dtype)
                for S, n in ((Sq, H), (Skv, K), (Skv, K)))
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention(q, k, v, causal=causal, window=window,
                                   impl="torch")
            err = max_abs_err(got.float(), want.float())
            errs["flash_attention"] = max(errs["flash_attention"], err)
            by_dtype[str(dtype)] = max(by_dtype.get(str(dtype), 0.0), err)
            tol = FLASH_TOL[dtype]
            check(got.dtype == dtype and within(got, want, tol, tol),
                  f"flash_attention {dtype} B={B} Sq={Sq} Skv={Skv} H={H} "
                  f"K={K} hd={hd} causal={causal} window={window}: max err "
                  f"{max_abs_err(got.float(), want.float())}")
            checks += 1
    return checks


# (B, Sq, Skv, H, K, hd, causal, window) of the backward: GQA groups 1, 2
# and 8, causal or not, window 128, ragged Sq = Skv = 77, Sq = Skv in
# {512, 2048}, each head dim, Sq != Skv with rows that have no allowed key,
# qwen3-1.7b's training shape, hubert-xlarge's (16 heads at hd 80,
# bidirectional), a ragged hd 80 case, llama-3.2-vision's cross shape
# (2,048 queries over 4,096 media keys, 64 / 8 heads, no mask), a ragged
# non-causal case with Sq < Skv and qwen3-moe-235b's training shape (64
# query heads over 4 KV heads: a GQA group of 16, causal)
FLASH_BWD_HUBERT = (4, 2048, 2048, 16, 16, 80, False, 0)
FLASH_BWD_CROSS = (4, 2048, 4096, 64, 8, 128, False, 0)
FLASH_BWD_QWEN3_MOE = (4, 2048, 2048, 64, 4, 128, True, 0)
FLASH_BWD_CASES = [
    (2, 77, 77, 8, 8, 128, True, 0), (2, 77, 77, 8, 4, 64, False, 0),
    (1, 77, 77, 8, 1, 32, True, 16), (1, 256, 256, 8, 8, 16, True, 0),
    (2, 512, 512, 16, 16, 128, False, 0), (2, 512, 512, 16, 8, 128, True, 128),
    (1, 512, 512, 16, 2, 64, True, 0), (1, 2048, 2048, 16, 8, 128, True, 0),
    (1, 2048, 2048, 8, 1, 128, False, 0), (2, 200, 77, 4, 2, 64, True, 64),
    (4, 2048, 2048, 16, 8, 128, True, 0), FLASH_BWD_HUBERT,
    (2, 77, 77, 4, 2, 80, True, 0), FLASH_BWD_CROSS,
    (2, 200, 333, 8, 2, 128, False, 0), FLASH_BWD_QWEN3_MOE,
]
# The backward's tolerances, (atol, atol as a share of the output's
# largest |entry|, rtol): max |a - b| <= atol + share max|b| + rtol |b|.
# float32 1e-4 -- both compute in float32, but the kernel sums dQ over the
# kv tiles (in registers, in tile order) and dK, dV over up to G x Sq rows
# in another order than the plain einsums, sums of up to 16,384 terms of
# unit scale.  bf16: the kernel and ``attention_bwd_ref`` compute in
# float32 from the same bf16 values (the kernel's P and dS enter their
# products as bf16 pairs hi + lo, 16 bits of mantissa) and round each
# output once, so two bf16 ulps (rtol 2^-6) over a floor of 2^-10 of the
# largest entry (float32 sums near zero).  L is float32 in both dtypes and takes the float32
# tolerance.  Autograd of ``attention_ref`` in bf16 is another function:
# the FA-2 backward (the reference's too) takes delta from O rounded to
# bf16, the softmax's autograd from O in float32 -- up to 5.3e-3 of the
# largest |dQ| at qwen3-1.7b's shape between the plain versions on the CPU
# -- so those rows take a floor of 2^-7 of the largest entry.
FLASH_BWD_TOL = {torch.float32: (1e-4, 0.0, 1e-4),
                 torch.bfloat16: (0.0, 2 ** -10, 2 ** -6)}
FLASH_BWD_AUTOGRAD_TOL_BF16 = (0.0, 2 ** -7, 2 ** -6)
# the cases whose backward runs twice and must repeat bit for bit (the
# ragged windowed case, qwen3-1.7b's, hubert-xlarge's training shape and
# the cross shape): every sum is in one fixed order, so a restart
# retraces the uninterrupted run
FLASH_BWD_REPEAT = [(2, 200, 77, 4, 2, 64, True, 64),
                    (4, 2048, 2048, 16, 8, 128, True, 0), FLASH_BWD_HUBERT,
                    FLASH_BWD_CROSS]


def _check_flash_bwd(rng, dev, errs: dict,
                     cases: Sequence[tuple] = tuple(FLASH_BWD_CASES)) -> int:
    """The flash backward on the card: (1) the kernel against
    ``attention_bwd_ref`` on the same q, k, v, dO and the plain forward's
    o and L; (2) the forward kernel's L against the plain L; (3) autograd
    through both kernels against torch autograd of ``attention_ref``.
    Each within FLASH_BWD_TOL (autograd's bf16 rows within
    FLASH_BWD_AUTOGRAD_TOL_BF16); for each output the largest error is
    kept by dtype, with the mean and largest |entry| of that case's plain
    output beside it.  (4) In the FLASH_BWD_REPEAT cases the kernel runs
    twice on the same inputs and must give equal dq, dk and dv."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_fwd_ref,
                                                     attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_mask
    checks = 0
    by = errs.setdefault("flash_attention_bwd_by_output", {})
    for case in cases:
        B, Sq, Skv, H, K, hd, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (B, S, n, hd), np.float32)).to(dev, dtype)
                for S, n in ((Sq, H), (Skv, K), (Skv, K)))
            do = torch.from_numpy(rng.standard_normal(
                (B, Sq, H, hd), np.float32)).to(dev, dtype)
            what = (f"{dtype} B={B} Sq={Sq} Skv={Skv} H={H} K={K} hd={hd} "
                    f"causal={causal} window={window}")
            o, L = attention_fwd_ref(q, k, v, causal=causal, window=window)
            got = flash_attention_bwd_cuda(q, k, v, o, do, L, causal, window)
            if case in FLASH_BWD_REPEAT:
                again = flash_attention_bwd_cuda(q, k, v, o, do, L, causal,
                                                 window)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"flash_attention_bwd {what}: two calls differ")
                checks += 1
            want = attention_bwd_ref(q, k, v, o, do, L, causal=causal,
                                     window=window)
            _, Lk = flash_attention_cuda(q, k, v, causal, window, lse=True)
            qkv = (q, k, v)
            for t in qkv:
                t.requires_grad_(True)
            grads = torch.autograd.grad(
                flash_attention(q, k, v, causal=causal, window=window), qkv,
                do)
            auto = torch.autograd.grad(
                attention_ref(q, k, v, causal=causal, window=window), qkv,
                do)
            for t in qkv:
                t.requires_grad_(False)
            tol = FLASH_BWD_TOL[dtype]
            rows = [(f"d{n}", g, w, tol) for n, g, w in zip("qkv", got, want)]
            # a row with no allowed key (a window chunk past Skv): the
            # FA-2 backward, the reference's too, takes P = 1 there (L =
            # -1e30 absorbs log Skv) where the softmax's autograd has
            # 1 / Skv, so only rows with a key are held to autograd
            if bool(attention_mask(Sq, Skv, causal, window, dev).any(1)
                    .all()):
                auto_tol = (FLASH_BWD_AUTOGRAD_TOL_BF16
                            if dtype == torch.bfloat16 else tol)
                rows += [(f"autograd_d{n}", g, w, auto_tol)
                         for n, g, w in zip("qkv", grads, auto)]
            rows.append(("L", Lk, L, FLASH_BWD_TOL[torch.float32]))
            for name, g, w, (atol, share, rtol) in rows:
                err = max_abs_err(g.float(), w.float())
                w_abs = w.float().abs()
                top = float(w_abs.max())
                key = f"{dtype}:{name}"
                if err >= by.get(key, {}).get("max_abs_err", -1.0):
                    by[key] = {"max_abs_err": err,
                               "mean_abs_ref": float(w_abs.mean()),
                               "max_abs_ref": top}
                if name != "L":
                    errs["flash_attention_bwd"] = max(
                        errs["flash_attention_bwd"], err)
                check(g.dtype == w.dtype and
                      within(g, w, atol + share * top, rtol),
                      f"flash_attention_bwd {name} {what}: max err {err}, "
                      f"max |ref| {top}")
                checks += 1
    return checks


def _ssd_inputs(rng, dev, *shape_x, N: int, per_head: bool):
    """Random SSD inputs: x, dt (0.1 |N(0, 1)|), a or A (negative), B, C;
    per head (BH, S, ...) or in the model's layout (B, S, H, ...)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    x = rng.standard_normal(shape_x, np.float32)
    dt = np.abs(rng.standard_normal(shape_x[:-1], np.float32)) * 0.1
    if per_head:
        BH, S, _ = shape_x
        a = -np.abs(rng.standard_normal(BH, np.float32))
        bc = (BH, S, N)
    else:
        Bsz, S, H, _ = shape_x
        a = -np.linspace(1.0, 16.0, H, dtype=np.float32)
        bc = (Bsz, S, N)
    return (t(x), t(dt), t(a), t(rng.standard_normal(bc, np.float32)),
            t(rng.standard_normal(bc, np.float32)))


def _check_ssd(rng, dev, errs: dict) -> int:
    """``ssd`` (the Pallas signature) and ``ssd_chunked`` (the model's
    form) against their plain versions on the card; at the kernel tests'
    small shapes also against the sequential ``ssd_ref``."""
    from repro_torch.kernels.ssd import ssd, ssd_chunked, ssd_ref
    atol, rtol = SSD_TOL
    checks = 0

    def hold(got, want, what):
        nonlocal checks
        for g, w, part in zip(got, want, ("y", "state")):
            errs["ssd"] = max(errs["ssd"], max_abs_err(g, w))
            check(within(g, w, atol, rtol),
                  f"ssd {what} {part}: max err {max_abs_err(g, w)}")
        checks += 1

    # the kernel tests' shapes; then S ragged against the kernel's chunk of
    # 256 (over two and three chunks) and below one chunk, N in {8, 13,
    # 128} (13: rows of B and C off 16-byte boundaries), and jamba's
    # prefill, 4 x 128 heads a row of N = 16 (512 rows of heads)
    for BH, S, P, N, chunk in ((4, 256, 64, 32, 64), (2, 128, 32, 16, 128),
                               (8, 512, 64, 64, 128), (1, 64, 16, 8, 32),
                               (3, 77, 64, 128, 64), (2, 200, 16, 128, 128),
                               (2, 520, 32, 8, 128), (3, 700, 64, 128, 128),
                               (2, 40, 64, 8, 32), (2, 300, 16, 13, 100),
                               (512, 2048, 64, 16, 256)):
        args = _ssd_inputs(rng, dev, BH, S, P, N=N, per_head=True)
        got = ssd(*args, chunk=chunk)
        hold(got, ssd(*args, chunk=chunk, impl="torch"),
             f"BH={BH} S={S} P={P} N={N}")
        if S <= 512:
            hold(got, ssd_ref(*args), f"BH={BH} S={S} vs sequential")
    for Bsz, S, H, P, N in ((2, 200, 4, 64, 128), (2, 77, 8, 32, 64),
                            (2, 600, 8, 64, 8), (1, 300, 4, 16, 13),
                            (4, 2048, 32, 64, 128), (4, 2048, 128, 64, 16)):
        args = _ssd_inputs(rng, dev, Bsz, S, H, P, N=N, per_head=False)
        chunk = min(256, S)
        what = f"model form B={Bsz} S={S} H={H} P={P} N={N}"
        hold(ssd_chunked(*args, chunk),
             ssd_chunked(*args, chunk, impl="torch"), what)
        # from a carried state (a prefill that goes on from an earlier one)
        h0 = torch.from_numpy(rng.standard_normal((Bsz, H, P, N), np.float32)
                              * 0.5).to(dev)
        hold(ssd_chunked(*args, chunk, h0),
             ssd_chunked(*args, chunk, h0, impl="torch"), what + " from h0")
    return checks


# The SSD backward's cases (B, S, H, P, N, h0, dstate): the CPU tests'
# shapes (S ragged against the kernel's 256-row chunk, S below one chunk,
# N in {8, 13, 128}, P in {16, 32, 64}, B and C shared by H > 1 heads),
# with and without an initial state and a final state's gradient, then
# mamba2-370m's training shape (4 x 2,048 tokens, 32 heads of P = 64, N =
# 128; the training path has neither).  SSD_BWD_TOL: each output within
# 1e-4 of its own largest |entry| against the plain version in float64 on
# the card -- the CPU tests' tolerance against jax.vjp of the reference
# (tests/test_torch_ssd_bwd.py), where the float32 plain version lands
# within 5e-6 and the kernel's emulated 3xTF32 schedule within a third of
# it.  da, the A gradient, is the exception: with dcum_t = dy_t . y_t -
# x_t . dx_t, da = sum_t dcum_t cumdt_t (cumdt the in-chunk cumsum of
# dt), a sum whose terms cancel, so a correct float32 evaluation can miss
# 1e-4 of its largest entry: the float32 plain version does on one of
# this check's draws at seeds 1-8 (tests/test_torch_ssd_bwd.py::
# test_da_bound_holds_float32_where_its_largest_entry_alone_does_not).
# da is held to 1e-4 of its largest entry plus SSD_BWD_DA_UNIT = 2^-21
# (the rounding unit of the split's small part) of each entry's summand
# magnitude, sum_t (|dy_t . y_t| + |x_t . dx_t|) cumdt_t, from the
# float64 forward and backward, which that test shows holds the float32
# plain version on all 48 draws and the emulated kernel on the worst.
# SSD_BWD_REPEAT: run twice, the outputs bit-equal.
SSD_BWD_CASES = [
    (2, 77, 4, 16, 32, True, True), (1, 20, 3, 16, 13, False, False),
    (2, 300, 4, 64, 13, True, False), (1, 600, 2, 64, 128, False, True),
    (1, 260, 2, 32, 8, True, True), (2, 512, 8, 64, 128, True, True),
    (4, 2048, 32, 64, 128, False, False), (4, 2048, 128, 64, 16, False, False),
]
SSD_BWD_TOL = 1e-4
SSD_BWD_DA_UNIT = 2.0 ** -21
SSD_BWD_REPEAT = [(1, 260, 2, 32, 8, True, True),
                  (4, 2048, 32, 64, 128, False, False)]
SSD_BWD_OUTPUTS = ("dx", "ddt", "da", "dB", "dC", "dinit")
# the backward's own kernels (csrc/ssd_bwd.cu), by a part of their names;
# the other five of its launches are the forward's kernels
SSD_BWD_PARTS = ("ssd_dcb", "ssd_dx", "ssd_dbdc", "ssd_finish")


def _da_scale(x, dt, dy, y, dx) -> torch.Tensor:
    """(B * H,): the magnitude of da's summands, sum_t (|dy_t . y_t| +
    |x_t . dx_t|) cumdt_t, cumdt the cumsum of dt within the kernel's
    256-row chunks."""
    Bsz, S, H, _ = x.shape
    Q = 256
    dtc = torch.nn.functional.pad(dt, (0, 0, 0, -S % Q)).reshape(Bsz, -1,
                                                                  Q, H)
    cumdt = torch.cumsum(dtc, 2).reshape(Bsz, -1, H)[:, :S]
    terms = ((dy * y).sum(-1).abs() + (x * dx).sum(-1).abs()) * cumdt
    return terms.sum(1).reshape(Bsz * H)


def _check_ssd_bwd(rng, dev, errs: dict,
                   cases: Sequence[tuple] = tuple(SSD_BWD_CASES)) -> int:
    """``ssd_bwd`` against ``ssd_chunked_bwd_ref`` in float64 on the same
    card inputs (and the forward kernel's y) at each of ``cases``, each
    output within SSD_BWD_TOL of its largest |entry| (da also within
    SSD_BWD_DA_UNIT of its summands' magnitude); the largest error of
    each output kept with that entry; the SSD_BWD_REPEAT cases run twice
    and must be bit-equal."""
    from repro_torch.kernels.ssd import ssd_chunked_bwd_ref, ssd_chunked_ref
    from repro_torch.kernels.ssd.ops import ssd_bwd_cuda_heads, ssd_cuda_heads
    checks = 0
    by = errs.setdefault("ssd_bwd_by_output", {})

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to(dev)

    for case in cases:
        Bsz, S, H, P, N, init, dfin = case
        what = f"B={Bsz} S={S} H={H} P={P} N={N} h0={init} dstate={dfin}"
        x, dt, A, Bm, Cm = _ssd_inputs(rng, dev, Bsz, S, H, P, N=N,
                                       per_head=False)
        a = A.repeat(Bsz)                    # row b * H + h: A[h]
        h0 = randn(Bsz * H, P, N) * 0.5 if init else None
        ds = randn(Bsz * H, P, N) if dfin else None
        dy = randn(Bsz, S, H, P)
        y, _ = ssd_cuda_heads(x, dt, a, Bm, Cm, h0)
        got = ssd_bwd_cuda_heads(x, dt, a, Bm, Cm, h0, y, dy, ds)
        if case in SSD_BWD_REPEAT:
            again = ssd_bwd_cuda_heads(x, dt, a, Bm, Cm, h0, y, dy, ds)
            check(all((g is None and h is None) or torch.equal(g, h)
                      for g, h in zip(got, again)),
                  f"ssd_bwd {what}: two calls differ")
            checks += 1
            del again

        def f64(t, shape=None):
            return None if t is None else (
                t.double() if shape is None else t.double().reshape(shape))

        args64 = (f64(x), f64(dt), f64(a), f64(Bm), f64(Cm), min(256, S),
                  f64(h0, (Bsz, H, P, N)))
        want = ssd_chunked_bwd_ref(*args64, f64(dy), f64(ds, (Bsz, H, P, N)))
        y64, _ = ssd_chunked_ref(*args64)
        for name, g, w in zip(SSD_BWD_OUTPUTS, got, want):
            if w is None:
                check(g is None, f"ssd_bwd {what}: {name} without h0")
                continue
            w = w.reshape(g.shape)
            err = max_abs_err(g, w)
            top = float(w.abs().max())
            bound = torch.full_like(w, SSD_BWD_TOL * top)
            if name == "da":
                bound += SSD_BWD_DA_UNIT * _da_scale(f64(x), f64(dt),
                                                     f64(dy), y64, want[0])
            over = float(((g.double() - w).abs() / bound).max())
            if err / max(top, 1e-30) >= by.get(name, {}).get("share", -1.0):
                by[name] = {"max_abs_err": err, "max_abs_ref": top,
                            "share": err / max(top, 1e-30),
                            "of_bound": over, "case": what}
            errs["ssd_bwd"] = max(errs["ssd_bwd"], err)
            check(bool(torch.isfinite(g).all()) and over <= 1.0,
                  f"ssd_bwd {name} {what}: max err {err}, max |ref| {top}, "
                  f"{over} of the bound")
            checks += 1
        del got, want, y64
    torch.cuda.synchronize()
    return checks


def _rand_below(rng, n: int) -> int:
    return int.from_bytes(rng.bytes((n.bit_length() + 7) // 8 + 8),
                          "little") % n


def _check_mont_mul(rng, dev, errs: dict) -> int:
    """``mont_mul`` against its plain version on the card, limb for limb,
    and ``modexp_ints`` against Python ``pow``."""
    from repro_torch.crypto.limb import (batch_to_limbs, limbs_needed,
                                         montgomery_params)
    from repro_torch.kernels.modmul import ops as mm
    from repro_torch.kernels.modmul.ref import mont_mul_int
    checks = _check_mont_exp(rng, dev, errs)
    for L in (8, 32, 128, 256):
        n = _rand_below(rng, 1 << (16 * L - 3)) | (1 << (16 * L - 4)) | 1
        check(limbs_needed(n) == L, f"modulus of {L} limbs")
        mp = montgomery_params(n, L)
        nl = torch.from_numpy(mp["n_limbs"].astype(np.int32)).to(dev)
        edges = [0, 1, n - 1, mp["R"] % n]
        for batch in (1, 7, 58, 1024):
            k = min(batch, len(edges))
            av = edges[:k] + [_rand_below(rng, n) for _ in range(batch - k)]
            bv = [_rand_below(rng, n) for _ in range(batch - k)] + edges[:k]
            limbs = batch_to_limbs(av + bv, L)
            a = torch.from_numpy(limbs[:batch].astype(np.int32)).to(dev)
            b = torch.from_numpy(limbs[batch:].astype(np.int32)).to(dev)
            got = mm.mont_mul_op(a, b, nl, mp["n0inv"])
            want = mm.mont_mul_op(a, b, nl, mp["n0inv"], impl="torch")
            errs["mont_mul"] = max(errs["mont_mul"], max_abs_err(got, want))
            check(torch.equal(got, want), f"mont_mul L={L} batch={batch}")
            checks += 1
            if batch <= N_DECRYPT:
                truth = mont_mul_int(limbs[:batch], limbs[batch:], n, L)
                check(np.array_equal(got.cpu().numpy(),
                                     truth.astype(np.int32)),
                      f"mont_mul L={L} batch={batch} against Python ints")
                checks += 1
    # odd L past the ladder's 511: 16-bit digits, 32 a lane
    for L in (513, 1021):
        n = _rand_below(rng, 1 << (16 * L - 3)) | (1 << (16 * L - 4)) | 1
        mp = montgomery_params(n, L)
        nl = torch.from_numpy(mp["n_limbs"].astype(np.int32)).to(dev)
        for batch in (1, 7):
            av = [0, n - 1, mp["R"] % n][:batch] + [
                _rand_below(rng, n) for _ in range(batch - min(batch, 3))]
            bv = [_rand_below(rng, n) for _ in range(batch)]
            limbs = batch_to_limbs(av + bv, L)
            a = torch.from_numpy(limbs[:batch].astype(np.int32)).to(dev)
            b = torch.from_numpy(limbs[batch:].astype(np.int32)).to(dev)
            got = mm.mont_mul_op(a, b, nl, mp["n0inv"])
            want = mm.mont_mul_op(a, b, nl, mp["n0inv"], impl="torch")
            errs["mont_mul"] = max(errs["mont_mul"], max_abs_err(got, want))
            check(torch.equal(got, want), f"mont_mul L={L} batch={batch}")
            truth = mont_mul_int(limbs[:batch], limbs[batch:], n, L)
            check(np.array_equal(got.cpu().numpy(), truth.astype(np.int32)),
                  f"mont_mul L={L} batch={batch} against Python ints")
            checks += 2
    # modexp at the decryption's width: n^2 of 2048 bits, L = 128
    n = _rand_below(rng, 1 << 2047) | (1 << 2047) | 1
    L = limbs_needed(n)
    check(L == 128, "2048-bit modulus has 128 limbs")
    exps = [0, 1, _rand_below(rng, 1 << 64) | (1 << 63),
            _rand_below(rng, 1 << 2374) | (1 << 2373)]
    bases = [_rand_below(rng, n) for _ in exps]
    got = mm.modexp_ints(bases, exps, n, L, device=dev)
    check(got == [pow(x, e, n) for x, e in zip(bases, exps)],
          "modexp_ints equals pow at L = 128")
    return checks + 1


def _ladder_inputs(n: int, L: int, xs, exps, dev):
    """Montgomery-domain bases, exponent bits and R mod n, on the card."""
    from repro_torch.crypto.limb import (batch_to_limbs, montgomery_params,
                                         to_limbs, to_mont)
    from repro_torch.kernels.modmul.ops import exponent_bits
    mp = montgomery_params(n, L)
    nbits = max(e.bit_length() for e in exps) or 1
    a = torch.from_numpy(batch_to_limbs([to_mont(x % n, mp) for x in xs], L)
                         .astype(np.int32)).to(dev)
    bits = torch.from_numpy(exponent_bits(exps, nbits)).to(dev)
    one = torch.from_numpy(to_limbs(mp["R"] % n, L).astype(np.int32)).to(dev)
    return mp, a, bits, one


def _check_mont_exp(rng, dev, errs: dict) -> int:
    """``mont_exp`` (the whole ladder in one launch) against the plain
    ladder (``impl="torch"``) limb for limb and against Python ``pow``:
    even L on 32-bit digits, an odd L on 16-bit ones, batches 1, 7, 58
    with 32-bit exponents; then the decryption's width with exponents of
    0, 1 and 64 bits, and with a 2,374-bit one against ``pow``."""
    from repro_torch.crypto.limb import batch_from_limbs
    from repro_torch.kernels.modmul import ops as mm
    checks = 0

    def hold(n, L, xs, exps, what, plain=True):
        nonlocal checks
        mp, a, bits, one = _ladder_inputs(n, L, xs, exps, dev)
        got = mm.mont_exp_op(a, bits, mp["n_limbs"], mp["n0inv"], one)
        if plain:
            want = mm.mont_exp_op(a, bits, mp["n_limbs"], mp["n0inv"], one,
                                  impl="torch")
            errs["mont_exp"] = max(errs["mont_exp"], max_abs_err(got, want))
            check(torch.equal(got, want), f"mont_exp {what}: plain ladder")
            checks += 1
        R_inv = pow(mp["R"], -1, n)
        vals = batch_from_limbs(got.cpu().numpy().astype(np.uint32))
        check([v * R_inv % n for v in vals] ==
              [pow(x, e, n) for x, e in zip(xs, exps)],
              f"mont_exp {what}: pow")
        checks += 1

    for L in (8, 32, 128, 256, 33):
        n = _rand_below(rng, 1 << (16 * L - 3)) | (1 << (16 * L - 4)) | 1
        for batch in (1, 7, 58):
            xs = [_rand_below(rng, n) for _ in range(batch)]
            exps = [0, 1][:batch] + [_rand_below(rng, 1 << 32) | 1 << 31
                                     for _ in range(batch - 2)]
            hold(n, L, xs, exps, f"L={L} batch={batch}")
    # the decryption's width; the 2,374-bit row against pow only here:
    # the plain ladder over ~2,400 bits takes ~4 min on the card, so the
    # timing phase holds the kernel against pow at the decryption's own
    # shape and against the plain ladder over its first PLAIN_LADDER_BITS
    # bits
    n = _rand_below(rng, 1 << 2047) | (1 << 2047) | 1
    exps = [0, 1, _rand_below(rng, 1 << 64) | (1 << 63)]
    hold(n, 128, [_rand_below(rng, n) for _ in exps], exps,
         "L=128, exponents of 0, 1 and 64 bits")
    exps.append(_rand_below(rng, 1 << 2374) | (1 << 2373))
    hold(n, 128, [_rand_below(rng, n) for _ in exps], exps,
         "L=128, exponents of 0, 1, 64 and 2,374 bits", plain=False)
    return checks


def _main_cfg(**kw):
    from repro_torch import Security, Topology, Wire
    return dict(topology=Topology(n_nodes=N_MAIN, cluster_size=C_MAIN,
                                  schedule="ring"),
                security=Security(redundancy=3, masking="global",
                                  **kw.pop("security", {})),
                wire=Wire(**kw.pop("wire", {})), **kw)


def _run(agg, xs) -> tuple:
    """One allreduce: (result, executed bytes, host seconds)."""
    before = agg.stats()["bytes_sent"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = agg.allreduce(xs)
    torch.cuda.synchronize()
    return out, agg.stats()["bytes_sent"] - before, time.perf_counter() - t0


def phase_main(xs, ref, dev) -> tuple[dict, dict]:
    from repro_torch import Runtime, SecureAggregator
    from repro_torch.core.byzantine import ByzantineSpec
    from repro_torch.kernels import backend
    agg = SecureAggregator(**_main_cfg(), device=dev)
    want_bytes = agg.cost(T_MAIN)["bytes_total"]
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    out, sent, secs = _run(agg, xs)
    launches = backend.launch_counts()
    check(launches["mask_encrypt"] >= 1 and launches["unmask_decrypt"] >= 1
          and launches["vote_combine"] >= 15, f"launches {launches}")
    launches = {k.name: launches[k.name] for k in backend.SECURE_AGG}
    check(tuple(out.shape) == (N_MAIN, T_MAIN), f"shape {out.shape}")
    check(bool(torch.isfinite(out).all()), "finite result")
    check(torch.equal(out, ref.expand_as(out)), "full: equals reference")
    check(sent == want_bytes, f"full: bytes {sent} != cost {want_bytes}")
    host_s = [secs]
    for _ in range(2):
        again, sent2, secs = _run(agg, xs)
        check(torch.equal(again, out) and sent2 == want_bytes, "repeat")
        host_s.append(secs)
    peak = torch.cuda.max_memory_allocated()
    del again

    plain = SecureAggregator(**_main_cfg(runtime=Runtime(
        kernel_impl="torch")), device=dev)
    before = backend.launch_counts()
    plain_out, plain_sent, plain_s = _run(plain, xs)
    check(backend.launch_counts() == before, "plain run launched a kernel")
    check(torch.equal(plain_out, out), "plain-version run equals kernels")
    check(plain_sent == want_bytes, "plain run bytes")
    del plain_out

    dig = SecureAggregator(**_main_cfg(wire={"transport": "digest"}),
                           device=dev)
    dig_out, dig_sent, dig_s = _run(dig, xs)
    check(torch.equal(dig_out, out), "digest: equals honest result")
    check(dig_sent == dig.cost(T_MAIN)["bytes_total"], "digest: bytes")
    del dig_out

    ranks = tuple(cl * C_MAIN + cl % C_MAIN for cl in range(N_MAIN // C_MAIN))
    flip = SecureAggregator(**_main_cfg(security={"byzantine": ByzantineSpec(
        corrupt_ranks=ranks, mode="flip")}), device=dev)
    flip_out, flip_sent, flip_s = _run(flip, xs)
    check(torch.equal(flip_out, out), "flip: equals honest result")
    check(flip_sent == want_bytes, "flip: bytes")
    del flip_out
    return ({"phase": "main", "n_nodes": N_MAIN, "T": T_MAIN,
             "equal_reference": True, "equal_plain_run": True,
             "bytes_sent": want_bytes, "launches": launches,
             "allreduce_s": host_s, "plain_allreduce_s": plain_s,
             "digest_s": dig_s, "flip_s": flip_s,
             "peak_mem_bytes": peak}, launches)


def phase_batched(rng, dev) -> dict:
    from repro_torch import SecureAggregator, Security, Topology
    from repro_torch.core.masking import reference_aggregate
    from repro_torch.kernels import backend
    S, n, T = 64, 16, 1 << 16
    agg = SecureAggregator(topology=Topology(n_nodes=n, cluster_size=4),
                           security=Security(redundancy=3), device=dev)
    xs = torch.from_numpy(rng.standard_normal((S, n, T), np.float32)
                          * 0.3).to(dev)
    backend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = agg.allreduce_batched(xs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = backend.launch_counts()
    check(tuple(out.shape) == (S, T), f"batched shape {out.shape}")
    check(min(launches[k.name] for k in backend.SECURE_AGG) >= 1,
          f"batched launches {launches}")
    check(agg.stats()["bytes_sent"] == S * agg.cost(T)["bytes_total"],
          "batched: bytes")
    mcfg = agg.cfg.mask_cfg()
    for s in range(S):
        check(torch.equal(out[s], reference_aggregate(mcfg, xs[s])),
              f"batched session {s} equals its plain sum")
    return {"phase": "batched", "S": S, "n_nodes": n, "T": T,
            "equal_reference": True, "launches": launches, "seconds": secs,
            "bytes_sent": agg.stats()["bytes_sent"]}


# service: (a) the steady stream at the main cell's protocol, (b) mixed
# traffic with a chunked 2^20 session, (c) resilience at the reference
# grid's small size, on the card and on the CPU
SERVICE_SHAPE = {"sessions": 256, "T": 1 << 16, "max_batch": 16,
                 "mixed_T": (1000, 5000, 1 << 16, 1 << 20),
                 "row": 1 << 16, "pool": 1 << 25}
SERVICE_CHAOS_SEEDS = (0, 1, 2)


def _pool(seed: int, size: int) -> np.ndarray:
    """A seeded float32 pool that sessions take their payloads from as
    views (distinct offsets per session and slot): the stream's 4 GiB of
    contributions without 4 GiB of draws."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(size, np.float32) * 0.3).clip(-0.95, 0.95)


def _payload(pool: np.ndarray, key: int, T: int) -> np.ndarray:
    off = (key * 40_009) % (pool.shape[0] - T)
    return pool[off:off + T]


def _open_sessions(svc, pool, count: int, T: int, *, params=None,
                   first_key: int = 0, now=None) -> list:
    n = (params or svc.default_params).n_nodes
    out = []
    for i in range(count):
        s = svc.open(params=params, now=now)
        for slot in range(n):
            s.contribute(slot, _payload(pool, (first_key + i) * n + slot, T))
        svc.seal(s.sid, now=now)
        out.append(s)
    return out


def _stream_service(dev, depth: int, T: int, max_batch: int, impl=None):
    """(a)'s service: the main cell's protocol, sessions of T."""
    from repro_torch.service import (AggregationService, BatchingConfig,
                                     SessionParams, StreamConfig)
    params = SessionParams(n_nodes=N_MAIN, elems=T, cluster_size=C_MAIN,
                           redundancy=3, schedule="ring", masking="global")
    return AggregationService(
        params, kernel_impl=impl, device=dev,
        batching=BatchingConfig(max_batch=max_batch),
        stream=StreamConfig(depth=depth))


def _run_stream(dev, pool, shape: dict, depth: int, impl=None) -> tuple:
    """(a)'s stream through a fresh service: every session opened and
    sealed, then one pump flushes the backlog as full batches (size
    watermark), ``depth`` slots in flight.  (sessions, seconds, service)."""
    svc = _stream_service(dev, depth, shape["T"], shape["max_batch"], impl)
    ss = _open_sessions(svc, pool, shape["sessions"], shape["T"])
    _sync(dev)
    t0 = time.perf_counter()
    ran = svc.pump()
    _sync(dev)
    secs = time.perf_counter() - t0
    check(ran == shape["sessions"], f"service (a): {ran} sessions ran")
    return ss, secs, svc


def _stage_means(svc) -> dict:
    from repro_torch.obs import metrics as M
    hist = svc.metrics.snapshot()["histograms"]
    return {st: hist.get(f"{M.H_STAGE}{{stage={st}}}", {}).get("mean")
            for st in M.STAGES}


def phase_service(dev, seed: int, shape: Optional[dict] = None
                  ) -> tuple[dict, dict]:
    """The multi-session service on the card: (a) the steady stream,
    (b) mixed traffic, (c) resilience against the CPU.  Returns the
    phase's line and the kernel launches of (a)'s depth-2 stream."""
    from repro_torch import SecureAggregator, Security, Topology
    from repro_torch.kernels import backend
    shape = dict(SERVICE_SHAPE if shape is None else shape)
    pool = _pool(seed, shape["pool"])
    on_card = dev.type == "cuda"
    # warm-up: one batch builds the kernels' library, the round index and
    # the pinned pools, so the timed runs see a running service
    warm = dict(shape, sessions=shape["max_batch"])
    _run_stream(dev, pool, warm, 2)

    # (a) the steady stream: depth 2 (the path the counts are read on),
    # then depth 1, then the plain versions
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    ss2, secs2, svc2 = _run_stream(dev, pool, shape, 2)
    launches = backend.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    batches = svc2.executor.batches_run
    check(batches == shape["sessions"] // shape["max_batch"],
          f"service (a): {batches} batches")
    per_batch = {k.name: launches[k.name] / batches
                 for k in backend.SECURE_AGG}
    rounds = N_MAIN // C_MAIN - 1
    if on_card:
        check(per_batch == {"mask_encrypt": 1, "unmask_decrypt": 1,
                            "vote_combine": rounds},
              f"service (a): launches per batch {per_batch}")
    cost = SecureAggregator(**_main_cfg(), device=dev).cost(shape["T"])
    wire = svc2.executor.wire_bytes
    check(wire == cost["bytes_total"] * shape["sessions"],
          f"service (a): wire bytes {wire} != cost x rows")
    stages = _stage_means(svc2)
    ss1, secs1, _ = _run_stream(dev, pool, shape, 1)
    before = backend.launch_counts()
    ssp, secsp, _ = _run_stream(dev, pool, shape, 2, impl="torch")
    check(backend.launch_counts() == before,
          "service (a): the plain-version stream launched a kernel")
    for a, b, c in zip(ss2, ss1, ssp):
        check(torch.equal(a.result, b.result),
              f"service (a): session {a.sid} depth 2 != depth 1")
        check(torch.equal(a.result, c.result),
              f"service (a): session {a.sid} kernels != plain versions")
    del ss1, ssp
    sample = ss2[::max(1, len(ss2) // 4)][:4]
    for s in sample:
        one = SecureAggregator(**_main_cfg(security={"seed": s.seed}),
                               device=dev)
        xs = torch.stack([torch.from_numpy(_payload(pool, s.sid * N_MAIN + i,
                                                    shape["T"]))
                          for i in range(N_MAIN)]).to(dev)
        check(torch.equal(one.allreduce(xs)[0].cpu(), s.result),
              f"service (a): session {s.sid} != one-shot allreduce")
    del ss2, svc2

    # one profiled warm batch: the device's busy share
    svc = _stream_service(dev, 2, shape["T"], shape["max_batch"])
    _open_sessions(svc, pool, shape["max_batch"], shape["T"])
    svc.pump()
    _open_sessions(svc, pool, shape["max_batch"], shape["T"])
    prof = (profile_device(lambda: svc.pump(), parts=(
        "::mask_kernel", "::vote_kernel", "::unmask_kernel", "Memcpy"))
        if on_card else None)
    del svc

    mixed = _phase_service_mixed(dev, pool, shape)
    chaos = _phase_service_chaos(dev)
    T, S = shape["T"], shape["sessions"]
    line = {"phase": "service", "n_nodes": N_MAIN, "T": T, "sessions": S,
            "max_batch": shape["max_batch"],
            "contribution_bytes": 4 * S * N_MAIN * T,
            "sessions_per_s": {"depth2": S / secs2, "depth1": S / secs1,
                               "plain_depth2": S / secsp},
            "pump_s": {"depth2": secs2, "depth1": secs1,
                       "plain_depth2": secsp},
            "stage_mean_s": stages, "launches_per_batch": per_batch,
            "wire_bytes": wire, "peak_mem_bytes": peak,
            "equal_plain": True, "equal_depth1": True,
            "equal_one_shot": [s.sid for s in sample],
            "profiled_batch": None if prof is None else {
                "wall_ms": prof["profiled_wall_s"] * 1e3,
                "device_busy_ms": prof["device_busy_ms"],
                "device_busy_share": prof["device_busy_share"],
                "by_part": prof["by_part"],
                "by_kernel_ms": prof["by_kernel_ms"][:8]},
            "mixed": mixed, "chaos": chaos}
    return line, {k.name: launches[k.name] for k in backend.KERNELS}


def _phase_service_mixed(dev, pool, shape: dict) -> dict:
    """(b): sessions of every length in ``mixed_T`` (the longest chunked
    across rows of ``row``), pairwise-masked and digest-transport
    sessions under their own batch keys, a Byzantine flip injected into
    a session in flight and an epoch advance (joins) while sessions are
    queued.  Every session ends revealed within the quantization bound
    of its plain sum; the chunked session equals the monolithic one-shot
    allreduce bit for bit."""
    import dataclasses as dc
    from repro_torch import SecureAggregator
    from repro_torch.core.masking import quantization_error_bound
    from repro_torch.core.overlay import build_overlay
    from repro_torch.runtime.fault import SessionFaultPlan
    from repro_torch.service import (AggregationService, BatchingConfig,
                                     EpochManager, SessionParams,
                                     StreamConfig)
    em = EpochManager(build_overlay(1024, 0.2, seed=3), cluster_size=C_MAIN,
                      n_clusters=N_MAIN // C_MAIN)
    base = SessionParams(n_nodes=N_MAIN, elems=shape["mixed_T"][0],
                         cluster_size=C_MAIN, redundancy=3)
    svc = AggregationService(
        base, epochs=em, device=dev, stream=StreamConfig(depth=2),
        batching=BatchingConfig(max_batch=shape["max_batch"],
                                max_row_elems=shape["row"],
                                pad_buckets=(1024, 4096, 16384, 65536)))
    kinds = []
    for T in shape["mixed_T"]:
        kinds.append(("global", dc.replace(base, elems=T)))
    kinds.append(("pairwise", dc.replace(base, elems=shape["mixed_T"][1],
                                         masking="pairwise", clip=1.0)))
    kinds.append(("digest", dc.replace(base, elems=shape["mixed_T"][2],
                                       transport="digest")))
    sessions, key = [], 0
    epoch0 = em.current().epoch
    for rep in range(2):
        for name, params in kinds:
            (s,) = _open_sessions(svc, pool, 1, params.elems, params=params,
                                  first_key=key)
            key += 1
            sessions.append((name, s))
        if rep == 0:
            # in flight: a Byzantine flip on one member of one cluster of
            # a sealed session, then an epoch advance
            sessions[0][1].inject_fault(SessionFaultPlan(byzantine_slots=(1,)))
            em.churn(joins=8)
    check(em.current().epoch == epoch0 + 1, "service (b): epoch advance")
    check(sessions[-1][1].epoch.epoch == epoch0 + 1
          and sessions[0][1].epoch.epoch == epoch0,
          "service (b): sessions pinned to their epochs")
    _sync(dev)
    t0 = time.perf_counter()
    ran = svc.drain()
    _sync(dev)
    secs = time.perf_counter() - t0
    check(ran == len(sessions), f"service (b): {ran} of {len(sessions)} ran")
    errs = {}
    for name, s in sessions:
        check(s.state.value == "revealed", f"service (b): {name} {s.sid}")
        n = s.params.n_nodes
        xs = np.stack([_payload(pool, s.sid * n + i, s.params.elems)
                       for i in range(n)])
        mcfg = s.params.agg_config().mask_cfg()
        err = float(np.abs(s.result.numpy().astype(np.float64)
                           - xs.astype(np.float64).sum(0)).max())
        check(err <= 4 * quantization_error_bound(mcfg),
              f"service (b): {name} session {s.sid} err {err}")
        errs[f"{name}:{s.params.elems}"] = max(errs.get(
            f"{name}:{s.params.elems}", 0.0), err)
    big = [s for name, s in sessions if s.params.elems == max(
        shape["mixed_T"])]
    rows = big[0].n_rows(shape["row"])
    for s in big:
        one = SecureAggregator(**_main_cfg(security={"seed": s.seed}),
                               device=dev)
        xs = torch.stack([torch.from_numpy(_payload(
            pool, s.sid * N_MAIN + i, s.params.elems))
            for i in range(N_MAIN)]).to(dev)
        check(torch.equal(one.allreduce(xs)[0].cpu(), s.result),
              f"service (b): chunked session {s.sid} != monolithic")
    return {"sessions": len(sessions), "seconds": secs,
            "chunked_rows": rows, "chunked_equal_monolithic": True,
            "batch_sizes": list(svc.queue.batch_sizes),
            "flip_absorbed": True, "epochs": [epoch0, epoch0 + 1],
            "max_err_by_kind": errs}


def _chaos_service(dev, seed: Optional[int], poison: bool, sink):
    """(c)'s service at the reference grid's size, traced under a
    TickClock into ``sink``."""
    from repro_torch.obs import TickClock, TraceRecorder
    from repro_torch.runtime.chaos import ChaosConfig
    from repro_torch.runtime.resilience import RetryPolicy
    from repro_torch.service import (AggregationService, BatchingConfig,
                                     SessionParams)
    chaos = None
    if poison:
        chaos = ChaosConfig(mode="dispatch", poison_sids=(3,))
    elif seed is not None:
        chaos = ChaosConfig(mode="dispatch", p=0.35, seed=seed)
    return AggregationService(
        SessionParams(n_nodes=8, elems=16, cluster_size=4, redundancy=3),
        batching=BatchingConfig(max_batch=4, max_age=1e9),
        retry=RetryPolicy(max_attempts=2, base_backoff_s=0),
        chaos=chaos, device=dev,
        recorder=TraceRecorder(clock=TickClock(), sink=sink))


def _phase_service_chaos(dev) -> dict:
    """(c): dispatch chaos at p = 0.35 under seeds 0, 1, 2 and a poison
    session bisected out, each on the card and on the CPU: the dead
    letters, the quarantines and the TickClock JSONL's sha256 equal, and
    every revealed session equal to the fault-free run."""
    import io
    from repro_torch.runtime.chaos import ChaosError
    vals = (np.random.default_rng(23).standard_normal((8, 8, 16), np.float32)
            * 0.3)

    def run(d, seed, poison):
        buf = io.StringIO()
        svc = _chaos_service(d, seed, poison, buf)
        ss = []
        for i in range(8):
            s = svc.open(now=0.0)
            for slot in range(8):
                s.contribute(slot, vals[i, slot])
            svc.seal(s.sid, now=0.0)
            ss.append(s)
        try:
            svc.drain()
        except ChaosError:
            pass
        svc.recorder.close()
        return (ss, svc.executor.dead_letter,
                svc.stats["resilience"]["quarantined"],
                hashlib.sha256(buf.getvalue().encode()).hexdigest())

    cpu = torch.device("cpu")
    clean, _, _, _ = run(dev, None, False)
    out = {}
    for seed, poison in [(s, False) for s in SERVICE_CHAOS_SEEDS] + \
            [(None, True)]:
        card = run(dev, seed, poison)
        host = run(cpu, seed, poison)
        name = "poison" if poison else f"seed{seed}"
        check(card[1] == host[1], f"service (c) {name}: dead letters")
        check(card[2] == host[2], f"service (c) {name}: quarantines")
        check(card[3] == host[3], f"service (c) {name}: trace sha256")
        for a, b, c in zip(card[0], host[0], clean):
            check(a.state.value == b.state.value,
                  f"service (c) {name}: states")
            if a.state.value == "revealed":
                check(torch.equal(a.result, c.result)
                      and torch.equal(b.result, c.result),
                      f"service (c) {name}: session {a.sid} != fault-free")
        if poison:
            check([sid for sid, _ in card[1]] == [3],
                  "service (c): the poison session alone quarantined")
        out[name] = {"dead_letter": [sid for sid, _ in card[1]],
                     "quarantined": card[2], "trace_sha256": card[3]}
    return out


# funcs: (a) the function verbs at the main cell's protocol, (b) polling
# at the paper's scale, (c) the tuner, (d) the launchers
FUNCS_SHAPE = {"bins": 4096, "steps": 1 << 16, "topk_steps": 4096, "k": 8,
               "q": 0.9, "poll_n": 256, "poll_tau": 0.2, "polls": 256,
               "poll_steps": 1024, "hists": 64, "hist_bins": 4096,
               "batch": 16, "main_T": T_MAIN, "probe": (16, 1024, 8),
               "launch_sessions": 32}
SECURE_AGG_PARTS = ("::mask_kernel", "::vote_kernel", "::unmask_kernel")


def _same(got, want) -> bool:
    """One function result on two runs: equal bit for bit, same dtype."""
    a, b = np.asarray(got), np.asarray(want)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _quantized(dom, vals) -> np.ndarray:
    """The values on ``dom``'s grid, ascending: the numpy oracle."""
    return np.sort([dom.value(int(i)) for i in dom.indices(vals)])


def _launch_delta(before: dict) -> dict:
    from repro_torch.kernels import backend
    now = backend.launch_counts()
    return {k.name: now[k.name] - before[k.name] for k in backend.SECURE_AGG}


def phase_funcs(dev, seed: int, shape: Optional[dict] = None
                ) -> tuple[dict, dict]:
    """The secure functions and the tuner on the card: (a) the verbs at
    the main cell's protocol, (b) polling at the paper's scale against
    the CPU, (c) the tuner's decisions through the service and on the
    main cell's workload, and its probe, (d) the launchers.  Returns the
    phase's line and the launches of (a)'s verbs."""
    shape = dict(FUNCS_SHAPE if shape is None else shape)
    verbs, launches = _funcs_verbs(dev, seed, shape)
    line = {"phase": "funcs", "verbs": verbs,
            "polling": _funcs_polling(dev, seed, shape),
            "tuner": _funcs_tuner(dev, seed, shape),
            "launchers": _funcs_launchers(dev, shape)}
    return line, launches


def _funcs_verbs(dev, seed: int, shape: dict) -> tuple[dict, dict]:
    """(a): histogram, median, minimum, maximum, quantile and top-k at
    n = 64 through the facade on the card, each equal to the numpy oracle
    on the quantized domain and to the same verb on the plain versions,
    its executed bytes equal to ``cost(fn=...)``.  After a warm call of
    each, the counts are set to 0 and read after the verbs' run (the
    plain runs between are checked to launch nothing).  Returns the
    per-verb lines and those counts."""
    from repro_torch import Runtime, SecureAggregator
    from repro_torch.funcs import ValueDomain
    from repro_torch.funcs.run import quantile_rank
    from repro_torch.kernels import backend
    vals = np.random.default_rng(seed + 7).random(N_MAIN)
    agg = SecureAggregator(**_main_cfg(), device=dev)
    plain = SecureAggregator(**_main_cfg(runtime=Runtime(
        kernel_impl="torch")), device=dev)
    dom = ValueDomain(0.0, 1.0, shape["steps"])
    tdom = ValueDomain(0.0, 1.0, shape["topk_steps"])
    qs, tq = _quantized(dom, vals), _quantized(tdom, vals)
    q, k = shape["q"], shape["k"]
    cases = [
        ("histogram", dict(bins=shape["bins"]),
         lambda a: a.histogram(vals, bins=shape["bins"]),
         np.histogram(vals, bins=shape["bins"], range=(0.0, 1.0))[0]),
        ("median", dict(domain=dom), lambda a: a.median(vals, domain=dom),
         qs[quantile_rank(0.5, N_MAIN) - 1]),
        ("minimum", dict(domain=dom),
         lambda a: a.minimum(vals, domain=dom), qs[0]),
        ("maximum", dict(domain=dom),
         lambda a: a.maximum(vals, domain=dom), qs[-1]),
        ("quantile", dict(domain=dom, q=q),
         lambda a: a.quantile(vals, q, domain=dom),
         qs[quantile_rank(q, N_MAIN) - 1]),
        ("topk", dict(domain=tdom, k=k),
         lambda a: a.topk(vals, k, domain=tdom), tq[::-1][:k])]
    # warm: the callables of every payload width, and the kernels' library
    for _, _, call, _ in cases:
        call(agg)
    out = {}
    backend.reset_launch_counts()
    for name, kw, call, want in cases:
        cost = agg.cost(fn=name, **kw)
        before, sent0 = backend.launch_counts(), agg.stats()["bytes_sent"]
        _sync(dev)
        t0 = time.perf_counter()
        got = call(agg)
        _sync(dev)
        secs = time.perf_counter() - t0
        launched = _launch_delta(before)
        sent = agg.stats()["bytes_sent"] - sent0
        check(_same(got, want), f"funcs (a) {name}: {got} != oracle {want}")
        check(sent == cost["bytes_total"],
              f"funcs (a) {name}: bytes {sent} != cost {cost['bytes_total']}")
        before = backend.launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        got_plain = call(plain)
        _sync(dev)
        plain_secs = time.perf_counter() - t0
        check(backend.launch_counts() == before,
              f"funcs (a) {name}: the plain-version run launched a kernel")
        check(_same(got, got_plain), f"funcs (a) {name}: kernels != plain")
        rounds = cost["allreduces"]
        out[name] = {"rounds": rounds, "round_elems": sorted(set(
            cost["round_elems"])), "ms": secs * 1e3,
            "ms_per_round": secs * 1e3 / rounds, "plain_ms": plain_secs * 1e3,
            "bytes": sent, "launches": launched,
            "launches_per_round": {k2: v / rounds
                                   for k2, v in launched.items()},
            "result": np.asarray(got).tolist() if name != "histogram"
            else {"sum": int(np.sum(got)), "nonzero": int(np.count_nonzero(
                got))}}
    return out, backend.launch_counts()


def _poll_run(d, seed: int, shape: dict, profile: bool = False) -> dict:
    """(b)'s deployment on device ``d``: ``polls`` median polls and
    ``hists`` histogram sessions, sealed, two forced pumps (the second
    profiled when ``profile``), the churn, then the drain."""
    from repro_torch import SecureAggregator, Security, Topology
    from repro_torch.core.overlay import build_overlay
    from repro_torch.service import BatchingConfig, EpochManager
    em = EpochManager(build_overlay(shape["poll_n"], shape["poll_tau"],
                                    seed=42), cluster_size=4)
    n = em.current().n_nodes
    agg = SecureAggregator(topology=Topology(n_nodes=n, cluster_size=4),
                           security=Security(redundancy=3), epochs=em,
                           batching=BatchingConfig(max_batch=shape["batch"],
                                                   max_age=1e9),
                           device=d)
    rng = np.random.default_rng(seed + 11)
    polls, hists = [], []
    for kind, count, kw in (
            ("median", shape["polls"],
             dict(domain=(0.0, 1.0, shape["poll_steps"]))),
            ("histogram", shape["hists"], dict(bins=shape["hist_bins"]))):
        for _ in range(count):
            fs = agg.open_session(fn=kind, now=0.0, **kw)
            vals = rng.random(n)
            for slot in range(n):
                fs.contribute(slot, float(vals[slot]))
            fs.seal(now=0.0)
            (polls if kind == "median" else hists).append((fs, vals))
    _sync(d)
    t0 = time.perf_counter()
    agg.pump(now=0.0, force=True)
    prof = None
    if profile:
        prof = profile_device(lambda: agg.pump(now=0.0, force=True),
                              parts=(*SECURE_AGG_PARTS, "Memcpy"))
    else:
        agg.pump(now=0.0, force=True)
    em.churn(joins=8, leaves=8, honest_join_frac=1.0)
    agg.drain()
    _sync(d)
    secs = time.perf_counter() - t0
    st = agg.stats()["service"]
    return {"n": n, "seconds": secs, "polls": polls, "hists": hists,
            "sizes": list(st["batches"]["sizes"]),
            "batches": st["batches"]["run"], "epoch": st["epoch"],
            "stages": _stage_means(agg.service), "profile": prof,
            "done": all(fs.done for fs, _ in polls + hists)}


def _funcs_polling(dev, seed: int, shape: dict) -> dict:
    """(b): the polling deployment of ``secure_polling`` (an overlay of
    ``build_overlay(256, 0.2, seed=42)`` with clusters of 4): concurrent
    median polls and histogram sessions in batches of 16 rows, a churn
    of 8 joins and 8 leaves after the second round, on the card and on
    the CPU.  Every result equals the numpy oracle and the CPU's, each
    bisection round runs as shared batches, as many as on the CPU."""
    from repro_torch.funcs import ValueDomain
    from repro_torch.funcs.run import quantile_rank
    card = _poll_run(dev, seed, shape)
    host = _poll_run(torch.device("cpu"), seed, shape)
    check(card["done"] and host["done"], "funcs (b): sessions not done")
    n = card["n"]
    dom = ValueDomain(0.0, 1.0, shape["poll_steps"])
    for (fs, vals), (hs, _) in zip(card["polls"], host["polls"]):
        want = _quantized(dom, vals)[quantile_rank(0.5, n) - 1]
        check(fs.result == want == hs.result,
              f"funcs (b): poll {fs.fid} {fs.result} != {want}")
    for (fs, vals), (hs, _) in zip(card["hists"], host["hists"]):
        want = np.histogram(vals, bins=shape["hist_bins"],
                            range=(0.0, 1.0))[0]
        check(_same(fs.result, want) and _same(hs.result, want),
              f"funcs (b): histogram {fs.fid}")
    rows = shape["batch"]
    rounds = dom.bisect_rounds
    want_batches = (rounds * -(-shape["polls"] // rows)
                    + -(-shape["hists"] // rows))
    check(card["batches"] == host["batches"] == want_batches
          and card["sizes"] == host["sizes"],
          f"funcs (b): batches {card['batches']} / {host['batches']} "
          f"(want {want_batches})")
    prof = None
    if dev.type == "cuda":
        prof = _poll_run(dev, seed, shape, profile=True)["profile"]
    sessions = shape["polls"] + shape["hists"]
    return {"n_slots": n, "polls": shape["polls"],
            "poll_steps": shape["poll_steps"], "rounds": rounds,
            "histograms": shape["hists"], "hist_bins": shape["hist_bins"],
            "batch_rows": rows, "batches": card["batches"],
            "epochs": card["epoch"], "equal_oracle": True,
            "equal_cpu": True,
            "seconds": card["seconds"], "cpu_seconds": host["seconds"],
            "func_sessions_per_s": sessions / card["seconds"],
            "stage_mean_s": card["stages"],
            "profiled_round": None if prof is None else {
                "wall_ms": prof["profiled_wall_s"] * 1e3,
                "device_busy_ms": prof["device_busy_ms"],
                "device_busy_share": prof["device_busy_share"],
                "by_part": prof["by_part"],
                "by_kernel_ms": prof["by_kernel_ms"][:8]}}


def _tuner_rows() -> list:
    """The decision signatures of ``benchmarks/tune.py`` and their byte
    rows, read from ``BENCH_secure_agg.json`` as data."""
    import re
    rows = json.loads((pathlib.Path(__file__).resolve().parent
                       / "BENCH_secure_agg.json").read_text())
    out = []
    for key in sorted(rows):
        m = re.fullmatch(r"tuner_decision_n(\d+)_T(\d+)_S(\d+)_bytes", key)
        if m:
            n, T, S = map(int, m.groups())
            out.append((n, T, S, int(rows[key]),
                        int(rows[f"tuner_default_n{n}_T{T}_S{S}_bytes"])))
    check(len(out) == 3, f"funcs (c): {len(out)} tuner rows")
    return out


def _service_batch(agg, vals: np.ndarray) -> tuple:
    """One batch of ``S`` sessions through the facade's service: (the
    revealed rows, seconds of the drain, executed wire bytes)."""
    S, n, _ = vals.shape
    wire0 = (agg.service.stats["wire"]["bytes_sent"]
             if agg.service is not None else 0)
    ss = []
    for i in range(S):
        s = agg.open_session(vals.shape[2], now=0.0)
        for slot in range(n):
            s.contribute(slot, vals[i, slot])
        agg.seal(s.sid, now=0.0)
        ss.append(s)
    _sync(agg.device)
    t0 = time.perf_counter()
    ran = agg.drain()
    _sync(agg.device)
    secs = time.perf_counter() - t0
    check(ran == S, f"funcs (c): {ran} of {S} sessions ran")
    return (torch.stack([s.result for s in ss]), secs,
            agg.service.stats["wire"]["bytes_sent"] - wire0)


def _digest_share(run) -> dict:
    """One more call of ``run`` (a tuned dispatch) with CUDA events
    around every digest vote (``digest_vote_combine``) and every digest
    hash (``digest_rows``) the engine calls, and around the whole call:
    each region's stream time (its kernels and the gaps between their
    launches) and its share of the dispatch."""
    from repro_torch.core import engine
    spans = {"digest_vote_combine": [], "digest_rows": []}
    originals = {name: getattr(engine, name) for name in spans}

    def timed(name):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = originals[name](*a, **kw)
            end.record()
            spans[name].append((start, end))
            return out
        return call

    whole = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
    for name in spans:
        setattr(engine, name, timed(name))
    try:
        torch.cuda.synchronize()
        whole[0].record()
        run()
        whole[1].record()
        torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(engine, name, fn)
    total = whole[0].elapsed_time(whole[1])
    out = {"dispatch_ms": total}
    for name, evs in spans.items():
        ms = sum(a.elapsed_time(b) for a, b in evs)
        out[name] = {"calls": len(evs), "ms": ms, "share": ms / total}
    return out


def _funcs_tuner(dev, seed: int, shape: dict) -> dict:
    """(c): the three decision signatures of ``benchmarks/tune.py``, each
    through the service tuned and on the ring / full default (bytes
    equal to the committed rows and to the executed account, sums within
    the reference test's 1e-3 of each other); the main cell's workload
    tuned (executed bytes equal to ``cost``, the sum equal to the plain
    reference sum); ``tune="probe"`` at one signature."""
    from repro_torch import AggConfig, SecureAggregator, Topology
    from repro_torch.core.masking import (quantization_error_bound,
                                          reference_aggregate)
    from repro_torch.service import BatchingConfig
    from repro_torch.tune import Tuner, clear_tuner_cache
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(seed + 13)
    out = {"signatures": []}
    for n, T, S, want_pred, want_base in _tuner_rows():
        aggs = {mode: SecureAggregator(
            topology=Topology(n_nodes=n, cluster_size=4), tune=mode,
            batching=BatchingConfig(max_batch=S, max_age=1e9), device=dev)
            for mode in ("auto", None)}
        vals = rng.integers(0, 2, size=(S, n, T)).astype(np.float32)
        runs = {}
        for mode, agg in aggs.items():
            _service_batch(agg, vals)                   # warm
            runs[mode] = _service_batch(agg, vals)
        d = aggs["auto"]._tune_decision(T, S)
        check(d.predicted_bytes == want_pred and d.baseline_bytes
              == want_base, f"funcs (c) n{n} T{T} S{S}: decision bytes")
        check(runs["auto"][2] == d.predicted_bytes,
              f"funcs (c) n{n} T{T} S{S}: executed {runs['auto'][2]} != "
              f"predicted {d.predicted_bytes}")
        check(runs[None][2] == d.baseline_bytes,
              f"funcs (c) n{n} T{T} S{S}: default bytes")
        tuned, default = runs["auto"][0], runs[None][0]
        err = float((tuned.double() - default.double()).abs().max())
        check(err <= 1e-3, f"funcs (c) n{n} T{T} S{S}: tuned vs default "
              f"err {err}")
        truth = torch.from_numpy(vals.sum(1))
        check(float((tuned.double() - truth.double()).abs().max()) <= 1e-3,
              f"funcs (c) n{n} T{T} S{S}: tuned vs plain sum")
        c = d.config
        sig = {"n": n, "T": T, "S": S,
               "pick": f"{c.schedule}/{c.transport} w{c.digest_words} "
                       f"backup={c.digest_backup} pad={d.padded_elems}",
               "predicted_bytes": d.predicted_bytes,
               "baseline_bytes": d.baseline_bytes,
               "executed_bytes": runs["auto"][2],
               "tuned_ms": runs["auto"][1] * 1e3,
               "default_ms": runs[None][1] * 1e3,
               "bit_equal_default": bool(torch.equal(tuned, default)),
               "max_abs_diff_default": err}
        if on_card and c.transport == "digest":
            sig["digest_share"] = _digest_share(
                lambda: _service_batch(aggs["auto"], vals))
        out["signatures"].append(sig)
        del aggs, runs, tuned, default

    # the main cell's own workload, tuned: n = 64, T = 2^22, S = 1
    T = shape["main_T"]
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 17)
    xs = (torch.rand((N_MAIN, T), generator=g, device=dev) * 2 - 1) * 0.9
    tagg = SecureAggregator(**_main_cfg(), tune="auto", device=dev)
    agg = SecureAggregator(**_main_cfg(), device=dev)
    ref = reference_aggregate(agg.cfg.mask_cfg(), xs)
    times = {}
    for name, a in (("tuned", tagg), ("untuned", agg)):
        got, sent, _ = _run_on(a, xs)                       # warm
        want = a.cost(T)["bytes_total"]
        check(sent == want, f"funcs (c) main {name}: bytes {sent} != {want}")
        check(torch.equal(got, ref.expand_as(got)),
              f"funcs (c) main {name}: != the plain reference sum")
        times[name] = [_run_on(a, xs)[2] * 1e3 for _ in range(3)]
        del got
    d = tagg._tune_decision(T)
    c = d.config
    share = prof = None
    if on_card:
        share = _digest_share(lambda: tagg.allreduce(xs))
        p = profile_device(lambda: tagg.allreduce(xs),
                           parts=SECURE_AGG_PARTS)
        prof = {"wall_ms": p["profiled_wall_s"] * 1e3,
                "device_busy_ms": p["device_busy_ms"],
                "device_busy_share": p["device_busy_share"],
                "by_part": p["by_part"], "by_kernel_ms": p["by_kernel_ms"]}
    out["main"] = {
        "n": N_MAIN, "T": T, "S": 1,
        "pick": f"{c.schedule}/{c.transport} w{c.digest_words} "
                f"backup={c.digest_backup} chunk={c.chunk_elems}",
        "executed_bytes": tagg.cost(T)["bytes_total"],
        "untuned_bytes": agg.cost(T)["bytes_total"],
        "predicted_bytes": d.predicted_bytes,
        "equal_reference": True,
        "quantization_bound": quantization_error_bound(agg.cfg.mask_cfg()),
        "tuned_ms": times["tuned"], "untuned_ms": times["untuned"],
        "tuned_median_ms": statistics.median(times["tuned"]),
        "untuned_median_ms": statistics.median(times["untuned"]),
        "digest_share": share, "tuned_profile": prof}
    del xs, ref, tagg, agg

    # tune="probe" at one signature: each finalist's measured seconds
    n, T, S = shape["probe"]
    cfg = AggConfig(n_nodes=n, cluster_size=4)
    clear_tuner_cache()
    byte_pick = Tuner().resolve(cfg, T, S)
    clear_tuner_cache()
    prober = Tuner(probe=True, device=dev)
    probed = prober.resolve(cfg, T, S)
    clear_tuner_cache()
    check(probed.probed and prober.stats()["probes"]
          == len(prober.last_probe) >= 2, "funcs (c) probe: no probes")
    out["probe"] = {
        "signature": [n, T, S], "finalists": prober.last_probe,
        "byte_winner_chunk_elems": byte_pick.config.chunk_elems,
        "probe_pick_chunk_elems": probed.config.chunk_elems,
        "pick_is_byte_winner": (probed.config == byte_pick.config
                                and probed.padded_elems
                                == byte_pick.padded_elems)}
    return out


def _run_on(agg, xs) -> tuple:
    """One allreduce on the facade's device: (result, executed bytes,
    seconds)."""
    before = agg.stats()["bytes_sent"]
    _sync(agg.device)
    t0 = time.perf_counter()
    out = agg.allreduce(xs)
    _sync(agg.device)
    return out, agg.stats()["bytes_sent"] - before, time.perf_counter() - t0


def _funcs_launchers(dev, shape: dict) -> dict:
    """(d): ``repro_torch.launch.secure_polling`` at its defaults and
    ``serve_agg --fn median`` / ``--tune auto`` at small sizes, in this
    process on the card; each completes with its own checks."""
    import contextlib
    import io
    from repro_torch.launch import secure_polling, serve_agg
    from repro_torch.obs import MetricsRegistry
    d = str(dev)
    out = {}
    for name, run in (
            ("secure_polling", lambda: secure_polling.main(["--device", d])),
            ("serve_agg_median", lambda: serve_agg.main(
                ["--fn", "median", "--sessions",
                 str(shape["launch_sessions"]), "--batch", "16",
                 "--max-age", "1e9", "--device", d],
                metrics=MetricsRegistry())),
            ("serve_agg_tune", lambda: serve_agg.main(
                ["--tune", "auto", "--sessions",
                 str(shape["launch_sessions"]), "--batch", "16",
                 "--max-age", "1e9", "--device", d],
                metrics=MetricsRegistry()))):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = run()
        secs = time.perf_counter() - t0
        if name == "secure_polling":
            check(res["da"] is not None and res["da"]["output"]
                  == res["da"]["expected"], "funcs (d): polling DA")
        else:
            check(res["revealed"] == res["exact"]
                  == shape["launch_sessions"], f"funcs (d) {name}: {res}")
        if name == "serve_agg_tune":
            batches = res["stats"]["batches"]["run"]
            check(res["stats"]["wire"]["bytes_sent"]
                  == batches * res["decision"].predicted_bytes,
                  "funcs (d) serve_agg --tune: bytes")
        out[name] = {"seconds": secs,
                     "last_lines": buf.getvalue().strip().splitlines()[-3:]}
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _mesh_cfg(**kw):
    """The mesh phase's config: the main cell's protocol at n = 16."""
    from repro_torch import AggConfig
    return AggConfig(n_nodes=N_MESH, cluster_size=C_MAIN, redundancy=3,
                     schedule="ring", masking="global", **kw)


def _mesh_inputs(seed: int, dev, shape: dict) -> tuple:
    """(a)'s per-node payloads, (b)'s per-node trees (as rows), (d)'s
    sessions: drawn from ``seed`` on ``dev``, so the parent and every rank
    hold the same bits; uniform within 0.9 of the clip, so the plain sum
    is the quantized sum's yardstick."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def draw(*sz):
        return (torch.rand(sz, generator=g, device=dev) * 2 - 1) * 0.9

    n, T = N_MESH, shape["T"]
    return draw(n, T), draw(n, T), draw(shape["S"], n, shape["T_batch"])


def _tree_of(rows: torch.Tensor) -> dict:
    """(..., T) rows -> (b)'s dict payload: two leaves of T / 2."""
    h = rows.shape[-1] // 2
    return {"b": rows[..., h:], "w": rows[..., :h].reshape(
        rows.shape[:-1] + (h // 64, 64))}


def _tree_sha(tree: dict) -> str:
    return sha(torch.cat([tree[k].reshape(-1) for k in sorted(tree)]))


def _mesh_rank(rank: int, seed: int, job_dir: str, shape: dict) -> None:
    """One rank of the mesh phase: (a)-(d) through the facade, checked
    against the parent's sim hashes, with timings; writes
    ``rank{r}.json``.  Any failed check raises and ends the run."""
    import torch.distributed as dist
    from repro_torch import Runtime, SecureAggregator
    from repro_torch.core.byzantine import ByzantineSpec
    from repro_torch.core.engine import flat_node_id
    from repro_torch.kernels import backend
    from repro_torch.runtime.compat import node_mesh
    dev = torch.device(shape["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with open(pathlib.Path(job_dir) / "want.json") as f:
        want = json.load(f)
    mesh = node_mesh(N_MESH)
    nid = flat_node_id(mesh, ("data",))
    xa, xb, xd = _mesh_inputs(seed, dev, shape)
    rt = Runtime(backend="mesh", mesh=mesh)
    on_card = dev.type == "cuda"

    def launches():
        return backend.launch_counts()

    def timed(agg, fn) -> dict:
        walls, wires = [], {}
        for _ in range(shape["runs"]):
            dist.barrier()
            w0 = agg.stats()["wire_s"]
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
            for k, v in agg.stats()["wire_s"].items():
                wires.setdefault(k, []).append((v - w0[k]) * 1e3)
        prof = None
        if on_card:
            dist.barrier()
            kernels = ("::mask_kernel", "::vote_kernel", "::unmask_kernel")
            p = profile_device(fn, parts=(*kernels, "Memcpy"))
            # the ranks' contexts share the card by time slices, so a
            # profiled span can hold other ranks' turns: only the
            # kernels' own times and the copies are read from it
            prof = {"wall_ms": p["profiled_wall_s"] * 1e3,
                    "device_busy_ms": p["device_busy_ms"],
                    "kernel_ms": sum(p["by_part"][k]["ms"] for k in kernels),
                    "kernel_launches": {k[2:]: p["by_part"][k]["launches"]
                                        for k in kernels},
                    "copy_ms": p["by_part"]["Memcpy"]["ms"]}
            if rank == 0:
                prof["by_kernel_ms"] = p["by_kernel_ms"][:8]
        return {"wall_ms": walls, "wire_ms": wires, "profile": prof}

    out = {"rank": rank, "node": nid}
    # (a) the facade on the mesh backend at full payload width
    agg = SecureAggregator(_mesh_cfg(), runtime=rt, device=dev)
    backend.reset_launch_counts()
    got = agg.allreduce(xa)
    _sync(dev)
    out["a_launches"] = launches()
    if on_card:
        want_launches = dict.fromkeys(out["a_launches"], 0)
        want_launches.update(mask_encrypt=1, unmask_decrypt=1,
                             vote_combine=3)
        check(out["a_launches"] == want_launches,
              f"rank {rank} (a) launches {out['a_launches']}")
    check(sha(got[nid]) == want["a_rows"][nid], f"rank {rank} (a) row")
    check(sha(got) == want["a_all"], f"rank {rank} (a) gathered result")
    check(agg.stats()["bytes_sent"] == want["a_bytes"], f"rank {rank} bytes")
    del got
    out["a"] = timed(agg, lambda: agg.allreduce(xa))

    # (b) the manual backend: this rank's tree, 64 chunks
    man = SecureAggregator(_mesh_cfg(chunk_elems=shape["chunk"]),
                           runtime=Runtime(backend="manual"), device=dev)
    tree = _tree_of(xb[nid])
    backend.reset_launch_counts()
    got = man.allreduce(tree)
    _sync(dev)
    out["b_launches"] = launches()
    check(_tree_sha(got) == want["b_rows"][nid], f"rank {rank} (b) tree")
    del got
    out["b"] = timed(man, lambda: man.allreduce(tree))

    # (c) under attack: the digest transport, flips on one member a cluster
    flip = SecureAggregator(_mesh_cfg(transport="digest", byzantine=(
        ByzantineSpec(corrupt_ranks=MESH_FLIP, mode="flip"))),
        runtime=rt, device=dev)
    backend.reset_launch_counts()
    got = flip.allreduce(xa)
    _sync(dev)
    out["c_launches"] = launches()
    check(sha(got[nid]) == want["a_rows"][nid], f"rank {rank} (c) exact")
    check(flip.stats()["bytes_sent"] == want["c_bytes"], f"rank {rank} (c)")
    over = flip.derive(byzantine=ByzantineSpec(corrupt_ranks=MESH_FLIP_OVER,
                                               mode="flip"))
    got = over.allreduce(xa)
    _sync(dev)
    check(sha(got[nid]) == want["c_over_rows"][nid]
          and sha(got) == want["c_over_all"],
          f"rank {rank} (c) flips past the vote: not the sim's result")
    del got

    # (d) batched on the mesh: the distributed reveal
    backend.reset_launch_counts()
    got = agg.allreduce_batched(xd)
    _sync(dev)
    out["d_launches"] = launches()
    check(sha(got) == want["d"], f"rank {rank} (d) batched")
    del got
    out["e"] = _mesh_service_rank(rank, mesh, dev, seed, shape, want["e"])
    out["f"] = _mesh_funcs_rank(rank, rt, dev, seed, shape, want["f"])
    out["peak_mem_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if on_card else None)
    with open(pathlib.Path(job_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def _mesh_service(dev, shape: dict, **kw):
    """(e)'s service: n = N_MESH, S sessions of T a batch, depth 2."""
    from repro_torch.service import (AggregationService, BatchingConfig,
                                     SessionParams, StreamConfig)
    params = SessionParams(n_nodes=N_MESH, elems=shape["svc_T"],
                           cluster_size=C_MAIN, redundancy=3)
    return AggregationService(
        params, device=dev, stream=StreamConfig(depth=2),
        batching=BatchingConfig(max_batch=shape["svc_S"]), **kw)


def _mesh_service_rank(rank: int, mesh, dev, seed: int, shape: dict,
                       want: list) -> dict:
    """(e) in one rank: the service on the mesh transport, every rank
    its own copy over the same calls, its rows held to the parent's sim
    service by sha256; a hop fault recovered; dispatch chaos on the mesh
    tripping the breaker onto the sim."""
    import torch.distributed as dist
    from repro_torch.runtime.chaos import ChaosConfig
    from repro_torch.runtime.resilience import CircuitBreaker, RetryPolicy
    pool = _pool(seed + 1, shape["svc_pool"])
    S, T, B = shape["svc_S"], shape["svc_T"], shape["svc_batches"]
    mkw = dict(transport="mesh", mesh=mesh)

    def rows_equal(ss, what):
        for s in ss:
            check(s.state.value == "revealed" and sha(s.result) == want[s.sid],
                  f"rank {rank} (e) {what}: session {s.sid} != sim")

    svc = _mesh_service(dev, shape, **mkw)
    ss = _open_sessions(svc, pool, S * B, T)
    dist.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    ran = svc.pump()
    _sync(dev)
    secs = time.perf_counter() - t0
    check(ran == S * B, f"rank {rank} (e): {ran} sessions ran")
    rows_equal(ss, "stream")
    stream = {"seconds": secs, "seconds_per_batch": secs / B,
              "stages": _stage_means(svc)}
    del ss, svc

    retry = RetryPolicy(max_attempts=3, base_backoff_s=0.0)
    svc = _mesh_service(dev, shape, retry=retry, **mkw,
                        chaos=ChaosConfig(mode="hop", hop_k=0, times=1))
    ss = _open_sessions(svc, pool, S, T)
    svc.pump()
    rows_equal(ss, "hop fault")
    res = svc.stats["resilience"]
    check(res["chaos_injected"] == 1 and res["retries"] == 1
          and res["quarantined"] == 0, f"rank {rank} (e) hop: {res}")
    del ss, svc

    brk = CircuitBreaker(k=2, cooloff_s=1e9)
    svc = _mesh_service(dev, shape, retry=retry, breaker=brk, **mkw,
                        chaos=ChaosConfig(mode="dispatch",
                                          only_backend="mesh"))
    ss = _open_sessions(svc, pool, S, T)
    svc.pump()
    rows_equal(ss, "degraded")
    res = svc.stats["resilience"]
    check(brk.state == "open" and brk.trips == 1
          and res["degraded_batches"] == 1 and res["retries"] == 2,
          f"rank {rank} (e) breaker: {res}")
    return {"stream": stream, "hop": {"retries": 1},
            "breaker": res["breaker"],
            "degraded_batches": res["degraded_batches"]}


def _mesh_funcs(rt, dev, seed: int, shape: dict) -> dict:
    """(f)'s two functions through a facade on ``rt``: a median on
    ``f_steps`` grid steps and a histogram of ``f_bins`` bins of N_MESH
    values drawn from ``seed``, with each one's seconds (``rt`` None:
    the sim)."""
    from repro_torch import SecureAggregator
    vals = np.random.default_rng(seed + 19).random(N_MESH)
    agg = SecureAggregator(_mesh_cfg(), runtime=rt, device=dev)
    out = {}
    for name, call in (
            ("median", lambda: agg.median(
                vals, domain=(0.0, 1.0, shape["f_steps"]))),
            ("histogram", lambda: agg.histogram(vals,
                                                bins=shape["f_bins"]))):
        t0 = time.perf_counter()
        got = call()
        out[name] = {"result": np.asarray(got).tolist(),
                     "seconds": time.perf_counter() - t0}
    out["bytes"] = agg.stats()["bytes_sent"]
    return out


def _mesh_funcs_rank(rank: int, rt, dev, seed: int, shape: dict,
                     want: dict) -> dict:
    """(f) in one rank: the median and the histogram on the ``mesh``
    backend, each equal to the parent's sim on the card."""
    import torch.distributed as dist
    dist.barrier()
    got = _mesh_funcs(rt, dev, seed, shape)
    for name in ("median", "histogram"):
        check(got[name]["result"] == want[name]["result"],
              f"rank {rank} (f) {name}: {got[name]['result']} != sim")
    check(got["bytes"] == want["bytes"], f"rank {rank} (f) bytes")
    return {name: got[name]["seconds"] for name in ("median", "histogram")}


def phase_mesh(dev, seed: int, shape: Optional[dict] = None,
               tp2_e_dir: Optional[str] = None) -> tuple[dict, dict]:
    """The distributed transports on one card: N_MESH rank processes over
    a gloo group, every wire staged through host memory, the kernels in
    every rank.  The parent computes the port's sim on the card first and
    hands the ranks its hashes.  With ``tp2_e_dir`` the ranks then run
    tp2 (e) and (f) into it (``_mesh_then_tp2e_rank``)."""
    from repro_torch import SecureAggregator
    from repro_torch.core.byzantine import ByzantineSpec
    from repro_torch.core.masking import quantization_error_bound
    from repro_torch.runtime.compat import spawn_nodes
    shape = dict(MESH_SHAPE if shape is None else shape, device=str(dev))
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.lib()          # the ranks load this build
    xa, xb, xd = _mesh_inputs(seed, dev, shape)
    sim = SecureAggregator(_mesh_cfg(), device=dev)
    ra = sim.allreduce(xa)
    bound = 4 * quantization_error_bound(sim.cfg.mask_cfg())
    err = float((ra.double() - xa.double().sum(0)).abs().max())
    check(err < bound, f"mesh (a) sim: err {err} >= bound {bound}")
    sim_ms = []
    for _ in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        sim.allreduce(xa)
        _sync(dev)
        sim_ms.append((time.perf_counter() - t0) * 1e3)
    rb = sim.allreduce(_tree_of(xb))
    flip_cost = SecureAggregator(_mesh_cfg(transport="digest"),
                                 device=dev).cost(shape["T"])["bytes_total"]
    over = SecureAggregator(_mesh_cfg(transport="digest", byzantine=(
        ByzantineSpec(corrupt_ranks=MESH_FLIP_OVER, mode="flip"))),
        device=dev).allreduce(xa)
    check(not torch.equal(over, ra), "mesh (c) sim: flips past the vote "
          "left the sum unchanged")
    want = {"c_over_rows": [sha(over[i]) for i in range(N_MESH)],
            "c_over_all": sha(over),
            "a_rows": [sha(ra[i]) for i in range(N_MESH)], "a_all": sha(ra),
            "a_bytes": sim.cost(shape["T"])["bytes_total"],
            "b_rows": [_tree_sha({k: v[i] for k, v in rb.items()})
                       for i in range(N_MESH)],
            "c_bytes": flip_cost, "d": sha(sim.allreduce_batched(xd))}
    # (e)'s sessions through the sim service on the card
    svc = _mesh_service(dev, shape)
    ss = _open_sessions(svc, _pool(seed + 1, shape["svc_pool"]),
                        shape["svc_S"] * shape["svc_batches"],
                        shape["svc_T"])
    svc.pump()
    want["e"] = [sha(s.result) for s in ss]
    # (f)'s functions on the sim, on the card
    want["f"] = _mesh_funcs(None, dev, seed, shape)
    del xa, xb, xd, ra, rb, over, ss, svc
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    job = pathlib.Path(tempfile.mkdtemp(prefix="mesh-phase-"))
    try:
        (job / "want.json").write_text(json.dumps(want))
        t0 = time.perf_counter()
        if tp2_e_dir is None:
            spawn_nodes(_mesh_rank, N_MESH, seed, str(job), shape)
        else:
            spawn_nodes(_mesh_then_tp2e_rank, N_MESH, seed, str(job), shape,
                        tp2_e_dir)
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((job / f"rank{r}.json").read_text())
                 for r in range(N_MESH)]
    finally:
        shutil.rmtree(job, ignore_errors=True)
    for k in ("a", "b", "c", "d"):
        check(all(r[f"{k}_launches"] == ranks[0][f"{k}_launches"]
                  for r in ranks), f"mesh ({k}): launches differ by rank")

    def slowest(part):
        runs = zip(*(r[part]["wall_ms"] for r in ranks))
        return statistics.median(max(run) for run in runs)

    def split(part):
        return [{"rank": r["rank"],
                 "wall_ms": statistics.median(r[part]["wall_ms"]),
                 "wire_ms": {k: statistics.median(v)
                             for k, v in r[part]["wire_ms"].items()},
                 "profile": r[part]["profile"]} for r in ranks]

    line = {"phase": "mesh", "ranks": N_MESH, "backend": "gloo",
            "device": str(dev), "T": shape["T"],
            "chunk_elems": shape["chunk"], "batched": [shape["S"],
                                                       shape["T_batch"]],
            "equal_sim": True, "sim_err": err, "sim_bound": bound,
            "bytes_sent": want["a_bytes"],
            "launches_per_rank": {k: ranks[0][f"{k}_launches"]
                                  for k in ("a", "b", "c", "d")},
            "a_slowest_rank_ms": slowest("a"),
            "b_slowest_rank_ms": slowest("b"), "sim_a_ms": sim_ms,
            "a_split": split("a"), "b_split": split("b"),
            "peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks],
            "spawn_to_end_s": spawn_s,
            "e_service": {
                "sessions": shape["svc_S"] * shape["svc_batches"],
                "T": shape["svc_T"], "depth": 2, "equal_sim": True,
                "hop_fault_recovered": True,
                "breaker": ranks[0]["e"]["breaker"],
                "slowest_rank_s_per_batch": max(
                    r["e"]["stream"]["seconds_per_batch"] for r in ranks),
                "rank0_stage_mean_s": ranks[0]["e"]["stream"]["stages"]},
            "f_funcs": {
                "median_steps": shape["f_steps"],
                "histogram_bins": shape["f_bins"], "equal_sim": True,
                "median": want["f"]["median"]["result"],
                "sim_s": {k: want["f"][k]["seconds"]
                          for k in ("median", "histogram")},
                "slowest_rank_s": {k: max(r["f"][k] for r in ranks)
                                   for k in ("median", "histogram")}}}
    line["g_expert_parallel"] = _mesh_ep(dev, seed, shape)
    return line, ranks[0]["a_launches"]


def _ep_cfg(shape: dict):
    """(g)'s config in float32: qwen3-moe-235b's at full width (its smoke
    config in a CPU rehearsal)."""
    from repro_torch.configs import get_config, get_smoke_config
    get = get_smoke_config if shape.get("ep_smoke") else get_config
    return dataclasses.replace(get(EP_ARCH), dtype="float32")


def _ep_rank(rank: int, seed: int, job_dir: str, shape: dict) -> None:
    """One rank of mesh (g): one MoE layer's experts drawn whole from the
    seed (the same on every rank), this rank's half of them, its own
    (B, S) tokens and one token every rank holds; ``moe_forward`` under an
    expert-axis context (``moe_distributed``, then
    ``moe_distributed_replicated``) against ``moe_local`` over every
    expert on the same card.  Writes ``ep{r}.json``."""
    from repro_torch.models import layers as L
    from repro_torch.runtime.compat import node_mesh
    from repro_torch.runtime.context import DistCtx, use_ctx
    dev = torch.device(shape["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = _ep_cfg(shape)
    n = shape["ep_ranks"]
    mesh = node_mesh(n)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    full = L.make_moe_params(cfg, g)
    E, D = cfg.moe.n_experts, cfg.d_model
    E_loc = E // n
    mine = {k: v[rank * E_loc:(rank + 1) * E_loc] if v.dim() == 3 else v
            for k, v in full.items()}
    g.manual_seed(seed + 1 + rank)
    x = torch.randn((shape["ep_B"], shape["ep_S"], D), generator=g,
                    device=dev)
    g.manual_seed(seed + 1 + n)
    x1 = torch.randn((1, 1, D), generator=g, device=dev)
    ctx = DistCtx(mesh=mesh, dp_axes=("data",), ep_axis="data")
    local, local1 = L.moe_local(cfg, full, x), L.moe_local(cfg, full, x1)
    local_ms = []
    for _ in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        L.moe_local(cfg, full, x)
        _sync(dev)
        local_ms.append((time.perf_counter() - t0) * 1e3)
    with use_ctx(ctx):
        walls = []
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            dist = L.moe_forward(cfg, mine, x)
            _sync(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        rep = L.moe_forward(cfg, mine, x1)
    T = x.shape[0] * x.shape[1]
    idx, _ = L._router(cfg, full, x.reshape(T, D))
    slot, C = L._dispatch_slots(cfg, idx, T)
    C1 = L._capacity(cfg, 1)
    out = {"rank": rank, "tokens": T, "capacity": C,
           "dropped_pairs": int((slot == E * C).sum()),
           "err": max_abs_err(dist, local), "err_replicated":
           max_abs_err(rep, local1),
           "ok": within(dist, local, EP_TOL, 0.0)
           and within(rep, local1, EP_TOL, 0.0),
           "wall_ms": walls, "local_all_experts_ms": local_ms,
           # each all_to_all sends E * C_e rows of D float32 (1 / n of
           # them to this rank itself); the replicated path's float32
           # all-reduce carries E * C_e(1) rows
           "all_to_all_bytes": E * C * D * 4,
           "all_to_all_bytes_off_rank": E * C * D * 4 * (n - 1) // n,
           "all_reduce_bytes": E * C1 * D * 4,
           "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else 0)}
    del dist, rep, local, local1
    out["g2_backward"] = _ep_grad(cfg, full, mesh, ctx, rank, seed, shape,
                                  dev)
    (pathlib.Path(job_dir) / f"ep{rank}.json").write_text(json.dumps(out))


def _ep_grad(cfg, full: dict, mesh, ctx, rank: int, seed: int, shape: dict,
             dev) -> dict:
    """Mesh (g2) in one rank: the expert-parallel layer's backward at
    capacity EP_GRAD_CF (nothing drops): the gradient of sum(out * w) for
    a seeded cotangent w, with respect to this rank's tokens and its
    expert slice, through ``moe_distributed`` and the exchange's backward;
    against ``moe_local`` over every expert on both ranks' tokens (one
    call a rank's tokens: with no drop a token's output does not depend
    on the others), the ranks taking the reference in turn so that one
    reference's activations are alive at a time."""
    import torch.distributed as dist
    from repro_torch.models import layers as L
    from repro_torch.runtime.context import use_ctx
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=EP_GRAD_CF))
    n, D = shape["ep_ranks"], cfg.d_model
    E_loc = cfg.moe.n_experts // n
    rows = slice(rank * E_loc, (rank + 1) * E_loc)
    stacks = ("w_gate", "w_up", "w_down")
    g = torch.Generator(device=dev)

    def tokens(r):
        # rank r's tokens (as in (g)) and cotangent
        g.manual_seed(seed + 1 + r)
        x = torch.randn((shape["ep_B"], shape["ep_S"], D), generator=g,
                        device=dev)
        g.manual_seed(seed + 100 + r)
        return x, torch.randn(x.shape, generator=g, device=dev)

    x, w = tokens(rank)
    x.requires_grad_(True)
    mine = {k: (v[rows].clone().requires_grad_(True) if k in stacks else v)
            for k, v in full.items()}
    _sync(dev)
    t0 = time.perf_counter()
    with use_ctx(ctx):
        loss = (L.moe_forward(cfg, mine, x) * w).sum()
        got = torch.autograd.grad(loss, [x] + [mine[k] for k in stacks])
    _sync(dev)
    ep_ms = (time.perf_counter() - t0) * 1e3
    del loss, mine
    errs, tops, ref_ms = {}, {}, None
    for turn in range(n):
        if turn == rank:
            ref = {k: (v.detach().requires_grad_(True) if k in stacks
                       else v) for k, v in full.items()}
            _sync(dev)
            t0 = time.perf_counter()
            total = None
            for r in range(n):
                xr, wr = tokens(r)
                if r == rank:
                    xr.requires_grad_(True)
                    mine_x = xr
                part = (L.moe_local(cfg, ref, xr) * wr).sum()
                total = part if total is None else total + part
            want = torch.autograd.grad(total, [mine_x] +
                                       [ref[k] for k in stacks])
            want = [want[0]] + [t[rows] for t in want[1:]]
            _sync(dev)
            ref_ms = (time.perf_counter() - t0) * 1e3
            for name, a, b in zip(("dx",) + stacks, got, want):
                errs[name] = max_abs_err(a, b)
                tops[name] = float(b.abs().max())
            del ref, total, want
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier(group=mesh.group)
    ok = all(errs[k] <= EP_TOL * max(1.0, tops[k]) for k in errs)
    return {"capacity_factor": EP_GRAD_CF, "ok": ok, "max_abs_err": errs,
            "max_abs_ref": tops, "ep_fwd_bwd_ms": ep_ms,
            "local_reference_ms": ref_ms}


def _mesh_ep(dev, seed: int, shape: dict) -> dict:
    """Mesh (g): expert parallelism on ``ep_ranks`` gloo ranks of the
    card (every exchange staged through pinned host memory), each rank's
    output within EP_TOL of ``moe_local`` over all the experts."""
    from repro_torch.runtime.compat import spawn_nodes
    job = pathlib.Path(tempfile.mkdtemp(prefix="ep-phase-"))
    try:
        t0 = time.perf_counter()
        spawn_nodes(_ep_rank, shape["ep_ranks"], seed, str(job), shape)
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((job / f"ep{r}.json").read_text())
                 for r in range(shape["ep_ranks"])]
    finally:
        shutil.rmtree(job, ignore_errors=True)
    for r in ranks:
        check(r["ok"], f"mesh (g) rank {r['rank']}: moe_distributed err "
              f"{r['err']}, replicated {r['err_replicated']} > {EP_TOL}")
        g2 = r["g2_backward"]
        check(g2["ok"], f"mesh (g2) rank {r['rank']}: gradient errors "
              f"{g2['max_abs_err']} against largest entries "
              f"{g2['max_abs_ref']}, tol {EP_TOL} of max(1, largest)")
    cfg = _ep_cfg(shape)
    return {"arch": cfg.name, "dtype": "float32",
            "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
            "experts_per_rank": cfg.moe.n_experts // shape["ep_ranks"],
            "ranks": shape["ep_ranks"], "tokens_per_rank":
            [shape["ep_B"], shape["ep_S"]], "tol": EP_TOL,
            "spawn_to_end_s": spawn_s, "by_rank": ranks}


def phase_paillier(dev) -> tuple[dict, dict, tuple[int, int]]:
    """Threshold Paillier and the paper's DA protocol at full width, with
    the partial decryptions on the card.  Returns the line, the DA path's
    launches and the decryption's (rows, exponent bits)."""
    from repro_torch.core import protocol
    from repro_torch.core.overlay import build_overlay
    from repro_torch.crypto import paillier
    from repro_torch.kernels import backend

    # (a) one threshold decryption of 512 summed votes
    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    tp, shares = paillier.threshold_keygen(
        bits=KEY_BITS, t=C_THRESHOLD // 2 + 1, c=C_THRESHOLD, p=P_FULL,
        q=Q_FULL)
    keygen_s = time.perf_counter() - t0
    votes = np.random.default_rng(KEY_BITS).integers(0, 2, N_OVERLAY)
    t0 = time.perf_counter()
    agg = None
    for v in votes.tolist():
        ct = tp.pk.encrypt(v)
        agg = ct if agg is None else tp.pk.add(agg, ct)
    encrypt_s = time.perf_counter() - t0
    decryptors = shares[:N_DECRYPT]
    nbits = max((2 * tp.delta * sh.value).bit_length() for sh in decryptors)
    backend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts = tp.partial_decrypt_batch(agg, decryptors, device=dev)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in backend.MODMUL}
    t0 = time.perf_counter()
    want = tp.partial_decrypt_batch(agg, decryptors, use_kernel=False)
    pow_s = time.perf_counter() - t0
    check(parts == want, "partial decryptions on the card equal pow")
    check(tp.combine(parts) == int(votes.sum()), "combine: the vote sum")
    check(launches == {"mont_mul": 1, "mont_exp": 1},
          f"a decryption's launches {launches}: want one ladder and one "
          "exit multiply")
    ladder = profile_device(
        lambda: tp.partial_decrypt_batch(agg, decryptors, device=dev))

    # (b) the DA protocol over a 512-node overlay, Step 4 on the card; the
    # key's primes are the committed ones, so its shapes are fixed
    seed = 0

    def run(kernel_crypto: bool):
        ov = build_overlay(N_OVERLAY, TAU_OVERLAY, seed=seed)
        proto = protocol.DAProtocol(ov, key_bits=KEY_BITS, seed=seed,
                                    kernel_crypto=kernel_crypto, device=dev,
                                    primes=(P_FULL, Q_FULL))
        t0 = time.perf_counter()
        res = proto.run()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    backend.reset_launch_counts()
    res, da_s = run(True)
    path_launches = backend.launch_counts()
    ref, da_pow_s = run(False)
    check(res.exact and res.output == res.expected, "DA protocol exact")
    check(res.cluster_sizes[-1] == C_THRESHOLD,
          f"threshold cluster of {res.cluster_sizes[-1]} members")
    check(path_launches["mont_exp"] > 0 and
          path_launches["mont_mul"] == path_launches["mont_exp"],
          f"DA protocol launches {path_launches}: one ladder and one exit "
          "multiply a decryption")
    for k in ("output", "expected", "exact", "phase_bytes", "n", "g",
              "cluster_sizes"):
        check(getattr(res, k) == getattr(ref, k), f"DA protocol {k}")
    check(dataclasses.asdict(res.stats) == dataclasses.asdict(ref.stats),
          "DA protocol stats")
    ct_bytes = (tp.pk.n2.bit_length() + 7) // 8
    # Step 4 counts c_t messages of 2 ciphertexts for each decryptor
    rows = res.phase_bytes["decrypt"] // (C_THRESHOLD * ct_bytes * 2)
    return ({"phase": "paillier", "key_bits": KEY_BITS,
             "n2_bits": tp.pk.n2.bit_length(), "c_t": C_THRESHOLD,
             "t": tp.t, "decryptors": len(decryptors), "nbits": nbits,
             "launches": launches, "kernel_s": kernel_s,
             "pow_s": pow_s, "keygen_s": keygen_s, "encrypt_s": encrypt_s,
             "ladder_profile": ladder,
             "plaintext": int(votes.sum()), "equal_pow": True,
             "da": {"n": res.n, "g": res.g,
                    "cluster_sizes": res.cluster_sizes,
                    "output": res.output, "exact": res.exact,
                    "messages": res.stats.messages,
                    "bytes": res.stats.bytes, "launches": path_launches,
                    "decryptors": rows,
                    "decryptions": path_launches["mont_exp"],
                    "seconds": da_s,
                    "pow_seconds": da_pow_s, "equal_pow_run": True},
             "seconds": time.perf_counter() - phase_t0},
            path_launches, (rows, nbits))


def phase_launch(dev, shape: Optional[dict] = None) -> tuple[dict, dict]:
    """The two launchers of the ninth slice: (a) ``serve_agg --transport
    mesh`` (one rank process a slot, each on the card) against the same
    loads on ``--transport sim`` in this process: every session revealed
    and exact, equal batch sizes and wire bytes, rank 0's kernel launches;
    (b) ``launch.quickstart.main`` on the card, its launches counted from
    zero."""
    import contextlib
    import io
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import backend
    from repro_torch.launch import quickstart, serve_agg
    from repro_torch.obs import MetricsRegistry
    shape = dict(LAUNCH_SHAPE if shape is None else shape)
    cuda = dev.type == "cuda"
    common = ["--overlay-n", str(shape["overlay_n"]), "--batch",
              str(shape["batch"]), "--max-age", "1e9", "--device", str(dev)]
    loads = {"additive": (shape["sessions"],
                          ["--sessions", str(shape["sessions"]), "--elems",
                           str(shape["elems"])]),
             "median": (shape["median_sessions"],
                        ["--fn", "median", "--sessions",
                         str(shape["median_sessions"]), "--steps",
                         str(shape["steps"])])}
    out = {"phase": "launch", "shape": shape}
    mesh_launches = dict.fromkeys(backend.launch_counts(), 0)
    for name, (n, argv) in loads.items():
        runs = {}
        for transport in ("sim", "mesh"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            # the mesh's rank 0 prints to the inherited stdout, not buf
            with contextlib.redirect_stdout(buf):
                res = serve_agg.main(common + argv + ["--transport",
                                                      transport],
                                     metrics=MetricsRegistry())
            res["seconds"] = time.perf_counter() - t0
            check(res["revealed"] == res["exact"] == n,
                  f"launch (a) {name} on {transport}: revealed "
                  f"{res['revealed']}, exact {res['exact']} of {n}")
            runs[transport] = res
        sim, mesh = runs["sim"], runs["mesh"]
        check(mesh["stats"]["batches"]["sizes"]
              == sim["stats"]["batches"]["sizes"],
              f"launch (a) {name}: batch sizes {mesh['stats']['batches']}"
              f" != sim {sim['stats']['batches']}")
        check(mesh["stats"]["wire"] == sim["stats"]["wire"],
              f"launch (a) {name}: wire {mesh['stats']['wire']} != sim "
              f"{sim['stats']['wire']}")
        if cuda:
            for k in ("mask_encrypt", "unmask_decrypt", "vote_combine"):
                check(mesh["launches"][k] > 0 and sim["launches"][k] > 0,
                      f"launch (a) {name}: no {k} launch (mesh rank 0 "
                      f"{mesh['launches']}, sim {sim['launches']})")
        for k, v in mesh["launches"].items():
            mesh_launches[k] += v
        out[f"serve_agg_{name}"] = {
            t: {"seconds": r["seconds"], "wall_s": r["wall_s"],
                "sessions_per_s": r["sessions_per_s"],
                "revealed": r["revealed"], "exact": r["exact"],
                "batch_sizes": r["stats"]["batches"]["sizes"],
                "wire_bytes": r["stats"]["wire"]["bytes_sent"],
                "launches": {k: v for k, v in r["launches"].items() if v}}
            for t, r in runs.items()}
        out[f"serve_agg_{name}"]["ranks"] = mesh["slots"]
    # (b) the quickstart
    buf = io.StringIO()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        qs = quickstart.main(device=dev, steps=shape["quickstart_steps"])
    _sync(dev)
    secs = time.perf_counter() - t0
    qs_launches = backend.launch_counts()
    toks = qs["serve"]["tokens"]
    vocab = get_smoke_config("olmo-1b").vocab_size
    check(toks.shape == (2, 8) and bool(((toks >= 0) & (toks < vocab)).all()),
          f"launch (b) quickstart tokens {toks}")
    if cuda:
        for k in ("mask_encrypt", "unmask_decrypt", "flash_attention",
                  "flash_attention_bwd"):
            check(qs_launches[k] > 0,
                  f"launch (b) quickstart: no {k} launch {qs_launches}")
    losses = qs["train"]["losses"]
    out["quickstart"] = {
        "seconds": secs, "steps": len(losses), "loss_first": losses[0],
        "loss_last": losses[-1], "facade": qs["facade"],
        "step_s_median": statistics.median(qs["train"]["step_s"]),
        "serve_tok_per_s": qs["serve"]["tok_per_s"],
        "serve_tokens": toks.tolist(),
        "launches": {k: v for k, v in qs_launches.items() if v},
        "last_lines": buf.getvalue().strip().splitlines()[-3:]}
    return out, {"serve_agg_mesh_rank0": mesh_launches,
                 "quickstart": qs_launches}


def check_widths(arch: str, cfg) -> None:
    """The port's full config against the reference's published widths."""
    want = REFERENCE_WIDTHS[arch]
    got = {k: getattr(cfg, k) for k in want
           if k not in ("ssm", "moe", "pattern")}
    for k in ("ssm", "moe"):
        if k in want:
            sub = getattr(cfg, k)
            got[k] = dataclasses.asdict(sub) if sub else None
    if "pattern" in want:
        got["pattern"] = [(s.mixer, s.mlp) for s in cfg.pattern]
    check(got == want, f"{arch} widths {got} != reference {want}")


def serve_launches(cfg) -> dict:
    """The kernel calls one prefill makes: one ``flash_attention`` an
    attention layer, one ``ssd`` (four launches, counted once) a Mamba2
    layer."""
    mamba = sum(s.mixer == "mamba2" for s in cfg.pattern)
    per = {"flash_attention": len(cfg.pattern) - mamba, "ssd": mamba}
    return {k: v * cfg.n_units for k, v in per.items() if v}


def phase_serve(dev, seed: int,
                shape=(SERVE_BATCH, SERVE_PROMPT, SERVE_GEN), configs=None
                ) -> tuple[dict, dict]:
    """Every served model at full width through the kernels (at
    SERVE_UNITS' depth where it is cut), with the float32 prefill held
    against the plain versions (at SERVE_CHECK_UNITS' depth where it is
    cut).  ``configs`` (arch -> config) replaces the full configs in a
    CPU rehearsal.  A kernel's launches are those of the first model that
    runs it (qwen3's for flash attention); each model's own are in its
    entry."""
    from repro_torch.configs import get_config
    batch, prompt, gen = shape
    out, launches = {"phase": "serve", "batch": batch, "prompt_len": prompt,
                     "gen": gen}, {}
    for arch in (configs or REFERENCE_WIDTHS):
        cfg = configs[arch] if configs else get_config(arch)
        if configs is None:
            check_widths(arch, cfg)
        full_units = cfg.n_units
        cfg_check = cfg
        if arch in SERVE_UNITS:
            cfg = dataclasses.replace(cfg, n_units=min(SERVE_UNITS[arch],
                                                       full_units))
            cfg_check = dataclasses.replace(
                cfg, n_units=min(SERVE_CHECK_UNITS[arch], cfg.n_units))
        run = _serve_arch if cfg.decoder else _encode_arch
        out[arch], n = run(arch, cfg, cfg_check, dev, seed, shape)
        out[arch].update(n_units=cfg.n_units, n_units_full=full_units,
                         n_units_f32_check=cfg_check.n_units)
        for k, v in n.items():
            launches.setdefault(k, v)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out, launches


def _seed_biases(params: dict, seed: int) -> None:
    """Overwrite every QKV bias (zeros as ``init_params`` draws them) with
    N(0, SERVE_BIAS_STD^2) values from a generator of their own, unit by
    unit (in the tree's dtype: a bf16 tree's biases are the float32
    tree's rounded), in place."""
    gen = torch.Generator(device=params["embed"].device)
    gen.manual_seed(seed + 1)
    for unit in params["units"]:
        for lp in unit.values():
            for name in ("bq", "bk", "bv"):
                b = lp["mixer"].get(name)
                if b is not None:
                    b.copy_(torch.randn(b.shape, generator=gen,
                                        device=b.device) * SERVE_BIAS_STD)


class RouteLog:
    """While active, every MoE router call's expert ids and its top k + 1
    float32 logits, in call order (``models.layers._router`` wrapped;
    the logits are computed again beside the router's own, the same
    product on the same inputs)."""

    def __init__(self, on: bool = True):
        self.on = on
        self.calls = []

    def __enter__(self):
        from repro_torch.models import layers as L
        self._layers, self._router = L, L._router
        if self.on:
            def router(cfg, p, xf):
                idx, w = self._router(cfg, p, xf)
                logits = xf.float() @ p["router"].float()
                top = torch.topk(logits, cfg.moe.top_k + 1, dim=-1).values
                self.calls.append((cfg, idx, top))
                return idx, w
            L._router = router
        return self

    def __exit__(self, *exc):
        self._layers._router = self._router


def routing_agreement(kern: RouteLog, plain: RouteLog) -> dict:
    """Layer by layer, how the kernel run and the plain run routed the
    same prompts: the share of (token, choice) pairs given the same
    expert and of pairs given the same dispatch slot, each run's dropped
    pairs, the tokens whose choices differ, and at those tokens the
    plain run's closest gap between adjacent logits of its top k + 1
    (the near tie a float difference tipped)."""
    from repro_torch.models import layers as L
    check(len(kern.calls) == len(plain.calls),
          f"router calls {len(kern.calls)} vs {len(plain.calls)}")
    layers = []
    for (cfg, ik, _), (_, ip, tp) in zip(kern.calls, plain.calls):
        T = ik.shape[0]
        sk, C = L._dispatch_slots(cfg, ik, T)
        sp, _ = L._dispatch_slots(cfg, ip, T)
        sink = cfg.moe.n_experts * C
        flipped = (ik != ip).any(dim=1)
        gaps = (tp[:, :-1] - tp[:, 1:]).min(dim=1).values[flipped]
        layers.append({
            "same_expert_share": float((ik == ip).float().mean()),
            "same_slot_share": float((sk == sp).float().mean()),
            "dropped": [int((sk == sink).sum()), int((sp == sink).sum())],
            "pairs": int(ik.numel()), "capacity": C,
            "flipped_tokens": int(flipped.sum()),
            "max_logit_gap_at_flip": (float(gaps.max()) if gaps.numel()
                                      else None)})
    gaps = [x["max_logit_gap_at_flip"] for x in layers
            if x["max_logit_gap_at_flip"] is not None]
    return {"moe_layers": len(layers),
            "min_same_expert_share": min(
                (x["same_expert_share"] for x in layers), default=1.0),
            "flipped_tokens": sum(x["flipped_tokens"] for x in layers),
            "max_logit_gap_at_flip": max(gaps, default=None),
            "by_layer": layers}


def _serve_arch(arch: str, cfg, cfg_check, dev, seed: int, shape
                ) -> tuple[dict, dict]:
    """One model: the bf16 serve at ``cfg``'s depth, the float32 check at
    ``cfg_check``'s (the first units of the same weights; none where it
    has no unit).  Every tensor it makes dies when it returns."""
    from repro_torch.kernels import backend
    from repro_torch.launch.serve import prompt_batch, serve
    from repro_torch.models import model as M
    batch, prompt, gen = shape
    want = serve_launches(cfg)
    moe = cfg.moe is not None
    cuda = dev.type == "cuda"
    # the prompts ``serve`` builds (with a vision model's media)
    prompts = prompt_batch(cfg, batch, prompt, seed, dev)
    max_seq = prompt + gen

    def weights(c, cast: bool):
        """The weights drawn from the seed on the card (the same numbers
        every call), QKV biases seeded nonzero: float32 masters, or cast
        to the compute dtype as they are drawn."""
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        params = M.init_params(c, g, cast=cast)
        _seed_biases(params, seed)
        return params

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # the weights as served, bf16, cast as drawn so the peak is the
    # serving footprint; a short serve first, so the timed one finds
    # cuBLAS, the kernel library and the allocator warm
    cast = weights(cfg, True)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(cast))
    serve(cfg, batch=batch, prompt_len=64, gen=2, seed=seed, params=cast,
          device=dev)
    mem_before = 0
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats()
        mem_before = torch.cuda.memory_allocated()
    # 1. the bf16 serve through the kernels
    res = serve(cfg, batch=batch, prompt_len=prompt, gen=gen, seed=seed,
                params=cast, device=dev)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    toks = res["tokens"]
    check(toks.shape == (batch, gen) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all()),
        f"{arch}: tokens {toks.shape}")
    # 2. launches: one kernel call a layer in the prefill, none in decode
    pre, dec = res["launches"]["prefill"], res["launches"]["decode"]
    check({k: v for k, v in pre.items() if v} == want,
          f"{arch}: prefill launches {pre}, want {want}")
    check(sum(dec.values()) == 0, f"{arch}: decode launches {dec}")
    # the warm prefill alone, three times
    prefill_s = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        M.prefill(cfg, cast, prompts, max_seq)
        sync()
        prefill_s.append(time.perf_counter() - t0)
    # 4. the bf16 serve through the plain versions (its peak memory: its
    # float32 scores are what bounds SERVE_UNITS), and the bf16 prefill
    # logits of both, with how each routed
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    plain = serve(cfg, batch=batch, prompt_len=prompt, gen=gen, seed=seed,
                  params=cast, device=dev, kernel_impl="torch")
    plain_peak = torch.cuda.max_memory_allocated() if cuda else 0
    check(sum(plain["launches"]["prefill"].values()) == 0,
          f"{arch}: the plain run launched a kernel")
    with RouteLog(moe) as rk:
        lb, _ = M.prefill(cfg, cast, prompts, max_seq)
    with RouteLog(moe) as rp:
        lbp, _ = M.prefill(cfg, cast, prompts, max_seq, impl="torch")
    bf16_err = max_abs_err(lb.float(), lbp.float())
    routing = {"bf16": routing_agreement(rk, rp)} if moe else None
    profiles = _profile_serve(cfg, cast, prompts, max_seq, prompt) \
        if cuda else {}
    del cast, lb, lbp, rk, rp
    out = {
        "prefill_s": res["t_prefill_s"],
        "prefill_s_warm": prefill_s,
        "prefill_s_warm_median": statistics.median(prefill_s),
        "decode_s": res["t_decode_s"], "decode_tok_per_s": res["tok_per_s"],
        "peak_mem_bytes": peak, "mem_at_reset_bytes": mem_before,
        "plain_peak_mem_bytes": plain_peak,
        "weight_bytes": weight_bytes, "params": cfg.param_count(),
        "launches_prefill": want,
        "launches_decode": sum(dec.values()),
        "f32_logit_tol": LOGIT_TOL_F32,
        "bf16_prefill_logit_max_err_vs_plain": bf16_err,
        "bf16_tokens_equal_plain_share": float(
            (plain["tokens"] == toks).mean()),
        "plain_prefill_s": plain["t_prefill_s"],
        "plain_decode_tok_per_s": plain["tok_per_s"],
        "routing": routing, "profiles": profiles,
        "sample_tokens": toks[0, :8].tolist()}
    if cfg_check.n_units == 0:
        out["f32_check"] = "none: SERVE_CHECK_UNITS is 0"
        return out, want
    # 3. the float32 prefill at the check's depth, kernels against plain
    # versions, then one float32 decode step, which launches nothing
    cfg32 = dataclasses.replace(cfg_check, dtype="float32")
    want32 = serve_launches(cfg32)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = weights(cfg32, False)
    backend.reset_launch_counts()
    with RouteLog(moe) as rk:
        lk, cache = M.prefill(cfg32, params, prompts, max_seq)
    f32_launches = {k: backend.launch_counts()[k] for k in want32}
    with RouteLog(moe) as rp:
        lp, _ = M.prefill(cfg32, params, prompts, max_seq, impl="torch")
    check(f32_launches == want32 and {k: backend.launch_counts()[k]
                                      for k in want32} == want32,
          f"{arch}: float32 prefill launches {f32_launches}, want {want32}")
    if moe:
        routing["float32"] = routing_agreement(rk, rp)
    del rk, rp
    f32_err = max_abs_err(lk, lp)
    check(bool(torch.isfinite(lk).all()) and f32_err <= LOGIT_TOL_F32,
          f"{arch}: float32 prefill logits differ by {f32_err}"
          + (f" (routing {routing})" if moe else ""))
    nxt = torch.argmax(lk[:, -1, :cfg.vocab_size], -1)[:, None]
    M.decode_step(cfg32, params, cache, nxt, prompt)
    check({k: backend.launch_counts()[k] for k in want32} == want32,
          f"{arch}: float32 decode launched a kernel")
    out.update({
        "f32_check_peak_mem_bytes": (torch.cuda.max_memory_allocated()
                                     if cuda else 0),
        "f32_prefill_logit_max_err": f32_err,
        "f32_logit_max_abs": float(lp.abs().max())})
    return out, want


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class MoESpans:
    """While active, ``record_function`` ranges around every MoE MLP
    (``moe_mlp``) and around its expert products (``moe_experts``), so a
    profile splits the MoE's time from the rest and its dispatch and
    combine from its products."""

    def __enter__(self):
        from torch.profiler import record_function

        from repro_torch.models import layers as L
        self._layers = L
        self._saved = L.moe_forward, L._expert_ffn

        def span(name, fn):
            def inner(*a, **kw):
                with record_function(name):
                    return fn(*a, **kw)
            return inner

        L.moe_forward = span("moe_mlp", self._saved[0])
        L._expert_ffn = span("moe_experts", self._saved[1])
        return self

    def __exit__(self, *exc):
        self._layers.moe_forward, self._layers._expert_ffn = self._saved


class CrossSpans:
    """While active (``on``: for a cross-attention model), ranges of
    ``record_function`` around a cross-attention layer's q, k, v
    projections (``cross_qkv``: ``models.layers._qkv`` where k, v come
    from the media) and its flash call (``cross_flash``: the non-causal
    call; the self-attention layers of a decoder are causal), so a profile
    splits the cross layers' attention from the rest."""

    def __init__(self, on: bool = True):
        self.on = on

    def __enter__(self):
        from torch.profiler import record_function

        from repro_torch.models import layers as L
        self._layers = L
        self._saved = L._qkv, L.flash_attention
        if not self.on:
            return self
        qkv, flash = self._saved

        def cross_qkv(cfg, p, x, kv_src, dtype):
            if kv_src is x:
                return qkv(cfg, p, x, kv_src, dtype)
            with record_function("cross_qkv"):
                return qkv(cfg, p, x, kv_src, dtype)

        def cross_flash(q, k, v, **kw):
            if kw["causal"]:
                return flash(q, k, v, **kw)
            with record_function("cross_flash"):
                return flash(q, k, v, **kw)

        L._qkv, L.flash_attention = cross_qkv, cross_flash
        return self

    def __exit__(self, *exc):
        self._layers._qkv, self._layers.flash_attention = self._saved


# kernel-name parts a serve profile splits out: the flash and SSD kernels,
# and cuBLAS's products (``nvjet`` and ``gemm`` kernels)
SERVE_PARTS = ("ssd_", "flash_", "nvjet", "gemm")


def _profile_serve(cfg, params, prompts: dict, max_seq: int,
                   prompt: int) -> dict:
    """One profiled prefill and 4 profiled decode steps: device time by
    kernel and the device's busy share (and the MoE's spans, for an MoE
    model, the cross layers' attention spans for a cross-attention
    model)."""
    from repro_torch.models import model as M
    holder = {}
    cross = any(sp.mixer == "cross_attn" for sp in cfg.pattern)
    spans = (("moe_mlp", "moe_experts") if cfg.moe else ()) + \
        (("cross_qkv", "cross_flash") if cross else ())

    def prefill():
        holder["out"] = M.prefill(cfg, params, prompts, max_seq)

    with MoESpans(), CrossSpans(cross):
        out = {"prefill": profile_device(prefill, SERVE_PARTS, spans)}
        logits, cache = holder.pop("out")
        nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]

        def decode():
            c = cache
            for i in range(4):
                _, c = M.decode_step(cfg, params, c, nxt, prompt + i)

        out["decode_4_steps"] = profile_device(decode, spans=spans)
    return out


def _encode_arch(arch: str, cfg, cfg_check, dev, seed: int, shape
                 ) -> tuple[dict, dict]:
    """An encoder-only model through ``launch.serve.encode``: the bf16
    inference forward over ``batch`` rows of ``prompt`` frames at
    ``cfg``'s depth (one flash call a layer), its seconds, peak memory and
    profile; the same forward on the plain versions (logit error, the
    share of positions whose argmax agrees); and the float32 forward at
    ``cfg_check``'s depth, kernels against plain versions within
    LOGIT_TOL_F32 over every position's logits."""
    from repro_torch.kernels import backend
    from repro_torch.launch.serve import encode, prompt_batch
    from repro_torch.models import model as M
    batch, frames_len = shape[0], shape[1]
    want = serve_launches(cfg)
    cuda = dev.type == "cuda"
    frames = prompt_batch(cfg, batch, frames_len, seed, dev)

    def weights(c, cast: bool):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return M.init_params(c, g, cast=cast)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cast = weights(cfg, True)
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(cast))
    encode(cfg, batch=batch, seq_len=64, seed=seed, params=cast, device=dev)
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats()
    res = encode(cfg, batch=batch, seq_len=frames_len, seed=seed,
                 params=cast, device=dev)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    lk = res["logits"]
    check(tuple(lk.shape) == (batch, frames_len, M.padded_vocab(cfg))
          and bool(torch.isfinite(lk.float()).all()),
          f"{arch}: encode logits {tuple(lk.shape)}")
    got = {k: v for k, v in res["launches"].items() if v}
    check(got == want, f"{arch}: encode launches {got}, want {want}")
    warm = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        M.forward(cfg, cast, frames)
        sync()
        warm.append(time.perf_counter() - t0)
    plain = encode(cfg, batch=batch, seq_len=frames_len, seed=seed,
                   params=cast, device=dev, kernel_impl="torch")
    check(sum(plain["launches"].values()) == 0,
          f"{arch}: the plain run launched a kernel")
    lp = plain["logits"]
    voc = cfg.vocab_size
    out = {
        "encode_s": res["t_s"], "encode_s_warm": warm,
        "encode_s_warm_median": statistics.median(warm),
        "frames_per_s": batch * frames_len / statistics.median(warm),
        "plain_encode_s": plain["t_s"], "peak_mem_bytes": peak,
        "weight_bytes": weight_bytes, "params": cfg.param_count(),
        "launches_encode": want, "f32_logit_tol": LOGIT_TOL_F32,
        "bf16_logit_max_err_vs_plain": max_abs_err(lk.float(), lp.float()),
        "bf16_argmax_equal_plain_share": float(
            (lk[..., :voc].argmax(-1) == lp[..., :voc].argmax(-1))
            .float().mean()),
        "profiles": ({"forward": profile_device(
            lambda: M.forward(cfg, cast, frames), SERVE_PARTS)}
            if cuda else {})}
    del cast, res, plain, lk, lp
    # the float32 forward at the check's depth, kernels against plain
    cfg32 = dataclasses.replace(cfg_check, dtype="float32")
    want32 = serve_launches(cfg32)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = weights(cfg32, False)
    backend.reset_launch_counts()
    lk = M.forward(cfg32, params, frames)
    f32_launches = {k: backend.launch_counts()[k] for k in want32}
    lp = M.forward(cfg32, params, frames, impl="torch")
    check(f32_launches == want32 and {k: backend.launch_counts()[k]
                                      for k in want32} == want32,
          f"{arch}: float32 forward launches {f32_launches}, want {want32}")
    f32_err = max_abs_err(lk, lp)
    check(bool(torch.isfinite(lk).all()) and f32_err <= LOGIT_TOL_F32,
          f"{arch}: float32 logits differ by {f32_err}")
    out.update({
        "f32_check_peak_mem_bytes": (torch.cuda.max_memory_allocated()
                                     if cuda else 0),
        "f32_logit_max_err": f32_err,
        "f32_logit_max_abs": float(lp.abs().max())})
    return out, want


def phase_train(dev, seed: int, errs: dict) -> tuple[list, dict, dict]:
    """The training path on the card: (a) the flash backward kernel
    against its plain version; (b) qwen3-1.7b at full width, plain then
    secure steps; (c) the byzantine training across gloo ranks; (d) a
    crash and restart; (e) the SSD backward kernel against its plain
    version; (f) mamba2-370m at full width, plain then secure steps; (g)
    hubert-xlarge at full width and depth, plain then secure steps; (h)
    one unit of llama-3.2-vision-90b, the loss and gradients through the
    kernels and the plain versions; (i) one unit of qwen3-moe-235b,
    plain then secure steps.  Returns one JSON line a sub-run and the
    launch counts of the secure runs of (b) and (f)."""
    n = _check_flash_bwd(np.random.default_rng(seed), dev, errs)
    lines = [{"phase": "train", "part": "a_flash_bwd", "checks": n,
              "tol_atol_share_rtol": {
                  **{str(k): v for k, v in FLASH_BWD_TOL.items()},
                  "autograd torch.bfloat16": FLASH_BWD_AUTOGRAD_TOL_BF16},
              "max_abs_err": errs["flash_attention_bwd"],
              "max_abs_err_by_output": errs["flash_attention_bwd_by_output"]}]
    line, launches = _train_full(dev, seed)
    lines.append(line)
    lines.append(_train_byzantine(dev))
    lines.append(_train_restart(dev))
    t0 = time.perf_counter()
    n = _check_ssd_bwd(np.random.default_rng(seed + 1), dev, errs)
    lines.append({"phase": "train", "part": "e_ssd_bwd", "checks": n,
                  "tol_share_of_largest": SSD_BWD_TOL,
                  "da_unit_of_summands": SSD_BWD_DA_UNIT,
                  "max_abs_err": errs["ssd_bwd"],
                  "by_output": errs["ssd_bwd_by_output"],
                  "seconds": time.perf_counter() - t0})
    line, mamba_launches = _train_mamba(dev, seed)
    lines.append(line)
    lines.append(_train_hubert(dev, seed))
    lines.append(_train_vision(dev, seed))
    lines.append(_train_moe(dev, seed))
    return lines, launches, mamba_launches


def _train_full(dev, seed: int) -> tuple[dict, dict]:
    """(b): ``train_loop`` for TRAIN_STEPS plain steps, then as many
    secure steps from the same seeded init, each run's step seconds,
    peak memory and launches (counted from 0 just before the run); one
    more secure step profiled; the sync of one step's local gradients
    through the kernels and through the plain versions, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.engine import tree_flatten
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.kernels import backend
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import dp_axes_of, single_rank_mesh
    from repro_torch.launch.train import default_agg, train_loop
    from repro_torch.optim import adamw
    cfg = get_config("qwen3-1.7b")
    check_widths("qwen3-1.7b", cfg)
    B, S = SERVE_BATCH, SERVE_PROMPT
    sh = ShapeConfig("chip_train", S, B, "train")
    opt = adamw.OptConfig(state_dtype=cfg.opt_state_dtype, **TRAIN_OPT)
    agg = default_agg(1)

    def run(secure: bool):
        return _train_run(cfg, sh, opt, dev, seed, TRAIN_STEPS, secure)

    out, plain = run(False)
    del out
    torch.cuda.empty_cache()
    counts = plain["launches"]
    check(counts["flash_attention_bwd"] == TRAIN_STEPS * cfg.n_layers and
          counts["flash_attention"] ==
          TRAIN_STEPS * cfg.n_layers * (1 + cfg.remat)
          and counts["mask_encrypt"] == 0, f"plain run launches {counts}")

    out, secure = run(True)
    params = out["params"]
    del out
    torch.cuda.empty_cache()
    # the gradient elements the sync carries (the embedding's padded
    # vocab rows included), in chunks of agg.chunk_elems
    n_elems = sum(t.numel() for t in tree_flatten(params)[0])
    n_chunks = -(-n_elems // agg.chunk_elems)
    counts = secure["launches"]
    check(counts["flash_attention_bwd"] == TRAIN_STEPS * cfg.n_layers and
          counts["mask_encrypt"] == counts["unmask_decrypt"]
          == TRAIN_STEPS * n_chunks,
          f"secure run launches {counts}, want {n_chunks} chunks a step")
    # one more secure step, from the run's weights, profiled: the step's
    # and the sync's spans on the device (train_loop's and the secure
    # step's record_function), the sync's share the ratio of the two, and
    # the device's kernels in the step
    prof = profile_device(
        lambda: train_loop(cfg, steps=1, shape=sh, secure=True, opt_cfg=opt,
                           seed=seed, device=dev, params=params),
        ("flash_wgmma", "fa_dkdv_wgmma", "fa_dq_wgmma", "fa_delta",
         *SECURE_AGG_PARTS,
         "Memcpy DtoH", "Memcpy HtoD", "Memcpy DtoD", "nvjet",
         "multi_tensor_apply", "elementwise"),
        spans=("train_step", "secure_sync"))
    bwd = {p: prof["by_part"][p]
           for p in ("fa_delta", "fa_dkdv_wgmma", "fa_dq_wgmma")}
    check(all(b["launches"] > 0 for b in bwd.values()),
          f"the backward's kernels missing from the step's profile: {bwd}")
    step_ms, sync_ms = (prof["spans_ms"][k]["device"]
                        for k in ("train_step", "secure_sync"))
    prof["sync_share_of_step"] = sync_ms / step_ms
    prof["step_busy_share"] = prof["device_busy_ms"] / step_ms
    dtoh = prof["by_part"]["Memcpy DtoH"]
    check(dtoh["ms"] < 5.0, f"device-to-host copies in a one-rank secure "
          f"step: {dtoh}")
    # one step's local gradients synced through the kernels and the
    # plain versions: bit for bit
    stream = SyntheticStream(DataConfig(seq_len=S, global_batch=B,
                                        seed=seed), cfg)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.global_batch(0).items()}
    _, grads = ST.local_grads(cfg, params, batch, B * S)
    del params
    with single_rank_mesh() as mesh:
        backend.reset_launch_counts()
        a = tree_flatten(ST.tree_allreduce(grads, agg, mesh,
                                           dp_axes_of(mesh)))[0]
        ka = backend.launch_counts()
        b = tree_flatten(ST.tree_allreduce(
            grads, agg.replace(kernel_impl="torch"), mesh,
            dp_axes_of(mesh)))[0]
        check(backend.launch_counts() == ka and ka["mask_encrypt"] ==
              n_chunks, f"sync launches {ka}")
        equal = all(torch.equal(x, y) for x, y in zip(a, b))
        check(equal, "the sync's kernels and plain versions differ")
        del grads, a, b
    torch.cuda.empty_cache()
    diff = [x - y for x, y in zip(secure["losses"], plain["losses"])]
    check(all(math.isfinite(x) for x in plain["losses"] + secure["losses"]),
          "non-finite loss")
    check(max(map(abs, diff)) <= TRAIN_LOSS_TOL,
          f"secure - plain losses {diff} > {TRAIN_LOSS_TOL}")
    return {"phase": "train", "part": "b_full_width", "arch": cfg.name,
            "batch": B, "seq_len": S, "dtype": cfg.dtype,
            "remat": cfg.remat, "params": cfg.param_count(),
            "grad_elems": n_elems,
            "opt": {**TRAIN_OPT, "state_dtype": opt.state_dtype},
            "agg": {"n_nodes": agg.n_nodes, "chunk_elems": agg.chunk_elems,
                    "chunks": n_chunks, "clip": agg.clip},
            "plain": plain, "secure": secure, "secure_minus_plain": diff,
            "tol": TRAIN_LOSS_TOL, "sync_bit_equal_plain": equal,
            "profile_secure_step": prof}, counts


def _train_run(cfg, sh, opt, dev, seed: int, steps: int, secure: bool
               ) -> tuple[dict, dict]:
    """One ``train_loop`` run from the seeded init, its launch counts
    counted from 0 just before it and its peak memory from a reset just
    before it: (the loop's output, one JSON line)."""
    from repro_torch.kernels import backend
    from repro_torch.launch.train import train_loop
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    out = train_loop(cfg, steps=steps, shape=sh, secure=secure, opt_cfg=opt,
                     seed=seed, device=dev)
    counts = backend.launch_counts()
    warm = statistics.median(out["step_s"][1:])
    tokens = sh.global_batch * sh.seq_len
    line = {"losses": out["losses"], "step_s": out["step_s"],
            "step_s_median_warm": warm, "tokens_per_s": tokens / warm,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "launches": counts,
            "launches_per_step": {k: v / steps for k, v in counts.items()}}
    return out, line


def _train_mamba(dev, seed: int) -> tuple[dict, dict]:
    """(f): ``train_loop`` on mamba2-370m at full width (bf16 compute,
    float32 weights and AdamW moments, remat on), batch 4 x 2,048 from
    ``SyntheticStream``: MAMBA_STEPS plain steps, then as many secure
    steps from the same init on the one-rank mesh; each step's loss and
    seconds, tokens/s, peak memory and launches (a step with remat: 96
    ``ssd`` -- the forward, and again in the backward -- and 48
    ``ssd_bwd``); the secure losses within TRAIN_LOSS_TOL of the plain
    ones; one more plain step profiled (busy share, the scan's and the
    backward's kernels by name, each of the backward's own kernels,
    SSD_BWD_PARTS, seen in it).  Returns the line and the secure run's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config("mamba2-370m"), remat=True)
    check_widths("mamba2-370m", cfg)
    L = cfg.n_layers
    sh = ShapeConfig("chip_train", SERVE_PROMPT, SERVE_BATCH, "train")
    opt = adamw.OptConfig(state_dtype=cfg.opt_state_dtype, **TRAIN_OPT)
    lines = {}
    for secure in (False, True):
        out, line = _train_run(cfg, sh, opt, dev, seed, MAMBA_STEPS, secure)
        counts = line["launches"]
        check(counts["ssd"] == 2 * L * MAMBA_STEPS and
              counts["ssd_bwd"] == L * MAMBA_STEPS and
              counts["flash_attention"] == counts["flash_attention_bwd"] == 0
              and (counts["mask_encrypt"] > 0) == secure,
              f"mamba2 {'secure' if secure else 'plain'} launches {counts}")
        lines["secure" if secure else "plain"] = line
        params = out["params"]
        del out
        torch.cuda.empty_cache()
    prof = profile_device(
        lambda: train_loop(cfg, steps=1, shape=sh, opt_cfg=opt, seed=seed,
                           device=dev, params=params),
        ("ssd_cb", "ssd_state", "ssd_pass", "ssd_scan", *SSD_BWD_PARTS,
         "nvjet", "multi_tensor_apply", "elementwise"),
        spans=("train_step",))
    bwd = {p: prof["by_part"][p] for p in SSD_BWD_PARTS}
    check(all(b["launches"] > 0 for b in bwd.values()),
          f"the SSD backward's kernels missing from the step's profile: {bwd}")
    step_ms = prof["spans_ms"]["train_step"]["device"]
    prof["step_busy_share"] = prof["device_busy_ms"] / step_ms
    del params
    torch.cuda.empty_cache()
    plain, secure = lines["plain"], lines["secure"]
    diff = [x - y for x, y in zip(secure["losses"], plain["losses"])]
    check(all(math.isfinite(x) for x in plain["losses"] + secure["losses"]),
          "mamba2: non-finite loss")
    check(max(map(abs, diff)) <= TRAIN_LOSS_TOL,
          f"mamba2: secure - plain losses {diff} > {TRAIN_LOSS_TOL}")
    return {"phase": "train", "part": "f_mamba2", "arch": cfg.name,
            "batch": SERVE_BATCH, "seq_len": SERVE_PROMPT,
            "dtype": cfg.dtype, "remat": cfg.remat,
            "params": cfg.param_count(),
            "opt": {**TRAIN_OPT, "state_dtype": opt.state_dtype},
            "plain": plain, "secure": secure, "secure_minus_plain": diff,
            "tol": TRAIN_LOSS_TOL, "profile_plain_step": prof}, \
        secure["launches"]


def _train_steps(arch: str, cfg, dev, seed: int, part: str,
                 line: dict) -> dict:
    """TRAIN_STEPS plain steps of ``train_loop``, then as many secure
    steps from the same seeded init (batch SERVE_BATCH x SERVE_PROMPT,
    the config's own dtypes and remat); each run's losses, step seconds,
    tokens/s, peak memory and launches, the secure sync's chunks.  The
    flash backward must launch once an attention layer a step, the
    forward twice with remat, and the sync's kernels once a chunk in the
    secure run only.  Returns the part's line (``line`` merged in)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.engine import tree_flatten
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import default_agg
    from repro_torch.optim import adamw
    sh = ShapeConfig("chip_train", SERVE_PROMPT, SERVE_BATCH, "train")
    opt = adamw.OptConfig(state_dtype=cfg.opt_state_dtype, **TRAIN_OPT)
    agg = default_agg(1)
    n_attn = cfg.n_units * sum(s.mixer != "mamba2" for s in cfg.pattern)
    out = {}
    for secure in (False, True):
        res, run = _train_run(cfg, sh, opt, dev, seed, TRAIN_STEPS, secure)
        # on one rank an expert stack syncs over no axis (the reference's
        # _dp_leaf_axes: its gradient is complete along "data"), so the
        # sync carries the other leaves
        leaves = tree_flatten(res["params"])[0]
        n_elems = sum(t.numel() for t, ex in
                      zip(leaves, ST.expert_leaves(cfg, res["params"]))
                      if not ex)
        n_chunks = -(-n_elems // agg.chunk_elems)
        del leaves
        del res
        torch.cuda.empty_cache()
        c = run["launches"]
        check(c["flash_attention_bwd"] == TRAIN_STEPS * n_attn and
              c["flash_attention"] == TRAIN_STEPS * n_attn * (1 + cfg.remat)
              and c["mask_encrypt"] == c["unmask_decrypt"]
              == (TRAIN_STEPS * n_chunks if secure else 0),
              f"{arch} {'secure' if secure else 'plain'} launches {c}, "
              f"{n_attn} attention layers, {n_chunks} chunks")
        out["secure" if secure else "plain"] = run
    plain, secure = out["plain"], out["secure"]
    diff = [x - y for x, y in zip(secure["losses"], plain["losses"])]
    return {"phase": "train", "part": part, "arch": arch,
            "batch": SERVE_BATCH, "seq_len": SERVE_PROMPT,
            "dtype": cfg.dtype, "remat": cfg.remat, "n_units": cfg.n_units,
            "params": cfg.param_count(), "synced_grad_elems": n_elems,
            "opt": {**TRAIN_OPT, "state_dtype": opt.state_dtype},
            "agg": {"n_nodes": agg.n_nodes, "chunk_elems": agg.chunk_elems,
                    "chunks": n_chunks},
            "plain": plain, "secure": secure, "secure_minus_plain": diff,
            "tol": TRAIN_LOSS_TOL, **line}


def _train_hubert(dev, seed: int) -> dict:
    """(g): hubert-xlarge at full width and depth (48 units, head dim 80:
    the flash backward's hd 80 instantiation, bidirectional) on the
    synthetic stream's frames; the secure losses within TRAIN_LOSS_TOL
    of the plain ones; the first step through the kernels against the
    plain versions (``_kernels_vs_plain``, the first and last unit's
    attention weights leaf by leaf)."""
    from repro_torch.configs import get_config
    cfg = get_config("hubert-xlarge")
    check_widths("hubert-xlarge", cfg)
    line = _train_steps("hubert-xlarge", cfg, dev, seed, "g_hubert", {})
    check(all(map(math.isfinite, line["plain"]["losses"]
                  + line["secure"]["losses"])), "hubert: non-finite loss")
    check(max(map(abs, line["secure_minus_plain"])) <= TRAIN_LOSS_TOL,
          f"hubert: secure - plain losses {line['secure_minus_plain']}")
    params, batch = _first_step(cfg, dev, seed, SERVE_BATCH)
    line["check"] = _kernels_vs_plain(
        "hubert", cfg, params, batch, _attn_paths(cfg, (0, cfg.n_units - 1)))
    del params, batch
    torch.cuda.empty_cache()
    return line


def _train_moe(dev, seed: int) -> dict:
    """(i): qwen3-moe-235b-a22b at full width, TRAIN_MOE_UNITS of its 94
    units, capacity 1.25 (pairs drop): plain then secure steps, finite
    and reported; the first step's loss and gradients through the
    kernels against the plain versions (``_kernels_vs_plain``) at
    TRAIN_MOE_CHECK_BATCH.  Later steps are not gated: a bf16 routing
    flip changes the path."""
    from repro_torch.configs import get_config
    arch = "qwen3-moe-235b-a22b"
    full = get_config(arch)
    check_widths(arch, full)
    cfg = dataclasses.replace(full, n_units=TRAIN_MOE_UNITS)
    # the secure step's sync holds the gradients and their sum beside the
    # float32 weights and bf16 moments, ~66 GB: segments that grow in
    # place keep the allocator's split blocks (15 GB in a first run) from
    # failing it; the setting is put back after the part
    torch.cuda.empty_cache()
    torch._C._accelerator_setAllocatorSettings("expandable_segments:True")
    try:
        line = _train_steps(arch, cfg, dev, seed, "i_qwen3_moe",
                            {"units_of": full.n_units,
                             "allocator": "expandable_segments:True"})
        check(all(map(math.isfinite, line["plain"]["losses"]
                      + line["secure"]["losses"])),
              "qwen3-moe: non-finite loss")
        params, batch = _first_step(cfg, dev, seed, TRAIN_MOE_CHECK_BATCH)
        line["check"] = _kernels_vs_plain(
            "qwen3-moe", cfg, params, batch,
            _attn_paths(cfg, range(cfg.n_units)))
        line["check_batch_cut"] = (
            "the plain versions' float32 scores, 4.3 GB a copy at batch "
            "4, beside 30 GB of weights and gradients and the MoE "
            "layer's activations leave too thin a margin on 80 GB")
        del params, batch
    finally:
        torch.cuda.empty_cache()
        torch._C._accelerator_setAllocatorSettings(
            "expandable_segments:False")
    return line


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _attn_paths(cfg, units) -> list:
    """(name, key path) of the wq, wk and wv of each attention layer of
    the given units."""
    from repro_torch.configs.base import MAMBA2
    return [(f"unit{u}.layer{i}.{spec.mixer}.{w}",
             ("units", u, f"layer{i}", "mixer", w))
            for u in units for i, spec in enumerate(cfg.pattern)
            if spec.mixer != MAMBA2 for w in ("wq", "wk", "wv")]


def _first_step(cfg, dev, seed: int, rows: int) -> tuple:
    """``train_loop``'s seeded weights and the first ``rows`` rows of its
    first batch (SERVE_BATCH x SERVE_PROMPT), on the card."""
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.models import model as M
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = M.init_params(cfg, gen)
    stream = SyntheticStream(DataConfig(seq_len=SERVE_PROMPT,
                                        global_batch=SERVE_BATCH,
                                        seed=seed), cfg)
    batch = {k: torch.from_numpy(v[:rows].copy()).to(dev)
             for k, v in stream.global_batch(0).items()}
    return params, batch


def _grads_of(cfg, params, batch: dict, impl, keep=()) -> tuple:
    """One loss and gradient computation (``impl`` as ``loss_fn``'s):
    ({loss, grad norm, seconds, peak bytes}, {name: the gradient at each
    ``keep`` path}); the other gradients are dropped."""
    from repro_torch.core.engine import tree_flatten
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    leaves, rebuild = tree_flatten(params)
    tokens = batch["labels"].numel()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        loss = M.loss_fn(cfg, params, batch, total_tokens=tokens, impl=impl)
        grads = rebuild(list(torch.autograd.grad(loss, leaves)))
    gnorm = float(adamw.global_norm(grads))
    loss = float(loss.detach())
    seconds = time.perf_counter() - t0
    for p in leaves:
        p.requires_grad_(False)
    kept = {name: _at(grads, path) for name, path in keep}
    del grads
    return {"loss": loss, "grad_norm": gnorm, "seconds": seconds,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}, kept


def _kernels_vs_plain(what: str, cfg, params, batch: dict, keep) -> dict:
    """The loss and gradients of one step on ``params`` and ``batch``
    through the kernels and through the plain versions (``impl="torch"``,
    which must launch no kernel), and through the plain versions in
    float32 compute as the yardstick of bf16 rounding: the loss and grad
    norm within TRAIN_LOSS_TOL relative; each ``keep`` leaf's gradient
    within the larger of TRAIN_LEAF_TOL and twice the plain bf16 run's
    own error against float32, as shares of the plain leaf's largest
    |entry|.  Returns the comparison for the part's line."""
    from repro_torch.kernels import backend
    runs = {}
    for name, c, impl in (("kernels", cfg, None), ("plain", cfg, "torch"),
                          ("plain_f32", dataclasses.replace(
                              cfg, dtype="float32"), "torch")):
        backend.reset_launch_counts()
        runs[name] = (*_grads_of(c, params, batch, impl, keep),
                      backend.launch_counts())
    (kern, kg, kc), (plain, pg, pc), (f32, fg, fc) = runs.values()
    check(kc["flash_attention_bwd"] > 0 and not any(pc.values())
          and not any(fc.values()),
          f"{what}: launches through the kernels {kc}, the plain "
          f"versions {pc}, in float32 {fc}")
    rel = {k: abs(kern[k] - plain[k]) / abs(plain[k])
           for k in ("loss", "grad_norm")}

    def share(a, b):
        return max_abs_err(a, b) / float(b.abs().max())
    leaf = {n: {"kernels": share(kg[n], pg[n]),
                "plain_vs_f32": share(pg[n], fg[n])} for n in pg}
    for v in leaf.values():
        v["tol"] = max(TRAIN_LEAF_TOL, 2 * v["plain_vs_f32"])
    check(all(math.isfinite(r[k]) for r in (kern, plain, f32)
              for k in ("loss", "grad_norm"))
          and max(rel.values()) <= TRAIN_LOSS_TOL
          and all(v["kernels"] <= v["tol"] for v in leaf.values()),
          f"{what}: kernels against plain versions {rel}, leaves (shares "
          f"of the largest entry) {leaf}")
    return {"batch": int(batch["labels"].shape[0]), "kernels": kern,
            "plain": plain, "plain_f32": f32, "rel_diff": rel,
            "tol": TRAIN_LOSS_TOL, "leaf_err_share_of_largest": leaf,
            "leaf_tol_floor": TRAIN_LEAF_TOL, "kernel_launches": kc}


def _train_vision(dev, seed: int) -> dict:
    """(h): llama-3.2-vision-90b at full width, one unit of its 20 (4 self
    layers and a cross layer to 4,096 seeded media tokens), float32
    weights, bf16 compute: the loss and gradients of one step through
    the kernels at SERVE_BATCH x SERVE_PROMPT (twice: the second timed),
    then at TRAIN_VISION_CHECK_BATCH through the kernels against the
    plain versions (``_kernels_vs_plain``, the cross layer's and the
    first self layer's attention weights leaf by leaf).  No optimizer step: weights, gradients and
    AdamW's moments would not fit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import backend
    arch = "llama-3.2-vision-90b"
    full = get_config(arch)
    check_widths(arch, full)
    cfg = dataclasses.replace(full, n_units=1)
    params, batch = _first_step(cfg, dev, seed, SERVE_BATCH)
    n_attn = len(cfg.pattern)
    runs = []
    for _ in range(2):
        backend.reset_launch_counts()
        runs.append(_grads_of(cfg, params, batch, None)[0])
        c = backend.launch_counts()
        check(c["flash_attention_bwd"] == n_attn and c["flash_attention"]
              == n_attn * (1 + cfg.remat), f"llama-vision launches {c}")
    b = TRAIN_VISION_CHECK_BATCH
    small = {k: v[:b] for k, v in batch.items()}
    del batch
    torch.cuda.empty_cache()
    from repro_torch.configs.base import CROSS_ATTN
    cross = [i for i, sp in enumerate(cfg.pattern) if sp.mixer == CROSS_ATTN]
    keep = [(n, p) for n, p in _attn_paths(cfg, (0,))
            if p[2] in (f"layer{cross[0]}", "layer0")]
    chk = _kernels_vs_plain("llama-vision", cfg, params, small, keep)
    check(all(math.isfinite(r[k]) for r in runs
              for k in ("loss", "grad_norm")), "llama-vision: non-finite")
    del params, small
    torch.cuda.empty_cache()
    warm = runs[1]
    tokens = SERVE_BATCH * SERVE_PROMPT
    return {"phase": "train", "part": "h_llama_vision", "arch": arch,
            "n_units": 1, "units_of": full.n_units,
            "media_tokens": cfg.n_media_tokens, "batch": SERVE_BATCH,
            "seq_len": SERVE_PROMPT, "dtype": cfg.dtype,
            "remat": cfg.remat, "params": cfg.param_count(),
            "what": "loss and gradients of one step, no optimizer step",
            "loss": warm["loss"], "grad_norm": warm["grad_norm"],
            "step_s": [r["seconds"] for r in runs],
            "step_s_warm": warm["seconds"],
            "tokens_per_s": tokens / warm["seconds"],
            "peak_mem_bytes": warm["peak_mem_bytes"],
            "launches_per_step": c, "check": chk,
            "check_batch_cut": "the plain versions' float32 score tensors "
                               "(8.6 GB a cross-layer copy at batch 4) "
                               "do not fit beside the weights and "
                               "gradients"}


def _train_byzantine(dev) -> dict:
    """(c): ``launch.byzantine_training`` on the card."""
    from repro_torch.launch import byzantine_training as BT
    t0 = time.perf_counter()
    out = BT.run(ranks=BYZ_RANKS, steps=BYZ_STEPS, device=str(dev))
    check(out["max_dev_secure"] < BT.TOL,
          f"byzantine: secure deviates {out['max_dev_secure']}")
    sec = out["secure"]["launches"]
    check(sec["vote_combine"] > 0 and sec["flash_attention_bwd"] > 0,
          f"byzantine launches {sec}")
    return {"phase": "train", "part": "c_byzantine", "seconds":
            time.perf_counter() - t0, **out}


def _train_restart(dev) -> dict:
    """(d): the reference's crash / restart case on the card: qwen3
    smoke, a crash at step 10 after a checkpoint at step 8."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import FailurePlan, InjectedCrash
    cfg = get_smoke_config("qwen3-1.7b")
    kw = dict(steps=16, shape=ShapeConfig("t", 64, 4, "train"),
              opt_cfg=adamw.OptConfig(lr=1e-3, warmup_steps=5,
                                      total_steps=100, grad_clip=1.0),
              log_every=1000, device=dev)
    ref = train_loop(cfg, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        try:
            train_loop(cfg, ckpt_dir=ck, ckpt_every=8,
                       failure_plan=FailurePlan(crash_at_steps=(10,)), **kw)
            crashed = False
        except InjectedCrash:
            crashed = True
        out = train_loop(cfg, ckpt_dir=ck, ckpt_every=8, **kw)
    rel = abs(out["losses"][-1] - ref["losses"][-1]) / abs(ref["losses"][-1])
    check(crashed and out["resumed_from"] == 8 and rel <= RESTART_RTOL,
          f"restart: crashed {crashed}, resumed from {out['resumed_from']},"
          f" last loss rel diff {rel}")
    return {"phase": "train", "part": "d_restart", "arch": cfg.name,
            "dtype": cfg.dtype, "resumed_from": out["resumed_from"],
            "losses_uninterrupted": ref["losses"],
            "losses_resumed": out["losses"], "last_rel_diff": rel,
            "rtol": RESTART_RTOL}


# ---------------------------------------------------------------------------
# tp: tensor parallelism over "model", gloo ranks on the one card
# ---------------------------------------------------------------------------

# (a) qwen3-1.7b and (b) mamba2-370m at full width and depth on a (1, 2)
# mesh, served at the serve phase's shape; the float32 gate at a cut
# depth ("check_units": the first units of the same draw): the prefill's
# logits and those of "check_decode" decode steps fed seeded tokens
# (teacher-forced, the same on both sides), against the one-rank float32
# prefill and decode steps within LOGIT_TOL_F32; (c) one secure training
# step of qwen3-1.7b at full width, "train_units" of its 28 units, in
# float32, on a (2, 2) mesh against the one-rank secure step, loss and
# grad norm within TRAIN_LOSS_TOL relative.  Each rank's flash attention
# runs at H / 2 = 8 query and K / 2 = 4 KV heads (the serve at
# TP_FLASH_CASE, the training step's forward and backward at
# TP_TRAIN_FLASH_CASE: its 2 dp rows of the global batch of 4 at 1,024
# positions), its SSD scan at 16 of mamba2's 32 heads: the kernels are
# held at those shapes too.
TP_SHAPE = {"archs": ("qwen3-1.7b", "mamba2-370m"), "tp": 2,
            "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
            "check_units": {"qwen3-1.7b": 4, "mamba2-370m": 8},
            "check_decode": 4,
            "train_units": 2, "train_batch": 4, "train_seq": 1024,
            "smoke": False}
TP_FLASH_CASE = (4, 2048, 2048, 8, 4, 128, True, 0)
TP_TRAIN_FLASH_CASE = (2, 1024, 1024, 8, 4, 128, True, 0)
TP_SSD_CASE = (4, 2048, 16, 64, 128)       # (B, S, H, P, N) per rank


def _tp_cfg(arch: str, shape: dict):
    from repro_torch.configs import get_config, get_smoke_config
    return (get_smoke_config if shape["smoke"] else get_config)(arch)


def _tp_weights(cfg, seed: int, dev, cast: bool):
    """The seeded draw (float32 masters, or cast as drawn), the same on
    every rank and in this process."""
    from repro_torch.models import model as M
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return M.init_params(cfg, g, cast=cast)


def _tp_forced(cfg, shape: dict, seed: int, dev) -> torch.Tensor:
    """The tokens the float32 check's decode steps are fed, (B, steps),
    the same on every rank and in this process."""
    return torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (shape["batch"], shape["check_decode"]),
        dtype=np.int32)).to(dev)


def _tp_f32_check(params, prompts: dict, forced: torch.Tensor, prefill,
                  decode) -> torch.Tensor:
    """The float32 check's logits: the prefill's last position, then one
    a teacher-forced decode step, (B, 1 + steps, Vp) on the CPU.
    ``prefill(params, prompts)`` and ``decode(params, cache, tokens, t)``
    are the mesh's step builders or the one-rank model functions."""
    logits, cache = prefill(params, prompts)
    got = [logits.float().cpu()]
    PL = prompts["tokens"].shape[1]
    for i in range(forced.shape[1]):
        logits, cache = decode(params, cache, forced[:, i:i + 1], PL + i)
        got.append(logits.float().cpu())
    return torch.cat(got, dim=1)


# tp (a)'s bf16 cut decode against the one-rank decode on the same cache
BF16_R_GATE, BF16_EQ_GATE = 0.05, 0.99


def _bf16_cut_decode(cfg, params, mesh, shape: dict, seed: int, dev
                     ) -> dict:
    """tp (a)'s check of the cut decode in bfloat16, on one rank of the
    serve's mesh: the first attention layer's bf16 cache as the serve
    builds it (``_unit_prefill`` of the rank's first unit on a seeded
    residual stream of the serve's batch and prompt, the cache at the
    serve's length, cut on its positions), one seeded token's q of every
    head at the prompt's last position; ``decode_attention_cut`` on the
    rank's block against ``decode_attention`` on the blocks gathered.  r
    is rms(cut - one) / rms(one - one in float32 on the same bf16
    values), eq the share of outputs bit-equal to the one-rank decode."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as ST
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.runtime import context as C
    B, PL = shape["batch"], shape["prompt"]
    max_seq = ST.cache_len(PL + shape["gen"], B, mesh)
    ctx, _ = ST.serve_ctx(cfg, mesh,
                          ShapeConfig("tp_bf16", max_seq, B, "decode"))
    rng = np.random.default_rng(seed + 5)
    x = torch.from_numpy(rng.standard_normal(
        (B, PL, cfg.d_model), np.float32)).to(dev, torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal(
        (B, 1, cfg.n_heads, cfg.hd), np.float32)).to(dev, torch.bfloat16)
    t = PL - 1
    with C.use_ctx(ctx), torch.no_grad():
        _, cache = M._unit_prefill(cfg, params["units"][0], x, None,
                                   max_seq=max_seq, impl=None)
        kb, vb = cache["layer0"]["k"], cache["layer0"]["v"]
        n, j = C.cache_cut(ctx)
        got = L.decode_attention_cut(q, kb, vb, t, lo=j * kb.shape[1])
        k, v = (torch.cat(list(C.cut_gather(ctx, c)), dim=1)
                for c in (kb, vb))
        one = L.decode_attention(q, k, v, t)
        one32 = L.decode_attention(q.float(), k.float(), v.float(), t)
    got, one = got.float(), one.float()
    r = float(torch.sqrt(torch.mean((got - one) ** 2))
              / torch.sqrt(torch.mean((one - one32) ** 2)))
    return {"r": r, "equal_share": float((got == one).float().mean()),
            "dtype": str(kb.dtype), "blocks": n, "cache_len": max_seq,
            "block_shape": list(kb.shape), "t": t,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "hd": cfg.hd,
            "r_gate": BF16_R_GATE, "equal_share_gate": BF16_EQ_GATE}


def _tp_serve_rank(rank: int, seed: int, job_dir: str, shape: dict,
                   d_dir: Optional[str] = None,
                   d_shape: Optional[dict] = None) -> None:
    """One rank of tp (a) / (b): for each arch the full draw from the
    seed (every rank the same), ``serve`` on the (1, tp) mesh (this
    rank's slice cut by ``shard_tree``), its launches counted from 0
    before it, its peak memory, its cache bytes; then the float32
    prefill and teacher-forced decode steps at the cut depth, whose
    logits rank 0 writes beside ``tp{r}.json``.  With ``d_dir`` the rank
    then runs tp2 (d) at ``d_shape`` (default TP2_SHAPE) into it (one
    spawn of 2 processes fewer)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import backend
    from repro_torch.launch import serve as SV
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device(shape["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    mesh = make_host_mesh(data=1, model=shape["tp"])
    B, PL, gen = shape["batch"], shape["prompt"], shape["gen"]
    out = {"rank": rank}
    for arch in shape["archs"]:
        cfg = _tp_cfg(arch, shape)
        # this rank's slice of the bf16 draw, the full tree gone before
        # the timed serve, so its peak is the rank's own footprint
        cast = SH.shard_tree(cfg, _tp_weights(cfg, seed, dev, True), mesh)
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in _leaves(cast))
        # a short serve first: cuBLAS, the kernels and the allocator warm
        SV.serve(cfg, mesh, batch=B, prompt_len=64, gen=2, params=cast,
                 device=dev)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        backend.reset_launch_counts()
        res = SV.serve(cfg, mesh, batch=B, prompt_len=PL, gen=gen,
                       seed=seed, params=cast, device=dev)
        counts = backend.launch_counts()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        bf16_cut = (_bf16_cut_decode(cfg, cast, mesh, shape, seed, dev)
                    if cfg.pattern[0].mixer == "attn" else None)
        del cast
        np.save(pathlib.Path(job_dir) / f"tokens-{arch}-{rank}.npy",
                res["tokens"])
        cfg32 = dataclasses.replace(
            cfg, n_units=shape["check_units"][arch], dtype="float32")
        max_seq = PL + shape["check_decode"]
        pre, _ = ST.build_prefill_step(
            cfg32, mesh, ShapeConfig("tp_check", PL, B, "prefill"),
            max_seq=max_seq)
        dec, _ = ST.build_decode_step(
            cfg32, mesh, ShapeConfig("tp_check", max_seq, B, "decode"))
        params = SH.shard_tree(cfg32, _tp_weights(cfg32, seed, dev, False),
                               mesh)
        logits = _tp_f32_check(
            params, SV.prompt_batch(cfg32, B, PL, seed, dev, mesh),
            _tp_forced(cfg32, shape, seed, dev), pre, dec)
        np.save(pathlib.Path(job_dir) / f"logits-{arch}-{rank}.npy",
                logits.numpy())
        del params, logits
        if cuda:
            torch.cuda.empty_cache()
        out[arch] = {
            "prefill_s": res["t_prefill_s"], "decode_s": res["t_decode_s"],
            "decode_tok_per_s": res["tok_per_s"], "peak_mem_bytes": peak,
            "weight_bytes": weight_bytes, "cache_bytes": res["cache_bytes"],
            "launches": {k: v for k, v in counts.items() if v},
            "launches_prefill": {k: v for k, v in
                                 res["launches"]["prefill"].items() if v},
            "launches_decode": sum(res["launches"]["decode"].values()),
            "bf16_cut_decode": bf16_cut}
    (pathlib.Path(job_dir) / f"tp{rank}.json").write_text(json.dumps(out))
    if d_dir is not None:
        if cuda:
            torch.cuda.empty_cache()
        _tp2_train_rank(rank, seed, d_dir, dict(d_shape or TP2_SHAPE,
                                                device=shape["device"]))


def _tp_train_cfg(shape: dict):
    return dataclasses.replace(
        _tp_cfg("qwen3-1.7b", shape), n_units=shape["train_units"],
        dtype="float32", dp_mode="replicated")


def _tp_train_rank(rank: int, seed: int, job_dir: str, shape: dict
                   ) -> None:
    """One rank of tp (c): one secure step on the (2, 2) mesh from the
    seeded float32 draw (this rank's slice) on its dp rows of the
    stream's first global batch, its launches counted from 0."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.kernels import backend
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import default_agg
    from repro_torch.optim import adamw
    from repro_torch.runtime.compat import flat_node_id
    dev = torch.device(shape["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    mesh = make_host_mesh(data=2, model=2)
    cfg = _tp_train_cfg(shape)
    GB, S = shape["train_batch"], shape["train_seq"]
    params = SH.shard_tree(cfg, _tp_weights(cfg, seed, dev, False), mesh)
    opt = adamw.OptConfig(state_dtype=cfg.opt_state_dtype, **TRAIN_OPT)
    state = adamw.init_opt_state(opt, params)
    step, _ = ST.build_secure_train_step(
        cfg, mesh, default_agg(2), opt_cfg=opt,
        shape=ShapeConfig("tp_train", S, GB, "train"))
    rows = GB // 2
    r = flat_node_id(mesh, ("data",))
    batch = {k: torch.from_numpy(v[r * rows:(r + 1) * rows].copy()).to(dev)
             for k, v in SyntheticStream(DataConfig(
                 seq_len=S, global_batch=GB, seed=seed),
                 cfg).global_batch(0).items()}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    params, state, m = step(params, state, batch)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    step_s = time.perf_counter() - t0
    (pathlib.Path(job_dir) / f"train{rank}.json").write_text(json.dumps({
        "rank": rank, "loss": loss, "grad_norm": gnorm, "step_s": step_s,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated() if cuda
                           else 0),
        "launches": {k: v for k, v in backend.launch_counts().items()
                     if v}}))


def _rank_kernels(rng, dev, errs: dict, tag: str, flash_cases,
                  ssd_case, bwd_cases) -> dict:
    """The kernels at a rank's shapes: flash attention at each of
    ``flash_cases`` in float32 and bf16 against its plain version, on
    the card its backward at ``bwd_cases`` (``_check_flash_bwd``: the
    kernel against ``attention_bwd_ref`` and autograd through both
    kernels against the plain one's, at FLASH_BWD_TOL; the backward
    kernel has no CPU form), and the SSD scan at ``ssd_case`` (B, S, H,
    P, N); the errors also into ``errs``.  Returns {kernel: {"shape",
    "max_abs_err", ...}}."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd_chunked
    flash_err = 0.0
    for case in flash_cases:
        B, Sq, Skv, H, K, hd, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (B, S, n, hd), np.float32)).to(dev, dtype)
                for S, n in ((Sq, H), (Skv, K), (Skv, K)))
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention(q, k, v, causal=causal, window=window,
                                   impl="torch")
            err = max_abs_err(got.float(), want.float())
            check(within(got, want, FLASH_TOL[dtype], FLASH_TOL[dtype]),
                  f"{tag} flash_attention {dtype} {case}: max err {err}")
            flash_err = max(flash_err, err)
            del q, k, v, got, want
    errs["flash_attention"] = max(errs["flash_attention"], flash_err)
    out = {"flash_attention": {"shape": [list(c) for c in flash_cases],
                               "max_abs_err": flash_err}}
    if dev.type == "cuda":
        bwd = {"flash_attention_bwd": 0.0}
        n = _check_flash_bwd(rng, dev, bwd, cases=bwd_cases)
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"],
                                          bwd["flash_attention_bwd"])
        out["flash_attention_bwd"] = {
            "shape": [list(c) for c in bwd_cases],
            "max_abs_err": bwd["flash_attention_bwd"], "checks": n,
            "by_output": bwd["flash_attention_bwd_by_output"]}
    Bsz, S, Hs, P, N = ssd_case
    args = _ssd_inputs(rng, dev, Bsz, S, Hs, P, N=N, per_head=False)
    got = ssd_chunked(*args, 256)
    want = ssd_chunked(*args, 256, impl="torch")
    ssd_err = max(max_abs_err(g, w) for g, w in zip(got, want))
    check(all(within(g, w, *SSD_TOL) for g, w in zip(got, want)),
          f"{tag} ssd {tuple(ssd_case)}: max err {ssd_err}")
    errs["ssd"] = max(errs["ssd"], ssd_err)
    out["ssd"] = {"shape": [list(ssd_case)], "max_abs_err": ssd_err}
    return out


def _rank_info(prefix: str, kern: dict, per_rank: dict) -> dict:
    """For the kernels line: each kernel's rank shapes, error, timing
    (where timed) and launches a rank, under ``prefix``'s keys."""
    def timed(name, key):
        return kern.get(name, {}).get("timing", {}).get(key)

    return {name: {f"{prefix}_shape": kern.get(name, {}).get("shape"),
                   f"{prefix}_max_abs_err": kern.get(name, {}).get(
                       "max_abs_err"),
                   f"{prefix}_ms": timed(name, "ms"),
                   f"{prefix}_plain_ms": timed(name, "plain_ms"),
                   f"{prefix}_bound_ms": timed(name, "bound_ms"),
                   f"{prefix}_library_ms": timed(name, "library_ms"),
                   f"{prefix}_launches_per_rank": per_rank.get(name)}
            for name in set(kern) | set(per_rank)}


def _tp_kernels(rng, dev, errs: dict) -> dict:
    """The kernels at a TP rank's shapes (``_rank_kernels``): flash
    attention at qwen3's 8 query over 4 KV heads (the serve's
    TP_FLASH_CASE and the training step's TP_TRAIN_FLASH_CASE), its
    backward at the training step's, the SSD scan at 16 of mamba2's
    heads; on the card the forward's and the scan's timings
    (``time_flash`` / ``time_ssd`` at the serve's heads)."""
    out = _rank_kernels(rng, dev, errs, "tp",
                        [TP_FLASH_CASE, TP_TRAIN_FLASH_CASE], TP_SSD_CASE,
                        [TP_TRAIN_FLASH_CASE])
    if dev.type == "cuda":
        _, _, _, H, K, hd, _, _ = TP_FLASH_CASE
        _, _, Hs, _, N = TP_SSD_CASE
        out["flash_attention"]["timing"] = time_flash(rng, dev, H=H, K=K,
                                                      hd=hd)
        out["ssd"]["timing"] = time_ssd(rng, dev, H=Hs, N=N)
    return out


def phase_tp(dev, seed: int, errs: dict, shape: Optional[dict] = None,
             d_dir: Optional[str] = None, d_shape: Optional[dict] = None
             ) -> tuple[dict, dict]:
    """Tensor parallelism over "model" on gloo ranks of the one card:
    (a) / (b) ``serve`` on a (1, 2) mesh against the one-rank serve and
    float32 prefill, (c) a secure step on a (2, 2) mesh against the
    one-rank secure step, and the kernels at the ranks' shapes.  Returns
    the line and, for the kernels line, the per-rank shapes and
    launches.  ``shape`` overrides TP_SHAPE (``smoke=True`` and small
    serve shapes in a CPU rehearsal).  With ``d_dir`` the serve's ranks
    then run tp2 (d) at ``d_shape`` into it (``_tp_serve_rank``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.launch import serve as SV
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import single_rank_mesh
    from repro_torch.launch.train import default_agg
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime.compat import spawn_nodes
    shape = dict(TP_SHAPE, **(shape or {}), device=str(dev))
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    B, PL, gen = shape["batch"], shape["prompt"], shape["gen"]
    out = {"phase": "tp", "tp": shape["tp"], "batch": B, "prompt_len": PL,
           "gen": gen, "f32_logit_tol": LOGIT_TOL_F32,
           "train_loss_rtol": TRAIN_LOSS_TOL}
    kern = _tp_kernels(rng, dev, errs)
    out["kernels_at_rank_shapes"] = kern
    if cuda:
        torch.cuda.empty_cache()
    job = pathlib.Path(tempfile.mkdtemp(prefix="tp-phase-"))
    try:
        # (a), (b): the serve on its ranks, then the one-rank references
        t0 = time.perf_counter()
        spawn_nodes(_tp_serve_rank, shape["tp"], seed, str(job), shape,
                    d_dir, d_shape)
        out["serve_spawn_s"] = time.perf_counter() - t0
        ranks = [json.loads((job / f"tp{r}.json").read_text())
                 for r in range(shape["tp"])]
        per_rank: dict = {}
        for arch in shape["archs"]:
            cfg = _tp_cfg(arch, shape)
            want = serve_launches(cfg)
            toks = [np.load(job / f"tokens-{arch}-{r}.npy")
                    for r in range(shape["tp"])]
            logits = [np.load(job / f"logits-{arch}-{r}.npy")
                      for r in range(shape["tp"])]
            for r, rk in enumerate(ranks):
                check(np.array_equal(toks[r], toks[0])
                      and np.array_equal(logits[r], logits[0]),
                      f"tp {arch}: rank {r}'s tokens or logits differ from "
                      "rank 0's")
                cut = rk[arch]["bf16_cut_decode"]
                check(cut is None or (cut["r"] <= BF16_R_GATE
                                      and cut["equal_share"]
                                      >= BF16_EQ_GATE),
                      f"tp {arch} rank {r}: the bf16 cut decode against "
                      f"the one-rank decode {cut}")
                if cuda:
                    check(rk[arch]["launches_prefill"] == want
                          and rk[arch]["launches_decode"] == 0,
                          f"tp {arch} rank {r}: prefill launches "
                          f"{rk[arch]['launches_prefill']}, want {want}")
            # the one-rank bf16 serve of the same draw, warmed as the
            # ranks' is by a short serve first: its tokens and times
            w = _tp_weights(cfg, seed, dev, True)
            SV.serve(cfg, batch=B, prompt_len=64, gen=2, params=w,
                     device=dev)
            one = SV.serve(cfg, batch=B, prompt_len=PL, gen=gen, seed=seed,
                           params=w, device=dev)
            del w
            agree = float((one["tokens"] == toks[0]).mean())
            # the one-rank float32 prefill and decode steps at the cut
            # depth, fed the same tokens
            cfg32 = dataclasses.replace(
                cfg, n_units=shape["check_units"][arch], dtype="float32")
            max_seq = PL + shape["check_decode"]
            ref = _tp_f32_check(
                _tp_weights(cfg32, seed, dev, False),
                SV.prompt_batch(cfg32, B, PL, seed, dev),
                _tp_forced(cfg32, shape, seed, dev),
                lambda p, b: M.prefill(cfg32, p, b, max_seq),
                lambda p, c, t, i: M.decode_step(cfg32, p, c, t, i))
            got = torch.from_numpy(logits[0])
            err = max_abs_err(got[:, :1], ref[:, :1])
            dec_err = max_abs_err(got[:, 1:], ref[:, 1:])
            check(np.isfinite(logits[0]).all() and err <= LOGIT_TOL_F32
                  and dec_err <= LOGIT_TOL_F32,
                  f"tp {arch}: float32 logits at {cfg32.n_units} units "
                  f"differ from one rank's by {err} (prefill), {dec_err} "
                  f"({shape['check_decode']} decode steps)")
            if cuda:
                torch.cuda.empty_cache()
            out[arch] = {
                "n_units": cfg.n_units, "dtype": cfg.dtype,
                "by_rank": [rk[arch] for rk in ranks],
                "prefill_launches_want": want,
                "f32_check_units": cfg32.n_units,
                "f32_prefill_logit_max_err_vs_one_rank": err,
                "f32_check_decode_steps": shape["check_decode"],
                "f32_decode_logit_max_err_vs_one_rank": dec_err,
                "f32_logit_max_abs": float(ref.abs().max()),
                "bf16_tokens_equal_one_rank_share": agree,
                "bf16_cut_decode": ranks[0][arch]["bf16_cut_decode"],
                "one_rank_prefill_s": one["t_prefill_s"],
                "one_rank_decode_tok_per_s": one["tok_per_s"],
                "one_rank_cache_bytes": one["cache_bytes"]}
            for k, v in ranks[0][arch]["launches_prefill"].items():
                per_rank.setdefault(k, {})[arch] = v
        # (c): the secure step on the (2, 2) mesh, then on one rank
        t0 = time.perf_counter()
        spawn_nodes(_tp_train_rank, 4, seed, str(job), shape)
        out["train_spawn_s"] = time.perf_counter() - t0
        tr = [json.loads((job / f"train{r}.json").read_text())
              for r in range(4)]
    finally:
        shutil.rmtree(job, ignore_errors=True)
    cfg = _tp_train_cfg(shape)
    GB, S = shape["train_batch"], shape["train_seq"]
    opt = adamw.OptConfig(state_dtype=cfg.opt_state_dtype, **TRAIN_OPT)
    with single_rank_mesh() as one_mesh:
        params = _tp_weights(cfg, seed, dev, False)
        step, _ = ST.build_secure_train_step(
            cfg, one_mesh, default_agg(1), opt_cfg=opt,
            shape=ShapeConfig("tp_train", S, GB, "train"))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticStream(
            DataConfig(seq_len=S, global_batch=GB, seed=seed),
            cfg).global_batch(0).items()}
        _, _, m = step(params, adamw.init_opt_state(opt, params), batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        del params, batch
    for r in tr:
        for what, got, want in (("loss", r["loss"], loss),
                                ("grad norm", r["grad_norm"], gnorm)):
            check(math.isfinite(got) and abs(got - want)
                  <= TRAIN_LOSS_TOL * abs(want),
                  f"tp (c) rank {r['rank']}: {what} {got} against one "
                  f"rank's {want}")
        if cuda:
            check(r["launches"].get("flash_attention", 0) > 0
                  and r["launches"].get("flash_attention_bwd", 0) > 0
                  and r["launches"].get("mask_encrypt", 0) > 0,
                  f"tp (c) rank {r['rank']}: launches {r['launches']}")
    out["train"] = {"arch": cfg.name, "mesh": [2, 2],
                    "n_units": cfg.n_units, "dtype": cfg.dtype,
                    "batch": GB, "seq_len": S, "by_rank": tr,
                    "one_rank_loss": loss, "one_rank_grad_norm": gnorm}
    for k, v in tr[0]["launches"].items():
        per_rank.setdefault(k, {})["train_secure_step"] = v
    info = _rank_info("tp", kern, per_rank)
    return out, info



# ---------------------------------------------------------------------------
# tp2: seq_parallel, the vocabulary-parallel loss, the padded head split
# ---------------------------------------------------------------------------

# (d) one baseline training step (AdamW) of qwen3-1.7b and of mamba2-370m
# at full width, "units" of their units, float32, on a (1, 2) mesh of 2
# gloo ranks, the global batch of "batch" x "seq" tokens whole on both:
# with seq_parallel=True (the residual stream cut on the sequence; the
# vocabulary-parallel loss, which every TP step now takes), then the
# same step without seq_parallel, then (rank 0) the one-rank step with
# its whole logits; loss and grad norm within TRAIN_LOSS_TOL relative of
# one rank's, each step's peak.  (e) llama4-maverick's two attention
# layers of its unit (attn_chunked, window 8,192, then attn) at full
# width, float32, on a (1, 16) mesh of 16 ranks, its 40 query heads
# padded to 48 (3 a rank, one KV head a rank): their output and the
# input's gradient on "e_batch" x "e_seq" seeded positions against the
# unpadded layers on one rank within LOGIT_TOL_F32.  The kernels at the
# ranks' shapes: flash and its backward at (d)'s qwen3-1.7b rank (4 x
# 1,024, 8 / 4 heads, hd 128, causal) and at (e)'s (1 x 2,048, 3 / 1
# heads, hd 128, with the window and with the full causal mask), the SSD
# scan and its backward at mamba2's (1, 2) rank under seq_parallel (16
# heads, the whole sequence).  (f) the same two layers as the serving
# path runs them (``models.model._unit_prefill`` / ``_unit_decode``: the
# norm, the attention, the cache), float32, on the (1, 16) mesh, batch
# "f_batch": the prefill of "f_prompt" seeded positions of the residual
# stream, then "f_decode" steps, against one rank with the whole cache
# within LOGIT_TOL_F32 of the largest entry; the cache cut on its
# positions over "model" (the window's 8,192 slots in 512-slot blocks:
# the tail of 2,048 spans four ranks' blocks), a rank's cache bytes 1/16
# of one rank's.
TP2_SHAPE = {"archs": ("qwen3-1.7b", "mamba2-370m"), "units": 2,
             "batch": 4, "seq": 1024,
             "e_arch": "llama4-maverick-400b-a17b", "e_tp": 16,
             "e_batch": 1, "e_seq": 2048, "e_heads": None, "smoke": False,
             "f_batch": 1, "f_prompt": 10240, "f_decode": 16,
             # (B, Sq, Skv, H, K, hd, causal, window) and (B, S, H, P, N)
             # a rank
             "flash_cases": [(4, 1024, 1024, 8, 4, 128, True, 0),
                             (1, 2048, 2048, 3, 1, 128, True, 8192),
                             (1, 2048, 2048, 3, 1, 128, True, 0)],
             "ssd_case": (4, 1024, 16, 64, 128)}


def _tp2_cfg(arch: str, shape: dict, sp: bool):
    return dataclasses.replace(
        _tp_cfg(arch, shape), n_units=shape["units"], dtype="float32",
        dp_mode="replicated", seq_parallel=sp)


def _tp2_step(cfg, mesh, shape: dict, seed: int, dev) -> dict:
    """One baseline step (AdamW) from the seeded float32 draw (this
    rank's slice on a mesh) on the stream's first global batch, whole on
    the rank: loss, grad norm, seconds, peak bytes, launches, and the
    bytes of each collective kind."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.kernels import backend
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw
    from repro_torch.runtime import context as C
    cuda = dev.type == "cuda"
    params = _tp_weights(cfg, seed, dev, False)
    if mesh is not None:
        params = SH.shard_tree(cfg, params, mesh)
    opt = adamw.OptConfig(state_dtype=cfg.opt_state_dtype, **TRAIN_OPT)
    state = adamw.init_opt_state(opt, params)
    GB, S = shape["batch"], shape["seq"]
    step, _ = ST.build_train_step(cfg, opt, ShapeConfig("tp2", S, GB,
                                                        "train"), mesh)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticStream(
        DataConfig(seq_len=S, global_batch=GB, seed=seed),
        cfg).global_batch(0).items()}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    C.reset_collective_counts()
    t0 = time.perf_counter()
    params, state, m = step(params, state, batch)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    out = {"loss": loss, "grad_norm": gnorm,
           "step_s": time.perf_counter() - t0,
           "peak_mem_bytes": (torch.cuda.max_memory_allocated() if cuda
                              else 0),
           "launches": {k: v for k, v in backend.launch_counts().items()
                        if v},
           "collective_bytes": {k: v["bytes"] for k, v in
                                C.collective_counts().items()}}
    del params, state, batch
    if cuda:
        torch.cuda.empty_cache()
    return out


def _tp2_train_rank(rank: int, seed: int, job_dir: str, shape: dict
                    ) -> None:
    """One rank of tp2 (d): after a warm-up step, for each arch the step
    with seq_parallel, then without, on the (1, 2) mesh; rank 0 then the
    one-rank step."""
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device(shape["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_host_mesh(data=1, model=2)
    # one untimed step first: cuBLAS, the kernels, the allocator and the
    # gloo paths warm (the first step took ~14 s against ~1.2)
    _tp2_step(_tp2_cfg(shape["archs"][0], shape, True), mesh, shape, seed,
              dev)
    out = {"rank": rank}
    for arch in shape["archs"]:
        out[arch] = {
            "seq_parallel": _tp2_step(_tp2_cfg(arch, shape, True), mesh,
                                      shape, seed, dev),
            "no_seq_parallel": _tp2_step(_tp2_cfg(arch, shape, False), mesh,
                                         shape, seed, dev)}
    if rank == 0:
        for arch in shape["archs"]:
            out[arch]["one_rank"] = _tp2_step(_tp2_cfg(arch, shape, False),
                                              None, shape, seed, dev)
    (pathlib.Path(job_dir) / f"tp2d{rank}.json").write_text(json.dumps(out))


def _tp2_attn_cfg(shape: dict):
    cfg = _tp_cfg(shape["e_arch"], shape)
    if shape["e_heads"]:
        H, K = shape["e_heads"]
        cfg = dataclasses.replace(cfg, n_heads=H, n_kv_heads=K)
    return dataclasses.replace(cfg, dtype="float32")


def _tp2_attn(cfg, shape: dict, seed: int, dev, mesh) -> tuple:
    """(e)'s two attention layers of the unit on the seeded input: the
    output, the input's gradient for a seeded dO, the launches and the
    seconds of the forward and backward (the first call: set-up
    included); on a mesh this rank's slice of the seeded weights, under
    the step's context."""
    from repro_torch.configs.base import ATTN, ATTN_CHUNKED
    from repro_torch.kernels import backend
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import layers as L
    from repro_torch.runtime.context import DistCtx, use_ctx
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    layers = {"chunked": {"mixer": L.make_attn_params(cfg, g)},
              "full": {"mixer": L.make_attn_params(cfg, g)}}
    ctx = DistCtx()
    if mesh is not None:
        layers = SH.shard_tree(cfg, layers, mesh)
        ctx = ST.dist_ctx(cfg, mesh)
    rng = np.random.default_rng(seed + 2)
    B, S, D = shape["e_batch"], shape["e_seq"], cfg.d_model
    x, dy = (torch.from_numpy(rng.standard_normal((B, S, D), np.float32))
             .to(dev) for _ in range(2))
    x.requires_grad_(True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    with use_ctx(ctx):
        h = L.attn_forward(cfg, layers["chunked"]["mixer"], x,
                           mixer=ATTN_CHUNKED)
        y = L.attn_forward(cfg, layers["full"]["mixer"], h, mixer=ATTN)
        (dx,) = torch.autograd.grad(y, x, dy)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counts = {k: v for k, v in backend.launch_counts().items() if v}
    return y.detach(), dx, counts, time.perf_counter() - t0


def _tp2_attn_rank(rank: int, seed: int, job_dir: str, shape: dict
                   ) -> None:
    """One rank of tp2 (e): the padded layers on the (1, e_tp) mesh;
    rank 0 writes the output and the gradient, every rank their
    digests."""
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device(shape["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_host_mesh(data=1, model=shape["e_tp"])
    cfg = _tp2_attn_cfg(shape)
    t0 = time.perf_counter()
    y, dx, counts, fwd_bwd_s = _tp2_attn(cfg, shape, seed, dev, mesh)
    sec = time.perf_counter() - t0
    y, dx = y.cpu().numpy(), dx.cpu().numpy()
    if rank == 0:
        np.save(pathlib.Path(job_dir) / "e_y.npy", y)
        np.save(pathlib.Path(job_dir) / "e_dx.npy", dx)
    (pathlib.Path(job_dir) / f"tp2e{rank}.json").write_text(json.dumps({
        "rank": rank, "s": sec, "fwd_bwd_s": fwd_bwd_s,
        "launches": counts,
        "y_sha": hashlib.sha256(y.tobytes()).hexdigest(),
        "dx_sha": hashlib.sha256(dx.tobytes()).hexdigest()}))


def _tp2_cache(cfg, shape: dict, seed: int, dev, mesh) -> dict:
    """(f): the unit's two attention layers (the chunked one, then the
    global one; no MLP) through the serving path's unit prefill and
    decode on the seeded residual stream: the prefill's last position
    and each step's output (float32, on the CPU), the cache's bytes, the
    collective bytes by kind of the prefill and of the steps, the
    launches and the seconds of each.  On a mesh, this rank's slice of
    the seeded weights under the serving context (the cache cut on its
    positions)."""
    from repro_torch.configs.base import (ATTN, ATTN_CHUNKED, NONE,
                                          LayerSpec, ShapeConfig)
    from repro_torch.kernels import backend
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.runtime import context as C
    cfg = dataclasses.replace(cfg, n_units=1, pattern=(
        LayerSpec(ATTN_CHUNKED, NONE), LayerSpec(ATTN, NONE)))
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 3)
    unit = {f"layer{i}": {"norm1": L.make_norm_params(cfg, g),
                          "mixer": L.make_attn_params(cfg, g)}
            for i in range(2)}
    B, P, steps = shape["f_batch"], shape["f_prompt"], shape["f_decode"]
    ctx = C.DistCtx()
    if mesh is not None:
        unit = SH.shard_tree(cfg, {"units": [unit]}, mesh)["units"][0]
        ctx = ST.serve_ctx(cfg, mesh, ShapeConfig("f", P + steps, B,
                                                  "decode"))[0]
    rng = np.random.default_rng(seed + 4)
    x = torch.from_numpy(rng.standard_normal((B, P, cfg.d_model),
                                             np.float32)).to(dev)
    xs = torch.from_numpy(rng.standard_normal((steps, B, 1, cfg.d_model),
                                              np.float32)).to(dev)
    out = {}
    with C.use_ctx(ctx), torch.no_grad():
        _sync(dev)
        backend.reset_launch_counts()
        C.reset_collective_counts()
        t0 = time.perf_counter()
        y, cache = M._unit_prefill(cfg, unit, x, None, max_seq=P + steps,
                                   impl=None)
        _sync(dev)
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_launches"] = {k: v for k, v in
                                   backend.launch_counts().items() if v}
        out["prefill_collective_bytes"] = {
            k: v["bytes"] for k, v in C.collective_counts().items()}
        ys = [y[:, -1:].cpu()]
        del y
        backend.reset_launch_counts()
        C.reset_collective_counts()
        t0 = time.perf_counter()
        for i in range(steps):
            yi, cache = M._unit_decode(cfg, unit, cache, xs[i], P + i)
            ys.append(yi.cpu())
        _sync(dev)
        out["decode_s"] = time.perf_counter() - t0
        out["decode_launches"] = sum(backend.launch_counts().values())
        out["decode_collective_bytes"] = {
            k: v["bytes"] for k, v in C.collective_counts().items()}
    out["cache_bytes"] = sum(t.numel() * t.element_size()
                             for layer in cache.values()
                             for t in layer.values())
    out["cache_shapes"] = {f"{name}/{k}": list(t.shape)
                           for name, layer in cache.items()
                           for k, t in layer.items()}
    out["y"] = torch.cat(ys, dim=1)
    return out


def _tp2_cache_rank(rank: int, seed: int, job_dir: str, shape: dict
                    ) -> None:
    """One rank of tp2 (f) on the (1, e_tp) mesh: rank 0 writes the
    outputs, every rank their digest and its figures."""
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device(shape["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.empty_cache()
    mesh = make_host_mesh(data=1, model=shape["e_tp"])
    res = _tp2_cache(_tp2_attn_cfg(shape), shape, seed, dev, mesh)
    y = res.pop("y").numpy()
    if rank == 0:
        np.save(pathlib.Path(job_dir) / "f_y.npy", y)
    res.update(rank=rank, y_sha=hashlib.sha256(y.tobytes()).hexdigest())
    (pathlib.Path(job_dir) / f"tp2f{rank}.json").write_text(json.dumps(res))


def _tp2_ef_rank(rank: int, seed: int, job_dir: str, shape: dict) -> None:
    """One rank of tp2 (e), then (f), in one process."""
    _tp2_attn_rank(rank, seed, job_dir, shape)
    _tp2_cache_rank(rank, seed, job_dir, shape)


def _mesh_then_tp2e_rank(rank: int, seed: int, job_dir: str, shape: dict,
                         e_dir: str) -> None:
    """A mesh phase rank, then tp2 (e) and (f) at TP2_SHAPE in the same
    process and gloo group of N_MESH = e_tp ranks (one spawn of 16
    processes fewer): their files into ``e_dir``, read by
    ``phase_tp2``."""
    _mesh_rank(rank, seed, job_dir, shape)
    if shape["device"].startswith("cuda"):
        torch.cuda.empty_cache()
    _tp2_ef_rank(rank, seed, e_dir, dict(TP2_SHAPE, device=shape["device"]))


def _tp2_kernels(rng, dev, errs: dict, shape: dict) -> dict:
    """The kernels at tp2's rank shapes (``_rank_kernels``): flash
    attention and its backward at (d)'s qwen3 rank (8 query heads over 4
    KV heads) and at (e)'s (3 query heads over 1 KV head, hd 128, the
    window and the full causal mask), the SSD scan at (d)'s mamba2 rank
    (16 heads, the whole sequence), and on the card its backward there
    (``_check_ssd_bwd``, no initial state or final state's gradient, as
    the training step has neither); on the card the flash forward and
    backward timed at (e)'s shape with the full mask (the window masks
    nothing at 2,048)."""
    cases = shape["flash_cases"]
    out = _rank_kernels(rng, dev, errs, "tp2", cases, shape["ssd_case"],
                        cases)
    if dev.type == "cuda":
        bwd = {"ssd_bwd": 0.0}
        case = tuple(shape["ssd_case"]) + (False, False)
        n = _check_ssd_bwd(rng, dev, bwd, cases=[case])
        errs["ssd_bwd"] = max(errs["ssd_bwd"], bwd["ssd_bwd"])
        out["ssd_bwd"] = {"shape": [list(case)],
                          "max_abs_err": bwd["ssd_bwd"], "checks": n,
                          "by_output": bwd["ssd_bwd_by_output"]}
        B, Sq, _, H, K, hd, _, _ = cases[-1]
        out["flash_attention"]["timing"] = time_flash(rng, dev, H=H, K=K,
                                                      hd=hd, B=B, S=Sq)
        out["flash_attention_bwd"]["timing"] = time_flash_bwd(
            rng, dev, H=H, K=K, hd=hd, B=B, S=Sq)
    return out


CUT_KINDS = ("tp_cache_a2a", "tp_decode_qkv", "tp_decode_combine")


def _tp2_cache_check(cfg, shape: dict, seed: int, dev, f: list,
                     fy: torch.Tensor) -> dict:
    """tp2 (f) against one rank with the whole cache: every rank's
    outputs equal, rank 0's within LOGIT_TOL_F32 of the largest entry
    of one rank's, a rank's cache 1/e_tp of one rank's, the cut's
    collectives made (one a layer in the prefill, three a layer a step),
    the flash kernel launched once a layer in the prefill and nothing
    in decode."""
    tp = shape["e_tp"]
    one = _tp2_cache(cfg, shape, seed, dev, None)
    ref = one.pop("y")
    err = max_abs_err(fy, ref)
    scale = float(ref.abs().max())
    for r in f:
        check(r["y_sha"] == f[0]["y_sha"],
              f"tp2 (f) rank {r['rank']}: outputs differ from rank 0's")
        check(r["cache_bytes"] * tp == one["cache_bytes"],
              f"tp2 (f) rank {r['rank']}: cache {r['cache_bytes']} bytes, "
              f"one rank's {one['cache_bytes']} over {tp}")
        got = {**r["prefill_collective_bytes"],
               **r["decode_collective_bytes"]}
        check(all(got.get(k, 0) > 0 for k in CUT_KINDS),
              f"tp2 (f) rank {r['rank']}: collectives {got}")
        if dev.type == "cuda":
            check(r["prefill_launches"].get("flash_attention", 0) == 2
                  and r["decode_launches"] == 0,
                  f"tp2 (f) rank {r['rank']}: launches "
                  f"{r['prefill_launches']}, {r['decode_launches']} in "
                  "decode")
    check(torch.isfinite(fy).all() and err <= LOGIT_TOL_F32 * scale,
          f"tp2 (f): the cut cache's outputs differ from one rank's by "
          f"{err} (largest entry {scale})")
    return {"arch": cfg.name, "mesh": [1, tp], "batch": shape["f_batch"],
            "prompt": shape["f_prompt"], "decode_steps": shape["f_decode"],
            "max_err_vs_one_rank": err, "rel_err_vs_one_rank": err / scale,
            "max_abs": scale,
            "rank_cache_bytes": f[0]["cache_bytes"],
            "one_rank_cache_bytes": one["cache_bytes"],
            "rank_cache_shapes": f[0]["cache_shapes"],
            "one_rank_cache_shapes": one["cache_shapes"],
            "rank_cut_bytes": {k: {**f[0]["prefill_collective_bytes"],
                                   **f[0]["decode_collective_bytes"]}.get(k)
                               for k in CUT_KINDS},
            "rank_prefill_collective_bytes":
                f[0]["prefill_collective_bytes"],
            "rank_decode_collective_bytes": f[0]["decode_collective_bytes"],
            "rank_prefill_s": [r["prefill_s"] for r in f],
            "rank_decode_s": [r["decode_s"] for r in f],
            "one_rank_prefill_s": one["prefill_s"],
            "one_rank_decode_s": one["decode_s"],
            "rank_prefill_launches": f[0]["prefill_launches"],
            "one_rank_prefill_launches": one["prefill_launches"]}


def phase_tp2(dev, seed: int, errs: dict, shape: Optional[dict] = None,
              e_dir: Optional[str] = None, d_dir: Optional[str] = None
              ) -> tuple[dict, dict]:
    """seq_parallel, the vocabulary-parallel loss and the padded head
    split on gloo ranks of the one card: (d) a (1, 2) training step of
    qwen3-1.7b and mamba2-370m with and without seq_parallel against one
    rank's, (e) llama4-maverick's attention layers at TP 16 against the
    unpadded layers on one rank, (f) the same layers' prefill and decode
    over the cache cut on its positions against one rank's whole cache,
    and the kernels at the ranks' shapes.  Returns the line and, for the
    kernels line, the per-rank shapes and launches.  ``shape`` overrides
    TP2_SHAPE (``smoke=True`` and small shapes in a CPU rehearsal).  With
    ``e_dir`` (e) and (f) have run in the mesh phase's ranks at
    TP2_SHAPE, with ``d_dir`` (d) in the tp phase's ranks, and their
    files are read from there."""
    from repro_torch.runtime.compat import spawn_nodes
    shape = dict(TP2_SHAPE, **(shape or {}), device=str(dev))
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    out = {"phase": "tp2", "train_loss_rtol": TRAIN_LOSS_TOL,
           "f32_tol": LOGIT_TOL_F32}
    kern = _tp2_kernels(rng, dev, errs, shape)
    out["kernels_at_rank_shapes"] = kern
    if cuda:
        torch.cuda.empty_cache()
    job = pathlib.Path(tempfile.mkdtemp(prefix="tp2-phase-"))
    per_rank: dict = {}
    try:
        # (d): the steps on the (1, 2) ranks, rank 0 also alone, spawned
        # here unless the tp phase's ranks ran them
        d_job = job if d_dir is None else pathlib.Path(d_dir)
        if d_dir is None:
            t0 = time.perf_counter()
            spawn_nodes(_tp2_train_rank, 2, seed, str(job), shape)
            out["d_spawn_s"] = time.perf_counter() - t0
        out["d_in_tp_spawn"] = d_dir is not None
        d = [json.loads((d_job / f"tp2d{r}.json").read_text())
             for r in range(2)]
        for arch in shape["archs"]:
            one = d[0][arch]["one_rank"]
            for r, rk in enumerate(d):
                for run in ("seq_parallel", "no_seq_parallel"):
                    got = rk[arch][run]
                    for what in ("loss", "grad_norm"):
                        check(math.isfinite(got[what])
                              and abs(got[what] - one[what])
                              <= TRAIN_LOSS_TOL * abs(one[what]),
                              f"tp2 (d) {arch} {run} rank {r}: {what} "
                              f"{got[what]} against one rank's {one[what]}")
                    sp = rk[arch]["seq_parallel"]["collective_bytes"]
                    check("tp_seq_gather" in sp and "tp_loss" in sp
                          and "tp_cat" not in sp,
                          f"tp2 (d) {arch} rank {r}: collectives {sp}")
                    if cuda:
                        want = ("flash_attention", "flash_attention_bwd") \
                            if arch == "qwen3-1.7b" else ("ssd", "ssd_bwd")
                        check(all(got["launches"].get(k, 0) > 0
                                  for k in want),
                              f"tp2 (d) {arch} {run} rank {r}: launches "
                              f"{got['launches']}")
            out[arch] = {"mesh": [1, 2], "n_units": shape["units"],
                         "batch": shape["batch"], "seq_len": shape["seq"],
                         "by_rank": [rk[arch] for rk in d]}
            for k, v in d[0][arch]["seq_parallel"]["launches"].items():
                per_rank.setdefault(k, {})[f"d_{arch}"] = v
        # (e): the padded attention on the (1, e_tp) ranks, spawned here
        # unless the mesh phase's ranks ran it
        e_job = job if e_dir is None else pathlib.Path(e_dir)
        if e_dir is None:
            t0 = time.perf_counter()
            spawn_nodes(_tp2_ef_rank, shape["e_tp"], seed, str(job), shape)
            out["e_spawn_s"] = time.perf_counter() - t0
        out["e_in_mesh_spawn"] = e_dir is not None
        e = [json.loads((e_job / f"tp2e{r}.json").read_text())
             for r in range(shape["e_tp"])]
        y = torch.from_numpy(np.load(e_job / "e_y.npy"))
        dx = torch.from_numpy(np.load(e_job / "e_dx.npy"))
        f = [json.loads((e_job / f"tp2f{r}.json").read_text())
             for r in range(shape["e_tp"])]
        fy = torch.from_numpy(np.load(e_job / "f_y.npy"))
    finally:
        shutil.rmtree(job, ignore_errors=True)
    for r in e:
        check(r["y_sha"] == e[0]["y_sha"] and r["dx_sha"] == e[0]["dx_sha"],
              f"tp2 (e) rank {r['rank']}: output or gradient differ from "
              "rank 0's")
        if cuda:
            check(r["launches"].get("flash_attention", 0) == 2
                  and r["launches"].get("flash_attention_bwd", 0) == 2,
                  f"tp2 (e) rank {r['rank']}: launches {r['launches']}")
    cfg = _tp2_attn_cfg(shape)
    y1, dx1, one_counts, one_s = _tp2_attn(cfg, shape, seed, dev, None)
    y_err = max_abs_err(y, y1.cpu())
    dx_err = max_abs_err(dx, dx1.cpu())
    check(torch.isfinite(y).all() and y_err <= LOGIT_TOL_F32
          and dx_err <= LOGIT_TOL_F32,
          f"tp2 (e): padded layers differ from one rank's by {y_err} "
          f"(output), {dx_err} (input gradient)")
    from repro_torch.launch import sharding as SH
    from repro_torch.models import layers as L
    out["e"] = {"arch": cfg.name, "mesh": [1, shape["e_tp"]],
                "heads": [cfg.n_heads, cfg.n_kv_heads],
                "padded_heads": cfg.n_heads + SH.pad_heads(cfg,
                                                          shape["e_tp"]),
                "rank_heads": len(L.q_heads(cfg, shape["e_tp"], 0)),
                "batch": shape["e_batch"], "seq_len": shape["e_seq"],
                "y_max_err_vs_one_rank": y_err,
                "dx_max_err_vs_one_rank": dx_err,
                "y_max_abs": float(y1.abs().max()),
                "dx_max_abs": float(dx1.abs().max()),
                "rank_s": [r["s"] for r in e],
                "rank_fwd_bwd_s": [r["fwd_bwd_s"] for r in e],
                "one_rank_fwd_bwd_s": one_s,
                "by_rank_launches": e[0]["launches"],
                "one_rank_launches": one_counts}
    del y1, dx1
    for k, v in e[0]["launches"].items():
        per_rank.setdefault(k, {})["e_llama4_attn"] = v
    out["f"] = _tp2_cache_check(cfg, shape, seed, dev, f, fy)
    for k, v in f[0]["prefill_launches"].items():
        per_rank.setdefault(k, {})["f_llama4_prefill"] = v
    info = _rank_info("tp2", kern, per_rank)
    return out, info


# fsdp: command-r-35b (dp_mode="fsdp", the smallest dense config that
# uses FSDP) at full width on a (2, 1) ("data", "model") mesh of 2 gloo
# ranks on the one card, float32: (a) the loss and gradients of one step
# at ``units`` units on the global batch, (b) the prefill at
# ``prefill_units``, each against one rank's; (c) the dry run of
# ``dry_cells`` in subprocesses (no card): qwen3-moe's train_4k on the
# pod mesh (its 16 x 16 cell traces the same code less the pooled
# dispatch) and llama4's prefill_32k.  (a) runs 1 unit: at 2 a rank
# peaks at 36.6 GiB (the tied embedding's weight and two gradient
# buffers of 7.8 GiB each at the end of the backward), and two such
# ranks ran the card out of memory in one of three runs
FSDP_SHAPE = {"arch": "command-r-35b", "units": 1, "batch": 4,
              "seq": 1024, "prefill_units": 2, "prefill_batch": 4,
              "prefill_prompt": 2048, "smoke": False,
              "dry_cells": (("qwen3-moe-235b-a22b", "train_4k", True),
                            ("llama4-maverick-400b-a17b", "prefill_32k",
                             False))}
# (a)'s rank shape: 2 sequences of 1,024, all 64 query over 8 KV heads
FSDP_FLASH_CASE = (2, 1024, 1024, 64, 8, 128, True, 0)


def _fsdp_cfg(shape: dict, units: int):
    cfg = dataclasses.replace(_tp_cfg(shape["arch"], shape), n_units=units,
                              dtype="float32")
    check(cfg.dp_mode == "fsdp", f"{cfg.name}: dp_mode {cfg.dp_mode}")
    return cfg


def _fsdp_batch(cfg, shape: dict, seed: int, dev, rows: slice) -> dict:
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    return {k: torch.from_numpy(v[rows].copy()).to(dev)
            for k, v in SyntheticStream(DataConfig(
                seq_len=shape["seq"], global_batch=shape["batch"],
                seed=seed), cfg).global_batch(0).items()}


def _fsdp_grads(cfg, params, batch: dict, total: int, mesh) -> tuple:
    """(loss, grad norm) of one baseline step's loss and synced gradients
    (no update): on ``mesh`` through the step's own sync."""
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw
    from repro_torch.runtime.context import use_ctx
    with use_ctx(ST.dist_ctx(cfg, mesh, sharded_batch=True)):
        loss, grads = ST.local_grads(cfg, params, batch, total)
    ST.sync_grads_(cfg, loss, grads, mesh)
    gnorm = ST.grad_norm(cfg, grads, mesh) if mesh is not None \
        else adamw.global_norm(grads)
    return float(loss), float(gnorm)


def _fsdp_rank(rank: int, seed: int, job_dir: str, shape: dict) -> None:
    """One rank of fsdp (a) / (b): this rank's FSDP slice of the seeded
    float32 draw (``shard_tree(..., fsdp="data")``), (a) the loss and
    synced gradients of its rows of the global batch, its seconds, peak
    memory, collectives and launches; (b) the prefill of its rows, whose
    logits it writes beside ``fsdp{r}.json``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import backend
    from repro_torch.launch import serve as SV
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import context
    dev = torch.device(shape["device"])
    cuda = dev.type == "cuda"
    if cuda:
        # two ranks of ~30 GB share the card: expandable segments keep
        # the caching allocator's fragmentation from adding ~9 GB a rank
        torch._C._accelerator_setAllocatorSettings(
            "expandable_segments:True")
        torch.cuda.set_device(dev)
    mesh = make_host_mesh(data=2, model=1)
    cfg = _fsdp_cfg(shape, shape["units"])
    params = SH.shard_tree(cfg, _tp_weights(cfg, seed, dev, False), mesh,
                           fsdp=ST.fsdp_axis(cfg, mesh))
    n_cut = sum(SH.fsdp_dim(cfg, p, t) is not None
                for p, t in SH._leaves_with_paths(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    rows = shape["batch"] // 2
    batch = _fsdp_batch(cfg, shape, seed, dev,
                        slice(rank * rows, (rank + 1) * rows))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    context.reset_collective_counts()
    t0 = time.perf_counter()
    loss, gnorm = _fsdp_grads(cfg, params, batch,
                              shape["batch"] * shape["seq"], mesh)
    step_s = time.perf_counter() - t0
    out = {"rank": rank, "loss": loss, "grad_norm": gnorm,
           "step_s": step_s, "fsdp_leaves": n_cut,
           "weight_bytes": weight_bytes,
           "peak_mem_bytes": (torch.cuda.max_memory_allocated() if cuda
                              else 0),
           "collectives": context.collective_counts(),
           "launches": {k: v for k, v in backend.launch_counts().items()
                        if v}}
    del params, batch
    if cuda:
        torch.cuda.empty_cache()
    cfg = _fsdp_cfg(shape, shape["prefill_units"])
    B, PL = shape["prefill_batch"], shape["prefill_prompt"]
    params = SH.shard_tree(cfg, _tp_weights(cfg, seed, dev, False), mesh,
                           fsdp=ST.fsdp_axis(cfg, mesh))
    pre, _ = ST.build_prefill_step(cfg, mesh,
                                   ShapeConfig("fsdp_pre", PL, B, "prefill"))
    prompts = SV.prompt_batch(cfg, B, PL, seed, dev, mesh)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    context.reset_collective_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _ = pre(params, prompts)
    logits = logits.float().cpu()
    out["prefill"] = {
        "s": time.perf_counter() - t0,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated() if cuda
                           else 0),
        "collectives": context.collective_counts(),
        "launches": {k: v for k, v in backend.launch_counts().items() if v}}
    np.save(pathlib.Path(job_dir) / f"fsdp-logits-{rank}.npy",
            logits.numpy())
    (pathlib.Path(job_dir) / f"fsdp{rank}.json").write_text(json.dumps(out))


def _fsdp_dryrun(cells) -> list:
    """Start ``python -m repro_torch.launch.dryrun`` for each cell, side by
    side (each in a process of its own, on the CPU)."""
    env = dict(os.environ)
    src = str(pathlib.Path(__file__).resolve().parent / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out_dir = tempfile.mkdtemp(prefix="fsdp-dryrun-")
    procs = []
    for arch, shape, multi_pod in cells:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out-dir", out_dir]
        if multi_pod:
            cmd.append("--multi-pod")
        procs.append(((arch, shape, multi_pod), time.perf_counter(),
                      subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)))
    return [out_dir, procs]


def _fsdp_dryrun_read(started) -> list:
    """Wait for the dry-run processes; each record's terms, trace seconds
    and whether CUDA stayed uninitialized."""
    out_dir, procs = started
    res = []
    try:
        for (arch, shape, multi_pod), t0, proc in procs:
            stdout, stderr = proc.communicate(timeout=600)
            # read after (a) and (b): an upper bound on the process's time
            done_within = time.perf_counter() - t0
            what = f"fsdp (c) dryrun {arch} {shape} multi_pod={multi_pod}"
            check(proc.returncode == 0,
                  f"{what}: rc {proc.returncode}: {stderr[-2000:]}")
            lines = stdout.strip().splitlines()
            check(lines and lines[-1] == "torch.cuda.is_initialized() = "
                  "False", f"{what}: {lines[-2:]}")
            mesh = "2x16x16" if multi_pod else "16x16"
            rec = json.loads((pathlib.Path(out_dir)
                              / f"{arch}_{shape}_{mesh}.json").read_text())
            check("refused" not in rec and rec["counted"]["flops"] > 0,
                  f"{what}: {rec.get('refused')}")
            res.append({"arch": arch, "shape": shape, "mesh": mesh,
                        "terms_estimate": rec["terms"],
                        "trace_s": rec["t_lower_s"],
                        "done_within_s": done_within,
                        "memory_estimate": rec["memory"],
                        "collective_bytes": rec["counted"][
                            "collective_bytes"],
                        "kernels_meta": rec["counted"]["kernels"],
                        "useful_flops_ratio": rec["useful_flops_ratio"],
                        "cuda_initialized": False})
    finally:
        for _, _, proc in procs:
            proc.kill()
        shutil.rmtree(out_dir, ignore_errors=True)
    return res


def _fsdp_kernels(rng, dev, errs: dict) -> dict:
    """Flash attention and its backward at (a)'s rank shape
    (FSDP_FLASH_CASE) against ``impl="torch"`` in float32 and bf16, at
    FLASH_TOL / FLASH_BWD_TOL (the backward: the card only)."""
    from repro_torch.kernels.flash_attention import flash_attention
    B, Sq, Skv, H, K, hd, causal, window = FSDP_FLASH_CASE
    flash_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, S, n, hd), np.float32)).to(dev, dtype)
            for S, n in ((Sq, H), (Skv, K), (Skv, K)))
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention(q, k, v, causal=causal, window=window,
                               impl="torch")
        err = max_abs_err(got.float(), want.float())
        check(within(got, want, FLASH_TOL[dtype], FLASH_TOL[dtype]),
              f"fsdp flash_attention {dtype} {FSDP_FLASH_CASE}: max err "
              f"{err}")
        flash_err = max(flash_err, err)
        del q, k, v, got, want
    errs["flash_attention"] = max(errs["flash_attention"], flash_err)
    out = {"flash_attention": {"shape": [list(FSDP_FLASH_CASE)],
                               "max_abs_err": flash_err}}
    if dev.type == "cuda":
        bwd = {"flash_attention_bwd": 0.0}
        n = _check_flash_bwd(rng, dev, bwd, cases=[FSDP_FLASH_CASE])
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"],
                                          bwd["flash_attention_bwd"])
        out["flash_attention_bwd"] = {
            "shape": [list(FSDP_FLASH_CASE)],
            "max_abs_err": bwd["flash_attention_bwd"], "checks": n,
            "by_output": bwd["flash_attention_bwd_by_output"]}
    return out


def phase_fsdp(dev, seed: int, errs: dict, shape: Optional[dict] = None
               ) -> tuple[dict, dict]:
    """FSDP over "data" on 2 gloo ranks of the one card: (a) the loss and
    grad norm of one step of command-r-35b against one rank's, (b) the
    float32 FSDP prefill against one rank's, (c) the dry run of
    FSDP_SHAPE's cells in subprocesses (started first, read last; they
    must leave CUDA uninitialized), and flash and its backward at (a)'s
    rank shape.  Returns the line and, for the kernels line, the shapes
    and launches.  ``shape`` overrides FSDP_SHAPE (``smoke=True`` and
    small shapes in a CPU rehearsal)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M
    from repro_torch.runtime.compat import spawn_nodes
    shape = dict(FSDP_SHAPE, **(shape or {}), device=str(dev))
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    dry = _fsdp_dryrun(shape["dry_cells"])
    out = {"phase": "fsdp", "arch": shape["arch"], "mesh": [2, 1],
           "dtype": "float32", "train_loss_rtol": TRAIN_LOSS_TOL,
           "f32_logit_tol": LOGIT_TOL_F32}
    kern = _fsdp_kernels(rng, dev, errs)
    out["kernels_at_rank_shapes"] = kern
    if cuda:
        torch.cuda.empty_cache()
        out["parent_mem_bytes"] = {
            "allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved()}
    job = pathlib.Path(tempfile.mkdtemp(prefix="fsdp-phase-"))
    try:
        t0 = time.perf_counter()
        spawn_nodes(_fsdp_rank, 2, seed, str(job), shape)
        out["spawn_s"] = time.perf_counter() - t0
        ranks = [json.loads((job / f"fsdp{r}.json").read_text())
                 for r in range(2)]
        logits = torch.cat([torch.from_numpy(
            np.load(job / f"fsdp-logits-{r}.npy")) for r in range(2)])
    finally:
        shutil.rmtree(job, ignore_errors=True)
    # (a) one rank's loss and grad norm on the whole batch
    cfg = _fsdp_cfg(shape, shape["units"])
    params = _tp_weights(cfg, seed, dev, False)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, gnorm = _fsdp_grads(cfg, params, _fsdp_batch(
        cfg, shape, seed, dev, slice(None)), shape["batch"] * shape["seq"],
        None)
    one_s = time.perf_counter() - t0
    one_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del params
    for r in ranks:
        for what, got, want in (("loss", r["loss"], loss),
                                ("grad norm", r["grad_norm"], gnorm)):
            check(math.isfinite(got) and abs(got - want)
                  <= TRAIN_LOSS_TOL * abs(want),
                  f"fsdp (a) rank {r['rank']}: {what} {got} against one "
                  f"rank's {want}")
        check(r["fsdp_leaves"] > 0, f"fsdp (a) rank {r['rank']}: no FSDP "
              "slice")
        check(r["collectives"].get("fsdp_gather", {}).get("calls", 0) > 0
              and r["collectives"].get("fsdp_scatter", {}).get("calls", 0)
              > 0, f"fsdp (a) rank {r['rank']}: {r['collectives']}")
        if cuda:
            check(r["launches"].get("flash_attention", 0) > 0
                  and r["launches"].get("flash_attention_bwd", 0) > 0,
                  f"fsdp (a) rank {r['rank']}: launches {r['launches']}")
    # (b) one rank's float32 prefill
    if cuda:
        torch.cuda.empty_cache()
    cfg = _fsdp_cfg(shape, shape["prefill_units"])
    B, PL = shape["prefill_batch"], shape["prefill_prompt"]
    params = _tp_weights(cfg, seed, dev, False)
    with torch.no_grad():
        ref, _ = M.prefill(cfg, params, SV.prompt_batch(cfg, B, PL, seed,
                                                        dev), PL)
    ref = ref.float().cpu()
    del params
    err = max_abs_err(logits, ref)
    check(bool(torch.isfinite(logits).all()) and err <= LOGIT_TOL_F32,
          f"fsdp (b): prefill logits differ from one rank's by {err}")
    if cuda:
        for r in ranks:
            check(r["prefill"]["launches"].get("flash_attention", 0)
                  == cfg.n_units, f"fsdp (b) rank {r['rank']}: "
                  f"{r['prefill']['launches']}")
        torch.cuda.empty_cache()
    out["train"] = {"n_units": shape["units"], "batch": shape["batch"],
                    "seq_len": shape["seq"], "by_rank": ranks,
                    "one_rank_loss": loss, "one_rank_grad_norm": gnorm,
                    "one_rank_s": one_s, "one_rank_peak_mem_bytes": one_peak}
    out["prefill"] = {"n_units": shape["prefill_units"], "batch": B,
                      "prompt_len": PL,
                      "f32_logit_max_err_vs_one_rank": err,
                      "f32_logit_max_abs": float(ref.abs().max())}
    # (c) the dry run's records, read last
    out["dryrun"] = _fsdp_dryrun_read(dry)
    out["dryrun_note"] = ("terms are estimates from the H100's datasheet "
                          "constants, not times of the card")
    info = {name: {"fsdp_shape": kern.get(name, {}).get("shape"),
                   "fsdp_max_abs_err": kern.get(name, {}).get(
                       "max_abs_err"),
                   "fsdp_launches_per_rank": ranks[0]["launches"].get(name)}
            for name in ("flash_attention", "flash_attention_bwd")}
    return out, info


def phase_timing(rng, dev, xs, decrypt: tuple[int, int]
                 ) -> tuple[dict, dict]:
    """Kernel and plain-version times at the main paths' shapes, with the
    least time the card could take for the same work."""
    from repro_torch.core.plan import AggConfig
    from repro_torch.kernels.secure_agg import ops
    mcfg = AggConfig(n_nodes=N_MAIN, cluster_size=C_MAIN).mask_cfg()
    B, T = N_MAIN, T_MAIN
    N = B * T
    x = xs.reshape(B, T)
    nids = torch.arange(B, dtype=torch.int32, device=dev)
    seeds = torch.full((B,), mcfg.seed, dtype=torch.int32, device=dev)
    offs = torch.zeros(B, dtype=torch.int32, device=dev)
    agg = words(rng, (B, T), dev)
    r = 3
    copies = [words(rng, (N,), dev) for _ in range(r)]
    acc = words(rng, (N,), dev)

    def mask(impl):
        return lambda: ops.mask_encrypt_batch_fn(
            x, nids, seeds, mcfg.scale, mcfg.clip, mode="mask",
            offsets=offs, cluster_size=C_MAIN, impl=impl)

    def unmask(impl):
        return lambda: ops.unmask_decrypt_batch_fn(
            agg, N_MAIN, seeds, mcfg.scale, mode="mask", offsets=offs,
            impl=impl)

    def vote(impl):
        return lambda: ops.vote_combine_fn(copies, acc, impl=impl)

    # (bytes, integer, float) operations each function needs
    # (``roofline.counts``): per-row key derivation is counted once per
    # row and key; the mask's float work is clip (2), scale and round
    work = {"mask_encrypt": (*mask_work(B, T), mask),
            "unmask_decrypt": (*unmask_work(B, T, N_MAIN), unmask),
            "vote_combine": (*vote_work(r, N), vote)}
    out = {}
    for name, (nbytes, int_ops, float_ops, fn) in work.items():
        kernel_ms = cuda_ms(fn(None), reps=10)
        plain_ms = cuda_ms(fn("torch"), reps=3)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # integers go through their half-rate pipe; all operations share
        # the lane issue rate
        ops_ms = max(int_ops / INT32_OPS_PER_S,
                     (int_ops + float_ops) / LANE_OPS_PER_S) * 1e3
        out[name] = {"ms": kernel_ms, "plain_ms": plain_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations",
                     "bytes": nbytes, "int_ops": int_ops,
                     "float_ops": float_ops,
                     "bytes_ms": bytes_ms, "operations_ms": ops_ms,
                     "library_ms": None}
    del agg, copies, acc
    rows, nbits = decrypt
    mm = time_mont_mul(rng, dev, [(rows, 128), (1056, 128)])
    out["mont_mul"] = mm[f"{rows}x128"]
    out["mont_exp"] = time_mont_exp(rng, dev, rows, 128, nbits)
    out["flash_attention"] = time_flash(rng, dev)
    for H, K in ((64, 8), (64, 4), (32, 8), (40, 8)):
        out["flash_attention"][f"h{H}_k{K}"] = time_flash(rng, dev, H=H,
                                                          K=K)
    out["flash_attention"]["hubert_h16_hd80"] = time_flash(
        rng, dev, H=16, K=16, hd=80, causal=False)
    out["flash_attention"]["cross_h64_k8_skv4096"] = time_flash(
        rng, dev, H=64, K=8, Skv=4096, causal=False)
    out["flash_attention_bwd"] = time_flash_bwd(rng, dev)
    out["flash_attention_bwd"]["hubert_h16_hd80"] = time_flash_bwd(
        rng, dev, H=16, K=16, hd=80, causal=False)
    out["flash_attention_bwd"]["cross_h64_k8_skv4096"] = time_flash_bwd(
        rng, dev, H=64, K=8, Skv=4096, causal=False)
    out["ssd_bwd"] = time_ssd_bwd(rng, dev)
    from repro_torch.kernels.ssd.ops import CHUNK
    Bsz, S, H, P, N = SERVE_BATCH, SERVE_PROMPT, 32, 64, 128
    # the chunk states, written, read and rewritten, read again
    out["ssd"] = {**time_ssd(rng, dev), "kernel_chunk": CHUNK,
                  "ms_from_h0": time_ssd_from_h0(rng, dev),
                  "scratch_state_bytes": 4 * Bsz * H * (-(-S // CHUNK))
                  * P * N,
                  "jamba_h128_n16": time_ssd(rng, dev, H=128, N=16)}
    return {"phase": "timing", "shapes": {"rows": B, "T": T, "r": r},
            "kernels": out, "mont_mul": mm,
            "allreduce": _time_allreduce(xs, dev),
            "nvidia_smi": smi_line()}, out


def device_ms(fn, reps: int, inner: int) -> float:
    """Median device time of one of ``inner`` back-to-back calls of
    ``fn``, in ms.  A spin kernel queued first holds the stream while the
    host enqueues the events and the calls, so host launch overhead stays
    outside the events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4 * host_s * 2e9) + 100_000     # clock < 2 GHz: covered
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_mont_mul(rng, dev, shapes) -> dict:
    """``mont_mul`` kernel and plain times, with bounds, at (rows, L)."""
    from repro_torch.crypto.limb import montgomery_params
    from repro_torch.kernels.modmul import ops as mm
    out = {}
    for rows, L in shapes:
        n = _rand_below(rng, 1 << (16 * L - 1)) | (1 << (16 * L - 2)) | 1
        mp = montgomery_params(n, L)
        nl = torch.from_numpy(mp["n_limbs"].astype(np.int32)).to(dev)
        a = torch.randint(0, 1 << 16, (rows, L), dtype=torch.int32,
                          device=dev)
        a[:, -1] = 0                      # operands below n
        b = a.roll(1, 0).contiguous()
        kernel_ms = device_ms(
            lambda: mm.mont_mul_op(a, b, nl, mp["n0inv"]), reps=7, inner=200)
        plain_ms = cuda_ms(
            lambda: mm.mont_mul_op(a, b, nl, mp["n0inv"], impl="torch"),
            reps=3)
        nbytes, int_ops = mont_mul_work(rows, L)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = int_ops / INT32_OPS_PER_S * 1e3
        out[f"{rows}x{L}"] = {
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "int_ops": int_ops, "bytes_ms": bytes_ms,
            "operations_ms": ops_ms, "library_ms": None}
    return out


def time_mont_exp(rng, dev, rows: int, L: int, nbits: int) -> dict:
    """The one-launch ladder at the decryption's shape, beside the host
    loop of two ``mont_mul`` launches a bit that it replaced (in turns:
    ladder, loop, loop, ladder), every row held against Python ``pow``.
    The plain ladder runs over the first PLAIN_LADDER_BITS exponent bits
    at the same rows x L, held limb for limb against the kernel over the
    same bits (and both against ``pow`` of those leading bits).  Its time
    over those ``plain_bits`` is ``plain_ms``, beside the kernel's over the
    same bits (``ms_at_plain_bits``); ``plain_ms_scaled_to_nbits`` scales
    it to ``nbits`` (the plain ladder is one host loop of the same two
    products a bit) and is an estimate, not a measurement.  The
    full-length plain ladder (4,744 plain products, 199-295 s on the card)
    no longer runs here."""
    from repro_torch.crypto.limb import batch_from_limbs
    from repro_torch.kernels.modmul import ops as mm
    n = _rand_below(rng, 1 << (16 * L - 1)) | (1 << (16 * L - 2)) | 1
    xs = [_rand_below(rng, n) for _ in range(rows)]
    exps = [_rand_below(rng, 1 << nbits) | 1 << (nbits - 1)
            for _ in range(rows)]
    mp, a, bits, one = _ladder_inputs(n, L, xs, exps, dev)
    nl = torch.from_numpy(mp["n_limbs"].astype(np.int32)).to(dev)

    def ladder():
        return mm.mont_exp_op(a, bits, mp["n_limbs"], mp["n0inv"], one)

    def loop():
        return mm.mont_exp_loop(a, bits, nl, mp["n0inv"], one)

    ladder_ms, loop_ms = [cuda_ms(ladder, reps=3)], [cuda_ms(loop, reps=1)]
    loop_ms.append(cuda_ms(loop, reps=1))
    ladder_ms.append(cuda_ms(ladder, reps=3))
    R_inv = pow(mp["R"], -1, n)

    def held_to_pow(out, es, what):
        vals = batch_from_limbs(out.cpu().numpy().astype(np.uint32))
        check([v * R_inv % n for v in vals] ==
              [pow(x, e, n) for x, e in zip(xs, es)],
              f"mont_exp at the decryption's shape, {what}: pow")

    held_to_pow(ladder(), exps, f"{nbits} bits")
    head = min(PLAIN_LADDER_BITS, nbits)
    bits_head = bits[:, :head].contiguous()
    got = mm.mont_exp_op(a, bits_head, mp["n_limbs"], mp["n0inv"], one)
    head_ms = cuda_ms(lambda: mm.mont_exp_op(a, bits_head, mp["n_limbs"],
                                             mp["n0inv"], one), reps=3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = mm.mont_exp_op(a, bits_head, mp["n_limbs"], mp["n0inv"], one,
                          impl="torch")
    end.record()
    end.synchronize()
    check(torch.equal(got, want), "mont_exp at the decryption's rows x L "
          f"equals the plain ladder over the first {head} bits")
    held_to_pow(got, [e >> (nbits - head) for e in exps],
                f"the first {head} bits")
    plain_head_ms = start.elapsed_time(end)
    nbytes, int_ops = mont_exp_work(rows, L, nbits)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = int_ops / INT32_OPS_PER_S * 1e3
    ms = statistics.median(ladder_ms)
    return {"ms": ms, "ladder_ms": ladder_ms, "loop_ms": loop_ms,
            "plain_ms": plain_head_ms, "plain_bits": head,
            "ms_at_plain_bits": head_ms,
            "plain_ms_scaled_to_nbits": plain_head_ms * nbits / head,
            "rows": rows, "L": L,
            "nbits": nbits, "us_per_product": ms * 1e3 / (2 * nbits),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "int_ops": int_ops, "bytes_ms": bytes_ms,
            "operations_ms": ops_ms, "library_ms": None}


def bound(nbytes: float, flops: float, flops_per_s: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "operations_ms": ops_ms}


def time_flash(rng, dev, H: int = 16, K: int = 8, hd: int = 128,
               Skv: Optional[int] = None, causal: bool = True,
               B: Optional[int] = None, S: Optional[int] = None) -> dict:
    """``flash_attention`` at qwen3-1.7b's prefill (B 4, S 2048, H 16,
    K 8, hd 128, causal, bf16; command-r-35b's and qwen1.5-110b's with H
    64; qwen3-moe-235b's H 64 over K 4, jamba's H 32, llama4-maverick's H
    40, whose window of 8,192 masks nothing at 2,048; hubert-xlarge's H = K
    = 16 at hd 80, bidirectional; llama-3.2-vision's cross-attention, H 64
    over K 8 and ``Skv`` 4,096 media tokens, no mask), its plain version,
    and ``scaled_dot_product_attention`` on the same inputs in its (B, H,
    S, hd) layout (timed here only; the port never calls it).  ``B`` and
    ``S`` default to the serve's batch and prompt."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    B, S = B or SERVE_BATCH, S or SERVE_PROMPT
    Skv = Skv or S
    q, k, v = (torch.from_numpy(rng.standard_normal((B, n_s, n, hd),
                                                    np.float32)
                                ).to(dev, torch.bfloat16)
               for n_s, n in ((S, H), (Skv, K), (Skv, K)))
    kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal),
                        reps=10)
    # the training forward: the same kernel, also writing L
    lse_ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal, 0,
                                                  lse=True), reps=10)
    plain_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal,
                                               impl="torch"), reps=3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                      enable_gqa=True), reps=10)
    got = flash_attention(q, k, v, causal=causal).transpose(1, 2).float()
    lib_err = max_abs_err(got, sdpa(qt, kt, vt, is_causal=causal,
                                    enable_gqa=True).float())
    # two products over the allowed (query, key) pairs (i >= j where
    # causal), 2 FLOP a multiply-add
    nbytes, flops = flash_fwd_work(B, S, Skv, H, K, hd, causal)
    return {"ms": kernel_ms, "ms_with_lse": lse_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": f"scaled_dot_product_attention(is_causal={causal}, "
                       "enable_gqa=True)",
            "library_max_abs_err": lib_err,
            "shape": [B, S, Skv, H, K, hd, causal], **bound(
                nbytes, flops, BF16_FLOPS_PER_S)}


def time_flash_bwd(rng, dev, H: int = 16, K: int = 8, hd: int = 128,
                   Skv: Optional[int] = None, causal: bool = True,
                   B: Optional[int] = None, S: Optional[int] = None
                   ) -> dict:
    """The flash backward at qwen3-1.7b's training shape (B 4, S 2048, H
    16, K 8, hd 128, causal, bf16; hubert-xlarge's with H = K = 16 at hd
    80, bidirectional; llama-3.2-vision's cross-attention with H 64 over
    K 8 and ``Skv`` 4,096 media keys, no mask) from the forward kernel's
    o and L, its plain version, and the backward of
    ``scaled_dot_product_attention`` (GQA) on the same inputs in its (B,
    H, S, hd) layout (timed here only; the port never calls it).  ``ms``
    is the CUDA-event median of lone calls, ``by_kernel_ms`` each
    launch's mean device time in a profiled run of 20 calls; the bound
    counts the function's five products over the allowed pairs,
    ``design_bound_ms`` the kernels' ten.  ``B`` and ``S`` default to the
    serve's batch and prompt."""
    from repro_torch.kernels.flash_attention import attention_bwd_ref
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    B, S = B or SERVE_BATCH, S or SERVE_PROMPT
    Skv = Skv or S
    q, do = (torch.from_numpy(rng.standard_normal((B, S, H, hd), np.float32)
                              ).to(dev, torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Skv, K, hd),
                                                 np.float32)
                             ).to(dev, torch.bfloat16) for _ in range(2))
    o, L = flash_attention_cuda(q, k, v, causal, 0, lse=True)

    def call():
        return flash_attention_bwd_cuda(q, k, v, o, do, L, causal, 0)

    kernel_ms = cuda_ms(call, reps=5)

    def calls():
        for _ in range(20):
            call()

    # each of the call's launches: mean device ms a launch, launches seen
    by_kernel = [(name, ms / n, n) for name, ms, n in
                 profile_device(calls)["by_kernel_ms"]]
    plain_ms = cuda_ms(lambda: attention_bwd_ref(q, k, v, o, do, L,
                                                 causal=causal), reps=2)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), reps=5)
    got = call()
    lib = torch.autograd.grad(ot, (qt, kt, vt), dot)
    lib_err = max(max_abs_err(g.float(), w.transpose(1, 2).float())
                  for g, w in zip(got, lib))
    # five products over the allowed pairs (i >= j where causal), 2 FLOP
    # a multiply-add; q, o, dO and L read, k, v read, dq, dk, dv written
    nbytes, flops = flash_bwd_work(B, S, Skv, H, K, hd, causal)
    # the kernels' own work: S and dP in both passes, and dV, dK and dQ
    # as two products each (P and dS as bf16 pairs hi + lo): ten products
    design = bound(nbytes, 2 * flops, BF16_FLOPS_PER_S)
    return {"ms": kernel_ms, "by_kernel_ms": by_kernel,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": f"scaled_dot_product_attention(is_causal={causal}, "
                       "enable_gqa=True) backward",
            "library_max_abs_err": lib_err,
            "design_bound_ms": design["bound_ms"],
            "design_flops": design["flops"],
            "shape": [B, S, Skv, H, K, hd, causal], **bound(
                nbytes, flops, BF16_FLOPS_PER_S)}


def time_ssd(rng, dev, H: int = 32, N: int = 128) -> dict:
    """``ssd_chunked`` at mamba2-370m's prefill (B 4, S 2048, 32 heads of
    P = 64, N = 128, B and C shared by the heads; jamba's with 128 heads
    of N = 16) and its plain version.
    ``ms`` is the CUDA-event median of single calls, the host's enqueueing
    of the wrapper's launches and scratch included; ``queued_ms`` the
    device time of one of 20 calls queued back to back; ``by_kernel_ms``
    each kernel's mean device time a launch, and its launches seen, in a
    profiled run of 200 calls (late in a long process the profiler can
    drop a window's first launches, so means, not sums), and
    ``kernels_ms`` their sum, one call's device time.  The bound is the
    least work over every chunking at the rate of the unit the kernel
    runs on (3xTF32 on the tensor cores), with the float32 CUDA-core
    rate's beside it."""
    from repro_torch.kernels.ssd import ssd_chunked
    Bsz, S, P = SERVE_BATCH, SERVE_PROMPT, 64
    args = _ssd_inputs(rng, dev, Bsz, S, H, P, N=N, per_head=False)

    def call():
        return ssd_chunked(*args, 256)

    kernel_ms = cuda_ms(call, reps=10)
    queued_ms = device_ms(call, reps=5, inner=20)
    def calls():
        for _ in range(200):
            call()

    prof = profile_device(calls)
    by_kernel = [(name, ms / n, n) for name, ms, n in prof["by_kernel_ms"]]
    plain_ms = cuda_ms(lambda: ssd_chunked(*args, 256, impl="torch"), reps=3)
    # x and y, dt, A, B and C once each, the final state written once
    nbytes = ssd_bytes(Bsz, S, H, P, N)
    flops, least_q = ssd_flops(Bsz, S, H, P, N)
    f32 = bound(nbytes, flops, F32_FLOPS_PER_S)
    return {"ms": kernel_ms, "queued_ms": queued_ms,
            "by_kernel_ms": by_kernel,
            "kernels_ms": sum(ms for _, ms, _ in by_kernel),
            "plain_ms": plain_ms, "library_ms": None,
            "shape": [Bsz, S, H, P, N], "unit": "tensor cores, 3xTF32",
            "bound_chunk": least_q,
            **bound(nbytes, flops, F32_3XTF32_FLOPS_PER_S),
            "bound_f32_ms": f32["bound_ms"], "bound_f32_by": f32["bound_by"]}


def time_ssd_from_h0(rng, dev) -> float:
    """``ssd_chunked`` at mamba2-370m's prefill shape from a carried state
    (a prefill that goes on from an earlier one): the CUDA-event median
    of single calls, as ``time_ssd``'s ``ms``."""
    from repro_torch.kernels.ssd import ssd_chunked
    Bsz, S, H, P, N = SERVE_BATCH, SERVE_PROMPT, 32, 64, 128
    args = _ssd_inputs(rng, dev, Bsz, S, H, P, N=N, per_head=False)
    h0 = torch.from_numpy(rng.standard_normal((Bsz, H, P, N), np.float32)
                          ).to(dev)
    return cuda_ms(lambda: ssd_chunked(*args, 256, h0), reps=10)


def time_ssd_bwd(rng, dev) -> dict:
    """``ssd_bwd`` at mamba2-370m's training shape (B 4, S 2048, 32 heads
    of P = 64, N = 128, B and C shared; no initial state, no final state's
    gradient, as in training) from the forward kernel's y, and its plain
    version (``ssd_chunked_bwd_ref`` in float32 on the card).  ``ms`` is
    the CUDA-event median of lone calls, ``by_kernel_ms`` each launch's
    mean device time in a profiled run of 20 calls, ``scratch_bytes`` the
    wrapper's scratch (``ops.bwd_scratch_bytes``; null for a tree without
    it) and ``peak_bytes_a_call`` the memory one call adds at its peak.
    No PyTorch call computes the function (``library_ms`` null).  The
    bound: the least work over every chunk length at the 3xTF32 rate,
    against the bytes of x, y, dy, dx, dt, ddt, A, dA, B, C, dB and dC
    once each."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ssd_chunked_bwd_ref
    from repro_torch.kernels.ssd.ops import ssd_bwd_cuda_heads, ssd_cuda_heads
    Bsz, S, H, P, N = SERVE_BATCH, SERVE_PROMPT, 32, 64, 128
    x, dt, A, Bm, Cm = _ssd_inputs(rng, dev, Bsz, S, H, P, N=N,
                                   per_head=False)
    a = A.repeat(Bsz)
    dy = torch.from_numpy(rng.standard_normal((Bsz, S, H, P), np.float32)
                          ).to(dev)
    y, _ = ssd_cuda_heads(x, dt, a, Bm, Cm)

    def call():
        return ssd_bwd_cuda_heads(x, dt, a, Bm, Cm, None, y, dy, None)

    kernel_ms = cuda_ms(call, reps=10)

    def calls():
        for _ in range(20):
            call()

    by_kernel = [(name, ms / n, n) for name, ms, n in
                 profile_device(calls)["by_kernel_ms"]]
    plain_ms = cuda_ms(lambda: ssd_chunked_bwd_ref(x, dt, a, Bm, Cm, 256,
                                                   None, dy, None), reps=3)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    call()
    scratch = torch.cuda.max_memory_allocated() - base
    nbytes = ssd_bwd_bytes(Bsz, S, H, P, N)
    flops, least_q = ssd_bwd_flops(Bsz, S, H, P, N)
    return {"ms": kernel_ms, "by_kernel_ms": by_kernel,
            "kernels_ms": sum(ms for _, ms, _ in by_kernel),
            "plain_ms": plain_ms, "library_ms": None, "library": "none",
            "shape": [Bsz, S, H, P, N], "unit": "tensor cores, 3xTF32",
            "bound_chunk": least_q,
            "kernel_chunk_flops": ssd_bwd_flops_at(Bsz, S, H, P, N, 256),
            "scratch_bytes": (ssd_ops.bwd_scratch_bytes(Bsz, H, S, P, N)
                              if hasattr(ssd_ops, "bwd_scratch_bytes")
                              else None),
            "peak_bytes_a_call": scratch,
            **bound(nbytes, flops, F32_3XTF32_FLOPS_PER_S)}


def _time_allreduce(xs, dev) -> dict:
    """Host-clock median of the full-width allreduce, and one profiled
    call: device time by kernel name and the device's busy share."""
    from repro_torch import SecureAggregator
    agg = SecureAggregator(**_main_cfg(), device=dev)
    agg.allreduce(xs)
    host = [_run(agg, xs)[2] for _ in range(3)]
    return {"host_s": host, "median_s": statistics.median(host),
            **profile_device(lambda: agg.allreduce(xs))}


def profile_device(fn, parts: tuple = (), spans: tuple = ()) -> dict:
    """One profiled call of ``fn``: its wall time, device time by kernel
    name, the device's busy share, for each of ``parts`` the device
    time and launches of the kernels whose names contain it, and for each
    of ``spans`` (``record_function`` ranges) the milliseconds of its
    ranges on the host and on the device (from the first to the last
    kernel launched inside it, idle gaps included); the ranges' device
    rows are not kernels, and are kept out of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    averages = prof.key_averages()
    for ev in averages:
        # operators repeat their kernels' device time; gloo's transfers
        # are host work that the profiler files under the device
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("gloo:") \
                or ev.key in spans:
            continue
        dev_us = _device_us(ev)
        if dev_us > 0:
            rows.append((ev.key[:80], dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"profiled_wall_s": wall, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3),
            "by_kernel_ms": rows[:12],
            "by_part": {p: {"ms": sum(r[1] for r in rows if p in r[0]),
                            "launches": sum(r[2] for r in rows if p in r[0])}
                        for p in parts},
            "spans_ms": {n: {
                "host": sum(ev.cpu_time_total for ev in averages
                            if ev.key == n and
                            ev.device_type == DeviceType.CPU) / 1e3,
                "device": sum(_device_us(ev) for ev in averages
                              if ev.key == n and
                              ev.device_type == DeviceType.CUDA) / 1e3}
                for n in spans}}


def _device_us(ev) -> float:
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    emit(phase_device())            # always first: raises without a card
    # float32 products in full float32 (also the default), stated for the
    # float checks; no convolution runs, so cuDNN's TF32 switch is moot
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import backend
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    if "build" in phases:
        emit(phase_build())
    errs = {k.name: 0.0 for k in backend.KERNELS}
    # fsdp first: its two ranks of ~37 GiB each need the card as a fresh
    # process leaves it (later phases leave ~12 GiB in this process)
    fsdp_info = {}
    if "fsdp" in phases:
        line, fsdp_info = phase_fsdp(dev, args.seed, errs)
        emit(line)
    if "kernels" in phases:
        emit(phase_kernels(rng, dev, errs))
    launches, timing = {}, {}
    if {"main", "timing"} & set(phases):
        xs = torch.from_numpy(rng.standard_normal((N_MAIN, T_MAIN),
                                                  np.float32) * 0.3).to(dev)
    if "main" in phases:
        from repro_torch.core.masking import reference_aggregate
        from repro_torch.core.plan import AggConfig
        mcfg = AggConfig(n_nodes=N_MAIN, cluster_size=C_MAIN).mask_cfg()
        ref = reference_aggregate(mcfg, xs)
        line, main_launches = phase_main(xs, ref, dev)
        launches.update(main_launches)
        del ref
        emit(line)
    if "batched" in phases:
        emit(phase_batched(rng, dev))
    service_launches = None
    if "service" in phases:
        line, service_launches = phase_service(dev, args.seed)
        emit(line)
    funcs_launches = None
    if "funcs" in phases:
        line, funcs_launches = phase_funcs(dev, args.seed)
        emit(line)
    mesh_launches = None
    # tp2 (e) and (f) need as many ranks as the mesh phase spawns: where
    # both phases run, the mesh phase's ranks run them after their own work
    tp2_e_dir = None
    if {"mesh", "tp2"} <= set(phases) and TP2_SHAPE["e_tp"] == N_MESH:
        tp2_e_dir = tempfile.mkdtemp(prefix="tp2-e-")
        atexit.register(shutil.rmtree, tp2_e_dir, True)
    if "mesh" in phases:
        line, mesh_launches = phase_mesh(dev, args.seed, tp2_e_dir=tp2_e_dir)
        emit(line)
    decrypt = (N_DECRYPT, DECRYPT_BITS)
    if "paillier" in phases:
        line, da_launches, decrypt = phase_paillier(dev)
        for k in backend.MODMUL:
            launches[k.name] = da_launches[k.name]
        emit(line)
    if "serve" in phases:
        line, serve_launches = phase_serve(dev, args.seed)
        launches.update(serve_launches)
        emit(line)
    train_launches = mamba_launches = None
    if "train" in phases:
        lines, train_launches, mamba_launches = phase_train(dev, args.seed,
                                                            errs)
        launches[backend.FLASH_ATTENTION_BWD.name] = \
            train_launches[backend.FLASH_ATTENTION_BWD.name]
        launches[backend.SSD_BWD.name] = mamba_launches[backend.SSD_BWD.name]
        for line in lines:
            emit(line)
    # tp2 (d) runs on 2 ranks, as tp's serve does: where both phases
    # run, tp's ranks run (d) after their own work
    tp2_d_dir = None
    if {"tp", "tp2"} <= set(phases) and TP_SHAPE["tp"] == 2:
        tp2_d_dir = tempfile.mkdtemp(prefix="tp2-d-")
        atexit.register(shutil.rmtree, tp2_d_dir, True)
    tp_info = {}
    if "tp" in phases:
        line, tp_info = phase_tp(dev, args.seed, errs, d_dir=tp2_d_dir)
        emit(line)
    tp2_info = {}
    if "tp2" in phases:
        line, tp2_info = phase_tp2(dev, args.seed, errs, e_dir=tp2_e_dir,
                                   d_dir=tp2_d_dir)
        emit(line)
    launch_launches = None
    if "launch" in phases:
        line, launch_launches = phase_launch(dev)
        emit(line)
    if "timing" in phases:
        line, timing = phase_timing(rng, dev, xs, decrypt)
        emit(line)

    kernels = []
    for k in backend.KERNELS:
        t = timing.get(k.name, {})
        checked = "train" in phases if not k.pallas else "kernels" in phases
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches.get(k.name),
            "max_abs_err": errs[k.name] if checked else None,
            "ms": t.get("ms"),
            "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
            "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
            # where the plain version ran over fewer exponent bits than
            # ``ms`` (the ladder), the bits and the kernel's time over them
            **{key: t[key] for key in ("plain_bits", "ms_at_plain_bits")
               if key in t},
            "mesh_launches_per_rank": (None if mesh_launches is None
                                       else mesh_launches[k.name]),
            "service_launches": (None if service_launches is None
                                 else service_launches[k.name]),
            "funcs_launches": (None if funcs_launches is None
                               else funcs_launches[k.name]),
            "train_launches_secure_run": (
                None if train_launches is None
                else train_launches[k.name]),
            "mamba2_train_launches_secure_run": (
                None if mamba_launches is None
                else mamba_launches[k.name]),
            "serve_agg_mesh_rank0_launches": (
                None if launch_launches is None
                else launch_launches["serve_agg_mesh_rank0"][k.name]),
            "quickstart_launches": (
                None if launch_launches is None
                else launch_launches["quickstart"][k.name]),
            # the tp phase: the shapes a rank's calls run at, held against
            # the plain version there (the first one timed), and the
            # launches a rank made in each of its runs
            **{key: tp_info.get(k.name, {}).get(key)
               for key in ("tp_shape", "tp_max_abs_err", "tp_ms",
                           "tp_plain_ms", "tp_bound_ms", "tp_library_ms",
                           "tp_launches_per_rank")},
            # the tp2 phase: (e)'s padded rank shape for flash and its
            # backward (timed there), (d)'s mamba2 rank for the SSD scan,
            # and the launches a rank made in (d) and (e)
            **{key: tp2_info.get(k.name, {}).get(key)
               for key in ("tp2_shape", "tp2_max_abs_err", "tp2_ms",
                           "tp2_plain_ms", "tp2_bound_ms", "tp2_library_ms",
                           "tp2_launches_per_rank")},
            # the fsdp phase: (a)'s rank shape held against the plain
            # version, and a rank's launches in (a)'s step
            **{key: fsdp_info.get(k.name, {}).get(key)
               for key in ("fsdp_shape", "fsdp_max_abs_err",
                           "fsdp_launches_per_rank")}})
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
