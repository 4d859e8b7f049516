"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile] [--first-launch] [--tp-cards]
    python3 chip_smoke.py --tp-cards-only CONFIG ...   # several cards (tp, sp, ep, pp, item 10)
    python3 chip_smoke.py --only offload zeropp_onebit  # the build, then these phases
    python3 chip_smoke.py --only train_extras lora_hybrid
    python3 chip_smoke.py --only tooling
    python3 chip_smoke.py --only observability
    python3 chip_smoke.py --only elastic
    python3 chip_smoke.py --only fleet
    python3 chip_smoke.py --ab NAME=PATH ...   # K1 (K2/K3, K4) variants side by side

Run from the root of a checkout on a machine with a CUDA card.  Phases,
one JSON line each; any failure exits non-zero with no result line:

1. environment and build: the card (``nvidia-smi`` name and power limit),
   torch/CUDA versions, and the nvcc builds of every kernel source in the
   checkout, in parallel, with ptxas registers, spills and warnings per
   kernel; then the first launches of K1, K2 and K3 (S=256 and the
   training shape) and of K4 (four decode cases) in a child process killed
   after FIRST_LAUNCH_TIMEOUT_S, so that a pipeline that hangs fails the
   run at once;
2. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and a few more, with kernel / plain / library timings
   (CUDA events, median of 20 after warm-up): K1 the flash forward, K2 the
   dq backward, K3 the dk/dv backward (bf16/fp16 and fp32; an fp32
   gradient through autograd), K4 the paged decode attention (at
   the serving stream's decode shape, GQA, hd 64, page 16, a contiguous
   cache, fp16, fp32, a slot at length 0, a page shared by two slots,
   every slot full and one full slot beside seven short ones; timed with
   the L2 flushed before each call, as a decode tick finds it), then K4's
   int8 mode (int8 pages and their scale rows read in place) at
   DECODE_INT8_CASES, beside the full-precision mode and SDPA over the
   dequantized cache;
3. block-sparse attention (``SparseSelfAttention`` -> the ``block_mask``
   mode of K1, K2, K3) at SPARSE_CASES: llama-740m's attention at S=16384
   under the "fixed" layout (the main case), llama2-7b's width under
   BigBird, GQA, hd 64, sub-tile mask blocks, fp16, a dense layout (must
   equal the unmasked kernels) and a raw mask with dead rows (exact zeros,
   lse -1e30).  Each forward + backward launches K1, K2 and K3 once; each
   output is held against its plain version as in phase 2; times against
   the same kernels unmasked, the plain versions, SDPA with the mask as a
   bool attn_mask and the bound over the live pairs.  Then
   ``DeepSpeedTransformerLayer`` (BERT-large width, pre-LN and post-LN,
   bf16): bidirectional, so no kernel launches.  Then ``ring_attention``:
   the ring of ``ops/ring_attention.py`` run as ``sp`` virtual ranks in
   one process (the same schedule as the P2P ring, each rotation a list
   index) at RING_CASES (llama-740m's attention at S=16384 over sp=4, GQA,
   sp=2): its output and gradients against the plain version on the
   first heads and against K1-K3 causal over the whole sequence, K1/K2/K3
   launches (each sp causal + sp(sp-1)/2 non-causal, the future blocks
   skipped), its time against the one-device kernels', and one ring
   block's K1 (non-causal, with lse) and K2/K3 (with dlse) against their
   plain versions, SDPA and the bound;
4. the training path: ``initialize`` -> ``train_batch`` on llama-740m at
   full width and depth, S=16384, micro batch 1, bf16 over fp32 masters,
   AdamW (bf16 mu), full-layer remat; 2 warm and 5 timed steps on one
   batch from the seed.  Every step must launch K1 2L times (forward and
   remat recompute), K2 and K3 L times, and the loss must stay finite and
   fall;
   Then ``train_remat``: the same model, weights and batch under each
   remat policy (1 warm step through ``forward``/``backward``/``step`` and
   3 timed ``train_batch`` steps each): K1 launches L times a
   step under ``save_qkv``/``save_matmuls`` and 2L under ``save_attn``/
   ``dots_saveable``, K2 and K3 L times; the first step's loss and
   gradient norm equal the ``nothing_saveable`` run's bit for bit (else
   within PARITY_*, and the record says by how much); step time, MFU,
   peak memory, and the memory the forward's graph holds beyond
   ``nothing_saveable``'s, which must be what the policy keeps
   (``saved_bytes_per_layer``) within REMAT_HELD_*;
5. training parity at S=2048: 3 steps from the same weights and batch
   through the kernels and through the plain attention branch (which must
   launch none); losses and the gradient norm must agree, and both are
   held beside an fp32 engine; an fp32 engine through the kernels (their
   fp32 variants) must agree with the fp32 plain branch.  ``train_loop``:
   2 steps of gas 2 through ``forward``/``backward``/``step`` equal 2
   steps of ``train_batch``, losses and masters bit for bit; ``frozen``: 2
   steps with ``frozen_keywords=("embed",)`` leave the embedding and its
   Adam moments untouched; ``train_zero`` (the train cell under ZeRO
   stages 0-3 over NCCL at world size = the card count, one process per
   card when there are more, with MiCS at 4+ cards: at one card each
   stage's losses and masters bit-equal to the one-device engine's and
   stage 3's peak within ZERO_PEAK_EXCESS_GB of its; steps, memory and
   collectives a step by kind; ``comm_bench`` at world > 1; a probe of
   two ranks sharing card 0 over NCCL and over gloo, recorded);
   ``train_tp`` (the same cell under tensor parallelism, stages 0 and 3,
   ``initialize(mesh=MeshLayout(tp=n))``: at one card a model axis of 1,
   every model-axis collective a copy, losses and masters bit-equal to the
   one-device engine's; with more cards one process per card at the
   largest model axis the card count and the model's heads allow, the
   loss trajectory beside train_zero's data-parallel one; model-axis
   collectives a step; with no ``params=`` at a model axis of 1 the
   masters equal the default init's); ``train_sp`` (the same cell through
   ``initialize(mesh=MeshLayout(sp=1))`` at one card: losses and masters
   bit-equal to the one-device engine's, the 'seq' plumbing costing
   nothing);
   ``checkpoint`` (S=16384, full width at CKPT_LAYERS layers, in a
   temporary directory outside the checkout, removed after): train 2
   steps, ``save_checkpoint``, train 2; a fresh engine
   ``load_checkpoint``s and trains the same 2 (losses and every master bit
   for bit), then an async save, one step during the write, and a third
   engine resumes from that tag bit for bit; GB written, save and load
   GB/s (sha256 of the payload included), the async return and commit
   times; the depth is cut (never the width) if the disk cannot hold two
   tags; ``elastic`` (ROADMAP item 13's single-host half: llama-740m at
   full width cut to ELASTIC_LAYERS layers, S=16384, the batch triad from
   the ``elasticity`` block's plan, micro-batch 1 x gas 4 at one card;
   ELASTIC_STEPS steps here uninterrupted, then ``python -m
   deepspeed_tpu_torch.launcher --elastic_restarts 2`` (no ``--num_gpus``
   on one card: the launcher counts the GPUs, and ``/proc`` shows it never
   initializes CUDA: no ``/dev/nvidia*`` open, where the training process
   and a process that only called ``torch.cuda.device_count()`` hold them) on
   this script's ``--elastic-child``, whose process gets SIGTERM after
   step ELASTIC_SIGTERM_AFTER: it saves at the next step boundary and exits
   75, the supervisor relaunches it once, the new process resumes from
   that tag to the end; losses and the final masters' checksum bit-equal
   to the uninterrupted run's, K1/K2/K3 4/2/2 a micro-step in both
   processes from the libraries built here, time to recover split into
   its parts, both processes' memory peaks, ``ds_report``'s output;
   ``--tp-cards-only`` also takes ELASTIC_CARD_CONFIGS (4 cards):
   ``elastic4_740m``, ZeRO-2 over 4 ranks with SIGTERM to one rank,
   relaunched at 2 cards); ``pod`` (item 13's pod half, the same cell:
   ``python -m deepspeed_tpu_torch.launcher --pod_coord_dir S --pod_lease
   1.0 --pod_miss_limit 3 --elastic_restarts 2`` with ``-H`` naming one
   host h0 and ``--launcher local`` starts this script's ``--pod-child``
   as h0 of a two-host pod whose h1 is ``tests/_torch_pod_peer.py``, a
   plain process holding no card; POD_STEPS steps, a pod-scope checkpoint
   every POD_CKPT_EVERY; h1 is SIGKILLed when the coordinator announces
   POD_HOLD_TAG, before its host manifest lands; h0's heartbeat watchdog
   declares it dead and exits 87; the supervisor runs one more round at
   generation 2, whose process quarantines the torn tag, resumes from
   global_step2 at [h0] and commits the rest: losses and the final
   checksum bit-equal to ``elastic``'s uninterrupted run, K1/K2/K3 16/8/8
   a step from the built libraries, no ``/dev/nvidia*`` in the launcher
   or the peer, time to detect and time to recover with their parts, the
   pod save's parts; then the replica hooks at full width in this process:
   ``replica_snapshot`` -> ``replica_ingest`` into a second engine
   bit-equal with both directions' GB/s, and a ``HostReplicator`` refusing
   the slab at the store's 64 MiB cap within POD_REPLICA_MAX_S; 4 cards:
   ``pod4_740m`` in POD_CARD_CONFIGS);
6. the serving path at full llama2-7b width and depth with random weights
   from the seed: ``init_inference`` -> ``engine.forward`` on S=4096 (K1
   must launch once per layer), the same tokens through the plain
   attention branch and through an fp32 engine (logit gates), then greedy
   ``generate`` on 4 ragged prompts, twice (must be token-equal);
7. the paged serving path on the same engine: ``engine.serving(b_slots=8,
   page_size=128, max_model_len=4096)`` -> ``run`` of 24 requests from the
   seed (mixed prompt lengths, 4 sharing a 600-token prefix, 4 sampled
   lanes), twice on fresh engines (token-equal).  Every decode tick
   replays one CUDA graph holding 32 K4 launches, with no new capture; the
   page accounting balances; served greedy tokens agree with an fp32
   teacher-forced ``forward`` on decisive positions; sampled lanes equal
   ``generate(sampling=...)`` (gated in fp32, reported in bf16);
   ``serve_tp``: the same stream through ``initialize_serving_mesh(tp)`` ->
   ``init_inference(mesh=)`` -> the paged engine (at one card tp=1 in
   this process, else one process per card at tp = the card count, each
   rank failing if its teardown outlasts TEARDOWN_S), token-exact with the unsharded run, one capture whose graph holds the
   model-axis all-reduces (two a layer and the embedding's) and the logits
   gather; ``--tp-cards`` (several cards) then runs TP_CARD_CONFIGS: llama2-7b
   training at tp = the card count, llama2-70b paged serving, and
   llama2-70b's widths at 8 layers sharded against one card;
   ``--tp-cards-only`` also takes SP_CARD_CONFIGS (4 cards):
   ``sp4_740m`` (llama-740m at S=65536 over sp=4, ring, against one card's
   run of the same tokens), ``uly_7b`` (llama2-7b's widths at 8 layers,
   S=32768, Ulysses over sp=4, against one card), ``tp4_740m`` (llama-740m
   at tp=4, 14 heads padded to 16, against dp=4);
   then, on the same weights and stream: ``hf_load`` (the weights written
   as an HF Llama directory of bf16 safetensors shards, by a writer of
   this script, then ``init_inference(<dir>)``: every leaf, the S=4096
   logits (K1 once per layer) and the served tokens bit-equal to the
   native engine's; load GB/s, host anonymous memory, device peak),
   ``quantized`` (int8 and int4 engines: bytes at rest under JAX's bars,
   int8 logits bit-equal to a bf16 engine over the dequantized tree and
   its serving token-equal, 32 K4 a tick in one capture; |dlogits| and
   top-1 against bf16, forward and tick times beside the dequantized
   engine's) and ``generate_fallback`` (an engine over ``apply_fn``
   alone: a 2048-token prompt, 4 new tokens, K1 once per layer in each
   bucketed forward, tokens reported against the cached ``generate``,
   whose dense prefill is held against the masked branch);
   then ``serving_extras`` (``phase_serving_extras``): the stream with
   int8 pages, a shared-prefix stream through a host tier (tokens equal
   to the tier-off run), speculative decoding (a perturbed draft, k =
   SPEC_K; the draft step and the verify block captured, the verify block
   K4 over B*(k+1) rows), per-slot LoRA adapters and ``fuse_adapter``,
   and the supervisor's warm restart after a planted fault; each run
   with no new capture in steady state and the page accounting balanced,
   the greedy streams held to fp32 on decisive positions; then ``fleet``
   (ROADMAP item 14's fleet half, ``fleet_7b4``: llama2-7b's widths at
   FLEET_LAYERS layers in fp32, the same seeded weights in every process):
   the stream through one supervised member here as the reference, then
   FLEET_MEMBERS member processes (this script's ``--fleet-member``, each
   the port's ``FleetMemberDaemon`` over a warmed ``supervised_serving``)
   routed by a coordinator ``FleetRouter`` and a standby in this process
   over ``StoreMemberProxy`` handles; the member holding the most streams
   is SIGKILLed once one of them has FLEET_KILL_JOURNALED journaled
   tokens, and the coordinator router FLEET_COORD_KILL_ROUNDS rounds after
   the first resumed token: every request finished once at full length
   and token-equal to the reference, every stream of the victim failed
   over and one resumed from the journal, the standby in a higher term,
   each survivor's pages balanced with one capture and 4 K4 a replayed
   tick, and the K1 and K4 kernel events that torch.profiler counts over
   its serving equal to its K1 count and its replays' K4; the times to
   detect the loss and to fail over, the tokens re-decoded, each member's
   start-to-ready seconds;
8. MoE and pipeline parallelism (ROADMAP queue 1, item 9): ``moe_serving``
   (Mixtral-8x7B's widths, MOE_SERVE_LAYERS of 32 layers, bf16, no-drop:
   ``forward`` at S=4096 with K1 once a layer, the 24-request stream with
   K4 once a layer in the one captured decode graph and no new capture,
   tick, tok/s, TTFT and the expert FFN's share of the tick; first, at
   MOE_FP32_LAYERS layers, the served greedy tokens against an fp32 engine
   on decisive positions), ``moe_train`` (MOE_TRAIN_LAYERS layers, S=4096,
   the capacity and the no-drop paths, 3 steps each: K1 2L, K2/K3 L a
   step, the loss with its aux term finite and falling; the capacity run
   again through ``initialize(mesh=MeshLayout(ep=1))`` at NCCL world 1,
   bit-equal; a PR-MoE pyramid at llama-740m's widths through forward and
   backward) and ``pipeline`` (llama-740m, 4 virtual stages x 4 layers, 8
   microbatches, GPipe and 1F1B, against the un-pipelined engine at gas=8:
   loss and gradient norm within PIPE_*_RTOL, launches, step times);
   ``--tp-cards-only`` also takes ITEM9_CARD_CONFIGS (4 cards):
   ``ep4_mixtral8`` (Mixtral's widths at 8 layers over ep=4, the capacity
   path, against ZeRO-3 dp=4) and ``pp4_7b`` (llama2-7b over pp=4, GPipe
   and 1F1B, M=4, against ZeRO-3 dp=4), losses within TP_DP_LOSS_RTOL;
9. ZeRO-Offload, ZeRO-Infinity, ZeRO++ and the 1-bit optimizers
   (ROADMAP queue 1, item 10): ``offload`` (llama2-7b at full width,
   S=4096, its optimizer state in host RAM through the host step, 3 steps
   on one card: step, host Adam and transfer rates, device peak under 80
   GB, host RSS; layers cut to what host RAM holds, the cut printed; then
   the train cell cut to OFFLOAD_740M_LAYERS layers through the device
   engine, ``host_step``, ``streamed``, NVMe and ZeRO-Infinity from one
   seed and batch: the first loss equal,
   masters within OFFLOAD_MASTER_RTOL after step 1, NVMe and Infinity
   resume bit-exact) and ``zeropp_onebit`` (the train cell at NCCL world
   1: qwZ + qgZ against plain ZeRO-3 within JAX's bound with every
   sharded gather int8; OneBitAdam's warm-up equal to AdamW's, its
   exchange uint8 with nonzero error buffers; ZeroOneAdam through a local
   step and OneBitLamb finite and falling); ``--only offload zeropp_onebit`` runs them alone
   after the build; ``--tp-cards-only`` also takes ITEM10_CARD_CONFIGS
   (4 cards): ``zpp4_7b`` and ``onebit4_740m``;
10. the model-and-optimizer half of ROADMAP queue 1, item 11:
   ``train_extras`` (the train cell, llama-740m at S=16384 uncut: LAMB,
   SGD with Nesterov momentum, Adagrad, Lion and RMSprop, 3 steps each,
   each first loss AdamW's bit for bit and its state's bytes a parameter
   its own; progressive layer drop with K1/K2/K3 following each step's
   host mask; random-LTD on every kept count from 8192 to 16384 with
   K1-K3 on the kept subset and no plain-branch attention; the seqlen
   curriculum through every S from 2048 to 16384; ``compute_eigenvalue``
   at S=1024 on the plain branch, the only one JAX's dispatch can
   differentiate twice, and the fp32 Hessian-vector product along its
   vector against a central difference of fp32 gradients) and
   ``lora_hybrid`` (llama2-7b at full width, LoRA rank 16 on wq/wk/wv/wo:
   the dense prefill's logits against ``forward_cached``'s masked branch;
   HYBRID_ROUNDS rounds of ``DeepSpeedHybridEngine.generate`` on 4 prompts of
   2048 tokens, 128 new, greedy, then ``train_batch`` on the 4 x 2176-token
   rollouts; tokens equal to ``init_inference`` on the base, then on
   ``fused(lora)`` after the step; the base bit-unchanged after every
   generate and every step; K1 32 a
   prefill, 64/32/32 a step); ``--only train_extras lora_hybrid`` runs
   them alone after the build; then ``tooling`` (item 11's tooling half on
   the train cell: TOOLING_STEPS steps under TOOLING_COMPRESSION — QAT
   8 -> 4 bits, 8-bit activation fake-quant, sparse MLP and head pruning —
   with 32/16/16 launches a step, the transformed leaves' dense ratios and
   levels, and the kernel path against the plain branch at PARITY_S;
   ``redundancy_clean`` to 7 heads, its ``init_inference`` forward against
   the masked model's, ``student_initialization`` to 8 layers and one
   step; the flops profiler at PROFILE_STEP of the plain cell against the
   analytic count (``_profile_analytic``) and the CSV and TensorBoard
   monitors read back; the autotuner over AUTOTUNE_SPACE, micro-batch 16
   ending as ``compile_oom``, then a step; llama2-7b under
   ``OnDevice(device="meta")``: no byte on the card), ``--only tooling``
   alone after the build; then ``observability`` (ROADMAP item 12): its
   serving part runs right after the paged serving path on that engine and
   stream (monitor, watchdog, one SLO rule that must fire and one that must
   not, program statistics sampled every OBS_SAMPLE_EVERY-th invocation,
   ``/metrics`` scraped on an ephemeral 127.0.0.1 port, a ``torch.profiler``
   window over OBS_SERVE_WINDOW working ticks: tokens equal to the plain
   run's, one capture, decode invocations = ticks, the decode program's
   counted FLOP = one eager decode step's with K4's cost sink = this
   script's ``decode_work``; its ticks held beside phase paged_serving's
   plain rerun of the stream); its train part after ``tooling`` (the train
   cell with an
   ``InMemoryMonitor``, the watchdog at OBS_WATCHDOG_S and
   ``DS_TPU_PEAK_TFLOPS=989``, OBS_STEPS steps: ``train_step``'s counted
   FLOP = the flops profiler's, the last ``train/tflops_est`` within
   OBS_TFLOPS_RTOL of FLOP over the median step, ``train/mfu_est`` =
   that over 989; a trace window whose middle OBS_WINDOW_STEPS steps each
   hold 2L/L/L K1/K2/K3 kernel events launched inside their ``train.batch``;
   the step with the hooks off and on in turns), beside three children (``--watchdog-child``) that arm a 2 s
   watchdog around a 10 s device sleep and a ``synchronize``, a host copy
   or an NCCL barrier and must exit 85 within 15 s; ``--only
   observability`` builds its own llama2-7b engine and plain run first;
11. with ``--profile`` only: ``torch.profiler`` device time by kernel for
   one warm train step, one forward, one decode step and 10 warm decode
   ticks of the serving engine, and the device's busy share;
12. the ``kernels`` line: per kernel its launches on its main path (and on
   the MoE, pipeline, offload, item 11, tooling, observability, elastic
   and pod paths), error against the plain version, times
   and the bound from this run's shapes (K1-K3 with a ``block_mask``
   record from the sparse main case).

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): tensor-core bf16/fp16,
# CUDA-core fp32, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# (B, S, Hq, Hkv, hd, dtype, causal).  K1's first shape is the training
# path's (2 launches per layer per step), its second the serving path's
# (one per layer of engine.forward at llama2-7b, S=4096).
TRAIN_SHAPE = (1, 16384, 14, 14, 128, torch.bfloat16, True)
SERVE_SHAPE = (1, 4096, 32, 32, 128, torch.bfloat16, True)
# uly_7b's (4 cards): llama2-7b's 32 heads over sp=4 after Ulysses'
# all-to-all, the whole S=32768 causal on each card's 8 heads
ULY_SHAPE = (1, 32768, 8, 8, 128, torch.bfloat16, True)
# item 11's new shapes: random-LTD's smallest kept subset of the train
# cell, and the LoRA llama2-7b step on its 4 x 2176-token rollouts
LTD_SHAPE = (1, 8192, 14, 14, 128, torch.bfloat16, True)
LORA_SHAPE = (4, 2176, 32, 32, 128, torch.bfloat16, True)
# forward_cached's dense prefill at llama2-7b: the hybrid engine's 4 x 2048
# prompts and generate_fallback's cached generate of one
HYBRID_PREFILL_SHAPE = (4, 2048, 32, 32, 128, torch.bfloat16, True)
FALLBACK_PREFILL_SHAPE = (1, 2048, 32, 32, 128, torch.bfloat16, True)
# phase tooling's: the head-pruned llama-740m after redundancy_clean (7 of
# its 14 heads) at the serving forward's S, and the autotuner's trial of
# the train cell at micro-batch 16 (its forward runs K1 before the card
# runs out of memory)
CLEANED_SHAPE = (1, 4096, 7, 7, 128, torch.bfloat16, True)
AUTOTUNE_OOM_SHAPE = (16, 16384, 14, 14, 128, torch.bfloat16, True)
FWD_SHAPES = [
    TRAIN_SHAPE,
    SERVE_SHAPE,
    ULY_SHAPE,
    LTD_SHAPE,
    LORA_SHAPE,
    HYBRID_PREFILL_SHAPE,
    FALLBACK_PREFILL_SHAPE,
    CLEANED_SHAPE,
    AUTOTUNE_OOM_SHAPE,
    (2, 2048, 32, 8, 128, torch.bfloat16, True),
    (2, 2048, 12, 12, 64, torch.bfloat16, True),
    (1, 2048, 16, 16, 128, torch.bfloat16, False),
    (1, 1024, 8, 8, 128, torch.float16, True),
    (1, 1024, 8, 2, 64, torch.float32, True),
]
# K2/K3: the tensor-core kernels (bf16/fp16), then the CUDA-core fp32 ones
BWD_SHAPES = [
    TRAIN_SHAPE,
    ULY_SHAPE,
    LTD_SHAPE,
    LORA_SHAPE,
    (2, 2048, 32, 8, 128, torch.bfloat16, True),
    (2, 2048, 12, 12, 64, torch.bfloat16, True),
    (1, 2048, 16, 16, 128, torch.bfloat16, False),
    (1, 1024, 8, 8, 128, torch.float16, True),
    (1, 2048, 8, 2, 64, torch.float32, True),
    (1, 2048, 8, 2, 128, torch.float32, True),
    (1, 2048, 8, 2, 128, torch.float32, False),
]
FP32_BWD_SHAPE = (1, 2048, 8, 2, 128, torch.float32, True)   # the kernels line's fp32 record
# From this length on, one fp32 [S, S] score plane per head is over 0.27 GB
# and the plain versions run on slices of one batch row's PLAIN_HEADS heads:
# compared on the first slice, timed over all of them.
CHUNK_FROM_S = 8192
PLAIN_HEADS = 2
# Agreement with the plain version, per output tensor [B, S, H, hd]:
#  - the relative error ||got - ref|| / ||ref|| of every 128-row tile of
#    every (batch, head), the worst tile gated.  Tile by tile, rows with
#    small values (the long rows and late keys of a causal plane, where
#    |dq| ~ sqrt(e/n)) are held as tightly as the large early ones;
#  - per element, |got - ref| <= elem_rtol |ref| + elem_atol_rms * rms(ref),
#    for a single wrong element inside a tile.
# bf16/fp16 P and dS are rounded to the input dtype before their products
# and sums run in another order; fp32 differs in summation order only.  K1
# rounds the unnormalised P of its online softmax, the plain version the
# normalised one, so its errors are larger than K2/K3's.  Each limit lies
# between two readings on the H100 (PERF.md): above the worst tile error
# and per-element need of the kernel over every shape here and in
# tests/test_torch_kernels_gpu.py, and below the worst-tile error of the
# lower-precision yardstick (``plain_low_precision``); both yardsticks must
# be rejected in every run.
AGREE_TOL = {
    # K1: worst tile 3.3e-3 bf16 / 4.0e-4 fp16 / 7.9e-7 fp32; yardstick
    # >= 5.9e-3 / 8.6e-4 / 4.7e-3.  Per element: needs <= 0.063 / 0.003.
    "fwd": {
        torch.bfloat16: {"tile_rel": 4.5e-3, "elem_rtol": 2e-2, "elem_atol_rms": 0.1},
        torch.float16: {"tile_rel": 6e-4, "elem_rtol": 2e-2, "elem_atol_rms": 1e-2},
        torch.float32: {"tile_rel": 1e-5, "elem_rtol": 1e-4, "elem_atol_rms": 1e-3},
    },
    # K2/K3: worst tile 8.7e-4 bf16 / 8.7e-5 fp16; yardstick >= 6.7e-3 /
    # 1.0e-3.  Per element: needs <= 0.008 / 0.0011, yardstick >= 0.064 / 0.010.
    # fp32 (summation order only): fp32's tile limit of PERF.md, as K1's.
    "bwd": {
        torch.bfloat16: {"tile_rel": 3e-3, "elem_rtol": 2e-2, "elem_atol_rms": 3e-2},
        torch.float16: {"tile_rel": 4e-4, "elem_rtol": 2e-2, "elem_atol_rms": 5e-3},
        torch.float32: {"tile_rel": 1e-5, "elem_rtol": 1e-4, "elem_atol_rms": 1e-3},
    },
}
LSE_ATOL = 1e-5   # lse is fp32 always: 1.9e-6 at most on the H100
# K1 bf16, causal, past 16384 rows (the longest length the limits above
# were set at): rms(ref), the per-element unit, keeps falling with S (0.0375
# at 16384 rows, 0.0279 at 32768) while the rounding of a short row's few
# dominant products does not (max |err| 0.0156 at every length), so the
# same elements need more units.  At uly_7b's (1, 32768, 8x128) K1 needed
# 0.134 and the lower-precision yardstick 0.269 (H100, PERF.md): the limit
# there lies between; the tile limit is AGREE_TOL's.
LONG_ROWS, LONG_ROWS_FWD_ELEM_ATOL_RMS = 16384, 0.2


def fwd_tol(dtype, S: int, causal: bool) -> dict:
    """K1's AGREE_TOL entry at this length."""
    tol = AGREE_TOL["fwd"][dtype]
    if dtype == torch.bfloat16 and causal and S > LONG_ROWS:
        tol = {**tol, "elem_atol_rms": LONG_ROWS_FWD_ELEM_ATOL_RMS}
    return tol

# bench.py's training defaults, on the port
TRAIN_MODEL = "llama-740m"
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 1,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 1e-4, "mu_dtype": "bfloat16",
                             "nu_dtype": "float32"}},
    "zero_optimization": {"stage": 1},
    "bf16": {"enabled": True},
    "data_types": {"grad_accum_dtype": "bf16"},
    "steps_per_print": 10 ** 9,
}
WARM_STEPS, TIMED_STEPS = 2, 5
PARITY_S, PARITY_STEPS = 2048, 3
# K1 launches per layer and step under each named remat policy (K2 and K3:
# one each): save_qkv and save_matmuls keep the kernel's own output and lse
REMAT_POLICY_K1 = {"nothing_saveable": 2, "save_attn": 2, "save_qkv": 1,
                   "save_matmuls": 1, "dots_saveable": 2}
REMAT_TIMED_STEPS = 3
# what a policy's forward holds beyond nothing_saveable's must be what it
# keeps (``saved_bytes_per_layer``) within this share and this many GB
REMAT_HELD_RTOL, REMAT_HELD_ATOL_GB = 0.1, 0.1
# bytes a parameter of a checkpoint: bf16 params, fp32 masters, bf16 mu,
# fp32 nu (TRAIN_CONFIG)
CKPT_BYTES_PER_PARAM = 2 + 4 + 2 + 4
# phase checkpoint's depth, of llama-740m's 16 layers: the script's time
# limit since phases elastic and pod (the save, load and resume of tags
# through separate processes) joined it; the rates are per byte, at ~2.6 GB
# a tag
CKPT_LAYERS = 4
# bf16 kernel path vs bf16 plain branch (P rounded at different points),
# every step: a few times the gaps measured on the card (5.7e-4 in loss,
# 0.67% in gradient norm at step 3; PERF.md)
PARITY_LOSS_RTOL = 2e-3
PARITY_GRAD_NORM_RTOL = 2e-2
# fp32 through the kernels (attn_impl="auto") vs the fp32 plain branch: the
# two differ in summation order only (4.1e-7 in loss, 1.4e-6 in gradient
# norm on the H100).  Each limit lies between that reading and the
# yardstick every run must exceed: the bf16 kernel path's own distance
# from fp32 (4.0e-4 / 4.9e-3; PERF.md).
FP32_PARITY_LOSS_RTOL = 1e-5
FP32_PARITY_GRAD_NORM_RTOL = 1e-4
GEN_PROMPTS, GEN_NEW = [17, 45, 90, 128], 32

# The paged serving stream: 24 requests arriving at t=0, prompts 16-2000
# tokens (log-uniform), 32-128 new tokens, 4 sharing a 600-token prefix
# (whole pages and a copy-on-write boundary page), 4 sampled lanes.
SERVE_SLOTS, SERVE_PAGE, SERVE_MAX_LEN = 8, 128, 4096
SERVE_REQUESTS, SHARED_PREFIX = 24, 600
SHARED_RIDS, SAMPLED_RIDS = (3, 9, 15, 21), (1, 6, 12, 18)
# K4 cases: (label, B, Hq, Hkv, hd, dtype, page, pages per slot).  The first
# is the serving decode tick's (lengths from the stream); "identity" runs a
# contiguous [B, T, Hkv, hd] cache; "len0" has a slot at length 0 (its
# table row all trash page); "shared" maps slot 0's pages into slot 1;
# "full" has every slot at T - 1 (bandwidth alone decides) and "skew" slot
# 0 at T - 1 beside seven slots at 1 (``decode_lengths``).
DECODE_CASES = [
    ("serve", 8, 32, 32, 128, torch.bfloat16, 128, 32),
    ("gqa", 8, 32, 8, 128, torch.bfloat16, 128, 32),
    ("hd64", 8, 16, 16, 64, torch.bfloat16, 128, 32),
    ("page16", 8, 32, 32, 128, torch.bfloat16, 16, 256),
    ("identity", 8, 32, 32, 128, torch.bfloat16, 4096, 1),
    ("fp16", 8, 32, 32, 128, torch.float16, 128, 32),
    ("fp32", 8, 32, 32, 128, torch.float32, 128, 32),
    ("len0", 8, 32, 32, 128, torch.bfloat16, 128, 32),
    ("shared", 8, 32, 32, 128, torch.bfloat16, 128, 32),
    ("full", 8, 32, 32, 128, torch.bfloat16, 128, 32),
    ("skew", 8, 32, 32, 128, torch.bfloat16, 128, 32),
]
# K4's int8 mode (kv_dtype="int8" pages: int8 codes and one fp32 scale per
# pool row, read in place): the cases of DECODE_CASES it runs at, the pools
# made by quantizing the case's bf16/fp32 pools row by row
# (``kv_quantize_rows``), held to the same DECODE_TOL as the case's dtype.
DECODE_INT8_CASES = ("serve", "gqa", "hd64", "page16", "fp32")
# K4 against its plain version, per (slot, head) output row: the worst
# row's relative error and a per-element bound (``agreement`` with one row
# per tile).  The kernel keeps the scores in fp32 and rounds the
# unnormalised P of its online softmax, the plain version the normalised
# one.  Each row limit lies between two readings on the H100 (PERF.md):
# above the kernel's worst row over every case here and in
# tests/test_torch_kernels_gpu.py (bf16 4.4e-3, fp16 4.8e-4, fp32 6.5e-7),
# below the lower-precision yardstick's (scores rounded to the input dtype:
# >= 7.1e-3 / 1.5e-3 / 9.8e-3).  The per-element bounds sit 3x above the
# kernel's need (0.0104 / 0.0006 / ~0).
DECODE_TOL = {
    torch.bfloat16: {"tile_rel": 6e-3, "elem_rtol": 2e-2, "elem_atol_rms": 3e-2},
    torch.float16: {"tile_rel": 8e-4, "elem_rtol": 2e-2, "elem_atol_rms": 3e-3},
    torch.float32: {"tile_rel": 1e-5, "elem_rtol": 1e-4, "elem_atol_rms": 1e-4},
}

# Block-sparse attention (``SparseSelfAttention`` -> the masked K1, K2, K3):
# (label, (B, S, Hq, Hkv, hd, dtype), (sparsity config, its arguments)).
# The first is the main case: llama-740m's attention at bench.py's training
# length under the GPT-3 "fixed" pattern; then llama2-7b's width under
# BigBird (bidirectional), GQA with 64-blocks (below K1/K2's 128-row tile),
# hd 64 with 32-blocks (below K3's tile too), fp16, a dense layout that must
# equal the unmasked kernels, and a raw mask with dead block rows (layout
# None: ``dead_rows_mask``).
SPARSE_CASES = [
    ("fixed_740m", (1, 16384, 14, 14, 128, torch.bfloat16),
     ("FixedSparsityConfig", {"block": 128, "num_local_blocks": 4,
                              "num_global_blocks": 1})),
    ("bigbird_7b", (1, 4096, 32, 32, 128, torch.bfloat16),
     ("BigBirdSparsityConfig", {"block": 128, "attention": "bidirectional"})),
    ("longformer_gqa", (2, 2048, 32, 8, 128, torch.bfloat16),
     ("BSLongformerSparsityConfig", {"block": 64, "num_sliding_window_blocks": 3})),
    ("variable_hd64", (2, 2048, 12, 12, 64, torch.bfloat16),
     ("VariableSparsityConfig", {"block": 32, "local_window_blocks": (2, 4),
                                 "global_block_indices": (0,)})),
    ("fixed_fp16", (1, 2048, 16, 16, 128, torch.float16),
     ("FixedSparsityConfig", {"block": 128, "num_local_blocks": 4,
                              "num_global_blocks": 1})),
    ("dense_equiv", (1, 4096, 32, 32, 128, torch.bfloat16),
     ("DenseSparsityConfig", {"block": 128})),
    ("dead_rows", (1, 2048, 8, 8, 128, torch.bfloat16), None),
]
# The masked kernels must take at most this share of the same kernel's
# unmasked time at the main case (27.4% of the causal pairs live): dead
# tiles are neither loaded nor computed.
SPARSE_MAX_TIME_RATIO = 0.7
# DeepSpeedTransformerLayer at BERT-large width, bf16 activations
LAYER_SHAPE = {"batch_size": 8, "seq": 512, "hidden_size": 1024, "heads": 16,
               "intermediate_size": 4096, "num_hidden_layers": 24}
# bf16 activations against the same layer in fp32: relative L2 of the output
LAYER_REL_TOL = 5e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of one call, by CUDA events around each call;
    ``flush`` (``l2_flush``) runs before each call, outside the events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


L2_FLUSH_BYTES = 1 << 30   # 20x the H100's 50 MB L2


def l2_flush():
    """A callable that reads L2_FLUSH_BYTES through the L2, leaving it full
    of other (clean) lines: a decode tick finds the pools cold, since one
    layer's weights (~400 MB at llama2-7b) pass through the L2 between two
    K4 launches.  Read rather than written, as those weights are: a written
    buffer would leave dirty lines whose write-back the timed call pays.
    The read keeps the card busy ~0.33 ms, longer than the host takes to
    enqueue the timed call behind it, so the events time the device alone
    (a shorter flush left the host's launch time inside the events)."""
    buf = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    return lambda: buf.sum()


def _bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _pairs(S: int, causal: bool) -> int:
    return S * (S + 1) // 2 if causal else S * S


# Tensor-core products a kernel does over each attended (query, key) pair:
# the forward 2 (QK^T, PV), K2 3 (QK^T, dO V^T, dS K), K3 4 (the same two
# scores, P^T dO, dS^T Q)
ATTN_GEMMS = {"fwd": 2, "dq": 3, "dkv": 4}


def attention_cost(kernel, B, S, Hq, Hkv, hd, esize, pairs) -> tuple:
    """(operations, bytes) of one launch of ``kernel`` over ``pairs``
    attended pairs.  Bytes: each input read once, each output written once
    (fp32 lse/delta rows [B, Hq, S])."""
    q_bytes, kv_bytes, row_bytes = (esize * B * S * Hq * hd, esize * B * S * Hkv * hd,
                                    4 * B * Hq * S)
    nbytes = {
        "fwd": 2 * q_bytes + 2 * kv_bytes + row_bytes,             # q,k,v -> out,lse
        "dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,         # q,k,v,dO,lse,delta -> dq
        "dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,        # ... -> dk,dv
    }[kernel]
    return ATTN_GEMMS[kernel] * 2.0 * B * Hq * pairs * hd, float(nbytes)


def attention_bound_ms(B, S, Hq, Hkv, hd, dtype, causal, kernel="fwd",
                       pairs=None) -> tuple:
    """Least time for the work these inputs need, at the dtype's peak or
    the memory rate (``attention_cost``) over the attended (query, key)
    pairs (``pairs``: the live pairs of a block mask; by default every
    pair, or the causal triangle)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    return _bound(*attention_cost(kernel, B, S, Hq, Hkv, hd, esize,
                                  _pairs(S, causal) if pairs is None else pairs), dtype)


def attention_flops(B, S, Hq, Hkv, hd, dtype, causal) -> float:
    """The forward's tensor-core work over the attended pairs (QK^T, PV)."""
    return attention_cost("fwd", B, S, Hq, Hkv, hd, 2, _pairs(S, causal))[0]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _kernel_label(mangled: str) -> str:
    if "decode_attention_kernel" in mangled:
        g = re.search(r"Li(\d+)ELi(\d+)E", mangled)
        dtype = ("bf16" if "bfloat16" in mangled else "fp16" if "half" in mangled
                 else "fp32")
        return (f"decode_attention_kernel<{dtype},hd{g.group(1) if g else '?'},"
                f"G{g.group(2) if g else '?'}>")
    name = re.search(r"\d+(flash_\w+?_kernel)", mangled)
    hd = re.search(r"Li(\d+)E", mangled)
    dtype = ("bf16" if "bfloat16" in mangled else "fp16" if "half" in mangled
             else "fp32")
    causal, masked = (re.findall(r"Lb([01])E", mangled) + ["?", "?"])[:2]
    return (f"{name.group(1) if name else mangled[:60]}<{dtype},"
            f"hd{hd.group(1) if hd else '?'},causal={causal},masked={masked}>")


def ptxas_report(log: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads}} from nvcc -Xptxas=-v,
    and ptxas's performance warnings by code and kernel (C7513 and the like:
    wgmma serialised) under ``warnings``."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"\((C\d+)\) (.*?) in the function '(\S+)'", line)
        if m:
            out.setdefault("warnings", []).append(
                f"{m.group(1)} {_kernel_label(m.group(3))}: {m.group(2)[:160]}")
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = _kernel_label(m.group(1))
            out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current]["spill_stores"] = int(m.group(1))
            out[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


def phase_build():
    """Every kernel source, one nvcc each, all started together."""
    from deepspeed_tpu_torch.ops.kernels import decode_attention as da
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.op_builder import BUILD_DIR

    builders = fa.builders() + da.builders()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        list(pool.map(lambda b: b.load(), builders))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {b.name: b.build_seconds for b in builders},
          "build_dir": str(BUILD_DIR),
          "ptxas": {b.name: ptxas_report(b.log) for b in builders}})


# The first launches of K1, K2 and K3, then K4 at FIRST_LAUNCH_DECODE, in a
# child process with a time limit: a wrong mbarrier phase parity in their
# TMA pipelines (or a tile list that producer and consumers walk apart)
# hangs a kernel instead of failing it, and a hang would otherwise hold the
# run.
FIRST_LAUNCH_SHAPES = [
    (1, 256, 2, 2, 64, torch.bfloat16, True),
    (1, 256, 2, 2, 128, torch.bfloat16, True),
    (1, 256, 2, 2, 128, torch.float16, False),
    (1, 256, 4, 2, 128, torch.float32, True),
    TRAIN_SHAPE,
]
FIRST_LAUNCH_DECODE = ("serve", "len0", "page16", "fp32")
# K4's int8 mode: its first launches (a verify block's B*(k+1) rows too)
FIRST_LAUNCH_DECODE_INT8 = ("serve", "page16", "fp32", "verify")
SPEC_K = 4   # draft tokens a speculative tick (phase serving_extras)
FIRST_LAUNCH_TIMEOUT_S = 180
K1_DESIGN = ("wgmma+TMA, warp-specialised: a producer warpgroup (setmaxnreg 24) "
             "feeds a 2-3 stage K/V ring by TMA; two consumer warpgroups "
             "(setmaxnreg 240) of 64 query rows, 128-key tiles, S=QK^T SS and "
             "O+=PV RS, a tile's softmax overlapping the next products")
K2_DESIGN = ("wgmma+TMA, warp-specialised: Q and dO resident (128 query rows), a "
             "producer warpgroup (setmaxnreg 24) feeds a 3-4 stage ring of 64-key "
             "K/V tiles by TMA; two consumer warpgroups (setmaxnreg 240) of 64 rows: "
             "S=QK^T and dP=dO V^T SS m64n64, P on S while dP runs, dQ+=dS K RS "
             "with K read MN-major; fp32: a CUDA-core kernel of 64-row tiles")
K3_DESIGN = ("wgmma+TMA, warp-specialised: K and V resident (128 keys), a producer "
             "warpgroup (setmaxnreg 24) feeds a 2-3 stage ring of 64-row Q/dO tiles "
             "by TMA and their lse/delta by bulk copy, over every q head of the "
             "group; two consumer warpgroups (setmaxnreg 240) of 64 keys: "
             "S^T=KQ^T and dP^T=V dO^T SS m64n64, dV+=P^T dO and dK+=dS^T Q RS "
             "with dO and Q read MN-major, dS in registers only; fp32: a "
             "CUDA-core kernel of 64-key tiles")


def _child(args, timeout_s: int, what: str):
    """Run this script again with ``args``, killed after ``timeout_s``: a
    hang raises with what the child printed so far."""
    try:
        return subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                              capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        raise RuntimeError(f"{what} did not finish in {timeout_s} s: the kernel hangs. "
                           f"Its output so far:\n{out[-4000:]}")


def first_launches() -> int:
    """The child's side of ``phase_first_launch``: launch K1, then K2 and
    K3 on its residuals, once at each FIRST_LAUNCH_SHAPES entry, then K4 at
    each FIRST_LAUNCH_DECODE case; synchronise after each, and compare the
    small ones and K4 with the plain versions (worst-tile / worst-row
    gates).  Prints one JSON line per launch as it goes (a hang shows which
    kernel hung) and a summary line."""
    from deepspeed_tpu_torch.ops.kernels import decode_attention as da
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for shape in FIRST_LAUNCH_SHAPES:
        causal, dtype, small = shape[-1], shape[5], shape[1] < CHUNK_FROM_S
        q, k, v, do = _inputs(gen, shape, 4)
        scale = shape[4] ** -0.5
        rec = {"shape": _shape_dict(shape, None)}
        with torch.inference_mode():
            t0 = time.perf_counter()
            o, lse = fa._forward(q, k, v, causal, scale)
            torch.cuda.synchronize()
            rec["K1_s"] = time.perf_counter() - t0
            emit({"first_launch": "K1", **rec})
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
            args = (q, k, v, do, lse, delta, causal, scale)
            t0 = time.perf_counter()
            dq = fa.flash_attention_bwd_dq(*args)
            torch.cuda.synchronize()
            rec["K2_s"] = time.perf_counter() - t0
            emit({"first_launch": "K2", **rec})
            t0 = time.perf_counter()
            dk, dv = fa.flash_attention_bwd_dkv(*args)
            torch.cuda.synchronize()
            rec["K3_s"] = time.perf_counter() - t0
            emit({"first_launch": "K3", **rec})
            if small:
                ref = fa.flash_attention_reference(q, k, v, causal, scale)
                rec["agreement"] = {"out": agreement(o, ref, AGREE_TOL["fwd"][dtype])}
                rk, rv = fa.flash_attention_bwd_dkv_reference(*args)
                for name, got, want in (
                        ("dq", dq, fa.flash_attention_bwd_dq_reference(*args)),
                        ("dk", dk, rk), ("dv", dv, rv)):
                    rec["agreement"][name] = agreement(got, want, AGREE_TOL["bwd"][dtype])
        out.append(rec)
        del q, k, v, do, o, lse, delta, dq, dk, dv
        free_memory()
    for label in FIRST_LAUNCH_DECODE:
        case = next(c for c in DECODE_CASES if c[0] == label)
        q, k, v, mask, table = _decode_case(gen, case, decode_lengths(case, 0))
        rec = {"case": label}
        with torch.inference_mode():
            t0 = time.perf_counter()
            o = da.decode_attention(q, k, v, mask, table)
            torch.cuda.synchronize()
            rec["K4_s"] = time.perf_counter() - t0
            emit({"first_launch": "K4", **rec})
            ref = da.decode_attention_reference(q, k, v, mask, table)
            rec["agreement"] = {"out": agreement(o[:, :, None], ref[:, :, None],
                                                 DECODE_TOL[case[5]], tile=1)}
        out.append(rec)
        del q, k, v, mask, table, o, ref
        free_memory()
    for label in FIRST_LAUNCH_DECODE_INT8:
        verify = label == "verify"
        case = next(c for c in DECODE_CASES if c[0] == ("serve" if verify else label))
        q, k, v, mask, table = _decode_case(gen, case, decode_lengths(case, 0))
        k, v, ks, vs = quantize_pools(k, v)
        if verify:   # each slot's k+1 rows, as forward_paged(verify=True) sends them
            q, table, mask = verify_rows(gen, q, table, mask, decode_lengths(case, 0))
        rec = {"case": label, "int8": True}
        with torch.inference_mode():
            t0 = time.perf_counter()
            o = da.decode_attention(q, k, v, mask, table, k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            rec["K4_s"] = time.perf_counter() - t0
            emit({"first_launch": "K4 int8", **rec})
            ref = da.decode_attention_reference(q, k, v, mask, table, k_scale=ks,
                                                v_scale=vs)
            rec["agreement"] = {"out": agreement(o[:, :, None], ref[:, :, None],
                                                 DECODE_TOL[case[5]], tile=1)}
        out.append(rec)
        del q, k, v, ks, vs, mask, table, o, ref
        free_memory()
    emit({"first_launches": out})
    return 0 if all(a["ok"] for r in out for a in r.get("agreement", {}).values()) else 1


def phase_first_launch():
    """The first launches of K1-K4 in a child process that is killed after
    FIRST_LAUNCH_TIMEOUT_S: a hang fails the run here, with a message."""
    t0 = time.perf_counter()
    res = _child(["--first-launch"], FIRST_LAUNCH_TIMEOUT_S, "the first launches of K1-K4")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    rec = json.loads(lines[-1]) if lines else {}
    emit({"phase": "first_launch", "seconds": time.perf_counter() - t0,
          "returncode": res.returncode, **rec})
    check(res.returncode == 0, f"the first launches of K1-K4 failed (exit "
                               f"{res.returncode}): {res.stdout[-2000:]} "
                               f"{res.stderr[-4000:]}")


def _cut(x, sl):
    """Slice ``sl`` = (batch row, first head, end head) of a [B, S, H, hd]
    tensor or of a [B, H, S] row tensor (lse, delta)."""
    b, lo, hi = sl
    return x[b:b + 1].narrow(2 if x.dim() == 4 else 1, lo, hi - lo).contiguous()


def _slices(shape):
    """Pieces the plain versions run on: None (all at once), or from
    CHUNK_FROM_S on (MHA only) each batch row's heads PLAIN_HEADS at a
    time, as (row, first head, end head)."""
    B, S, Hq, Hkv, hd, dtype, causal = shape
    if S < CHUNK_FROM_S:
        return None
    check(Hq == Hkv and Hq % PLAIN_HEADS == 0, "head slices need MHA")
    return [(b, h, h + PLAIN_HEADS) for b in range(B) for h in range(0, Hq, PLAIN_HEADS)]


def _parts(slices, *tensors):
    """The plain version's inputs per slice (``_cut``)."""
    if slices is None:
        return [list(tensors)]
    return [[_cut(x, sl) for x in tensors] for sl in slices]


def _inputs(gen, shape, n):
    B, S, Hq, Hkv, hd, dtype, causal = shape
    heads = (Hq, Hkv, Hkv, Hq)[:n]
    return [torch.randn((B, S, H, hd), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype) for H in heads]


def _shape_dict(shape, slices):
    B, S, Hq, Hkv, hd, dtype, causal = shape
    d = {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd,
         "dtype": str(dtype).replace("torch.", ""), "causal": causal}
    if slices is not None:
        b, lo, hi = slices[0]
        d["plain_on"] = (f"row {b}, heads {lo}-{hi - 1} compared; "
                         f"plain_ms over all {len(slices)} slices of one row's "
                         f"{PLAIN_HEADS} heads")
    return d


def agreement(got, ref, tol: dict, tile: int = 128, dead=None) -> dict:
    """How far ``got`` [B, S, H, hd] is from the plain version ``ref``, and
    whether that is within ``tol`` (an ``AGREE_TOL`` entry; key ``ok``).
    ``dead`` (bool [S]): the rows a block mask leaves with nothing to attend
    (or keys no live query sees); both tensors must be exactly zero there,
    and tiles whose reference is all zero are left out of the worst tile's
    ratio."""
    got, ref = got.float(), ref.float()
    diff = got - ref
    B, S, H, hd = ref.shape

    def tile_norms(x):
        return x.reshape(B, S // tile, tile, H, hd).pow(2).sum((2, 4)).sqrt()

    rms = ref.pow(2).mean().sqrt().item()
    ref_norms = tile_norms(ref)
    live = ref_norms > 0
    tile_rel = (tile_norms(diff)[live] / ref_norms[live]).max().item()
    # the smallest elem_atol_rms this pair passes at the dtype's elem_rtol
    atol_needed = ((diff.abs() - tol["elem_rtol"] * ref.abs()).clamp(min=0).max()
                   .item() / rms)
    out = {"max_abs_err": diff.abs().max().item(),
           "max_abs_ref": ref.abs().max().item(), "rms_ref": rms,
           "rel_l2": (diff.norm() / ref.norm()).item(),
           "worst_tile_rel_l2": tile_rel, "elem_atol_rms_needed": atol_needed,
           "ok": tile_rel <= tol["tile_rel"] and atol_needed <= tol["elem_atol_rms"]}
    if dead is not None:
        exact = bool((got[:, dead] == 0).all() and (ref[:, dead] == 0).all())
        out.update(dead_rows=int(dead.sum()), dead_rows_exact=exact,
                   ok=out["ok"] and exact)
    return out


def plain_low_precision(q, k, v, causal, do=None, lse=None, delta=None,
                        block_mask=None):
    """The yardstick the gates must reject: the plain formulas with the
    scores S (and dP) rounded to the input dtype after their products, as
    a kernel that kept them in half precision would (to bf16 for fp32
    inputs).  Returns out, or (dq, dk, dv) when given dO, lse and delta."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import attended

    B, S, Hq, hd = q.shape
    Hkv, scale = k.shape[2], 1.0 / math.sqrt(hd)
    kr, vr = (x.repeat_interleave(Hq // Hkv, dim=2) for x in (k, v))
    low = torch.bfloat16 if q.dtype == torch.float32 else q.dtype
    s = (torch.einsum("bqhd,bkhd->bhqk", q, kr) * scale).to(low)
    keep = attended(S, causal, block_mask, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    if do is None:
        p = torch.softmax(s, dim=-1)
        if block_mask is not None:      # dead rows: 0, not the softmax's NaN
            p = p.masked_fill(~keep, 0.0)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), vr)
    p = torch.exp(s.float() - lse[..., None]).to(q.dtype)
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vr)
    ds = (p.float() * (dp.float() - delta[..., None]) * scale).to(q.dtype)
    del dp

    def group_sum(x):
        return x.float().reshape(B, S, Hkv, Hq // Hkv, hd).sum(3).to(q.dtype)

    return (torch.einsum("bhqk,bkhd->bqhd", ds, kr),
            group_sum(torch.einsum("bhqk,bqhd->bkhd", ds, q)),
            group_sum(torch.einsum("bhqk,bqhd->bkhd", p, do)))


def compare(got, ref, low, tol: dict, tile: int = 128, dead=None) -> dict:
    """``agreement`` of the kernel's output, with the readings of two
    yardsticks beside it: the lower-precision version ``low``, and the
    kernel's output with its last live ``tile`` rows zeroed (a grid one CTA
    short: the longest causal rows for dq and out, the last keys for dk
    and dv, where the values are smallest)."""
    B, S = ref.shape[:2]
    live = ref.reshape(B, S // tile, -1).abs().amax(dim=(0, 2)) > 0
    last = int(live.nonzero().max())
    broken = got.clone()
    broken[:, last * tile:(last + 1) * tile] = 0
    keys = ("max_abs_err", "rel_l2", "worst_tile_rel_l2", "elem_atol_rms_needed")
    out = agreement(got, ref, tol, tile, dead)
    for name, x in (("low_precision", low), ("last_tile_zeroed", broken)):
        reading = agreement(x, ref, tol, tile, dead)
        out[name] = {**{k: reading[k] for k in keys}, "rejected": not reading["ok"]}
    out["yardsticks_rejected"] = all(out[n]["rejected"] for n in
                                     ("low_precision", "last_tile_zeroed"))
    return out


def phase_fwd_kernel(gen: torch.Generator):
    """K1 vs its plain version; returns {shape: record}."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_reference)

    records = {}
    for shape in FWD_SHAPES:
        B, S, Hq, Hkv, hd, dtype, causal = shape
        slices = _slices(shape)
        q, k, v = _inputs(gen, shape, 3)
        parts = _parts(slices, q, k, v)
        with torch.inference_mode():
            out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
            torch.cuda.synchronize()
            ref, ref_lse = flash_attention_reference(*parts[0], causal, None, True)
            if slices is not None:
                out, lse = _cut(out, slices[0]), _cut(lse, slices[0])
            tol = fwd_tol(dtype, S, causal)
            agree = compare(out, ref, plain_low_precision(*parts[0], causal), tol)
            lse_err = (lse - ref_lse).abs().max().item()
            del out, lse, ref, ref_lse
            kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal))
            reps, warm = (20, 3) if slices is None else (5, 1)
            plain_ms = time_ms(
                lambda: [flash_attention_reference(*p, causal) for p in parts],
                reps=reps, warmup=warm)
            del parts
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv))
        bound, bound_by = attention_bound_ms(*shape)
        rec = {"phase": "kernel", "name": "flash_attention_fwd",
               "shape": _shape_dict(shape, slices),
               "max_abs_err": agree["max_abs_err"], "out": agree,
               "tol": tol, "lse_max_abs_err": lse_err,
               "lse_atol": LSE_ATOL, "ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound, "bound_by": bound_by,
               "bound_share": bound / kernel_ms,
               "tflops": attention_flops(*shape) / kernel_ms / 1e9}
        emit(rec)
        check(agree["ok"] and lse_err <= LSE_ATOL,
              f"flash_attention_fwd disagrees with its plain version at "
              f"{rec['shape']}: {agree}, lse err {lse_err}")
        check(agree["yardsticks_rejected"],
              f"the flash_attention_fwd gate passed a yardstick at "
              f"{rec['shape']}: {agree}")
        records[shape] = rec
        del q, k, v
        free_memory()
    return records


def phase_bwd_kernels(gen: torch.Generator):
    """K2 and K3 vs their plain versions on the residuals of a plain
    forward; library: the backward of scaled_dot_product_attention (dq, dk
    and dv in one call).  Returns {shape: (K2 record, K3 record)}."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference,
        flash_attention_bwd_dq, flash_attention_bwd_dq_reference,
        flash_attention_reference)

    records = {}
    for shape in BWD_SHAPES:
        B, S, Hq, Hkv, hd, dtype, causal = shape
        slices = _slices(shape)
        q, k, v, do = _inputs(gen, shape, 4)
        with torch.inference_mode():
            out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            del out
            args = (q, k, v, do, lse, delta, causal)
            dq = flash_attention_bwd_dq(*args)
            dk, dv = flash_attention_bwd_dkv(*args)
            torch.cuda.synchronize()
            # plain versions on the same residuals, head slice by head slice
            parts = _parts(slices, q, k, v, do, lse, delta)
            if slices is not None:   # MHA: q and kv heads slice alike
                dq, dk, dv = (_cut(x, slices[0]) for x in (dq, dk, dv))
            low = plain_low_precision(*parts[0][:3], causal, *parts[0][3:])
            rq = flash_attention_bwd_dq_reference(*parts[0], causal)
            tol = AGREE_TOL["bwd"][dtype]
            agree = {"dq": compare(dq, rq, low[0], tol)}
            del rq
            rk, rv = flash_attention_bwd_dkv_reference(*parts[0], causal)
            agree["dk"] = compare(dk, rk, low[1], tol)
            agree["dv"] = compare(dv, rv, low[2], tol)
            del rk, rv, dq, dk, dv, low
            free_memory()
            reps, warm = (20, 3) if slices is None else (5, 1)
            dq_ms = time_ms(lambda: flash_attention_bwd_dq(*args))
            dkv_ms = time_ms(lambda: flash_attention_bwd_dkv(*args))
            dq_plain = time_ms(lambda: [flash_attention_bwd_dq_reference(*p, causal)
                                        for p in parts], reps=reps, warmup=warm)
            dkv_plain = time_ms(lambda: [flash_attention_bwd_dkv_reference(*p, causal)
                                         for p in parts], reps=reps, warmup=warm)
            del parts
        free_memory()
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=Hq != Hkv)
        dot = do.transpose(1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True))
        del qt, kt, vt, sdpa_out, dot
        pair = []
        for name, kernel, ms, plain_ms, outs in (
                ("flash_attention_bwd_dq", "dq", dq_ms, dq_plain, ("dq",)),
                ("flash_attention_bwd_dkv", "dkv", dkv_ms, dkv_plain, ("dk", "dv"))):
            bound, bound_by = attention_bound_ms(*shape, kernel=kernel)
            rec = {"phase": "kernel", "name": name,
                   "shape": _shape_dict(shape, slices),
                   "max_abs_err": max(agree[o]["max_abs_err"] for o in outs),
                   **{o: agree[o] for o in outs}, "tol": tol,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "library_what": "scaled_dot_product_attention backward "
                                   "(dq, dk, dv in one call): compare with "
                                   "K2 + K3",
                   "bound_ms": bound, "bound_by": bound_by,
                   "bound_share": bound / ms}
            emit(rec)
            check(all(agree[o]["ok"] for o in outs),
                  f"{name} disagrees with its plain version at {rec['shape']}: "
                  f"{ {o: agree[o] for o in outs} }")
            check(all(agree[o]["yardsticks_rejected"] for o in outs),
                  f"the {name} gate passed a yardstick at {rec['shape']}: "
                  f"{ {o: agree[o] for o in outs} }")
            pair.append(rec)
        records[shape] = tuple(pair)
        del q, k, v, do, lse, delta, args
        free_memory()
    # fp32 gradients on the card run through K1-K3 under autograd (once
    # refused) and agree with an fp32 autograd of the plain forward
    f = [torch.randn((1, 256, 4, 64), generator=gen, device="cuda").requires_grad_()
         for _ in range(3)]
    do = torch.randn((1, 256, 4, 64), generator=gen, device="cuda")
    before = kernel_counts()
    flash_attention(*f).backward(do)
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(kernel_counts(), before))
    check(got == (1, 1, 1), f"an fp32 flash gradient launched K1/K2/K3 {got} times")
    fr = [x.detach().clone().requires_grad_() for x in f]
    flash_attention_reference(*fr).backward(do)
    for x, r in zip(f, fr):
        a = agreement(x.grad, r.grad, AGREE_TOL["bwd"][torch.float32])
        check(a["ok"], f"fp32 flash autograd disagrees with the plain autograd: {a}")
    return records


def serving_stream(seed: int, vocab: int):
    """The paged serving stream (``Request``s, all arriving at t=0)."""
    import numpy as np
    from deepspeed_tpu_torch.inference import Request, SamplingParams

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, SHARED_PREFIX)
    reqs = []
    for rid in range(SERVE_REQUESTS):
        if rid in SHARED_RIDS:
            tail = rng.integers(0, vocab, int(rng.integers(24, 400)))
            ids = np.concatenate([prefix, tail])
        else:
            n = int(np.exp(rng.uniform(math.log(16), math.log(2000))))
            ids = rng.integers(0, vocab, n)
        sampling = (SamplingParams(temperature=0.9, top_k=50, top_p=0.95,
                                   seed=1000 + rid)
                    if rid in SAMPLED_RIDS else None)
        reqs.append(Request(rid=rid, input_ids=ids.astype(np.int32),
                            max_new_tokens=int(rng.integers(32, 129)),
                            sampling=sampling))
    return reqs


def _decode_case(gen, case, lengths):
    """K4 inputs of one case: q [B, Hq, hd], pools [P, page, Hkv, hd] (or a
    contiguous cache), a shuffled page table and the mask t <= length."""
    label, B, Hq, Hkv, hd, dtype, page, maxp = case
    T = page * maxp
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((B, Hq, hd), generator=gen, device="cuda").to(dtype)
    if label == "identity":
        k, v = (torch.randn((B, T, Hkv, hd), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        table = None
    else:
        P = 1 + B * maxp
        k, v = (torch.randn((P, page, Hkv, hd), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
        table = perm[:B * maxp].reshape(B, maxp).to(torch.int32)
        used = (lengths.long() + page) // page            # pages holding 0..length
        table = torch.where(torch.arange(maxp, device="cuda")[None] < used[:, None],
                            table, torch.zeros_like(table))
        if label == "shared":
            n = int(used[0].item())
            table[1, :n] = table[0, :n]
    mask = (torch.arange(T, device="cuda")[None] <= lengths[:, None]).to(torch.int32)
    return q, k, v, mask, table


def quantize_pools(k, v):
    """A case's pools as int8 pages: each pool row quantized as the serving
    store does (``kv_quantize_rows``) -> (k8, v8, k_scale, v_scale), the
    scale planes [P, page] ([B, T] for a contiguous cache)."""
    from deepspeed_tpu_torch.models.transformer import kv_quantize_rows

    out = []
    for x in (k, v):
        q, s = kv_quantize_rows(x.reshape(-1, x.shape[2], x.shape[3]))
        out.append((q.reshape(x.shape), s.reshape(x.shape[:2])))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def verify_rows(gen, q, table, mask, lengths, k=SPEC_K):
    """A speculative verify block's K4 inputs: each slot's k+1 query rows
    (fresh queries), its page-table row repeated k+1 times, row j of slot b
    masked ``t <= lengths[b] + j`` (as ``forward_paged(verify=True)``)."""
    B, Hq, hd = q.shape
    T = mask.shape[1]
    qv = torch.randn((B * (k + 1), Hq, hd), generator=gen, device="cuda").to(q.dtype)
    pos = (torch.tensor(lengths, device="cuda")[:, None]
           + torch.arange(k + 1, device="cuda")[None]).reshape(-1)
    mv = (torch.arange(T, device="cuda")[None] <= pos[:, None]).to(torch.int32)
    return qv, table.repeat_interleave(k + 1, dim=0).contiguous(), mv


def decode_low_precision(q, k, v, mask, table):
    """The yardstick the K4 gate must reject: the plain version with the
    scores rounded to the input dtype (to bf16 for fp32 inputs)."""
    from deepspeed_tpu_torch.ops.kernels.decode_attention import _as_pool

    k, v, table = _as_pool(k, v, table)
    B, Hq, hd = q.shape
    P, page, Hkv, _ = k.shape
    T = mask.shape[1]
    t = torch.arange(T, device=q.device)
    rows = table.long()[:, t // page] * page + t % page
    ck, cv = (x.reshape(P * page, Hkv, hd)[rows] for x in (k, v))
    low = torch.bfloat16 if q.dtype == torch.float32 else q.dtype
    s = (torch.einsum("bkgd,btkd->bkgt", q.reshape(B, Hkv, Hq // Hkv, hd), ck)
         / math.sqrt(hd)).to(low).float()
    s = s.masked_fill(~mask.bool()[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgt,btkd->bkgd", p, cv).reshape(B, Hq, hd)


def decode_compare(got, ref, low, G, tol) -> dict:
    """``agreement`` per (slot, head) output row, beside two yardsticks:
    the lower-precision version and the kernel's output with the last KV
    head's group of the last slot zeroed (a grid one CTA short)."""
    def rows(x):
        return x[:, :, None, :]   # [B, Hq, 1, hd]: one row per tile

    broken = got.clone()
    broken[-1, -G:] = 0
    keys = ("max_abs_err", "rel_l2", "worst_tile_rel_l2", "elem_atol_rms_needed")
    out = agreement(rows(got), rows(ref), tol, tile=1)
    for name, x in (("low_precision", low), ("last_group_zeroed", broken)):
        reading = agreement(rows(x), rows(ref), tol, tile=1)
        out[name] = {**{k: reading[k] for k in keys}, "rejected": not reading["ok"]}
    out["yardsticks_rejected"] = all(out[n]["rejected"] for n in
                                     ("low_precision", "last_group_zeroed"))
    return out


def decode_work(case, lengths, int8: bool = False) -> tuple:
    """(operations, bytes) of K4's work on these inputs: 4 * attended * Hq
    * hd operations (q.k and p.v); the K/V bytes of the attended rows
    (int8: one byte an element plus the two fp32 scales of each row) plus
    q, out and the mask (and the page table)."""
    label, B, Hq, Hkv, hd, dtype, page, maxp = case
    esize = torch.tensor([], dtype=dtype).element_size()
    attended = sum(n + 1 for n in lengths)
    kv = (2 * attended * (Hkv * hd + 4) if int8
          else 2 * attended * Hkv * hd * esize)
    nbytes = (kv + 2 * B * Hq * hd * esize + 4 * B * page * maxp + 4 * B * maxp)
    return 4.0 * attended * Hq * hd, float(nbytes)


def decode_bound_ms(case, lengths, int8: bool = False) -> tuple:
    """Least time for K4's work on these inputs (``decode_work``) at the
    dtype's peak or the memory rate."""
    return _bound(*decode_work(case, lengths, int8), case[5])


def decode_lengths(case, seed: int) -> list:
    """The slot lengths of a K4 case: the first B requests of the serving
    stream halfway through their decode (slot 3 at 0 for "len0"), or the
    case's own ("full": every slot at T - 1; "skew": slot 0 at T - 1, the
    rest at 1)."""
    label, B, _, _, _, _, page, maxp = case
    T = page * maxp
    if label == "full":
        return [T - 1] * B
    if label == "skew":
        return [T - 1] + [1] * (B - 1)
    lengths = [len(r.input_ids) + r.max_new_tokens // 2
               for r in serving_stream(seed, 32000)[:B]]
    if label == "len0":
        lengths[3] = 0
    return lengths


def decode_sdpa_ms(q, k, v, mask, table, flush) -> float:
    """SDPA with query length 1 and a bool mask on the same keys gathered
    contiguous (the gather is not timed)."""
    from deepspeed_tpu_torch.ops.kernels.decode_attention import _as_pool

    B, Hq, hd = q.shape
    pk, pv, pt = _as_pool(k, v, table)
    page, Hkv = pk.shape[1], pk.shape[2]
    t = torch.arange(mask.shape[1], device="cuda")
    rows = pt.long()[:, t // page] * page + t % page
    ck, cv = (x.reshape(-1, Hkv, hd)[rows].transpose(1, 2).contiguous()
              for x in (pk, pv))
    bmask = mask.bool()[:, None, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], ck, cv, attn_mask=bmask, enable_gqa=Hq != Hkv), flush=flush)


K4_DESIGN = ("TMA page ring + cluster split + DSMEM merge: grid (Hkv, B, NSPLIT), "
             "clusters of NSPLIT <= 8 CTAs split a (slot, KV head)'s keys, tiles of "
             "R rows of a page interleaved over the ranks; each CTA lists its live "
             "tiles from the mask, one producer warp streams their K/V by TMA into "
             "a 32 KB mbarrier ring, four consumer warps run per-stream online "
             "softmax on CUDA cores; each rank pushes its state into the column "
             "owners' inboxes through distributed shared memory, one cluster "
             "barrier, each owner merges in rank order")


K4_INT8_DESIGN = ("the same kernel with int8 pools: TMA moves the int8 tiles as bytes "
                  "(64-row tiles, 4 or 8 KB of K), each consumer lane widens its "
                  "codes as round(code * row scale) in the compute dtype, the "
                  "tile's K and V scale rows bulk-copied into the same ring stage "
                  "on the tile's mbarrier")


def phase_decode_kernel(gen: torch.Generator, seed: int, gate: bool = True):
    """K4 vs its plain version at DECODE_CASES, then its int8 mode at
    DECODE_INT8_CASES (records ``<label>-int8``); library: SDPA with query
    length 1 and a bool mask on the same keys gathered contiguous (the
    gather, and for int8 the dequantization, not timed).  Every timing
    finds the L2 cold (``l2_flush``).  Returns {label: record}."""
    from deepspeed_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_reference, split_plan)

    flush = l2_flush()
    records = {}
    for case in DECODE_CASES:
        label, B, Hq, Hkv, hd, dtype, page, maxp = case
        lengths = decode_lengths(case, seed)
        q, k, v, mask, table = _decode_case(gen, case, lengths)
        tol = DECODE_TOL[dtype]
        with torch.inference_mode():
            before = decode_attention.launches
            out = decode_attention(q, k, v, mask, table)
            torch.cuda.synchronize()
            check(decode_attention.launches == before + 1, "K4 did not count its launch")
            ref = decode_attention_reference(q, k, v, mask, table)
            agree = decode_compare(out, ref, decode_low_precision(q, k, v, mask, table),
                                   Hq // Hkv, tol)
            kernel_ms = time_ms(lambda: decode_attention(q, k, v, mask, table), flush=flush)
            plain_ms = time_ms(lambda: decode_attention_reference(q, k, v, mask, table),
                               flush=flush)
            library_ms = decode_sdpa_ms(q, k, v, mask, table, flush)
        bound, bound_by = decode_bound_ms(case, lengths)
        nsplit, rows = split_plan(page * maxp, page, hd, dtype)
        rec = {"phase": "kernel", "name": "decode_attention", "case": label,
               "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "hd": hd,
                         "dtype": str(dtype).replace("torch.", ""), "page": page,
                         "pages_per_slot": maxp, "lengths": lengths,
                         "paged": table is not None},
               "nsplit": nsplit, "tile_rows": rows,
               "max_abs_err": agree["max_abs_err"], "out": agree, "tol": tol,
               "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library_what": "scaled_dot_product_attention, query length 1, "
                               "bool mask, keys gathered contiguous (gather "
                               "not timed)",
               "l2": "flushed", "bound_ms": bound, "bound_by": bound_by,
               "bound_share": bound / kernel_ms}
        emit(rec)
        if gate:
            check(agree["ok"], f"decode_attention disagrees with its plain version "
                               f"at {label}: {agree}")
            check(agree["yardsticks_rejected"],
                  f"the decode_attention gate passed a yardstick at {label}: {agree}")
        records[label] = rec
        del q, k, v, mask, table
        free_memory()
    # the int8 mode at DECODE_INT8_CASES: the case's pools quantized row by
    # row, against its plain version (gather, kv_dequantize, the same
    # arithmetic) within the case dtype's bounds; the library reading is
    # SDPA over the pre-dequantized cache (the dequantization not timed)
    for label in DECODE_INT8_CASES:
        case = next(c for c in DECODE_CASES if c[0] == label)
        _, B, Hq, Hkv, hd, dtype, page, maxp = case
        lengths = decode_lengths(case, seed)
        q, k, v, mask, table = _decode_case(gen, case, lengths)
        k8, v8, ks, vs = quantize_pools(k, v)
        del k, v
        tol = DECODE_TOL[dtype]
        with torch.inference_mode():
            before = decode_attention.launches
            out = decode_attention(q, k8, v8, mask, table, k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            check(decode_attention.launches == before + 1, "K4 did not count its launch")
            ref = decode_attention_reference(q, k8, v8, mask, table, k_scale=ks,
                                             v_scale=vs)
            kd = (k8.float() * ks[..., None, None]).to(dtype)
            vd = (v8.float() * vs[..., None, None]).to(dtype)
            agree = decode_compare(out, ref, decode_low_precision(q, kd, vd, mask, table),
                                   Hq // Hkv, tol)
            kernel_ms = time_ms(lambda: decode_attention(q, k8, v8, mask, table,
                                                         k_scale=ks, v_scale=vs),
                                flush=flush)
            plain_ms = time_ms(lambda: decode_attention_reference(
                q, k8, v8, mask, table, k_scale=ks, v_scale=vs), flush=flush)
            library_ms = decode_sdpa_ms(q, kd, vd, mask, table, flush)
        bound, bound_by = decode_bound_ms(case, lengths, int8=True)
        nsplit, rows = split_plan(page * maxp, page, hd, torch.int8)
        rec = {"phase": "kernel", "name": "decode_attention", "case": label,
               "mode": "int8", "shape": records[label]["shape"],
               "nsplit": nsplit, "tile_rows": rows,
               "max_abs_err": agree["max_abs_err"], "out": agree, "tol": tol,
               "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library_what": "scaled_dot_product_attention over the cache "
                               "dequantized to the case dtype and gathered "
                               "contiguous (neither timed), query length 1",
               "full_precision_ms": records[label]["ms"],
               "l2": "flushed", "bound_ms": bound, "bound_by": bound_by,
               "bound_share": bound / kernel_ms}
        emit(rec)
        if gate:
            check(agree["ok"], f"decode_attention int8 disagrees with its plain "
                               f"version at {label}: {agree}")
            check(agree["yardsticks_rejected"],
                  f"the decode_attention int8 gate passed a yardstick at {label}: "
                  f"{agree}")
        records[f"{label}-int8"] = rec
        del q, k8, v8, ks, vs, kd, vd, mask, table
        free_memory()
    # what the kernel does not take raises, never runs the plain version
    x = torch.zeros((1, 3, 128), device="cuda", dtype=torch.bfloat16)
    pool = torch.zeros((2, 8, 1, 128), device="cuda", dtype=torch.bfloat16)
    m = torch.ones((1, 8), device="cuda", dtype=torch.int32)
    pt = torch.ones((1, 1), device="cuda", dtype=torch.int32)
    for bad in (lambda: decode_attention(x, pool, pool, m, pt),            # G = 3
                lambda: decode_attention(x[:, :1].double(), pool.double(),
                                         pool.double(), m, pt)):
        try:
            bad()
        except (NotImplementedError, TypeError):
            pass
        else:
            raise RuntimeError("decode_attention ran an input it does not take")
    return records


def dead_rows_mask(S: int):
    """The raw block mask of the ``dead_rows`` case: 64-blocks, causal, half
    the blocks below the diagonal live, the diagonal live except in block
    rows 5 and 22 (whole dead rows, each half of a 128-row tile) and key
    block 13 seen by no query."""
    import numpy as np

    n = S // 64
    mask = np.tril(np.random.default_rng(7).random((n, n)) < 0.5)
    np.fill_diagonal(mask, True)
    mask[[5, 22]] = False
    mask[:, 13] = False
    return mask


def _sparse_case(S: int, spec):
    """(SparseSelfAttention or None, block mask, causal, block) of a case."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa_mod

    if spec is None:
        return None, dead_rows_mask(S), True, 64
    name, kw = spec
    cfg = getattr(sa_mod, name)(**kw)
    sa = sa_mod.SparseSelfAttention(cfg, max_seq_length=S)
    return sa, sa.layout(S), cfg.attention == "unidirectional", cfg.block


def _sdpa_ms(q, k, v, do, keep):
    """The library yardstick of the masked kernels:
    ``scaled_dot_product_attention`` with the layout expanded to a bool
    ``[S, S]`` attn_mask (forward, backward alone, forward + backward)."""
    gqa = q.shape[2] != k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                              enable_gqa=gqa)

    with torch.no_grad():
        fwd_ms = time_ms(fwd)
    out = fwd()
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                 retain_graph=True))
    del out
    both_ms = time_ms(lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dot))
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_bwd_ms": both_ms}


def phase_sparse_attention(gen: torch.Generator):
    """Block-sparse attention at SPARSE_CASES: per case, the main path
    (``SparseSelfAttention`` forward + backward on tensors that require
    grad, counts set to 0 just before and read just after: one K1, one K2
    and one K3 launch), then the masked K1/K2/K3 against their plain
    versions on the kernel's residuals, against the same kernels unmasked
    (time, and the dense layout's outputs), against SDPA with the mask, and
    the bound over the live pairs.  Returns {label: record}."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    records = {}
    for label, (B, S, Hq, Hkv, hd, dtype), spec in SPARSE_CASES:
        sa, mask, causal, block = _sparse_case(S, spec)
        shape = (B, S, Hq, Hkv, hd, dtype, causal)
        bm = fa._as_block_mask(mask, S)
        scale = 1.0 / math.sqrt(hd)
        q, k, v, do = _inputs(gen, shape, 4)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

        def masked_call(*x):
            if sa is not None:
                return sa(*x)
            return fa.flash_attention(*x, causal=causal, block_q=block, block_k=block,
                                      block_mask=mask)

        # the main path of this slice: counts to 0 just before, read just after
        reset_counts()
        out = masked_call(qg, kg, vg)
        out.backward(do)
        torch.cuda.synchronize()
        launches = kernel_counts()
        check(launches == (1, 1, 1), f"{label}: SparseSelfAttention forward + "
                                     f"backward launched K1/K2/K3 {launches} times")
        grads = (qg.grad, kg.grad, vg.grad)
        out = out.detach()
        del qg, kg, vg

        tables = fa.live_tile_tables(bm, S, causal, q.device)
        keep = fa.attended(S, causal, bm, q.device)
        pairs = int(keep.sum())
        # query rows with no live key, keys no live query sees
        dead_q, dead_k = ~keep.any(-1), ~keep.any(0)
        slices = _slices(shape)
        tol_f, tol_b = AGREE_TOL["fwd"][dtype], AGREE_TOL["bwd"][dtype]
        with torch.inference_mode():
            # the masked kernels on the main path's residuals: the forward's
            # internal entry gives lse
            out_k, lse = fa._forward(q, k, v, causal, scale, bm)
            delta = (do.float() * out_k.float()).sum(-1).transpose(1, 2).contiguous()
            args = (q, k, v, do, lse, delta, causal, scale, bm)
            dq = fa.flash_attention_bwd_dq(*args)
            dk, dv = fa.flash_attention_bwd_dkv(*args)
            torch.cuda.synchronize()
            same_as_autograd = all(torch.equal(a, b) for a, b in
                                   zip((out, *grads), (out_k, dq, dk, dv)))
            check(same_as_autograd, f"{label}: the autograd path and the direct "
                                    "kernel calls differ on the same inputs")
            parts = _parts(slices, q, k, v, do, lse, delta)
            p0 = parts[0]
            if slices is not None:
                out_k, dq, dk, dv, lse_k = (_cut(x, slices[0])
                                            for x in (out_k, dq, dk, dv, lse))
            else:
                lse_k = lse
            ref, ref_lse = fa.flash_attention_reference(*p0[:3], causal, scale, True, bm)
            agree = {"out": compare(out_k, ref, plain_low_precision(
                *p0[:3], causal, block_mask=bm), tol_f, dead=dead_q)}
            lse_err = (lse_k - ref_lse).abs().max().item()
            dead_lse = bool((lse_k[:, :, dead_q] == -1e30).all())
            del ref, ref_lse
            low = plain_low_precision(*p0[:3], causal, *p0[3:], block_mask=bm)
            agree["dq"] = compare(dq, fa.flash_attention_bwd_dq_reference(
                *p0, causal, scale, bm), low[0], tol_b, dead=dead_q)
            rk, rv = fa.flash_attention_bwd_dkv_reference(*p0, causal, scale, bm)
            agree["dk"] = compare(dk, rk, low[1], tol_b, dead=dead_k)
            agree["dv"] = compare(dv, rv, low[2], tol_b, dead=dead_k)
            del rk, rv, low, out_k, dq, dk, dv
            free_memory()

            # the same kernels unmasked at the same shape and causality
            out_u, lse_u = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
            delta_u = (do.float() * out_u.float()).sum(-1).transpose(1, 2).contiguous()
            args_u = (q, k, v, do, lse_u, delta_u, causal, scale)
            if label == "dense_equiv":
                # a dense layout runs the masked kernels over every causal
                # tile: the unmasked kernels' results, within the same limits
                dense = {}
                for name, got, want, tol in (
                        ("out", out, out_u, tol_f),
                        ("dq", grads[0], fa.flash_attention_bwd_dq(*args_u), tol_b),
                        *zip(("dk", "dv"), grads[1:],
                             fa.flash_attention_bwd_dkv(*args_u), (tol_b, tol_b))):
                    dense[name] = {**agreement(got, want, tol),
                                   "bit_equal": torch.equal(got, want)}
                check(all(r["ok"] for r in dense.values()),
                      f"dense_equiv: the masked kernels differ from the unmasked "
                      f"ones: {dense}")
            ms = {
                "K1": time_ms(lambda: masked_call(q, k, v)),
                "K2": time_ms(lambda: fa.flash_attention_bwd_dq(*args)),
                "K3": time_ms(lambda: fa.flash_attention_bwd_dkv(*args)),
            }
            unmasked_ms = {
                "K1": time_ms(lambda: fa.flash_attention(q, k, v, causal=causal)),
                "K2": time_ms(lambda: fa.flash_attention_bwd_dq(*args_u)),
                "K3": time_ms(lambda: fa.flash_attention_bwd_dkv(*args_u)),
            }
            reps, warm = (20, 3) if slices is None else (5, 1)
            plain_ms = {
                "K1": time_ms(lambda: [fa.flash_attention_reference(
                    *p[:3], causal, scale, False, bm) for p in parts], reps, warm),
                "K2": time_ms(lambda: [fa.flash_attention_bwd_dq_reference(
                    *p, causal, scale, bm) for p in parts], reps, warm),
                "K3": time_ms(lambda: [fa.flash_attention_bwd_dkv_reference(
                    *p, causal, scale, bm) for p in parts], reps, warm),
            }
            del parts, out_u, lse_u, delta_u, args_u
        free_memory()
        sdpa = _sdpa_ms(q, k, v, do, keep)
        library = {"K1": sdpa["fwd_ms"], "K2": sdpa["bwd_ms"], "K3": sdpa["bwd_ms"]}
        kernels = {}
        for name, kernel, outs in (("K1", "fwd", ("out",)), ("K2", "dq", ("dq",)),
                                   ("K3", "dkv", ("dk", "dv"))):
            bound, bound_by = attention_bound_ms(*shape, kernel=kernel, pairs=pairs)
            unmasked_bound, _ = attention_bound_ms(*shape, kernel=kernel)
            kernels[name] = {
                "launches": launches[("K1", "K2", "K3").index(name)],
                "max_abs_err": max(agree[o]["max_abs_err"] for o in outs),
                "ms": ms[name], "unmasked_ms": unmasked_ms[name],
                "ratio_to_unmasked": ms[name] / unmasked_ms[name],
                "plain_ms": plain_ms[name], "library_ms": library[name],
                "bound_ms": bound, "bound_by": bound_by,
                "bound_share": bound / ms[name],
                "unmasked_bound_ms": unmasked_bound}
        rec = {"phase": "sparse_attention", "case": label,
               "shape": _shape_dict(shape, slices), "block": block,
               "layout": spec[0] if spec else "raw block_mask (dead_rows_mask)",
               "layout_args": spec[1] if spec else None,
               "block_density": float(mask.mean()), "live_pairs": pairs,
               "live_share_of_unmasked_pairs": pairs / _pairs(S, causal),
               "tiles": {n: {"visited": int(t.idx.numel()),
                             "partly_live_share": t.partial_share()}
                         for n, t in tables.items() if not n.startswith("f32")},
               "launches": dict(zip(("K1", "K2", "K3"), launches)),
               "autograd_equals_direct_calls": same_as_autograd,
               "kernels": kernels, "agreement": agree, "tol": {"fwd": tol_f, "bwd": tol_b},
               "lse_max_abs_err": lse_err, "dead_rows_lse_neg_inf": dead_lse,
               "dead_query_rows": int(dead_q.sum()), "dead_key_rows": int(dead_k.sum()),
               "sdpa_with_mask": {**sdpa, "what": "scaled_dot_product_attention, "
                                  "bool [S, S] attn_mask of the attended pairs"}}
        if label == "dense_equiv":
            rec["equals_unmasked_kernels"] = dense
        emit(rec)
        for o, a in agree.items():
            check(a["ok"], f"{label}: masked {o} disagrees with its plain version: {a}")
            check(a["yardsticks_rejected"],
                  f"{label}: the {o} gate passed a yardstick: {a}")
        check(lse_err <= LSE_ATOL and dead_lse,
              f"{label}: lse err {lse_err}, dead rows NEG_INF {dead_lse}")
        if label == "dead_rows":
            check(rec["dead_query_rows"] >= 128 and rec["dead_key_rows"] >= 64,
                  f"dead_rows: the case has no dead rows to check: {rec}")
        if label == SPARSE_CASES[0][0]:
            check(all(r["ratio_to_unmasked"] <= SPARSE_MAX_TIME_RATIO
                      for r in kernels.values()),
                  f"{label}: a masked kernel takes more than {SPARSE_MAX_TIME_RATIO}"
                  f" of its unmasked time: {kernels}")
        records[label] = rec
        del q, k, v, do, grads, out, keep, dead_q, dead_k, args, lse, delta
        free_memory()
    return records


def phase_transformer_layer(seed: int):
    """``DeepSpeedTransformerLayer`` at BERT-large width, pre-LN and post-LN,
    in bf16 (``fp16=True`` selects bf16 activations, the parameters are cast
    to bf16): bidirectional, so its attention takes the plain branch and
    launches no kernel; the output is finite and close to the same layer in
    fp32 on the fp32 parameters."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention
    from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                      DeepSpeedTransformerLayer)

    shape = dict(LAYER_SHAPE)
    B, S = shape.pop("batch_size"), shape.pop("seq")
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    x = torch.randn((B, S, shape["hidden_size"]), generator=gen, device="cuda")
    for pre_ln in (True, False):
        layers = {fp16: DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(
            batch_size=B, fp16=fp16, pre_layer_norm=pre_ln, training=False, **shape))
            for fp16 in (True, False)}
        params = layers[False].init(torch.Generator(device="cuda").manual_seed(seed))
        low = {key: p.to(torch.bfloat16) for key, p in params.items()}
        before = flash_attention.launches
        with torch.inference_mode():
            out = layers[True].apply(low, x)
            ms = time_ms(lambda: layers[True].apply(low, x), reps=10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            layers[True].apply(low, x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            ref = layers[False].apply(params, x)
        torch.cuda.synchronize()
        k1 = flash_attention.launches - before
        rel = ((out.float() - ref).norm() / ref.norm()).item()
        rec = {"phase": "transformer_layer", "pre_layer_norm": pre_ln, "B": B, "S": S,
               **shape, "dtype": str(out.dtype).replace("torch.", ""), "ms": ms,
               "wall_ms": wall_ms,
               "tokens_per_s": B * S / ms * 1e3, "k1_launches": k1,
               "finite": bool(torch.isfinite(out).all()),
               "rel_l2_vs_fp32": rel, "rel_tol": LAYER_REL_TOL}
        emit(rec)
        check(tuple(out.shape) == tuple(x.shape) and rec["finite"],
              f"transformer layer output: {rec}")
        check(k1 == 0, f"the bidirectional layer launched K1 {k1} times")
        check(rel <= LAYER_REL_TOL, f"bf16 layer strays from fp32: {rec}")
        del layers, params, low, out, ref
    free_memory()


# (name, (B, S, Hq, Hkv, hd), sp): the ring's virtual ranks at llama-740m's
# attention (the training cell's S over sp=4: 4096 rows a rank), GQA and sp=2
RING_CASES = [("ring_740m", (1, 16384, 14, 14, 128), 4),
              ("ring_gqa", (1, 8192, 16, 2, 128), 4),
              ("ring_sp2", (1, 8192, 14, 14, 128), 2)]


class _PlainVersions:
    """Inside: the flash wrappers run K1-K3's plain versions on the card's
    tensors (the ring's plain version: the same schedule, each block as
    its plain version computes it), counting no launch."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

        self.saved = (fa._launch, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
        fa._launch = lambda q, k, v, causal, sm, bm=None: fa.flash_attention_reference(
            q, k, v, causal, sm, True, bm)
        fa.flash_attention_bwd_dq = fa.flash_attention_bwd_dq_reference
        fa.flash_attention_bwd_dkv = fa.flash_attention_bwd_dkv_reference
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

        fa._launch, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv = self.saved
        return False


def _ring_block(gen, B, Sl, H, hd, dtype) -> dict:
    """One ring block at the shard length ``Sl``: K1 non-causal with lse,
    and K2 and K3 fed ``delta - dlse``, against their plain versions (on
    the first PLAIN_HEADS heads from CHUNK_FROM_S rows on, timed over every
    slice, as phase ``kernel`` runs them), SDPA and the bound."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    shape = (B, Sl, H, H, hd, dtype, False)
    slices = _slices(shape)
    q, k, v, do = (torch.randn(B, Sl, H, hd, generator=gen, device="cuda", dtype=dtype)
                   for _ in range(4))
    dlse = torch.randn(B, H, Sl, generator=gen, device="cuda") * 0.1
    with torch.no_grad():
        out, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    delta = ((do.float() * out.float()).sum(-1).transpose(1, 2) - dlse).contiguous()
    args = (q, k, v, do, lse, delta, False)
    dq, (dk, dv) = fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dkv(*args)
    parts = _parts(slices, q, k, v, do, lse, delta)
    if slices is not None:
        out, lse, dq, dk, dv = (_cut(x, slices[0]) for x in (out, lse, dq, dk, dv))
    with torch.no_grad():
        ref, ref_lse = fa.flash_attention_reference(*parts[0][:3], causal=False,
                                                    return_lse=True)
    dq_ref = fa.flash_attention_bwd_dq_reference(*parts[0], False)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_reference(*parts[0], False)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    o_s = F.scaled_dot_product_attention(qt, kt, vt)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(o_s, (qt, kt, vt), do.transpose(1, 2),
                                                   retain_graph=True))
    del o_s, qt, kt, vt
    reps, warm = (20, 3) if slices is None else (5, 1)
    plain = {"K1": lambda p: fa.flash_attention_reference(*p[:3], causal=False,
                                                          return_lse=True),
             "K2": lambda p: fa.flash_attention_bwd_dq_reference(*p, False),
             "K3": lambda p: fa.flash_attention_bwd_dkv_reference(*p, False)}
    recs = {}
    for name, kind, got, want, fn, lib in (
            ("K1", "fwd", out, ref, lambda: fa.flash_attention(q, k, v, causal=False,
                                                               return_lse=True), sdpa_fwd),
            ("K2", "dq", dq, dq_ref, lambda: fa.flash_attention_bwd_dq(*args), sdpa_bwd),
            ("K3", "dkv", dk, dk_ref, lambda: fa.flash_attention_bwd_dkv(*args), sdpa_bwd)):
        bound, by = attention_bound_ms(B, Sl, H, H, hd, dtype, False, kernel=kind)
        tol = AGREE_TOL["fwd" if kind == "fwd" else "bwd"][dtype]
        agree = agreement(got, want, tol)
        if name == "K3":
            agree_v = agreement(dv, dv_ref, tol)
            agree["ok"] = agree["ok"] and agree_v["ok"]
            agree["max_abs_err"] = max(agree["max_abs_err"], agree_v["max_abs_err"])
        with torch.no_grad():
            plain_ms = time_ms(lambda: [plain[name](p) for p in parts], reps=reps,
                               warmup=warm)
        recs[name] = {"shape": _shape_dict(shape, slices), "causal": False,
                      "dlse": name != "K1", "ms": time_ms(fn), "plain_ms": plain_ms,
                      "library_ms": lib,
                      "library": "scaled_dot_product_attention " + (
                          "forward" if name == "K1" else "backward (dq, dk, dv together)"),
                      "bound_ms": bound, "bound_by": by, **agree}
        check(agree["ok"], f"ring block {name} differs from its plain version: "
                           f"{recs[name]}")
    lse_err = (lse - ref_lse).abs().max().item()
    recs["K1"]["lse_max_abs_err"] = lse_err
    check(lse_err <= LSE_ATOL, f"ring block lse differs by {lse_err}")
    return recs


def phase_ring_attention(gen: torch.Generator) -> dict:
    """Ring attention (``ops/ring_attention.py``) as ``sp`` virtual ranks
    in one process at each RING_CASES entry, bf16: forward, then the
    backward of the sum of squares linearised at the one-device kernels'
    output (one dO = 2·out for every path, so each is held as a kernel is);
    counts K1/K2/K3 launches (sp causal + sp(sp-1)/2 non-causal each, the
    future blocks skipped; 4 + 12 without skipping at sp=4).  The ring's
    output is held within the ``kernel`` phase's bf16 tolerance of the
    ring's plain version (the same schedule through K1-K3's plain
    versions, on the first heads); its output and gradients against K1-K3
    causal over the whole sequence within twice those tolerances plus how
    far the two plain versions lie apart; its time against those
    kernels'.  Then one block, the kernels' new launch pattern, at the
    main case's shard length and at ``sp4_740m``'s (SP_S / 4 rows), each
    kernel held against its plain version on the same residuals."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention
    from deepspeed_tpu_torch.ops.ring_attention import ring_attention_virtual

    dtype = torch.bfloat16
    out = {}
    for name, (B, S, Hq, Hkv, hd), sp in RING_CASES:
        q, k, v = (torch.randn(B, S, h, hd, generator=gen, device="cuda", dtype=dtype)
                   for h in (Hq, Hkv, Hkv))

        def ring(q, k, v):
            return torch.cat(ring_attention_virtual(
                list(q.chunk(sp, 1)), list(k.chunk(sp, 1)), list(v.chunk(sp, 1)),
                causal=True), 1)

        def one(q, k, v):
            return flash_attention(q, k, v, causal=True)

        def run(fn, do):
            qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
            o = fn(qq, kk, vv)
            o.backward(do)
            return o.detach(), qq.grad, kk.grad, vv.grad

        with torch.no_grad():
            do = one(q, k, v) * 2
        reset_counts()
        got = run(ring, do)
        launches = kernel_counts()
        want = sp + sp * (sp - 1) // 2
        base = run(one, do)
        # the plain versions on the first heads (whole GQA groups): the
        # ring's schedule, and causal attention over the whole sequence
        G = Hq // Hkv
        hq = G * max(1, -(-PLAIN_HEADS // G))
        full = (q, k, v, do)
        q, k, v, do_h = q[:, :, :hq], k[:, :, :hq // G], v[:, :, :hq // G], do[:, :, :hq]
        with _PlainVersions():
            plain = run(ring, do_h)
            plain_one = run(one, do_h)
        q, k, v, do = full
        rec = {"phase": "ring_attention", "case": name, "shape": [B, S, Hq, Hkv, hd],
               "sp": sp, "rows_per_rank": S // sp, "dtype": "bf16",
               "launches": dict(zip(("K1", "K2", "K3"), launches)),
               "launches_predicted": {"K1": want, "K2": want, "K3": want},
               "launches_without_skipping": sp * sp,
               "plain_heads": hq}
        check(launches == (want,) * 3, f"{name}: the ring launched K1/K2/K3 {launches} "
                                       f"times, expected {want} each")
        ok = True
        for i, (part, kind) in enumerate((("out", "fwd"), ("dq", "bwd"), ("dk", "bwd"),
                                          ("dv", "bwd"))):
            tol = AGREE_TOL[kind][dtype]
            h = hq if part in ("out", "dq") else hq // G
            vs_plain = agreement(got[i][:, :, :h], plain[i], tol)
            # the ring and the one-device attention differ, in their plain
            # versions, by this much; each kernel path lies within ``tol``
            # of its plain version
            apart = agreement(plain[i], plain_one[i], tol)
            limit = {**tol, "tile_rel": 2 * tol["tile_rel"] + apart["worst_tile_rel_l2"],
                     "elem_atol_rms": 2 * tol["elem_atol_rms"]
                     + apart["elem_atol_rms_needed"]}
            vs_kernels = agreement(got[i], base[i], limit)
            rec[part] = {"vs_plain": vs_plain, "vs_one_device_kernels": vs_kernels,
                         "plain_ring_vs_plain_one_device": apart,
                         "one_device_vs_its_plain_worst_tile": agreement(
                             base[i][:, :, :h], plain_one[i], tol)["worst_tile_rel_l2"]}
            # gradients: the plain ring's backward reads its own forward's
            # out (delta = rowsum(dO o) cancels in the first rows), so only
            # the output is held to it; each block's K2/K3 are held on the
            # kernel's residuals in _ring_block, as phase kernel holds them
            ok = ok and vs_kernels["ok"] and (vs_plain["ok"] or part != "out")
        rec["max_abs_err"] = max(rec[p]["vs_plain"]["max_abs_err"]
                                 for p in ("out", "dq", "dk", "dv"))
        rec["ring_ms"] = time_ms(lambda: run(ring, do), reps=5, warmup=1)
        rec["one_device_ms"] = time_ms(lambda: run(one, do), reps=5, warmup=1)
        rec["ring_over_one_device"] = rec["ring_ms"] / rec["one_device_ms"]
        emit(rec)
        check(ok, f"{name}: the ring differs from the plain version or the kernels")
        out[name] = rec
        del q, k, v, got, base, plain
        free_memory()
    B, S, Hq, _, hd = RING_CASES[0][1]
    for key, rows in (("block", S // RING_CASES[0][2]), ("block_sp4_740m", SP_S // 4)):
        blocks = _ring_block(gen, B, rows, Hq, hd, dtype)
        emit({"phase": "ring_block", "rows": rows, **blocks})
        out[key] = blocks
        free_memory()
    return out


def kernel_counts() -> tuple:
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    return (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches)


def reset_counts() -> None:
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels.decode_attention import decode_attention

    for fn in (fa.flash_attention, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, decode_attention):
        fn.launches = 0


def _train_engine(seed, S, attn_impl="auto", fp32=False, params=None,
                  config_extra=None, mesh=None, name=TRAIN_MODEL, **model_kw):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    config = {**TRAIN_CONFIG, "seed": seed, **(config_extra or {})}
    if fp32:
        config["bf16"] = {"enabled": False}
        config["data_types"] = {"grad_accum_dtype": "fp32"}
    model = CausalLM(name, max_seq_len=S, attn_impl=attn_impl,
                     dtype=torch.float32 if fp32 else torch.bfloat16, **model_kw)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                params=params, mesh=mesh)
    return model, engine


def phase_train(seed: int, profile: bool, kernel_ms: dict):
    """The main path: ``initialize`` -> ``train_batch`` at bench.py's
    defaults.  Returns the launches of the timed run."""
    S = TRAIN_SHAPE[1]
    t0 = time.perf_counter()
    model, engine = _train_engine(seed, S)
    cfg = model.config
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                                        device="cuda")}
    L = cfg.num_layers
    per_step = (2 * L, L, L)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, norms = [], [], []
    # the main path: counts to 0 just before, read just after
    reset_counts()
    for _ in range(WARM_STEPS + TIMED_STEPS):
        before = kernel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(engine.train_batch(batch=batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
        norms.append(engine.get_global_grad_norm())
        got = tuple(a - b for a, b in zip(kernel_counts(), before))
        check(got == per_step, f"a train step launched K1/K2/K3 {got} times, "
                               f"expected {per_step}")
    launches = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = step_s[WARM_STEPS:]
    med = statistics.median(timed)
    flops_per_token = 6.0 * model.param_count + 12.0 * L * cfg.hidden_size * S
    tflops = S / med * flops_per_token / 1e12
    attn_ms = L * (2 * kernel_ms["fwd"] + kernel_ms["dq"] + kernel_ms["dkv"])
    rec = {"phase": "train", "model": TRAIN_MODEL, "params": model.param_count,
           "layers": L, "S": S, "micro_batch": 1, "gas": 1,
           "config": TRAIN_CONFIG, "remat_policy": cfg.remat_policy,
           "init_s": init_s, "step_s": step_s, "warm_steps": WARM_STEPS,
           "median_step_s": med, "tokens_per_s": S / med,
           "model_flops_per_token": flops_per_token, "model_tflops": tflops,
           "mfu": tflops * 1e12 / PEAK_FLOPS[torch.bfloat16],
           "peak_memory_gb": peak_gb,
           "losses": losses, "grad_norm": engine.get_global_grad_norm(),
           "launches": dict(zip(("K1", "K2", "K3"), launches)),
           "launches_per_step": dict(zip(("K1", "K2", "K3"), per_step)),
           "attention_kernels_ms_per_step_from_kernel_phase": attn_ms,
           "attention_share_of_step": attn_ms / 1e3 / med}
    emit(rec)
    check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall on a repeated batch: {losses}")
    if profile:
        profile_step("train_step", lambda: engine.train_batch(batch=batch))
    del engine, model, batch
    free_memory()
    return launches, {"loss": losses[0], "grad_norm": norms[0], "peak_gb": peak_gb,
                      "median_step_s": med}


def _train_batch(cfg, S, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"input_ids": torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                                       device="cuda")}


def saved_bytes_per_layer(cfg, S: int, policy: str) -> int:
    """What a policy keeps beyond ``nothing_saveable``, a layer at micro
    batch 1 and bf16: JAX's names (q, k, v post-rope; attn_out; the fp32
    lse; mlp_gate, mlp_up), or every matmul output for ``dots_saveable``."""
    q, kv = cfg.num_heads * cfg.dims_per_head, cfg.kv_heads * cfg.dims_per_head
    d, f = cfg.hidden_size, cfg.intermediate_size
    lse = 4 * cfg.num_heads * S
    return {"save_attn": 2 * S * q,
            "save_qkv": 2 * S * (2 * q + 2 * kv) + lse,
            "save_matmuls": 2 * S * (2 * q + 2 * kv + 2 * f) + lse,
            "dots_saveable": 2 * S * (q + 2 * kv + d + 2 * f + d)}[policy]


def phase_train_remat(seed: int, base: dict):
    """llama-740m at S=16384 under each remat policy: launches per step,
    step time, MFU, peak memory and what the forward's graph holds (read
    between ``forward`` and ``backward`` of the first step, which runs
    through the reference loop); the first step's loss and gradient norm
    against phase ``train``'s (same weights, same batch, ``train_batch``)."""
    S = TRAIN_SHAPE[1]
    out = {}
    for policy, k1 in REMAT_POLICY_K1.items():
        t_phase = time.perf_counter()
        model, engine = _train_engine(seed, S, remat_policy=policy)
        cfg = model.config
        L = cfg.num_layers
        batch = _train_batch(cfg, S, seed + 1)
        per_step = (k1 * L, L, L)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, step_s = [], [], []
        reset_counts()
        for step in range(1 + REMAT_TIMED_STEPS):
            before = kernel_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if step == 0:
                m0 = torch.cuda.memory_allocated()
                engine.forward(batch)
                held = torch.cuda.memory_allocated() - m0
                engine.backward()
                losses.append(float(engine.step()["loss"]))
            else:
                losses.append(float(engine.train_batch(batch=batch)))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            norms.append(engine.get_global_grad_norm())
            got = tuple(a - b for a, b in zip(kernel_counts(), before))
            check(got == per_step, f"{policy}: a step launched K1/K2/K3 {got} "
                                   f"times, expected {per_step}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        med = statistics.median(step_s[1:])
        flops_per_token = 6.0 * model.param_count + 12.0 * L * cfg.hidden_size * S
        loss_diff = abs(losses[0] - base["loss"]) / abs(base["loss"])
        norm_diff = abs(norms[0] - base["grad_norm"]) / abs(base["grad_norm"])
        bit_equal = losses[0] == base["loss"] and norms[0] == base["grad_norm"]
        rec = {"phase": "train_remat", "policy": policy, "model": TRAIN_MODEL,
               "S": S, "launches_per_step": dict(zip(("K1", "K2", "K3"), per_step)),
               "step_s": step_s, "median_step_s": med, "tokens_per_s": S / med,
               "mfu": S / med * flops_per_token / PEAK_FLOPS[torch.bfloat16],
               "peak_memory_gb": peak_gb,
               "held_after_forward_gb": held / 1e9,
               "first_loss": losses[0], "first_grad_norm": norms[0],
               "bit_equal_to_train_phase": bit_equal,
               "loss_rel_diff": loss_diff, "grad_norm_rel_diff": norm_diff,
               "losses": losses, "seconds": time.perf_counter() - t_phase}
        if policy != "nothing_saveable":
            ref = out["nothing_saveable"]
            rec["extra_peak_gb"] = peak_gb - ref["peak_memory_gb"]
            rec["extra_held_gb"] = rec["held_after_forward_gb"] - ref["held_after_forward_gb"]
            rec["kept_gb"] = L * saved_bytes_per_layer(cfg, S, policy) / 1e9
        emit(rec)
        check(bit_equal or (loss_diff <= PARITY_LOSS_RTOL
                            and norm_diff <= PARITY_GRAD_NORM_RTOL),
              f"{policy}: first step strays from nothing_saveable: {rec}")
        check(all(math.isfinite(x) for x in losses), f"{policy}: non-finite loss")
        if "kept_gb" in rec:
            check(abs(rec["extra_held_gb"] - rec["kept_gb"])
                  <= REMAT_HELD_RTOL * rec["kept_gb"] + REMAT_HELD_ATOL_GB,
                  f"{policy} holds other tensors than the ones it keeps: {rec}")
        out[policy] = rec
        del engine, model, batch
        free_memory()
    return out


def phase_train_loop(seed: int):
    """Two steps of gas 2 through ``forward``/``backward``/``step`` and
    through ``train_batch`` from the same initial state (the same seed):
    losses and every parameter bit for bit."""
    t0 = time.perf_counter()
    S, gas = PARITY_S, 2
    extra = {"gradient_accumulation_steps": gas}
    batches = None
    results = []
    for loop in (False, True):
        model, engine = _train_engine(seed, S, config_extra=extra)
        if batches is None:
            batches = [_train_batch(model.config, S, seed + 10 + i)
                       for i in range(2 * gas)]
        losses = []
        for step in range(2):
            micro = batches[step * gas:(step + 1) * gas]
            if loop:
                for mb in micro:
                    engine.backward(engine.forward(mb))
                    check(engine.is_gradient_accumulation_boundary()
                          == (mb is micro[-1]), "boundary flag out of step")
                losses.append(float(engine.step()["loss"]))
            else:
                losses.append(float(engine.train_batch(
                    batch={"input_ids": torch.cat([m["input_ids"] for m in micro])})))
        results.append((losses, [t.clone() for t in
                                 _leaves(engine.get_params(fp32=True))]))
        del engine, model
        free_memory()
    (la, pa), (lb, pb) = results
    same = la == lb and all(torch.equal(x, y) for x, y in zip(pa, pb))
    rec = {"phase": "train_loop", "model": TRAIN_MODEL, "S": S, "gas": gas,
           "train_batch_losses": la, "loop_losses": lb, "bit_equal": same,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    check(same, f"forward/backward/step differs from train_batch: {rec}")
    del pa, pb
    free_memory()


# train_zero: ZeRO stages over NCCL at the card count's world size (one
# process per card): steps per stage, the stage-3 peak's allowance over the
# one-device engine's, the time limits of its child processes
ZERO_STEPS = 3
ZERO_PEAK_EXCESS_GB = 0.5
TRAIN_ZERO_TIMEOUT_S = 600
SHARED_CARD_TIMEOUT_S = 90


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _zero_steps(engine, batch, per_step, by_axis=False):
    """ZERO_STEPS of ``train_batch``: losses, step seconds and, per step,
    the comms logger's calls and bytes by kind (``by_axis``: by kind and
    mesh axes) (K1-K3 launches checked)."""
    from deepspeed_tpu_torch import comm

    log = comm.get_comms_logger()
    losses, step_s, comms = [], [], []
    for _ in range(ZERO_STEPS):
        if log is not None:
            log.reset()
        before = kernel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        got = tuple(a - b for a, b in zip(kernel_counts(), before))
        check(got == per_step, f"a ZeRO step launched K1/K2/K3 {got} times, "
                               f"expected {per_step}")
        comms.append({} if log is None else
                     log.totals_by_axis() if by_axis else log.totals())
    return losses, step_s, comms


def run_train_zero(seed: int, world: int, rank: int, ref=None) -> None:
    """Stages 0-3 of llama-740m at S=16384 (the ``train`` cell) on this
    rank of a ``world``-rank NCCL job; ``ref`` is the one-device engine's
    run (world 1), which every stage must equal bit for bit."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import get_config

    S = TRAIN_SHAPE[1]
    cfg = get_config(TRAIN_MODEL)
    L = cfg.num_layers
    per_step = (2 * L, L, L)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (world, S), generator=gen,
                                        device="cuda")}
    comm.configure({"enabled": True})
    flops_per_token = 6.0 * cfg.param_count + 12.0 * L * cfg.hidden_size * S
    param_gb = 2 * cfg.param_count / 1e9
    layer_gb = 2 * (cfg.param_count - 2 * cfg.vocab_size * cfg.hidden_size
                    - cfg.hidden_size) / L / 1e9
    cases = [{"stage": stage} for stage in range(4)]
    if world >= 4 and world % 2 == 0:   # MiCS: shards within halves of the world
        cases.append({"stage": 3, "mics_shard_size": world // 2})
    first_losses = []
    stage0_losses = None
    for zero in cases:
        stage = zero["stage"]
        model, engine = _train_engine(seed, S, config_extra={"zero_optimization": zero})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_s, comms = _zero_steps(engine, batch, per_step)
        launches = kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        held_gb = torch.cuda.memory_allocated() / 1e9
        med = statistics.median(step_s[1:])
        tflops = world * S / med * flops_per_token / 1e12
        first_losses.append(losses[0])
        if stage == 0 and stage0_losses is None:
            stage0_losses = losses
        rec = {"phase": "train_zero", "stage": stage, "world_size": world,
               "mics_shard_size": zero.get("mics_shard_size", -1),
               "backend": torch.distributed.get_backend(), "model": TRAIN_MODEL,
               "S": S, "rows_per_rank": 1, "remat_policy": cfg.remat_policy,
               "step_s": step_s, "median_step_s": med,
               "tokens_per_s": world * S / med, "model_tflops": tflops,
               "mfu": tflops * 1e12 / world / PEAK_FLOPS[torch.bfloat16],
               "peak_memory_gb": peak_gb, "held_memory_gb": held_gb,
               "losses": losses, "collectives_per_step": comms[-1],
               "launches": dict(zip(("K1", "K2", "K3"), launches)),
               "launches_per_step": dict(zip(("K1", "K2", "K3"), per_step)),
               "dims_sharded": sum(d is not None for d in engine.partition.mdims),
               "leaves": len(engine.partition.mdims)}
        if stage == 3:
            rec["reckoning"] = {
                "forward_gather_gb": param_gb, "recompute_gather_gb": L * layer_gb,
                "layer_gb": layer_gb,
                "grad_reduce_scatter_dtype": str(engine.accum_dtype)}
        if ref is not None:   # (no name outlives the engine: the next peak)
            same = losses == ref["losses"] and all(
                torch.equal(m.cpu(), r) for m, r in
                zip(_leaves(engine.state.master_params), ref["masters"]))
            rec.update(one_device={"losses": ref["losses"],
                                   "median_step_s": ref["median_step_s"],
                                   "peak_memory_gb": ref["peak_gb"]},
                       bit_equal=same, step_overhead=med / ref["median_step_s"] - 1,
                       peak_excess_gb=peak_gb - ref["peak_gb"])
        if rank == 0:
            emit(rec)
        check(all(math.isfinite(x) for x in losses), f"non-finite loss: {rec}")
        # the same weights and rows: every stage's first forward is the same
        check(losses[0] == first_losses[0],
              f"stage {stage}'s first loss {losses[0]} != stage 0's {first_losses[0]}")
        if ref is not None:
            check(rec["bit_equal"], f"stage {stage} at world 1 differs from the "
                                    f"one-device engine: {rec}")
            if stage == 3:
                check(rec["peak_excess_gb"] <= ZERO_PEAK_EXCESS_GB,
                      f"stage 3's peak exceeds the one-device engine's by "
                      f"{rec['peak_excess_gb']:.3f} GB")
        del engine, model
        free_memory()
    if world > 1:
        from deepspeed_tpu_torch.comm.benchmark import run_sweep

        rows = run_sweep(["all_gather", "reduce_scatter", "all_reduce"], 20, 29,
                         trials=10, print_table=False)
        if rank == 0:
            emit({"phase": "comm_bench", "world_size": world, "rows": rows})
        return stage0_losses
    elif rank == 0:
        emit({"phase": "comm_bench", "world_size": 1,
              "skipped": "one rank: a collective is a copy, so no bandwidth to "
                         "measure (comm/benchmark.py runs under torchrun on N cards)"})
    return stage0_losses


def _one_device_reference(seed: int) -> dict:
    """The ``train`` cell's engine without a process group, ZERO_STEPS steps:
    the reference every world-1 stage must equal."""
    S = TRAIN_SHAPE[1]
    model, engine = _train_engine(seed, S)
    cfg = model.config
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                                        device="cuda")}
    L = cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, _ = _zero_steps(engine, batch, (2 * L, L, L))
    ref = {"losses": losses, "median_step_s": statistics.median(step_s[1:]),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "masters": [m.detach().cpu() for m in _leaves(engine.state.master_params)]}
    del engine, model, batch
    free_memory()
    return ref


def probe_shared_card() -> dict:
    """Two ranks on the one card, NCCL and gloo (CUDA tensors), each pair
    in its own child processes killed after SHARED_CARD_TIMEOUT_S: does an
    all-reduce and a reduce-scatter go through?  Recorded, not worked
    around."""
    import subprocess as sp

    procs = {}
    for backend in ("nccl", "gloo"):
        port = _free_port()
        procs[backend] = [sp.Popen(
            [sys.executable, os.path.abspath(__file__), "--probe-shared-card",
             backend, str(port), str(r)], stdout=sp.PIPE, stderr=sp.STDOUT, text=True)
            for r in (0, 1)]
    deadline = time.monotonic() + SHARED_CARD_TIMEOUT_S
    out = {}
    for backend, pair in procs.items():
        ranks = []
        for p in pair:
            try:
                text, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
                rc = p.returncode
            except sp.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
                rc = "timeout"
            lines = [ln for ln in text.splitlines() if ln.strip()]
            ranks.append({"rc": rc, "tail": lines[-3:]})
        out[backend] = {"ok": all(r["rc"] == 0 for r in ranks), "ranks": ranks}
    rec = {"phase": "shared_card_probe", **out}
    emit(rec)
    return rec


def shared_card_child(backend: str, port: int, rank: int) -> int:
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=SHARED_CARD_TIMEOUT_S // 2))
    x = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(x)
    out = torch.empty(2, device="cuda")
    dist.reduce_scatter_tensor(out, x)
    torch.cuda.synchronize()
    print(json.dumps({"rank": rank, "all_reduce": x.tolist(),
                      "reduce_scatter": out.tolist()}), flush=True)
    dist.destroy_process_group()
    return 0


def phase_train_zero(seed: int) -> None:
    """ZeRO stages 0-3 over NCCL at world size = the card count: in this
    process at one card (after the one-device reference run, which each
    stage must equal bit for bit), one child process per card otherwise;
    then the shared-card probe."""
    t0 = time.perf_counter()
    probe_shared_card()
    world = torch.cuda.device_count()
    if world == 1:
        from deepspeed_tpu_torch import comm

        ref = _one_device_reference(seed)
        comm.init_distributed(init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                              world_size=1, verbose=False)
        try:
            run_train_zero(seed, 1, 0, ref=ref)
            t1 = time.perf_counter()
            run_train_tp(seed, 1, 0, ref=ref)
            emit({"phase": "train_tp_done", "seconds": time.perf_counter() - t1})
            t1 = time.perf_counter()
            run_train_sp(seed, ref)
            emit({"phase": "train_sp_done", "seconds": time.perf_counter() - t1})
        finally:
            comm.destroy_process_group()
    else:
        import subprocess as sp

        env = {**os.environ, "WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(_free_port())}
        procs = [sp.Popen([sys.executable, os.path.abspath(__file__), "--seed",
                           str(seed), "--train-zero-rank"],
                          env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
                 for r in range(world)]
        deadline = time.monotonic() + TRAIN_ZERO_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(all(p.returncode == 0 for p in procs),
              f"train_zero ranks exited {[p.returncode for p in procs]}")
    emit({"phase": "train_zero_done", "seconds": time.perf_counter() - t0})


def train_zero_rank(seed: int) -> int:
    """One rank of phase ``train_zero`` (``--train-zero-rank``, started by
    the parent with RANK/WORLD_SIZE/LOCAL_RANK/MASTER_ADDR/MASTER_PORT)."""
    from deepspeed_tpu_torch import comm

    torch.backends.cuda.matmul.allow_tf32 = False
    comm.init_distributed(verbose=False)
    try:
        world, rank = comm.get_world_size(), comm.get_rank()
        dp_losses = run_train_zero(seed, world, rank)
        run_train_tp(seed, world, rank, dp_losses=dp_losses)
    finally:
        comm.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# Tensor parallelism: train_tp, serve_tp and the multi-card configurations
# ---------------------------------------------------------------------------

TP_STAGES = (0, 3)
# the one-device engine's loss beside the tensor-parallel path's at a model
# axis of 1: the vocab-parallel loss takes ATen logsumexp's steps in its
# order, so they are expected bit-equal; this bound says how far they may
# differ if a build rounds the max/sum-exp form differently
TP_LOSS_RTOL = 1e-6
# tp x dp beside dp = world (the same weights and global batch), each of
# the steps: bf16 partial sums put them 2.9e-4 apart at step 3 on 4 H100s;
# a planted fault (the all-reduce of a row-parallel forward or of a
# column-parallel input's gradient skipped) moved them 4.6e-3 at step 1
# and 0.11-0.18 by step 2 (llama-740m's widths at 2 layers, fp32, 4 gloo
# ranks on the CPU).  sp4_740m and uly_7b against one card: planted
# sequence-parallel faults (a past ring block dropped, the last cotangent
# rotation skipped, gradients not summed over 'seq') moved the losses
# 5.1e-2, 1.1e-2 and 0.31 at step 2 (tests/sp_gate_rehearsal.py, the same
# widths and ranks, S=512; PERF.md)
TP_DP_LOSS_RTOL = 2e-3
SERVE_TP_TIMEOUT_S = 900


def _tp_degree(world: int, cfg) -> int:
    """The largest divisor of ``world`` that shards ``cfg`` evenly, with no
    padded heads, vocabulary or FFN columns (the model axis of a phase run
    one process per card; ``tp4_740m`` runs the padded one)."""
    for n in range(world, 0, -1):
        if world % n == 0 and all(x % n == 0 for x in (
                cfg.num_heads, cfg.kv_heads, cfg.vocab_size, cfg.intermediate_size)):
            return n
    return 1


def run_train_tp(seed: int, world: int, rank: int, ref=None, dp_losses=None) -> None:
    """Phase ``train_tp``: the train cell (llama-740m, S=16384,
    ``nothing_saveable``, bf16 over fp32 masters) under tensor parallelism
    over NCCL at stages 0 and 3: ``initialize(mesh=MeshLayout(tp=n,
    dp=world/n))``, each replica ``n`` rows (the train_zero global batch).
    At one card the model axis is 1 (every model-axis collective a copy)
    and ``ref`` is the one-device engine's run, which both stages must
    equal bit for bit; with more cards the loss trajectory is held to
    train_zero's stage 0 at dp=world (``dp_losses``) within
    TP_DP_LOSS_RTOL."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import get_config
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout

    S = TRAIN_SHAPE[1]
    cfg = get_config(TRAIN_MODEL)
    L = cfg.num_layers
    tp = _tp_degree(world, cfg)
    dp = world // tp
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (world, S), generator=gen,
                                        device="cuda")}
    comm.configure({"enabled": True})
    flops_per_token = 6.0 * cfg.param_count + 12.0 * L * cfg.hidden_size * S
    per_step = (2 * L, L, L)
    for stage in TP_STAGES:
        # no params=: every rank draws the default init's leaves and keeps
        # its shards, the data-parallel run's weights at any model axis
        model, engine = _train_engine(
            seed, S, mesh=MeshLayout(tp=tp, dp=dp),
            config_extra={"zero_optimization": {"stage": stage},
                          "train_micro_batch_size_per_gpu": world // dp})
        check(engine.tp == tp, f"the engine runs tp={engine.tp}, expected {tp}")
        if tp == 1 and stage == TP_STAGES[0]:   # the seed names the default init
            init = _leaves(_default_init(seed, S))
            seed_equal = all(torch.equal(m, w) for m, w in zip(
                _leaves(engine.state.master_params), init))
            del init
            emit({"phase": "train_tp_seed", "tp": tp,
                  "masters_equal_default_init": seed_equal})
            check(seed_equal, "train_tp without params=: the masters are not the "
                              "default init's")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_s, comms = _zero_steps(engine, batch, per_step, by_axis=True)
        launches = kernel_counts()
        med = statistics.median(step_s[1:])
        tflops = world * S / med * flops_per_token / 1e12
        model_axis = {op: by["model"] for op, by in comms[-1].items() if "model" in by}
        rec = {"phase": "train_tp", "stage": stage, "world_size": world, "tp": tp,
               "dp": dp, "backend": torch.distributed.get_backend(),
               "model": TRAIN_MODEL, "S": S, "rows_per_replica": world // dp,
               "remat_policy": cfg.remat_policy, "step_s": step_s,
               "median_step_s": med, "tokens_per_s": world * S / med,
               "model_tflops": tflops,
               "mfu": tflops * 1e12 / world / PEAK_FLOPS[torch.bfloat16],
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "held_memory_gb": torch.cuda.memory_allocated() / 1e9,
               "losses": losses, "collectives_per_step_by_axis": comms[-1],
               "model_axis_collectives_per_step": model_axis,
               "launches": dict(zip(("K1", "K2", "K3"), launches)),
               "launches_per_step": dict(zip(("K1", "K2", "K3"), per_step)),
               "nvidia_smi": nvidia_smi_line()}
        check(all(math.isfinite(x) for x in losses), f"non-finite loss: {rec}")
        check(model_axis.get("all_reduce", {}).get("calls", 0) > 0,
              f"no model-axis all-reduce in a step: {rec}")
        if ref is not None:
            same_masters = all(torch.equal(m.cpu(), r) for m, r in
                               zip(_leaves(engine.state.master_params), ref["masters"]))
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
            rec.update(one_device={"losses": ref["losses"],
                                   "median_step_s": ref["median_step_s"],
                                   "peak_memory_gb": ref["peak_gb"]},
                       masters_bit_equal=same_masters,
                       losses_bit_equal=losses == ref["losses"],
                       loss_max_rel_diff=loss_rel,
                       step_overhead=med / ref["median_step_s"] - 1,
                       peak_excess_gb=rec["peak_memory_gb"] - ref["peak_gb"])
        if dp_losses is not None:
            rec["dp_world_stage0_losses"] = dp_losses
            rec["loss_max_rel_diff_vs_dp"] = max(
                abs(a - b) / abs(b) for a, b in zip(losses, dp_losses))
        if rank == 0:
            emit(rec)
        if dp_losses is not None:
            check(rec["loss_max_rel_diff_vs_dp"] <= TP_DP_LOSS_RTOL,
                  f"train_tp stage {stage}: tp={tp} x dp={dp} losses differ from "
                  f"dp={world}'s beyond {TP_DP_LOSS_RTOL}: {rec}")
        if ref is not None:
            check(rec["masters_bit_equal"], f"train_tp stage {stage} at a model axis "
                                            f"of 1: masters differ from the one-device "
                                            f"engine's: {rec}")
            check(rec["loss_max_rel_diff"] <= TP_LOSS_RTOL,
                  f"train_tp stage {stage}: losses differ from the one-device "
                  f"engine's beyond {TP_LOSS_RTOL}: {rec}")
        del engine, model
        free_memory()


def run_train_sp(seed: int, ref: dict) -> None:
    """Phase ``train_sp`` at one card: the train cell through
    ``initialize(mesh=MeshLayout(sp=1))`` at NCCL world 1 (the 'seq' axis
    named, of size 1): losses and masters bit-equal to the one-device
    engine's ``ref``, K1-K3 launched as there, the step's overhead."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import get_config
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout

    S = TRAIN_SHAPE[1]
    cfg = get_config(TRAIN_MODEL)
    L = cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                                        device="cuda")}
    comm.configure({"enabled": True})
    model, engine = _train_engine(seed, S, mesh=MeshLayout(sp=1),
                                  config_extra={"zero_optimization": {"stage": 0}})
    check(engine.sp == 1, f"the engine runs sp={engine.sp}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_s, comms = _zero_steps(engine, batch, (2 * L, L, L), by_axis=True)
    med = statistics.median(step_s[1:])
    same = losses == ref["losses"] and all(
        torch.equal(m.cpu(), r) for m, r in zip(_leaves(engine.state.master_params),
                                                ref["masters"]))
    rec = {"phase": "train_sp", "sp": 1, "world_size": 1, "model": TRAIN_MODEL, "S": S,
           "remat_policy": cfg.remat_policy, "losses": losses, "step_s": step_s,
           "median_step_s": med, "one_device_median_step_s": ref["median_step_s"],
           "step_overhead": med / ref["median_step_s"] - 1,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_excess_gb": torch.cuda.max_memory_allocated() / 1e9 - ref["peak_gb"],
           "collectives_per_step_by_axis": comms[-1], "bit_equal": same,
           "launches": dict(zip(("K1", "K2", "K3"), kernel_counts())),
           "nvidia_smi": nvidia_smi_line()}
    emit(rec)
    check(same, f"train_sp at sp=1 differs from the one-device engine: {rec}")
    del engine, model
    free_memory()


def _default_init(seed: int, S: int):
    """The train cell's default init (what the engine draws from its seed
    at a model axis of 1), whole, in fp32 on this rank's card."""
    from deepspeed_tpu_torch.models import CausalLM

    return CausalLM(TRAIN_MODEL, max_seq_len=S).init_fn(
        torch.Generator(device="cuda").manual_seed(seed), device="cuda")


def _serve_tp_record(sv, rec, tp: int) -> dict:
    h = sv.health()
    rec.update(phase="serve_tp", tp=tp, mesh_devices=h["mesh_devices"],
               mesh_axes=h["mesh_axes"],
               kv_pool_bytes_per_device=h["kv_pool_bytes_per_device"],
               kv_pool_bytes_total=h["kv_pool_bytes_total"],
               graph_collectives_per_tick=sv._exec.graph_collectives,
               nvidia_smi=nvidia_smi_line())
    check(h["kv_pool_bytes_per_device"] * tp == h["kv_pool_bytes_total"],
          f"per-device pool bytes x tp != total: {h}")
    cfg = sv.model.config
    got = sv._exec.graph_collectives.get("all_reduce", {}).get("model", 0)
    check(got == 2 * cfg.num_layers + 1,
          f"the decode graph holds {got} model-axis all-reduces, expected two per "
          f"layer and the embedding's ({2 * cfg.num_layers + 1})")
    return rec


def phase_serve_tp(engine, params, seed: int, stream, first) -> None:
    """Phase ``serve_tp``: llama2-7b through ``initialize_serving_mesh(tp)``
    -> ``init_inference(mesh=)`` -> the paged ``ServingEngine`` on the
    serving stream.  At one card: a model axis of 1 in this process (every
    collective a copy), token-exact with phase ``serving``'s greedy and
    sampled outputs (``first``), one capture, the model-axis all-reduces
    and the logits gather inside the decode graph.  With more cards: one
    process per card at tp = the card count (``--serve-tp-rank``): every
    rank serves the same tokens, and rank 0's greedy tokens agree with an
    fp32 engine on decisive positions as phase ``paged_serving``'s do (bf16
    partial sums round differently above a model axis of 1, so they are
    reported beside ``first``, not held to it)."""
    import numpy as np
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.parallel.mesh import initialize_serving_mesh

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    if world == 1:
        comm.init_distributed(init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                              world_size=1, verbose=False)
        try:
            comm.configure({"enabled": True})
            tp_engine = _inference_engine(CausalLM("llama2-7b"), params,
                                          initialize_serving_mesh(tp=1))
            check(all(a is b for a, b in zip(_leaves(tp_engine.params),
                                             _leaves(params))),
                  "a model axis of 1 copied the weights")
            reset_counts()
            sv, outs, rec = _serve_once(tp_engine, stream, "tp1")
            rec = _serve_tp_record(sv, rec, 1)
            sv.close()
            del sv, tp_engine
            free_memory()
        finally:
            comm.destroy_process_group()
    else:
        import subprocess as sp
        import tempfile

        out = tempfile.mkdtemp(prefix="serve_tp_")
        env = {**os.environ, "WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(_free_port())}
        procs = [sp.Popen([sys.executable, os.path.abspath(__file__), "--seed",
                           str(seed), "--serve-tp-rank", out],
                          env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
                 for r in range(world)]
        _join(procs, SERVE_TP_TIMEOUT_S, "serve_tp")
        rec = _rank0_record(out, "serve_tp")
        outs = {int(k): np.asarray(v) for k, v in rec.pop("outputs").items()}
        f32 = fp32_serving_engine(params)
        rec.update(greedy_vs_fp32(engine, f32, stream, outs))
        del f32
        free_memory()
    same = {rid: bool(np.array_equal(outs[rid], first[rid])) for rid in first}

    def diverge(a, b):
        diff = np.flatnonzero(a != b)
        return int(diff[0]) if len(diff) else None

    rec.update(token_exact_vs_serving=all(same.values()),
               differing_rids=[rid for rid, ok in same.items() if not ok],
               first_divergence={rid: diverge(outs[rid], first[rid]) for rid in first},
               seconds=time.perf_counter() - t0)
    emit(rec)
    # a model axis of 1 sums every row-parallel product whole, as the
    # unsharded engine does: token-exact.  Above 1 the partial sums round
    # differently in bf16, and random weights turn that into other tokens
    # (llama2-70b's widths at 8 layers are held on decisive positions by
    # --tp-cards; the CPU tests hold tp=2 token-exact in fp32)
    if rec["tp"] == 1:
        check(rec["token_exact_vs_serving"], f"serve_tp differs from phase serving: {rec}")
    else:
        check(rec["ranks_token_equal"], f"serve_tp's ranks served different tokens: {rec}")
        check_greedy_vs_fp32(rec, f"serve_tp at tp={rec['tp']}")


TEARDOWN_S = 60


def _run_rank(body) -> int:
    """One rank of a phase run one process per card: the process group,
    ``body()``, then the teardown.  A rank whose teardown is still waiting
    after TEARDOWN_S (NCCL work a CUDA graph captured held it before
    ``comm.destroy_process_group`` released the graphs) exits 1."""
    import threading
    import traceback

    from deepspeed_tpu_torch import comm

    torch.backends.cuda.matmul.allow_tf32 = False
    comm.init_distributed(verbose=False)
    try:
        body()
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        t = threading.Thread(target=comm.destroy_process_group, daemon=True)
        t.start()
        t.join(TEARDOWN_S)
        if t.is_alive():
            print(f"rank teardown still waiting after {TEARDOWN_S} s: exiting 1",
                  file=sys.stderr, flush=True)
            sys.stdout.flush()
            os._exit(1)
    return 0


def _rank0_record(out: str, what: str) -> dict:
    path = os.path.join(out, "rank0.json")
    check(os.path.exists(path), f"{what}: rank 0 wrote no record")
    with open(path) as f:
        return json.load(f)


def _join(procs, timeout_s: int, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          f"{what} ranks exited {[p.returncode for p in procs]}")


def serve_tp_rank(seed: int, out: str) -> None:
    """One rank of phase ``serve_tp`` on several cards: phase ``serving``'s
    weights (the same seed; the engine keeps this rank's shards), the
    stream, rank 0's record and outputs into ``out``; the serving engine is
    closed before it returns."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.parallel.mesh import initialize_serving_mesh

    world, rank = comm.get_world_size(), comm.get_rank()
    comm.configure({"enabled": True})
    model = CausalLM("llama2-7b")
    tp = _tp_degree(world, model.config)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mesh = initialize_serving_mesh(tp=tp)
    # phase serving's weights (the default init of the seed), whole;
    # init_inference keeps this rank's shards of them
    params = model.init_fn(gen, device="cuda", dtype=torch.bfloat16)
    engine = _inference_engine(model, params, mesh)
    del params
    free_memory()
    stream = serving_stream(seed, model.config.vocab_size)
    reset_counts()
    sv, outs, rec = _serve_once(engine, stream, f"tp{tp}")
    rec = _serve_tp_record(sv, rec, tp)
    digest = {rid: v.tolist() for rid, v in outs.items()}
    every = [None] * world
    torch.distributed.all_gather_object(every, digest)
    rec["ranks_token_equal"] = all(d == digest for d in every)
    sv.close()
    del sv, engine
    free_memory()
    if rank == 0:
        rec["outputs"] = {str(k): v.tolist() for k, v in outs.items()}
        with open(os.path.join(out, "rank0.json"), "w") as f:
            json.dump(rec, f)


# The configurations that need tensor parallelism, one process per card
# (``--tp-cards``, at 4 cards): llama2-7b training (≈94 GB of bf16 params,
# fp32 masters, moments and bf16 gradients: no one card holds it), llama2-70b
# paged serving (140 GB of bf16 weights), and llama2-70b's widths at 8 layers
# sharded over the cards against one card (tp=1, bf16 and fp32).
TP_CARD_CONFIGS = ("train_7b", "serve_70b", "cmp_70b8")
TP_CARD_TIMEOUT_S = 900
CMP_LAYERS, CMP_S = 8, 2048
# Sequence parallelism and the padded model axis (``--tp-cards-only``, 4
# cards): llama-740m at S=65536 over sp=4 (ring; one card's run of the
# same tokens first, in the parent), llama2-7b's widths at ULY_LAYERS
# layers, S=32768, Ulysses over sp=4 (32 heads; the same), llama-740m at
# tp=4 (14 heads padded to 16) against dp=4 in the same ranks.
SP_CARD_CONFIGS = ("sp4_740m", "uly_7b", "tp4_740m")
# MoE and pipeline over 4 cards (``--tp-cards-only``): see MOE_CARD_LAYERS
ITEM9_CARD_CONFIGS = ("ep4_mixtral8", "pp4_7b")
SP_S, ULY_S, ULY_LAYERS = 65536, 32768, 8


def phase_tp_cards(seed: int, configs=TP_CARD_CONFIGS) -> None:
    """Each configuration one process per card; it passes when every rank
    exits 0 and rank 0 wrote its record (and, for ``sp4_740m`` and
    ``uly_7b``, its losses lie within TP_DP_LOSS_RTOL of one card's run of
    the same tokens, made here first)."""
    import subprocess as sp
    import tempfile

    world = torch.cuda.device_count()
    check(world >= 2, f"--tp-cards needs several cards, found {world}")
    for config in configs:
        t0 = time.perf_counter()
        ref = _sp_card_reference(seed, config)
        out = tempfile.mkdtemp(prefix=f"tp_cards_{config}_")
        env = {**os.environ, "WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(_free_port())}
        procs = [sp.Popen([sys.executable, os.path.abspath(__file__), "--seed",
                           str(seed), "--tp-card-rank", config, out],
                          env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
                 for r in range(world)]
        _join(procs, TP_CARD_TIMEOUT_S, config)
        rec = _rank0_record(out, config)
        if ref is not None:
            rec["one_card"] = ref
            rec["loss_max_rel_diff_vs_one_card"] = max(
                abs(a - b) / abs(b) for a, b in zip(rec["losses"], ref["losses"]))
        emit(rec)
        if ref is not None:
            check(rec["loss_max_rel_diff_vs_one_card"] <= TP_DP_LOSS_RTOL,
                  f"{config}: losses differ from one card's beyond {TP_DP_LOSS_RTOL}")
        emit({"phase": f"tp_cards_{config}_done", "seconds": time.perf_counter() - t0})


def _sp_card(config: str) -> dict:
    """(model name, S, model keywords) of a sequence-parallel configuration."""
    return {"sp4_740m": (TRAIN_MODEL, SP_S, {}),
            "uly_7b": ("llama2-7b", ULY_S, {"num_layers": ULY_LAYERS,
                                            "attn_impl": "ulysses"})}[config]


def _one_row(vocab: int, S: int, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    return {"input_ids": torch.randint(0, vocab, (1, S), generator=gen, device="cuda")}


def _sp_card_reference(seed: int, config: str):
    """One card's run (no process group) of a sequence-parallel
    configuration's model and tokens, under ``nothing_saveable``: losses,
    step time and peak memory; None for the other configurations."""
    if config not in ("sp4_740m", "uly_7b"):
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    name, S, kw = _sp_card(config)
    kw = {k: v for k, v in kw.items() if k != "attn_impl"}
    model, engine = _train_engine(seed, S, name=name, **kw)
    L = model.config.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, _ = _zero_steps(engine, _one_row(model.config.vocab_size, S, seed),
                                    (2 * L, L, L))
    ref = {"losses": losses, "step_s": step_s,
           "median_step_s": statistics.median(step_s[1:]),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del engine, model
    free_memory()
    return ref


def _tp_card_sp(seed: int, world: int, rank: int, config: str) -> dict:
    """``sp4_740m`` / ``uly_7b``: the model over a 'seq' axis of ``world``
    (ring or Ulysses), one row of S tokens, each rank its S/world slice."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops.ring_attention import ring_attention
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout

    comm.configure({"enabled": True})
    name, S, kw = _sp_card(config)
    model, engine = _train_engine(seed, S, name=name, mesh=MeshLayout(sp=world),
                                  config_extra={"zero_optimization": {"stage": 0}}, **kw)
    cfg = model.config
    L = cfg.num_layers
    r = comm.axis_index("seq")
    # the ring: one causal block and r past ones a layer call on rank r;
    # Ulysses: one full-sequence causal call on its heads
    blocks = 1 + r if model.attn_impl != "ulysses" else 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ring_attention.rotations = 0
    losses, step_s, comms = _zero_steps(engine, _one_row(cfg.vocab_size, S, seed),
                                        (2 * L * blocks, L * blocks, L * blocks),
                                        by_axis=True)
    med = statistics.median(step_s[1:])
    flops_per_token = 6.0 * cfg.param_count + 12.0 * L * cfg.hidden_size * S
    tflops = S / med * flops_per_token / 1e12
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    return {"model": name, "layers": L, "S": S, "sp": world, "attn_impl": model.attn_impl,
            "rows": 1, "remat_policy": cfg.remat_policy, "losses": losses,
            "step_s": step_s, "median_step_s": med, "tokens_per_s": S / med,
            "model_tflops": tflops,
            "mfu": tflops * 1e12 / world / PEAK_FLOPS[torch.bfloat16],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "held_memory_gb": torch.cuda.memory_allocated() / 1e9,
            "rank0_launches_per_step": {"K1": 2 * L * blocks, "K2": L * blocks,
                                        "K3": L * blocks},
            "ring_rotations_per_step": ring_attention.rotations / ZERO_STEPS,
            "collectives_per_step_by_axis": comms[-1]}


def _tp_card_tp4_740m(seed: int, world: int, rank: int) -> dict:
    """llama-740m at a model axis of ``world`` (14 heads padded to 16 at 4)
    against dp=``world`` on the same weights (the seed's default init) and
    global batch of ``world`` rows, stage 0: losses within
    TP_DP_LOSS_RTOL at every step."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout

    comm.configure({"enabled": True})
    S = TRAIN_SHAPE[1]
    cfg = None
    out = {}
    for name, mesh, micro in (("dp", MeshLayout(dp=world), 1),
                              ("tp", MeshLayout(tp=world), world)):
        model, engine = _train_engine(
            seed, S, mesh=mesh, config_extra={"zero_optimization": {"stage": 0},
                                              "train_micro_batch_size_per_gpu": micro})
        cfg = model.config
        L = cfg.num_layers
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        batch = {"input_ids": torch.randint(0, cfg.vocab_size, (world, S), generator=gen,
                                            device="cuda")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_s, comms = _zero_steps(engine, batch, (2 * L, L, L), by_axis=True)
        out[name] = {"losses": losses, "step_s": step_s,
                     "median_step_s": statistics.median(step_s[1:]),
                     "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "held_memory_gb": torch.cuda.memory_allocated() / 1e9,
                     "local_heads": (engine.state.params["layers"]["wq"].shape[-1]
                                     // cfg.dims_per_head)}
        del engine, model, batch
        free_memory()
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["tp"]["losses"], out["dp"]["losses"]))
    check(rel <= TP_DP_LOSS_RTOL, f"tp4_740m: tp={world} losses differ from dp={world}'s "
                                  f"by {rel}: {out}")
    return {"model": TRAIN_MODEL, "S": S, "tp": world, "heads": cfg.num_heads,
            "padded_heads": out["tp"]["local_heads"] * world, **out["tp"],
            "dp_world": out["dp"], "loss_max_rel_diff_vs_dp": rel}


def _tp_card_train_7b(seed: int, world: int, rank: int) -> dict:
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout

    from deepspeed_tpu_torch import comm

    comm.configure({"enabled": True})
    name, S = "llama2-7b", 4096
    model, engine = _train_engine(seed, S, name=name, mesh=MeshLayout(tp=world),
                                  config_extra={"zero_optimization": {"stage": 0}})
    cfg = model.config
    L = cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                                        device="cuda")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_s, comms = _zero_steps(engine, batch, (2 * L, L, L), by_axis=True)
    med = statistics.median(step_s[1:])
    flops_per_token = 6.0 * cfg.param_count + 12.0 * L * cfg.hidden_size * S
    tflops = S / med * flops_per_token / 1e12
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    return {"model": name, "S": S, "tp": world, "micro_batch": 1,
            "remat_policy": cfg.remat_policy, "params": cfg.param_count,
            "state_gb": cfg.param_count * (2 + 4 + 2 + 4 + 2) / 1e9,
            "step_s": step_s, "median_step_s": med, "tokens_per_s": S / med,
            "model_tflops": tflops, "mfu": tflops * 1e12 / world / PEAK_FLOPS[torch.bfloat16],
            "losses": losses, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "held_memory_gb": torch.cuda.memory_allocated() / 1e9,
            "collectives_per_step_by_axis": comms[-1],
            "launches": dict(zip(("K1", "K2", "K3"), kernel_counts()))}


def _tp_card_serve_70b(seed: int, world: int, rank: int) -> dict:
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.parallel.mesh import initialize_serving_mesh

    comm.configure({"enabled": True})
    model = CausalLM("llama2-70b")
    mesh = initialize_serving_mesh(tp=world)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init_fn(gen, device="cuda", dtype=torch.bfloat16,
                           tp=(comm.axis_index("model"), world), streamed=True)
    engine = _inference_engine(model, params, mesh)
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    stream = serving_stream(seed, model.config.vocab_size)
    reset_counts()
    sv, outs, rec = _serve_once(engine, stream, f"llama2-70b tp{world}")
    rec = _serve_tp_record(sv, rec, world)
    digest = {rid: v.tolist() for rid, v in outs.items()}
    every = [None] * world
    torch.distributed.all_gather_object(every, digest)
    rec.update(model="llama2-70b", init_s=init_s, weights_gb_per_card=weights_gb,
               ranks_token_equal=all(d == digest for d in every))
    check(rec["ranks_token_equal"], "the ranks served different tokens")
    sv.close()
    return rec


def _inference_engine(model, params, mesh):
    import deepspeed_tpu_torch

    return deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"},
                                              params=params, mesh=mesh)


def _tp_card_cmp_70b8(seed: int, world: int, rank: int) -> dict:
    """llama2-70b's widths at CMP_LAYERS layers: the tp=world forward on
    every rank; on rank 0 the same weights whole on one card in bf16 and in
    fp32: top-1 on decisive positions (fp32 margin above the bf16 one-card
    run's own deviation from fp32) and max |dlogits|."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.parallel.mesh import initialize_serving_mesh

    model = CausalLM("llama2-70b", num_layers=CMP_LAYERS)
    cfg = model.config
    mesh = initialize_serving_mesh(tp=world)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_fn(gen, device="cuda", dtype=torch.bfloat16,
                           tp=(comm.axis_index("model"), world), streamed=True)
    tokens = torch.randint(0, cfg.vocab_size, (1, CMP_S),
                           generator=torch.Generator(device="cuda").manual_seed(seed + 7),
                           device="cuda")
    engine = _inference_engine(model, params, mesh)
    reset_counts()
    got = engine.forward(tokens).float()
    launches = kernel_counts()[0]
    del engine, params
    free_memory()
    rec = {"model": "llama2-70b", "layers": CMP_LAYERS, "S": CMP_S, "tp": world,
           "params": cfg.param_count, "k1_launches_per_rank": launches,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if rank == 0:
        import deepspeed_tpu_torch

        outs = {}
        for dtype in (torch.bfloat16, torch.float32):
            whole = model.init_fn(torch.Generator(device="cuda").manual_seed(seed),
                                  device="cuda", dtype=dtype, tp=(0, 1), streamed=True)
            one = deepspeed_tpu_torch.init_inference(
                CausalLM("llama2-70b", num_layers=CMP_LAYERS, dtype=dtype),
                config={"dtype": "bf16" if dtype == torch.bfloat16 else "fp32"},
                params=whole)
            outs[dtype] = one.forward(tokens).float()
            del one, whole
            free_memory()
        plain, ref = outs[torch.bfloat16], outs[torch.float32]
        noise = (plain - ref).abs().max().item()
        top2 = ref.topk(2, dim=-1)
        decisive = (top2.values[..., 0] - top2.values[..., 1]) > noise
        want = top2.indices[..., 0]
        rec.update(noise_tp1_bf16_vs_fp32=noise, decisive_positions=int(decisive.sum()),
                   top1_tp_vs_fp32_decisive=(got.argmax(-1) == want)[decisive]
                   .float().mean().item(),
                   top1_tp1_bf16_vs_fp32_decisive=(plain.argmax(-1) == want)[decisive]
                   .float().mean().item(),
                   top1_tp_vs_tp1_bf16=(got.argmax(-1) == plain.argmax(-1))
                   .float().mean().item(),
                   max_abs_dlogits_tp_vs_tp1_bf16=(got - plain).abs().max().item(),
                   max_abs_dlogits_tp_vs_fp32=(got - ref).abs().max().item(),
                   mean_abs_dlogits_tp_vs_fp32=(got - ref).abs().mean().item(),
                   mean_abs_dlogits_tp1_bf16_vs_fp32=(plain - ref).abs().mean().item())
        check(rec["decisive_positions"] >= 32, f"too few decisive positions: {rec}")
        check(rec["top1_tp_vs_fp32_decisive"] >= 0.99,
              f"tp={world} disagrees with fp32 on decisive positions: {rec}")
    comm.barrier()
    return rec


def tp_card_rank(seed: int, config: str, out: str) -> None:
    """One rank of a ``--tp-cards`` configuration; rank 0's record into
    ``out``."""
    from deepspeed_tpu_torch import comm

    world, rank = comm.get_world_size(), comm.get_rank()
    run = {"train_7b": _tp_card_train_7b, "serve_70b": _tp_card_serve_70b,
           "cmp_70b8": _tp_card_cmp_70b8, "tp4_740m": _tp_card_tp4_740m,
           "ep4_mixtral8": _tp_card_ep4_mixtral8, "pp4_7b": _tp_card_pp4_7b,
           "zpp4_7b": _tp_card_zpp4_7b, "onebit4_740m": _tp_card_onebit4_740m,
           "sp4_740m": lambda *a: _tp_card_sp(*a, "sp4_740m"),
           "uly_7b": lambda *a: _tp_card_sp(*a, "uly_7b")}[config]
    rec = run(seed, world, rank)
    rec.update(phase=f"tp_cards_{config}", world_size=world,
               nvidia_smi=nvidia_smi_line())
    every = [None] * world
    torch.distributed.all_gather_object(
        every, {k: rec.get(k) for k in ("peak_memory_gb", "held_memory_gb",
                                        "weights_gb_per_card")})
    rec["per_card"] = every
    if rank == 0:
        with open(os.path.join(out, "rank0.json"), "w") as f:
            json.dump(rec, f)


def _leaves(tree):
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    return tree_leaves(tree)


def _dir_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(r, n)) for r, _, files in os.walk(path)
               for n in files) / 1e9


def phase_checkpoint(seed: int):
    """Save, resume and async-save llama-740m at S=16384 (full width,
    CKPT_LAYERS layers), in a temporary directory outside the checkout: the
    resumed run's losses and every master must equal the uninterrupted
    run's, bit for bit."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.resilience import verify_checkpoint_dir

    t0 = time.perf_counter()
    S = TRAIN_SHAPE[1]
    root = tempfile.mkdtemp(prefix="ds_port_ckpt_")
    try:
        disk = shutil.disk_usage(root)
        from deepspeed_tpu_torch.models import get_config

        cfg = get_config(TRAIN_MODEL)
        state_gb = CKPT_BYTES_PER_PARAM * cfg.param_count / 1e9
        layers = CKPT_LAYERS
        # two tags must fit: cut depth (never width) until they do
        while layers > 1 and 2.2 * state_gb * layers / cfg.num_layers > disk.free / 1e9:
            layers -= 1
        cut = {} if layers == cfg.num_layers else {"num_layers": layers}
        emit({"phase": "checkpoint_disk", "dir": root, "free_gb": disk.free / 1e9,
              "state_gb_full_depth": state_gb, "layers": layers, "depth_cut": cut})
        batches = [_train_batch(cfg, S, seed + 20 + i) for i in range(5)]

        def run(engine, bs):
            return [float(engine.train_batch(batch=b)) for b in bs]

        def masters(engine):
            return [t.clone() for t in _leaves(engine.get_params(fp32=True))]

        _, a = _train_engine(seed, S, **cut)
        run(a, batches[:2])
        torch.cuda.synchronize()
        t = time.perf_counter()
        tag_dir = a.save_checkpoint(root)
        save_s = time.perf_counter() - t
        gb = _dir_gb(os.path.join(tag_dir, "state"))
        t = time.perf_counter()
        verify_checkpoint_dir(tag_dir)   # the sha256 pass alone
        verify_s = time.perf_counter() - t
        want_losses, want_masters = run(a, batches[2:4]), masters(a)
        del a
        free_memory()
        _, b = _train_engine(seed + 1, S, **cut)
        torch.cuda.synchronize()
        t = time.perf_counter()
        b.load_checkpoint(root)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        got_losses = run(b, batches[2:4])
        sync_equal = got_losses == want_losses and all(
            torch.equal(x, y) for x, y in zip(masters(b), want_masters))
        del want_masters
        # async: returns after the device->host snapshot; the step after it
        # runs while the write goes on
        b.config.checkpoint_config.async_save = True
        torch.cuda.synchronize()
        t = time.perf_counter()
        async_dir = b.save_checkpoint(root)
        async_return_s = time.perf_counter() - t
        async_losses = run(b, batches[4:5])
        b.wait_for_checkpoint()
        async_done_s = time.perf_counter() - t
        manifest = verify_checkpoint_dir(async_dir)
        with open(os.path.join(root, "latest")) as f:
            latest = f.read().strip()
        async_masters = masters(b)
        del b
        free_memory()
        _, c = _train_engine(seed + 2, S, **cut)
        c.load_checkpoint(root)
        async_equal = run(c, batches[4:5]) == async_losses and all(
            torch.equal(x, y) for x, y in zip(masters(c), async_masters))
        del c, async_masters
        free_memory()
        rec = {"phase": "checkpoint", "model": TRAIN_MODEL, "S": S,
               "layers": layers, "depth_cut": cut, "gb_written": gb,
               "save_s": save_s, "save_gbps": gb / save_s,
               "sha256_pass_s": verify_s,
               "load_s": load_s, "load_gbps": gb / load_s,
               "async_return_s": async_return_s,
               "async_until_durable_s": async_done_s,
               "async_tag": os.path.basename(async_dir), "latest": latest,
               "manifest_payload_files": len(manifest["payload"]),
               "resume_losses": got_losses, "uninterrupted_losses": want_losses,
               "bit_equal": sync_equal, "async_bit_equal": async_equal,
               "timings_include": "sha256 of every payload file (save: manifest; "
                                  "load: verify_on_load)",
               "seconds": time.perf_counter() - t0}
        emit(rec)
        check(sync_equal, f"resume is not bit-exact: {rec}")
        check(async_equal and latest == rec["async_tag"],
              f"async resume is not bit-exact or latest not published: {rec}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _adam_state(opt_state):
    """The Adam link's state in an optimizer chain's nested tuple."""
    from deepspeed_tpu_torch.runtime.optimizer import ScaleByAdamState

    if isinstance(opt_state, ScaleByAdamState):
        return opt_state
    if isinstance(opt_state, tuple):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def phase_frozen(seed: int):
    """2 steps with ``frozen_keywords=("embed",)`` at S=2048: the embedding
    does not move a bit and its Adam moments stay zero."""
    t0 = time.perf_counter()
    S = PARITY_S
    model, engine = _train_engine(seed, S, frozen_keywords=("embed",))
    before = engine.get_params(fp32=True)["embed"].clone()
    other = engine.get_params(fp32=True)["lm_head"].clone()
    losses = [float(engine.train_batch(batch=_train_batch(model.config, S, seed + i)))
              for i in range(2)]
    adam = _adam_state(engine.state.opt_state)
    rec = {"phase": "frozen", "model": TRAIN_MODEL, "S": S, "losses": losses,
           "embed_unchanged": torch.equal(engine.get_params(fp32=True)["embed"], before),
           "embed_moments_zero": not (adam.mu["embed"].any() or adam.nu["embed"].any()),
           "lm_head_moved": not torch.equal(engine.get_params(fp32=True)["lm_head"],
                                            other),
           "grad_norm": engine.get_global_grad_norm(),
           "seconds": time.perf_counter() - t0}
    emit(rec)
    check(rec["embed_unchanged"] and rec["embed_moments_zero"] and rec["lm_head_moved"],
          f"frozen parameters moved or trainable ones did not: {rec}")
    del engine, model, before, other
    free_memory()


def phase_train_parity(seed: int):
    """3 steps from one set of weights on one batch at S=2048 through the
    kernels (attn_impl="auto") and through the plain branch ("xla"), both
    bf16, and through fp32 engines on the plain branch and on the kernels
    (K1's and K2/K3's CUDA-core fp32 variants): the fp32 kernel path must
    stay within FP32_PARITY_* of the fp32 plain branch, a distance the bf16
    kernel path's must exceed."""
    from deepspeed_tpu_torch.models import CausalLM

    S = PARITY_S
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    base = CausalLM(TRAIN_MODEL, max_seq_len=S)
    params = base.init_fn(gen)
    batch = {"input_ids": torch.randint(0, base.config.vocab_size, (1, S),
                                        generator=gen, device="cuda")}
    L = base.config.num_layers
    runs = {}
    for label, impl, fp32 in (("kernel", "auto", False), ("plain", "xla", False),
                              ("fp32", "xla", True), ("fp32_kernel", "auto", True)):
        _, engine = _train_engine(seed, S, impl, fp32, params=params)
        before = kernel_counts()
        losses, norms = [], []
        for _ in range(PARITY_STEPS):
            losses.append(float(engine.train_batch(batch=batch)))
            norms.append(engine.get_global_grad_norm())
        got = tuple(a - b for a, b in zip(kernel_counts(), before))
        want = ((2 * L * PARITY_STEPS, L * PARITY_STEPS, L * PARITY_STEPS)
                if impl == "auto" else (0, 0, 0))
        check(got == want, f"{label} run launched K1/K2/K3 {got}, expected {want}")
        runs[label] = {"losses": losses, "grad_norms": norms, "launches": got}
        del engine
        free_memory()

    def rel(a, b):
        return abs(a - b) / abs(b)

    k, p, f, fk = runs["kernel"], runs["plain"], runs["fp32"], runs["fp32_kernel"]
    rec = {"phase": "train_parity", "model": TRAIN_MODEL, "S": S,
           "steps": PARITY_STEPS, **{f"{n}_{key}": r[key] for n, r in runs.items()
                                     for key in ("losses", "grad_norms")},
           "loss_rel_diff_kernel_vs_plain": [rel(a, b) for a, b in
                                             zip(k["losses"], p["losses"])],
           "grad_norm_rel_diff_kernel_vs_plain": [rel(a, b) for a, b in
                                                  zip(k["grad_norms"], p["grad_norms"])],
           "loss_rel_diff_vs_fp32": {
               "kernel": [rel(a, b) for a, b in zip(k["losses"], f["losses"])],
               "plain": [rel(a, b) for a, b in zip(p["losses"], f["losses"])]},
           "grad_norm_rel_diff_vs_fp32": {
               "kernel": [rel(a, b) for a, b in zip(k["grad_norms"], f["grad_norms"])],
               "plain": [rel(a, b) for a, b in zip(p["grad_norms"], f["grad_norms"])]},
           "fp32_kernel_vs_fp32_plain": {
               "loss_rel_diff": [rel(a, b) for a, b in zip(fk["losses"], f["losses"])],
               "grad_norm_rel_diff": [rel(a, b) for a, b in
                                      zip(fk["grad_norms"], f["grad_norms"])]},
           "gates": {"loss_rtol": PARITY_LOSS_RTOL,
                     "grad_norm_rtol": PARITY_GRAD_NORM_RTOL,
                     "vs_fp32": "kernel path no further than the plain branch",
                     "fp32_loss_rtol": FP32_PARITY_LOSS_RTOL,
                     "fp32_grad_norm_rtol": FP32_PARITY_GRAD_NORM_RTOL,
                     "fp32_yardstick": "the bf16 kernel path's distance from fp32 "
                                       "must exceed the fp32 limits"}}
    emit(rec)
    check(max(rec["loss_rel_diff_kernel_vs_plain"]) <= PARITY_LOSS_RTOL,
          f"kernel and plain loss trajectories differ: {rec}")
    check(max(rec["grad_norm_rel_diff_kernel_vs_plain"]) <= PARITY_GRAD_NORM_RTOL,
          f"kernel and plain gradient norms differ: {rec}")
    for key in ("loss_rel_diff_vs_fp32", "grad_norm_rel_diff_vs_fp32"):
        check(max(rec[key]["kernel"]) <= max(rec[key]["plain"]),
              f"the kernel path strays further from fp32 than the plain "
              f"branch ({key}): {rec}")
    f32 = rec["fp32_kernel_vs_fp32_plain"]
    for diffs, yard, tol in (
            (f32["loss_rel_diff"], rec["loss_rel_diff_vs_fp32"]["kernel"],
             FP32_PARITY_LOSS_RTOL),
            (f32["grad_norm_rel_diff"], rec["grad_norm_rel_diff_vs_fp32"]["kernel"],
             FP32_PARITY_GRAD_NORM_RTOL)):
        check(max(diffs) <= tol, f"fp32 training through the kernels strays from the "
                                 f"fp32 plain branch: {rec}")
        check(max(yard) > tol, f"the fp32 parity limit {tol} passes the bf16 kernel "
                               f"path too: {rec}")
    del params, batch
    free_memory()


def fp32_reference_logits(params, tokens) -> torch.Tensor:
    """The same weights and tokens through an fp32 engine on the plain
    attention branch: the reference both bf16 paths are held to."""
    engine = fp32_serving_engine(params)
    logits = engine.forward(tokens).float()
    del engine
    torch.cuda.empty_cache()
    return logits


def device_activity(events):
    """Busy time (us) as the union of the device intervals, and per-name
    (total us, count).  The profiler's "Command Buffer Full" markers are
    host stalls, not device work, and are left out."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in events:
        if e.device_type != DeviceType.CUDA or "Command Buffer" in e.name:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        total, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), n + 1)
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy, by_name


def profile_step(label: str, fn) -> None:
    """One warm call of ``fn`` under ``torch.profiler``: device time by
    kernel (top 12), K1/K2/K3 time and the device's busy share of the wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, by_name = device_activity(prof.events())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])

    def total_ms(tag):
        return sum(t for name, (t, _) in by_name.items() if tag in name) / 1e3

    flash = {"K1": total_ms("flash_fwd"), "K2": total_ms("flash_bwd_dq"),
             "K3": total_ms("flash_bwd_dkv")}
    emit({"phase": "profile", "what": label, "wall_ms": wall_ms,
          "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / 1e3 / wall_ms,
          "flash_kernels_ms": flash,
          "flash_kernels_share_of_wall": {k: v / wall_ms for k, v in flash.items()},
          "top_kernels": [{"name": name[:90], "ms": t / 1e3, "count": n}
                          for name, (t, n) in top[:12]]})


def phase_serving(seed: int, profile: bool):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention

    model = CausalLM("llama2-7b")          # attn_impl="auto", bf16 activations
    cfg = model.config
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init_fn(gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    engine = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"},
                                                params=params)
    emit({"phase": "init", "model": "llama2-7b", "params": model.param_count,
          "layers": cfg.num_layers, "seconds": time.perf_counter() - t0,
          "weights_gb": torch.cuda.memory_allocated() / 1e9})

    S = SERVE_SHAPE[1]
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device="cuda")
    # the serving path: counts to 0 just before, read just after
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = engine.forward(tokens)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = flash_attention.launches
    check(launches == cfg.num_layers,
          f"engine.forward launched flash_attention_fwd {launches} times, "
          f"expected one per layer ({cfg.num_layers})")
    check(tuple(logits.shape) == (1, S, cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    t0 = time.perf_counter()
    engine.forward(tokens)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    model.attn_impl = "xla"                # the plain attention branch
    before = flash_attention.launches
    plain = engine.forward(tokens)
    torch.cuda.synchronize()
    model.attn_impl = "auto"
    check(flash_attention.launches == before, "plain branch launched the kernel")
    ref = fp32_reference_logits(params, tokens)
    ref_top2 = ref.topk(2, dim=-1).values
    margin = ref_top2[..., 0] - ref_top2[..., 1]
    # bf16 noise level: how far the plain branch itself strays from fp32
    plain_dev = (plain.float() - ref).abs()
    flash_dev = (logits.float() - ref).abs()
    noise = plain_dev.max().item()
    decisive = margin > noise
    top1 = {name: x.argmax(-1) for name, x in
            (("flash", logits), ("plain", plain), ("ref", ref))}

    def agree(a, b, where=None):
        same = (top1[a] == top1[b]).float()
        return (same[where] if where is not None else same).mean().item()

    rec = {"phase": "forward", "S": S, "flash_launches": launches,
           "cold_s": cold_s, "warm_s": warm_s, "prefill_tok_per_s": S / warm_s,
           "max_abs_dlogits_vs_plain": (logits.float() - plain.float()).abs().max().item(),
           "max_abs_dlogits_vs_fp32": flash_dev.max().item(),
           "mean_abs_dlogits_vs_fp32": flash_dev.mean().item(),
           "plain_max_abs_dlogits_vs_fp32": noise,
           "plain_mean_abs_dlogits_vs_fp32": plain_dev.mean().item(),
           "top1_agreement_vs_plain": agree("flash", "plain"),
           "top1_agreement_vs_fp32": agree("flash", "ref"),
           "plain_top1_agreement_vs_fp32": agree("plain", "ref"),
           "decisive_positions": int(decisive.sum()),
           "top1_agreement_vs_plain_decisive": agree("flash", "plain", decisive),
           "top1_agreement_vs_fp32_decisive": agree("flash", "ref", decisive),
           "logits_abs_max": logits.float().abs().max().item()}
    emit(rec)
    # Random weights leave top-1 margins inside bf16 noise at most positions,
    # so any two bf16 attention paths disagree there (PERF.md).  The
    # gates: over every position, the kernel path's logits are no further
    # from the fp32 run (max and mean |dlogits|) than the plain branch's;
    # on positions whose fp32 margin exceeds the plain branch's own
    # deviation from fp32, the kernel path agrees >= 99%; and its overall
    # top-1 agreement with fp32 is the plain branch's or better (2-point
    # slack).
    check(rec["max_abs_dlogits_vs_fp32"] <= rec["plain_max_abs_dlogits_vs_fp32"]
          and rec["mean_abs_dlogits_vs_fp32"]
          <= rec["plain_mean_abs_dlogits_vs_fp32"],
          f"kernel path's logits stray further from fp32 than the plain "
          f"branch's: {rec}")
    check(rec["decisive_positions"] >= 32, "too few decisive positions to judge")
    check(rec["top1_agreement_vs_plain_decisive"] >= 0.99
          and rec["top1_agreement_vs_fp32_decisive"] >= 0.99,
          f"top-1 agreement on decisive positions below 0.99: {rec}")
    check(rec["top1_agreement_vs_fp32"] >= rec["plain_top1_agreement_vs_fp32"] - 0.02,
          f"kernel path strays further from fp32 than the plain branch: {rec}")
    del logits, plain, ref, plain_dev, flash_dev

    lengths = GEN_PROMPTS
    ids = torch.zeros((4, max(lengths)), dtype=torch.long)
    mask = torch.zeros((4, max(lengths)), dtype=torch.bool)
    cpu_gen = torch.Generator().manual_seed(seed + 1)
    for i, n in enumerate(lengths):
        ids[i, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=cpu_gen)
        mask[i, :n] = True
    new = GEN_NEW
    first = engine.generate(ids, max_new_tokens=new, attention_mask=mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    second = engine.generate(ids, max_new_tokens=new, attention_mask=mask)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(tuple(second.shape) == (4, max(lengths) + new),
          f"generate shape {tuple(second.shape)}")
    check(torch.equal(first, second), "greedy generate is not deterministic")
    gen_tokens = second[:, max(lengths):]
    check(bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size)).all()),
          "generated token ids out of range")
    # cross-check: the longest (unpadded) row's first token is the argmax of
    # the full-sequence forward's last logits (reported, not asserted: the
    # two paths round bf16 attention differently)
    fwd = engine.forward(ids[3:4, :128])
    same_first = int(fwd[0, -1].argmax()) == int(second[3, 128])
    emit({"phase": "generate", "prompts": lengths, "new_tokens": new,
          "seconds": gen_s, "tok_per_s": 4 * new / gen_s,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "deterministic": True,
          "first_token_matches_forward_argmax": same_first})
    if profile:
        ids128 = tokens[:, :128].repeat(4, 1)
        profile_step("forward", lambda: engine.forward(tokens))
        profile_step("generate_2_tokens",
                     lambda: engine.generate(ids128, max_new_tokens=2))
    del tokens
    free_memory()
    paged, first, stream = phase_paged_serving(engine, params, seed, profile)
    # phase observability's serving part, on this engine and stream
    t0 = time.perf_counter()
    obs = observability_serving(engine, seed, stream, first, paged["rerun_run"])
    obs["part_seconds"] = time.perf_counter() - t0
    emit({"phase": "observability/serving", "seconds": obs["part_seconds"]})
    phase_serve_tp(engine, params, seed, stream, first)
    item6 = {"hf_load": phase_hf_load(engine, params, seed, stream, first),
             "quantized": phase_quantized(engine, params, seed, stream),
             "generate_fallback": phase_generate_fallback(engine, params, seed)}
    item6["serving_extras"] = phase_serving_extras(engine, params, seed, stream,
                                                   first, paged)
    item6["observability"] = obs
    del engine, params
    free_memory()
    return launches, paged, item6


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q / 100 * len(xs)) - 1))]


def _serve_once(engine, stream, label, shared=True, before_run=None, keep_ticks=False,
                **serve_kw):
    """One fresh ServingEngine over the stream (``serve_kw``: the serving
    extras); per-tick times by wrapping its decode tick (the tick ends in a
    host fetch of the tokens, so the host clock around it is the tick's
    time).  ``shared``: the stream's shared prefix must be shared;
    ``before_run(sv)`` runs between the build and the run; ``keep_ticks``
    keeps every tick's seconds in the record (``tick_s``)."""
    from deepspeed_tpu_torch.ops.kernels.decode_attention import decode_attention

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sv = engine.serving(**{"b_slots": SERVE_SLOTS, "page_size": SERVE_PAGE,
                           "max_model_len": SERVE_MAX_LEN, **serve_kw})
    build_s = time.perf_counter() - t0
    inv0 = sv.program_inventory()
    tick_s = []
    tick = sv._decode_tick

    def timed_tick(*args):
        t = time.perf_counter()
        tick(*args)
        tick_s.append(time.perf_counter() - t)

    sv._decode_tick = timed_tick
    if before_run is not None:
        before_run(sv)
    t0 = time.perf_counter()
    results = sv.run(list(stream))
    run_s = time.perf_counter() - t0
    del sv._decode_tick
    inv1 = sv.program_inventory()
    acct = sv.page_accounting()
    ex = sv._exec
    out_tokens = sum(len(r.output_ids) for r in results)
    ttft = [r.ttft_s for r in results]
    rec = {"phase": "paged_serving", "run": label, "requests": len(results),
           "engine_build_s": build_s, "run_s": run_s,
           "output_tokens": out_tokens, "output_tok_per_s": out_tokens / run_s,
           "decode_ticks": ex.replays, "decode_ticks_per_s": ex.replays / run_s,
           "mean_decode_tick_ms": 1e3 * statistics.mean(tick_s),
           "median_decode_tick_ms": 1e3 * statistics.median(tick_s),
           "decode_share_of_run": sum(tick_s) / run_s,
           "ttft_p50_s": _percentile(ttft, 50), "ttft_p99_s": _percentile(ttft, 99),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "kv_pool_gb": sv.health()["kv_pool_bytes_total"] / 1e9,
           "k4_launches_in_graph": ex.graph_k4_launches,
           "graph_captures": ex.captures, "inventory": inv1,
           "k4_counter": decode_attention.launches,
           "prefix_hits": sv.prefix_hits, "cow_copies": sv.cow_copies,
           "prefix_shared_tokens": sv.prefix_shared_tokens,
           "page_accounting": acct}
    if keep_ticks:
        rec["tick_s"] = tick_s
    cfg = engine.model.config
    spec = sv._spec
    captures = 1 + (spec.captures if spec is not None else 0)
    ticks = spec.verify_replays if spec is not None else ex.replays
    if spec is not None:
        rec.update({"decode_ticks": ticks, "decode_ticks_per_s": ticks / run_s,
                    "draft_replays": spec.draft_replays,
                    "k4_launches_in_draft_graph": spec.draft_k4_launches,
                    "k4_launches_in_verify_graph": spec.verify_k4_launches,
                    "k4_launches_per_tick": (spec.k * spec.draft_k4_launches
                                             + spec.verify_k4_launches),
                    "mean_accepted_len": spec.mean_accepted_len()})
    check(len(results) == len(stream), f"{len(results)} of {len(stream)} served")
    check(ex.graph_k4_launches == cfg.num_layers,
          f"the decode graph holds {ex.graph_k4_launches} K4 launches, "
          f"expected one per layer ({cfg.num_layers})")
    check(ex.captures == 1 and inv0["captures"] == inv1["captures"] == captures
          and ticks == len(tick_s)
          and (spec is None or spec.draft_replays == spec.k * ticks),
          f"new captures in steady state: {inv0} -> {inv1}, {ticks} graph ticks "
          f"for {len(tick_s)} ticks")
    check(acct["balanced"] and acct["referenced"] == acct["cached"],
          f"page accounting after the run: {acct}")
    if shared:
        check(sv.prefix_hits >= len(SHARED_RIDS) - 1 and sv.cow_copies >= 1,
              f"the shared prefix was not shared: {sv.health()}")
    for r in results:
        ids = r.output_ids
        want = next(q for q in stream if q.rid == r.rid).max_new_tokens
        check(len(ids) == want and r.finish_reason == "length"
              and bool(((ids >= 0) & (ids < cfg.vocab_size)).all()),
              f"request {r.rid}: {r.finish_reason}, {len(ids)} tokens")
    return sv, {r.rid: r.output_ids for r in results}, rec


def _positions_logits(engine, stream, outs, rids, params=None):
    """Teacher-forced logits over prompt + served output at the positions
    that predicted each served token ([n_out, V] fp32 per request), through
    ``engine``'s forward over its weights or over ``params``."""
    got = {}
    for rid in rids:
        prompt = stream[rid].input_ids
        seq = torch.tensor(list(prompt) + list(outs[rid][:-1]), device="cuda")[None]
        if params is None:
            logits = engine.forward(seq)
        else:
            with torch.inference_mode():
                logits = engine.apply_fn(params, seq)
        got[rid] = logits[0, len(prompt) - 1:].float().clone()
    return got


def fp32_serving_engine(params):
    """An fp32 llama2-7b engine on the plain attention branch over the
    same weights: the reference served tokens are held to."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    return deepspeed_tpu_torch.init_inference(
        CausalLM("llama2-7b", attn_impl="xla", dtype=torch.float32),
        config={"dtype": "fp32"}, params=params)


class _RouterLogits:
    """Records the router logits of every MoE layer a forward runs (in
    call order), while active."""

    def __enter__(self):
        from deepspeed_tpu_torch.moe import sharded_moe

        self.mod, self.calls = sharded_moe, []
        self.orig = sharded_moe._router_logits

        def record(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            self.calls.append(out.detach().float()[0])
            return out

        sharded_moe._router_logits = record
        return self

    def __exit__(self, *exc):
        self.mod._router_logits = self.orig


def _routing_decisive(plain_calls, ref_calls, layers: int, rids, lengths) -> dict:
    """Per request, the positions whose fp32 routing is decided beyond bf16
    noise in every MoE layer: the gap between the 2nd and 3rd router logit
    exceeds twice how far the bf16 plain branch's router logits stray from
    fp32's there (a near tie flips a bf16 token to another expert)."""
    out, k = {}, 0
    for rid, n in zip(rids, lengths):
        ok = None
        for _ in range(layers):
            r32, r16 = ref_calls[k], plain_calls[k]
            k += 1
            top3 = r32.topk(3, dim=-1).values
            good = (top3[:, 1] - top3[:, 2]) > 2 * (r16 - r32).abs().max(-1).values
            ok = good if ok is None else ok & good
        out[rid] = ok[-n:]     # the positions that predicted the served tokens
    return out


def greedy_vs_fp32(engine, f32, stream, outs, moe_layers: int = 0) -> dict:
    """The greedy requests' served tokens (``outs``) against the fp32
    engine ``f32`` on the same weights, teacher-forced: top-1 at every
    position and at the decisive ones, whose fp32 top-2 margin exceeds how
    far ``engine``'s bf16 plain attention branch strays from fp32 there
    (its largest stray over every position).  An MoE model (``moe_layers``)
    holds each position to its own stray instead, and only where its fp32
    routing is decided beyond bf16 noise in every layer
    (:func:`_routing_decisive`): a near tie of two gates sends a bf16 token
    to another expert and moves its logits by whole units."""
    rids = [r.rid for r in stream if r.rid not in SAMPLED_RIDS]
    engine.model.attn_impl = "xla"
    with _RouterLogits() as rp:
        plain = _positions_logits(engine, stream, outs, rids)
    engine.model.attn_impl = "auto"
    with _RouterLogits() as rr:
        ref = _positions_logits(f32, stream, outs, rids)
    stray = {r: (plain[r] - ref[r]).abs().max(-1).values for r in rids}
    noise = max(stray[r].max().item() for r in rids)
    routed = (_routing_decisive(rp.calls, rr.calls, moe_layers, rids,
                                [len(outs[r]) for r in rids]) if moe_layers else None)
    n_dec = n_agree = n_all = n_all_agree = 0
    for rid in rids:
        top2 = ref[rid].topk(2, dim=-1)
        served = torch.as_tensor(outs[rid], device="cuda").long()
        ok = top2.indices[:, 0] == served
        margin = top2.values[:, 0] - top2.values[:, 1]
        dec = (margin > noise) if routed is None else (margin > stray[rid]) & routed[rid]
        n_dec += int(dec.sum())
        n_agree += int((ok & dec).sum())
        n_all += len(served)
        n_all_agree += int(ok.sum())
    del plain, ref
    free_memory()
    rec = {"greedy_positions": n_all, "greedy_top1_vs_fp32": n_all_agree / n_all,
           "noise_plain_bf16_vs_fp32": noise, "decisive_positions": n_dec,
           "greedy_top1_vs_fp32_decisive": n_agree / max(n_dec, 1)}
    if routed is not None:
        rec["decisive_by"] = ("each position's own bf16 stray, routing decided in "
                              "every layer")
        rec["median_stray"] = float(torch.cat(list(stray.values())).median())
        rec["routing_decided_positions"] = int(sum(int(v.sum()) for v in routed.values()))
    return rec


def check_greedy_vs_fp32(rec, what: str) -> None:
    check(rec["decisive_positions"] >= 32, f"{what}: too few decisive positions "
                                           f"to judge: {rec}")
    check(rec["greedy_top1_vs_fp32_decisive"] >= 0.99,
          f"{what}: served greedy tokens disagree with fp32 on decisive "
          f"positions: {rec}")


def phase_paged_serving(engine, params, seed: int, profile: bool):
    """The paged serving path on the llama2-7b engine.  Returns the K4
    launch record of the main path's run."""
    import numpy as np
    from deepspeed_tpu_torch.ops.kernels.decode_attention import decode_attention

    cfg = engine.model.config
    stream = serving_stream(seed, cfg.vocab_size)
    # the paged serving path: counts to 0 just before, read just after
    reset_counts()
    sv, first, rec = _serve_once(engine, stream, "first")
    launches = {"counter": decode_attention.launches,
                "per_tick": sv._exec.graph_k4_launches,
                "ticks": sv._exec.replays,
                "replayed": sv._exec.graph_k4_launches * sv._exec.replays}
    bf16_run = {key: rec[key] for key in ("mean_decode_tick_ms", "median_decode_tick_ms",
                                          "output_tok_per_s", "kv_pool_gb")}
    emit(rec)
    del sv
    free_memory()
    sv, second, rec2 = _serve_once(engine, stream, "rerun")
    emit(rec2)
    # the plain run phase observability's instrumented run is held beside
    launches["rerun_run"] = {key: rec2[key] for key in OBS_RUN_KEYS}
    same = all(np.array_equal(first[r], second[r]) for r in first)
    check(same, "the rerun of the stream served other tokens")
    if profile:
        profile_serving(sv, stream)
    del sv
    free_memory()

    # sampled lanes beside generate(sampling=...) in bf16 (reported)
    def lane_stream(eng, rid):
        r = stream[rid]
        full = eng.generate(r.input_ids[None], max_new_tokens=r.max_new_tokens,
                            sampling=r.sampling)
        return full[0, len(r.input_ids):].cpu().numpy()

    bf16_lanes = {}
    for rid in SAMPLED_RIDS:
        ref = lane_stream(engine, rid)
        diff = np.flatnonzero(ref != first[rid])
        bf16_lanes[rid] = {"tokens": len(ref),
                           "first_divergence": int(diff[0]) if len(diff) else None}

    # greedy lanes against fp32, on decisive positions
    f32 = fp32_serving_engine(params)
    greedy = greedy_vs_fp32(engine, f32, stream, first)

    # sampled lanes in fp32: a serving engine and generate(sampling=...)
    sampled_reqs = [stream[r] for r in SAMPLED_RIDS]
    longest = max(len(r.input_ids) + r.max_new_tokens for r in sampled_reqs)
    sv32 = f32.serving(b_slots=len(SAMPLED_RIDS), page_size=SERVE_PAGE,
                       max_model_len=-(-longest // SERVE_PAGE) * SERVE_PAGE)
    got32 = {r.rid: r.output_ids for r in sv32.run(sampled_reqs)}
    check(sv32.page_accounting()["balanced"], "fp32 page accounting")
    del sv32
    free_memory()
    f32_exact = {rid: bool(np.array_equal(got32[rid], lane_stream(f32, rid)))
                 for rid in SAMPLED_RIDS}
    del f32
    free_memory()
    rec = {"phase": "paged_serving_gates", "k4_launches": launches,
           "rerun_identical": same, **greedy,
           "sampled_bf16_vs_generate_bf16": bf16_lanes,
           "sampled_fp32_serving_equals_generate_fp32": f32_exact}
    emit(rec)
    check_greedy_vs_fp32(rec, "paged_serving")
    check(all(f32_exact.values()), f"sampled lanes differ from generate: {rec}")
    # what phase serving_extras holds its runs beside (the same call)
    launches["bf16_run"] = {**bf16_run, "noise_plain_bf16_vs_fp32":
                            greedy["noise_plain_bf16_vs_fp32"]}
    return launches, first, stream


# ---------------------------------------------------------------------------
# The paged serving extras (ROADMAP item 7) on the llama2-7b engine and its
# serving stream: int8 pages, the host-RAM tier, speculative decoding,
# per-slot adapters, the supervisor's warm restart
# ---------------------------------------------------------------------------

TIER_SYSTEMS, TIER_SYSTEM_LEN, TIER_REQUESTS = 3, 1024, 12   # 8 full pages each
TIER_SLOTS, TIER_MAX_LEN, TIER_HOST_PAGES = 2, 1280, 64
ADAPTER_TENANTS, ADAPTER_RANK = 4, 16
SUPERVISOR_FAULT_TICK = 40


def tier_stream(seed: int, vocab: int):
    """Three 1024-token system prompts (8 full pages, no boundary page) in
    rotation with 16-100-token tails, 64 new tokens each: over a pool of 20
    pages every admission needs room, so system pages demote and come back
    as promotions."""
    import numpy as np
    from deepspeed_tpu_torch.inference import Request

    rng = np.random.default_rng(seed + 7)
    systems = [rng.integers(0, vocab, TIER_SYSTEM_LEN) for _ in range(TIER_SYSTEMS)]
    return [Request(rid=1000 + i, input_ids=np.concatenate(
        [systems[i % TIER_SYSTEMS], rng.integers(0, vocab, int(rng.integers(16, 100)))]
    ).astype(np.int32), max_new_tokens=64) for i in range(TIER_REQUESTS)]


def tier_move_rates(sv, reps: int = 8) -> dict:
    """One page's demote and promote moves (every layer's K and V slabs,
    pinned host memory) timed alone, synchronised: ms a page and GB/s."""
    ex = sv._exec
    page_bytes = sum(a[:, 1].numel() * a.element_size() for a in ex.pools)
    slabs, event = ex.extract(1)
    event.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        slabs, event = ex.extract(1)
        event.synchronize()
    demote = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        ex.inject(slabs, 0)          # the trash page: nothing reads it
    torch.cuda.synchronize()
    promote = (time.perf_counter() - t0) / reps
    return {"page_mb": page_bytes / 1e6, "pinned": bool(slabs[0].is_pinned()),
            "demote_ms_per_page": 1e3 * demote, "promote_ms_per_page": 1e3 * promote,
            "demote_gb_per_s": page_bytes / demote / 1e9,
            "promote_gb_per_s": page_bytes / promote / 1e9}


def tenant_lora(cfg, seed: int, tenant: int) -> dict:
    """Seeded random LoRA factors of one tenant at ADAPTER_RANK on the
    DEFAULT_TARGETS (both A and B non-zero, so the delta is real)."""
    import numpy as np

    rng = np.random.default_rng(seed * 100 + tenant)
    L, d, hq = cfg.num_layers, cfg.hidden_size, cfg.num_heads * cfg.dims_per_head
    hkv = cfg.kv_heads * cfg.dims_per_head
    shapes = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d)}
    r = ADAPTER_RANK
    return {t: {"A": (rng.standard_normal((L, i, r)) / np.sqrt(i)).astype(np.float32),
                "B": (rng.standard_normal((L, r, o)) * 0.5 / np.sqrt(r)).astype(np.float32)}
            for t, (i, o) in shapes.items()}


def _tokens_agree(a: dict, b: dict) -> float:
    n = same = 0
    for rid, x in a.items():
        y = b[rid]
        m = min(len(x), len(y))
        n += m
        same += int((x[:m] == y[:m]).sum())
    return same / max(n, 1)


def _decisive_top1(engine, params, stream, outs, rids, noise: float) -> dict:
    """``engine``'s forward over ``params`` teacher-forced over prompt +
    served tokens: top-1 against the served tokens, everywhere and where
    the forward's top-2 margin exceeds ``noise`` (the paged_serving bf16
    noise level)."""
    got = _positions_logits(engine, stream, outs, rids, params)
    n_dec = n_agree = n_all = n_all_agree = 0
    for rid in rids:
        top2 = got[rid].topk(2, dim=-1)
        served = torch.as_tensor(outs[rid], device="cuda").long()
        ok = top2.indices[:, 0] == served
        dec = (top2.values[:, 0] - top2.values[:, 1]) > noise
        n_dec += int(dec.sum())
        n_agree += int((ok & dec).sum())
        n_all += len(served)
        n_all_agree += int(ok.sum())
    return {"positions": n_all, "top1": n_all_agree / max(n_all, 1),
            "decisive_positions": n_dec,
            "top1_decisive": n_agree / max(n_dec, 1), "noise": noise}


def phase_serving_extras(engine, params, seed: int, stream, first, paged) -> dict:
    """Item 7 on the llama2-7b engine and the 24-request stream.  Each run
    is a fresh engine whose decode path takes no new capture in steady
    state, with its page accounting balanced and every request finished:

    - ``int8``: ``kv_dtype="int8"``; K4's int8 mode, 32 launches a tick in
      the one graph; tick ms beside bf16's (phase paged_serving, this
      call); pages and tokens the int8 pool holds in the bf16 pool's GB;
    - ``tier``: ``tier_stream`` through 20 pages and a host tier of 64,
      against a big pool with the tier off (tokens equal: the bytes round
      trip); demotions, promotions, a page's move ms and GB/s;
    - ``speculative``: ``perturbed_draft(scale=1e-3)``, k = SPEC_K; K4
      launches a tick (k draft replays of 32 + the verify block's 32 over
      B*(k+1) rows), mean accepted length, tick ms, token agreement with
      the plain stream;
    - ``adapters``: ADAPTER_TENANTS tenants at rank ADAPTER_RANK on the
      default targets, the stream's requests spread over them and the base
      model; tick ms beside bf16's; each tenant's greedy requests again
      under ``fuse_adapter`` (and the per-slot streams teacher-forced
      through the serving engine's fused weights: top-1 on decisive
      positions), the first fuse moving the server onto its own weights
      (one recapture) and the engine's weights never written, then
      ``fuse_adapter(None)`` restoring the base bit for bit;
    - ``supervisor``: a raise at serve.decode on tick SUPERVISOR_FAULT_TICK;
      one restart, every request finished, the restart's seconds and its
      graph captures.

    The greedy streams of int8, speculative and supervisor are held to an
    fp32 engine (teacher-forced) with paged_serving's decisive-position
    gate."""
    import numpy as np
    from deepspeed_tpu_torch.inference import (AdapterRegistry, SpeculativeConfig,
                                               perturbed_draft)
    from deepspeed_tpu_torch.ops.kernels.decode_attention import decode_attention
    from deepspeed_tpu_torch.resilience import (FaultInjector, clear_injector,
                                                install_injector)
    from deepspeed_tpu_torch.resilience.fault_injection import SITE_SERVE_DECODE
    from deepspeed_tpu_torch.runtime.lora import LoRAConfig

    cfg = engine.model.config
    bf16 = paged["bf16_run"]
    out = {"phase": "serving_extras", "bf16": bf16}
    launches = {}

    def k4(sv):
        spec = sv._spec
        per_tick = (sv._exec.graph_k4_launches if spec is None else
                    spec.k * spec.draft_k4_launches + spec.verify_k4_launches)
        return {"counter": decode_attention.launches, "per_tick": per_tick,
                "in_graph": sv._exec.graph_k4_launches}

    # --- int8 pages
    reset_counts()
    sv, int8_outs, rec = _serve_once(engine, stream, "int8", kv_dtype="int8")
    check(sv._exec.graph_k4_launches == cfg.num_layers and sv.kv_dtype == "int8",
          f"int8: {sv._exec.graph_k4_launches} K4 launches in the graph")
    launches["int8"] = k4(sv)
    check(launches["int8"]["counter"] > 0, "int8: K4 not launched")
    pool = sv.health()["kv_pool_bytes_total"]
    page_int8 = pool / sv.num_pages
    page_bf16 = bf16["kv_pool_gb"] * 1e9 / sv.num_pages
    pages_equal_gb = int(bf16["kv_pool_gb"] * 1e9 // page_int8)
    out["int8"] = {**{k: rec[k] for k in ("mean_decode_tick_ms", "median_decode_tick_ms",
                                          "output_tok_per_s", "kv_pool_gb",
                                          "peak_memory_gb", "graph_captures")},
                   "bf16_mean_decode_tick_ms": bf16["mean_decode_tick_ms"],
                   "tick_ratio_to_bf16": rec["mean_decode_tick_ms"]
                   / bf16["mean_decode_tick_ms"],
                   "page_bytes": page_int8, "bf16_page_bytes": page_bf16,
                   "pages_in_bf16_pool_gb": pages_equal_gb,
                   "tokens_in_bf16_pool_gb": pages_equal_gb * SERVE_PAGE,
                   "bf16_pool_pages": sv.num_pages,
                   "tokens_equal_to_bf16": _tokens_agree(int8_outs, first),
                   "k4": launches["int8"]}
    emit({"phase": "serving_extras", "run": "int8", **out["int8"]})
    del sv
    free_memory()

    # --- the host tier
    tstream = tier_stream(seed, cfg.vocab_size)
    kw = {"b_slots": TIER_SLOTS, "page_size": SERVE_PAGE, "max_model_len": TIER_MAX_LEN}
    reset_counts()
    sv, tier_outs, rec = _serve_once(engine, tstream, "tier", shared=False,
                                     num_pages=1 + TIER_SLOTS * (TIER_MAX_LEN // SERVE_PAGE),
                                     host_tier_pages=TIER_HOST_PAGES, **kw)
    launches["tier"] = k4(sv)
    h = sv.health()
    moves = tier_move_rates(sv)
    lat = sv.tier_latencies()
    del sv
    free_memory()
    _, ref_outs, _ = _serve_once(engine, tstream, "tier_off", shared=False,
                                 num_pages=1 + TIER_SYSTEMS * 9 + TIER_SLOTS * 10, **kw)
    same = all(np.array_equal(tier_outs[r], ref_outs[r]) for r in ref_outs)
    out["tier"] = {"demotions": h["demotions_total"], "promotions": h["promotions_total"],
                   "demoted_pages_hwm": h["demoted_pages_hwm"],
                   "host_tier_gb": h["host_tier_bytes"] / 1e9,
                   "prefix_hits": h["prefix_hits_total"],
                   "tokens_equal_to_tier_off": same,
                   "mean_decode_tick_ms": rec["mean_decode_tick_ms"],
                   "engine_promote_ms": 1e3 * statistics.median(lat["promote_s"])
                   if lat["promote_s"] else None,
                   "engine_demote_issue_ms": 1e3 * statistics.median(lat["demote_s"])
                   if lat["demote_s"] else None,
                   **moves, "k4": launches["tier"]}
    emit({"phase": "serving_extras", "run": "tier", **out["tier"]})
    check(h["demotions_total"] > 0 and h["promotions_total"] > 0,
          f"tier: no demote/promote cycle: {out['tier']}")
    check(same, "tier: tokens differ from the tier-off run")
    del ref_outs
    free_memory()

    # --- speculative decoding
    draft, dparams = perturbed_draft(engine.model, params, scale=1e-3, seed=seed)
    reset_counts()
    sv, spec_outs, rec = _serve_once(
        engine, stream, "speculative",
        speculative=SpeculativeConfig(draft, dparams, k=SPEC_K))
    launches["speculative"] = k4(sv)
    spec = sv._spec
    out["speculative"] = {
        **{k: rec[k] for k in ("mean_decode_tick_ms", "median_decode_tick_ms",
                               "output_tok_per_s", "decode_ticks", "mean_accepted_len",
                               "k4_launches_in_draft_graph", "k4_launches_in_verify_graph",
                               "k4_launches_per_tick", "peak_memory_gb")},
        "k": spec.k, "bf16_mean_decode_tick_ms": bf16["mean_decode_tick_ms"],
        "tokens_equal_to_plain": _tokens_agree(spec_outs, first),
        "draft_pool_gb": spec.pool_bytes["total"] / 1e9, "k4": launches["speculative"]}
    emit({"phase": "serving_extras", "run": "speculative", **out["speculative"]})
    check(spec.draft_k4_launches == cfg.num_layers
          and spec.verify_k4_launches == cfg.num_layers,
          f"speculative: K4 {spec.draft_k4_launches} in the draft graph, "
          f"{spec.verify_k4_launches} in the verify graph")
    check(rec["mean_accepted_len"] > 1.0, f"speculative: no token accepted: {rec}")
    del sv, draft, dparams, spec
    free_memory()

    # --- adapters
    reg = AdapterRegistry(params["layers"])
    tenants = [f"tenant{i}" for i in range(ADAPTER_TENANTS)]
    for i, aid in enumerate(tenants):
        reg.register(aid, tenant_lora(cfg, seed, i),
                     LoRAConfig(rank=ADAPTER_RANK, alpha=2.0 * ADAPTER_RANK))
    astream = [dataclasses.replace(r, adapter_id=(None if i % (ADAPTER_TENANTS + 1) == 0
                                                  else tenants[i % (ADAPTER_TENANTS + 1) - 1]))
               for i, r in enumerate(stream)]
    reset_counts()
    sv, ad_outs, rec = _serve_once(engine, astream, "adapters", shared=False, adapters=reg)
    launches["adapters"] = k4(sv)
    stats = sv.adapter_stats()
    base_copy = {k: v.clone() for k, v in params["layers"].items() if k in ("wq", "wo")}
    # each tenant in turn from fused weights: its greedy requests served
    # again, and its per-slot stream teacher-forced through the serving
    # engine's fused weights (sv.params: its own since the first fuse)
    fuse_s, per_slot, fused_outs, rids_all = [], {}, {}, []
    for aid in tenants:
        rids = [r.rid for r in astream if r.adapter_id == aid and r.sampling is None]
        t0 = time.perf_counter()
        sv.fuse_adapter(aid)
        fuse_s.append(time.perf_counter() - t0)
        got = sv.run([dataclasses.replace(r, rid=f"f{r.rid}") for r in astream
                      if r.rid in rids])
        fused_outs.update({int(r.rid[1:]): r.output_ids for r in got})
        per_slot.update({rid: ad_outs[rid] for rid in rids})
        rec_t = _decisive_top1(engine, sv.params, astream, ad_outs, rids,
                               bf16["noise_plain_bf16_vs_fp32"])
        for key in ("positions", "decisive_positions"):
            rec_t[f"{key}_agree"] = rec_t[key] * rec_t["top1" if key == "positions"
                                                       else "top1_decisive"]
        rids_all.append(rec_t)
    sv.fuse_adapter(None)
    captures_after_fuse = sv.program_inventory()["captures"]
    restored = all(torch.equal(sv.params["layers"][k], params["layers"][k])
                   for k in params["layers"])
    engine_untouched = all(torch.equal(params["layers"][k], v) for k, v in base_copy.items())
    n_pos = sum(r["positions"] for r in rids_all)
    n_dec = sum(r["decisive_positions"] for r in rids_all)
    fused_top1 = {"positions": n_pos,
                  "top1": sum(r["positions_agree"] for r in rids_all) / max(n_pos, 1),
                  "decisive_positions": n_dec,
                  "top1_decisive": sum(r["decisive_positions_agree"] for r in rids_all)
                  / max(n_dec, 1), "noise": bf16["noise_plain_bf16_vs_fp32"]}
    out["adapters"] = {
        **{k: rec[k] for k in ("mean_decode_tick_ms", "median_decode_tick_ms",
                               "output_tok_per_s", "peak_memory_gb")},
        "bf16_mean_decode_tick_ms": bf16["mean_decode_tick_ms"],
        "tick_ratio_to_no_adapters": rec["mean_decode_tick_ms"]
        / bf16["mean_decode_tick_ms"],
        "tenants": ADAPTER_TENANTS, "rank": ADAPTER_RANK, "stats": stats,
        "fuse_s": fuse_s, "fused_tokens_equal_to_per_slot":
        _tokens_agree(fused_outs, per_slot),
        "per_slot_stream_under_fused_weights": fused_top1,
        "base_restored_bit_exact": restored,
        "engine_weights_untouched": engine_untouched,
        "graph_captures_after_fuse": captures_after_fuse, "k4": launches["adapters"]}
    emit({"phase": "serving_extras", "run": "adapters", **out["adapters"]})
    check(all(s["admissions"] > 0 for s in stats.values()), f"adapters: {stats}")
    check(restored, "adapters: fuse_adapter(None) did not restore the base weights")
    check(engine_untouched, "adapters: fuse_adapter wrote the InferenceEngine's weights")
    check(captures_after_fuse == 2, f"adapters: {captures_after_fuse} captures after "
                                    "the fuses (the first fuse recaptures once)")
    check(fused_top1["decisive_positions"] >= 32
          and fused_top1["top1_decisive"] >= 0.99,
          f"adapters: the fused weights disagree with the per-slot stream: {fused_top1}")
    del sv, reg
    free_memory()

    # --- the supervisor: counts from before its first engine's build (its
    # capture, the run, the restart's recapture)
    reset_counts()
    sup = engine.supervised_serving(b_slots=SERVE_SLOTS, page_size=SERVE_PAGE,
                                    max_model_len=SERVE_MAX_LEN)
    restart_s = []
    body = sup._restart_body

    def timed_restart(*a, **k):
        t = time.perf_counter()
        body(*a, **k)
        torch.cuda.synchronize()
        restart_s.append(time.perf_counter() - t)

    sup._restart_body = timed_restart
    inj = FaultInjector()
    inj.add(site=SITE_SERVE_DECODE, kind="raise", at_call=SUPERVISOR_FAULT_TICK)
    install_injector(inj)
    try:
        t0 = time.perf_counter()
        results = sup.run(list(stream))
        run_s = time.perf_counter() - t0
    finally:
        clear_injector()
    launches["supervisor"] = {"counter": decode_attention.launches,
                              "per_tick": sup.engine._exec.graph_k4_launches}
    sup_outs = {r.rid: r.output_ids for r in results}
    entry = sup.restart_log[-1] if sup.restart_log else {}
    out["supervisor"] = {"restarts": sup.restarts, "run_s": run_s,
                         "restart_s": restart_s, "replayed_inflight":
                         entry.get("replayed_inflight"),
                         "graph_captures_after_restart":
                         entry.get("graph_captures_after_restart"),
                         "programs_reused": entry.get("programs_reused"),
                         "finished": len(results),
                         "tokens_equal_to_fault_free": _tokens_agree(sup_outs, first),
                         "replays": {r.rid: r.replays for r in results if r.replays},
                         "page_accounting": sup.engine.page_accounting(),
                         "k4": launches["supervisor"]}
    emit({"phase": "serving_extras", "run": "supervisor", **out["supervisor"]})
    check(sup.restarts == 1 and len(results) == len(stream)
          and all(len(r.output_ids) == stream[r.rid].max_new_tokens for r in results),
          f"supervisor: {out['supervisor']}")
    check(out["supervisor"]["graph_captures_after_restart"] == 1
          and sup.engine.program_inventory()["captures"] == 1,
          f"supervisor: captures after the restart: {entry}")
    check(out["supervisor"]["page_accounting"]["balanced"], "supervisor: accounting")
    sup.engine.close()
    del sup, results
    free_memory()

    # --- greedy streams against fp32, on decisive positions
    f32 = fp32_serving_engine(params)
    for name, outs in (("int8", int8_outs), ("speculative", spec_outs),
                       ("supervisor", sup_outs)):
        g = greedy_vs_fp32(engine, f32, stream, outs)
        out[name]["greedy_vs_fp32"] = g
        emit({"phase": "serving_extras", "run": name, "greedy_vs_fp32": g})
        check_greedy_vs_fp32(g, f"serving_extras {name}")
    del f32
    free_memory()
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Hugging Face loading, weight quantization and the full-recompute generate,
# on phase_serving's llama2-7b weights and serving stream
# ---------------------------------------------------------------------------

HF_SHARD_BYTES = 5 * 10 ** 9          # at most 5 GB a safetensors shard
HF_DISK_MARGIN = 1.1                  # free disk needed over the checkpoint
QUANT_BYTES_BAR = {8: 0.62, 4: 0.40}  # JAX's bars against the bf16 tree
FALLBACK_PROMPT, FALLBACK_NEW = 2048, 4


def _hf_llama_tensors(cfg, layers: int):
    """(HF name, native leaf path, layer or None, transposed) of a llama
    checkpoint: the inverse of the llama policy, written out by hand
    (``nn.Linear`` weights are stored ``[out, in]``, the native ``[in, out]``)."""
    per_layer = [("input_layernorm.weight", "attn_norm_scale", False),
                 ("self_attn.q_proj.weight", "wq", True),
                 ("self_attn.k_proj.weight", "wk", True),
                 ("self_attn.v_proj.weight", "wv", True),
                 ("self_attn.o_proj.weight", "wo", True),
                 ("post_attention_layernorm.weight", "mlp_norm_scale", False),
                 ("mlp.gate_proj.weight", "w_gate", True),
                 ("mlp.up_proj.weight", "w_up", True),
                 ("mlp.down_proj.weight", "w_down", True)]
    out = [("model.embed_tokens.weight", ("embed",), None, False)]
    for i in range(layers):
        out += [(f"model.layers.{i}.{name}", ("layers", leaf), i, t)
                for name, leaf, t in per_layer]
    return out + [("model.norm.weight", ("final_norm_scale",), None, False),
                  ("lm_head.weight", ("lm_head",), None, True)]


def _write_safetensors(path: str, named) -> None:
    """A ``.safetensors`` file (8-byte little-endian header length, JSON
    header, raw bytes) of ``named`` = [(name, shape, dtype name, fetch)]:
    each tensor fetched to the host and written in turn."""
    header, offset = {}, 0
    for name, shape, dtype, _ in named:
        nbytes = math.prod(shape) * 2
        header[name] = {"dtype": dtype, "shape": list(shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for _, _, _, fetch in named:
            f.write(fetch().reshape(-1).view(torch.uint8).numpy().data)


def write_hf_llama(root: str, params, cfg, layers: int) -> dict:
    """llama2-7b's bf16 weights as an HF Llama directory: config.json,
    model.safetensors.index.json and shards of at most HF_SHARD_BYTES."""
    def leaf(path):
        node = params
        for k in path:
            node = node[k]
        return node

    def fetch(path, i, t):
        x = leaf(path) if i is None else leaf(path)[i]
        return (x.T if t else x).contiguous().cpu()

    tensors = []
    for name, path, i, t in _hf_llama_tensors(cfg, layers):
        x = leaf(path) if i is None else leaf(path)[i]
        check(x.dtype == torch.bfloat16, f"{name}: {x.dtype}")
        shape = tuple(reversed(x.shape)) if t else tuple(x.shape)
        tensors.append((name, shape, "BF16",
                        (lambda p=path, i=i, t=t: fetch(p, i, t))))
    shards, size = [[]], 0
    for item in tensors:
        nbytes = math.prod(item[1]) * 2
        if shards[-1] and size + nbytes > HF_SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append(item)
        size += nbytes
    weight_map = {}
    for k, shard in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        _write_safetensors(os.path.join(root, fname), shard)
        weight_map.update({name: fname for name, *_ in shard})
    total = sum(math.prod(shape) * 2 for _, shape, _, _ in tensors)
    with open(os.path.join(root, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                   "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": layers, "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.kv_heads,
                   "max_position_embeddings": cfg.max_seq_len,
                   "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
                   "tie_word_embeddings": False, "torch_dtype": "bfloat16"}, f)
    return {"shards": len(shards), "tensors": len(tensors), "gb": total / 1e9}


def rss_anon() -> int:
    """Host anonymous memory of this process (mmap'd file pages, which RSS
    counts, are not in it): ``RssAnon`` of /proc/self/status, or where the
    kernel does not report it, resident minus shared (file-backed and
    shmem) pages of /proc/self/statm."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssAnon:"):
                return int(line.split()[1]) * 1024
    with open("/proc/self/statm") as f:
        _, resident, shared = (int(x) for x in f.read().split()[:3])
    return (resident - shared) * os.sysconf("SC_PAGE_SIZE")


def rss_anon_source() -> str:
    with open("/proc/self/status") as f:
        return ("status RssAnon" if any(line.startswith("RssAnon:") for line in f)
                else "statm resident - shared")


def heap_in_use() -> int:
    """Bytes the C heap has handed out and not taken back (glibc
    ``mallinfo2``: ``uordblks + hblkhd``), where torch's CPU allocator
    takes host tensors: anonymous memory by nature, whatever the kernel
    reports of mapped file pages."""
    import ctypes

    class MallInfo2(ctypes.Structure):
        _fields_ = [(name, ctypes.c_size_t) for name in (
            "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks", "fsmblks",
            "uordblks", "fordblks", "keepcost")]

    libc = ctypes.CDLL("libc.so.6")
    libc.mallinfo2.restype = MallInfo2
    info = libc.mallinfo2()
    return info.uordblks + info.hblkhd


class _PeakHost:
    """The peaks of :func:`rss_anon` and :func:`heap_in_use` while the
    ``with`` block runs (sampled every 2 ms by a thread)."""

    def __enter__(self):
        import threading

        self.base = self.peak = rss_anon()
        self.heap_base = self.heap_peak = heap_in_use()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, rss_anon())
            self.heap_peak = max(self.heap_peak, heap_in_use())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_anon())
        self.heap_peak = max(self.heap_peak, heap_in_use())


def _forward_tokens(cfg, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed + 60)
    return torch.randint(0, cfg.vocab_size, (1, SERVE_SHAPE[1]), generator=gen,
                         device="cuda")


def _same_outputs(a: dict, b: dict) -> bool:
    import numpy as np

    return sorted(a) == sorted(b) and all(np.array_equal(a[r], b[r]) for r in a)


def phase_hf_load(engine, params, seed: int, stream, served) -> dict:
    """llama2-7b written as an HF Llama directory (bf16 safetensors shards),
    then ``init_inference(<dir>)``: every leaf bit-equal to the weights it
    was written from, the S=4096 ``forward`` (K1 once per layer) bit-equal
    to the native engine's, the serving stream token-equal to its serving
    (``served``).  Load seconds, GB/s, host anonymous-memory growth and the
    device's peak are reported.  The depth is cut (never the width) if the
    disk cannot hold the checkpoint."""
    import dataclasses
    import shutil
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.ops.kernels.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention

    cfg = engine.model.config
    root = tempfile.mkdtemp(prefix="ds_port_hf_")
    try:
        free = shutil.disk_usage(root).free
        per_layer = sum(x[0].numel() * 2 for x in params["layers"].values())
        top = sum(x.numel() * 2 for k, x in params.items() if k != "layers")
        layers = cfg.num_layers
        while layers > 1 and HF_DISK_MARGIN * (top + layers * per_layer) > free:
            layers -= 1
        native = engine
        if layers < cfg.num_layers:   # the same weights, cut to the layers written
            native = deepspeed_tpu_torch.init_inference(
                CausalLM(dataclasses.replace(cfg, num_layers=layers)),
                config={"dtype": "bf16"},
                params={**params, "layers": {k: v[:layers]
                                             for k, v in params["layers"].items()}})
        t0 = time.perf_counter()
        written = write_hf_llama(root, params, cfg, layers)
        write_s = time.perf_counter() - t0
        emit({"phase": "hf_write", "dir": root, "free_gb": free / 1e9, "layers": layers,
              "depth_cut": layers < cfg.num_layers, "write_s": write_s, **written})

        free_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dev0 = torch.cuda.memory_allocated()
        with _PeakHost() as host:
            t0 = time.perf_counter()
            hf = deepspeed_tpu_torch.init_inference(root, config={"dtype": "bf16"})
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        loaded_gb = sum(x.numel() * x.element_size() for x in _leaves(hf.params)) / 1e9
        def spelled(c):   # num_kv_heads None means num_heads
            return dataclasses.replace(c, num_kv_heads=c.kv_heads)

        check(spelled(hf.model.config) == spelled(native.model.config),
              f"loaded config {hf.model.config} != {native.model.config}")
        from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

        want = dict(tree_flatten_with_path(native.params))
        got = dict(tree_flatten_with_path(hf.params))
        check(sorted(got) == sorted(want), f"loaded leaves {sorted(got)}")
        differ = [p for p in got if not (
            got[p].dtype == want[p].dtype and got[p].shape == want[p].shape
            and got[p].is_contiguous() and torch.equal(got[p], want[p]))]
        check(not differ, f"loaded leaves differ from the written weights: {differ}")
        rec = {"phase": "hf_load", "layers": layers, "leaves": len(got),
               "load_s": load_s, "gb": loaded_gb, "gb_per_s": loaded_gb / load_s,
               "host_anon_growth_gb": (host.peak - host.base) / 1e9,
               "host_anon_source": rss_anon_source(),
               "host_heap_growth_gb": (host.heap_peak - host.heap_base) / 1e9,
               "device_peak_gb": (torch.cuda.max_memory_allocated() - dev0) / 1e9,
               "leaves_bit_equal": True}

        tokens = _forward_tokens(cfg, seed)
        want_logits = native.forward(tokens)
        reset_counts()
        logits = hf.forward(tokens)
        torch.cuda.synchronize()
        k1 = flash_attention.launches
        check(k1 == layers, f"HF engine forward launched K1 {k1} times, expected {layers}")
        check(torch.equal(logits, want_logits),
              "HF engine logits differ from the native engine's: max |d| "
              f"{(logits.float() - want_logits.float()).abs().max().item()}")
        rec.update(forward_k1_launches=k1, logits_bit_equal=True)
        del logits, want_logits
        free_memory()

        if native is not engine:
            _, served, _ = _serve_once(native, stream, "hf_load_native_cut")
        reset_counts()
        sv, outs, srec = _serve_once(hf, stream, "hf_load")
        k4 = {"counter": decode_attention.launches, "per_tick": sv._exec.graph_k4_launches,
              "ticks": sv._exec.replays}
        check(_same_outputs(outs, served),
              "HF engine served other tokens than the native engine")
        rec.update(serving_tokens_equal=True, k4_launches=k4,
                   mean_decode_tick_ms=srec["mean_decode_tick_ms"],
                   output_tok_per_s=srec["output_tok_per_s"],
                   serving_peak_gb=srec["peak_memory_gb"])
        emit(rec)
        del sv, hf, native
        free_memory()
        return {"k1": k1, "k4": k4}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_quantized(engine, params, seed: int, stream) -> dict:
    """Weight-only int8 and int4 engines over llama2-7b's bf16 weights:
    bytes at rest under JAX's bars, the int8 ``forward`` at S=4096 (K1 once
    per layer) bit-equal to a bf16 engine over ``dequantize_params(q)``
    (the per-layer dequantization is elementwise), and the serving stream
    token-equal to that engine's serving; |dlogits| and top-1 against the
    bf16 weights, forward and tick times beside the dequantized engine's."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.quantization import (dequantize_params,
                                                            tree_nbytes)
    from deepspeed_tpu_torch.ops.kernels.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention

    model, cfg = engine.model, engine.model.config
    bf16_bytes = tree_nbytes(params)
    rec = {"phase": "quantized", "bf16_gb": bf16_bytes / 1e9}
    engines = {}
    for bits, config in ((8, {"dtype": "int8"}),
                         (4, {"dtype": "bf16", "quant": {"enabled": True, "num_bits": 4}})):
        free_memory()
        before = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = deepspeed_tpu_torch.init_inference(model, params=params, config=config)
        torch.cuda.synchronize()
        nbytes = tree_nbytes(eng.params)
        rec[f"int{bits}"] = {"build_s": time.perf_counter() - t0, "gb": nbytes / 1e9,
                             "ratio_to_bf16": nbytes / bf16_bytes,
                             "allocated_gb_after_build": torch.cuda.memory_allocated() / 1e9,
                             "allocated_gb_added": (torch.cuda.memory_allocated()
                                                    - before) / 1e9}
        check(nbytes / bf16_bytes < QUANT_BYTES_BAR[bits],
              f"int{bits} tree is {nbytes / bf16_bytes:.3f} of bf16's "
              f"(bar {QUANT_BYTES_BAR[bits]})")
        engines[bits] = eng
    del engines[4]
    q8 = engines.pop(8)
    free_memory()
    ref = deepspeed_tpu_torch.init_inference(model, params=dequantize_params(q8.params),
                                             config={"dtype": "bf16"})

    tokens = _forward_tokens(cfg, seed)
    reset_counts()
    logits = q8.forward(tokens)
    torch.cuda.synchronize()
    k1 = flash_attention.launches
    check(k1 == cfg.num_layers,
          f"int8 forward launched K1 {k1} times, expected {cfg.num_layers}")
    want = ref.forward(tokens)
    check(torch.equal(logits, want),
          "int8 logits differ from the dequantized bf16 engine's: max |d| "
          f"{(logits.float() - want.float()).abs().max().item()}")
    bf16 = engine.forward(tokens).float()
    d = (logits.float() - bf16).abs()
    top2 = bf16.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > torch.quantile(d.flatten()[::97], 0.99)
    same = logits.argmax(-1) == bf16.argmax(-1)
    rec["forward"] = {
        "k1_launches": k1, "bit_equal_to_dequantized": True,
        "max_abs_dlogits_vs_bf16": d.max().item(),
        "mean_abs_dlogits_vs_bf16": d.mean().item(),
        "top1_vs_bf16": same.float().mean().item(),
        "decisive_positions": int(decisive.sum()),
        "top1_vs_bf16_decisive": same[decisive].float().mean().item(),
        # in turns: dequantized, int8, int8, dequantized
        "ms": None, "dequantized_bf16_ms": None}
    del logits, want, bf16, d, top2
    free_memory()
    times = {"q": [], "ref": []}
    for name in ("ref", "q", "q", "ref"):
        eng = q8 if name == "q" else ref
        times[name].append(time_ms(lambda: eng.forward(tokens), reps=5, warmup=1))
    rec["forward"]["ms"] = statistics.mean(times["q"])
    rec["forward"]["dequantized_bf16_ms"] = statistics.mean(times["ref"])
    free_memory()

    runs = {}
    for name, eng in (("int8", q8), ("dequantized_bf16", ref)):
        free_memory()
        base = torch.cuda.memory_allocated()
        reset_counts()
        sv, outs, srec = _serve_once(eng, stream, f"quantized_{name}")
        runs[name] = {"outs": outs, "k4": {"counter": decode_attention.launches,
                                           "per_tick": sv._exec.graph_k4_launches,
                                           "ticks": sv._exec.replays},
                      "mean_decode_tick_ms": srec["mean_decode_tick_ms"],
                      "median_decode_tick_ms": srec["median_decode_tick_ms"],
                      "output_tok_per_s": srec["output_tok_per_s"],
                      "peak_gb": srec["peak_memory_gb"],
                      "serving_added_peak_gb": srec["peak_memory_gb"] - base / 1e9}
        del sv
    check(_same_outputs(runs["int8"]["outs"], runs["dequantized_bf16"]["outs"]),
          "int8 serving differs from the dequantized bf16 engine's serving")
    rec["serving"] = {name: {k: v for k, v in r.items() if k != "outs"}
                      for name, r in runs.items()}
    rec["serving"]["tokens_equal"] = True
    emit(rec)
    del q8, ref, runs
    free_memory()
    return {"k1": k1, "k4": rec["serving"]["int8"]["k4"]}


def phase_generate_fallback(engine, params, seed: int) -> dict:
    """``generate`` through the full-recompute fallback: an engine over
    llama2-7b's ``apply_fn`` alone (no KV cache), a 2048-token prompt and 4
    new tokens, so every bucketed forward (S 2048, then 4096, and the
    causality probe's second 4096) takes K1 once per layer.  Tokens
    against the cached ``generate``'s are reported (the two paths round
    attention differently in bf16)."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention

    model, cfg = engine.model, engine.model.config
    runs = [0]

    def apply_fn(p, tokens, *args, **kwargs):
        runs[0] += 1
        return model.apply_fn(p, tokens, *args, **kwargs)

    fb = deepspeed_tpu_torch.init_inference(apply_fn=apply_fn, params=params,
                                            config={"dtype": "bf16"})
    check(fb.model is None, "the fallback engine has a KV-cache model")
    prompt = np.random.default_rng(seed + 61).integers(
        0, cfg.vocab_size, (1, FALLBACK_PROMPT)).astype(np.int32)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fb.generate(prompt, max_new_tokens=FALLBACK_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    k1 = flash_attention.launches
    check(runs[0] >= FALLBACK_NEW and k1 == cfg.num_layers * runs[0],
          f"fallback: K1 launched {k1} times over {runs[0]} forwards, expected "
          f"{cfg.num_layers} per forward")
    check(fb._uncached_causal is True, "the causality probe judged llama2-7b non-causal")
    check(tuple(out.shape) == (1, FALLBACK_PROMPT + FALLBACK_NEW), f"shape {out.shape}")
    # the first forward is the native engine's forward of the prompt, bit
    # for bit (S=2048 is its own bucket)
    first = int(engine.forward(prompt)[0, -1].argmax())
    check(int(out[0, FALLBACK_PROMPT]) == first,
          f"fallback's first token {int(out[0, FALLBACK_PROMPT])} != the argmax of "
          f"the engine's forward ({first})")
    cached = engine.generate(prompt, max_new_tokens=FALLBACK_NEW)
    new, ref = out[0, FALLBACK_PROMPT:].cpu(), cached[0, FALLBACK_PROMPT:].cpu()
    # both generates attend to the prompt through K1: the cached one's
    # dense prefill is held against the masked branch on the same prompt
    dense = _dense_prefill_check(cfg, params, torch.from_numpy(prompt).to("cuda"))
    rec = {"phase": "generate_fallback", "prompt": FALLBACK_PROMPT,
           "new_tokens": FALLBACK_NEW, "forward_runs": runs[0], "k1_launches": k1,
           "k1_per_forward": k1 / runs[0], "probe_causal": True, "seconds": gen_s,
           "seconds_per_token": gen_s / FALLBACK_NEW,
           "first_token_equal_to_forward_argmax": True,
           "tokens_equal_to_cached": int((new == ref).sum()),
           "first_token_equal_to_cached": bool(new[0] == ref[0]),
           "dense_prefill": dense}
    emit(rec)
    del fb
    free_memory()
    return {"k1": k1, "forward_runs": runs[0]}


def profile_serving(sv, stream) -> None:
    """10 warm decode ticks of a full slot fleet under torch.profiler: the
    device's busy share, K4's share and launches (32 per tick), top kernels."""
    from torch.profiler import ProfilerActivity, profile
    import dataclasses

    reqs = [dataclasses.replace(r, rid=f"p{r.rid}", max_new_tokens=64)
            for r in stream[:SERVE_SLOTS]]
    for r in reqs:
        sv.submit(r)
    sv.step()                      # admits all 8 (prefill) and decodes once
    sv.step()
    check(int(sv._active.sum()) == SERVE_SLOTS and not sv._queue,
          "profile: the slot fleet is not full")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            sv.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sv.run([])
    busy_us, by_name = device_activity(prof.events())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    k4 = [(t, n) for name, (t, n) in by_name.items() if "decode_attention" in name]
    k4_ms, k4_n = sum(t for t, _ in k4) / 1e3, sum(n for _, n in k4)
    emit({"phase": "profile", "what": "serving_10_decode_ticks", "wall_ms": wall_ms,
          "device_busy_ms": busy_us / 1e3, "device_busy_share": busy_us / 1e3 / wall_ms,
          "k4_ms": k4_ms, "k4_launches": k4_n, "k4_share_of_wall": k4_ms / wall_ms,
          "top_kernels": [{"name": name[:90], "ms": t / 1e3, "count": n}
                          for name, (t, n) in top[:12]]})
    check(k4_n == 10 * sv._exec.graph_k4_launches,
          f"profiler counts {k4_n} K4 launches in 10 ticks, expected "
          f"{10 * sv._exec.graph_k4_launches}")


# ---------------------------------------------------------------------------
# --ab: variants of K1, of K2/K3 or of K4, side by side (a redesign's steps)
# ---------------------------------------------------------------------------

# K1 shapes of the A/B timing: the two main paths' and the full-attention
# training shape; the masked main case is timed beside TRAIN_SHAPE
AB_SHAPES = [TRAIN_SHAPE, SERVE_SHAPE, TRAIN_SHAPE[:-1] + (False,)]
# K2/K3: the training shape, full attention at its length, GQA and the
# fp32 kernels' record shape; the masked main case beside TRAIN_SHAPE
AB_BWD_SHAPES = [TRAIN_SHAPE, TRAIN_SHAPE[:-1] + (False,),
                 (2, 2048, 32, 8, 128, torch.bfloat16, True), FP32_BWD_SHAPE]
AB_SOURCES = {"fwd": "flash_attention_fwd.cu", "bwd": "flash_attention_bwd.cu",
              "decode": "decode_attention.cu"}
AB_REPO = {"repo": "fwd", "repo-bwd": "bwd", "repo-decode": "decode"}


def _ab_kind(path: str) -> str:
    """``fwd``, ``bwd`` or ``decode``: ``repo``, ``repo-bwd`` and
    ``repo-decode`` are the checkout's forward, backward and decode
    sources, a copy is told by its entry points."""
    if path in AB_REPO:
        return AB_REPO[path]
    text = (Path(ROOT) / path).read_text()
    if "ds_decode_attention" in text:
        return "decode"
    return "bwd" if "ds_flash_attention_bwd_dq" in text else "fwd"


def _ab_builders(specs):
    """(kind, {name: KernelBuilder}) of ``name=path`` specs, all copies of
    one source (path from the repo root; ``repo`` / ``repo-bwd`` for the
    checkout's own; ``repo-decode`` for K4's), built with the same flags and
    headers.  A copy's own
    directory comes first on its include path, so an older source can keep
    the header it had beside it."""
    from deepspeed_tpu_torch.ops.op_builder import KernelBuilder

    kinds, out = set(), {}
    for spec in specs:
        name, path = spec.split("=", 1)
        kind = _ab_kind(path)
        kinds.add(kind)
        b = KernelBuilder(f"{Path(AB_SOURCES[kind]).stem}_{name}", AB_SOURCES[kind])
        if path not in AB_REPO:
            b.source = Path(ROOT) / path
        out[name] = b
    if len(kinds) != 1:
        raise ValueError(f"--ab compares copies of one source, got {sorted(kinds)}")
    return kinds.pop(), out


def _ab_use(kind, builder) -> None:
    from deepspeed_tpu_torch.ops.kernels import decode_attention as da
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    if kind == "decode":
        da._BUILDER = builder
    elif kind == "fwd":
        fa._FWD_BUILDER = builder
    else:
        fa._BWD_BUILDER = builder


def _ab_masked_ok(kind, builder) -> bool:
    """Whether a variant walks the tiles of the wrapper's tables: an older
    tiling would read them wrongly, so its masked mode is neither checked
    nor timed."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    c = {m[1]: int(m[2]) for m in re.finditer(
        r"^constexpr int (\w+) = (\d+);", builder.source.read_text(), re.MULTILINE)}
    if kind == "fwd":
        return fa._TILES["fwd"] == (c.get("BLOCK_M"), c.get("BLOCK_N"))
    return (fa._TILES["q"] == (c.get("DQ_BLOCK_M"), c.get("DQ_BLOCK_N"))
            and fa._TILES["kv"] == (c.get("DKV_BLOCK_N"), c.get("DKV_BLOCK_M")))


def _ab_takes_fp32(builder) -> bool:
    """Whether a backward source has the fp32 kernels (an older one refuses
    fp32 inputs)."""
    return "flash_bwd_dq_fp32_kernel" in builder.source.read_text()


def ab_check(specs, name) -> int:
    """The child of ``ab``: one variant against the plain versions at the
    first-launch shapes, GQA 32/8 over two batches (hd 64/128, bf16/fp16,
    causal and full), the dead-rows mask and random masks of 32- and
    64-blocks.  A backward variant runs on the checkout's K1; the fp32
    cases are skipped for a source without fp32 kernels (an older one)."""
    import numpy as np

    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    kind, builders = _ab_builders(specs)
    _ab_use(kind, builders[name])
    if kind == "decode":
        return _ab_check_decode(name)
    masked_ok = _ab_masked_ok(kind, builders[name])
    fp32_ok = kind == "fwd" or _ab_takes_fp32(builders[name])
    S1 = 1024
    rng = np.random.default_rng(0)
    masks = [dead_rows_mask(2048)] + [rng.random((S1 // b, S1 // b)) < 0.5 for b in (32, 64)]
    cases = [(shape, None) for shape in FIRST_LAUNCH_SHAPES[:-1]]
    cases += [((2, 1024, 32, 8, hd, dt, c), None) for hd in (64, 128)
              for dt in (torch.bfloat16, torch.float16) for c in (True, False)]
    if masked_ok:
        cases += [((1, 2048, 8, 8, 128, torch.bfloat16, True), masks[0])]
        cases += [((2, S1, 8, 2, hd, torch.bfloat16, c), m) for m in masks[1:]
                  for hd in (64, 128) for c in (True, False)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for shape, mask in cases:
        B, S, Hq, Hkv, hd, dtype, causal = shape
        q, k, v, do = _inputs(gen, shape, 4)
        scale = hd ** -0.5
        keep = fa.attended(S, causal, mask, "cuda")
        dead_q = None if mask is None else ~keep.any(-1)
        dead_k = None if mask is None else ~keep.any(0)
        rec = {"ab_check": name, "shape": _shape_dict(shape, None),
               "mask": None if mask is None else list(mask.shape)}
        if dtype == torch.float32 and not fp32_ok:
            emit({**rec, "skipped": "this source has no fp32 backward kernels"})
            continue
        with torch.inference_mode():
            out, lse = fa._forward(q, k, v, causal, scale, mask)
            torch.cuda.synchronize()
            if kind == "fwd":
                ref, ref_lse = fa.flash_attention_reference(q, k, v, causal, scale,
                                                            True, mask)
                agree = {"out": agreement(out, ref, AGREE_TOL["fwd"][dtype], dead=dead_q)}
                rec["lse_max_abs_err"] = (lse - ref_lse).abs().max().item()
                good = rec["lse_max_abs_err"] <= LSE_ATOL
            else:
                delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
                args = (q, k, v, do, lse, delta, causal, scale, mask)
                dq = fa.flash_attention_bwd_dq(*args)
                dk, dv = fa.flash_attention_bwd_dkv(*args)
                torch.cuda.synchronize()
                rk, rv = fa.flash_attention_bwd_dkv_reference(*args)
                tol = AGREE_TOL["bwd"][dtype]
                agree = {"dq": agreement(dq, fa.flash_attention_bwd_dq_reference(*args),
                                         tol, dead=dead_q),
                         "dk": agreement(dk, rk, tol, dead=dead_k),
                         "dv": agreement(dv, rv, tol, dead=dead_k)}
                good = True
        good = good and all(a["ok"] for a in agree.values())
        ok &= good
        emit({**rec, "ok": good,
              "worst_tile_rel_l2": {n: a["worst_tile_rel_l2"] for n, a in agree.items()}})
    return 0 if ok else 1


def _ab_decode_cases():
    """(label, case, int8) of the K4 A/B: every DECODE_CASES entry, then the
    int8 mode at DECODE_INT8_CASES."""
    out = [(c[0], c, False) for c in DECODE_CASES]
    return out + [(f"{c[0]}-int8", c, True) for c in DECODE_CASES
                  if c[0] in DECODE_INT8_CASES]


def _ab_decode_inputs(gen, case, int8):
    """One case's K4 inputs: ``(q, k, v, mask, table, scales, kd, vd)``,
    the pools quantized as the int8 store does with ``int8`` (``kd``/``vd``
    their dequantized copies, for the yardstick and the library)."""
    q, k, v, mask, table = _decode_case(gen, case, decode_lengths(case, 0))
    if not int8:
        return q, k, v, mask, table, {}, k, v
    k8, v8, ks, vs = quantize_pools(k, v)
    kd = (k8.float() * ks[..., None, None]).to(q.dtype)
    vd = (v8.float() * vs[..., None, None]).to(q.dtype)
    return q, k8, v8, mask, table, {"k_scale": ks, "v_scale": vs}, kd, vd


def _ab_check_decode(name) -> int:
    """A K4 variant against the plain version at every DECODE_CASES entry
    and, in its int8 mode, at DECODE_INT8_CASES (the gate of phase
    ``kernel``, yardsticks included)."""
    from deepspeed_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for label, case, int8 in _ab_decode_cases():
        _, B, Hq, Hkv, hd, dtype, page, maxp = case
        q, k, v, mask, table, sc, kd, vd = _ab_decode_inputs(gen, case, int8)
        with torch.inference_mode():
            out = decode_attention(q, k, v, mask, table, **sc)
            torch.cuda.synchronize()
            agree = decode_compare(out, decode_attention_reference(q, k, v, mask, table,
                                                                   **sc),
                                   decode_low_precision(q, kd, vd, mask, table), Hq // Hkv,
                                   DECODE_TOL[dtype])
        good = agree["ok"] and agree["yardsticks_rejected"]
        ok &= good
        emit({"ab_check": name, "case": label, "ok": good,
              "worst_row_rel_l2": agree["worst_tile_rel_l2"],
              "max_abs_err": agree["max_abs_err"]})
        del q, k, v, mask, table, out, sc, kd, vd
        free_memory()
    return 0 if ok else 1


def _ab_time_decode(builders, gen) -> None:
    """K4 variants in turns (A B .. B A) at every DECODE_CASES entry and, in
    the int8 mode, at DECODE_INT8_CASES, the L2 flushed before each call,
    SDPA beside them (over the dequantized cache for int8)."""
    import numpy as np
    from deepspeed_tpu_torch.ops.kernels.decode_attention import decode_attention

    flush = l2_flush()
    order = list(builders) + list(builders)[::-1]
    for label, case, int8 in _ab_decode_cases():
        lengths = decode_lengths(case, 0)
        q, k, v, mask, table, sc, kd, vd = _ab_decode_inputs(gen, case, int8)
        ms = {n: [] for n in builders}
        with torch.inference_mode():
            for name in order:
                _ab_use("decode", builders[name])
                ms[name].append(time_ms(lambda: decode_attention(q, k, v, mask, table,
                                                                 **sc), flush=flush))
            library_ms = decode_sdpa_ms(q, kd, vd, mask, table, flush)
        bound, bound_by = decode_bound_ms(case, lengths, int8=int8)
        emit({"phase": "ab_time_decode", "case": label, "l2": "flushed", "ms": ms,
              "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by,
              "bound_share": {n: bound / float(np.mean(t)) for n, t in ms.items()},
              "ratio_to_library": {n: float(np.mean(t)) / library_ms
                                   for n, t in ms.items()}})
        del q, k, v, mask, table, sc, kd, vd
        free_memory()


def _ab_serve_decode(builders, seed: int) -> None:
    """The paged serving stream on llama2-7b (random bf16 weights from the
    seed) with each K4 variant in turns (A B .. B A), with bf16 pages and
    with int8 pages: each run's fresh ServingEngine captures its decode
    graph with that variant; the records and checks of phase
    ``paged_serving``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    model = CausalLM("llama2-7b")
    params = model.init_fn(torch.Generator(device="cuda").manual_seed(seed),
                           device="cuda", dtype=torch.bfloat16)
    engine = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"},
                                                params=params)
    stream = serving_stream(seed, model.config.vocab_size)
    for kv_dtype in (None, "int8"):
        runs = {n: [] for n in builders}
        for name in list(builders) + list(builders)[::-1]:
            _ab_use("decode", builders[name])
            sv, _, rec = _serve_once(engine, stream, name, kv_dtype=kv_dtype)
            runs[name].append({key: rec[key] for key in (
                "median_decode_tick_ms", "mean_decode_tick_ms", "output_tok_per_s",
                "decode_ticks", "ttft_p50_s")})
            del sv
            free_memory()
        emit({"phase": "ab_serve_decode", "model": "llama2-7b",
              "kv_dtype": kv_dtype or "bf16", "runs": runs})


def _ab_time_fwd(builders, gen, sa, shape):
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    causal = shape[-1]
    q, k, v = _inputs(gen, shape, 3)
    order = list(builders) + list(builders)[::-1]
    ms, masked = {n: [] for n in builders}, {n: [] for n in builders}
    with torch.inference_mode():
        for name in order:
            _ab_use("fwd", builders[name])
            ms[name].append(time_ms(lambda: fa.flash_attention(q, k, v, causal=causal)))
            if shape == TRAIN_SHAPE and _ab_masked_ok("fwd", builders[name]):
                masked[name].append(time_ms(lambda: sa(q, k, v)))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=shape[2] != shape[3]))
    flops = attention_flops(*shape)
    return ms, masked, library_ms, flops


def _ab_time_bwd(builders, gen, sa, shape):
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    B, S, Hq, Hkv, hd, dtype, causal = shape
    scale = hd ** -0.5
    q, k, v, do = _inputs(gen, shape, 4)
    masks = [None]
    if shape == TRAIN_SHAPE:
        masks.append(fa._as_block_mask(sa.layout(S), S))
    res = {}
    with torch.inference_mode():
        for mask in masks:
            out, lse = fa._forward(q, k, v, causal, scale, mask)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            args = (q, k, v, do, lse, delta, causal, scale, mask)
            del out
            names = [n for n in builders
                     if mask is None or _ab_masked_ok("bwd", builders[n])]
            if dtype == torch.float32:
                names = [n for n in names if _ab_takes_fp32(builders[n])]
            ms = {n: {"K2": [], "K3": []} for n in names}
            for name in names + names[::-1]:
                _ab_use("bwd", builders[name])
                ms[name]["K2"].append(time_ms(lambda: fa.flash_attention_bwd_dq(*args)))
                ms[name]["K3"].append(time_ms(lambda: fa.flash_attention_bwd_dkv(*args)))
            res["unmasked" if mask is None else "masked_fixed_740m"] = ms
            del lse, delta, args
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=Hq != Hkv)
    library_ms = time_ms(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    bounds = {key: attention_bound_ms(*shape, kernel=key)[0] for key in ("dq", "dkv")}
    return res, library_ms, bounds


def ab(specs, unchecked: bool = False) -> int:
    """Build every variant (in parallel; ptxas registers, spills and
    warnings), check each in a child with the first-launch time limit, then
    time them in turns (A B .. B A) in this process: K1 variants at
    AB_SHAPES with SDPA's forward beside them, K2/K3 variants at
    AB_BWD_SHAPES with SDPA's backward (dq, dk, dv in one call), K4
    variants at DECODE_CASES with SDPA (``_ab_time_decode``) and then on
    the paged serving stream (``_ab_serve_decode``).  ``unchecked``: no
    checks and no serving, for diagnostic copies that skip work on
    purpose (their outputs are wrong)."""
    import numpy as np

    kind, builders = _ab_builders(specs)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        list(pool.map(lambda b: b.load(), builders.values()))
    emit({"phase": "ab_build", "kind": kind, "seconds": time.perf_counter() - t0,
          "ptxas": {n: ptxas_report(b.log) for n, b in builders.items()}})
    failed = {}
    for name in [] if unchecked else list(builders):
        try:
            res = _child(["--ab-check", name, *specs], FIRST_LAUNCH_TIMEOUT_S,
                         f"variant {name}'s checks")
            print(res.stdout, end="", flush=True)
            if res.returncode:
                failed[name] = res.stderr[-4000:]
        except RuntimeError as e:   # a hang: the child was killed
            failed[name] = str(e)
        if name in failed:
            emit({"phase": "ab_check_failed", "variant": name, "error": failed[name]})
            del builders[name]
    gen = torch.Generator(device="cuda").manual_seed(0)
    if kind == "decode":
        _ab_time_decode(builders, gen)
        if not unchecked:
            _ab_serve_decode(builders, 0)
        return 1 if failed else 0
    sa, _, _, _ = _sparse_case(TRAIN_SHAPE[1], SPARSE_CASES[0][2])
    if kind == "fwd":
        for shape in AB_SHAPES:
            ms, masked, library_ms, flops = _ab_time_fwd(builders, gen, sa, shape)
            rec = {"phase": "ab_time", "shape": _shape_dict(shape, None), "ms": ms,
                   "library_ms": library_ms,
                   "ratio_to_library": {n: float(np.mean(t)) / library_ms
                                        for n, t in ms.items()},
                   "tflops": {n: flops / float(np.mean(t)) / 1e9 for n, t in ms.items()}}
            if shape == TRAIN_SHAPE:
                rec["masked_fixed_740m_ms"] = masked
            emit(rec)
            free_memory()
    else:
        for shape in AB_BWD_SHAPES:
            res, library_ms, bounds = _ab_time_bwd(builders, gen, sa, shape)
            un = res["unmasked"]
            emit({"phase": "ab_time_bwd", "shape": _shape_dict(shape, None), "ms": res,
                  "library_ms": library_ms, "bound_ms": bounds,
                  "pair_ms": {n: float(np.mean(t["K2"]) + np.mean(t["K3"]))
                              for n, t in un.items()},
                  "ratio_to_library": {n: float(np.mean(t["K2"]) + np.mean(t["K3"]))
                                       / library_ms for n, t in un.items()},
                  "bound_share": {n: {"K2": bounds["dq"] / float(np.mean(t["K2"])),
                                      "K3": bounds["dkv"] / float(np.mean(t["K3"]))}
                                  for n, t in un.items()}})
            free_memory()
    return 1 if failed else 0


# ---------------------------------------------------------------------------
# MoE and pipeline parallelism (ROADMAP queue 1, item 9)
# ---------------------------------------------------------------------------

MOE_MODEL = "mixtral-8x7b"      # Mixtral-8x7B's published widths (32 layers)
# Depth is cut, never width: 16 of 32 layers in bf16 is ~47 GB; the fp32
# reference the served tokens are held to runs at MOE_FP32_LAYERS (fp32
# ~24 GB beside the bf16 engine's ~12 GB), as cmp_70b8 did for llama2-70b
MOE_SERVE_LAYERS, MOE_FP32_LAYERS = 16, 4
MOE_TRAIN_LAYERS, MOE_TRAIN_S = 2, 4096
# a PR-MoE pyramid at llama-740m's widths: dense, 4-expert, 8-expert layers
PRMOE_EXPERTS = (1,) * 8 + (4,) * 4 + (8,) * 4
# llama-740m over 4 virtual stages of 4 layers, 8 microbatches, in one
# process, against the un-pipelined engine at gas=8 on the same 8 rows.
# The same kernels run on the same rows in both; a microbatch's objective
# is the un-pipelined one over 8 (a power of two: exact in bf16), and each
# backward's gradients are banked at the same dtype in the same order, so
# the two differ only where fp32 sums of the loss run in another order:
# a loss and a gradient norm within these of the un-pipelined run's
PIPE_STAGES, PIPE_MICRO, PIPE_S, PIPE_STEPS = 4, 8, 4096, 2
PIPE_LOSS_RTOL, PIPE_NORM_RTOL = 1e-5, 1e-4
# the 4-card configurations (``--tp-cards-only``): Mixtral's widths at 8
# layers over ep=4 (the capacity path: the buffers exchanged over
# 'expert') against ZeRO-3 dp=4, and llama2-7b over pp=4 (GPipe and 1F1B,
# M=4) against ZeRO-3 dp=4, on the same cards, rows and weights
MOE_CARD_LAYERS = 8
PP_CARD_MODEL, PP_CARD_S = "llama2-7b", 4096


def _moe_params(layers: int, seed: int, device="cuda"):
    """Mixtral's widths at ``layers`` layers: the model and its bf16
    weights, the layer-streamed init of the seed (each layer of each leaf
    drawn on its own; ``w_gate`` is layers x 8 x 4096 x 14336)."""
    from deepspeed_tpu_torch.models import CausalLM

    model = CausalLM(MOE_MODEL, num_layers=layers, max_seq_len=SERVE_MAX_LEN)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_fn(gen, device="cuda", dtype=torch.bfloat16, tp=(0, 1),
                           streamed=True)
    if device != "cuda":
        from deepspeed_tpu_torch.utils.tree import tree_map

        params = tree_map(lambda x: x.to(device), params)
        free_memory()
    return model, params


def _moe_engine(model, params):
    import deepspeed_tpu_torch

    return deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"},
                                              params=params)


def phase_moe_serving(seed: int) -> dict:
    """Mixtral's widths through ``init_inference`` -> ``forward`` (S=4096,
    K1 once a layer) and the paged stream of phase ``paged_serving`` (24
    requests, 8 slots, 128-token pages; the no-drop MoE of the decode tick
    in its static form inside the one captured graph, K4 once a layer),
    at MOE_SERVE_LAYERS layers; first the served greedy tokens at
    MOE_FP32_LAYERS layers against an fp32 engine on the same weights
    (decisive positions).  Returns the launches for the kernels line."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.models import transformer as ttf
    from deepspeed_tpu_torch.ops.kernels.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention

    from deepspeed_tpu_torch.models import get_config

    t0 = time.perf_counter()
    stream = serving_stream(seed, get_config(MOE_MODEL).vocab_size)
    model, params = _moe_params(MOE_FP32_LAYERS, seed)
    engine = _moe_engine(model, params)
    sv, outs, rec4 = _serve_once(engine, stream, f"moe_{MOE_FP32_LAYERS}_layers")
    sv.close()
    del sv
    f32 = deepspeed_tpu_torch.init_inference(
        CausalLM(MOE_MODEL, num_layers=MOE_FP32_LAYERS, max_seq_len=SERVE_MAX_LEN,
                 attn_impl="xla", dtype=torch.float32),
        config={"dtype": "fp32"}, params=params)
    cmp = greedy_vs_fp32(engine, f32, stream, outs, moe_layers=MOE_FP32_LAYERS)
    emit({"phase": "moe_serving_fp32", "model": MOE_MODEL, "layers": MOE_FP32_LAYERS,
          **cmp, "median_decode_tick_ms": rec4["median_decode_tick_ms"],
          "nvidia_smi": nvidia_smi_line()})
    check_greedy_vs_fp32(cmp, "moe_serving")
    del f32, engine, params, model, outs
    free_memory()

    t1 = time.perf_counter()
    model, params = _moe_params(MOE_SERVE_LAYERS, seed)
    engine = _moe_engine(model, params)
    cfg = model.config
    L = cfg.num_layers
    init_s = time.perf_counter() - t1
    weights_gb = torch.cuda.memory_allocated() / 1e9
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    S = SERVE_SHAPE[1]
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device="cuda")
    # the forward: counts to 0 just before, read just after
    reset_counts()
    logits = engine.forward(tokens)
    torch.cuda.synchronize()
    k1_forward = flash_attention.launches
    check(k1_forward == L, f"the MoE forward launched K1 {k1_forward} times, "
                           f"expected one per layer ({L})")
    check(tuple(logits.shape) == (1, S, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "MoE forward logits")
    del logits
    t2 = time.perf_counter()
    engine.forward(tokens)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t2
    # the serving stream: counts to 0 just before, read just after
    reset_counts()
    sv, outs, rec = _serve_once(engine, stream, "moe_serving")
    k4 = {"counter": decode_attention.launches, "per_tick": sv._exec.graph_k4_launches,
          "ticks": sv._exec.replays, "replayed": sv._exec.graph_k4_launches * sv._exec.replays}
    check(k4["counter"] > 0 and k4["per_tick"] == L,
          f"the MoE serving path's K4 launches: {k4}")
    sv.close()
    del sv
    # the expert FFN's share of a tick: one layer's MoE MLP at the tick's
    # shape captured in a CUDA graph as the tick captures it, its replay
    # timed alone (CUDA events), times the layers, over the tick
    lp = ttf._layer(params, 0)
    h = torch.randn(SERVE_SLOTS, 1, cfg.hidden_size, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ttf._moe_mlp(cfg, lp, h, None)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            ttf._moe_mlp(cfg, lp, h, None)
        moe_ms = time_ms(graph.replay, reps=10)
    del graph
    expert_bytes = 3 * cfg.hidden_size * cfg.intermediate_size * cfg.num_experts * 2
    out = {"phase": "moe_serving", "model": MOE_MODEL, "layers": L,
           "layers_published": 32, "params": cfg.param_count, "weights_gb": weights_gb,
           "init_s": init_s, "moe_drop_tokens": cfg.moe_drop_tokens,
           "forward_S": S, "forward_s": forward_s, "prefill_tok_per_s": S / forward_s,
           "k1_launches_forward": k1_forward,
           "median_decode_tick_ms": rec["median_decode_tick_ms"],
           "mean_decode_tick_ms": rec["mean_decode_tick_ms"],
           "output_tok_per_s": rec["output_tok_per_s"], "ttft_p50_s": rec["ttft_p50_s"],
           "ttft_p99_s": rec["ttft_p99_s"], "decode_ticks": rec["decode_ticks"],
           "graph_captures": rec["graph_captures"], "k4": k4,
           "moe_mlp_ms_per_layer_at_tick_shape": moe_ms,
           "expert_ffn_share_of_tick": L * moe_ms / rec["median_decode_tick_ms"],
           "expert_bytes_per_layer_gb": expert_bytes / 1e9,
           "expert_read_bound_ms_per_tick": L * expert_bytes / PEAK_BYTES_PER_S * 1e3,
           "peak_memory_gb": rec["peak_memory_gb"], "fp32_check": cmp,
           "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi_line()}
    emit(out)
    del engine, params, model, tokens, lp, h
    free_memory()
    return {"k1_forward": k1_forward, "k4": k4}


def _moe_train_step_record(engine, batch, per_step, label) -> dict:
    """MOE train steps with K1-K3 launches checked: losses, step times,
    gradient norms."""
    losses, step_s, norms = [], [], []
    for _ in range(ZERO_STEPS):
        before = kernel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        norms.append(engine.get_global_grad_norm())
        got = tuple(a - b for a, b in zip(kernel_counts(), before))
        check(got == per_step, f"{label}: a step launched K1/K2/K3 {got} times, "
                               f"expected {per_step}")
    return {"losses": losses, "step_s": step_s, "grad_norms": norms,
            "median_step_s": statistics.median(step_s[1:])}


def phase_moe_train(seed: int) -> dict:
    """Mixtral's widths at MOE_TRAIN_LAYERS layers through ``initialize`` ->
    ``train_batch`` (S=4096, micro batch 1, bf16 over fp32 masters, AdamW;
    the one-device engine's update a leaf at a time keeps its 3.2B
    parameters' step within the card),
    on the capacity path (factor 1.25) and the no-drop path: K1 2L, K2/K3
    L a step, the loss carrying the aux term, finite and falling; the
    capacity run again under a mesh whose expert axis is 1 at NCCL world 1,
    bit-equal; then a PR-MoE pyramid at llama-740m's widths through forward
    and backward.  Returns the launches for the kernels line."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    S, Lm = MOE_TRAIN_S, MOE_TRAIN_LAYERS
    per_step = (2 * Lm, Lm, Lm)
    out, ref = {}, None
    for path, drop in (("capacity", True), ("nodrop", False)):
        t1 = time.perf_counter()
        model, engine = _train_engine(seed, S, name=MOE_MODEL, num_layers=Lm,
                                      moe_drop_tokens=drop)
        cfg = model.config
        init_s = time.perf_counter() - t1
        batch = _train_batch(cfg, S, seed + 1)
        with torch.no_grad():
            total, count, aux = model.loss_terms(engine.get_params(), batch)
        # the path: counts to 0 just before, read just after
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        rec = _moe_train_step_record(engine, batch, per_step, f"moe_train {path}")
        rec.update(path=path, init_s=init_s, params=cfg.param_count,
                   launches=dict(zip(("K1", "K2", "K3"), kernel_counts())),
                   aux_term_first=float(aux), ce_first=float(total / count),
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   tokens_per_s=S / rec["median_step_s"])
        check(all(math.isfinite(x) for x in rec["losses"]), f"non-finite MoE loss: {rec}")
        check(rec["losses"][-1] < rec["losses"][0], f"MoE loss did not fall: {rec}")
        check(float(aux) > 0 and abs(rec["losses"][0] - float(total / count) - float(aux))
              <= 1e-3 * rec["losses"][0], f"the MoE loss lacks its aux term: {rec}")
        if drop:
            ref = {"losses": rec["losses"], "norms": rec["grad_norms"],
                   "masters": [m.detach().cpu() for m in tree_leaves(
                       engine.state.master_params)]}
        out[path] = rec
        del engine, model, batch
        free_memory()
    # the capacity run under a mesh (expert axis 1) at NCCL world 1
    comm.init_distributed(init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                          world_size=1, verbose=False)
    try:
        model, engine = _train_engine(seed, S, name=MOE_MODEL, num_layers=Lm,
                                      moe_drop_tokens=True, mesh=MeshLayout(ep=1))
        check(engine.ep == 1 and engine.partition is not None,
              "the mesh engine is not data-parallel")
        batch = _train_batch(model.config, S, seed + 1)
        torch.cuda.reset_peak_memory_stats()
        rec = _moe_train_step_record(engine, batch, per_step, "moe_train ep=1")
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        same = (rec["losses"] == ref["losses"] and rec["grad_norms"] == ref["norms"]
                and all(torch.equal(m.cpu(), r) for m, r in zip(
                    tree_leaves(engine.state.master_params), ref["masters"])))
        out["ep1_mesh"] = {**rec, "bit_equal": same,
                           "expert_leaf_zero_axes": sorted({
                               z for z, e in zip(engine.partition.zaxes,
                                                 engine.partition.edims)
                               if e is not None})}
        check(same, f"the expert-axis-1 mesh run differs from one device: {rec}")
        del engine, model, batch
    finally:
        comm.destroy_process_group()
    del ref
    free_memory()
    # the PR-MoE pyramid: forward and backward
    model = CausalLM(TRAIN_MODEL, num_experts=PRMOE_EXPERTS, moe_use_residual=True,
                     scan_layers=False, max_seq_len=S)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_fn(gen, device="cuda", dtype=torch.bfloat16)
    work = tree_map(lambda x: x.requires_grad_(), params)
    batch = _train_batch(model.config, S, seed + 1)
    L = model.config.num_layers
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss = model.loss_fn(work, batch)
    loss.backward()
    torch.cuda.synchronize()
    pyramid_s = time.perf_counter() - t1
    pyramid = dict(zip(("K1", "K2", "K3"), kernel_counts()))
    check(tuple(pyramid.values()) == (2 * L, L, L),
          f"the PR-MoE pyramid launched K1/K2/K3 {pyramid}")
    grads_ok = all(bool(torch.isfinite(work["layers"][i][k].grad).all())
                   and float(work["layers"][i][k].grad.abs().sum()) > 0
                   for i, k in ((0, "w_gate"), (8, "router"), (15, "router"),
                                (15, "coefficient"), (15, "res_w_down")))
    check(math.isfinite(float(loss.detach())) and grads_ok, "PR-MoE pyramid loss or gradients")
    out["prmoe"] = {"model": TRAIN_MODEL, "num_experts": list(PRMOE_EXPERTS),
                    "use_residual": True, "params": model.config.param_count, "S": S,
                    "loss": float(loss.detach()), "fwd_bwd_s": pyramid_s, "launches": pyramid}
    del work, params, model, loss, batch
    free_memory()
    emit({"phase": "moe_train", "model": MOE_MODEL, "layers": Lm, "S": S,
          **out, "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi_line()})
    return {"train_per_step": per_step, "capacity": out["capacity"]["launches"],
            "nodrop": out["nodrop"]["launches"], "prmoe": pyramid}


def phase_pipeline(seed: int) -> dict:
    """llama-740m at full width and depth through 4 virtual stages of 4
    layers, 8 microbatches, in this process (GPipe and 1F1B), against the
    un-pipelined engine at gas=8 on the same rows and weights: the loss
    and gradient norm at every step within PIPE_*_RTOL, K1-K3 launches a
    step, step times.  Returns the launches for the kernels line."""
    t0 = time.perf_counter()
    S, M, P = PIPE_S, PIPE_MICRO, PIPE_STAGES
    runs = {}
    for label, kw in (("unpipelined", {}),
                      ("gpipe", dict(pipeline_stages=P, pipeline_microbatches=M,
                                     pipeline_schedule="gpipe")),
                      ("1f1b", dict(pipeline_stages=P, pipeline_microbatches=M,
                                    pipeline_schedule="1f1b"))):
        model, engine = _train_engine(seed, S, config_extra={
            "gradient_accumulation_steps": M}, **kw)
        cfg = model.config
        L = cfg.num_layers
        check(engine.pipelined == bool(kw), f"{label}: pipelined={engine.pipelined}")
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        batch = {"input_ids": torch.randint(0, cfg.vocab_size, (M, S), generator=gen,
                                            device="cuda")}
        per_step = (2 * L * M, L * M, L * M)
        torch.cuda.reset_peak_memory_stats()
        # the path: counts to 0 just before, read just after
        reset_counts()
        losses, step_s, norms = [], [], []
        for _ in range(PIPE_STEPS):
            before = kernel_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(engine.train_batch(batch=batch)))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            norms.append(engine.get_global_grad_norm())
            got = tuple(a - b for a, b in zip(kernel_counts(), before))
            check(got == per_step, f"pipeline {label}: a step launched K1/K2/K3 {got}, "
                                   f"expected {per_step}")
        runs[label] = {"losses": losses, "grad_norms": norms, "step_s": step_s,
                       "tokens_per_s": M * S / step_s[-1],
                       "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "launches_per_step": dict(zip(("K1", "K2", "K3"), per_step))}
        del engine, model, batch
        free_memory()
    ref = runs["unpipelined"]
    for label in ("gpipe", "1f1b"):
        r = runs[label]
        r["loss_max_rel_diff"] = max(abs(a - b) / abs(b)
                                     for a, b in zip(r["losses"], ref["losses"]))
        r["grad_norm_max_rel_diff"] = max(abs(a - b) / abs(b)
                                          for a, b in zip(r["grad_norms"], ref["grad_norms"]))
        r["step_time_vs_unpipelined"] = r["step_s"][-1] / ref["step_s"][-1]
    rec = {"phase": "pipeline", "model": TRAIN_MODEL, "S": S, "stages": P,
           "layers_per_stage": L // P, "microbatches": M, "virtual": True,
           "loss_rtol": PIPE_LOSS_RTOL, "grad_norm_rtol": PIPE_NORM_RTOL, **runs,
           "bubble_share_model": (P - 1) / (M + P - 1),
           "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi_line()}
    emit(rec)
    for label in ("gpipe", "1f1b"):
        check(runs[label]["loss_max_rel_diff"] <= PIPE_LOSS_RTOL
              and runs[label]["grad_norm_max_rel_diff"] <= PIPE_NORM_RTOL,
              f"pipeline {label} strays from the un-pipelined engine: {runs[label]}")
    return {"per_step": runs["gpipe"]["launches_per_step"]}


def _tp_card_ep4_mixtral8(seed: int, world: int, rank: int) -> dict:
    """Mixtral's widths at MOE_CARD_LAYERS layers, the capacity path, over
    an expert axis of ``world`` (each card 8/world experts of every layer,
    the buffers exchanged over 'expert') against ZeRO-3 over dp=``world``,
    the same weights (the seed's streamed init, on the host) and ``world``
    rows: losses within TP_DP_LOSS_RTOL at each step."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout

    comm.configure({"enabled": True})
    model, params = _moe_params(MOE_CARD_LAYERS, seed, device="cpu")
    S = MOE_TRAIN_S
    cfg = dataclasses.replace(model.config, moe_drop_tokens=True, max_seq_len=S)
    L = cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (world, S), generator=gen,
                                        device="cuda")}
    out = {}
    for name, mesh, stage in (("dp", MeshLayout(dp=world), 3),
                              ("ep", MeshLayout(ep=world), 1)):
        from deepspeed_tpu_torch.models import CausalLM

        config = {**TRAIN_CONFIG, "seed": seed, "zero_optimization": {"stage": stage}}
        engine, *_ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), config=config,
                                                    params=params, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_s, comms = _zero_steps(engine, batch, (2 * L, L, L), by_axis=True)
        out[name] = {"losses": losses, "step_s": step_s,
                     "median_step_s": statistics.median(step_s[1:]),
                     "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "held_memory_gb": torch.cuda.memory_allocated() / 1e9,
                     "collectives_per_step_by_axis": comms[-1],
                     "local_experts": int(engine.state.params["layers"]["w_gate"].shape[1])}
        del engine
        free_memory()
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["ep"]["losses"], out["dp"]["losses"]))
    check(rel <= TP_DP_LOSS_RTOL, f"ep4_mixtral8: ep={world} losses differ from ZeRO-3 "
                                  f"dp={world}'s by {rel}: {out}")
    return {"model": MOE_MODEL, "layers": L, "S": S, "ep": world, "path": "capacity",
            **out["ep"], "zero3_dp": out["dp"], "loss_max_rel_diff_vs_dp": rel}


def _tp_card_pp4_7b(seed: int, world: int, rank: int) -> dict:
    """llama2-7b over a 'pipe' axis of ``world`` (each card 32/world
    layers), GPipe and 1F1B, M=``world`` microbatches of one row, against
    ZeRO-3 over dp=``world`` on the same ``world`` rows and default init:
    losses within TP_DP_LOSS_RTOL at each step."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import MeshLayout

    comm.configure({"enabled": True})
    name, S = PP_CARD_MODEL, PP_CARD_S
    out = {}
    for label, mesh, stage, kw, gas in (
            ("dp", MeshLayout(dp=world), 3, {}, 1),
            ("gpipe", MeshLayout(pp=world), 0,
             dict(pipeline_stages=world, pipeline_microbatches=world,
                  pipeline_schedule="gpipe"), world),
            ("1f1b", MeshLayout(pp=world), 0,
             dict(pipeline_stages=world, pipeline_microbatches=world,
                  pipeline_schedule="1f1b"), world)):
        model, engine = _train_engine(
            seed, S, name=name, mesh=mesh, config_extra={
                "zero_optimization": {"stage": stage},
                "gradient_accumulation_steps": gas}, **kw)
        cfg = model.config
        L = cfg.num_layers
        per_rank = (2 * L, L, L) if not kw else (2 * (L // world) * world,
                                                 (L // world) * world, (L // world) * world)
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        batch = {"input_ids": torch.randint(0, cfg.vocab_size, (world, S), generator=gen,
                                            device="cuda")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_s, comms = _zero_steps(engine, batch, per_rank, by_axis=True)
        out[label] = {"losses": losses, "step_s": step_s,
                      "median_step_s": statistics.median(step_s[1:]),
                      "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "held_memory_gb": torch.cuda.memory_allocated() / 1e9,
                      "launches_per_step_rank": dict(zip(("K1", "K2", "K3"), per_rank)),
                      "collectives_per_step_by_axis": comms[-1]}
        del engine, model, batch
        free_memory()
    rels = {label: max(abs(a - b) / abs(b) for a, b in zip(out[label]["losses"],
                                                           out["dp"]["losses"]))
            for label in ("gpipe", "1f1b")}
    check(max(rels.values()) <= TP_DP_LOSS_RTOL,
          f"pp4_7b: pipelined losses differ from ZeRO-3 dp={world}'s: {rels} {out}")
    return {"model": name, "S": S, "pp": world, "microbatches": world, **out,
            "loss_max_rel_diff_vs_dp": rels}


# ---------------------------------------------------------------------------
# ZeRO-Offload, ZeRO-Infinity, ZeRO++ and the 1-bit optimizers (ROADMAP
# queue 1, item 10): phases ``offload`` and ``zeropp_onebit``
# ---------------------------------------------------------------------------

# two steps show the loss falling; a third cost ~9 s of the script's time
# limit once phase pod joined it
OFFLOAD_7B_MODEL, OFFLOAD_7B_S, OFFLOAD_7B_STEPS = "llama2-7b", 4096, 2
# host bytes a parameter of the host step: fp32 master, m, v
OFFLOAD_HOST_BYTES = 12
# the share of MemAvailable the 7B phase's state may take (the rest: this
# process, its CUDA context, the staging buffers, the page cache)
OFFLOAD_HOST_SHARE = 0.88
OFFLOAD_DEVICE_GB = 80.0
# plain AdamW (fp32 moments on both sides: the host Adam keeps fp32)
OFFLOAD_OPT = {"type": "adamw", "params": {"lr": 1e-4, "weight_decay": 0.01}}
# an offload mode's masters after step 1 against the device engine's,
# relative to each leaf's largest magnitude: the host Adam's lr/bc1 and
# sqrt(v)/sqrt(bc2) round apart from the chain's m/bc1/sqrt(v/bc2) by a
# few ulps of the update (3e-7 at the tiny model on the CPU)
OFFLOAD_MASTER_RTOL = 1e-6
OFFLOAD_MODES = ("device", "host_step", "streamed", "nvme", "infinity")
# disk bytes a parameter: NVMe state (12) and a checkpoint's copy (12) +
# bf16 files (2)
OFFLOAD_DISK_BYTES = 26
# the 740m modes' depth: 2 of the cell's 16 layers, the least that runs
# ZeRO-Infinity's layer prefetch and both buffer slots, keep the whole
# script well inside its time limit on a slow host (the offload phase took
# 254 s at 16 layers, 170-212 s at 8 and 170 s at 4 on a slower host, most
# of it the NVMe and Infinity files, which scale with the layers)
OFFLOAD_740M_LAYERS = 2
ZPP_STEPS, ONEBIT_STEPS, ONEBIT_FREEZE = 3, 6, 2
# ZeroOneAdam through all of its phases within ZO_STEPS steps: variance
# steps at counts 1, 2 and 4, a 1-bit step at 3, the variance frozen after
# 4, then syncs at 5, 6 and 8 around a local step at 7 (the sync interval
# doubles to 2 after step 5).  tests/test_torch_onebit.py holds the JAX
# engine's loss falling and the port equal to it at these settings on the
# tiny model
ZO_CARD_HYPER = {"lr": 3e-5, "var_freeze_step": 4, "var_update_scaler": 1,
                 "local_step_scaler": 1, "local_step_clipper": 2}
ZO_STEPS = 8
ZPP_BOUND = {"rtol": 0.05, "atol": 0.02}   # tests/unit/test_zeropp.py:42
# 4 cards (``--tp-cards-only``): ZeRO++ at llama2-7b and OneBitAdam at the
# train cell; rehearsed over 4 gloo ranks in tests/test_torch_{zeropp,onebit}.py
ITEM10_CARD_CONFIGS = ("zpp4_7b", "onebit4_740m")


def meminfo_gb() -> dict:
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable", "MemFree"):
                out[key] = int(val.split()[0]) * 1024 / 1e9
    return out


def host_rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def _layer_params(cfg) -> tuple:
    """(parameters a layer, parameters outside the layers)."""
    rest = cfg.vocab_size * cfg.hidden_size * (1 if cfg.tie_embeddings else 2) \
        + cfg.hidden_size
    return (cfg.param_count - rest) // cfg.num_layers, rest


def _fit_layers(cfg, budget_bytes: float, bytes_per_param: float) -> int:
    per_layer, rest = _layer_params(cfg)
    return max(0, min(cfg.num_layers,
                      int((budget_bytes / bytes_per_param - rest) // per_layer)))


def _offload_masters(engine) -> dict:
    """The fp32 masters by path on the host (per-layer Infinity files
    stacked back into the [L, ...] leaves)."""
    from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

    if engine._param_offload is not None:
        out = {}
        for k, v in engine._param_offload.read_masters().items():
            if k.startswith("layers."):
                _, i, leaf = k.split(".", 2)
                out.setdefault(f"layers/{leaf}", {})[int(i)] = torch.from_numpy(v)
            else:
                out[k] = torch.from_numpy(v)
        return {k: torch.stack([v[i] for i in sorted(v)]) if isinstance(v, dict) else v
                for k, v in out.items()}
    if engine._offload is not None:
        return {k: torch.from_numpy(v.copy()) for k, v in
                engine._offload.read_masters().items()}
    return {p: x.detach().to("cpu", copy=True)
            for p, x in tree_flatten_with_path(engine.state.master_params)}


def _masters_rel(got: dict, ref: dict) -> float:
    worst = 0.0
    for k, r in ref.items():
        worst = max(worst, float((got[k] - r).abs().max() / r.abs().max().clamp(min=1e-30)))
    return worst


def _offload_config(mode: str, root: str) -> dict:
    zero = {"stage": 1}
    if mode == "host_step":
        zero["offload_optimizer"] = {"device": "cpu"}
    elif mode == "streamed":
        zero["offload_optimizer"] = {"device": "cpu", "host_step": False}
    elif mode == "nvme":
        zero["offload_optimizer"] = {"device": "nvme", "nvme_path": os.path.join(root, "nvme"),
                                     "pipeline_read": True, "pipeline_write": True}
    elif mode == "infinity":
        zero = {"stage": 3, "offload_param": {"device": "nvme",
                                              "nvme_path": os.path.join(root, "inf")}}
    return {"zero_optimization": zero, "optimizer": OFFLOAD_OPT,
            "aio": {"thread_count": 8, "queue_depth": 16}}


def _timed_step(engine, batch, per_step) -> tuple:
    """(loss, seconds, the K1/K2/K3 launches the step made), the launches
    checked against ``per_step``."""
    before = kernel_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss = float(engine.train_batch(batch=batch))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    got = tuple(a - b for a, b in zip(kernel_counts(), before))
    check(got == per_step, f"an offload step launched K1/K2/K3 {got}, expected {per_step}")
    return loss, dt, got


def _launch_record(steps) -> dict:
    """The measured launches of K1, K2, K3, a list of the steps' each."""
    return {key: [got[i] for got in steps] for i, key in enumerate(("K1", "K2", "K3"))}


def _offload_stats(engine) -> dict:
    off = engine._offload or engine._param_offload
    return dict(off.stats) if off is not None else {}


def phase_offload_7b(seed: int) -> dict:
    """llama2-7b at full width, S=4096, micro batch 1, bf16 over fp32
    masters, AdamW, ZeRO stage 1 at one rank with the optimizer state in
    host RAM (``offload_optimizer.device="cpu"``: the host step by JAX's
    auto rule): OFFLOAD_7B_STEPS steps on one batch.  The layers are cut
    (never the width) where host RAM cannot hold 12 B a parameter."""
    from deepspeed_tpu_torch.models import get_config

    mem = meminfo_gb()
    cfg = get_config(OFFLOAD_7B_MODEL)
    layers = _fit_layers(cfg, mem["MemAvailable"] * 1e9 * OFFLOAD_HOST_SHARE,
                         OFFLOAD_HOST_BYTES)
    check(layers >= 1, f"host RAM {mem} holds no layer of {OFFLOAD_7B_MODEL}")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, engine = _train_engine(seed, OFFLOAD_7B_S, name=OFFLOAD_7B_MODEL,
                                  num_layers=layers,
                                  config_extra=_offload_config("host_step", ""))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(engine._offload is not None and engine._offload.storage == "cpu",
          "the 7B offload engine did not take the host step")
    L = model.config.num_layers
    batch = _train_batch(model.config, OFFLOAD_7B_S, seed + 1)
    reset_counts()
    losses, step_s, stats, launches = [], [], [], []
    for _ in range(OFFLOAD_7B_STEPS):
        loss, dt, got = _timed_step(engine, batch, (2 * L, L, L))
        losses.append(loss)
        step_s.append(dt)
        stats.append(_offload_stats(engine))
        launches.append(got)
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec = {"phase": "offload", "case": "llama2-7b_host_step", "model": OFFLOAD_7B_MODEL,
           "layers": L, "layers_published": cfg.num_layers,
           "layers_cut": L < cfg.num_layers, "params": model.param_count,
           "host_state_gb": engine._offload.optimizer.state_bytes() / 1e9,
           "meminfo_gb_before": mem, "S": OFFLOAD_7B_S, "micro_batch": 1,
           "init_s": init_s, "step_s": step_s, "losses": losses,
           "host_adam_s": [s["adam_s"] for s in stats],
           "host_adam_threads": engine._offload.optimizer.adam.num_threads,
           "torch_threads": torch.get_num_threads(),
           "grad_download_gbps": [s["download_gbps"] for s in stats],
           "param_upload_gbps": [s["upload_gbps"] for s in stats],
           "device_peak_gb": peak, "host_rss_gb": host_rss_gb(),
           "launches_per_step": _launch_record(launches)}
    emit(rec)
    check(all(math.isfinite(x) for x in losses), f"non-finite 7B offload loss {losses}")
    check(losses[-1] < losses[0], f"the 7B offload loss did not fall: {losses}")
    check(peak < OFFLOAD_DEVICE_GB, f"the 7B offload peak {peak:.2f} GB is over the card")
    del engine, model, batch
    free_memory()
    return rec


def phase_offload_740m(seed: int) -> dict:
    """The train cell (llama-740m, S=16384) from one seed and batch through
    the device engine and each offload mode: the first loss equals the
    device engine's, every mode's fp32 masters after step 1 lie within
    OFFLOAD_MASTER_RTOL of its; the NVMe and Infinity state saved after
    step 1 and resumed by a fresh engine gives step 2 bit for bit."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.models import get_config

    S = TRAIN_SHAPE[1]
    cfg = get_config(TRAIN_MODEL)
    root = tempfile.mkdtemp(prefix="offload_")
    free = shutil.disk_usage(root).free
    layers = min(OFFLOAD_740M_LAYERS, _fit_layers(cfg, free * 0.8, OFFLOAD_DISK_BYTES))
    check(layers >= 1, f"{free / 1e9:.1f} GB free under {root} holds no layer")
    L = layers
    per_step = (2 * L, L, L)
    batch = _train_batch(cfg, S, seed + 1)
    out, ref = {"disk_free_gb": free / 1e9, "swap_root": root, "layers": L,
                "layers_cut": L < cfg.num_layers}, None
    try:
        for mode in OFFLOAD_MODES:
            t0 = time.perf_counter()
            model, engine = _train_engine(seed, S, num_layers=L,
                                          config_extra=_offload_config(mode, root))
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            loss1, s1, got1 = _timed_step(engine, batch, per_step)
            stats1 = _offload_stats(engine)
            masters = _offload_masters(engine)
            rec = {"init_s": init_s, "step_s": [s1], "losses": [loss1],
                   "stats": [stats1], "launches": [got1]}
            if ref is None:
                ref = {"loss": loss1, "masters": masters}
            else:
                rec["first_loss_equal"] = loss1 == ref["loss"]
                rec["masters_max_rel"] = _masters_rel(masters, ref["masters"])
            del masters
            if mode in ("nvme", "infinity"):
                ckpt = os.path.join(root, f"ckpt_{mode}")
                t = time.perf_counter()
                engine.save_checkpoint(ckpt, tag="t")
                rec["save_s"] = time.perf_counter() - t
            loss2, s2, got2 = _timed_step(engine, batch, per_step)
            rec["launches"].append(got2)
            rec["losses"].append(loss2)
            rec["step_s"].append(s2)
            rec["stats"].append(_offload_stats(engine))
            rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            if mode in ("nvme", "infinity"):
                after = _offload_masters(engine)
                del engine, model
                free_memory()
                model, engine = _train_engine(seed, S, num_layers=L,
                                              config_extra=_offload_config(mode, root))
                t = time.perf_counter()
                engine.load_checkpoint(ckpt, tag="t")
                rec["load_s"] = time.perf_counter() - t
                loss2r, _, _ = _timed_step(engine, batch, per_step)
                resumed = _offload_masters(engine)
                rec["resume_bit_exact"] = loss2r == loss2 and all(
                    torch.equal(resumed[k], after[k]) for k in after)
                del after, resumed
                shutil.rmtree(ckpt, ignore_errors=True)
            out[mode] = rec
            del engine, model
            free_memory()
            shutil.rmtree(os.path.join(root, "nvme"), ignore_errors=True)
            shutil.rmtree(os.path.join(root, "inf"), ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out.update(phase="offload", case="llama-740m_modes", model=TRAIN_MODEL, S=S,
               launches_per_step={mode: _launch_record(out[mode].pop("launches"))
                                  for mode in OFFLOAD_MODES})
    emit(out)
    for mode in OFFLOAD_MODES[1:]:
        rec = out[mode]
        check(rec["first_loss_equal"], f"offload {mode}: first loss differs: {rec}")
        check(rec["masters_max_rel"] <= OFFLOAD_MASTER_RTOL,
              f"offload {mode}: masters {rec['masters_max_rel']} from the device engine's")
        if mode in ("nvme", "infinity"):
            check(rec["resume_bit_exact"], f"offload {mode}: resume is not bit-exact")
    return out


def phase_offload(seed: int) -> dict:
    t0 = time.perf_counter()
    rec = {"llama2-7b": phase_offload_7b(seed), "llama-740m": phase_offload_740m(seed)}
    emit({"phase": "offload_done", "seconds": time.perf_counter() - t0})
    return rec


def _onebit_config(opt: str, **params) -> dict:
    return {"optimizer": {"type": opt, "params": {"lr": 1e-4, **params}},
            "zero_optimization": {"stage": 0}, "comms_logger": {"enabled": True}}


def _logged_steps(engine, batch, steps, per_step, probe=None) -> tuple:
    """(losses, step seconds, the comms logger's bytes by dtype, the
    measured launches) of ``steps`` steps, and ``probe(engine)`` after
    each step where given."""
    from deepspeed_tpu_torch import comm

    log = comm.get_comms_logger()
    losses, step_s, wire, launches, probes = [], [], [], [], []
    for _ in range(steps):
        log.reset()
        loss, dt, got = _timed_step(engine, batch, per_step)
        losses.append(loss)
        step_s.append(dt)
        wire.append(log.totals_by_dtype())
        launches.append(got)
        if probe is not None:
            probes.append(probe(engine))
    out = (losses, step_s, wire, _launch_record(launches))
    return out + (probes,) if probe is not None else out


def phase_zeropp_onebit(seed: int) -> dict:
    """The train cell at NCCL world 1 (every collective a copy: this prices
    the code path, not the links): ZeRO-3 with qwZ + qgZ against plain
    ZeRO-3, ZPP_STEPS steps (losses within JAX's qwZ bound; every gather
    of a sharded compute leaf int8; the step overhead); OneBitAdam with
    freeze_step=ONEBIT_FREEZE over ONEBIT_STEPS steps against AdamW (the
    warm-up steps equal, the error buffers nonzero after the freeze, the
    exchange uint8); ZeroOneAdam through its local steps (ZO_CARD_HYPER)
    and OneBitLamb (losses finite and falling)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import get_config

    t0 = time.perf_counter()
    S = TRAIN_SHAPE[1]
    cfg = get_config(TRAIN_MODEL)
    L = cfg.num_layers
    per_step = (2 * L, L, L)
    batch = _train_batch(cfg, S, seed + 1)
    out = {"phase": "zeropp_onebit", "model": TRAIN_MODEL, "S": S, "world_size": 1}
    comm.init_distributed(init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                          world_size=1, verbose=False)
    try:
        runs = {}
        for label, zero in (("plain", {"stage": 3}),
                            ("qwz_qgz", {"stage": 3, "zero_quantized_weights": True,
                                         "zero_quantized_gradients": True})):
            model, engine = _train_engine(seed, S, config_extra={
                "zero_optimization": zero, "comms_logger": {"enabled": True}})
            reset_counts()
            losses, step_s, wire, launches = _logged_steps(engine, batch, ZPP_STEPS,
                                                           per_step)
            part = engine.partition
            runs[label] = {"losses": losses, "step_s": step_s, "launches": launches,
                           "median_step_s": statistics.median(step_s[1:]),
                           "wire_per_step": wire[-1],
                           "num_quantized_leaves": part.num_quantized_leaves,
                           "sharded_compute_leaves": sum(p is not None for p in part.pdims),
                           "persistent_sharded_masters": sum(
                               p is None and m is not None
                               for p, m in zip(part.pdims, part.mdims))}
            del engine, model
            free_memory()
        plain, zpp = runs["plain"], runs["qwz_qgz"]
        zpp["step_overhead"] = zpp["median_step_s"] / plain["median_step_s"] - 1
        zpp["loss_max_abs_diff"] = max(abs(a - b) for a, b in
                                       zip(zpp["losses"], plain["losses"]))
        out["zeropp"] = runs
        onebit = {}
        for label, cfg_extra, steps in (
                ("adamw", _onebit_config("adamw"), ONEBIT_FREEZE + 1),
                ("onebitadam", _onebit_config("OneBitAdam", freeze_step=ONEBIT_FREEZE),
                 ONEBIT_STEPS),
                ("zerooneadam", _onebit_config("ZeroOneAdam", **ZO_CARD_HYPER), ZO_STEPS),
                ("onebitlamb", _onebit_config("OneBitLamb", freeze_step=2, lr=1e-3), 4)):
            model, engine = _train_engine(seed, S, config_extra=cfg_extra)
            reset_counts()
            # after each step: whether it left an accumulated local update
            # unsynced (0/1 Adam's local step)
            losses, step_s, wire, launches, probes = _logged_steps(
                engine, batch, steps, per_step,
                probe=lambda e: bool(getattr(e._comm_error, "lrs", 0.0) > 0))
            err = engine._comm_error
            errs = err if isinstance(err, list) else getattr(err, "error", None)
            onebit[label] = {"losses": losses, "step_s": step_s, "wire_per_step": wire,
                             "launches": launches, "local_steps": sum(probes),
                             "error_abs_sum": (None if errs is None else
                                               float(sum(e.abs().sum() for e in errs)))}
            del engine, model, err, errs
            free_memory()
        out["onebit"] = onebit
    finally:
        comm.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    check(all(math.isfinite(x) for x in zpp["losses"]), f"non-finite qwZ loss {zpp}")
    check(all(abs(a - b) <= ZPP_BOUND["atol"] + ZPP_BOUND["rtol"] * abs(b)
              for a, b in zip(zpp["losses"], plain["losses"])),
          f"qwZ/qgZ losses outside JAX's bound of plain ZeRO-3: {zpp['losses']} "
          f"{plain['losses']}")
    gathers = zpp["wire_per_step"]["all_gather"]
    check(gathers.get("int8", {}).get("calls") ==
          plain["wire_per_step"]["all_gather"]["bfloat16"]["calls"]
          - plain["persistent_sharded_masters"],
          f"qwZ: not every gather of a sharded compute leaf was int8: {gathers}")
    check(gathers.get("bfloat16", {}).get("calls", 0) == zpp["persistent_sharded_masters"],
          f"qwZ: bf16 gathers beyond the persistent leaves' re-gathers: {gathers}")
    check(zpp["num_quantized_leaves"] == zpp["sharded_compute_leaves"] > 0,
          f"num_quantized_leaves {zpp['num_quantized_leaves']}")
    check("reduce_scatter" not in zpp["wire_per_step"]
          and zpp["wire_per_step"]["all_to_all"]["int8"]["calls"] > 0,
          f"qgZ: the gradient reduce is not the int8 all-to-all: {zpp['wire_per_step']}")
    ob, aw = onebit["onebitadam"], onebit["adamw"]
    check(ob["losses"][:ONEBIT_FREEZE + 1] == aw["losses"],
          f"OneBitAdam's warm-up differs from AdamW: {ob['losses']} {aw['losses']}")
    check(ob["error_abs_sum"] > 0, "OneBitAdam's error buffers are zero after the freeze")
    check("uint8" in ob["wire_per_step"][-1].get("all_gather", {}),
          f"OneBitAdam's exchange is not uint8: {ob['wire_per_step'][-1]}")
    for label in ("zerooneadam", "onebitlamb"):
        ls = onebit[label]["losses"]
        check(all(math.isfinite(x) for x in ls) and ls[-1] < ls[0],
              f"{label}: losses not finite and falling: {ls}")
    check(onebit["zerooneadam"]["local_steps"] >= 1,
          f"ZeroOneAdam took no local step: {onebit['zerooneadam']}")
    emit({"phase": "zeropp_onebit_done", "seconds": time.perf_counter() - t0})
    return out


def _tp_card_zpp4_7b(seed: int, world: int, rank: int) -> dict:
    """llama2-7b, ZeRO-3 with qwZ, qgZ and hpZ=2 at dp=``world`` against
    plain ZeRO-3 at dp=``world`` on the same rows: losses within the qwZ
    bound; all-gather bytes by dtype a step."""
    from deepspeed_tpu_torch import comm

    comm.configure({"enabled": True})
    name, S = PP_CARD_MODEL, PP_CARD_S
    out = {}
    for label, zero in (("plain", {"stage": 3}),
                        ("zpp", {"stage": 3, "zero_quantized_weights": True,
                                 "zero_quantized_gradients": True,
                                 "zero_hpz_partition_size": 2})):
        model, engine = _train_engine(seed, S, name=name, config_extra={
            "zero_optimization": zero, "comms_logger": {"enabled": True}})
        L = model.config.num_layers
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        batch = {"input_ids": torch.randint(0, model.config.vocab_size, (world, S),
                                            generator=gen, device="cuda")}
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_s, wire, _ = _logged_steps(engine, batch, ZERO_STEPS, (2 * L, L, L))
        out[label] = {"losses": losses, "step_s": step_s,
                      "median_step_s": statistics.median(step_s[1:]),
                      "wire_per_step": wire[-1],
                      "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del engine, model, batch
        free_memory()
    ok = all(abs(a - b) <= ZPP_BOUND["atol"] + ZPP_BOUND["rtol"] * abs(b)
             for a, b in zip(out["zpp"]["losses"], out["plain"]["losses"]))
    check(ok, f"zpp4_7b: losses outside the qwZ bound: {out}")
    return {"model": name, "S": S, "dp": world, "hpz": 2, **out}


def _tp_card_onebit4_740m(seed: int, world: int, rank: int) -> dict:
    """OneBitAdam (freeze_step ONEBIT_FREEZE) against AdamW at dp=``world``
    on the train cell: the warm-up equal, bytes a step after the freeze."""
    from deepspeed_tpu_torch import comm

    comm.configure({"enabled": True})
    S = TRAIN_SHAPE[1]
    out = {}
    for label, extra, steps in (("adamw", _onebit_config("adamw"), ONEBIT_FREEZE + 1),
                                ("onebitadam", _onebit_config(
                                    "OneBitAdam", freeze_step=ONEBIT_FREEZE), ONEBIT_STEPS)):
        model, engine = _train_engine(seed, S, config_extra=extra)
        L = model.config.num_layers
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        batch = {"input_ids": torch.randint(0, model.config.vocab_size, (world, S),
                                            generator=gen, device="cuda")}
        reset_counts()
        losses, step_s, wire, _ = _logged_steps(engine, batch, steps, (2 * L, L, L))
        out[label] = {"losses": losses, "step_s": step_s, "wire_per_step": wire}
        del engine, model, batch
        free_memory()
    check(out["onebitadam"]["losses"][:ONEBIT_FREEZE + 1] == out["adamw"]["losses"],
          f"onebit4_740m: the warm-up differs from AdamW: {out}")
    return {"model": TRAIN_MODEL, "S": S, "dp": world, "freeze_step": ONEBIT_FREEZE, **out}


# ---------------------------------------------------------------------------
# Item 11, the model-and-optimizer half: phases train_extras, lora_hybrid
# ---------------------------------------------------------------------------

# each optimizer's hyperparameters on the train cell (3 steps each), and its
# state's bytes a parameter over fp32 masters
EXTRA_OPTIMIZERS = {
    "lamb": ({"lr": 1e-3, "betas": [0.9, 0.999], "weight_decay": 0.01}, 8),
    "sgd": ({"lr": 1e-2, "momentum": 0.9, "nesterov": True}, 4),
    "adagrad": ({"lr": 1e-2}, 4),
    "lion": ({"lr": 1e-4, "betas": [0.9, 0.99], "weight_decay": 0.01}, 4),
    "rmsprop": ({"lr": 1e-4}, 4),
}
EXTRA_STEPS = 3
PLD_CONFIG = {"enabled": True, "theta": 0.5, "gamma": 0.5}
PLD_STEPS = 5
LTD_CONFIG = {"enabled": True, "min_value": 8192, "max_value": 16384,
              "random_ltd_schedule": {"schedule_config": {"seq_per_step": 1024,
                                                          "require_steps": 4}}}
LTD_STEPS = 5
# fixed_linear reads its difficulty at step 1 first: over 8 steps it runs
# 2048, 4096, ..., 16384
CURRICULUM_CONFIG = {"enabled": True, "curriculum_type": "seqlen",
                     "min_difficulty": 2048, "max_difficulty": 16384,
                     "schedule_type": "fixed_linear",
                     "schedule_config": {"total_curriculum_step": 8,
                                         "difficulty_step": 2048}}
CURRICULUM_STEPS = 8
EIG_S, EIG_ITERS = 1024, 10
# the fp32 Hessian-vector product along the returned vector against the
# central difference of fp32 gradients at +-EIG_FD_EPS (the vector has unit
# norm): ||hvp - fd|| / ||fd|| at most EIG_FD_REL.  On the H100 along that
# vector the difference's error falls as eps^2 (0.228 at 1e-2, 2.3e-3 at
# 1e-3, 4.7e-4 at 3e-4: the curvature changes fast along it) down to the
# gradients' fp32 noise (7e-4 at eps 0.1 along a random unit vector,
# growing as 1/eps); a product that left a part of the model out would be
# off by O(1)
EIG_FD_EPS, EIG_FD_REL = 3e-4, 2e-3
# forward_cached's dense prefill (K1) against its masked branch on the same
# rows, llama2-7b bf16 with random weights: the worst row's ||dense -
# masked|| / ||masked|| of the logits at most PREFILL_ROW_REL.  On the H100
# at 4 x 2048: worst row 0.088, median 0.066 (two bf16 roundings of
# attention through 32 random layers); a prefill that skips one 128-key
# tile: median 0.88, worst 1.36 on the rows after it
PREFILL_ROW_REL = 0.25
LORA_MODEL, LORA_RANK, LORA_ALPHA, LORA_LR = "llama2-7b", 16, 32.0, 1e-3
# two rounds of a generate and a step: a generate on the base, a step, a
# generate on the fused tree, a step (the host-bound generates set the
# phase's time); the base is checked bit-unchanged after each generate and
# each step.  HYBRID_NEW stays a multiple of 128: the rollouts' step and
# the prompts' prefill both reach K1 only at S % 128 == 0
HYBRID_ROWS, HYBRID_PROMPT, HYBRID_NEW, HYBRID_ROUNDS = 4, 2048, 128, 2


class _AttentionLog:
    """Within the block: the q shape of every flash call the model makes
    (K2/K3 run in their backward at the same shape) and the count of
    plain-branch attention calls, read through ``models.transformer``'s
    own names (the launch counters stay the wrappers')."""

    def __init__(self):
        self.shapes, self.plain = [], 0

    def __enter__(self):
        from deepspeed_tpu_torch.models import transformer as tt

        self._tt, self._flash, self._plain = tt, tt.flash_attention, tt._plain_attention

        def flash(q, *a, **k):
            self.shapes.append(tuple(q.shape))
            return self._flash(q, *a, **k)

        def plain(*a, **k):
            self.plain += 1
            return self._plain(*a, **k)

        tt.flash_attention, tt._plain_attention = flash, plain
        return self

    def __exit__(self, *exc):
        self._tt.flash_attention, self._tt._plain_attention = self._flash, self._plain

    def take(self):
        shapes, plain = sorted(set(self.shapes)), self.plain
        self.shapes, self.plain = [], 0
        return shapes, plain


def _state_bytes(state) -> int:
    """The bytes of an optimizer state's tensors (step counts aside)."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size() if state.dim() else 0
    if dataclasses.is_dataclass(state):
        return sum(_state_bytes(getattr(state, f.name)) for f in dataclasses.fields(state))
    if isinstance(state, dict):
        return sum(_state_bytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(_state_bytes(v) for v in state)
    return 0


def _extra_optimizers(seed: int, batch) -> dict:
    """AdamW's first step, then each optimizer EXTRA_STEPS steps from the
    same seed and batch."""
    S = TRAIN_SHAPE[1]
    out = {}
    _, engine = _train_engine(seed, S)
    L = engine.model.config.num_layers
    per_step = (2 * L, L, L)
    reset_counts()
    adamw_loss, adamw_s, _ = _timed_step(engine, batch, per_step)
    out["adamw"] = {"first_loss": adamw_loss, "step_s": adamw_s}
    del engine
    free_memory()
    from deepspeed_tpu_torch.runtime.optimizer import create_optimizer

    for name, (params, per_param) in EXTRA_OPTIMIZERS.items():
        config = {"optimizer": {"type": name, "params": params}}
        t0 = time.perf_counter()
        _, engine = _train_engine(seed, S, config_extra=config)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        steps = [_timed_step(engine, batch, per_step) for _ in range(EXTRA_STEPS)]
        rec = {"init_s": init_s, "losses": [x[0] for x in steps],
               "step_s": [x[1] for x in steps],
               "launches_per_step": _launch_record([x[2] for x in steps]),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "state_bytes_per_param": _state_bytes(engine.state.opt_state)
               / engine.param_count, "expected_bytes_per_param": per_param}
        if name == "sgd":   # without momentum: no state at all
            rec["no_momentum_state_bytes"] = _state_bytes(create_optimizer(
                "sgd", {"lr": params["lr"]}).init(engine.state.master_params))
        out[name] = rec
        del engine
        free_memory()
    for name, (_, per_param) in EXTRA_OPTIMIZERS.items():
        rec = out[name]
        check(rec["losses"][0] == out["adamw"]["first_loss"],
              f"{name}'s first loss {rec['losses'][0]} != AdamW's "
              f"{out['adamw']['first_loss']}")
        check(all(math.isfinite(x) for x in rec["losses"]), f"{name}: {rec['losses']}")
        check(rec["state_bytes_per_param"] == per_param,
              f"{name}'s state holds {rec['state_bytes_per_param']} B a parameter, "
              f"expected {per_param}")
    check(out["sgd"]["no_momentum_state_bytes"] == 0, "SGD without momentum keeps state")
    return out


def _extra_runs(seed: int, batch, config_extra: dict, steps: int, expect) -> list:
    """``steps`` steps of the train cell under ``config_extra``; each
    step's seconds, loss, K1/K2/K3 launches and attention shapes, checked
    against ``expect(engine)`` (the launches and shapes the step must make,
    read before it) and no plain-branch attention."""
    _, engine = _train_engine(seed, TRAIN_SHAPE[1], config_extra=config_extra)
    torch.cuda.reset_peak_memory_stats()
    recs = []
    with _AttentionLog() as log:
        reset_counts()   # the path's launches: counts to 0 just before
        for _ in range(steps):
            want, shapes_want, info = expect(engine)
            before = kernel_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = float(engine.train_batch(batch=batch))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            got = tuple(a - b for a, b in zip(kernel_counts(), before))
            shapes, plain = log.take()
            recs.append({**info, "loss": loss, "step_s": dt, "launches": got,
                         "shapes": shapes, "plain_attention_calls": plain})
            check(got == want, f"{info}: K1/K2/K3 launched {got}, expected {want}")
            check(shapes == shapes_want, f"{info}: attention shapes {shapes}, "
                                         f"expected {shapes_want}")
            check(plain == 0, f"{info}: {plain} plain-branch attention calls")
            check(math.isfinite(loss), f"{info}: loss {loss}")
    recs[-1]["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del engine
    free_memory()
    return recs


def _eigen(seed: int) -> dict:
    """``compute_eigenvalue`` on the train cell's widths at S=EIG_S, the
    plain attention branch (what JAX's dispatch differentiates twice)."""
    from deepspeed_tpu_torch.runtime.eigenvalue import hvp
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_unflatten_like

    model, engine = _train_engine(seed, EIG_S, config_extra={
        "eigenvalue": {"enabled": True, "max_iter": EIG_ITERS}})
    batch = _train_batch(model.config, EIG_S, seed + 2)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lam, per_leaf = engine.compute_eigenvalue(batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    v = engine._eigenvalue_estimator.vector
    gen = torch.Generator(device="cuda").manual_seed(0)
    hv = tree_leaves(hvp(engine.loss_fn, engine.state.params, batch, gen,
                         tree_unflatten_like(engine.state.params, v)))
    # the returned vector's own Rayleigh quotient (the per-leaf values'
    # sum) and its residual ||Hv - rq v|| / |rq|
    rq = sum(per_leaf.values())
    res = math.sqrt(sum(float(((h.float() - rq * x.float()) ** 2).sum())
                        for h, x in zip(hv, v)))
    rec = {"S": EIG_S, "max_iter": EIG_ITERS, "lambda_max": lam, "seconds": seconds,
           "rayleigh_of_vector": rq, "residual_rel": res / max(abs(rq), 1e-30),
           "launches": launches,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "top_leaves": sorted(per_leaf.items(), key=lambda kv: -abs(kv[1]))[:4]}
    check(math.isfinite(lam) and lam != 0.0, f"eigenvalue {lam}")
    check(launches == (0, 0, 0), f"the plain branch launched K1/K2/K3 {launches}")
    del hv
    rec["fp32_hvp"] = _hvp_against_difference(
        model.config, engine.state.master_params, batch, v)
    del engine, model, v
    free_memory()
    return rec


def _hvp_against_difference(cfg, masters, batch, v) -> dict:
    """The double-backward product ``eigenvalue.hvp`` in fp32 at the fp32
    masters along ``v`` (unit norm), against the central difference of two
    fp32 gradients at masters +- EIG_FD_EPS v: the product through the
    plain attention branch, checked on the card."""
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.runtime.eigenvalue import hvp
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_unflatten_like

    model = CausalLM(TRAIN_MODEL, max_seq_len=cfg.max_seq_len, attn_impl="auto",
                     dtype=torch.float32)
    p = [x.detach().float() for x in tree_leaves(masters)]
    norm = math.sqrt(sum(float(x.float().square().sum()) for x in v))
    v = [x.float() / norm for x in v]

    def gen():
        return torch.Generator(device=p[0].device).manual_seed(0)

    def grad_at(sign):
        leaves = [(x + sign * EIG_FD_EPS * d).requires_grad_() for x, d in zip(p, v)]
        with torch.enable_grad():
            loss = model.loss_fn(tree_unflatten_like(masters, leaves), batch, gen())
            loss = loss[0] if isinstance(loss, tuple) else loss
            return torch.autograd.grad(loss, leaves)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hv = tree_leaves(hvp(model.loss_fn, tree_unflatten_like(masters, p), batch, gen(),
                         tree_unflatten_like(masters, v)))
    torch.cuda.synchronize()
    hvp_s = time.perf_counter() - t0
    launches = kernel_counts()
    plus = grad_at(1.0)
    fd = [(a - b) / (2 * EIG_FD_EPS) for a, b in zip(plus, grad_at(-1.0))]
    del plus
    diff = math.sqrt(sum(float((h - f).square().sum()) for h, f in zip(hv, fd)))
    ref = math.sqrt(sum(float(f.square().sum()) for f in fd))
    rq = sum(float((h * x).sum()) for h, x in zip(hv, v))
    rec = {"eps": EIG_FD_EPS, "rel_diff": diff / ref, "limit": EIG_FD_REL,
           "fd_norm": ref, "rayleigh": rq, "hvp_s": hvp_s, "launches": launches}
    check(launches == (0, 0, 0), f"the fp32 product launched K1/K2/K3 {launches}")
    check(diff / ref <= EIG_FD_REL,
          f"the fp32 Hessian-vector product is {diff / ref:.3e} (relative) from "
          f"the central difference, above {EIG_FD_REL}")
    del hv, fd, p, v, model
    free_memory()
    return rec


def phase_train_extras(seed: int) -> dict:
    """The train cell (llama-740m, S=16384, bf16 over fp32 masters, micro
    batch 1, ``nothing_saveable``) under item 11's optimizers and data
    efficiency features, from one seed and one batch."""
    import numpy as np

    from deepspeed_tpu_torch.models import get_config
    from deepspeed_tpu_torch.runtime.progressive_layer_drop import pld_keep_mask

    t0 = time.perf_counter()
    S = TRAIN_SHAPE[1]
    cfg = get_config(TRAIN_MODEL)
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.dims_per_head
    batch = _train_batch(cfg, S, seed + 1)
    out = {"phase": "train_extras", "model": TRAIN_MODEL, "S": S,
           "optimizers": _extra_optimizers(seed, batch)}

    def pld_expect(engine):
        pld = engine.progressive_layer_drop   # its update_state's arithmetic
        theta = float((1.0 - pld.theta) * np.exp(-pld.gamma * engine.global_steps)
                      + pld.theta)
        gen = torch.Generator()
        gen.set_state(engine.pld_generator.get_state())
        kept = int(pld_keep_mask(gen, L, theta).sum())
        return ((2 * kept, kept, kept), [(1, S, H, hd)] if kept else [],
                {"step": engine.global_steps + 1, "theta": theta, "kept_layers": kept})

    out["pld"] = _extra_runs(seed, batch, {"progressive_layer_drop": PLD_CONFIG},
                             PLD_STEPS, pld_expect)
    check(any(r["kept_layers"] < L for r in out["pld"]), "no layer dropped in "
                                                         f"{PLD_STEPS} steps")

    def ltd_expect(engine):
        keep = engine._random_ltd.update_seq(engine.global_steps)
        return ((2 * L, L, L), [(1, keep, H, hd)],
                {"step": engine.global_steps + 1, "keep": keep})

    out["random_ltd"] = _extra_runs(
        seed, batch, {"data_efficiency": {"data_routing": {"random_ltd": LTD_CONFIG}}},
        LTD_STEPS, ltd_expect)
    keeps = [r["keep"] for r in out["random_ltd"]]
    lo, hi = LTD_CONFIG["min_value"], LTD_CONFIG["max_value"]
    stride = (hi - lo) // LTD_CONFIG["random_ltd_schedule"]["schedule_config"]["require_steps"]
    check(keeps == list(range(lo, hi + 1, stride)), f"random-LTD kept {keeps}")

    def curriculum_expect(engine):
        from deepspeed_tpu_torch.runtime.data_pipeline import CurriculumScheduler

        probe = CurriculumScheduler({"curriculum_type": "seqlen",
                                     **{k: v for k, v in CURRICULUM_CONFIG.items()
                                        if k not in ("enabled", "curriculum_type")}})
        probe.set_state(dict(engine.curriculum_scheduler.get_state()))
        seq = probe.update_difficulty(engine.global_steps + 1)
        return ((2 * L, L, L), [(1, seq, H, hd)], {"step": engine.global_steps + 1,
                                                   "seq": seq})

    out["curriculum"] = _extra_runs(seed, batch, {"curriculum_learning": CURRICULUM_CONFIG},
                                    CURRICULUM_STEPS, curriculum_expect)
    seqs = [r["seq"] for r in out["curriculum"]]
    check(seqs == list(range(CURRICULUM_CONFIG["min_difficulty"],
                             CURRICULUM_CONFIG["max_difficulty"] + 1,
                             CURRICULUM_CONFIG["schedule_config"]["difficulty_step"])),
          f"the curriculum ran S={seqs}")
    out["eigenvalue"] = _eigen(seed)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def _checksum(tree) -> int:
    """The integer sum of every leaf's 16-bit words (any flipped bit moves it)."""
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    return sum(int(x.view(torch.int16).sum(dtype=torch.int64)) for x in tree_leaves(tree))


def _dense_prefill_check(cfg, params, tokens) -> dict:
    """One prefill of whole rows through ``forward_cached``'s dense branch
    (K1 once a layer, ``attn_impl="auto"``) against its masked branch
    (``"xla"``, the cached einsum) on the same rows: the worst row's
    ``||dense - masked|| / ||masked||`` of the logits is gated at
    PREFILL_ROW_REL.  The yardstick, a masked prefill that leaves out one
    128-key tile in the middle of every row (what a K1 that skipped a KV
    tile would give), must be rejected on the median row after the tile."""
    from deepspeed_tpu_torch.models.transformer import forward_cached, init_cache

    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    full = torch.ones(B, S, dtype=torch.bool, device=tokens.device)
    hole = full.clone()
    lo = S // 2
    hole[:, lo:lo + 128] = False

    def prefill(impl, mask):
        cache = init_cache(cfg, B, S, device=tokens.device)
        with torch.inference_mode():
            logits, _ = forward_cached(cfg, params, tokens, cache, pos, mask,
                                       attn_impl=impl)
        return logits.float()

    def row_rel(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).flatten()

    reset_counts()
    dense = prefill("auto", full)
    k1 = kernel_counts()
    masked = prefill("xla", full)
    err = row_rel(dense, masked)
    del dense
    yard = row_rel(prefill("xla", hole)[:, lo + 128:], masked[:, lo + 128:])
    rec = {"shape": [B, S], "k1": k1[0], "masked_k1": kernel_counts()[0] - k1[0],
           "worst_row_rel": float(err.max()), "median_row_rel": float(err.median()),
           "yardstick_worst_row_rel": float(yard.max()),
           "yardstick_median_row_rel": float(yard.median()), "limit": PREFILL_ROW_REL}
    check(k1 == (cfg.num_layers, 0, 0) and rec["masked_k1"] == 0,
          f"dense prefill launched K1/K2/K3 {k1}, the masked one K1 {rec['masked_k1']}")
    check(rec["worst_row_rel"] <= PREFILL_ROW_REL,
          f"the dense prefill's logits are {rec['worst_row_rel']:.3e} (worst row) "
          f"from the masked branch's, above {PREFILL_ROW_REL}")
    check(rec["yardstick_median_row_rel"] > PREFILL_ROW_REL,
          f"the prefill gate passed the median row of a prefill that skips a "
          f"128-key tile: {rec}")
    del masked, err, yard
    free_memory()
    return rec


def phase_lora_hybrid(seed: int) -> dict:
    """DeepSpeed-Chat's actor loop on llama2-7b at full width: a LoRA
    engine (rank LORA_RANK on ``DEFAULT_TARGETS``, AdamW) behind
    ``DeepSpeedHybridEngine``; HYBRID_ROUNDS rounds of generate (greedy,
    HYBRID_ROWS prompts of HYBRID_PROMPT tokens, HYBRID_NEW new) and a
    ``train_batch`` on the rollouts, the base bit-unchanged after each."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine
    from deepspeed_tpu_torch.runtime.lora import LoRAConfig, LoRAModel
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    t_start = time.perf_counter()
    base = CausalLM(LORA_MODEL)            # bf16 activations, attn_impl="auto"
    cfg = base.config
    L = cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    params = base.init_fn(gen, device="cuda", dtype=torch.bfloat16)
    model = LoRAModel(base, params, LoRAConfig(rank=LORA_RANK, alpha=LORA_ALPHA))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config={
        "train_micro_batch_size_per_gpu": HYBRID_ROWS, "gradient_accumulation_steps": 1,
        "bf16": {"enabled": True}, "seed": seed, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "adamw", "params": {"lr": LORA_LR}}})
    hybrid = DeepSpeedHybridEngine(engine)
    base_sum = _checksum(model.base_params)
    prompts = torch.randint(0, cfg.vocab_size, (HYBRID_ROWS, HYBRID_PROMPT),
                            generator=gen, device="cuda")
    torch.cuda.synchronize()
    rec = {"phase": "lora_hybrid", "model": LORA_MODEL, "layers": L,
           "lora_rank": LORA_RANK, "lora_params": engine.param_count,
           "init_s": time.perf_counter() - t_start, "rounds": [],
           "dense_prefill": _dense_prefill_check(cfg, params, prompts)}
    torch.cuda.reset_peak_memory_stats()

    def generate(eng, **kw):
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks = eng.generate(prompts, max_new_tokens=HYBRID_NEW, **kw)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t, kernel_counts()

    ref = None
    with _AttentionLog() as log:
        for r in range(HYBRID_ROUNDS):
            toks, gen_s, got = generate(hybrid)
            shapes, _ = log.take()
            # a generate on fused(lora) must leave the base as it found it
            unfused = _checksum(model.base_params) == base_sum
            if ref is None:   # B = 0: the fused tree is the base, bit for bit
                plain = deepspeed_tpu_torch.init_inference(base, config={"dtype": "bf16"},
                                                           params=params)
            else:
                plain = deepspeed_tpu_torch.init_inference(
                    base, config={"dtype": "bf16"}, params=model.fused(engine.state.params))
            want, ref_s, _ = generate(plain)
            del plain
            log.take()
            equal = torch.equal(toks, want)
            round_rec = {"round": r, "generate_s": gen_s, "reference_generate_s": ref_s,
                         "prefill_launches": got, "prefill_shapes": shapes,
                         "tokens_equal": equal, "base_unchanged_after_generate": unfused}
            check(unfused, f"round {r}: the generate left the base weights changed")
            check(got == (L, 0, 0), f"round {r}: generate launched K1/K2/K3 {got}, "
                                    f"expected {L} in the prefill")
            check(shapes == [(HYBRID_ROWS, HYBRID_PROMPT, cfg.num_heads, cfg.dims_per_head)],
                  f"round {r}: prefill shapes {shapes}")
            check(equal, f"round {r}: the hybrid's tokens differ from init_inference's "
                         f"{'on the base' if ref is None else 'on fused(lora)'}")
            ref = toks
            lora_before = [x.clone() for x in tree_leaves(engine.state.params)]
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = float(hybrid.train_batch(batch={"input_ids": toks}))
            torch.cuda.synchronize()
            round_rec.update(step_s=time.perf_counter() - t, loss=loss,
                             step_launches=kernel_counts(),
                             step_shapes=log.take()[0])
            # from B = 0 the first step moves the B factors only (A's
            # gradient is B's transpose times the weights' gradient)
            moved = any(not torch.equal(a, b) for a, b in
                        zip(lora_before, tree_leaves(engine.state.params)))
            unchanged = _checksum(model.base_params) == base_sum
            round_rec.update(adapters_moved=moved, base_unchanged=unchanged)
            check(math.isfinite(loss), f"round {r}: loss {loss}")
            check(unchanged, f"round {r}: the base weights changed")
            check(moved, f"round {r}: the adapters did not move")
            check(round_rec["step_launches"] == (2 * L, L, L),
                  f"round {r}: a step launched K1/K2/K3 {round_rec['step_launches']}")
            check(round_rec["step_shapes"] == [(HYBRID_ROWS, HYBRID_PROMPT + HYBRID_NEW,
                                                cfg.num_heads, cfg.dims_per_head)],
                  f"round {r}: step shapes {round_rec['step_shapes']}")
            rec["rounds"].append(round_rec)
    rec.update(peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               seconds=time.perf_counter() - t_start,
               mean_generate_s=hybrid.report_generate_latency())
    emit(rec)
    del hybrid, engine, model, params, base
    free_memory()
    return rec


# Item 11's tooling half (phase ``tooling``): the train cell (llama-740m,
# S=16384, TRAIN_CONFIG) under compression training, its cleanup, the flops
# profiler and the monitors on the plain cell, the autotuner, OnDevice
TOOLING_STEPS = 6
PLAIN_CELL_STEPS = 3
TOOLING_COMPRESSION = {
    "weight_quantization": {
        "shared_parameters": {"enabled": True, "quantization_type": "symmetric",
                              "schedule_offset": 1},
        "different_groups": {"wq": {"params": {"start_bits": 8, "target_bits": 4,
                                               "quantization_period": 2},
                                    "modules": ["layers/w"]}}},
    "activation_quantization": {
        "shared_parameters": {"enabled": True, "quantization_type": "asymmetric"},
        "different_groups": {"aq": {"params": {"bits": 8}, "modules": ["*"]}}},
    "sparse_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 2, "method": "l1"},
        "different_groups": {"sp": {"params": {"dense_ratio": 0.5},
                                    "modules": ["w_gate", "w_up", "w_down"]}}},
    "head_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 0},
        "different_groups": {"hp": {"params": {"dense_ratio": 0.5}, "modules": ["wo"]}}},
}
TOOLING_HEAD_PRUNING = {"head_pruning": TOOLING_COMPRESSION["head_pruning"]}
CLEAN_S = SERVE_SHAPE[1]
# the cleaned model against the masked one in fp32: summation order only,
# held at K1's fp32 per-element limit
CLEAN_FP32_ROW_REL = AGREE_TOL["fwd"][torch.float32]["elem_rtol"]
STUDENT_LAYERS = 8
# the sparse masks keep their dense ratio 0.5 and the ties at the threshold
# (JAX's `>=`): a few % more on the quantized grid, not the ~0.92 that the
# fake-quant's own zeros leave without a mask
PRUNE_KEPT_MAX = 0.55
PROFILE_STEP, PROFILE_STEPS = 2, 3
PROFILE_RTOL = 0.02
# Micro-batch 2 is left out so the trials give the kernels only shapes
# phase kernel holds (1, and 16's forward): K1 at (2, 16384, 14x128) equals
# SDPA and a reference that rounds P to bf16 before PV, element for element
# at its worst, yet on phase kernel's draw that element needs 0.121 rms
# units, over AGREE_TOL's 0.1 (PERF.md; tests/k1_precision_probe.py).
AUTOTUNE_SPACE = {"zero_stages": [0, 3], "mbs_candidates": [1, 16],
                  "remat_policies": ["nothing_saveable"], "fast": True,
                  "start_profile_step": 1, "end_profile_step": 3}


def _steps(engine, batch, n):
    """``n`` timed ``train_batch`` steps: (losses, seconds, K1/K2/K3 launches
    of each step)."""
    losses, secs, per_step = [], [], []
    for _ in range(n):
        before = kernel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        per_step.append(tuple(a - b for a, b in zip(kernel_counts(), before)))
    return losses, secs, per_step


def _row_rel(got, ref) -> float:
    """The worst row's relative L2 distance (fp32)."""
    g, r = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    return float(((g - r).norm(dim=-1) / r.norm(dim=-1)).max())


def _tooling_compression(seed: int, batch) -> dict:
    """TOOLING_STEPS compressed steps of the train cell; then the
    transformed leaves at the last step, and the kernel path against the
    plain branch at PARITY_S (``_compressed_parity``)."""
    from deepspeed_tpu_torch.compression import bit_schedule
    from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path, tree_leaves

    S = TRAIN_SHAPE[1]
    # the plain cell's step under the same conditions (no monitor, no
    # profiler), the compressed step's yardstick
    _, engine = _train_engine(seed, S)
    _, plain_secs, _ = _steps(engine, batch, PLAIN_CELL_STEPS)
    del engine
    free_memory()
    extra = {"compression_training": TOOLING_COMPRESSION}
    model, engine = _train_engine(seed, S, config_extra=extra)
    cfg = model.config
    L = cfg.num_layers
    check(cfg.act_quant_bits == 8, "activation quantization was not wired into the model")
    reset_counts()
    losses, secs, per_step = _steps(engine, batch, TOOLING_STEPS)
    launches = kernel_counts()
    check(all(math.isfinite(x) for x in losses), f"compressed loss not finite: {losses}")
    check(losses[-1] < losses[0], f"compressed loss did not fall: {losses}")
    check(all(p == (2 * L, L, L) for p in per_step),
          f"compressed steps launched K1/K2/K3 {per_step}, expected {(2 * L, L, L)} each")
    # the compute view the next step differentiates (every offset passed)
    step = engine.state.step
    paths = [p for p, _ in tree_flatten_with_path(engine.state.params)]
    view = dict(zip(paths, engine._compressed(tree_leaves(engine.state.params))))
    bits = bit_schedule(step, 8, 4, 1, 2)
    kept, distinct, heads = {}, {}, []
    with torch.no_grad():
        for name in ("w_gate", "w_up", "w_down"):
            w = view["layers/" + name]
            kept[name] = [float((w[i] != 0).float().mean()) for i in range(L)]
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            w = view["layers/" + name]
            distinct[name] = max(int(torch.unique(w[i]).numel()) for i in (0, L - 1))
        wo = view["layers/wo"].reshape(L, cfg.num_heads, -1)
        heads = [int((wo[i].abs().sum(-1) > 0).sum()) for i in range(L)]
    check(all(0.5 <= k <= PRUNE_KEPT_MAX for ks in kept.values() for k in ks),
          f"a pruned MLP leaf keeps outside [0.5, {PRUNE_KEPT_MAX}]: {kept}")
    check(all(n <= 2 ** bits for n in distinct.values()),
          f"a {bits}-bit leaf holds more than {2 ** bits} values: {distinct}")
    check(all(h >= cfg.num_heads // 2 for h in heads) and min(heads) < cfg.num_heads,
          f"head pruning kept {heads} of {cfg.num_heads} heads")
    del engine, view, wo
    free_memory()

    parity = _compressed_parity(seed, extra)
    return {"config": TOOLING_COMPRESSION, "losses": losses, "step_s": secs,
            "median_step_s": statistics.median(secs[1:]),
            "plain_cell_step_s": plain_secs,
            "plain_cell_median_step_s": statistics.median(plain_secs[1:]),
            "launches": dict(zip(("K1", "K2", "K3"), launches)),
            "launches_per_step": dict(zip(("K1", "K2", "K3"), per_step[-1])),
            "view_step": step, "view_bits": bits, "dense_kept": kept,
            "max_distinct_values": distinct, "heads_kept": heads,
            "parity": parity}


def _compressed_parity(seed: int, extra: dict) -> dict:
    """The kernel path against the plain branch at PARITY_S under
    compression, step by step on the same weights: before each of
    PARITY_STEPS steps, the loss and gradient norm of the engine's
    compressed tree through the kernels (attn_impl "auto") and through the
    plain branch ("xla"); the step then runs through the kernels.  (Two
    free-running trajectories part by more than the plain gate allows once
    a bf16 difference moves a weight or an activation across a fake-quant
    level: 1.2% in loss at step 2 on the card.)"""
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(seed + 70)
    base = CausalLM(TRAIN_MODEL, max_seq_len=PARITY_S)
    params = base.init_fn(gen)
    batch = {"input_ids": torch.randint(0, base.config.vocab_size, (1, PARITY_S),
                                        generator=gen, device="cuda")}
    model, eng = _train_engine(seed, PARITY_S, params=params, config_extra=extra)
    del params
    steps = []
    for _ in range(PARITY_STEPS):
        rec = {}
        for impl in ("auto", "xla"):
            model.attn_impl = impl
            work = eng._work_tree()
            before = kernel_counts()
            loss = eng.loss_fn(eng._view(work), batch,
                               torch.Generator(device="cuda").manual_seed(seed))
            grads = torch.autograd.grad(loss, [x for x in tree_leaves(work) if x.requires_grad])
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            rec[impl] = {"loss": float(loss.detach()), "grad_norm": float(norm),
                         "launches": tuple(a - b for a, b in zip(kernel_counts(), before))}
            del work, loss, grads
        model.attn_impl = "auto"
        k, p = rec["auto"], rec["xla"]
        rec["loss_rel"] = abs(k["loss"] - p["loss"]) / abs(p["loss"])
        rec["grad_norm_rel"] = abs(k["grad_norm"] - p["grad_norm"]) / abs(p["grad_norm"])
        rec["train_loss"] = float(eng.train_batch(batch=batch))
        steps.append(rec)
    L = model.config.num_layers
    del eng, model, batch
    free_memory()
    for i, rec in enumerate(steps):
        check(rec["auto"]["launches"] == (2 * L, L, L) and rec["xla"]["launches"] == (0, 0, 0),
              f"parity step {i}: launches {rec}")
        check(rec["loss_rel"] <= PARITY_LOSS_RTOL and rec["grad_norm_rel"] <= PARITY_GRAD_NORM_RTOL,
              f"compressed training, step {i}: kernel path vs plain branch {rec}")
    return {"S": PARITY_S, "steps": steps, "loss_rtol": PARITY_LOSS_RTOL,
            "grad_norm_rtol": PARITY_GRAD_NORM_RTOL}


def _tooling_clean(seed: int) -> dict:
    """``redundancy_clean`` of a head-pruned llama-740m (14 -> 7 heads):
    its ``init_inference`` forward (K1 over 7 heads) against the masked
    model's (K1 over 14, half of them zero in wo); then
    ``student_initialization`` (16 -> STUDENT_LAYERS layers) and one train
    step of the student.

    The two bf16 forwards differ only in bf16 roundings (matmuls over
    fewer columns, or a K dim half as long), which 16 random layers
    amplify; the bound is the K1 path's own bf16 spread on the masked
    model, its distance from the same model through the plain branch.  In
    fp32 (K1's fp32 variant) the two agree to summation order:
    CLEAN_FP32_ROW_REL."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.compression import (build_param_transform, redundancy_clean,
                                                 student_initialization)
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.utils.tree import tree_map

    cfg = CausalLM(TRAIN_MODEL).config
    gen = torch.Generator(device="cuda").manual_seed(seed + 71)
    params = CausalLM(TRAIN_MODEL).init_fn(gen)                  # fp32
    tokens = torch.randint(0, cfg.vocab_size, (1, CLEAN_S), generator=gen, device="cuda")
    block = {"compression_training": TOOLING_HEAD_PRUNING}
    with torch.no_grad():
        masked = build_param_transform(block, num_heads=cfg.num_heads)(params, 0)
    cleaned, dims = redundancy_clean(params, block, num_heads=cfg.num_heads)
    check(dims == {"num_heads": cfg.num_heads // 2}, f"redundancy_clean gave {dims}")

    def logits(tree, heads, dtype, impl="auto"):
        model = CausalLM(TRAIN_MODEL, max_seq_len=CLEAN_S, num_heads=heads,
                         head_dim=cfg.dims_per_head, attn_impl=impl, dtype=dtype)
        eng = deepspeed_tpu_torch.init_inference(
            model, config={"dtype": "bf16" if dtype == torch.bfloat16 else "float32"},
            params=tree_map(lambda x: x.to(dtype), tree))
        reset_counts()
        out = eng.forward(tokens).float()
        torch.cuda.synchronize()
        return out, kernel_counts()[0]

    H, h = cfg.num_heads, dims["num_heads"]
    got, k1_clean = logits(cleaned, h, torch.bfloat16)
    ref, k1_masked = logits(masked, H, torch.bfloat16)
    rel = _row_rel(got, ref)
    del got
    plain, _ = logits(masked, H, torch.bfloat16, impl="xla")
    bound = _row_rel(ref, plain)
    del plain
    dense, _ = logits(params, H, torch.bfloat16)
    yard = _row_rel(dense, ref)
    del dense, ref
    got32, _ = logits(cleaned, h, torch.float32)
    ref32, _ = logits(masked, H, torch.float32)
    rel32 = _row_rel(got32, ref32)
    del got32, ref32, masked, cleaned
    free_memory()
    rec = {"S": CLEAN_S, "new_dims": dims, "worst_row_rel": rel,
           "bound_kernel_vs_plain_row_rel": bound, "unpruned_vs_masked_row_rel": yard,
           "fp32_worst_row_rel": rel32, "fp32_limit": CLEAN_FP32_ROW_REL,
           "k1_launches": {"cleaned": k1_clean, "masked": k1_masked},
           "k1_shape_cleaned": [1, CLEAN_S, h, cfg.dims_per_head]}
    emit({"phase": "tooling/clean_forward", **rec})
    check(k1_clean == cfg.num_layers and k1_masked == cfg.num_layers,
          f"the forwards launched K1 {k1_clean}/{k1_masked} times, expected {cfg.num_layers}")
    check(rel <= bound, f"the cleaned model's logits stray from the masked model's "
                        f"further than K1's own bf16 spread: {rec}")
    check(rel32 <= CLEAN_FP32_ROW_REL, f"fp32: the cleaned model's logits stray: {rec}")
    check(yard > bound, f"the clean gate passes the unpruned model too: {rec}")
    lr_block = {"compression_training": {"layer_reduction": {
        "enabled": True, "keep_number_layer": STUDENT_LAYERS}}}
    student = student_initialization(params, lr_block)
    del params
    S = TRAIN_SHAPE[1]
    _, eng = _train_engine(seed, S, params=student, num_layers=STUDENT_LAYERS)
    del student
    reset_counts()
    losses, secs, per_step = _steps(eng, _train_batch(cfg, S, seed + 72), 1)
    check(math.isfinite(losses[0]) and per_step[0] == (2 * STUDENT_LAYERS, STUDENT_LAYERS,
                                                       STUDENT_LAYERS),
          f"the student's step: loss {losses}, launches {per_step}")
    del eng
    free_memory()
    return {**rec, "student_layers": STUDENT_LAYERS, "student_loss": losses[0],
            "student_step_s": secs[0], "student_launches": per_step[0]}


def _profile_analytic(model, S: int) -> dict:
    """The work a step of the train cell executes: every matmul 2*M*K*N
    forward and twice that backward, the layers' recompute under
    nothing_saveable but its last product (w_down, whose output no
    backward reads), and the attention kernels' own count per launch
    (``attention_cost``: K1 twice a layer, K2 and K3 once).  The port's
    own per-launch count (``kernel_cost``, what its profiler adds for each
    ctypes launch) must equal ``attention_cost`` here."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import attended_pairs, kernel_cost

    cfg = model.config
    shapes = model.init_fn(torch.Generator(), device="meta")
    layer = {k: x for k, x in shapes["layers"].items() if x.dim() == 3}
    per_token = {k: 2 * x.shape[0] * x.shape[1] * x.shape[2] for k, x in layer.items()}
    head = 2 * cfg.hidden_size * cfg.vocab_size
    matmul = 3 * S * (sum(per_token.values()) + head)
    recompute = S * (sum(per_token.values()) - per_token["w_down"])
    pairs = _pairs(S, True)
    dims = (1, S, cfg.num_heads, cfg.kv_heads, cfg.dims_per_head, 2, pairs)
    cost = {k: attention_cost(k, *dims)[0] for k in ATTN_GEMMS}
    port = {k: kernel_cost(k, *dims) for k in ATTN_GEMMS}
    check(attended_pairs(S, True) == pairs
          and all(port[k] == attention_cost(k, *dims) for k in ATTN_GEMMS),
          f"the port's kernel_cost {port} differs from attention_cost at {dims}")
    attn = cfg.num_layers * (2 * cost["fwd"] + cost["dq"] + cost["dkv"])
    return {"matmul": matmul, "recompute": recompute, "attention": attn,
            "total": matmul + recompute + attn,
            "formula": "3*S*(sum over the layer matrices of 2*L*in*out + 2*d*V) "
                       "+ S*(the same sum but w_down) + L*(2*K1 + K2 + K3), "
                       "K = ATTN_GEMMS[kernel]*2*Hq*S*(S+1)/2*hd"}


def _tooling_profile_monitor(seed: int, batch) -> dict:
    """The plain train cell with the flops profiler at PROFILE_STEP and the
    CSV and TensorBoard monitors into a temporary directory."""
    import tempfile

    S = TRAIN_SHAPE[1]
    out = tempfile.mkdtemp(prefix="tooling_")
    report = os.path.join(out, "flops_profile.txt")
    extra = {"flops_profiler": {"enabled": True, "profile_step": PROFILE_STEP,
                                "output_file": report},
             "csv_monitor": {"enabled": True, "output_path": out, "job_name": "cell"},
             "tensorboard": {"enabled": True, "output_path": out, "job_name": "cell"}}
    model, engine = _train_engine(seed, S, config_extra=extra)
    reset_counts()
    losses, secs, per_step = _steps(engine, batch, PROFILE_STEPS)
    prof = engine.flops_profiler.as_dict()
    want = _profile_analytic(model, S)
    rel = abs(prof["flops"] - want["total"]) / want["total"]
    check(rel <= PROFILE_RTOL, f"profiled flops {prof['flops']} vs analytic "
                               f"{want['total']}: {rel:.4f} > {PROFILE_RTOL}")
    check(prof["kernel_flops"] > 0 and "attention kernels' flops" in open(report).read(),
          f"the profile has no attention row: {prof}")
    engine.monitor.tb_monitor.summary_writer.close()
    csv_rows = open(os.path.join(out, "cell", "Train_Samples_train_loss.csv")).read()
    csv_losses = [float(r.split(",")[1]) for r in csv_rows.splitlines()[1:]]
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    tb = []
    for name in sorted(os.listdir(os.path.join(out, "cell"))):
        if name.startswith("events"):
            for event in EventFileLoader(os.path.join(out, "cell", name)).Load():
                # the loader may hand a scalar over as a one-element tensor
                tb += [(v.tag, v.simple_value if v.HasField("simple_value")
                        else v.tensor.float_val[0] if v.tensor.float_val
                        else float(torch.frombuffer(bytearray(v.tensor.tensor_content),
                                                    dtype=torch.float32)[0]), event.step)
                       for v in event.summary.value if v.tag == "Train/Samples/train_loss"]
    check(csv_losses == losses, f"CSV losses {csv_losses} != train_batch's {losses}")
    check([(s, v) for _, v, s in tb] == [(i + 1, float(torch.tensor(x).float()))
                                          for i, x in enumerate(losses)],
          f"TensorBoard losses {tb} != train_batch's {losses}")
    del engine, model
    free_memory()
    return {"profile_step": PROFILE_STEP, "counted_flops": prof["flops"],
            "kernel_flops": prof["kernel_flops"], "dispatched_flops": prof["dispatched_flops"],
            "bytes_accessed": prof["bytes accessed"], "profiled_step_s": prof["duration_s"],
            "analytic": want, "rel_diff": rel, "limit": PROFILE_RTOL,
            "report": open(report).read().splitlines(), "losses": losses, "step_s": secs,
            "launches_per_step": per_step,
            "monitor": {"csv": csv_losses, "tensorboard": [v for _, v, _ in tb]}}


def _tooling_autotune(seed: int) -> dict:
    """Gridsearch over AUTOTUNE_SPACE on the train cell (fast mode): the
    micro-batch the card cannot hold ends its sweep as ``compile_oom``."""
    import tempfile

    from deepspeed_tpu_torch.autotuning import autotune
    from deepspeed_tpu_torch.models import CausalLM

    S = TRAIN_SHAPE[1]
    rd = tempfile.mkdtemp(prefix="autotune_")
    base = {**TRAIN_CONFIG, "seed": seed,
            "autotuning": {"enabled": True, "results_dir": rd, **AUTOTUNE_SPACE}}
    gen = torch.Generator(device="cuda").manual_seed(seed + 73)
    vocab = CausalLM(TRAIN_MODEL).config.vocab_size
    t0 = time.perf_counter()
    reset_counts()
    best, records = autotune(
        lambda: CausalLM(TRAIN_MODEL, max_seq_len=S), base,
        lambda e: {"input_ids": torch.randint(0, vocab, (e.train_batch_size, S),
                                              generator=gen, device="cuda")})
    launches = kernel_counts()
    seconds = time.perf_counter() - t0
    recs = [r.as_dict() for r in records]
    for stage in AUTOTUNE_SPACE["zero_stages"]:
        mine = [r for r in recs if r["config_overrides"]["zero_optimization"]["stage"] == stage]
        check(mine and mine[-1]["status"] == "compile_oom"
              and mine[-1]["config_overrides"]["train_micro_batch_size_per_gpu"] == 16,
              f"stage {stage}: micro-batch 16 did not end as compile_oom: {mine}")
        check(all(r["status"] == "ok" for r in mine[:-1]), f"stage {stage}: {mine}")
    check(sorted(os.listdir(rd)) == ["best_config.json", "records.json"],
          f"autotuning results: {os.listdir(rd)}")
    free_memory()
    # the card trains afterwards
    cfg = CausalLM(TRAIN_MODEL).config
    _, eng = _train_engine(seed, S)
    after, _, _ = _steps(eng, _train_batch(cfg, S, seed + 74), 1)
    check(math.isfinite(after[0]), f"training after the autotuner: loss {after}")
    del eng
    free_memory()
    return {"space": AUTOTUNE_SPACE, "records": recs, "best": best, "seconds": seconds,
            "launches": dict(zip(("K1", "K2", "K3"), launches)), "loss_after": after[0],
            "card_memory_bytes": torch.cuda.get_device_properties(0).total_memory}


def _tooling_on_device() -> dict:
    """llama2-7b under ``OnDevice(device="meta")``: no byte on the card, the
    shapes of the real tree."""
    from deepspeed_tpu_torch import OnDevice
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

    model = CausalLM(LORA_MODEL)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with OnDevice(dtype=torch.bfloat16, device="meta"):
        meta = model.init_fn(torch.Generator())
    meta_bytes = torch.cuda.memory_allocated() - before
    real = model.init_fn(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    shapes = {p: (tuple(x.shape), x.dtype) for p, x in tree_flatten_with_path(meta)}
    same = shapes == {p: (tuple(x.shape), x.dtype) for p, x in tree_flatten_with_path(real)}
    real_bytes = sum(x.numel() * x.element_size() for _, x in tree_flatten_with_path(real))
    del real
    free_memory()
    check(meta_bytes == 0, f"OnDevice(meta) allocated {meta_bytes} bytes on the card")
    check(same, "the meta tree's shapes differ from the real tree's")
    return {"model": LORA_MODEL, "meta_bytes": meta_bytes, "real_tree_bytes": real_bytes,
            "leaves": len(shapes), "shapes_equal": same}


def phase_tooling(seed: int) -> dict:
    """Item 11's tooling half on the train cell: compression training,
    cleanup and layer reduction, the flops profiler and the monitors, the
    autotuner, OnDevice."""
    from deepspeed_tpu_torch.models import CausalLM

    t0 = time.perf_counter()
    # phase train's batch: the plain cell below is that cell
    batch = _train_batch(CausalLM(TRAIN_MODEL).config, TRAIN_SHAPE[1], seed + 1)
    rec = {"phase": "tooling", "model": TRAIN_MODEL, "S": TRAIN_SHAPE[1]}
    for part, run in (("compression", lambda: _tooling_compression(seed, batch)),
                      ("clean", lambda: _tooling_clean(seed)),
                      ("flops_profiler", lambda: _tooling_profile_monitor(seed, batch)),
                      ("autotune", lambda: _tooling_autotune(seed)),
                      ("on_device", _tooling_on_device)):
        t = time.perf_counter()
        rec[part] = run()
        rec[part]["part_seconds"] = time.perf_counter() - t
        emit({"phase": f"tooling/{part}", **rec[part]})   # each part as it ends
    rec["compressed_step_s_vs_plain_cell"] = {
        "compressed": rec["compression"]["median_step_s"],
        "plain": rec["compression"]["plain_cell_median_step_s"]}
    rec["seconds"] = time.perf_counter() - t0
    emit({"phase": "tooling", "seconds": rec["seconds"],
          "compressed_step_s_vs_plain_cell": rec["compressed_step_s_vs_plain_cell"],
          "part_seconds": {k: rec[k]["part_seconds"] for k in (
              "compression", "clean", "flops_profiler", "autotune", "on_device")}})
    return rec


# ---------------------------------------------------------------------------
# Observability and resilience (ROADMAP item 12) on the train and serving
# cells: per-program statistics and the live train/tflops_est and
# train/mfu_est gauges, the device-trace window, SLO rules, /metrics, the
# hang watchdog in the trainer, the serving engine and a child process
# ---------------------------------------------------------------------------

OBS_PEAK_TFLOPS = "989"                 # the card's bf16 peak (PEAK_FLOPS), as TFLOP/s
OBS_WATCHDOG_S = 120.0
OBS_STEPS, OBS_WINDOW_STEPS, OBS_TRAIN_TURNS = 6, 2, 3
# the train window: OBS_WINDOW_STEPS steps held to their exact kernel
# events, between one step at each edge of the window (reported, not
# held): a whole-script run on an H100 saw the profiler keep 63 of a
# window's 64 K1 events, a loss at an edge of the capture
OBS_WINDOW_EDGE = 1
OBS_TFLOPS_RTOL = 0.10                  # last train/tflops_est against FLOP / median step
OBS_SAMPLE_EVERY = 10
OBS_SERVE_WINDOW = 3                    # working ticks in the serving trace window
# the child: a 2 s watchdog around a ~10 s device sleep and one blocking
# wait; it must exit RC_HANG within 15 s of arming
OBS_CHILD_WATCHDOG_S, OBS_CHILD_SLEEP_S, OBS_CHILD_LIMIT_S = 2.0, 10.0, 15.0
OBS_WAITS = ("synchronize", "cpu_copy", "nccl_barrier")
OBS_RUN_KEYS = ("mean_decode_tick_ms", "median_decode_tick_ms", "run_s",
                "output_tok_per_s", "engine_build_s", "ttft_p50_s", "ttft_p99_s")
OBS_KERNEL_SYMBOLS = {"K1": "flash_fwd_wgmma_kernel", "K2": "flash_bwd_dq_kernel",
                      "K3": "flash_bwd_dkv_kernel", "K4": "decode_attention_kernel"}


def watchdog_child(wait: str) -> int:
    """Arm a HangWatchdog of OBS_CHILD_WATCHDOG_S around a device sleep of
    ~OBS_CHILD_SLEEP_S and then one blocking wait (``wait``: a
    ``torch.cuda.synchronize``, the host copy of a tensor the sleep's stream
    writes, or an NCCL barrier queued behind the sleep).  The watchdog's
    daemon thread can only run if the blocked call released the GIL; then
    it exits the process with RC_HANG.  Prints the arming time first."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.resilience import HangWatchdog

    torch.cuda.set_device(0)
    # released by the parent when the card is free to share: until then
    # nothing here touches CUDA (an end of input without the word: exit)
    if sys.stdin.readline().strip() != "go":
        return 0
    t_go = time.time()
    x = torch.zeros(1024, device="cuda")
    if wait == "nccl_barrier":
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                rank=0, world_size=1)
        dist.barrier()          # the communicator exists before the window
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(int(1e8))
    end.record()
    end.synchronize()
    cycles_per_s = 1e8 / (start.elapsed_time(end) / 1e3)
    wd = HangWatchdog(timeout_s=OBS_CHILD_WATCHDOG_S, poll_s=0.02)
    label = f"device wait {wait}"
    print(json.dumps({"armed_epoch": time.time(), "released_epoch": t_go,
                      "cycles_per_s": cycles_per_s}), flush=True)
    with wd.armed(label):
        torch.cuda._sleep(int(cycles_per_s * OBS_CHILD_SLEEP_S))
        if wait == "synchronize":
            torch.cuda.synchronize()
        elif wait == "cpu_copy":
            x.add_(1).cpu()
        else:
            dist.barrier()
    # reached only if the wait returned before the watchdog could exit
    print(json.dumps({"returned_epoch": time.time()}), flush=True)
    return 0


_OBS_CHILDREN: dict = {}   # wait -> (start epoch, Popen), between the two parts


def _start_watchdog_children() -> None:
    """Start the children early (their imports overlap the serving part);
    each waits for ``go`` on its input before it touches the card."""
    for wait in OBS_WAITS:
        _OBS_CHILDREN[wait] = (time.time(), subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--watchdog-child", wait],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))


def _release_watchdog_children() -> None:
    for _, p in _OBS_CHILDREN.values():
        p.stdin.write("go\n")
        p.stdin.flush()   # communicate() closes it


def _join_watchdog_children() -> dict:
    out = {}
    children = dict(_OBS_CHILDREN)
    _OBS_CHILDREN.clear()
    for wait, (t0, p) in children.items():
        try:
            stdout, stderr = p.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        end = time.time()
        lines = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
        armed = next((ln["armed_epoch"] for ln in lines if "armed_epoch" in ln), None)
        released = next((ln["released_epoch"] for ln in lines if "released_epoch" in ln),
                        None)
        out[wait] = {"rc": p.returncode, "child_wall_s": end - t0,
                     "exit_after_release_s": end - released if released else None,
                     "exit_after_arming_s": end - armed if armed is not None else None,
                     "returned_before_exit": any("returned_epoch" in ln for ln in lines),
                     "report_names_label": f"'device wait {wait}'" in stderr,
                     "stderr_tail": stderr.strip().splitlines()[-3:]}
    return out


def _trace_kernels(path: str, annotation: str, kernels) -> dict:
    """Count ``kernels``' events (OBS_KERNEL_SYMBOLS) in a torch.profiler
    Chrome trace, and how many of them lie inside an ``annotation`` range:
    on the GPU timeline (``gpu_user_annotation``), or launched (by their
    runtime call's correlation id) inside the CPU range."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {"gpu": [], "cpu": []}
    launch_ts = {}
    graph_launches = 0
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        if name == annotation and cat in ("gpu_user_annotation", "user_annotation"):
            side = "gpu" if cat == "gpu_user_annotation" else "cpu"
            ranges[side].append((e["ts"], e["ts"] + e.get("dur", 0)))
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
            if "GraphLaunch" in name:
                graph_launches += 1

    def inside(ts, side, dur=0):
        return any(lo <= ts and ts + dur <= hi for lo, hi in ranges[side])

    cpu_ranges = sorted(ranges["cpu"])
    out = {"annotations": {k: len(v) for k, v in ranges.items()},
           "graph_launches": graph_launches,
           # each annotation range's events, in order (by launch)
           "per_range": [{key: 0 for key in kernels} for _ in cpu_ranges]}
    for key in kernels:
        sym = OBS_KERNEL_SYMBOLS[key]
        ks = [e for e in events if e.get("cat") == "kernel" and sym in e.get("name", "")]
        gpu = sum(inside(e["ts"], "gpu", e.get("dur", 0)) for e in ks)
        cpu = 0
        for e in ks:
            ts = launch_ts.get((e.get("args") or {}).get("correlation"), -1)
            i = next((i for i, (lo, hi) in enumerate(cpu_ranges) if lo <= ts <= hi), None)
            if i is not None:
                cpu += 1
                out["per_range"][i][key] += 1
        out[key] = {"events": len(ks), "inside_gpu_range": gpu,
                    "launched_inside_cpu_range": cpu}
    return out


def _trace_kernel_events(path: str, kernels) -> dict:
    """The number of ``kernels``' events (OBS_KERNEL_SYMBOLS) in a
    torch.profiler Chrome trace, kernels replayed by a CUDA graph
    included."""
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    return {key: sum(OBS_KERNEL_SYMBOLS[key] in name for name in names) for key in kernels}


def observability_train(seed: int, profiler_flops=None) -> dict:
    """The train cell with a monitor and the watchdog: ``train_step``'s
    counted FLOP against the analytic count (and the flops profiler's, when
    phase tooling ran), the live gauges against FLOP over the measured
    step, a device-trace window of OBS_WINDOW_STEPS steps, then the step
    with the hooks off and on in turns."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.monitor import InMemoryMonitor
    from deepspeed_tpu_torch.observability import device_profiler as dp
    from deepspeed_tpu_torch.observability.program_stats import PEAK_TFLOPS_ENV

    S = TRAIN_SHAPE[1]
    old_peak = os.environ.get(PEAK_TFLOPS_ENV)
    os.environ[PEAK_TFLOPS_ENV] = OBS_PEAK_TFLOPS
    trace_dir = tempfile.mkdtemp(prefix="obs_train_trace_")
    try:
        # the watchdog children run while the two engines are built
        _release_watchdog_children()
        model, on = _train_engine(seed, S, config_extra={"resilience": {"watchdog": {
            "enabled": True, "timeout_s": OBS_WATCHDOG_S}}})
        mon = on.monitor = InMemoryMonitor()
        on._watchdog.monitor = mon
        _, off = _train_engine(seed, S)
        cfg = model.config
        L = cfg.num_layers
        batch = _train_batch(cfg, S, seed + 1)
        t = time.perf_counter()
        rec = {"watchdog_children": _join_watchdog_children()}
        rec["watchdog_children_wait_s"] = time.perf_counter() - t
        # the main path: counts to 0 just before, read just after
        reset_counts()
        losses, secs, per_step = _steps(on, batch, OBS_STEPS)
        flops = on.program_catalog.flops_of("train_step")
        analytic = _profile_analytic(model, S)["total"]
        tf = mon.series("train/tflops_est")
        mfu = mon.series("train/mfu_est")
        med = statistics.median(secs[1:])
        want = flops / med / 1e12
        rec.update({"steps": OBS_STEPS, "step_s": secs, "losses": losses,
                    "launches_per_step": per_step, "train_step_flops": flops,
                    "analytic_flops": analytic, "profiler_flops": profiler_flops,
                    "train_step_row": on.program_catalog.table()["train_step"],
                    "tflops_est": tf, "mfu_est": mfu, "median_step_s": med,
                    "flops_over_median_step_tflops": want,
                    "last_tflops_est_rel_err": (abs(tf[-1][1] - want) / want if tf
                                                else float("inf")),
                    "watchdog_fired": on._watchdog.fired})
        check(all(p == (2 * L, L, L) for p in per_step),
              f"observability train steps launched K1/K2/K3 {per_step}")
        check(abs(flops - analytic) / analytic <= PROFILE_RTOL,
              f"train_step FLOP {flops} vs analytic {analytic}")
        check(profiler_flops is None or flops == profiler_flops,
              f"train_step FLOP {flops} != the flops profiler's {profiler_flops}")
        check([s for s, _ in tf] == list(range(2, OBS_STEPS + 1))
              and [s for s, _ in mfu] == list(range(2, OBS_STEPS + 1)),
              f"gauges at steps {tf} / {mfu}")
        check(rec["last_tflops_est_rel_err"] <= OBS_TFLOPS_RTOL,
              f"train/tflops_est {tf[-1][1]} vs FLOP / median step {want}")
        check(all(abs(m - v * 1e12 / (float(OBS_PEAK_TFLOPS) * 1e12)) <= 1e-12 * max(m, 1e-30)
                  + 1e-15 for (_, m), (_, v) in zip(mfu, tf)),
              f"train/mfu_est {mfu} != train/tflops_est / {OBS_PEAK_TFLOPS}")
        check(not on._watchdog.fired, "the train watchdog fired")
        # the device-trace window: OBS_WINDOW_STEPS steps between its edges
        units = OBS_WINDOW_STEPS + 2 * OBS_WINDOW_EDGE
        cap = dp.capture_device_trace(trace_dir, n_units=units)
        check(cap is not None and cap.failed is None, "the train trace window did not start")
        t = time.perf_counter()
        _, win_s, win_steps = _steps(on, batch, units)
        check(not cap.active and cap.trace_path is not None,
              f"the window did not close after {units} steps: {cap.failed}")
        window = _trace_kernels(cap.trace_path, "train.batch", ("K1", "K2", "K3"))
        window.update(window_steps_s=win_s, window_s=time.perf_counter() - t,
                      annotations_entered=cap.annotations,
                      trace_mb=os.path.getsize(cap.trace_path) / 1e6)
        rec["trace_window"] = window
        check(window["annotations"]["cpu"] == units,
              f"train.batch annotations in the window: {window['annotations']}")
        held = window["per_range"][OBS_WINDOW_EDGE:OBS_WINDOW_EDGE + OBS_WINDOW_STEPS]
        check(all(r == {"K1": 2 * L, "K2": L, "K3": L} for r in held),
              f"trace window: K1/K2/K3 events a train.batch {window['per_range']}, "
              f"expected {(2 * L, L, L)} in each of the middle {OBS_WINDOW_STEPS}")
        # the hooks' cost: the same step, hooks off and on, in turns
        _steps(off, batch, 1)
        turns = {"off": [], "on": []}
        for _ in range(OBS_TRAIN_TURNS):
            turns["off"] += _steps(off, batch, 1)[1]
            turns["on"] += _steps(on, batch, 1)[1]
        rec["turns_step_s"] = turns
        rec["turns_median_step_s"] = {k: statistics.median(v) for k, v in turns.items()}
        on._watchdog.stop()
        del on, off, model, batch
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
        if old_peak is None:
            os.environ.pop(PEAK_TFLOPS_ENV, None)
        else:
            os.environ[PEAK_TFLOPS_ENV] = old_peak
        free_memory()
    children = rec["watchdog_children"]
    check(children["synchronize"]["rc"] == 85
          and children["synchronize"]["exit_after_arming_s"] <= OBS_CHILD_LIMIT_S
          and children["synchronize"]["report_names_label"],
          f"the watchdog child blocked in torch.cuda.synchronize: {children['synchronize']}")
    return rec


def check_k4_cost() -> dict:
    """K4's cost sink (``decode_cost``, from the launch's shapes) against
    this script's own formula (``decode_work``) at the serving cell's decode
    shape with every slot's keys attended, in bf16 and int8."""
    from deepspeed_tpu_torch.ops.kernels.decode_attention import decode_cost

    case = next(c for c in DECODE_CASES if c[0] == "serve")
    _, B, Hq, Hkv, hd, dtype, page, maxp = case
    esize = torch.tensor([], dtype=dtype).element_size()
    full = [page * maxp - 1] * B
    out = {}
    for int8 in (False, True):
        port = decode_cost(B, Hq, Hkv, hd, esize, page, maxp, page * maxp, int8=int8)
        mine = decode_work(case, full, int8=int8)
        check(port == mine, f"K4's cost sink {port} != decode_work {mine} (int8={int8})")
        out["int8" if int8 else "bf16"] = {"flops": port[0], "bytes": port[1]}
    return out


def observability_serving(engine, seed: int, stream, first, plain: dict) -> dict:
    """The serving cell with the monitor, the watchdog, two SLO rules (one
    must fire, one must not), program statistics sampled every
    OBS_SAMPLE_EVERY-th invocation and the /metrics endpoint on an
    ephemeral 127.0.0.1 port, a device-trace window over its first
    OBS_SERVE_WINDOW working ticks.  Its ticks after the window are held
    beside ``plain``, the same stream's plain run before it on the same
    engine (``first`` its tokens): the hooks' cost, in turns."""
    import shutil
    import tempfile
    import urllib.request

    import numpy as np
    from deepspeed_tpu_torch.monitor import InMemoryMonitor
    from deepspeed_tpu_torch.observability import SloRule
    from deepspeed_tpu_torch.observability import device_profiler as dp
    from deepspeed_tpu_torch.observability import export
    from deepspeed_tpu_torch.profiling.flops_profiler.profiler import CostCounter
    from deepspeed_tpu_torch.resilience import HangWatchdog

    _start_watchdog_children()
    cfg = engine.model.config
    L = cfg.num_layers
    rec = {"k4_cost": check_k4_cost()}
    trace_dir = tempfile.mkdtemp(prefix="obs_serve_trace_")
    env = {export.METRICS_PORT_ENV: "0", export.METRICS_HOST_ENV: "127.0.0.1"}
    old_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    caps = []

    def instrumented(mon, wd=None):
        return dict(monitor=mon, watchdog=wd, program_stats_sample_every=OBS_SAMPLE_EVERY,
                    slo_rules=[SloRule.parse("serve/queue_depth < 0", name="must_fire"),
                               SloRule.parse("serve/free_pages >= 0", name="must_not_fire")])

    def arm(sv):
        caps.append(dp.capture_device_trace(trace_dir, n_units=OBS_SERVE_WINDOW))

    def restore_env():
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if export.get_metrics_server() is not None:
            export.get_metrics_server().close()
            export._METRICS_SERVER = None

    try:
        mon = InMemoryMonitor()
        wd = HangWatchdog(timeout_s=OBS_WATCHDOG_S, monitor=mon)
        reset_counts()
        sv, outs, run = _serve_once(engine, stream, "observability", before_run=arm,
                                    keep_ticks=True, **instrumented(mon, wd))
        ticks = run.pop("tick_s")
        ex = sv._exec
        stats = sv.program_stats()
        health = sv.health()
        port = health["metrics_port"]
        check(port is not None, "no /metrics endpoint under DS_TPU_METRICS_PORT=0")
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=30).read().decode()
        # one eager decode step under the counter (every slot inactive: it
        # writes only to the trash page): the K4 launches and their cost
        ex._g_active.zero_()
        with torch.no_grad(), CostCounter() as counter:
            ex._decode_forward(ex._g_pt, ex._g_len, ex._g_tok, ex._g_active)
        torch.cuda.synchronize()
        eager = counter.cost()
        cap = caps[0]
        check(cap is not None and cap.failed is None and cap.trace_path is not None,
              f"the serving trace window failed: {cap and cap.failed}")
        window = _trace_kernels(cap.trace_path, "serve.decode", ("K4",))
        decode = stats["decode"]
        k4_flops = L * rec["k4_cost"]["bf16"]["flops"]
        rec.update({
            "run": {k: run[k] for k in ("run_s", "output_tok_per_s", "decode_ticks",
                                        "mean_decode_tick_ms", "median_decode_tick_ms",
                                        "graph_captures", "k4_counter", "engine_build_s",
                                        "ttft_p50_s", "ttft_p99_s")},
            "tokens_equal_uninstrumented": all(np.array_equal(outs[r], first[r])
                                               for r in first),
            "program_stats": stats, "alerts": health["alerts"],
            "slo_states": sv.slo_states(), "metrics_port": port,
            "scrape_has": {key: key in body for key in (
                "dstpu_serve_tokens_per_sec", 'dstpu_serve_program_flops{program="decode"}',
                'dstpu_alert{rule="must_fire"} 1', 'dstpu_alert{rule="must_not_fire"} 0')},
            "decode_eager_cost": {k: eager[k] for k in (
                "flops", "bytes accessed", "kernel_flops", "kernel_bytes",
                "kernel_launches")},
            "decode_sampled_mean_ms": 1e3 * decode.get("sampled_mean_s", float("nan")),
            "decode_tick_median_ms": run["median_decode_tick_ms"],
            "watchdog_fired": wd.fired, "trace_window": window,
            "k4_in_window": ("kernel events inside the replays" if window["K4"]["events"]
                             else "graph launches only")})
        check(rec["tokens_equal_uninstrumented"],
              "the instrumented run served other tokens than the plain run")
        check(ex.captures == 1, f"captures {ex.captures}")
        check(decode["invocations"] == ex.replays,
              f"decode invocations {decode['invocations']} != ticks {ex.replays}")
        check(eager["kernel_launches"] == {"decode": L}
              and eager["kernel_flops"] == k4_flops and decode["flops"] == eager["flops"],
              f"decode FLOP {decode['flops']} vs the counted step {eager} "
              f"(K4 {k4_flops})")
        check(decode["synced_samples"] == decode["invocations"] // OBS_SAMPLE_EVERY,
              f"decode samples {decode}")
        check(health["alerts"] == ["must_fire"], f"alerts {health['alerts']}")
        check(all(rec["scrape_has"].values()), f"/metrics lacks {rec['scrape_has']}")
        check(not wd.fired, "the serving watchdog fired")
        wd.stop()
        del sv, ex
        free_memory()
        after = ticks[OBS_SERVE_WINDOW:]
        rec["turns"] = {"off": plain,
                        "on": {**{k: run[k] for k in OBS_RUN_KEYS},
                               "mean_decode_tick_ms_after_window":
                                   1e3 * statistics.mean(after),
                               "median_decode_tick_ms_after_window":
                                   1e3 * statistics.median(after)}}
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
        restore_env()
    return rec


def phase_observability(seed: int, serving=None, tooling=None) -> dict:
    """The observability phase alone (``--only observability``): the
    llama2-7b engine, its serving stream and one plain run of it, then the
    serving part, the watchdog children and the train part."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    t0 = time.perf_counter()
    if serving is None:
        model = CausalLM("llama2-7b")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = model.init_fn(gen, device="cuda", dtype=torch.bfloat16)
        engine = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"},
                                                    params=params)
        stream = serving_stream(seed, model.config.vocab_size)
        sv, first, plain = _serve_once(engine, stream, "plain")
        del sv
        free_memory()
        setup_s = time.perf_counter() - t0
        t = time.perf_counter()
        serving = observability_serving(engine, seed, stream, first,
                                        {k: plain[k] for k in OBS_RUN_KEYS})
        serving["part_seconds"] = time.perf_counter() - t
        del engine, params, model
        free_memory()
    else:
        setup_s = 0.0
    rec = observability_summary(seed, serving, tooling)
    rec["setup_s"] = setup_s
    return rec


def observability_summary(seed: int, serving: dict, tooling=None) -> dict:
    """The train part (with the watchdog children beside its engine build)
    after the serving part; one line for the phase."""
    t = time.perf_counter()
    profiler_flops = tooling["flops_profiler"]["counted_flops"] if tooling else None
    train = observability_train(seed, profiler_flops)
    train["part_seconds"] = time.perf_counter() - t
    rec = {"phase": "observability", "train": train, "serving": serving,
           "part_seconds": {"serving": serving["part_seconds"],
                            "train_and_watchdog": train["part_seconds"]},
           "seconds": serving["part_seconds"] + train["part_seconds"]}
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# Phase elastic (ROADMAP queue 1, item 13's single-host half): the launcher
# starting llama-740m training, one process per card; SIGTERM mid-run; the
# agent saves at the step boundary and exits 75; the supervisor relaunches;
# the new process resumes from the tag and trains to the end
# ---------------------------------------------------------------------------

ELASTIC_LAYERS = 2            # of llama-740m's 16: the time limit
ELASTIC_STEPS = 8
ELASTIC_SIGTERM_AFTER = 3     # SIGTERM once the first process logged this step
ELASTIC_TIMEOUT_S = 600
ELASTIC_BACKOFF_S = 1.0
# bench.py's training defaults without the batch triad, which the elastic
# plan sets: at world 1 micro-batch 1 x gas 4, at 2 cards gas 2, at 4 gas 1
ELASTIC_CONFIG = {
    **{k: v for k, v in TRAIN_CONFIG.items()
       if k not in ("train_micro_batch_size_per_gpu", "gradient_accumulation_steps")},
    "elasticity": {"enabled": True, "max_train_batch_size": 4, "micro_batch_sizes": [1],
                   "min_gpus": 1, "max_gpus": 4},
}
ELASTIC_CARD_CONFIGS = ("elastic4_740m",)
ELASTIC4_SIGTERM_RANK = 2
ELASTIC4_RELAUNCH_GPUS = 2


def _elastic_engine(seed: int, layers: int, zero_stage: int):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    config = {**ELASTIC_CONFIG, "seed": seed,
              "zero_optimization": {"stage": zero_stage}}
    model = CausalLM(TRAIN_MODEL, max_seq_len=TRAIN_SHAPE[1], dtype=torch.bfloat16,
                     num_layers=layers)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config)
    return model, engine


def _elastic_batch(vocab: int, seed: int, step: int) -> dict:
    """The global batch of ``step``: every rank draws all of it and trains
    on its own rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 300 + step)
    rows = ELASTIC_CONFIG["elasticity"]["max_train_batch_size"]
    return {"input_ids": torch.randint(0, vocab, (rows, TRAIN_SHAPE[1]), generator=gen,
                                       device="cuda")}


def _process_start_time(pid="self") -> float:
    """The wall-clock time a process started: its start in clock ticks after
    boot (``/proc/<pid>/stat``) against the boot-time clock now (the whole
    seconds of ``/proc/stat``'s ``btime`` would cost up to a second)."""
    with open(f"/proc/{pid}/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    since = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    return time.time() - since


def _exited(pid: int) -> bool:
    """Whether ``pid`` has exited (gone, or a zombie its parent has not
    reaped yet)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def elastic_child(out: str) -> int:
    """One rank of phase ``elastic``, started by the launcher: the
    elastic-planned engine under ``ElasticAgent.run``, one JSON line a step
    (loss, seconds, K1/K2/K3 launches) into ``out/rank<r>.jsonl``."""
    from torch.profiler import ProfilerActivity, profile

    proc_start = _process_start_time()
    torch.backends.cuda.matmul.allow_tf32 = False   # as the parent's reference
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.elasticity import ElasticAgent
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    with open(os.path.join(out, "spec.json")) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    log = open(os.path.join(out, f"rank{rank}.jsonl"), "a")

    def record(**kw):
        log.write(json.dumps({"pid": os.getpid(), "rank": rank, "t": time.time(), **kw})
                  + "\n")
        log.flush()

    record(event="start", proc_start=proc_start)
    comm.init_distributed(verbose=False)
    model, engine = _elastic_engine(spec["seed"], spec["layers"], spec["zero_stage"])
    torch.cuda.synchronize()
    record(event="engine", world=engine.dp_world, micro=engine.micro_batch_size,
           gas=engine.gas, batch=engine.train_batch_size)
    agent = ElasticAgent(engine, spec["ckpt_dir"])
    vocab = model.config.vocab_size
    reset_counts()

    def step_fn(engine, step):
        before = kernel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(engine.train_batch(batch=_elastic_batch(vocab, spec["seed"], step)))
        torch.cuda.synchronize()
        record(step=step + 1, loss=loss, step_s=time.perf_counter() - t,
               launches=[a - b for a, b in zip(kernel_counts(), before)])

    last = agent.run(step_fn, spec["steps"])
    rc = agent.exit_code(last, spec["steps"])
    checksum = _checksum(engine.full_params(fp32=True)) if rc == 0 else None
    record(event="exit", last=last, rc=rc, checksum=checksum,
           resumed_step=agent.resumed_step, resumed_tag=agent.resumed_tag,
           restore_s=agent.timings.get("restore_s"), save_s=agent.timings.get("save_s"),
           peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
           libraries={b.name: {"path": str(b.library_path()), "loaded": b._lib is not None,
                               "built_here_s": b.build_seconds} for b in fa.builders()})
    log.close()
    comm.destroy_process_group()
    return rc


def _clean_env() -> dict:
    """This process's environment for a launcher: the repo on the path and
    no rank variables of its own."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    return env


def _elastic_run(root: str, num_gpus, restarts: int, sigterm_rank=None) -> dict:
    """``python -m deepspeed_tpu_torch.launcher`` on this script's
    ``--elastic-child``, with ``--num_gpus num_gpus`` (None: none, the
    launcher counts the host's GPUs); with ``sigterm_rank``, that rank's
    first process gets SIGTERM once it logged step ELASTIC_SIGTERM_AFTER.
    The launcher runs in a session of its own, killed whole on the
    deadline."""
    import signal

    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher",
           "-H", os.path.join(root, "no_hostfile"),
           *(["--num_gpus", str(num_gpus)] if num_gpus is not None else []),
           "--master_port", str(_free_port()), "--elastic_restarts", str(restarts),
           "--elastic_ckpt_dir", os.path.join(root, "ckpt"),
           "--elastic_backoff", str(ELASTIC_BACKOFF_S),
           os.path.abspath(__file__), "--elastic-child", root]
    logf = open(os.path.join(root, f"launcher_{time.time_ns()}.log"), "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=_clean_env(), stdout=logf,
                            stderr=subprocess.STDOUT, start_new_session=True)
    deadline = time.monotonic() + ELASTIC_TIMEOUT_S
    victim = sigterm_at = exit_seen_at = cuda_use = None

    def records(rank):
        path = os.path.join(root, f"rank{rank}.jsonl")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(line) for line in f if line.endswith("\n")]

    try:
        while proc.poll() is None:
            if time.monotonic() > deadline:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                raise RuntimeError(f"elastic: the launcher passed its {ELASTIC_TIMEOUT_S} s")
            if sigterm_rank is not None and victim is None:
                recs = records(sigterm_rank)
                if any(r.get("step") == ELASTIC_SIGTERM_AFTER for r in recs):
                    victim = recs[0]["pid"]
                    os.kill(victim, signal.SIGTERM)
                    sigterm_at = time.time()
            if victim is not None and exit_seen_at is None and _exited(victim):
                exit_seen_at = time.time()
            # the launcher's and a training process's use of CUDA, sampled
            # while that process trains (after the relaunch, if any)
            if cuda_use is None and (sigterm_rank is None or exit_seen_at is not None):
                live = [r["pid"] for r in records(0) if "step" in r and r["pid"] != victim]
                use = {"launcher": _cuda_use(proc.pid),
                       "training_process": _cuda_use(live[-1])} if live else {}
                if use and None not in use.values():
                    cuda_use = use
            # poll finely until the signalled process is gone: a 4-card step
            # is a few tens of milliseconds
            time.sleep(0.005 if sigterm_rank is not None and exit_seen_at is None else 0.05)
    finally:
        logf.close()
    with open(logf.name) as f:
        tail = f.read()[-4000:]
    return {"rc": proc.returncode, "sigterm_at": sigterm_at, "victim": victim,
            "exit_seen_at": exit_seen_at, "launcher_log_tail": tail,
            "launcher_pid": proc.pid, "cuda_use": cuda_use,
            "records": {r: records(r) for r in range(num_gpus or torch.cuda.device_count())}}


def _cuda_use(pid: int) -> dict:
    """Whether process ``pid`` has the CUDA driver library mapped
    (``libcuda.so`` in ``/proc/<pid>/maps``) and holds a GPU's device file
    open (``/dev/nvidia*`` among ``/proc/<pid>/fd``); a PID namespace hides
    neither.  ``import torch`` maps the library in any process; the driver
    opens the device files once CUDA is initialized (``cuInit``, as any
    ``torch.cuda`` query does) and keeps them.  None once it has exited."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            driver = any("libcuda.so" in line for line in f)
        names = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return None
    fds = []
    for fd in names:
        try:
            fds.append(os.readlink(f"/proc/{pid}/fd/{fd}"))
        except OSError:
            pass
    return {"libcuda_mapped": driver,
            "nvidia_device_files": sorted({t for t in fds if t.startswith("/dev/nvidia")})}


def _by_process(recs) -> list:
    """A rank's records split by process, in order: each process's start,
    engine, step and exit records."""
    procs = {}
    for r in recs:
        procs.setdefault(r["pid"], {"steps": []})
        p = procs[r["pid"]]
        if "step" in r:
            p["steps"].append(r)
        else:
            p[r["event"]] = r
    return list(procs.values())


def _recovery(run: dict, first: dict, second: dict) -> dict:
    """Time to recover, from SIGTERM to the resumed process's first
    completed step, and its parts (wall clock of one host)."""
    boundary = first["steps"][-1]["t"]
    resumed_start = second["start"]["proc_start"]
    built = second["engine"]["t"]
    first_step = second["steps"][0]
    parts = {"to_step_boundary_s": boundary - run["sigterm_at"],
             "save_s": first["exit"]["save_s"],
             "exit_s": run["exit_seen_at"] - first["exit"]["t"],
             "backoff_s": resumed_start - run["exit_seen_at"],
             "start_to_engine_s": built - resumed_start,
             "load_s": second["exit"]["restore_s"],
             "first_step_s": first_step["step_s"]}
    total = first_step["t"] - run["sigterm_at"]
    parts["other_s"] = total - sum(parts.values())
    return {"time_to_recover_s": total, **parts,
            "process_start_resolution_s": 1.0 / os.sysconf("SC_CLK_TCK")}


def phase_elastic(seed: int) -> tuple:
    """The single-card run: the uninterrupted 8 steps here, then the
    launcher with a SIGTERM after step ELASTIC_SIGTERM_AFTER; losses and
    the final masters' checksum bit-equal, one relaunch, K1-K3 from the
    built libraries in both processes, time to recover with its parts,
    ``ds_report``'s output.  Returns the record and phase ``pod``'s
    reference: the same run's first POD_STEPS losses, its checksum after
    them, and its engine (kept on the card for the replica hooks)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    stage = TRAIN_CONFIG["zero_optimization"]["stage"]
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    model, engine = _elastic_engine(seed, ELASTIC_LAYERS, stage)
    check(engine.gas == 4 and engine.micro_batch_size == 1,
          f"elastic plan at world 1: micro {engine.micro_batch_size} gas {engine.gas}")
    per_step = (2 * ELASTIC_LAYERS * engine.gas, ELASTIC_LAYERS * engine.gas,
                ELASTIC_LAYERS * engine.gas)
    vocab = model.config.vocab_size
    reset_counts()
    want_losses, want_launches, want_step_s = [], [], []
    for step in range(ELASTIC_STEPS):
        before = kernel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        want_losses.append(float(engine.train_batch(batch=_elastic_batch(vocab, seed, step))))
        torch.cuda.synchronize()
        want_step_s.append(time.perf_counter() - t)
        want_launches.append([a - b for a, b in zip(kernel_counts(), before)])
        if step + 1 == POD_STEPS:   # phase pod's uninterrupted run is this one's start
            pod_checksum = _checksum(engine.get_params(fp32=True))
    want_checksum = _checksum(engine.get_params(fp32=True))
    params = model.param_count
    parent_peak = torch.cuda.max_memory_allocated() / 1e9
    reference = {"seed": seed, "losses": want_losses[:POD_STEPS], "checksum": pod_checksum,
                 "launches": want_launches[:POD_STEPS], "engine": engine,
                 "what": "phase elastic's in-process run"}
    # phase pod's replica hooks reuse this engine, so its state stays on the
    # card through the children: recorded beside what the parent holds
    held_engine_gb = engine.replica_nbytes() / 1e9
    del engine, model
    free_memory()
    parent_held = torch.cuda.memory_reserved() / 1e9
    root = tempfile.mkdtemp(prefix="ds_port_elastic_")
    try:
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump({"seed": seed, "layers": ELASTIC_LAYERS, "steps": ELASTIC_STEPS,
                       "zero_stage": stage, "ckpt_dir": os.path.join(root, "ckpt")}, f)
        # one card: no --num_gpus, so the launcher counts the host's GPUs
        run = _elastic_run(root, None if torch.cuda.device_count() == 1 else 1, 2,
                           sigterm_rank=0)
        procs = _by_process(run["records"][0])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    import contextlib
    import io

    from deepspeed_tpu_torch import env_report

    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        report_rc = env_report.main([])
    emit({"phase": "ds_report", "rc": report_rc, "lines": report.getvalue().splitlines()})
    check(report_rc == 0, "ds_report failed")
    check(run["rc"] == 0, f"the launcher exited {run['rc']}:\n{run['launcher_log_tail']}")
    check(len(procs) == 2, f"{len(procs)} training processes, expected 2 (one relaunch)")
    first, second = procs
    got_losses = [s["loss"] for p in procs for s in p["steps"]]
    saved = first["exit"]["last"]
    rec = {"phase": "elastic", "model": TRAIN_MODEL, "layers": ELASTIC_LAYERS,
           "depth_cut": {"num_layers": ELASTIC_LAYERS}, "params": params,
           "S": TRAIN_SHAPE[1], "config": ELASTIC_CONFIG, "steps": ELASTIC_STEPS,
           "plan_world1": {"micro": second["engine"]["micro"], "gas": second["engine"]["gas"]},
           "sigterm_after_step": ELASTIC_SIGTERM_AFTER, "saved_at_step": saved,
           "first_exit_rc": first["exit"]["rc"], "resumed_tag": second["exit"]["resumed_tag"],
           "resumed_step": second["exit"]["resumed_step"], "second_exit_rc": second["exit"]["rc"],
           "processes": len(procs), "launcher_rc": run["rc"],
           "losses": got_losses, "uninterrupted_losses": want_losses,
           "bit_equal_losses": got_losses == want_losses,
           "checksum": second["exit"]["checksum"], "uninterrupted_checksum": want_checksum,
           "launches_per_step": {"uninterrupted": want_launches,
                                 "first_process": [s["launches"] for s in first["steps"]],
                                 "resumed_process": [s["launches"] for s in second["steps"]]},
           "expected_per_step": per_step,
           "libraries": {"first_process": first["exit"]["libraries"],
                         "resumed_process": second["exit"]["libraries"]},
           "step_s": {"uninterrupted": want_step_s,
                      "first_process": [s["step_s"] for s in first["steps"]],
                      "resumed_process": [s["step_s"] for s in second["steps"]]},
           "recovery": _recovery(run, first, second),
           "launcher_num_gpus_flag": torch.cuda.device_count() != 1,
           "cuda_use": run["cuda_use"],
           # the control: a process that only counts GPUs through CUDA
           "cuda_use_counting_through_cuda": json.loads(subprocess.run(
               [sys.executable, "-c", "import json, os, torch; torch.cuda.device_count(); "
                "import chip_smoke; print(json.dumps(chip_smoke._cuda_use(os.getpid())))"],
               cwd=ROOT, capture_output=True, text=True, check=True).stdout.splitlines()[-1]),
           "peak_memory_gb": {"parent_reference": parent_peak,
                              "parent_reserved_during_children": parent_held,
                              "of_which_engine_held_for_pod": held_engine_gb,
                              "first_process": first["exit"]["peak_memory_gb"],
                              "resumed_process": second["exit"]["peak_memory_gb"]},
           "nvidia_smi": nvidia_smi_line(), "seconds": time.perf_counter() - t0}
    emit(rec)
    check(first["exit"]["rc"] == 75 and saved == first["steps"][-1]["step"]
          and saved >= ELASTIC_SIGTERM_AFTER,
          f"the first process did not save at its step boundary and exit 75: {first['exit']}")
    check(rec["resumed_tag"] == f"global_step{saved}" and rec["resumed_step"] == saved,
          f"the relaunched process did not resume from the saved tag: {second['exit']}")
    check(second["exit"]["rc"] == 0 and second["steps"][-1]["step"] == ELASTIC_STEPS,
          "the relaunched process did not finish")
    use = run["cuda_use"] or {}
    check(use.get("training_process", {}).get("nvidia_device_files")
          and rec["cuda_use_counting_through_cuda"]["nvidia_device_files"],
          f"the probe did not see CUDA initialized: {use}, "
          f"{rec['cuda_use_counting_through_cuda']}")
    check(not use["launcher"]["nvidia_device_files"],
          f"the launcher initialized CUDA: {use['launcher']}")
    check(rec["bit_equal_losses"], "the resumed run's losses differ from the uninterrupted "
                                   f"run's: {got_losses} vs {want_losses}")
    check(rec["checksum"] == want_checksum, "the final masters differ from the "
                                             "uninterrupted run's")
    check(all(tuple(x) == per_step for x in want_launches + [
              s["launches"] for s in first["steps"] + second["steps"]]),
          f"K1/K2/K3 a step are not {per_step}: {rec['launches_per_step']}")
    for p in ("first_process", "resumed_process"):
        libs = rec["libraries"][p]
        check(all(libs[n]["loaded"] and libs[n]["built_here_s"] == 0.0 for n in libs),
              f"the {p} did not load the built K1-K3 libraries: {libs}")
    return rec, reference


def phase_elastic4(seed: int) -> None:
    """``elastic4_740m`` (4 cards): ZeRO-2 at the phase's widths over 4
    ranks uninterrupted, then again with SIGTERM to rank ELASTIC4_SIGTERM_RANK
    only (every rank must save the same step and exit 75), relaunched at
    ELASTIC4_RELAUNCH_GPUS cards (the plan's batch of 4 kept: gas 2) to the
    end; losses within TP_DP_LOSS_RTOL of the uninterrupted dp=4 run."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    check(world >= 4, f"elastic4_740m needs 4 cards, found {world}")
    runs = {}
    for label in ("uninterrupted", "preempted"):
        root = tempfile.mkdtemp(prefix=f"ds_port_elastic4_{label}_")
        try:
            with open(os.path.join(root, "spec.json"), "w") as f:
                json.dump({"seed": seed, "layers": ELASTIC_LAYERS, "steps": ELASTIC_STEPS,
                           "zero_stage": 2, "ckpt_dir": os.path.join(root, "ckpt")}, f)
            if label == "uninterrupted":
                runs[label] = [_elastic_run(root, 4, 0)]
            else:
                runs[label] = [_elastic_run(root, 4, 0, sigterm_rank=ELASTIC4_SIGTERM_RANK),
                               _elastic_run(root, ELASTIC4_RELAUNCH_GPUS, 1)]
        finally:
            shutil.rmtree(root, ignore_errors=True)
    ref = runs["uninterrupted"][0]
    check(ref["rc"] == 0, f"the uninterrupted dp=4 run exited {ref['rc']}")
    want = [s["loss"] for s in _by_process(ref["records"][0])[0]["steps"]]
    stopped, resumed = runs["preempted"]
    exits = [_by_process(stopped["records"][r])[0]["exit"] for r in range(4)]
    # rank 0's file holds both runs: the 4-card process, then the 2-card one
    first, later = _by_process(resumed["records"][0])[:2]
    got = [s["loss"] for p in (first, later) for s in p["steps"]]
    rec = {"phase": "tp_cards_elastic4_740m", "world_size": 4,
           "relaunch_gpus": ELASTIC4_RELAUNCH_GPUS, "sigterm_rank": ELASTIC4_SIGTERM_RANK,
           "saved_steps": [e["last"] for e in exits], "exit_rcs": [e["rc"] for e in exits],
           "stopped_rc": stopped["rc"], "resumed_rc": resumed["rc"],
           "resumed_plan": {k: later["engine"][k] for k in ("world", "micro", "gas", "batch")},
           "resumed_tag": later["exit"]["resumed_tag"], "losses": got,
           "uninterrupted_losses": want,
           "loss_max_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(got, want)),
           "nvidia_smi": nvidia_smi_line(), "seconds": time.perf_counter() - t0}
    emit(rec)
    check(len(set(rec["saved_steps"])) == 1 and set(rec["exit_rcs"]) == {75},
          f"the ranks did not all save the same step and exit 75: {rec['saved_steps']}")
    check(rec["resumed_plan"]["gas"] == 2 and rec["resumed_plan"]["batch"] == 4
          and resumed["rc"] == 0 and len(got) == ELASTIC_STEPS,
          f"the relaunch at 2 cards did not keep the batch or finish: {rec}")
    check(rec["loss_max_rel_diff"] <= TP_DP_LOSS_RTOL,
          f"elastic4_740m: losses differ from dp=4's beyond {TP_DP_LOSS_RTOL}")


# ---------------------------------------------------------------------------
# Phase pod (ROADMAP queue 1, item 13's pod half): the launcher in pod mode
# starting llama-740m training as host h0 of a two-host pod whose h1 is a
# simulated host holding no card; h1 dies in the middle of a pod-scope
# checkpoint, h0's heartbeat watchdog declares it dead and exits 87, the
# supervisor bumps the pod generation and relaunches, and the new process
# quarantines the torn tag and resumes from the tag both hosts attested
# ---------------------------------------------------------------------------

POD_STEPS = 6
POD_CKPT_EVERY = 2
POD_HOSTS = ("h0", "h1")
POD_LEASE_S = 1.0
POD_MISS_LIMIT = 3
POD_HOLD_TAG = "global_step4"   # h1 dies once this commit is announced
POD_COMMIT_TIMEOUT_S = 120.0
POD_TIMEOUT_S = 600
POD_CARD_CONFIGS = ("pod4_740m",)
POD4_GPUS = {"h0": "0,1", "h1": "2,3"}
POD4_KILL_AFTER = 3             # SIGKILL h1's spawner once rank 0 logged this step
POD_REPLICA_MAX_S = 1.0         # the over-cap refusal must not touch the slab


def pod_child(out: str) -> int:
    """One rank of phase ``pod`` (and ``pod4_740m``), started by the launcher
    in pod mode: ``PodContext.from_env`` over the spec's hosts, a started
    ``HeartbeatWatchdog``, the elastic-planned engine under
    ``PodElasticAgent.run``; one JSON line a step (loss, seconds, K1/K2/K3
    launches) and a line a save (its parts) into ``out/pod_rank<r>.jsonl``.
    When the watchdog declares a peer dead the rank records it and exits 87
    (``os._exit``, from the watchdog's thread)."""
    from torch.profiler import ProfilerActivity, profile

    proc_start = _process_start_time()
    torch.backends.cuda.matmul.allow_tf32 = False   # as the parent's reference
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.elasticity import (RC_POD_PEER_LOST, PodContext,
                                                PodElasticAgent, PodPeerLost,
                                                shrink_to_healthy)
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.runtime.config import ElasticityConfig

    with open(os.path.join(out, "pod_spec.json")) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    log = open(os.path.join(out, f"pod_rank{rank}.jsonl"), "a")
    ctx = PodContext.from_env(hosts=spec["pod_hosts"],
                              commit_timeout_s=spec["commit_timeout_s"])

    def record(**kw):
        log.write(json.dumps({"pid": os.getpid(), "rank": rank, "host": ctx.host_id,
                              "generation": ctx.generation, "t": time.time(), **kw}) + "\n")
        log.flush()

    def peer_dead(host):
        record(event="peer_dead", dead=host)
        os._exit(RC_POD_PEER_LOST)

    record(event="start", proc_start=proc_start, hosts=ctx.hosts,
           env={k: os.environ.get(k) for k in ("DS_TPU_POD_COORD_DIR", "DS_TPU_POD_GENERATION",
                                               "DS_TPU_POD_LEASE", "DS_TPU_POD_MISS_LIMIT",
                                               "DS_TPU_POD_HOST")})
    watchdog = ctx.watchdog(on_peer_dead=peer_dead).start()
    comm.init_distributed(verbose=False)
    # the round's plan over the pod's hosts (one card each as far as the
    # plan knows): printed, not applied, as h1 holds no card
    members, plan = shrink_to_healthy(ElasticityConfig(**ELASTIC_CONFIG["elasticity"]),
                                      ctx.hosts, chips_per_host=1)
    model, engine = _elastic_engine(spec["seed"], spec["layers"], spec["zero_stage"])
    torch.cuda.synchronize()
    record(event="engine", world=engine.dp_world, micro=engine.micro_batch_size,
           gas=engine.gas, batch=engine.train_batch_size,
           host_plan={"members": members, "triad": list(plan.as_triad())})
    agent = PodElasticAgent(engine, spec["ckpt_dir"], ctx, watchdog=watchdog,
                            ckpt_every=spec["ckpt_every"])
    vocab = model.config.vocab_size
    save = agent._save

    def recorded_save():
        t = time.perf_counter()
        tag = f"global_step{engine.global_steps}"
        save()
        record(event="save", tag=tag, s=time.perf_counter() - t, **ctx.timings)
    agent._save = recorded_save
    reset_counts()

    def step_fn(engine, step):
        before = kernel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(engine.train_batch(batch=_elastic_batch(vocab, spec["seed"], step)))
        torch.cuda.synchronize()
        record(step=step + 1, loss=loss, step_s=time.perf_counter() - t,
               launches=[a - b for a, b in zip(kernel_counts(), before)])

    try:
        last = agent.run(step_fn, spec["steps"])
    except PodPeerLost as e:
        record(event="peer_lost", dead=e.host)
        log.close()
        os._exit(e.rc)
    rc = agent.exit_code(last, spec["steps"])
    checksum = _checksum(engine.full_params(fp32=True)) if rc == 0 else None
    record(event="exit", last=last, rc=rc, checksum=checksum,
           resumed_step=agent.resumed_step, resumed_tag=agent.resumed_tag,
           restore_s=agent.timings.get("restore_s"), sweep_s=agent.timings.get("sweep_s"),
           peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
           libraries={b.name: {"path": str(b.library_path()), "loaded": b._lib is not None,
                               "built_here_s": b.build_seconds} for b in fa.builders()})
    log.close()
    watchdog.stop()
    comm.destroy_process_group()
    return rc


def _pod_records(root: str, rank: int) -> list:
    path = os.path.join(root, f"pod_rank{rank}.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.endswith("\n")]


def _pod_launcher(root: str, hostfile: str, restarts: int, extra=()) -> list:
    return [sys.executable, "-m", "deepspeed_tpu_torch.launcher", "-H", hostfile,
            "--launcher", "local", "--master_port", str(_free_port()), *extra,
            "--pod_coord_dir", os.path.join(root, "store"),
            "--pod_lease", str(POD_LEASE_S), "--pod_miss_limit", str(POD_MISS_LIMIT),
            "--elastic_restarts", str(restarts), "--elastic_ckpt_dir",
            os.path.join(root, "ckpt"), "--elastic_backoff", str(ELASTIC_BACKOFF_S),
            os.path.abspath(__file__), "--pod-child", root]


def _pod_run(root: str) -> dict:
    """The simulated peer h1 (``tests/_torch_pod_peer.py``, a plain
    process), then the launcher in pod mode on this script's
    ``--pod-child`` as host h0; SIGKILL to h1 once it holds at
    POD_HOLD_TAG.  Both run in sessions of their own, killed whole on the
    deadline."""
    import signal

    env = _clean_env()
    peer_spec = os.path.join(root, "peer_spec.json")
    with open(peer_spec, "w") as f:
        json.dump({"store": os.path.join(root, "store"), "host": POD_HOSTS[1],
                   "lease_s": POD_LEASE_S, "ckpt_dir": os.path.join(root, "ckpt"),
                   "out": os.path.join(root, "peer.jsonl"), "hold_tag": POD_HOLD_TAG}, f)
    peer = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "_torch_pod_peer.py"),
                             peer_spec], cwd=ROOT, env=env, start_new_session=True,
                            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    hostfile = os.path.join(root, "hostfile")
    with open(hostfile, "w") as f:
        f.write(f"{POD_HOSTS[0]} slots=1\n")
    logf = open(os.path.join(root, f"pod_launcher_{time.time_ns()}.log"), "w")
    proc = subprocess.Popen(_pod_launcher(root, hostfile, 2), cwd=ROOT, env=env, stdout=logf,
                            stderr=subprocess.STDOUT, start_new_session=True)
    deadline = time.monotonic() + POD_TIMEOUT_S
    kill_at = exit_seen_at = victim = None
    cuda_use = {}

    def peer_records():
        path = os.path.join(root, "peer.jsonl")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(line) for line in f if line.endswith("\n")]

    try:
        while proc.poll() is None:
            if time.monotonic() > deadline:
                raise RuntimeError(f"pod: the launcher passed its {POD_TIMEOUT_S} s")
            recs = _pod_records(root, 0)
            if kill_at is None and any(r.get("event") == "hold" for r in peer_records()):
                cuda_use["peer"] = _cuda_use(peer.pid)
                os.killpg(peer.pid, signal.SIGKILL)
                kill_at = time.time()
                peer.wait()
                victim = recs[0]["pid"] if recs else None
            if victim is not None and exit_seen_at is None and _exited(victim):
                exit_seen_at = time.time()
            live = [r["pid"] for r in recs if "step" in r]
            if "training_process" not in cuda_use and live and kill_at is None:
                use = {"launcher": _cuda_use(proc.pid), "training_process": _cuda_use(live[-1])}
                if None not in use.values():
                    cuda_use.update(use)
            time.sleep(0.005 if kill_at is not None and exit_seen_at is None else 0.05)
    finally:
        for p in (proc, peer):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        logf.close()
    with open(logf.name) as f:
        tail = f.read()[-6000:]
    return {"rc": proc.returncode, "kill_at": kill_at, "exit_seen_at": exit_seen_at,
            "victim": victim, "launcher_log_tail": tail, "cuda_use": cuda_use,
            "records": _pod_records(root, 0), "peer": peer_records()}


def _pod_recovery(run: dict, first: dict, second: dict) -> dict:
    """Time to detect (SIGKILL of h1 to h0's exit 87) and time to recover
    (SIGKILL to the resumed process's first completed step), with their
    parts (wall clock of one host)."""
    declared = first["peer_dead"]["t"]
    resumed_start = second["start"]["proc_start"]
    first_step = second["steps"][0]
    # the supervisor's jittered backoff, as it logged it; the rest of the
    # gap to the new process is the reap and the per-node spawner's start
    backoff = re.findall(r"relaunching \(restart \d+/\d+\) after ([0-9.]+)s",
                         run["launcher_log_tail"])
    detect = {"declared_s": declared - run["kill_at"],
              "exit_s": run["exit_seen_at"] - declared}
    parts = {**detect,
             "backoff_s": float(backoff[0]) if backoff else 0.0,
             "reap_and_spawn_s": resumed_start - run["exit_seen_at"]
             - (float(backoff[0]) if backoff else 0.0),
             "start_to_engine_s": second["engine"]["t"] - resumed_start,
             "sweep_s": second["exit"]["sweep_s"],
             "load_s": second["exit"]["restore_s"],
             "first_step_s": first_step["step_s"]}
    total = first_step["t"] - run["kill_at"]
    parts["other_s"] = total - sum(parts.values())
    return {"time_to_detect_s": run["exit_seen_at"] - run["kill_at"],
            "time_to_recover_s": total, **parts,
            "process_start_resolution_s": 1.0 / os.sysconf("SC_CLK_TCK")}


def _pod_by_process(recs) -> list:
    procs = {}
    for r in recs:
        p = procs.setdefault(r["pid"], {"steps": [], "saves": []})
        if "step" in r:
            p["steps"].append(r)
        elif r["event"] == "save":
            p["saves"].append(r)
        else:
            p[r["event"]] = r
    return list(procs.values())


def _pod_replica_hooks(reference: dict, seed: int) -> dict:
    """The replica hooks at full width, here: ``replica_snapshot`` of the
    reference engine, ``replica_ingest`` into a second engine built the same
    way (parameters, masters and moments bit-equal after it), then a
    ``HostReplicator`` sealing every step refuses the slab at the store's
    cap before building, checksumming or encoding it, within
    POD_REPLICA_MAX_S, and counts the refusal."""
    import tempfile

    from deepspeed_tpu_torch.elasticity import (REPLICA_MAX_BYTES, FileCoordinationStore,
                                                HostReplicator, read_replica)
    from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

    src = reference["engine"]
    _, dst = _elastic_engine(seed + 1, ELASTIC_LAYERS, TRAIN_CONFIG["zero_optimization"]["stage"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    slab = src.replica_snapshot()
    snap_s = time.perf_counter() - t
    t = time.perf_counter()
    step = dst.replica_ingest(slab)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t
    gb = len(slab) / 1e9

    def leaves(e):
        state = dataclasses.asdict(e.state)
        return tree_flatten_with_path({k: state[k] for k in ("params", "master_params",
                                                              "opt_state")})
    pairs = list(zip(leaves(src), leaves(dst)))
    equal = all(pa == pb and (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
                for (pa, a), (pb, b) in pairs)
    del slab
    store_dir = tempfile.mkdtemp(prefix="ds_port_pod_store_")
    try:
        store = FileCoordinationStore(store_dir)
        rep = HostReplicator(store, POD_HOSTS[0], 1, list(POD_HOSTS), src.replica_snapshot,
                             replica_every_k=1)
        t = time.perf_counter()
        sealed = rep.maybe_replicate(src.global_steps)
        refuse_s = time.perf_counter() - t
        rep.stop()
        published = read_replica(store, POD_HOSTS[0]) is not None
    finally:
        import shutil

        shutil.rmtree(store_dir, ignore_errors=True)
    out = {"slab_gb": gb, "step": step, "source_step": src.global_steps,
           "leaves": len(pairs), "bit_equal": equal,
           "snapshot_s": snap_s, "snapshot_gb_per_s": gb / snap_s,
           "ingest_s": ingest_s, "ingest_gb_per_s": gb / ingest_s,
           "cap_bytes": REPLICA_MAX_BYTES, "refused": not sealed and not published,
           "publish_failures": rep.publish_failures, "refuse_s": refuse_s}
    del dst
    return out


def phase_pod(seed: int, reference=None) -> dict:
    """The lost-host recovery on one card (see the module docstring's phase
    ``pod``), held bit-equal to phase ``elastic``'s uninterrupted run (or
    this phase's own when it runs alone), then the replica hooks."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    stage = TRAIN_CONFIG["zero_optimization"]["stage"]
    free_memory()
    if reference is None or reference["seed"] != seed:
        model, engine = _elastic_engine(seed, ELASTIC_LAYERS, stage)
        vocab, losses, launches = model.config.vocab_size, [], []
        reset_counts()
        for step in range(POD_STEPS):
            before = kernel_counts()
            losses.append(float(engine.train_batch(batch=_elastic_batch(vocab, seed, step))))
            launches.append([a - b for a, b in zip(kernel_counts(), before)])
        reference = {"seed": seed, "losses": losses, "launches": launches, "engine": engine,
                     "checksum": _checksum(engine.get_params(fp32=True)),
                     "what": "this phase's own in-process run"}
        del model, engine
    free_memory()
    per_step = (2 * ELASTIC_LAYERS * 4, ELASTIC_LAYERS * 4, ELASTIC_LAYERS * 4)
    root = tempfile.mkdtemp(prefix="ds_port_pod_")
    try:
        with open(os.path.join(root, "pod_spec.json"), "w") as f:
            json.dump({"seed": seed, "layers": ELASTIC_LAYERS, "steps": POD_STEPS,
                       "zero_stage": stage, "ckpt_dir": os.path.join(root, "ckpt"),
                       "ckpt_every": POD_CKPT_EVERY, "pod_hosts": list(POD_HOSTS),
                       "commit_timeout_s": POD_COMMIT_TIMEOUT_S}, f)
        run = _pod_run(root)
        from deepspeed_tpu_torch.elasticity import (FileCoordinationStore, dead_set,
                                                    read_generation)
        from deepspeed_tpu_torch.resilience import read_pod_manifest

        store = FileCoordinationStore(os.path.join(root, "store"))
        ckpt = os.path.join(root, "ckpt")
        tags = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
        pod_manifests = {t: read_pod_manifest(os.path.join(ckpt, t)) for t in tags
                         if os.path.isdir(os.path.join(ckpt, t))}
        store_state = {"generation": read_generation(store), "dead": dead_set(store),
                       "commits": {g: store.get(f"commit/{g}") for g in store.list("commit")}}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    procs = _pod_by_process(run["records"])
    check(run["rc"] == 0, f"the pod launcher exited {run['rc']}:\n{run['launcher_log_tail']}")
    check(len(procs) == 2, f"{len(procs)} training processes, expected 2 (one relaunch)")
    first, second = procs
    got = [s["loss"] for s in first["steps"] if s["step"] <= second["exit"]["resumed_step"]] \
        + [s["loss"] for s in second["steps"]]
    want = reference["losses"]
    saves = [{k: s.get(k) for k in ("generation", "tag", "s", "engine_save_s",
                                    "host_manifest_s", "pod_commit_wait_s")}
             for p in procs for s in p["saves"]]
    launcher_log = run["launcher_log_tail"]
    rec = {"phase": "pod", "model": TRAIN_MODEL, "layers": ELASTIC_LAYERS,
           "depth_cut": {"num_layers": ELASTIC_LAYERS}, "S": TRAIN_SHAPE[1],
           "steps": POD_STEPS, "ckpt_every": POD_CKPT_EVERY, "hosts": list(POD_HOSTS),
           "lease_s": POD_LEASE_S, "miss_limit": POD_MISS_LIMIT, "hold_tag": POD_HOLD_TAG,
           "reference": reference["what"],
           "first": {"generation": first["start"]["generation"],
                     "hosts": first["start"]["hosts"], "env": first["start"]["env"],
                     "host_plan": first["engine"]["host_plan"],
                     "steps": [s["step"] for s in first["steps"]],
                     "peer_dead": first.get("peer_dead", {}).get("dead")},
           "second": {"generation": second["start"]["generation"],
                      "hosts": second["start"]["hosts"],
                      "host_plan": second["engine"]["host_plan"],
                      "resumed_tag": second["exit"]["resumed_tag"],
                      "resumed_step": second["exit"]["resumed_step"],
                      "steps": [s["step"] for s in second["steps"]], "rc": second["exit"]["rc"],
                      "plan": {k: second["engine"][k] for k in ("world", "micro", "gas",
                                                                 "batch")}},
           "launcher_rc": run["rc"], "launcher_saw_87": "rc=87" in launcher_log,
           "tags": tags, "pod_manifests": pod_manifests, "store": store_state,
           "losses": got, "uninterrupted_losses": want, "bit_equal_losses": got == want,
           "checksum": second["exit"]["checksum"], "uninterrupted_checksum": reference["checksum"],
           "launches_per_step": {"first_process": [s["launches"] for s in first["steps"]],
                                 "resumed_process": [s["launches"] for s in second["steps"]]},
           "expected_per_step": per_step,
           "libraries": {"first_process": first["exit"]["libraries"]
                         if "exit" in first else None,
                         "resumed_process": second["exit"]["libraries"]},
           "saves": saves, "recovery": _pod_recovery(run, first, second),
           "step_s": [s["step_s"] for p in procs for s in p["steps"]],
           "peer": [r.get("event") + ":" + str(r.get("tag", "")) for r in run["peer"]],
           "cuda_use": run["cuda_use"],
           "peak_memory_gb": second["exit"]["peak_memory_gb"],
           "nvidia_smi": nvidia_smi_line()}
    replica = _pod_replica_hooks(reference, seed)
    reference.pop("engine", None)
    free_memory()
    rec["replica"] = replica
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    check(first["start"]["generation"] == 1 and first["start"]["hosts"] == list(POD_HOSTS),
          f"the first round was not generation 1 of both hosts: {first['start']}")
    step2 = pod_manifests.get("global_step2") or {}
    check(step2.get("generation") == 1 and step2.get("hosts") == list(POD_HOSTS),
          f"global_step2 is not pod-committed by both hosts in generation 1: {pod_manifests}")
    check(first.get("peer_dead", {}).get("dead") == POD_HOSTS[1] and "exit" not in first
          and rec["launcher_saw_87"],
          f"h0 did not declare h1 dead and exit 87: {first.get('peer_dead')}\n{launcher_log}")
    check(store_state["dead"] == [POD_HOSTS[1]] and store_state["generation"] == 2,
          f"not exactly one more round at generation 2 with dead/h1: {store_state}")
    check(f"{POD_HOLD_TAG}.corrupt" in tags and second["exit"]["resumed_tag"] == "global_step2",
          f"the torn {POD_HOLD_TAG} was not quarantined, or the resume was not from "
          f"global_step2: {tags}, {second['exit']}")
    check(second["start"]["hosts"] == [POD_HOSTS[0]] and second["exit"]["rc"] == 0
          and [s["step"] for s in second["steps"]] == list(range(3, POD_STEPS + 1)),
          f"the second round did not train steps 3-{POD_STEPS} at [h0]: {rec['second']}")
    for tag in (POD_HOLD_TAG, f"global_step{POD_STEPS}"):
        check((pod_manifests.get(tag) or {}).get("generation") == 2
              and pod_manifests[tag]["hosts"] == [POD_HOSTS[0]],
              f"{tag} is not pod-committed by [h0] in generation 2: {pod_manifests.get(tag)}")
    check(rec["bit_equal_losses"], f"the resumed run's losses differ from the uninterrupted "
                                   f"run's: {got} vs {want}")
    check(rec["checksum"] == reference["checksum"],
          "the final masters differ from the uninterrupted run's")
    check(all(tuple(x) == per_step for x in rec["launches_per_step"]["first_process"]
              + rec["launches_per_step"]["resumed_process"]),
          f"K1/K2/K3 a step are not {per_step}: {rec['launches_per_step']}")
    libs = rec["libraries"]["resumed_process"]
    check(all(libs[n]["loaded"] and libs[n]["built_here_s"] == 0.0 for n in libs),
          f"the resumed process did not load the built K1-K3 libraries: {libs}")
    use = run["cuda_use"]
    check(use.get("training_process", {}).get("nvidia_device_files"),
          f"the probe did not see the training process hold the card: {use}")
    check(not use["launcher"]["nvidia_device_files"] and not use["peer"]["nvidia_device_files"],
          f"the launcher or the simulated peer opened the card: {use}")
    check(replica["bit_equal"] and replica["step"] == replica["source_step"],
          f"the replica round trip is not bit-equal: {replica}")
    check(replica["refused"] and replica["publish_failures"] == 1
          and replica["refuse_s"] < POD_REPLICA_MAX_S,
          f"the over-cap slab was not refused within {POD_REPLICA_MAX_S} s: {replica}")
    return rec


def phase_pod4(seed: int) -> None:
    """``pod4_740m`` (4 cards): two host aliases of 2 cards each on this
    machine (``--launcher local``, slots narrowed to 0,1 and 2,3), ZeRO-2 at
    phase ``pod``'s widths.  h1's spawner is SIGKILLed after step
    POD4_KILL_AFTER: both ranks of h0 exit 87 out of the wedged NCCL step;
    the next round runs h0's 2 cards (the plan's batch of 4: gas 2) from
    the last pod-committed tag.  Losses within TP_DP_LOSS_RTOL of an
    uninterrupted dp=4 run."""
    import shutil
    import signal
    import tempfile

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    check(world >= 4, f"pod4_740m needs 4 cards, found {world}")
    root = tempfile.mkdtemp(prefix="ds_port_pod4_ref_")
    try:
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump({"seed": seed, "layers": ELASTIC_LAYERS, "steps": POD_STEPS,
                       "zero_stage": 2, "ckpt_dir": os.path.join(root, "ckpt")}, f)
        ref = _elastic_run(root, 4, 0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(ref["rc"] == 0, f"the uninterrupted dp=4 run exited {ref['rc']}")
    want = [s["loss"] for s in _by_process(ref["records"][0])[0]["steps"]]
    root = tempfile.mkdtemp(prefix="ds_port_pod4_")
    try:
        with open(os.path.join(root, "pod_spec.json"), "w") as f:
            json.dump({"seed": seed, "layers": ELASTIC_LAYERS, "steps": POD_STEPS,
                       "zero_stage": 2, "ckpt_dir": os.path.join(root, "ckpt"),
                       "ckpt_every": POD_CKPT_EVERY, "pod_hosts": list(POD_HOSTS),
                       "commit_timeout_s": POD_COMMIT_TIMEOUT_S}, f)
        hostfile = os.path.join(root, "hostfile")
        with open(hostfile, "w") as f:
            f.write("".join(f"{h} slots={world}\n" for h in POD_HOSTS))
        include = "@".join(f"{h}:{POD4_GPUS[h]}" for h in POD_HOSTS)
        logf = open(os.path.join(root, "launcher.log"), "w")
        proc = subprocess.Popen(_pod_launcher(root, hostfile, 1, ("-i", include)), cwd=ROOT,
                                env=_clean_env(), stdout=logf, stderr=subprocess.STDOUT,
                                start_new_session=True)
        deadline, killed = time.monotonic() + POD_TIMEOUT_S, None
        try:
            while proc.poll() is None:
                check(time.monotonic() < deadline, f"pod4: past {POD_TIMEOUT_S} s")
                if killed is None and any(r.get("step") == POD4_KILL_AFTER
                                          for r in _pod_records(root, 0)):
                    spawner = subprocess.run(["pgrep", "-P", str(proc.pid), "-f",
                                              "node_rank=1"], capture_output=True,
                                             text=True).stdout.split()
                    check(len(spawner) == 1, f"pod4: h1's spawner not found: {spawner}")
                    os.kill(int(spawner[0]), signal.SIGKILL)
                    killed = time.time()
                time.sleep(0.02)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            logf.close()
        with open(logf.name) as f:
            log = f.read()
        recs = {r: _pod_by_process(_pod_records(root, r)) for r in range(4)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    first, later = recs[0][:2] if len(recs[0]) >= 2 else (recs[0] + [{}, {}])[:2]
    got = [s["loss"] for s in first.get("steps", [])
           if s["step"] <= later.get("exit", {}).get("resumed_step", 0)] \
        + [s["loss"] for s in later.get("steps", [])]
    rec = {"phase": "tp_cards_pod4_740m", "world_size": 4, "hosts": POD4_GPUS,
           "kill_after_step": POD4_KILL_AFTER, "launcher_rc": proc.returncode,
           "h0_peer_dead": [p[0].get("peer_dead", {}).get("dead") for r, p in recs.items()
                            if r < 2 and p],
           "exits_87_logged": log.count("rc=87"),
           "resumed_plan": {k: later.get("engine", {}).get(k)
                            for k in ("world", "micro", "gas", "batch")},
           "resumed_tag": later.get("exit", {}).get("resumed_tag"), "losses": got,
           "uninterrupted_losses": want,
           "loss_max_rel_diff": (max(abs(a - b) / abs(b) for a, b in zip(got, want))
                                 if len(got) == len(want) else None),
           "nvidia_smi": nvidia_smi_line(), "seconds": time.perf_counter() - t0}
    emit(rec)
    check(proc.returncode == 0, f"pod4: the launcher exited {proc.returncode}:\n{log[-4000:]}")
    check(rec["h0_peer_dead"] == [POD_HOSTS[1]] * 2,
          f"pod4: both ranks of h0 did not declare h1 dead: {rec['h0_peer_dead']}")
    check(rec["resumed_plan"]["gas"] == 2 and rec["resumed_plan"]["batch"] == 4
          and len(got) == POD_STEPS, f"pod4: the 2-card round did not keep the batch: {rec}")
    check(rec["loss_max_rel_diff"] <= TP_DP_LOSS_RTOL,
          f"pod4_740m: losses differ from dp=4's beyond {TP_DP_LOSS_RTOL}")


# ---------------------------------------------------------------------------
# ROADMAP item 14's fleet half (phase ``fleet``): ``fleet_7b4``, llama2-7b's
# widths at FLEET_LAYERS of its 32 layers in fp32; FLEET_MEMBERS member
# daemons (this script's ``--fleet-member``) on the one card, routed by a
# coordinator FleetRouter and a standby in this process over
# StoreMemberProxy handles; the member with the most streams is SIGKILLed
# mid-stream, then the coordinator router is killed
# ---------------------------------------------------------------------------

FLEET_CONFIG = "fleet_7b4"
FLEET_MODEL = "llama2-7b"
FLEET_LAYERS = 4               # of 32: three members and a reference on one card
FLEET_SEED_OFFSET = 900        # the weights' seed: seed + this, in every process
FLEET_MEMBERS = 3
FLEET_LEASE_S = 1.0            # member lease; dead after FLEET_MISS_LIMIT missed
FLEET_MISS_LIMIT = 3
FLEET_ROUTER_LEASE_S = 2.0     # the coordinator election's lease
FLEET_JOURNAL_FLUSH_MS = 50.0  # token-journal appends on the store clock
FLEET_KILL_JOURNALED = 8       # SIGKILL once one of the victim's streams has this many journaled
FLEET_COORD_KILL_ROUNDS = 5    # router rounds after the first resumed token
FLEET_READY_TIMEOUT_S = 300
FLEET_TIMEOUT_S = 300
FLEET_SERVE = {"b_slots": SERVE_SLOTS, "page_size": SERVE_PAGE, "max_model_len": SERVE_MAX_LEN}


def _fleet_engine(seed: int):
    """``fleet_7b4``: the same seeded fp32 weights in every process."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    model = CausalLM(FLEET_MODEL, num_layers=FLEET_LAYERS, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed + FLEET_SEED_OFFSET)
    params = model.init_fn(gen, device="cuda", dtype=torch.float32)
    engine = deepspeed_tpu_torch.init_inference(model, config={"dtype": "fp32"},
                                                params=params)
    return model, params, engine


def _fleet_copies(stream):
    return [dataclasses.replace(r) for r in stream]


def _serve_counts(sup, base=None) -> dict:
    """A supervised engine's kernel counters and the work that implies
    them: prefills, decode ticks (graph replays), K4 launches a replay."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels.decode_attention import decode_attention

    ex = sup.engine._exec
    out = {"k1": fa.flash_attention.launches, "k4_counter": decode_attention.launches,
           "prefills": sum(ex._prefill_buckets.values()), "ticks": ex.replays,
           "graph_k4": ex.graph_k4_launches, "captures": ex.captures,
           "restarts": sup.restarts}
    if base is not None:
        for key in ("prefills", "ticks"):
            out[key] -= base[key]
    out["k4_replayed"] = out["graph_k4"] * out["ticks"]
    return out


def fleet_member_child(spec_path: str) -> int:
    """One member of phase ``fleet``: ``fleet_7b4`` under
    ``supervised_serving``, warmed, then the port's ``FleetMemberDaemon``
    (``inference/fleet_member.serve_member``) until the router's
    ``shutdown`` verb; JSON records (start, ready with the weights'
    checksum, counts after each working round, exit) into the spec's
    ``out``."""
    from torch.profiler import ProfilerActivity, profile

    proc_start = _process_start_time()
    torch.backends.cuda.matmul.allow_tf32 = False   # as the parent's reference
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch.inference.fleet_member import serve_member, warm_up
    from deepspeed_tpu_torch.ops.kernels import decode_attention as da
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    with open(spec_path) as f:
        spec = json.load(f)
    eid = spec["engine_id"]
    log = open(spec["out"], "a")

    def record(**kw):
        log.write(json.dumps({"pid": os.getpid(), "engine": eid, "t": time.time(), **kw}) + "\n")
        log.flush()

    record(event="start", proc_start=proc_start)
    _, params, engine = _fleet_engine(spec["seed"])
    checksum = _checksum(params)
    del params
    sup = engine.supervised_serving(max_restarts=spec["max_restarts"], **FLEET_SERVE)
    built = time.time()
    warm_up(sup.engine)
    torch.cuda.synchronize()
    warmed = time.time()
    # the member's whole serving life under torch.profiler: its K1 and K4
    # kernel events, the replayed ones included, are counted at exit
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    profiler_start_s = time.time() - warmed
    reset_counts()
    base = _serve_counts(sup)
    last = [None]

    def on_round(rounds: int) -> None:
        if rounds == 1:
            record(event="ready", proc_start=proc_start, built=built, warmed=warmed,
                   start_to_ready_s=time.time() - proc_start, checksum=checksum,
                   profiler_start_s=profiler_start_s,
                   libraries={b.name: {"loaded": b._lib is not None,
                                       "built_here_s": b.build_seconds}
                              for b in fa.builders() + da.builders()})
        # after every round that prefilled or replayed: a SIGKILLed member's
        # last record is at most one round old
        counts = _serve_counts(sup, base)
        if counts != last[0]:
            last[0] = counts
            record(event="counts", rounds=rounds, **counts)

    member, daemon, rounds = serve_member(
        eid, sup, spec["coord_dir"], lease_s=spec["lease_s"], idle_sleep_s=0.0005,
        ready_file=spec["ready_file"], on_round=on_round)
    torch.cuda.synchronize()
    counts = _serve_counts(sup, base)
    prof.stop()
    trace = os.path.join(os.path.dirname(spec["out"]), f"trace_{eid}.json")
    prof.export_chrome_trace(trace)
    profiled = _trace_kernel_events(trace, ("K1", "K4"))
    os.remove(trace)
    sv = sup.engine
    record(event="exit", rounds=rounds, alive=member.alive, shutdown=daemon.shutdown,
           page_accounting=sv.page_accounting(), inventory=sv.program_inventory(),
           peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
           k1_profiled=profiled["K1"], k4_profiled=profiled["K4"], **counts)
    log.close()
    sv.close()
    return 0 if member.alive and daemon.shutdown else 1


def _fleet_records(path: str) -> dict:
    """A member's records by event (the last of each)."""
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                if line.endswith("\n"):
                    rec = json.loads(line)
                    out[rec["event"]] = rec
    return out


def _fleet_members(root: str, seed: int) -> tuple:
    """Start FLEET_MEMBERS ``--fleet-member`` children at once, each in a
    session of its own; wait for every ``ready_file``."""
    procs, logs, specs = {}, {}, {}
    env = _clean_env()
    for i in range(FLEET_MEMBERS):
        eid = f"engine{i}"
        spec = {"engine_id": eid, "seed": seed, "coord_dir": os.path.join(root, "store"),
                "lease_s": FLEET_LEASE_S, "max_restarts": 5,
                "ready_file": os.path.join(root, f"ready_{eid}"),
                "out": os.path.join(root, f"member_{eid}.jsonl")}
        specs[eid] = spec
        path = os.path.join(root, f"spec_{eid}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        logs[eid] = open(os.path.join(root, f"{eid}.log"), "w")
        procs[eid] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--fleet-member", path], cwd=ROOT,
            env=env, stdout=logs[eid], stderr=subprocess.STDOUT, start_new_session=True)
    deadline = time.monotonic() + FLEET_READY_TIMEOUT_S
    for eid, spec in specs.items():
        while not os.path.exists(spec["ready_file"]):
            if procs[eid].poll() is not None or time.monotonic() > deadline:
                logs[eid].flush()
                with open(logs[eid].name) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(f"fleet: member {eid} never came ready "
                                   f"(rc {procs[eid].poll()}):\n{tail}")
            time.sleep(0.05)
    return procs, logs, specs


def _fleet_reap(procs, logs, grace_s: float = 60.0) -> dict:
    import signal

    rcs = {}
    deadline = time.monotonic() + grace_s
    for eid, p in procs.items():
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        rcs[eid] = p.returncode
    for f in logs.values():
        f.close()
    return rcs


def phase_fleet(seed: int) -> dict:
    """Phase ``fleet`` (see the module docstring): the fault-free reference
    through one supervised member here, then the member processes, the
    SIGKILL of the busiest member mid-stream and the coordinator's death,
    every stream token-equal to the reference in fp32."""
    import shutil
    import signal
    import tempfile

    import numpy as np
    from deepspeed_tpu_torch.elasticity import FileCoordinationStore, dead_set, read_generation
    from deepspeed_tpu_torch.inference import FleetRouter, StoreMemberProxy
    from deepspeed_tpu_torch.inference.fleet_member import warm_up

    t0 = time.perf_counter()
    free_memory()
    # 1. the fault-free reference: the stream through one supervised member
    model, params, engine = _fleet_engine(seed)
    cfg = model.config
    checksum = _checksum(params)
    stream = serving_stream(seed, cfg.vocab_size)
    want = {r.rid: r.max_new_tokens for r in stream}
    sup = engine.supervised_serving(max_restarts=5, **FLEET_SERVE)
    warm_up(sup.engine)
    torch.cuda.synchronize()
    reset_counts()
    base = _serve_counts(sup)
    t = time.perf_counter()
    ref_results = sup.run(_fleet_copies(stream))
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t
    ref = {r.rid: np.asarray(r.output_ids) for r in ref_results}
    ref_tokens = sum(len(v) for v in ref.values())
    ref_counts = _serve_counts(sup, base)
    ref_acct = sup.engine.page_accounting()
    check(sorted(ref) == sorted(want) and all(
        r.finish_reason == "length" and len(r.output_ids) == want[r.rid] for r in ref_results),
        "fleet: the reference run did not finish every request at its length")
    check(ref_acct["balanced"] and ref_counts["captures"] == 1 and ref_counts["k4_counter"] == 0,
          f"fleet: the reference run's accounting or captures: {ref_acct}, {ref_counts}")
    sup.engine.close()
    del sup, engine, params, model, ref_results
    free_memory()

    # 2. the member processes and the two routers
    root = tempfile.mkdtemp(prefix="ds_port_fleet_")
    procs, logs = {}, {}
    try:
        t_spawn = time.time()
        procs, logs, specs = _fleet_members(root, seed)
        t_ready = time.time()
        store = FileCoordinationStore(os.path.join(root, "store"))
        kw = {"lease_s": FLEET_ROUTER_LEASE_S, "miss_limit": FLEET_MISS_LIMIT,
              "journal_every_k": None, "journal_flush_ms": FLEET_JOURNAL_FLUSH_MS}

        def router(rid):
            proxies = [StoreMemberProxy(f"engine{i}", store, router_id=rid,
                                        lease_s=FLEET_LEASE_S) for i in range(FLEET_MEMBERS)]
            for p in proxies:
                p.beat()
            return FleetRouter(store, proxies, router_id=rid, **kw)

        coord, standby = router("router0"), router("router1")
        coord.step()
        standby.step()
        check(coord.is_coordinator and not standby.is_coordinator,
              "fleet: router0 did not win the first term")
        t_submit = time.time()
        for r in _fleet_copies(stream):
            coord.submit(r)
        results = []
        ev = {"victim": None, "kill_t": None, "detect_t": None, "first_resumed_t": None,
              "coord_kill_t": None, "takeover_t": None, "coord_kill_round": None}
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        rounds = 0
        while True:
            if coord.alive:
                coord.step()
                results += coord.take_results()
            standby.step()
            results += standby.take_results()
            rounds += 1
            now = time.time()
            if ev["victim"] is None:
                owners = dict(coord._owner)
                load = {e: sum(1 for o in owners.values() if o == e) for e in sorted(procs)}
                victim = max(sorted(load), key=lambda e: load[e])
                journaled = {rid: len(doc.get("tokens") or ())
                             for rid, doc in coord._journal_docs.items()
                             if rid in coord._requests and owners.get(rid) == victim}
                if journaled and max(journaled.values()) >= FLEET_KILL_JOURNALED:
                    os.killpg(procs[victim].pid, signal.SIGKILL)
                    ev["kill_t"] = time.time()
                    procs[victim].wait()
                    ev["victim"] = victim
                    ev["victim_rids"] = sorted(r for r, o in owners.items() if o == victim)
                    ev["journaled_at_kill"] = journaled
                    ev["victim_load"] = load
                    prog = store.get(f"fleet/progress/{victim}") or {}
                    ev["progress_at_kill"] = {rid: len(toks)
                                              for rid, toks in prog.get("streams") or ()}
            elif ev["detect_t"] is None and ev["victim"] in coord._failed_engines:
                ev["detect_t"] = now
            elif ev["detect_t"] is not None and ev["first_resumed_t"] is None:
                live = coord if coord.alive else standby
                for rid in ev["victim_rids"]:
                    owner = live._owner.get(rid)
                    done = any(r.rid == rid for r in results)
                    if done or (owner is not None
                                and live.members[owner].stream_progress().get(rid)):
                        ev["first_resumed_t"] = now
                        ev["first_resumed_round"] = rounds
                        break
            if ev["first_resumed_t"] is not None and coord.alive \
                    and rounds >= ev["first_resumed_round"] + FLEET_COORD_KILL_ROUNDS:
                ev["coord_term"] = coord.term
                ev["coord_generation"] = coord.generation
                coord.kill()
                ev["coord_kill_t"] = now
                ev["coord_kill_round"] = rounds
            if ev["coord_kill_t"] is not None and ev["takeover_t"] is None \
                    and standby.is_coordinator:
                ev["takeover_t"] = now
            if ev["takeover_t"] is not None and standby.outstanding() == 0 \
                    and not store.list("fleet/requests"):
                break
            check(time.monotonic() < deadline,
                  f"fleet: the stream did not finish within {FLEET_TIMEOUT_S} s: {ev}, "
                  f"{len(results)} results, coordinator alive {coord.alive}")
            time.sleep(0.001)
        t_done = time.time()
        for eid, p in standby.members.items():
            if p.alive:
                p.send_control("shutdown")
        rcs = _fleet_reap({e: p for e, p in procs.items() if e != ev["victim"]},
                          {e: f for e, f in logs.items() if e != ev["victim"]})
        logs[ev["victim"]].close()
        members = {eid: _fleet_records(spec["out"]) for eid, spec in specs.items()}
        store_state = {"dead": dead_set(store, prefix="fleet/dead"),
                       "journal_left": store.list("fleet/requests"),
                       "coordinator": store.get("fleet/coordinator"),
                       "generation": read_generation(store, key="fleet/generation")}
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        for f in logs.values():
            f.close()
        shutil.rmtree(root, ignore_errors=True)

    by = {}
    dup = []
    for r in results:
        if r.rid in by:
            dup.append(r.rid)
        by[r.rid] = r
    victim = ev["victim"]
    inflight = sorted(ev["progress_at_kill"])
    fleet_tokens = sum(len(r.output_ids) for r in by.values())
    redecoded = {str(rid): ev["progress_at_kill"][rid] - by[rid].resumed_tokens
                 for rid in inflight if rid in by}
    survivors = [e for e in sorted(members) if e != victim]
    per_member = {}
    for eid, recs in members.items():
        last = recs.get("exit") or recs.get("counts") or {}
        per_member[eid] = {
            "start_to_ready_s": recs.get("ready", {}).get("start_to_ready_s"),
            "checksum": recs.get("ready", {}).get("checksum"),
            "of_which_profiler_start_s": recs.get("ready", {}).get("profiler_start_s"),
            "libraries": recs.get("ready", {}).get("libraries"),
            "rc": rcs.get(eid), "killed": eid == victim,
            **{key: last.get(key) for key in ("k1", "k4_counter", "prefills", "ticks",
                                              "graph_k4", "k4_replayed", "k1_profiled",
                                              "k4_profiled", "captures", "restarts",
                                              "page_accounting", "rounds",
                                              "peak_memory_gb")}}
    rec = {"phase": "fleet", "config": FLEET_CONFIG, "model": FLEET_MODEL,
           "layers": FLEET_LAYERS, "depth_cut": {"num_layers": FLEET_LAYERS},
           "dtype": "float32", "members": FLEET_MEMBERS, "serve": FLEET_SERVE,
           "lease_s": FLEET_LEASE_S, "miss_limit": FLEET_MISS_LIMIT,
           "router_lease_s": FLEET_ROUTER_LEASE_S,
           "journal_flush_ms": FLEET_JOURNAL_FLUSH_MS, "requests": len(stream),
           "reference": {"run_s": ref_s, "output_tokens": ref_tokens,
                         "output_tok_per_s": ref_tokens / ref_s, **ref_counts,
                         "page_accounting": ref_acct},
           "weights_checksum": checksum,
           "spawn_to_all_ready_s": t_ready - t_spawn,
           "victim": victim, "victim_load_at_kill": ev.get("victim_load"),
           "victim_inflight_at_kill": inflight,
           "journaled_at_kill": {str(k): v for k, v in ev["journaled_at_kill"].items()},
           "time_to_detect_s": ev["detect_t"] - ev["kill_t"],
           "time_to_failover_s": ev["first_resumed_t"] - ev["kill_t"],
           "tokens_redecoded": sum(redecoded.values()), "redecoded_by_rid": redecoded,
           "coordinator_term": ev.get("coord_term"), "standby_term": standby.term,
           "coordinator_kill_to_takeover_s": ev["takeover_t"] - ev["coord_kill_t"],
           "router_rounds": rounds,
           "fleet_run_s": t_done - t_submit, "fleet_output_tokens": fleet_tokens,
           "fleet_output_tok_per_s": fleet_tokens / (t_done - t_submit),
           "failovers_by_rid": {str(r.rid): r.failovers for r in by.values() if r.failovers},
           "resumed_by_rid": {str(r.rid): r.resumed_tokens for r in by.values()
                              if r.resumed_tokens},
           "duplicates": dup, "store": store_state, "per_member": per_member,
           "nvidia_smi": nvidia_smi_line()}
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    check(not dup and sorted(by) == sorted(want),
          f"fleet: lost or doubled requests: {sorted(set(want) - set(by))}, {dup}")
    for rid, r in by.items():
        check(r.finish_reason in ("length", "eos") and len(r.output_ids) == want[rid],
              f"fleet: request {rid} ended {r.finish_reason} at {len(r.output_ids)} tokens")
        check(np.array_equal(np.asarray(r.output_ids), ref[rid]),
              f"fleet: request {rid}'s tokens differ from the fault-free run "
              f"(failovers {r.failovers}, resumed {r.resumed_tokens})")
    check(inflight and all(by[rid].failovers >= 1 for rid in inflight),
          f"fleet: a stream in flight on {victim} was not failed over: "
          f"{ {str(r): by[r].failovers for r in inflight} }")
    check(any(by[rid].resumed_tokens > 0 for rid in inflight),
          f"fleet: no failed-over stream resumed from the journal: {rec['resumed_by_rid']}")
    check(standby.is_coordinator and standby.term > rec["coordinator_term"],
          f"fleet: the standby's term {standby.term} is not above the dead "
          f"coordinator's {rec['coordinator_term']}")
    check(store_state["dead"] == [victim] and not store_state["journal_left"],
          f"fleet: the store after the run: {store_state}")
    for eid in survivors:
        m = per_member[eid]
        check(m["rc"] == 0 and m["page_accounting"]["balanced"]
              and m["captures"] == 1 and m["k4_counter"] == 0 and m["restarts"] == 0,
              f"fleet: survivor {eid}: {m}")
        # the profiler's kernel events against the counters and the replays
        check(m["k1_profiled"] == m["k1"] and m["k4_profiled"] == m["k4_replayed"],
              f"fleet: survivor {eid}'s profiled launches K1 {m['k1_profiled']}, K4 "
              f"{m['k4_profiled']} against K1 {m['k1']} and {m['graph_k4']} K4 launches "
              f"a replay x {m['ticks']} replays")
    for eid, m in per_member.items():
        check(m["checksum"] == checksum, f"fleet: {eid}'s weights differ: {m['checksum']} "
                                         f"vs {checksum}")
        # the paged prefill (a survivor's re-prefill too) attends with the
        # einsum over the gathered pages, as the JAX package's
        # ``_attention_paged`` does: K1 launches no time in a member; K4
        # runs inside the captured decode graph, FLEET_LAYERS a replay
        check(m["k1"] == 0 and m["graph_k4"] == FLEET_LAYERS and m["ticks"] > 0,
              f"fleet: {eid}'s launches do not follow its prefills and ticks: {m}")
        # K4's library is loaded by the capture; K1's is not on this path
        check(m["libraries"]["decode_attention"]["loaded"]
              and all(lib["built_here_s"] == 0.0 for lib in m["libraries"].values()),
              f"fleet: {eid} built a kernel or did not load K4's: {m['libraries']}")
    return rec


def _kernel_entry(name, source, replaces, launches, rec, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], **extra}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one train step, one forward, one "
                         "decode step and 10 serving decode ticks")
    ap.add_argument("--first-launch", action="store_true",
                    help="only the first launches of K1-K4 (the child process "
                         "of the hang guard)")
    ap.add_argument("--ab", nargs="+", metavar="NAME=PATH",
                    help="only build, check and time these copies of "
                         "flash_attention_fwd.cu, of flash_attention_bwd.cu or "
                         "of decode_attention.cu against each other (PATH from "
                         "the repo root; `repo`, `repo-bwd`, `repo-decode` for "
                         "the checkout's forward, backward and decode sources)")
    ap.add_argument("--ab-unchecked", action="store_true",
                    help="with --ab: time the copies without checking them "
                         "(diagnostic copies that skip work on purpose)")
    ap.add_argument("--ab-check", nargs="+", metavar="ARG",
                    help=argparse.SUPPRESS)   # NAME SPEC...: --ab's child
    ap.add_argument("--train-zero-rank", action="store_true",
                    help=argparse.SUPPRESS)   # one rank of phase train_zero
    ap.add_argument("--probe-shared-card", nargs=3, metavar="ARG",
                    help=argparse.SUPPRESS)   # BACKEND PORT RANK: the probe's child
    ap.add_argument("--serve-tp-rank", metavar="DIR",
                    help=argparse.SUPPRESS)   # one rank of phase serve_tp
    ap.add_argument("--tp-cards", action="store_true",
                    help="after every phase, the configurations that need tensor "
                         "parallelism, one process per card (several cards)")
    card_configs = (TP_CARD_CONFIGS + SP_CARD_CONFIGS + ITEM9_CARD_CONFIGS
                    + ITEM10_CARD_CONFIGS + ELASTIC_CARD_CONFIGS + POD_CARD_CONFIGS)
    ap.add_argument("--tp-cards-only", nargs="+", choices=card_configs, metavar="CONFIG",
                    help="only the build, then these configurations, one process "
                         "per card (of " + ", ".join(card_configs) + ")")
    ap.add_argument("--tp-card-rank", nargs=2, metavar="ARG",
                    help=argparse.SUPPRESS)   # CONFIG DIR: one rank of --tp-cards
    ap.add_argument("--only", nargs="+", choices=("offload", "zeropp_onebit",
                                                  "train_extras", "lora_hybrid",
                                                  "tooling", "observability", "elastic",
                                                  "pod", "fleet"),
                    help="only the build, then these phases (no kernels line)")
    ap.add_argument("--watchdog-child", metavar="WAIT",
                    help=argparse.SUPPRESS)   # phase observability's watchdog child
    ap.add_argument("--elastic-child", metavar="DIR",
                    help=argparse.SUPPRESS)   # phase elastic's training process
    ap.add_argument("--pod-child", metavar="DIR",
                    help=argparse.SUPPRESS)   # phase pod's training process
    ap.add_argument("--fleet-member", metavar="SPEC",
                    help=argparse.SUPPRESS)   # one member process of phase fleet
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.first_launch:
        return first_launches()
    if args.watchdog_child:
        return watchdog_child(args.watchdog_child)
    if args.elastic_child:
        return elastic_child(args.elastic_child)
    if args.pod_child:
        return pod_child(args.pod_child)
    if args.fleet_member:
        return fleet_member_child(args.fleet_member)
    if args.probe_shared_card:
        backend, port, rank = args.probe_shared_card
        return shared_card_child(backend, int(port), int(rank))
    if args.train_zero_rank:
        return train_zero_rank(args.seed)
    if args.serve_tp_rank:
        return _run_rank(lambda: serve_tp_rank(args.seed, args.serve_tp_rank))
    if args.tp_card_rank:
        return _run_rank(lambda: tp_card_rank(args.seed, *args.tp_card_rank))
    if (args.tp_cards or args.tp_cards_only) and torch.cuda.device_count() < 2:
        print("chip_smoke: --tp-cards needs several cards", file=sys.stderr)
        return 2
    if args.tp_cards_only:
        print(nvidia_smi_line(), flush=True)
        phase_build()
        rank_configs = [c for c in args.tp_cards_only
                        if c not in ELASTIC_CARD_CONFIGS + POD_CARD_CONFIGS]
        if rank_configs:
            phase_tp_cards(args.seed, rank_configs)
        if "elastic4_740m" in args.tp_cards_only:
            phase_elastic4(args.seed)
        if "pod4_740m" in args.tp_cards_only:
            phase_pod4(args.seed)
        return 0
    if args.only:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(nvidia_smi_line(), flush=True)
        phase_build()
        reference = None
        for name in args.only:
            if name == "elastic":
                _, reference = phase_elastic(args.seed)
            elif name == "pod":
                phase_pod(args.seed, reference)
            elif name == "fleet":
                phase_fleet(args.seed)
            else:
                {"offload": phase_offload, "zeropp_onebit": phase_zeropp_onebit,
                 "train_extras": phase_train_extras,
                 "lora_hybrid": phase_lora_hybrid, "tooling": phase_tooling,
                 "observability": phase_observability}[name](args.seed)
        return 0
    if args.ab_check:
        return ab_check(args.ab_check[1:], args.ab_check[0])
    if args.ab:
        print(nvidia_smi_line(), flush=True)
        return ab(args.ab, args.ab_unchecked)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references in fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t_start = time.perf_counter()
    phase_build()
    phase_first_launch()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    fwd = phase_fwd_kernel(gen)
    bwd = phase_bwd_kernels(gen)
    dec = phase_decode_kernel(gen, args.seed)
    sparse = phase_sparse_attention(gen)
    phase_transformer_layer(args.seed)
    ring = phase_ring_attention(gen)
    k1, (k2, k3) = fwd[TRAIN_SHAPE], bwd[TRAIN_SHAPE]
    train_launches, base = phase_train(
        args.seed, args.profile, {"fwd": k1["ms"], "dq": k2["ms"], "dkv": k3["ms"]})
    remat = phase_train_remat(args.seed, base)
    phase_train_parity(args.seed)
    phase_train_loop(args.seed)
    phase_train_zero(args.seed)
    phase_frozen(args.seed)
    phase_checkpoint(args.seed)
    elastic, elastic_ref = phase_elastic(args.seed)
    pod = phase_pod(args.seed, elastic_ref)
    del elastic_ref
    serve_launches, k4_launches, item6 = phase_serving(args.seed, args.profile)
    fleet = phase_fleet(args.seed)
    moe_serve = phase_moe_serving(args.seed)
    moe_train = phase_moe_train(args.seed)
    pipe = phase_pipeline(args.seed)
    offload = phase_offload(args.seed)
    zpp_onebit = phase_zeropp_onebit(args.seed)
    extras = phase_train_extras(args.seed)
    lora = phase_lora_hybrid(args.seed)
    tooling = phase_tooling(args.seed)
    obs = observability_summary(args.seed, item6["observability"], tooling)
    if args.tp_cards:
        phase_tp_cards(args.seed)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    src = "deepspeed_tpu_torch/ops/csrc/"
    jax_src = "deepspeed_tpu/ops/pallas/flash_attention.py"
    main_case = sparse[SPARSE_CASES[0][0]]

    def fp32_record(i):
        rec = bwd[FP32_BWD_SHAPE][i]
        return {"shape": rec["shape"], **{key: rec[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}

    def block_mask(name, replaces):
        rec = main_case["kernels"][name]
        return {"case": main_case["case"], "replaces": jax_src + replaces,
                **{key: rec[key] for key in (
                    "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "unmasked_ms", "ratio_to_unmasked")}}

    def item9_launches(i):
        """The MoE and pipeline paths' launches of K1 (i=0), K2, K3."""
        key = ("K1", "K2", "K3")[i]
        rec = {"launches_moe_train_per_step": moe_train["train_per_step"][i],
               "launches_moe_train": {p: moe_train[p][key] for p in ("capacity", "nodrop")},
               "launches_prmoe_fwd_bwd": moe_train["prmoe"][key],
               "launches_pipeline_per_step": pipe["per_step"][key]}
        if i == 0:
            rec["launches_moe_forward"] = moe_serve["k1_forward"]
        return rec

    def item10_launches(i):
        """The offload and ZeRO++/1-bit paths' launches of K1 (i=0), K2, K3,
        as each of their steps measured them (one count a step)."""
        key = ("K1", "K2", "K3")[i]
        runs = {**zpp_onebit["zeropp"], **zpp_onebit["onebit"]}
        return {"launches_offload_7b_per_step": offload["llama2-7b"]["launches_per_step"][key],
                "offload_7b_layers": offload["llama2-7b"]["layers"],
                "launches_offload_740m_per_step": {
                    mode: rec[key]
                    for mode, rec in offload["llama-740m"]["launches_per_step"].items()},
                "launches_zeropp_onebit_per_step": {
                    label: rec["launches"][key] for label, rec in runs.items()}}

    def item11_launches(i):
        """This slice's launches of K1 (i=0), K2, K3: per optimizer step,
        per PLD step by its kept layers, per random-LTD kept count, per
        curriculum length, per LoRA llama2-7b step and per hybrid prefill."""
        key = ("K1", "K2", "K3")[i]
        rec = {"launches_extra_optimizers_per_step": {
                   name: extras["optimizers"][name]["launches_per_step"][key]
                   for name in EXTRA_OPTIMIZERS},
               "launches_pld_per_step": [
                   {"kept_layers": r["kept_layers"], "launches": r["launches"][i]}
                   for r in extras["pld"]],
               "launches_random_ltd_per_keep": {
                   str(r["keep"]): r["launches"][i] for r in extras["random_ltd"]},
               "launches_curriculum_per_seq": {
                   str(r["seq"]): r["launches"][i] for r in extras["curriculum"]},
               "launches_lora_7b_per_step": [r["step_launches"][i]
                                             for r in lora["rounds"] if "step_launches" in r]}
        if i == 0:
            rec["launches_hybrid_per_prefill"] = [r["prefill_launches"][0]
                                                  for r in lora["rounds"]]
        return rec

    def tooling_launches(i):
        """Phase tooling's launches of K1 (i=0), K2, K3: per compressed step,
        in the compressed run, per profiled-cell step, in the autotuner's
        trials; K1 in the cleaned and masked forwards."""
        key = ("K1", "K2", "K3")[i]
        comp, prof = tooling["compression"], tooling["flops_profiler"]
        rec = {"launches_tooling_compressed_per_step": comp["launches_per_step"][key],
               "launches_tooling_compressed": comp["launches"][key],
               "launches_tooling_student_step": tooling["clean"]["student_launches"][i],
               "launches_tooling_profiled_cell_per_step": [p[i] for p in
                                                           prof["launches_per_step"]],
               "launches_tooling_autotune": tooling["autotune"]["launches"][key]}
        if i == 0:
            rec["launches_tooling_clean_forwards"] = tooling["clean"]["k1_launches"]
        return rec

    def elastic_launches(i):
        """Phase elastic's launches of K1 (i=0), K2, K3 a step: the
        uninterrupted run here, the launched process SIGTERM-ed mid-run and
        the relaunched one."""
        return {"launches_elastic_per_step": {
            run: [step[i] for step in steps]
            for run, steps in elastic["launches_per_step"].items()}}

    def pod_launches(i):
        """Phase pod's launches of K1 (i=0), K2, K3 a step: the launched
        process that lost its peer and the relaunched one."""
        return {"launches_pod_per_step": {
            run: [step[i] for step in steps]
            for run, steps in pod["launches_per_step"].items()}}

    def fleet_launches(kernel):
        """Phase fleet's launches of K1 or K4 in each member process: the
        kernel events a survivor's torch.profiler counted over its serving
        life (the SIGKILLed member's profile dies with it: null), beside
        what its counters imply (K1's wrapper count; K4's graph launches a
        replay x replays), its prefills and decode ticks."""
        key = {"K1": "k1", "K4": "k4_replayed"}[kernel]
        derived = {"K1": "the wrapper's count",
                   "K4": "graph launches a replay x replays"}[kernel]
        return {"launches_fleet": {eid: {
                    "launches": m[f"{kernel.lower()}_profiled"],
                    "counted_by": "torch.profiler kernel events",
                    "launches_derived": m[key], "derived_as": derived,
                    "prefills": m["prefills"], "decode_ticks": m["ticks"],
                    "killed": m["killed"]}
                    for eid, m in fleet["per_member"].items()},
                "launches_fleet_reference": fleet["reference"][key],
                "launches_fleet_reference_derived_as": derived}

    def ring_record(name):
        """The ring's launch pattern: one block (non-causal; K2/K3 with
        dlse) at the virtual ring's shard and at sp4_740m's, and the
        virtual sp=4 ring's launches at the main case."""
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        rec, sp4 = ring["block"][name], ring["block_sp4_740m"][name]
        main = ring[RING_CASES[0][0]]
        return {"block_shape": rec["shape"], "dlse": rec["dlse"],
                "launches_virtual_ring": main["launches"][name],
                "ring_case": main["case"], "ring_sp": main["sp"],
                "ring_ms": main["ring_ms"], "one_device_ms": main["one_device_ms"],
                **{key: rec[key] for key in keys},
                "sp4_740m_block": {"shape": sp4["shape"], **{key: sp4[key] for key in keys}}}

    emit({"kernels": [
        _kernel_entry("flash_attention_fwd", src + "flash_attention_fwd.cu",
                      jax_src + ":74", train_launches[0], k1,
                      design=K1_DESIGN, tflops=k1["tflops"],
                      serving_shape_tflops=fwd[SERVE_SHAPE]["tflops"],
                      launches_serving_forward=serve_launches,
                      launches_hf_load_forward=item6["hf_load"]["k1"],
                      launches_quantized_forward=item6["quantized"]["k1"],
                      launches_generate_fallback=item6["generate_fallback"]["k1"],
                      generate_fallback_forwards=item6["generate_fallback"]["forward_runs"],
                      launches_per_step_save_qkv=remat["save_qkv"]["launches_per_step"]["K1"],
                      serving_shape_ms=fwd[SERVE_SHAPE]["ms"],
                      block_mask=block_mask("K1", ":88"),
                      ring=ring_record("K1"), **item9_launches(0), **item10_launches(0),
                      **item11_launches(0), **tooling_launches(0), **elastic_launches(0), **pod_launches(0),
                      launches_observability_per_step=obs["train"]["launches_per_step"][0][0],
                      **fleet_launches("K1")),
        _kernel_entry("flash_attention_bwd_dq", src + "flash_attention_bwd.cu",
                      jax_src + ":189", train_launches[1], k2, design=K2_DESIGN,
                      bound_share=k2["bound_share"], fp32=fp32_record(0),
                      block_mask=block_mask("K2", ":202"), ring=ring_record("K2"),
                      **item9_launches(1), **item10_launches(1), **item11_launches(1),
                      **tooling_launches(1), **elastic_launches(1), **pod_launches(1),
                      launches_observability_per_step=obs["train"]["launches_per_step"][0][1]),
        _kernel_entry("flash_attention_bwd_dkv", src + "flash_attention_bwd.cu",
                      jax_src + ":236", train_launches[2], k3, design=K3_DESIGN,
                      bound_share=k3["bound_share"], fp32=fp32_record(1),
                      block_mask=block_mask("K3", ":254"), ring=ring_record("K3"),
                      **item9_launches(2), **item10_launches(2), **item11_launches(2),
                      **tooling_launches(2), **elastic_launches(2), **pod_launches(2),
                      launches_observability_per_step=obs["train"]["launches_per_step"][0][2]),
        _kernel_entry("decode_attention", src + "decode_attention.cu",
                      "tools/retired_decode_attention.py:53", k4_launches["counter"],
                      dec["serve"], design=K4_DESIGN, l2="flushed",
                      bound_share=dec["serve"]["bound_share"],
                      cases={label: {key: rec[key] for key in (
                          "ms", "plain_ms", "library_ms", "bound_ms", "bound_share")}
                          for label, rec in dec.items() if not label.endswith("-int8")},
                      launches_per_decode_tick=k4_launches["per_tick"],
                      decode_ticks=k4_launches["ticks"],
                      launches_replayed=k4_launches["replayed"],
                      launches_hf_load_serving=item6["hf_load"]["k4"],
                      launches_quantized_serving=item6["quantized"]["k4"],
                      launches_serving_extras=item6["serving_extras"]["launches"],
                      launches_moe_serving=moe_serve["k4"]["counter"],
                      launches_moe_serving_per_tick=moe_serve["k4"]["per_tick"],
                      moe_serving_ticks=moe_serve["k4"]["ticks"],
                      launches_observability_serving=obs["serving"]["run"]["k4_counter"],
                      **fleet_launches("K4"),
                      cost_sink=obs["serving"]["k4_cost"],
                      int8={"case": "serve", "design": K4_INT8_DESIGN,
                            **{key: dec["serve-int8"][key] for key in (
                                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "bound_share", "library_ms", "library_what",
                                "full_precision_ms", "tile_rows", "nsplit")},
                            "launches": item6["serving_extras"]["launches"]["int8"]["counter"],
                            "launches_per_decode_tick":
                                item6["serving_extras"]["launches"]["int8"]["per_tick"],
                            "cases": {label[:-5]: {key: rec[key] for key in (
                                "ms", "plain_ms", "library_ms", "bound_ms", "bound_share",
                                "full_precision_ms", "max_abs_err")}
                                for label, rec in dec.items() if label.endswith("-int8")}},
                      launches_counted="wrapper calls on the paged serving path: "
                                       "2 warm-up runs and the capture of the decode "
                                       "graph; each tick replays the captured ones")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
