#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: compile the CUDA kernels from src/repro_torch/csrc into build/.
  3. kernels: each kernel against its plain PyTorch version on the card, in
     bf16 and fp32, at the shapes of the three paths below (plus every
     flash mask kind at a small size), with times of the kernel, the plain
     version and, where one PyTorch call computes the same function, that
     call. The paged decode kernel also equals the ring kernel bit for bit
     on a paginated copy of the same cache. Each row of both paged
     kernels (pair and single layer) equals, bit for bit, the same row
     launched alone, in the first 2 and 6 rows (the degraded engine's
     cohorts) and inside a 40-row launch (batch invariance); both are held
     against their plain versions and timed at the speculative verify's
     shape (8 slots x 5 probe rows = 40 rows). Both paged kernels with a
     head map (``HEAD_MAP_SHAPES``: tinyllama's heads and its tp = 8
     rank's, granite-34b's g = 48 at hd 128; the identity, a permutation
     and repeated heads over a pool of more stored heads than q has;
     recurrentgemma-9b's tp = 2 rank, g = 8 at hd 256 over pools of 1 and
     2 stored heads) are
     held against their plain versions and, bit for bit, against the
     identity launch on a pool whose heads were gathered first, and timed
     beside it. The flash kernel with a
     per-row q0 tensor of equal entries equals its scalar launch, its rows
     below Lq equal a
     launch cut to Lq (padding transparency, also with junk keys past Lq),
     and it is timed at the engine's bucket shape beside SDPA with a
     boolean mask; the selective scan equals its plain version bit for bit
     in fp32 (and a sequence split across two calls equals one call), also
     at phase 15's rank widths (a Mamba pair at d_inner / 2, an RG-LRU
     pair at lru_width / 2). The
     dual RMSNorm's rows equal, bit for bit, the same row launched alone,
     inside an 8-row launch and at three offsets of a 2048-row launch (D =
     2048, 4096 and 100, plus_one both ways; scales that are not 16-byte
     aligned give the bits of an aligned copy). At every path's shape
     (``NORM_SHAPES``) it is held against its plain version in bf16 and
     fp32, and timed in bf16 beside two ``F.rms_norm`` calls (its
     yardstick) and beside the launch floor: an empty one-block kernel
     timed the same way, launched plainly and as the norm is (programmatic
     dependent launch). It is timed back to back and between the path's
     neighbours (a residual add before, a GEMM after, in one graph). At the
     dense models' head shapes (``DENSE_SHAPES``: yi-6b's GQA at hd 128,
     minicpm-2b's MHA, granite-34b's MQA with g = 48 at hd 128,
     recurrentgemma-9b's 16 query heads over one kv head at hd 256) the
     four decode entries and flash are held against their plain versions
     in bf16 and fp32 (ring horizons that walk 1 to 4 chunks), paged ==
     ring bit for bit, granite's and recurrentgemma's paged rows
     batch-invariant, and each is timed beside its bound, its plain version
     and SDPA; at recurrentgemma's shape also flash with the window mask
     (W = 2048) at generate's prefill and at a 2304-token prompt. The same
     at the MoE models' head shapes (``MOE_SHAPES``: dbrx-132b's 8 kv heads
     with g = 6, llama4-scout's with g = 5, hd 128), and at llama4's flash
     with the chunk mask (chunk 8192) at generate's prefill and at an
     8448-token prompt; the dual RMSNorm also at D = 5120 (llama4). The
     same at paligemma-3b's and whisper-medium's head shapes
     (``PREFIX_ENCDEC_SHAPES``: 8 query heads over 1 kv head at hd 256; 16
     heads at hd 64; and their tp = 2 rank shapes of phase 15 (d), 4 query
     heads over the kv head and 8 heads), with flash at phase 12's launches: the causal mask
     with a prefix of 256 over 384 positions (hd 256), the bidirectional
     encoder at S = T = 1500, and cross-attention of 32 and of 1 query row
     against 1500 keys.
  4. reduced parity: tinyllama, yi-6b, minicpm-2b, granite-34b and
     falcon-mamba cut to 4 layers in fp32, LP pairs (0,1), (2,3) (the dense
     three: plan_for_depth 3, one pair and two single layers, biases and
     norms filled from a seed): greedy tokens on the card equal the port's
     CPU path, prefill logits agree within 2e-4; the continuous-batching
     ``PagedEngine`` on the card gives the same tokens as ``generate`` on
     the card and as the engine on the CPU (for falcon-mamba also with a
     preempted request, resumed by a full re-prefill). Then granite-34b at
     full width cut to 2 layers (one LP pair), fp32: card == CPU for 2
     prompts of 32 tokens and 8 new, and the engine == ``generate`` on the
     card (the fp32 wide-group decode body on a model path). Then
     recurrentgemma cut to 6 layers (window 16; prompts of 21 tokens wrap
     the window ring): card == CPU; at the window raised to the cache
     length, the engine on the card == generate == the engine on the CPU;
     and one recurrentgemma period at full width (3 layers, 2.7 B fp32):
     card == CPU, the engine == generate (the hd 256 kernels in fp32).
     Then reduced paligemma (a prefix of 8) and whisper (2 encoder layers
     over 24 frames), plan_for_depth 3: card == CPU through ``generate``
     (the paged pool refuses both, as the JAX package's does); paligemma
     at full width cut to 2 layers (one pair) behind its 256 patch
     embeddings, fp32: card == CPU (prefix flash and the pair decode at hd
     256 on a model path); and ``core.interventions.apply_intervened`` on
     reduced paligemma, every plan kind and form: card == CPU, and on the
     card the sequential plan == the model's stack, bit for bit, and the
     "tp" groups of two == the LP pair path within 2e-4.
  5. generate path: LP tinyllama-1.1b at full width (22 layers,
     plan_for_depth 16 -> 6 pairs + 10 single layers), bf16 random weights
     from a seed, 4 prompts of 128 tokens, 64 new tokens through
     ``generate``, with the exact launch count of every kernel, and prefill
     ms and decode ms per step taken inside that one ``generate`` call.
  6. engine path: the same model behind ``PagedEngine`` (8 slots, pages of
     16, 129 pages, prefix cache, auto bucket ladder), 16 requests in two
     waves (8 sharing a 64-token prefix, 8 cold), 32 new tokens each: an
     fp32-pool run whose streams are held against ``generate`` (any
     divergence must sit at a near-tie), then a timed bf16-pool run whose
     kernel launches reconcile exactly with the engine's own counters, and
     a profiled window of 8 engine steps. In the timed runs of phases 5,
     6 and 9 the first layer's decode launch of each decode kernel at
     decode steps 0 and 40 is copied (inputs and output) and held against
     the kernel's plain version: the bf16 bodies on the model path itself.
  8. speculative and degraded engine paths, with phase 6's model, geometry
     and traffic. Speculative decoding (k = 4 drafts at plan_range(0, 22),
     11 pairs; verify at 8 x 5 = 40 rows): an fp32-pool run whose streams
     are held against phase 6's plain engine (near-tie rule), a timed
     bf16-pool run whose launches reconcile with the spec counters, its
     trace (``dump_trace``) through ``validate_trace``, runs with the
     segment weights scaled by 0.1, where drafts agree (fp32 pools: spec
     streams held against a plain engine on the same weights, with drafts
     accepted; bf16: accept per verify and engine steps), and a profiled
     window of 8 steps. The degraded cohort
     (the top 2 slots at plan_range(0, 22), SLO pressure at queue depth 1):
     an fp32-pool run whose streams are held against ``generate`` at their
     cohort's plan, and a timed bf16-pool run whose launches reconcile per
     cohort with the engine's spans.
  7. Mamba path: LP falcon-mamba-7b at full width (d 4096, d_inner 8192,
     N 16, vocab 65024) cut to its first 8 of 64 layers (plan_for_depth
     6 -> 2 pairs + 4 single layers), random weights made on the card
     from a seed, after the tinyllama weights are freed. First in fp32
     (~4 GB): the engine
     with phase 6's geometry and traffic, fp32 pool, held stream by stream
     against ``generate`` (the prefix cache and the bucket ladder switch
     off for the recurrent mixer: every admission prefills at its exact
     length). bf16 GEMMs of other shapes (decode at M = 8 against M = 1)
     move this random model's logits by a few percent of their scale, so
     the streams are held in fp32, where they move by far less. Then the
     same weights cast to bf16: ``generate`` with phase 5's prompts and
     lengths (the selective scan once per group at prefill) and a timed
     engine run whose launches reconcile with the engine's counters, each
     with a profiled window.

  9. dense paths: yi-6b, minicpm-2b and granite-34b at their published
     widths, yi cut to its first 8 of 32 layers, minicpm to its first 6
     of 40 and granite to its first 7 of 88 (``DENSE_LAYERS``), each under
     plan_for_depth(3/4 of its layers): 8 -> 6, 6 -> 4, 7 -> 5 groups, bf16 random weights
     made on the card from the seed (each model freed before the next):
     phase 5's ``generate`` and phase 6's engine (streams held to ``generate`` under the near-tie rule
     in an fp32 pool, both computing in fp32 on the bf16 weights: bf16
     logits tie at the top too often on these deeper models to hold bf16
     streams; granite's over 8 new tokens, the others' over 32; a timed
     bf16-pool run whose launches reconcile with the counters and whose
     decode launches are held against their plain versions; granite, a
     LayerNorm model, launches no dual RMSNorm), with the peak of allocated
     device memory.
 10. hybrid path: LP recurrentgemma-9b at its published widths, cut to
     its first 10 of 38 layers (plan_for_depth(7): 3 RG-LRU pairs, 1
     single RG-LRU layer, 3 single local-attention layers at hd 256),
     bf16 random weights made on the card from the seed: phase 5's
     ``generate`` and phase 6's engine (the prefix cache and the bucket
     ladder switch off for the recurrent state; streams held to
     ``generate`` in fp32 compute, the timed bf16 run reconciled: per
     decode step 3 decode attention and 6 dual RMSNorm launches, per
     prefill 3 flash and 4 scans), then a
     window run: one 2304-token prompt (W + 256) and 16 new tokens, its
     first flash launch and its wrapped-ring decode launches held against
     their plain versions, and in fp32 compute prefill + one decode step
     equal to the full forward over prompt + 1 within 2e-3.
 11. MoE path: dbrx-132b (16 experts, top 4, LayerNorm) and llama4-scout
     (16 experts, top 1 and a shared expert; three chunked-attention
     layers, then one global NoPE layer) at their published widths, cut to
     4 layers (``MOE_LAYERS``), bf16 random weights made on the card from
     the seed (each model freed before the next): phase 5's ``generate``
     (dbrx under plan_for_depth(3): its pair (2, 3); llama4 under
     plan_for_depth(2): pairs (0, 1), chunked + chunked, and (2, 3),
     chunked + global, which decodes in two single-layer launches), at the
     published capacity factor 1.25, with the share of slots dropped in
     the first MoE layer's prefill and the flash launches by mask kind;
     for llama4 a chunk run (``ring_run``: one 8448-token prompt, 16 new;
     the fp32 check at capacity E/k); then phase 6's engine (llama4 on new
     weights under the pair (0, 1) alone: the pool refuses a mixed pair;
     exact prefills: the prefix cache and buckets switch off for an MoE
     model; streams held to ``generate`` in fp32 compute at the capacity
     factor E/k, where nothing drops, over 8 new tokens; the timed bf16
     run at 1.25 reconciled).
 12. prefix-LM and encoder-decoder paths, through ``generate`` (the paged
     pool refuses both): LP paligemma-3b at full width (18 layers under
     plan_for_depth(14): 4 pairs + 10 single layers), 4 prompts of 128
     behind 256 patch embeddings (0.02 N(0, 1) from the seed), 64 new, a
     ring cache of 512; then LP whisper-medium at full width (24 encoder
     layers over frames [4, 1500, 1024] from the seed; 24 decoder layers
     under plan_for_depth(18): 6 pairs + 12 single layers), 4 prompts of
     32, 64 new, a ring cache of 128, with the encoder timed alone. bf16
     random weights made on the card from the seed; phase 5's metrics, the
     exact launch counts (whisper: a flash launch per encoder layer, per
     decoder group for self- and for cross-attention at prefill, and per
     group for cross-attention at every decode step) and the decode
     launches at steps 0 and 40 held against their plain versions.
 13. training (``repro_torch.train``, ``launch.train``): (a) tinyllama-1.1b
     at its widths cut to 2 layers (one LP pair) in fp32: the train step's
     loss, every gradient and one AdamW step on the card equal the CPU's,
     and the card's state comes back bit for bit from a checkpoint; (b)
     LP-only recovery fine-tuning (paper Table 2's recipe) of all 22 layers
     under plan_for_depth(16) in bf16: 8 steps of 8 x 256 from the
     synthetic source through ``train_loop`` (ms per step, tokens/s, peak
     memory, loss per step, one step profiled), with no kernel launched by
     the training forward and the frozen leaves bit-identical; the eval
     step (kernels) against the differentiable loss, then the fine-tuned
     weights through ``generate``, launches reconciled.
 14. tools: ``launch.serve.main`` in this process at tinyllama-1.1b's
     published widths under plan_for_depth(16) (``SERVE_ARGV``): one-shot,
     whose tokens equal a direct ``generate`` on the same weights and
     prompts bit for bit (launches reconciled, prefill and decode held to
     the H100 roofline of ``analysis.roofline``), then ``--continuous``
     three times: 16 requests of 32 tokens with the prefix cache and
     buckets (streams held to ``generate`` under the near-tie rule, trace
     validated, Prometheus metrics written), then 8 of 16 with ``--spec-k
     4`` and with ``--degrade-delta``, each with every request finished and
     every page freed; the dry run of the 40 cells with LP on and off and
     its report, with its weights + page pool of the continuous engine
     within 5% of ``torch.cuda.memory_allocated``;
     ``examples/quickstart_torch.py``. Every run's decode launches at two
     steps, and its first flash and dual RMSNorm launch at each shape, are
     held against their plain versions on the same inputs. (d) The same
     command at ``--mesh 1x2 --backend gloo`` (``MESH_ARGV``: 8 new
     tokens, fp32 weights), one-shot and then continuous (8 requests): the command line
     starts its two rank processes on the card (``launch.mesh.
     spawn_ranks``); every rank launches flash, the dual RMSNorm and its
     decode kernels, and rank 0's streams are held to the command at
     ``--mesh 1x1`` under the near-tie rule. (e) The dry run at the JAX
     package's grids, ``--mesh 16x16`` and ``--multi-pod``, for three
     cells (``DRY_GRID_CELLS``): rank 0's step on meta tensors, each
     collective recorded; no record may hold an error, and the card's
     memory must not move.
 15. tensor parallel: serving at tp > 1 with every rank a process of its
     own on the one card, joined over gloo (NCCL refuses two ranks on one
     device; the NCCL paths stay unrun and are printed). (a) tinyllama-1.1b
     cut to 11 of its 22 layers under plan_for_depth(8) at tp = 2 (its 4 kv
     heads split, 2 a rank), the ranks' shards of bf16 weights from the
     seed: each
     rank first checks that gloo takes CUDA tensors for all_reduce SUM and
     MAX (fp32, bf16, int64, int32), then records the collectives of a
     prefill (4 x 128) and one serve step, held in this process to the
     dry run's record of the same structure, rank and step
     (``make_dry_context``: kinds, bytes, group sizes, order), and runs
     ``sharded_generate`` (10 new) and ``PagedEngine`` on half of phase
     6's traffic as timed bf16 runs whose launches reconcile and whose
     decode launches are held to their plain versions (``DecodeProbe``).
     Its fp32 streams against tp = 1 are cut: phase 14 (d) holds the
     full model's streams at tp = 2 to tp = 1. (b) cut to 4 layers (one
     pair, two single layers) at tp = 8: 4 kv heads under 8 ranks are
     replicated and rank r's q heads read stored head r // 2 through the
     paged kernels' head map; its tokens (fp32 compute, 8 new) equal tp =
     1's and every rank launched both paged kernels with its map. (c) in
     (a)'s rank processes, after tinyllama: falcon-mamba-7b (4 layers, pair
     (0, 1): d_inner / 2 a rank), recurrentgemma-9b (3 layers, rec, rec,
     attn_local, pair (0, 1): lru_width / 2 a rank, its one kv head
     replicated and read through the paged kernel's head map), dbrx-132b
     (3 layers, pair (1, 2): 8 of 16 experts a rank) and llama4-scout (4
     layers, pairs (0, 1) and (2, 3), chunked + global, for
     ``sharded_generate``; the engine under (0, 1)) at their published
     widths, bf16 random weights from the seed (``TP_FAMILIES``): each
     family's ``sharded_generate`` (4 x 128) and engine (``tp_traffic``),
     10 new, in fp32 compute (the MoE models at capacity E/k) held to tp =
     1 streams that this process made and freed before the ranks started;
     timed bf16 runs reconciled and probed as in (a) (the first flash and
     scan launch at each shape too); one decode step's all-reduces
     counted and held to 1 + 2 per group sums and 3 max (tinyllama's
     too). (d) in the same ranks, after (c): whisper-medium (2 encoder + 2
     decoder layers, pair (0, 1): 8 of 16 heads a rank in the encoder, the
     decoder and the cross-attention) on frames [4, 1500, 1024] with
     prompts 4 x 32, and paligemma-3b (2 layers, pair (0, 1): 4 of 8 q
     heads over its replicated kv head) behind 256 patch embeddings with
     prompts 4 x 128 and a cache of 512, once at kv_mode "heads" and once
     at "seq" (the ring cut along the sequence, 256 positions a rank),
     ``sharded_generate`` (10 new) held the same way (``TP_ENCDEC``); the
     timed bf16 runs reconcile (the seq ring launches no decode kernel)
     and hold the first flash launch at each rank shape (bidirectional
     over 1500 frames, cross-attention at prefill and decode, the prefix
     mask) and the ring decode launches against their plain versions; one
     serve step's collectives counted: 1 + 2 per group sums, one more per
     cross-attention phase, 2 max (the argmax), and per attention phase cut
     along the sequence one gather, one max and one sum more. (e) in (b)'s
     ranks: tinyllama's ``sharded_generate`` at kv_mode "seq" (its 4 kv
     heads under 8 ranks), whose tokens equal the heads mode's and tp =
     1's, its collectives counted as in (d). (f) in (b)'s ranks after (e):
     the sharded trainer on the (pod 2, data 2, model 2) grid of the 8
     ranks, tinyllama-1.1b at its published widths cut to 2 layers (pair
     (0, 1)), fp32: 2 steps each of ZeRO, FSDP and int8 pod compression
     (sequence parallel) on global 8 x 128 batches, held to a tp = 1 run
     in this process (loss and grad_norm), every rank to rank 0, each
     step's collectives to the count its leaf list predicts; then one eval
     step whose flash and dual RMSNorm launches are held to their plain
     versions and whose loss is held to the train forward's. (g) in
     (b)'s ranks after (f): FSDP serving on the same grid, tinyllama-1.1b
     at its published widths cut to 3 layers (pair (0, 1), a single layer
     2), its segments flat shards over the 2 data ranks gathered one
     group at a time in every prefill and decode step: ``sharded_generate``
     (2 x 32, 4 new, cache 64) in fp32 compute on bf16 shards, held to tp
     = 1 on the same weights, and on int8 shards (block-128 scales), held
     to tp = 1 on the dequantised weights; ``PagedEngine`` of the bf16
     shards on 4 requests (the two prompts twice), held to the FSDP
     streams; launches reconciled, and one serve step's collectives held
     to the leaf list (a gather per leaf per group, two with int8). (h)
     after (g): the 8 ranks as the stages of a GPipe pipeline
     (``parallel/pp.py``): tinyllama-1.1b at its published widths, 16
     layers in 8 LP pairs, one pair a stage (``stack.apply_stack_full``:
     flash and the dual RMSNorm inside each stage), 4 microbatches of [1,
     64] fp32 hidden states, held to the unstaged forward of the same 16
     layers in this process within ``TP_PIPE_TOL``. All ranks' tokens
     agree. Times over gloo go through the host: correctness runs, not
     speed.

Phase 8 runs between 6 and 7, while the tinyllama weights are loaded, and
phases 9 to 15 after 7. The second-to-last line is the kernels JSON (with
every path's metrics and each phase's seconds), the last line the device
JSON.

    python3 chip_smoke.py --norm-times

times only the dual RMSNorm at ``NORM_SHAPES`` through the ``repro_torch``
beside this script, and prints one JSON line: so a copy of this script in
another checkout times that checkout's kernel on the same card.

    python3 chip_smoke.py --decode-times

does the same for the four decode attention entries and flash at
tinyllama's and the other models' head shapes.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
BF16_TOL = 2e-2     # atol = rtol, as the JAX package's kernel tests
FP32_TOL = 2e-5
LOGIT_TOL = 2e-4    # prefill logits after the whole stack, fp32
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,      # dense bf16 tensor-core rate
            "float32": 67e12}        # fp32 outside the tensor cores

# Main-path shapes (tinyllama-1.1b, B=4 prompts of 128, cache of 256).
B, S, MAX_LEN, N_NEW = 4, 128, 256, 64
D, HKV, G, HD = 2048, 4, 8, 64
# Engine shapes: 8 decode slots, pages of 16 tokens, 16 pages per slot
# (max_len 256), 129 pages with the garbage page 0.
N_SLOTS, PS, N_PAGES = 8, 16, 129
N_PG = MAX_LEN // PS
ENGINE_NEW = 32
# Speculative engine: 4 drafts a verify (verify launch of 8 x 5 = 40 rows);
# degraded cohort: the top 2 of the 8 slots, at maximal pairing.
SPEC_K, DEG_SLOTS = 4, 2
MARGIN_FRAC = 0.01   # a divergence must sit at a top-2 margin <= 1% of scale
# Mamba path: falcon-mamba-7b, d_inner 8192, state 16, cut to its first 8
# of 64 layers under plan_for_depth(6): 2 pairs + 4 single layers (at all
# 64 layers, 48 groups, the phase took 78.9-107.7 s; the cuts to 32, 16
# and 8 layers paid for phases 12, 15 and 15 (d)-(e), PERF.md §4).
MAMBA = "falcon-mamba-7b"
MAMBA_LAYERS, MAMBA_EFF_DEPTH, DI, NS = 8, 6, 8192, 16
# Dual RMSNorm (D, M) on the paths: tinyllama decode (generate, engine) and
# prefill (generate's 4 x 128 and the engine's 8 x 64 bucket); falcon-mamba
# decode, an exact engine admission of 97 tokens, and generate's prefill.
# llama4-scout's decode (4 rows, 8 slots) and generate's prefill at D = 5120.
NORM_SHAPES = ((2048, 4), (2048, 8), (2048, 512),
               (4096, 4), (4096, 8), (4096, 97), (4096, 512),
               (5120, 4), (5120, 8), (5120, 512))
NORM_EPS = 1e-6
DENSE = ("yi-6b", "minicpm-2b", "granite-34b")
# Layers phase 9 keeps of each model (its first ones): yi-6b's 32, minicpm-2b's
# 40 and granite-34b's 88 are cut to 8, 6 and 7 (two LP pairs each, since
# phase 15 took whisper, paligemma and the seq cache; 12, 10 and 11 before),
# so that with phases 10 to 15 the script keeps room in its time limit
# (PERF.md §4).
DENSE_LAYERS = {"yi-6b": 8, "minicpm-2b": 6, "granite-34b": 7}
# Attention head shapes (kv heads, GQA group, hd) held in phase 3 beside
# tinyllama's: yi-6b's GQA, minicpm-2b's MHA, granite-34b's MQA and
# recurrentgemma-9b's local attention (16 query heads over 1 kv head at hd
# 256).
DENSE_SHAPES = (("yi-6b", 4, 8, 128), ("minicpm-2b", 36, 1, 64),
                ("granite-34b", 1, 48, 128), ("recurrentgemma-9b", 1, 16, 256))
# Hybrid path: recurrentgemma-9b (RG-LRU and local attention, window 2048)
# cut to its first 10 of 38 layers (3 periods and a trailing rec layer;
# every layer kind stays; 20 until phase 15 took (d) and (e)) under
# plan_for_depth(7): 3 rec pairs, 1 single rec layer, 3 single attn_local
# layers. Its window run takes a prompt of W + 256 tokens.
HYBRID = "recurrentgemma-9b"
HYBRID_LAYERS, HYBRID_EFF_DEPTH, WINDOW = 10, 7, 2048
WINDOW_PROMPT, WINDOW_NEW = WINDOW + 256, 16
WINDOW_TOL = 2e-3   # prefill + one decode step against the full forward, fp32
# MoE path (phase 11): dbrx-132b and llama4-scout cut to 4 layers (one
# iRoPE period of llama4) at their published widths (8 layers took phase 11
# to 77 s and the script past 600 s, PERF.md §4). generate under
# plan_for_depth: dbrx's pair (2, 3) after two single layers, llama4's
# pairs (0, 1), chunked + chunked, and (2, 3), chunked + global. llama4's
# engine pairs (0, 1) only (layers 2, chunked, and 3, global, single): the
# paged pool refuses a pair of mixed kinds. Its chunk run takes a prompt of
# CHUNK + 256 tokens.
DBRX, LLAMA4 = "dbrx-132b", "llama4-scout-17b-a16e"
MOE = (DBRX, LLAMA4)
MOE_LAYERS = 4
MOE_EFF_DEPTH = {DBRX: 3, LLAMA4: 2}
MOE_PAIRS = {DBRX: ((2, 3),), LLAMA4: ((0, 1), (2, 3))}
LLAMA4_ENGINE_PAIRS = ((0, 1),)
CHUNK = 8192
CHUNK_PROMPT, CHUNK_NEW = CHUNK + 256, 16
# Head shapes of the MoE models held in phase 3 (kv heads, GQA group, hd).
MOE_SHAPES = ((DBRX, 8, 6, 128), (LLAMA4, 8, 5, 128))
# Prefix-LM and encoder-decoder paths (phase 12), through generate only (the
# paged pool refuses both, as in the JAX package). paligemma-3b: 18 layers
# under plan_for_depth(14) (4 pairs, 10 single layers), 256 patch
# embeddings in front of prompts of 128, a ring cache of 512.
# whisper-medium: 24 encoder layers over 1500 frames, 24 decoder layers
# under plan_for_depth(18) (6 pairs, 12 single layers), prompts of 32, a
# ring cache of 128.
PALI, WHISPER = "paligemma-3b", "whisper-medium"
PALI_EFF_DEPTH, PALI_PREFIX, PALI_MAX_LEN = 14, 256, 512
WHISPER_EFF_DEPTH, WHISPER_PROMPT, WHISPER_MAX_LEN, ENC_SEQ = 18, 32, 128, 1500
# Their head shapes held in phase 3 (kv heads, GQA group, hd): paligemma's
# 8 query heads over 1 kv head at hd 256, whisper's 16 heads at hd 64.
# Their rank shapes at tp = 2 (phase 15 (d)): paligemma's 4 query heads
# over its replicated kv head, whisper's 8 heads a rank.
PREFIX_ENCDEC_SHAPES = ((PALI, 1, 8, 256), (WHISPER, 16, 1, 64),
                        (PALI + " tp2", 1, 4, 256), (WHISPER + " tp2", 8, 1, 64))
# Train path (phase 13): (a) tinyllama-1.1b cut to 2 layers (one LP pair) in
# fp32, B = 2 x S = 64, card against CPU: loss within 1e-4 (of ~10.4),
# each leaf's gradients within 1e-3 of that leaf's largest |g|, one AdamW
# step at lr 1e-3; (b) all 22 layers under plan_for_depth(16), LP-only
# fine-tuning in bf16, 8 steps of 8 x 256, then the eval step's loss
# (kernels) within 2e-3 of the differentiable forward's (bf16 activations,
# two attention and norm paths, a mean over 2048 tokens; sound runs on the
# H100 read 1.6e-4) and 16 new tokens through generate.
TRAIN_CUT_B, TRAIN_CUT_S, TRAIN_CUT_LR = 2, 64, 1e-3
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_NEW = 8, 256, 8, 16
TRAIN_EVAL_TOL = 2e-3
# Tools (phase 14): ``launch.serve``'s command line in this process at
# tinyllama-1.1b's published widths under plan_for_depth(16), one-shot and
# continuous (plain with the prefix cache and buckets, then speculative,
# then degraded), the one-card dry run of the 40 cells with its report, and
# the quickstart example.
SERVE_ARGV = ["--arch", "tinyllama-1.1b", "--full-config", "--eff-depth", "16",
              "--batch", "4", "--prompt-len", "128", "--new-tokens", "32"]
SERVE_REQUESTS = 16
# The speculative and degraded runs serve 8 requests of 16 new tokens
# (phase 8 holds both modes at 16 x 32 on this model). Decode steps probed
# per run: the continuous run takes 124 decode launches, the two shorter
# runs 30 (fewer verifies if drafts are accepted).
SERVE_MODE_REQUESTS, SERVE_MODE_NEW = 8, 16
SERVE_STEPS = {"continuous": (0, 100), "spec": (0, 16), "degraded": (0, 24)}
MEM_TOL = 0.05      # the dry run's weights + page pool against memory_allocated
# Phase 14 (d): the serve command at --mesh 1x2 over gloo, both ranks on the
# one card, one-shot (4 x 128) and continuous (8 requests), 8 new tokens,
# fp32 weights, each held to the same command at --mesh 1x1.
MESH_NEW, MESH_REQUESTS = 8, 8
MESH_ARGV = SERVE_ARGV[:SERVE_ARGV.index("--new-tokens")] + ["--new-tokens", str(MESH_NEW)]
MESH_RANKS = ["--mesh", "1x2", "--backend", "gloo"]
# Phase 14 (e): the dry run at the JAX package's production grids, one rank's
# step on meta tensors: yi-6b decode (4 kv heads under 16 ranks: the seq
# ring), dbrx-132b decode (FSDP gathers), tinyllama train (the ZeRO
# reduction, accum 4 / 2).
DRY_GRID_CELLS = (("yi-6b", "decode_32k"), ("dbrx-132b", "decode_32k"),
                  ("tinyllama-1.1b", "train_4k"))
DRY_GRIDS = {"16x16": ["--mesh", "16x16"], "mp": ["--multi-pod"]}
# Paged decode with a head map (phase 3): (model, q's kv heads H, g, hd,
# stored heads of the pool, {map name: head map}). tinyllama's rank shape at
# tp = 8 (4 q heads of one replicated kv head: g = 4, map [rank // 2]) and
# its 4 x 8 heads over a pool of 6; granite-34b's MQA width (g = 48, hd
# 128: the wide group and two-column-warp bodies) over a pool of 3.
HEAD_MAP_SHAPES = (
    ("tinyllama-1.1b", 1, 4, 64, 4, {"rank 5 of 8": [2]}),
    ("tinyllama-1.1b", 4, 8, 64, 6, {"identity": [0, 1, 2, 3],
                                     "permutation": [5, 3, 0, 1],
                                     "repeated": [4, 4, 1, 1]}),
    ("granite-34b", 2, 48, 128, 3, {"identity": [0, 1], "permutation": [2, 0],
                                    "repeated": [1, 1]}),
    # recurrentgemma-9b's rank shape at tp = 2: 8 q heads over its one
    # replicated kv head (g = 8, hd 256), over a pool of 1 stored head (its
    # own) and of 2 (reading the second)
    ("recurrentgemma-9b", 1, 8, 256, 1, {"rank map [0]": [0]}),
    ("recurrentgemma-9b", 1, 8, 256, 2, {"map [1]": [1]}))
# Tensor-parallel serving (phase 15): every rank a process on the one card,
# joined over gloo (NCCL refuses two ranks on one device). (a) tinyllama-1.1b
# cut to 11 of its 22 layers (since phase 15 took (c); 22 until then) under
# plan_for_depth(8) at tp = 2 (kv heads split):
# sharded_generate (4 x 128, 10 new: 16 until (f) came, 32 until (d)) and
# the engine on half of phase 6's traffic (``tp_traffic``: 4 requests of
# each wave, 10 new; the probes read decode step 8, so 10 is the least);
# (b) cut to 4
# layers under plan_for_depth(3) (one pair, two single layers) at tp = 8 (4
# kv heads under 8 ranks: replicated, head map [rank // 2]), the same with 8
# new tokens. A decode step costs 0.1-0.2 s over gloo (20 all-reduces
# through the host at tp = 2), so the runs are short. (c) the recurrent and
# MoE families at tp = 2, served by (a)'s rank processes after tinyllama, at
# their published widths cut to a few layers: arch -> (layers kept,
# generate's LP pairs, the engine's LP pairs); sharded_generate (4 x 128)
# and the engine on ``tp_traffic``, 10 new tokens (16 until (f) came). llama4's generate pair
# (2, 3) is chunked + global, which the pool refuses: its engine runs under
# (0, 1) on weights made anew. (d) the encoder-decoder and the prefix-LM at
# tp = 2 in (a)'s ranks after (c), through sharded_generate only (the pool
# refuses both): whisper-medium cut to 2 encoder + 2 decoder layers, frames
# [4, 1500, 1024] and prompts 4 x 32 (cache 128); paligemma-3b cut to 2
# layers, a prefix of 256 before prompts 4 x 128 (cache 512), once at
# kv_mode "heads" and once at "seq" (its one kv head, replicated, cut along
# the sequence); decoder pair (0, 1), 10 new tokens (16 until (f) came):
# arch -> (decoder layers, kv modes). (e) in (b)'s ranks: tinyllama's sharded_generate at
# kv_mode "seq" (4 kv heads under 8 ranks). (b) and (e) take 8 new tokens
# (16 until (e) came): a step over gloo at tp = 8 takes 0.2-0.5 s.
TP_BACKEND, TP_TIMEOUT = "gloo", 420
TP2, TP2_LAYERS, TP2_EFF_DEPTH, TP2_NEW = 2, 11, 8, 10
TP8, TP8_LAYERS, TP8_EFF_DEPTH, TP8_NEW = 8, 4, 3, 8
TP_FAMILIES = {MAMBA: (4, ((0, 1),), ((0, 1),)),
               HYBRID: (3, ((0, 1),), ((0, 1),)),
               DBRX: (3, ((1, 2),), ((1, 2),)),
               LLAMA4: (4, ((0, 1), (2, 3)), ((0, 1),))}
TP_FAMILY_NEW = 10
TP_ENCDEC = {WHISPER: (2, ("heads",)), PALI: (2, ("heads", "seq"))}
TP_ENCDEC_NEW = 10
# (f) in (b)'s ranks after (e): the sharded trainer on the (pod, data, model)
# grid TP_TRAIN_GRID over the 8 ranks, tinyllama-1.1b at its published widths
# cut to TP_TRAIN_LAYERS layers (LP pair (0, 1)), fp32 weights (TF32 off),
# a global batch of TP_TRAIN_B x TP_TRAIN_S from data/synthetic per step,
# TP_TRAIN_STEPS steps in each mode, then one eval step; held to tp = 1 in
# the parent (TP_TRAIN_TOL, relative), compression to TP_TRAIN_COMPRESS_TOL
# of the uncompressed loss after the last step and its first step's
# grad_norm to TP_TRAIN_COMPRESS_NORM_TOL of tp = 1's, the eval to TP_TRAIN_EVAL_TOL of the train
# forward. Over gloo: a correctness run, not a speed.
TP_TRAIN_GRID, TP_TRAIN_LAYERS, TP_TRAIN_PAIRS = (2, 2, 2), 2, ((0, 1),)
TP_TRAIN_B, TP_TRAIN_S, TP_TRAIN_STEPS = 8, 128, 2
TP_TRAIN_OPT = dict(lr=3e-3, warmup_steps=2, total_steps=40)
TP_TRAIN_MODES = {"zero": {}, "fsdp": {"fsdp": True}, "compress": {"compress_pod": True}}
TP_TRAIN_TOL, TP_TRAIN_COMPRESS_TOL, TP_TRAIN_EVAL_TOL = 1e-4, 5e-2, 2e-3
# the compressed run's step-1 grad_norm against tp = 1's, relative: read
# 6.15905 against 6.15770 (2.2e-4) on an H100 80GB HBM3 at 700 W
TP_TRAIN_COMPRESS_NORM_TOL = 2e-3
# (g) in (b)'s ranks after (f): FSDP serving on the same grid. tinyllama-1.1b
# at its published widths cut to TP_FSDP_LAYERS layers (pair (0, 1) and a
# single layer, so both ring decode forms launch), fsdp_data = 2: bf16 and
# int8 shards through sharded_generate (TP_FSDP_B x TP_FSDP_S, TP_FSDP_NEW
# new, a ring of TP_FSDP_MAX_LEN), the bf16 shards through PagedEngine on
# the same prompts twice. Every forward gathers a group's weights through
# gloo (about 130 MB a rank in bf16), so the runs are short; the MoE models'
# FSDP serving is held on the CPU (tests/test_torch_fsdp_serve.py).
TP_FSDP_LAYERS, TP_FSDP_PAIRS = 3, ((0, 1),)
TP_FSDP_B, TP_FSDP_S, TP_FSDP_NEW, TP_FSDP_MAX_LEN = 2, 32, 4, 64
# The wrappers whose first launch at each shape (g) and (h) hold against
# their plain versions, beside (g)'s ring and paged decode launches.
TP_FSDP_SHAPES = ("flash_attention", "dual_rmsnorm")
# (h) after (g): GPipe stages over the 8 ranks, tinyllama-1.1b at its
# published widths, TP_PIPE_LAYERS layers in LP pairs, one pair a stage,
# TP_PIPE_MICRO microbatches of [1, TP_PIPE_S] fp32 hidden states; held to
# the unstaged forward within TP_PIPE_TOL (fp32, TF32 off).
TP_PIPE_LAYERS, TP_PIPE_MICRO, TP_PIPE_S, TP_PIPE_TOL = 16, 4, 64, 2e-5
TP_PIPE_REF = ROOT / "build" / "tp" / "pipe_ref.pt"   # the unstaged output
TP_NCCL_NOT_RUN = [
    "init_context(backend='nccl'): one card per rank, every all_reduce of the "
    "tp = 2 and tp = 8 paths and of the four families' tp = 2 paths (Mamba's "
    "x_proj sum, the MoE and RG-LRU phase exits) over NCCL (one card here, and "
    "NCCL refuses two ranks on one device)",
    "the encoder's and the cross-attention's phase sums of whisper-medium, and "
    "the sequence-sharded cache's all_gather_tp (an all_reduce of zero-padded "
    "blocks), max and packed sum of paligemma-3b and tinyllama over NCCL",
    "the sharded trainer's collectives (the sequence-parallel gathers and "
    "scatters with their backwards, the dp sum-and-scatters and gathers, FSDP's "
    "data gathers, the int8 pod sums) over NCCL, and a grid of one card per rank",
    "FSDP serving's per-group data gathers (bf16 and int8 shards) and the "
    "pipeline's hops and final sum over NCCL"]


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, iters=20, reps=10):
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events, so the host's launch cost
    is left out."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def call_ms(fn, iters=50):
    """Time of one call issued back to back from Python: the host's launch
    cost included, as the eager main path pays it."""
    import torch
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, dtype_name, *, flops_peak=None):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (flops_peak or PEAK_OPS[dtype_name]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def compare(name, got, want, tol):
    import torch
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
    log(f"  {name}: max_abs_err={err:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err:.3e}, tol {tol:g})")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    rows = {}

    def record(name, dtype, err, fn, plain, nb, fl, library=None, flops_peak=None):
        entry = rows.setdefault((name, dtype), {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if fn is None:
            return
        b_ms, b_by = bound(nb, fl, str(dtype).split(".")[1], flops_peak=flops_peak)
        entry.update(ms=time_ms(fn), plain_ms=time_ms(plain), bound_ms=b_ms,
                     bound_by=b_by, library_ms=time_ms(library) if library else None,
                     call_ms=call_ms(fn))
        log(f"  {name} {dtype}: ms={entry['ms']:.5f} plain_ms={entry['plain_ms']:.5f} "
            f"bound_ms={b_ms:.6f} ({b_by}) library_ms="
            f"{entry['library_ms']} call_ms={entry['call_ms']:.5f}")

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        log(f"[kernels] dual_rmsnorm {dtype}")
        for M in (B * S, B):   # prefill rows, decode rows
            x = rand(M, D, dtype=dtype)
            sa, sb = rand(D, dtype=dtype), rand(D, dtype=dtype)
            for plus_one in (False, True):
                ya, yb = ops.dual_rmsnorm(x, sa, sb, plus_one=plus_one)
                ra, rb = ops.dual_rmsnorm_plain(x, sa, sb, plus_one=plus_one)
                err = max(compare(f"dual_rmsnorm M={M} plus_one={plus_one} a", ya, ra, tol),
                          compare(f"dual_rmsnorm M={M} plus_one={plus_one} b", yb, rb, tol))
                timed = (M == B and not plus_one)   # the decode shape: most launches
                if M == B * S and not plus_one:   # the prefill shape: 12 launches
                    b_ms, b_by = bound(nbytes(x, sa, sb) + 2 * nbytes(x), 6 * M * D,
                                       "float32")
                    log(f"  dual_rmsnorm M={M}: ms={time_ms(lambda: ops.dual_rmsnorm(x, sa, sb)):.5f} "
                        f"plain_ms={time_ms(lambda: ops.dual_rmsnorm_plain(x, sa, sb)):.5f} "
                        f"bound_ms={b_ms:.6f} ({b_by})")
                record("dual_rmsnorm", dtype, err,
                       (lambda: ops.dual_rmsnorm(x, sa, sb)) if timed else None,
                       lambda: ops.dual_rmsnorm_plain(x, sa, sb),
                       nbytes(x, sa, sb) + 2 * nbytes(x), 6 * M * D,
                       library=two_rms_norms(x, sa, sb) if timed else None,
                       flops_peak=PEAK_OPS["float32"])
        check_norm_rows(ops, rand, dtype)
        if dtype == torch.bfloat16:
            from repro_torch.kernels import dual_rmsnorm as K
            device = torch.device(dev, torch.cuda.current_device())
            for pdl, key in ((False, "launch_floor_ms"), (True, "launch_floor_pdl_ms")):
                rows[key] = time_ms(lambda: K.noop(device, pdl=pdl))
            log(f"  launch floor (empty one-block kernel, graph replay): "
                f"ms={rows['launch_floor_ms']:.5f}; launched as the dual RMSNorm "
                f"(PDL): ms={rows['launch_floor_pdl_ms']:.5f}")
            rows["dual_rmsnorm_shapes"] = norm_times(
                ops, lambda pdl: K.noop(device, pdl=pdl))

        log(f"[kernels] decode attention {dtype}")
        k1, v1 = rand(B, MAX_LEN, HKV, HD, dtype=dtype), rand(B, MAX_LEN, HKV, HD, dtype=dtype)
        q1 = rand(B, HKV, G, HD, dtype=dtype)
        k2, v2 = rand(2, B, MAX_LEN, HKV, HD, dtype=dtype), rand(2, B, MAX_LEN, HKV, HD, dtype=dtype)
        q2 = rand(B, 2, HKV, G, HD, dtype=dtype).transpose(0, 1)   # strided, as on the path
        for t in (0, 63, 100, 160, MAX_LEN - 1):
            timed = t == 160
            err = compare(f"decode_attention t={t}", ops.decode_attention(q1, k1, v1, t),
                          ops.decode_attention_plain(q1, k1, v1, t), tol)
            n = t + 1
            lib = None
            if timed:
                ql = q1.reshape(B, HKV * G, 1, HD)
                kl, vl = k1[:, :n].transpose(1, 2), v1[:, :n].transpose(1, 2)
                lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, enable_gqa=True)
            record("decode_attention", dtype, err,
                   (lambda: ops.decode_attention(q1, k1, v1, t)) if timed else None,
                   lambda: ops.decode_attention_plain(q1, k1, v1, t),
                   2 * nbytes(q1) + 2 * B * n * HKV * HD * k1.element_size(),
                   4 * B * HKV * G * n * HD, library=lib)
            err = compare(f"decode_attention_pair t={t}", ops.decode_attention_pair(q2, k2, v2, t),
                          ops.decode_attention_pair_plain(q2, k2, v2, t), tol)
            if timed:
                ql2 = q2.reshape(2 * B, HKV * G, 1, HD)
                kl2 = k2.reshape(2 * B, MAX_LEN, HKV, HD)[:, :n].transpose(1, 2)
                vl2 = v2.reshape(2 * B, MAX_LEN, HKV, HD)[:, :n].transpose(1, 2)
                lib = lambda: F.scaled_dot_product_attention(ql2, kl2, vl2, enable_gqa=True)
            record("decode_attention_pair", dtype, err,
                   (lambda: ops.decode_attention_pair(q2, k2, v2, t)) if timed else None,
                   lambda: ops.decode_attention_pair_plain(q2, k2, v2, t),
                   2 * nbytes(q2) + 2 * 2 * B * n * HKV * HD * k2.element_size(),
                   4 * 2 * B * HKV * G * n * HD, library=lib)

        log(f"[kernels] flash attention {dtype}")
        for H in (2 * HKV, HKV):   # LP pair layer (heads folded), single layer
            q = rand(B, S, H, G, HD, dtype=dtype)
            k, v = rand(B, S, H, HD, dtype=dtype), rand(B, S, H, HD, dtype=dtype)
            err = compare(f"flash causal H={H}", ops.flash_attention(q, k, v, block_n=16),
                          ops.flash_attention_plain(q, k, v), tol)
            timed = H == 2 * HKV
            ql = q.permute(0, 2, 3, 1, 4).reshape(B, H * G, S, HD)
            kl, vl = k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous()
            lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                         enable_gqa=True)
            pairs = B * H * G * S * (S + 1) // 2   # allowed (query, key) pairs
            if not timed:   # the single-layer shape: 10 of the 16 launches
                b_ms, b_by = bound(2 * nbytes(q) + nbytes(k, v), 4 * HD * pairs,
                                   str(dtype).split(".")[1])
                log(f"  flash causal H={H}: ms={time_ms(lambda: ops.flash_attention(q, k, v, block_n=16)):.5f} "
                    f"plain_ms={time_ms(lambda: ops.flash_attention_plain(q, k, v)):.5f} "
                    f"bound_ms={b_ms:.6f} ({b_by}) library_ms={time_ms(lib):.5f}")
            record("flash_attention", dtype, err,
                   (lambda: ops.flash_attention(q, k, v, block_n=16)) if timed else None,
                   lambda: ops.flash_attention_plain(q, k, v),
                   2 * nbytes(q) + nbytes(k, v), 4 * HD * pairs,
                   library=lib if timed else None)
            if timed:
                check_flash_padding(ops, q, k, v, rand)
        # every other mask kind, offsets and ragged edges, at a small size
        for kw, s_len, t_len, hd, g, bn in (
                (dict(kind="window", window=7), 40, 40, 64, 2, 16),
                (dict(kind="chunk", chunk=16), 37, 37, 32, 4, 16),
                (dict(kind="causal", prefix_len=5), 40, 40, 16, 1, 64),
                (dict(kind="bidir"), 24, 40, 64, 3, 16),
                (dict(kind="causal", q0=16), 24, 40, 64, 8, 16),
                (dict(kind="causal", q0=20, k0=4), 24, 40, 128, 2, 32)):
            q = rand(2, s_len, 2, g, hd, dtype=dtype)
            k, v = rand(2, t_len, 2, hd, dtype=dtype), rand(2, t_len, 2, hd, dtype=dtype)
            err = compare(f"flash {kw} S={s_len} T={t_len} hd={hd} g={g} block_n={bn}",
                          ops.flash_attention(q, k, v, block_n=bn, **kw),
                          ops.flash_attention_plain(q, k, v, **kw), tol)
            record("flash_attention", dtype, err, None, None, 0, 0)

        log(f"[kernels] flash attention, per-row q0 {dtype}")
        # A bucketed radix-suffix prefill: 8 rows of a 64-token bucket after
        # 4 context pages; cold rows start at 0, hit rows at their ctx.
        Sb, Tc = 64, 4 * PS
        for H in (2 * HKV, HKV):
            q = rand(N_SLOTS, Sb, H, G, HD, dtype=dtype)
            k, v = (rand(N_SLOTS, Tc + Sb, H, HD, dtype=dtype) for _ in range(2))
            q0 = torch.tensor([0, 64, 32, 0, 48, 16, 64, 0], dtype=torch.int32,
                              device=dev)
            err = compare(f"flash q0 rows H={H}",
                          ops.flash_attention(q, k, v, q0=q0, block_n=16),
                          ops.flash_attention_plain(q, k, v, q0=q0), tol)
            record("flash_attention", dtype, err, None, None, 0, 0)
            same = torch.full((N_SLOTS,), 32, dtype=torch.int32, device=dev)
            if not torch.equal(ops.flash_attention(q, k, v, q0=same, block_n=16),
                               ops.flash_attention(q, k, v, q0=32, block_n=16)):
                raise AssertionError("flash with equal per-row q0 differs from "
                                     "the scalar launch")
            log(f"  flash q0 rows H={H}: equal entries == scalar q0, bit for bit")
            if H == 2 * HKV:   # the pair layer's bucket launch, timed
                qpos = q0[:, None] + torch.arange(Sb, device=dev)          # [8, Sb]
                mask = (torch.arange(Tc + Sb, device=dev)[None, None, :]
                        <= qpos[:, :, None])[:, None]                     # [8, 1, Sb, T]
                ql = q.permute(0, 2, 3, 1, 4).reshape(N_SLOTS, H * G, Sb, HD)
                kl, vl = (x.permute(0, 2, 1, 3).contiguous() for x in (k, v))
                lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                                             enable_gqa=True)
                compare(f"flash q0 rows H={H} against SDPA with a boolean mask",
                        ops.flash_attention(q, k, v, q0=q0, block_n=16),
                        lib().reshape(N_SLOTS, H, G, Sb, HD).permute(0, 3, 1, 2, 4), tol)
                pairs = int((qpos + 1).sum()) * H * G   # allowed (query, key) pairs
                b_ms, b_by = bound(2 * nbytes(q) + nbytes(k, v), 4 * HD * pairs,
                                   str(dtype).split(".")[1])
                rows[("flash_attention_bucket", dtype)] = entry = {
                    "shape": f"8 rows x {Sb}-token bucket after {Tc} context keys, "
                             f"per-row q0, {H} kv heads, g={G}, hd={HD}",
                    "ms": time_ms(lambda: ops.flash_attention(q, k, v, q0=q0, block_n=16)),
                    "plain_ms": time_ms(lambda: ops.flash_attention_plain(q, k, v, q0=q0)),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(lib)}
                log(f"  flash engine bucket H={H} {dtype}: ms={entry['ms']:.5f} "
                    f"plain_ms={entry['plain_ms']:.5f} bound_ms={b_ms:.6f} ({b_by}) "
                    f"library_ms={entry['library_ms']:.5f} (SDPA, boolean mask)")

        log(f"[kernels] paged decode attention {dtype}")
        # The engine's decode: 8 slots of 16 pages, ragged horizons, slot 1
        # idle (all-garbage block table, t = 0).
        qp, kr, vr, kp, vp, bt, tv = engine_decode_inputs(rand, gen, dtype, HKV, G, HD)
        pair = ops.decode_attention_pair_paged(qp, kp, vp, bt, tv)
        err = compare("decode_attention_pair_paged", pair,
                      ops.decode_attention_pair_paged_plain(qp, kp, vp, bt, tv), tol)
        single = ops.decode_attention_paged(qp[0], kp[0], vp[0], bt, tv)
        err1 = compare("decode_attention_paged", single,
                       ops.decode_attention_paged_plain(qp[0], kp[0], vp[0], bt, tv), tol)
        for b in range(N_SLOTS):
            if b == 1:
                continue
            ring = ops.decode_attention_pair(qp[:, b:b + 1], kr[:, b:b + 1],
                                             vr[:, b:b + 1], int(tv[b]))
            if not torch.equal(pair[:, b:b + 1], ring):
                raise AssertionError(f"paged decode differs from the ring kernel "
                                     f"on a paginated cache (slot {b})")
        log("  paged == ring kernel on the paginated cache, bit for bit (7 slots)")
        check_decode_batch_invariance(ops, qp, kp, vp, bt, tv)
        keys = int((tv + 1).sum())               # keys 0..t[b] of each row
        kv_bytes = 2 * keys * HKV * HD * kp.element_size()
        record("decode_attention_pair_paged", dtype, err,
               lambda: ops.decode_attention_pair_paged(qp, kp, vp, bt, tv),
               lambda: ops.decode_attention_pair_paged_plain(qp, kp, vp, bt, tv),
               2 * nbytes(qp) + 2 * kv_bytes + nbytes(bt, tv),
               2 * 4 * keys * HKV * G * HD)
        record("decode_attention_paged", dtype, err1,
               lambda: ops.decode_attention_paged(qp[0], kp[0], vp[0], bt, tv),
               lambda: ops.decode_attention_paged_plain(qp[0], kp[0], vp[0], bt, tv),
               2 * nbytes(qp[0]) + kv_bytes + nbytes(bt, tv),
               4 * keys * HKV * G * HD)
        for name, e in check_verify_shape(ops, rand, kp, vp, bt, tv, tol,
                                          rows["launch_floor_ms"]).items():
            rows[("verify", name, dtype)] = e
            record(name, dtype, e["max_abs_err"], None, None, 0, 0)
        del kr, vr, qp, kp, vp
        log(f"[kernels] paged decode attention with a head map {dtype}")
        for (name, key), e in check_head_map(ops, rand, gen, dtype, tol).items():
            rows[("head_map", name, key, dtype)] = e
            record(name, dtype, e["max_abs_err"], None, None, 0, 0)

        for model, hkv, g, hd in DENSE_SHAPES + MOE_SHAPES + PREFIX_ENCDEC_SHAPES:
            log(f"[kernels] attention at {model}'s shape (Hkv={hkv}, g={g}, hd={hd}) {dtype}")
            found = check_dense_shape(ops, rand, gen, dtype, hkv, g, hd, tol)
            if model.split()[0] in (PALI, WHISPER):
                found.update(check_prefix_encdec_flash(ops, rand, dtype, tol, model,
                                                       hkv, g))
            if model == HYBRID:
                found.update(check_masked_flash(ops, rand, dtype, hkv, g, hd, tol,
                                                "window", WINDOW, WINDOW_PROMPT))
            if model == LLAMA4:
                found.update(check_masked_flash(ops, rand, dtype, hkv, g, hd, tol,
                                                "chunk", CHUNK, CHUNK_PROMPT))
            for (name, key), e in found.items():
                record(name, dtype, e["max_abs_err"], None, None, 0, 0)
                rows[("dense", name, key, model, dtype)] = e
        torch.cuda.empty_cache()

        log(f"[kernels] ssm_scan {dtype}")
        # generate's pair and single-layer prefill, one engine admission of
        # 97 tokens, RG-LRU's width (N = 1), and phase 15's rank widths at
        # tp = 2: a Mamba pair's d_inner / 2 and an RG-LRU pair's
        # lru_width / 2.
        for what, (R, Ss, C, N) in (("pair", (2 * B, S, DI, NS)),
                                     ("single", (B, S, DI, NS)),
                                     ("engine", (1, 97, DI, NS)),
                                     ("rglru", (4, 128, 4096, 1)),
                                     ("tp2 mamba pair", (2 * B, S, DI // 2, NS)),
                                     ("tp2 rglru pair", (2 * B, S, 4096 // 2, 1))):
            a = (0.5 + 0.5 * torch.rand((R, Ss, C, N), generator=gen, device=dev)).to(dtype)
            bb = rand(R, Ss, C, N, dtype=dtype)
            h0 = rand(R, C, N, dtype=torch.float32)
            y, h = ops.ssm_scan(a, bb, h0)
            ry, rh = ops.ssm_scan_plain(a, bb, h0)
            err = max(compare(f"ssm_scan {what} {list(a.shape)} y", y, ry, tol),
                      compare(f"ssm_scan {what} h_S", h, rh, tol))
            if dtype == torch.float32:
                if not (torch.equal(y, ry) and torch.equal(h, rh)):
                    raise AssertionError(f"ssm_scan {what}: fp32 kernel differs from "
                                         "its plain version")
                y1, h1 = ops.ssm_scan(a[:, :64].contiguous(), bb[:, :64].contiguous(), h0)
                y2, h2 = ops.ssm_scan(a[:, 64:].contiguous(), bb[:, 64:].contiguous(), h1)
                if not (torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)):
                    raise AssertionError(f"ssm_scan {what}: two calls split at s = 64 "
                                         "differ from one call")
                log(f"  ssm_scan {what}: == plain bit for bit; split at s = 64 == one call")
            del y, h, ry, rh
            # bytes: a, b and y once each, h0 and h_S; 2 flops per element-step
            nb, fl = 3 * nbytes(a) + 2 * nbytes(h0), 2 * a.numel()
            if what == "pair":
                record("ssm_scan", dtype, err, lambda: ops.ssm_scan(a, bb, h0),
                       lambda: ops.ssm_scan_plain(a, bb, h0), nb, fl,
                       flops_peak=PEAK_OPS["float32"])
            else:
                b_ms, b_by = bound(nb, fl, "float32")
                e = {"shape": list(a.shape), "max_abs_err": err,
                     "ms": time_ms(lambda: ops.ssm_scan(a, bb, h0)),
                     "plain_ms": time_ms(lambda: ops.ssm_scan_plain(a, bb, h0)),
                     "bound_ms": b_ms, "bound_by": b_by}
                rows[("ssm_shape", what, dtype)] = e
                log(f"  ssm_scan {what}: ms={e['ms']:.5f} plain_ms={e['plain_ms']:.5f} "
                    f"bound_ms={b_ms:.6f} ({b_by})")
                record("ssm_scan", dtype, err, None, None, 0, 0)
            del a, bb, h0
        torch.cuda.empty_cache()
    return rows


def two_rms_norms(x, sa, sb):
    """The dual RMSNorm's yardstick: ``F.rms_norm`` once per path. No single
    PyTorch call computes both norms; the port never calls this."""
    import torch.nn.functional as F
    return lambda: (F.rms_norm(x, (x.shape[-1],), sa, NORM_EPS),
                    F.rms_norm(x, (x.shape[-1],), sb, NORM_EPS))


def norm_times(ops, noop=None):
    """The dual RMSNorm at every ``NORM_SHAPES`` entry: held against its
    plain version in fp32 and bf16, and timed in bf16 beside it and two
    ``F.rms_norm`` calls: back to back (``time_ms``), and between the path's
    neighbours (``between_ms``: a residual add before it and a GEMM of the
    pair's ``[2, D, D]`` shape after it in one graph, less the time of the
    add and the GEMM alone). With ``noop(pdl)``, the empty kernel is timed
    between the same neighbours, launched plainly and as the dual RMSNorm
    is (programmatic dependent launch): the floors of the two launches."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    out = []
    for d, m in NORM_SHAPES:
        errs = {}
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            x, sa, sb = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                         for shape in ((m, d), (d,), (d,)))
            got, want = ops.dual_rmsnorm(x, sa, sb), ops.dual_rmsnorm_plain(x, sa, sb)
            errs[dtype] = max(compare(f"dual_rmsnorm {str(dtype)[6:]} D={d} M={m} {half}",
                                      got[i], want[i], tol) for i, half in enumerate("ab"))
        b_ms, b_by = bound(nbytes(x, sa, sb) + 2 * nbytes(x), 6 * m * d, "float32")
        e = {"D": d, "M": m, "max_abs_err": errs[torch.bfloat16],
             "fp32_max_abs_err": errs[torch.float32],
             "ms": time_ms(lambda: ops.dual_rmsnorm(x, sa, sb)),
             "plain_ms": time_ms(lambda: ops.dual_rmsnorm_plain(x, sa, sb)),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": time_ms(two_rms_norms(x, sa, sb))}
        h = torch.randn((m, d), generator=gen, device="cuda").to(x.dtype)
        w = torch.randn((2, d, d), generator=gen, device="cuda").to(x.dtype)
        y0 = torch.empty((2, m, d), dtype=x.dtype, device="cuda")

        def least(fn):   # the GEMM's time spreads by tenths of a microsecond
            return min(time_ms(fn) for _ in range(3))

        base = least(lambda: (x + h, torch.matmul(y0, w)))

        def between(fn):
            return least(lambda: torch.matmul(fn(x + h), w)) - base

        e["between_ms"] = between(lambda r: ops.dual_rmsnorm(r, sa, sb))
        if noop is not None:
            e["floor_between_ms"] = between(lambda r: (noop(False), y0)[1])
            e["floor_pdl_between_ms"] = between(lambda r: (noop(True), y0)[1])
        log(f"  dual_rmsnorm bf16 D={d} M={m}: " + " ".join(
            f"{k}={v:.5f}" for k, v in e.items() if k.endswith("ms")) + f" ({b_by})")
        out.append(e)
    return out


def check_norm_rows(ops, rand, dtype):
    """Each dual RMSNorm row equals, bit for bit, the same row launched
    alone (M = 1), inside an 8-row launch and at three offsets of a
    2048-row launch (8 rows x a 256-token bucket), plus_one both ways: at
    D = 2048, 4096 and 5120 (8 warps x 3 vectors, the last round ragged),
    and at D = 100, where the scales are the two rows of
    a [2, D] pair as the model slices them (in bf16 the second starts 200
    bytes in: element-wise loads), also held against the plain version. A
    16-byte-misaligned sb gives the bits of an aligned copy."""
    import torch
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    offsets = (0, 1001, 2040)
    for d in (2048, 4096, 5120, 100):
        scales = rand(2, d, dtype=dtype)
        sa, sb = scales[0], scales[1]
        x8, big = rand(8, d, dtype=dtype), rand(2048, d, dtype=dtype)
        for o in offsets:
            big[o:o + 8] = x8
        for plus_one in (False, True):
            y8 = ops.dual_rmsnorm(x8, sa, sb, plus_one=plus_one)
            want = ops.dual_rmsnorm_plain(x8, sa, sb, plus_one=plus_one)
            compare(f"dual_rmsnorm D={d} M=8 plus_one={plus_one}", y8, want, tol)
            wide = ops.dual_rmsnorm(big, sa, sb, plus_one=plus_one)
            for i in range(8):
                alone = ops.dual_rmsnorm(x8[i:i + 1], sa, sb, plus_one=plus_one)
                if not torch.equal(alone, y8[:, i:i + 1]):
                    raise AssertionError(f"dual_rmsnorm {dtype} D={d}: row {i} alone "
                                         f"differs from the 8-row launch")
            for o in offsets:
                if not torch.equal(wide[:, o:o + 8], y8):
                    raise AssertionError(f"dual_rmsnorm {dtype} D={d}: rows at {o} of "
                                         f"a 2048-row launch differ from the 8-row launch")
    d = 2048
    x8, sa = rand(8, d, dtype=dtype), rand(d, dtype=dtype)
    sb = rand(d + 1, dtype=dtype)[1:]        # 2 or 4 bytes past a 16-byte line
    if not torch.equal(ops.dual_rmsnorm(x8, sa, sb), ops.dual_rmsnorm(x8, sa, sb.clone())):
        raise AssertionError(f"dual_rmsnorm {dtype}: a misaligned sb changes the bits")
    log(f"  dual_rmsnorm rows {dtype}: alone == in 8 rows == at {offsets} of 2048 rows, "
        f"bit for bit (D = 2048, 4096, 5120, 100; plus_one both ways); misaligned sb == "
        f"aligned copy")


def check_flash_padding(ops, q, k, v, rand):
    """Right-padding is bit-transparent (causal, block_n = 16): the rows
    below Lq of the S = 128 launch equal the launch cut to Lq, bit for bit,
    also when the keys and values at and past Lq hold large finite junk."""
    import torch
    full = ops.flash_attention(q, k, v, block_n=16)
    for lq in (37, 64, 100):
        cut = ops.flash_attention(q[:, :lq], k[:, :lq], v[:, :lq], block_n=16)
        kj, vj = k.clone(), v.clone()
        kj[:, lq:] = 1e4 * rand(*kj[:, lq:].shape, dtype=k.dtype)
        vj[:, lq:] = 1e4 * rand(*vj[:, lq:].shape, dtype=v.dtype)
        junk = ops.flash_attention(q, kj, vj, block_n=16)[:, :lq]
        if not (torch.equal(cut, full[:, :lq]) and torch.equal(cut, junk)):
            raise AssertionError(f"flash {q.dtype}: rows below Lq={lq} depend on "
                                 f"the keys past Lq")
    log(f"  flash padding {q.dtype}: rows below Lq in (37, 64, 100) == launch "
        f"cut to Lq, with and without junk past Lq, bit for bit")


def check_verify_shape(ops, rand, kp, vp, bt, tv, tol, floor_ms):
    """Both paged decode kernels at the speculative verify's shape (k = 4):
    8 slots x 5 probe rows = 40 rows; row j of slot s reads the slot's
    block table up to t[s] + j (slot 1 idle: garbage table, t = 0). Each
    held against its plain version and timed beside the launch floor, the
    bytes bound (each slot's keys read once) and the plain version.
    Returns {kernel name: entry}."""
    import torch
    probes = SPEC_K + 1
    dev = kp.device
    bt_v = bt.repeat_interleave(probes, 0)
    t_v = (tv.repeat_interleave(probes)
           + torch.arange(probes, device=dev).repeat(N_SLOTS)).clamp(max=MAX_LEN - 1)
    t_v[probes:2 * probes] = 0
    t_v = t_v.to(torch.int32)
    qv = rand(N_SLOTS * probes, 2, HKV, G, HD, dtype=kp.dtype).transpose(0, 1)
    keys_read = int((t_v.reshape(N_SLOTS, probes).max(1).values + 1).sum())
    keys_rows = int((t_v + 1).sum())
    kv_bytes = 2 * keys_read * HKV * HD * kp.element_size()
    out = {}
    for name, n_kv, q, k, v in (("decode_attention_pair_paged", 2, qv, kp, vp),
                                ("decode_attention_paged", 1, qv[0], kp[0], vp[0])):
        run = lambda: getattr(ops, name)(q, k, v, bt_v, t_v)   # noqa: E731
        plain = lambda: getattr(ops, name + "_plain")(q, k, v, bt_v, t_v)  # noqa: E731
        err = compare(f"{name} verify {N_SLOTS * probes} rows", run(), plain(), tol)
        nb = 2 * nbytes(q) + n_kv * kv_bytes + nbytes(bt_v, t_v)
        b_ms, b_by = bound(nb, n_kv * 4 * keys_rows * HKV * G * HD,
                           str(kp.dtype).split(".")[1])
        out[name] = e = {
            "shape": f"{N_SLOTS} slots x {probes} probe rows, ragged t, Hkv={HKV}, "
                     f"g={G}, hd={HD}",
            "max_abs_err": err, "ms": time_ms(run), "floor_ms": floor_ms,
            "bound_ms": b_ms, "bound_by": b_by, "plain_ms": time_ms(plain)}
        log(f"  {name} verify {kp.dtype}: ms={e['ms']:.5f} floor_ms={floor_ms:.5f} "
            f"bound_ms={b_ms:.6f} ({b_by}) plain_ms={e['plain_ms']:.5f}")
    return out


def check_dense_shape(ops, rand, gen, dtype, hkv, g, hd, tol):
    """The attention kernels at a dense model's head shape: the four decode
    entries (ring at generate's B = 4 and horizons that walk 1 to 4 chunks
    of 64 keys; paged at the engine's 8 slots, ragged t, slot 1 idle) and
    flash at generate's prefill (B = 4 prompts of 128, pair and single
    layer), each against its plain version. Paged == ring bit for bit on a
    paginated cache; at granite's MQA (g > 16) the paged rows are also
    batch-invariant. Each timed beside its bound, its plain version and
    SDPA where one call computes the same function. Returns {(kernel name,
    "ring" | "paged" | "prefill"): entry}."""
    import torch
    import torch.nn.functional as F
    dt = str(dtype).split(".")[1]
    out = {}

    def entry(name, key, err, fn, plain, nb, fl, library=None, shape=""):
        b_ms, b_by = bound(nb, fl, dt)
        e = out.setdefault((name, key), {"max_abs_err": 0.0, "shape": shape})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        if fn is not None:
            e.update(ms=time_ms(fn), plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(library) if library else None)
            log(f"  {name} {key} {dt}: ms={e['ms']:.5f} plain_ms={e['plain_ms']:.5f} "
                f"bound_ms={b_ms:.6f} ({b_by}) library_ms={e['library_ms']}")

    k1, v1 = rand(B, MAX_LEN, hkv, hd, dtype=dtype), rand(B, MAX_LEN, hkv, hd, dtype=dtype)
    q1 = rand(B, hkv, g, hd, dtype=dtype)
    k2, v2 = (rand(2, B, MAX_LEN, hkv, hd, dtype=dtype) for _ in range(2))
    q2 = rand(B, 2, hkv, g, hd, dtype=dtype).transpose(0, 1)   # strided, as on the path
    shape = f"B={B}, L={MAX_LEN}, t=160, Hkv={hkv}, g={g}, hd={hd}"
    for t in (0, 63, 100, 160, MAX_LEN - 1):
        timed = t == 160
        n = t + 1
        for name, q, k, v, n_kv in (("decode_attention", q1, k1, v1, 1),
                                    ("decode_attention_pair", q2, k2, v2, 2)):
            run = lambda: getattr(ops, name)(q, k, v, t)   # noqa: E731
            plain = lambda: getattr(ops, name + "_plain")(q, k, v, t)   # noqa: E731
            err = compare(f"{name} t={t}", run(), plain(), tol)
            lib = None
            if timed:
                rows_ = n_kv * B
                ql = q.reshape(rows_, hkv * g, 1, hd)
                kl = k.reshape(rows_, MAX_LEN, hkv, hd)[:, :n].transpose(1, 2)
                vl = v.reshape(rows_, MAX_LEN, hkv, hd)[:, :n].transpose(1, 2)
                lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                    ql, kl, vl, enable_gqa=True)
            entry(name, "ring", err, run if timed else None, plain,
                  2 * nbytes(q) + 2 * n_kv * B * n * hkv * hd * k.element_size(),
                  4 * n_kv * B * hkv * g * n * hd, library=lib, shape=shape)
    del k1, v1, q1, k2, v2, q2

    qp, kr, vr, kp, vp, bt, tv = engine_decode_inputs(rand, gen, dtype, hkv, g, hd)
    keys = int((tv + 1).sum())
    kv_bytes = 2 * keys * hkv * hd * kp.element_size()
    shape = f"{N_SLOTS} slots, {N_PG} pages of {PS}, ragged t, Hkv={hkv}, g={g}, hd={hd}"
    for name, q, k, v, n_kv in (("decode_attention_pair_paged", qp, kp, vp, 2),
                                ("decode_attention_paged", qp[0], kp[0], vp[0], 1)):
        run = lambda: getattr(ops, name)(q, k, v, bt, tv)   # noqa: E731
        plain = lambda: getattr(ops, name + "_plain")(q, k, v, bt, tv)   # noqa: E731
        got = run()
        err = compare(name, got, plain(), tol)
        for b in range(N_SLOTS):
            if b == 1:
                continue
            if n_kv == 2:
                ring = ops.decode_attention_pair(q[:, b:b + 1], kr[:, b:b + 1],
                                                 vr[:, b:b + 1], int(tv[b]))
                same = torch.equal(got[:, b:b + 1], ring)
            else:
                ring = ops.decode_attention(q[b:b + 1], kr[0, b:b + 1], vr[0, b:b + 1],
                                            int(tv[b]))
                same = torch.equal(got[b:b + 1], ring)
            if not same:
                raise AssertionError(f"{name} differs from the ring kernel on a "
                                     f"paginated cache (slot {b}, g={g}, hd={hd})")
        entry(name, "paged", err, run, plain,
              2 * nbytes(q) + n_kv * kv_bytes + nbytes(bt, tv),
              n_kv * 4 * keys * hkv * g * hd, shape=shape)
    log(f"  paged == ring kernel on the paginated cache, bit for bit (7 slots, "
        f"pair and single)")
    if g > 16 or hd > 128:   # the wide-group and the two-column-warp bodies
        check_decode_batch_invariance(ops, qp, kp, vp, bt, tv)
    del kr, vr, qp, kp, vp

    for H in (2 * hkv, hkv):   # LP pair layer (heads folded), single layer
        q = rand(B, S, H, g, hd, dtype=dtype)
        k, v = rand(B, S, H, hd, dtype=dtype), rand(B, S, H, hd, dtype=dtype)
        bn = 16   # the paths' pinned kv tile ("chunked:16")
        run = lambda: ops.flash_attention(q, k, v, block_n=bn)   # noqa: E731
        plain = lambda: ops.flash_attention_plain(q, k, v)   # noqa: E731
        err = compare(f"flash causal H={H}", run(), plain(), tol)
        ql = q.permute(0, 2, 3, 1, 4).reshape(B, H * g, S, hd)
        kl, vl = k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous()
        lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,  # noqa: E731
                                                     enable_gqa=True)
        pairs = B * H * g * S * (S + 1) // 2   # allowed (query, key) pairs
        entry("flash_attention", "prefill" if H == 2 * hkv else "prefill single", err,
              run, plain, 2 * nbytes(q) + nbytes(k, v), 4 * hd * pairs, library=lib,
              shape=f"B={B}, S={S}, {H} kv heads, g={g}, hd={hd}, causal, block_n={bn}")
    return out


def check_masked_flash(ops, rand, dtype, hkv, g, hd, tol, kind, span, long_len):
    """Flash with the window mask (``kind`` "window", W = ``span``) or the
    chunk mask ("chunk", chunk = ``span``) at a model's head shape and its
    paths' kv tile (block_n = 16): generate's prefill (B = 4 prompts of
    128, where neither mask cuts) and the long run's prefill (B = 1, S =
    ``long_len`` = span + 256, where the mask cuts the late rows). Each held
    against its plain version kv head by kv head (the heads are
    independent; at the long length the plain version's fp32 scores of all
    heads at once take tens of GB) and timed beside its bound and SDPA with
    a boolean mask. Returns {(kernel name, key): entry}."""
    import torch
    import torch.nn.functional as F
    dt = str(dtype).split(".")[1]
    out = {}
    mask_kw = {"window": span} if kind == "window" else {"chunk": span}
    for key, b, s_len in ((f"prefill {kind}", B, S), (f"prefill {kind} long", 1, long_len)):
        q = rand(b, s_len, hkv, g, hd, dtype=dtype)
        k, v = rand(b, s_len, hkv, hd, dtype=dtype), rand(b, s_len, hkv, hd, dtype=dtype)
        run = lambda: ops.flash_attention(q, k, v, kind=kind, block_n=16,  # noqa: E731
                                          **mask_kw)
        plain = lambda: ops.flash_attention_plain(q, k, v, kind=kind, **mask_kw)  # noqa: E731
        want = torch.cat([ops.flash_attention_plain(q[:, :, h:h + 1], k[:, :, h:h + 1],
                                                    v[:, :, h:h + 1], kind=kind, **mask_kw)
                          for h in range(hkv)], dim=2)
        err = compare(f"flash {kind}={span} B={b} S={s_len} Hkv={hkv} g={g} hd={hd}",
                      run(), want, tol)
        del want
        pos = torch.arange(s_len, device=q.device)
        causal = pos[None, :] <= pos[:, None]
        mask = causal & ((pos[:, None] - pos[None, :] < span) if kind == "window"
                         else (pos[:, None] // span == pos[None, :] // span))
        ql = q.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, s_len, hd)
        kl, vl = k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous()
        lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,  # noqa: E731
                                                     enable_gqa=True)
        pairs = int(mask.sum()) * b * hkv * g   # allowed (query, key) pairs
        b_ms, b_by = bound(2 * nbytes(q) + nbytes(k, v), 4 * hd * pairs, dt)
        long = s_len > S
        # The long launches take up to tens of ms in fp32: fewer timed calls,
        # and the plain version (tens of GB of scores) outside a graph.
        n = dict(iters=2, reps=3) if long else {}
        out[("flash_attention", key)] = e = {
            "shape": f"B={b}, S={s_len}, {hkv} kv heads, g={g}, hd={hd}, {kind} "
                     f"{span}, block_n=16",
            "max_abs_err": err, "ms": time_ms(run, **n),
            "plain_ms": call_ms(plain, iters=2) if long else time_ms(plain),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(lib, **n)}
        log(f"  flash_attention {key} {dt}: ms={e['ms']:.5f} plain_ms={e['plain_ms']:.5f} "
            f"bound_ms={b_ms:.6f} ({b_by}) library_ms={e['library_ms']:.5f}")
        del q, k, v, ql, kl, vl, mask, causal
        torch.cuda.empty_cache()
    return out


def check_prefix_encdec_flash(ops, rand, dtype, tol, model, hkv, g):
    """Flash at the shapes phases 12 and 15 (d) launch it, each against its
    plain version and timed beside its bound and SDPA (with a boolean mask
    for the prefix). paligemma (Hkv 1, g 8, hd 256; a rank's g 4 at tp =
    2): the causal mask with a prefix of 256 over S = 384 (256 patches +
    128 text), B = 4, the pair layer (2 folded kv heads) and a single one,
    block_n 16. whisper (16 heads, g 1, hd 64; a rank's 8 at tp = 2): the
    encoder's bidirectional S = T = 1500, the cross-attention prefill (S 32
    against T 1500; the pair's 2 x ``hkv`` folded heads and a single
    layer's ``hkv``) at block_n 16, and the cross-attention decode (S 1
    against T 1500; the pair folded into the batch: 8 rows, and a single
    layer's 4) at block_n 64. T = 1500 is no multiple of a tile: the
    ragged last tile is on the path. Returns {(kernel name, key):
    entry}."""
    import torch
    import torch.nn.functional as F
    dt = str(dtype).split(".")[1]
    if model.split()[0] == PALI:
        P, St = PALI_PREFIX, PALI_PREFIX + S
        cases = [("prefill prefix", B, St, St, 2 * hkv, g, 256, "causal", P, 16),
                 ("prefill prefix single", B, St, St, hkv, g, 256, "causal", P, 16)]
    else:
        cases = [("encoder bidir", B, ENC_SEQ, ENC_SEQ, hkv, 1, 64, "bidir", 0, 16),
                 ("cross prefill", B, WHISPER_PROMPT, ENC_SEQ, 2 * hkv, 1, 64, "bidir", 0, 16),
                 ("cross prefill single", B, WHISPER_PROMPT, ENC_SEQ, hkv, 1, 64, "bidir",
                  0, 16),
                 ("cross decode", 2 * B, 1, ENC_SEQ, hkv, 1, 64, "bidir", 0, 64),
                 ("cross decode single", B, 1, ENC_SEQ, hkv, 1, 64, "bidir", 0, 64)]
    out = {}
    for key, b, s_len, t_len, h, g, hd, kind, prefix, bn in cases:
        q = rand(b, s_len, h, g, hd, dtype=dtype)
        k, v = rand(b, t_len, h, hd, dtype=dtype), rand(b, t_len, h, hd, dtype=dtype)
        run = lambda: ops.flash_attention(q, k, v, kind=kind, prefix_len=prefix,  # noqa: E731
                                          block_n=bn)
        plain = lambda: ops.flash_attention_plain(q, k, v, kind=kind,  # noqa: E731
                                                  prefix_len=prefix)
        err = compare(f"flash {kind} prefix={prefix} B={b} S={s_len} T={t_len} H={h} "
                      f"g={g} hd={hd} block_n={bn}", run(), plain(), tol)
        mask = None
        pairs = s_len * t_len
        if kind == "causal":
            qpos = torch.arange(s_len, device=q.device)[:, None]
            kpos = torch.arange(t_len, device=q.device)[None, :]
            mask = (kpos <= qpos) | (kpos < prefix)
            pairs = int(mask.sum())
        ql = q.permute(0, 2, 3, 1, 4).reshape(b, h * g, s_len, hd)
        kl, vl = k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous()
        lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,  # noqa: E731
                                                     enable_gqa=True)
        b_ms, b_by = bound(2 * nbytes(q) + nbytes(k, v), 4 * hd * pairs * b * h * g, dt)
        n = dict(iters=5, reps=3) if s_len * t_len > 10 ** 6 else {}
        out[("flash_attention", key)] = e = {
            "shape": f"B={b}, S={s_len}, T={t_len}, {h} kv heads, g={g}, hd={hd}, "
                     f"{kind}{f' prefix {prefix}' if prefix else ''}, block_n={bn}",
            "max_abs_err": err, "ms": time_ms(run, **n), "plain_ms": time_ms(plain, **n),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(lib, **n)}
        log(f"  flash_attention {key} {dt}: ms={e['ms']:.5f} plain_ms={e['plain_ms']:.5f} "
            f"bound_ms={b_ms:.6f} ({b_by}) library_ms={e['library_ms']:.5f}")
        del q, k, v, ql, kl, vl
    torch.cuda.empty_cache()
    return out


def engine_decode_inputs(rand, gen, dtype, hkv, g, hd):
    """The engine's decode at one head shape: q [2, 8, hkv, g, hd] (strided,
    as on the path), ring caches kr, vr [2, 8, 256, hkv, hd], the same keys
    paginated into pools kp, vp [2, 129, 16, hkv, hd] through block tables
    bt (slot 1 idle: all garbage page, t = 0) and ragged horizons tv."""
    import torch
    kr, vr = (rand(2, N_SLOTS, MAX_LEN, hkv, hd, dtype=dtype) for _ in range(2))
    qp = rand(N_SLOTS, 2, hkv, g, hd, dtype=dtype).transpose(0, 1)   # as on the path
    perm = 1 + torch.randperm(N_SLOTS * N_PG, generator=gen, device="cuda")
    bt = perm.to(torch.int32).reshape(N_SLOTS, N_PG)
    kp = torch.zeros((2, N_PAGES, PS, hkv, hd), dtype=dtype, device="cuda")
    vp = torch.zeros_like(kp)
    kp[:, bt.long().reshape(-1)] = kr.reshape(2, -1, PS, hkv, hd)
    vp[:, bt.long().reshape(-1)] = vr.reshape(2, -1, PS, hkv, hd)
    bt[1] = 0
    tv = torch.tensor([255, 0, 17, 100, 160, 63, 200, 31], dtype=torch.int32, device="cuda")
    return qp, kr, vr, kp, vp, bt, tv


def decode_times():
    """Device ms (CUDA-graph replay) of the four decode entries at
    tinyllama's shape and at ``DENSE_SHAPES``, bf16 and fp32, through the
    ``repro_torch`` beside this script: generate's ring decode (B = 4, t =
    160) and the engine's paged decode (8 slots); and flash at generate's
    prefill pair shape (B = 4, S = 128, causal, block_n = 16). A shape that
    checkout's wrapper refuses is reported as refused. Copied into another
    checkout, this times that checkout's kernels on the same card."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    out = []
    for model, hkv, g, hd in (("tinyllama-1.1b", HKV, G, HD),) + DENSE_SHAPES + MOE_SHAPES \
            + PREFIX_ENCDEC_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q1 = rand(B, hkv, g, hd, dtype=dtype)
            k1, v1 = (rand(B, MAX_LEN, hkv, hd, dtype=dtype) for _ in range(2))
            qp, kr, vr, kp, vp, bt, tv = engine_decode_inputs(rand, gen, dtype, hkv, g, hd)
            qf = rand(B, S, 2 * hkv, g, hd, dtype=dtype)
            kf, vf = (rand(B, S, 2 * hkv, hd, dtype=dtype) for _ in range(2))
            e = {"model": model, "dtype": str(dtype).split(".")[1]}
            for name, fn in (
                    ("decode_attention", lambda: ops.decode_attention(q1, k1, v1, 160)),
                    ("decode_attention_pair",
                     lambda: ops.decode_attention_pair(qp[:, :B], kr[:, :B], vr[:, :B], 160)),
                    ("decode_attention_paged",
                     lambda: ops.decode_attention_paged(qp[0], kp[0], vp[0], bt, tv)),
                    ("decode_attention_pair_paged",
                     lambda: ops.decode_attention_pair_paged(qp, kp, vp, bt, tv)),
                    ("flash_attention",
                     lambda: ops.flash_attention(qf, kf, vf, block_n=16))):
                try:
                    e[name] = time_ms(fn)
                except ValueError as err:   # a checkout whose wrapper refuses the shape
                    e[name] = f"refused: {err}"
            log(json.dumps(e))
            out.append(e)
    return out


def check_decode_batch_invariance(ops, qp, kp, vp, bt, tv):
    """For both paged decode kernels, each row of the 8-slot launch equals,
    bit for bit, the same row launched alone (B = 1), inside the first 2
    and first 6 rows (the degraded engine's two cohorts) and inside a
    40-row launch (the 8 rows five times: the speculative verifier's width
    at k = 4)."""
    import torch
    n = bt.shape[0]
    for name, q, k, v, cat in (
            ("decode_attention_pair_paged", qp, kp, vp, lambda x: torch.cat([x] * 5, 1)),
            ("decode_attention_paged", qp[0], kp[0], vp[0], lambda x: torch.cat([x] * 5))):
        fn = getattr(ops, name)
        rows = lambda x, lo, hi: x[:, lo:hi] if x.dim() == 5 else x[lo:hi]  # noqa: E731
        full = fn(q, k, v, bt, tv)
        for lo, hi in [(b, b + 1) for b in range(n)] + [(0, DEG_SLOTS),
                                                        (0, N_SLOTS - DEG_SLOTS)]:
            part = fn(rows(q, lo, hi), k, v, bt[lo:hi], tv[lo:hi])
            if not torch.equal(part, rows(full, lo, hi)):
                raise AssertionError(f"{name} rows {lo}..{hi - 1} launched as "
                                     f"B = {hi - lo} differ from the {n}-row launch")
        wide = fn(cat(q), k, v, torch.cat([bt] * 5), torch.cat([tv] * 5))
        for i in range(5):
            if not torch.equal(rows(wide, i * n, (i + 1) * n), full):
                raise AssertionError(f"{name} rows in a {5 * n}-row launch differ "
                                     f"from the {n}-row launch")
        log(f"  decode batch invariance {name} {qp.dtype}: each of {n} rows == "
            f"alone (B = 1) == in the first {DEG_SLOTS} and {N_SLOTS - DEG_SLOTS} "
            f"rows == inside a {5 * n}-row launch, bit for bit")


def check_head_map(ops, rand, gen, dtype, tol):
    """Both paged decode kernels with a head map (``HEAD_MAP_SHAPES``: q's
    kv heads read stored heads of a pool that holds more than q has), at
    the engine's 8 slots (ragged t, slot 1 idle), for each map of the shape:
    held against the plain version, and bit for bit against the identity
    launch on a pool whose heads were gathered first
    (``index_select``); timed beside that identity launch, the plain
    version and the bound (the mapped stored heads' keys read once).
    Returns {(kernel name, key): entry}."""
    import torch
    dt = str(dtype).split(".")[1]
    out = {}
    for model, H, g, hd, Hs, maps in HEAD_MAP_SHAPES:
        qp, _, _, kp, vp, bt, tv = engine_decode_inputs(rand, gen, dtype, Hs, g, hd)
        qp = qp[:, :, :H]                   # q's H kv heads (strided, as on the path)
        keys = int((tv + 1).sum())
        for what, hm_list in maps.items():
            hm = torch.tensor(hm_list, dtype=torch.int32, device="cuda")
            kg, vg = (x.index_select(3, hm.long()) for x in (kp, vp))   # gathered pool
            kv_bytes = 2 * keys * len(set(hm_list)) * hd * kp.element_size()
            for name, n_kv, q, k, v, k1, v1 in (
                    ("decode_attention_pair_paged", 2, qp, kp, vp, kg, vg),
                    ("decode_attention_paged", 1, qp[0], kp[0], vp[0], kg[0], vg[0])):
                fn, plain_fn = getattr(ops, name), getattr(ops, name + "_plain")
                run = lambda: fn(q, k, v, bt, tv, hm)   # noqa: E731
                plain = lambda: plain_fn(q, k, v, bt, tv, hm)   # noqa: E731
                ident = lambda: fn(q, k1, v1, bt, tv)   # noqa: E731
                got = run()
                err = compare(f"{name} head_map {what} {hm_list} ({model}: H={H}, "
                              f"g={g}, hd={hd}, {Hs} stored heads)", got, plain(), tol)
                if not torch.equal(got, ident()):
                    raise AssertionError(f"{name} with head_map {hm_list} differs from "
                                         "the identity launch on the gathered pool")
                b_ms, b_by = bound(2 * nbytes(q) + n_kv * kv_bytes + nbytes(bt, tv, hm),
                                   n_kv * 4 * keys * H * g * hd, dt)
                out[(name, f"{model} {what}")] = e = {
                    "shape": f"{N_SLOTS} slots, ragged t, q: {H} kv heads x g={g}, "
                             f"hd={hd}; pool: {Hs} stored heads; head_map {hm_list}",
                    "max_abs_err": err, "ms": time_ms(run), "identity_ms": time_ms(ident),
                    "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": b_by}
                log(f"  {name} head_map {what} {dt}: == identity launch on the gathered "
                    f"pool, bit for bit; ms={e['ms']:.5f} identity_ms="
                    f"{e['identity_ms']:.5f} plain_ms={e['plain_ms']:.5f} "
                    f"bound_ms={b_ms:.6f} ({b_by})")
        del qp, kp, vp
    return out


# ---------------------------------------------------------------------------
# phase 4: reduced config, card against CPU
# ---------------------------------------------------------------------------

def fill_biases(params, seed, plus_one=False):
    """Biases 0.2 * N(0, 1) and norm scales 1 + 0.2 * N(0, 1), in place, from
    a seed: the init's zeros and ones would leave those branches untested.
    With ``plus_one`` (a (1 + scale) norm) the scales are 0.2 * N(0, 1), so
    the norms multiply by the same factors."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    for name, p in params.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bq", "bk", "bv", "bo", "b_up", "b_down", "bias", "scale"):
            x = 0.2 * torch.randn(p.shape, generator=gen)
            p.data.copy_(x + 1 if leaf == "scale" and not plus_one else x)
    return params


def reduced_parity():
    """tinyllama (g = 1 as reduced, and a GQA group of 4) under
    plan_range(0, 4), and reduced yi-6b, minicpm-2b and granite-34b under
    plan_for_depth(3) (a pair and two single layers; biases and norms
    filled), 4 layers, fp32: card == CPU for prefill logits and greedy
    tokens, and the engine on the card == generate on the card == the
    engine on the CPU."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import plan_for_depth, plan_range
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import (PagedEngine, PagedServeConfig, ServeConfig,
                                   generate, make_prefill)

    pc = ParallelContext()
    base = reduced_config(get_config("tinyllama-1.1b"), n_layers=4)
    models = [(dataclasses.replace(base, n_kv_heads=n_kv), 2)   # g = 1, then 4
              for n_kv in (base.n_kv_heads, 1)]
    models += [(reduced_config(get_config(m), n_layers=4), 3) for m in DENSE]
    for cfg, depth in models:
        plan = plan_range(cfg, 0, 4) if depth == 2 else plan_for_depth(cfg, depth)
        ms = T.build_structure(cfg, plan=plan)
        p_cpu = fill_biases(T.init_params(ms, torch.Generator().manual_seed(SEED),
                                          torch.float32, device="cpu"), SEED + 6)
        p_gpu = copy.deepcopy(p_cpu).to("cuda")   # the same weights, on the card
        prompts = torch.randint(0, cfg.vocab_size, (2, 16),
                                generator=torch.Generator().manual_seed(SEED + 1))
        sv = ServeConfig(max_len=48, cache_dtype=torch.float32)
        lg_cpu, _ = make_prefill(ms, pc, sv)(p_cpu, prompts)
        lg_gpu, _ = make_prefill(ms, pc, sv)(p_gpu, prompts.cuda())
        err = (lg_gpu.cpu() - lg_cpu).abs().max().item()
        tok_cpu = generate(p_cpu, prompts, 16, ms=ms, pc=pc, sv=sv)
        tok_gpu = generate(p_gpu, prompts.cuda(), 16, ms=ms, pc=pc, sv=sv).cpu()
        same = bool((tok_cpu == tok_gpu).all())
        what = f"{cfg.name} n_kv_heads={cfg.n_kv_heads}"
        log(f"[reduced] {what} pairs={ms.plan.pairs}: prefill logits "
            f"max_abs_err={err:.3e} (tol {LOGIT_TOL:g}); greedy tokens equal: {same}")
        if err > LOGIT_TOL or not same:
            raise AssertionError(f"reduced parity failed ({what}): logits err "
                                 f"{err:.3e}, tokens\n{tok_cpu}\n{tok_gpu}")
        # The continuous-batching engine: card == generate on the card ==
        # the engine on the CPU, token for token.
        work = reduced_traffic(cfg.vocab_size)
        psv = PagedServeConfig(n_slots=4, page_size=8, n_pages=33, max_len=48,
                               cache_dtype=torch.float32, prefix_cache=True)
        eng = PagedEngine(p_gpu, ms, psv)
        got = serve(eng, work)
        cpu = serve(PagedEngine(p_cpu, ms, psv), work)
        ref = [generate(p_gpu, torch.from_numpy(p).cuda()[None], n, ms=ms, pc=pc,
                        sv=sv)[0].cpu().numpy() for _, p, n in work]
        n_gen = sum(a.tolist() == b.tolist() for a, b in zip(got, ref))
        n_cpu = sum(a.tolist() == b.tolist() for a, b in zip(got, cpu))
        c = eng.counters
        log(f"[reduced] engine {what}: {len(work)} requests, "
            f"prefix hits {c['prefix_hits']}, bucket launches {c['bucket_groups']}; "
            f"streams equal to generate on the card {n_gen}/{len(work)}, "
            f"to the engine on the CPU {n_cpu}/{len(work)}")
        if n_gen != len(work) or n_cpu != len(work) or not c["prefix_hits"]:
            raise AssertionError(f"reduced engine parity failed ({what})")


def full_width_cut(name, n_layers, prompt_len, *, prefix=False):
    """``name`` at its published widths cut to its first ``n_layers``
    layers under plan_range (one LP pair and what follows it), fp32 weights
    (biases and norms filled) and caches: B = 2 prompts of ``prompt_len``
    tokens, 8 new. Card tokens == CPU tokens, prefill logits within
    LOGIT_TOL, and the engine on the card == generate on the card: the fp32
    bodies of the head shape on a model path (ring and paged). granite-34b
    at 2 layers (d 6144, 48 query heads over 1 kv head at hd 128, vocab
    49152; ~6 GB on the CPU side) takes the wide-group decode body;
    recurrentgemma-9b at 3 layers, one period (the RG-LRU pair and the
    attn_local layer at hd 256, vocab 256,000; ~11 GB), the hd 256 ones.
    With ``prefix`` (paligemma-3b at 2 layers, one pair: 8 query heads
    over 1 kv head at hd 256, vocab 257,216; ~3 GB) the prompts follow
    ``cfg.prefix_len`` patch embeddings (0.02 N(0, 1) from the seed): the
    prefix-LM flash and the pair decode at hd 256 on a model path in fp32;
    the paged pool refuses a prefix-LM, so no engine runs."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_range
    from repro_torch.model import transformer as T
    from repro_torch.model.params import ModelParams, tree_map
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import (PagedEngine, PagedServeConfig, ServeConfig,
                                   generate, make_prefill)

    pc = ParallelContext()
    cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
    ms = T.build_structure(cfg, plan=plan_range(cfg, 0, n_layers))
    if ms.plan.pairs != ((0, 1),):
        raise AssertionError(f"{name} at {n_layers} layers: pairs {ms.plan.pairs}")
    what = f"{name} {n_layers} layers"
    # Drawn on the card and copied to the CPU: the CPU generator would
    # take ~10 s for recurrentgemma's 2.7 B values.
    p_gpu = fill_biases(T.init_params(ms, torch.Generator(device="cuda").manual_seed(SEED),
                                      torch.float32, device="cuda"), SEED + 6,
                        plus_one=prefix)
    p_cpu = ModelParams(tree_map(lambda x: x.cpu(), p_gpu.tree()))
    n_params = sum(v.numel() for v in p_cpu.parameters())
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt_len),
                            generator=torch.Generator().manual_seed(SEED + 1))
    extra, P = {}, 0
    if prefix:
        P = cfg.prefix_len
        extra["prefix"] = 0.02 * torch.randn(
            (2, P, cfg.d_model), generator=torch.Generator().manual_seed(SEED + 7))
    extra_gpu = {k: x.cuda() for k, x in extra.items()}
    sv = ServeConfig(max_len=max(48, P + prompt_len + 8), cache_dtype=torch.float32)
    lg_cpu, _ = make_prefill(ms, pc, sv)(p_cpu, prompts, **extra)
    lg_gpu, _ = make_prefill(ms, pc, sv)(p_gpu, prompts.cuda(), **extra_gpu)
    err = (lg_gpu.cpu() - lg_cpu).abs().max().item()
    scale = lg_cpu.abs().max().item()
    tok_cpu = generate(p_cpu, prompts, 8, ms=ms, pc=pc, sv=sv, **extra)
    tok_gpu = generate(p_gpu, prompts.cuda(), 8, ms=ms, pc=pc, sv=sv, **extra_gpu).cpu()
    same = bool((tok_cpu == tok_gpu).all())
    log(f"[{what}] {n_params / 1e9:.3f} B parameters (fp32), pairs "
        f"{ms.plan.pairs}{f', prefix {P}' if P else ''}: prefill logits "
        f"max_abs_err={err:.3e} (logit scale {scale:.3f}, tol {LOGIT_TOL:g}); "
        f"greedy tokens equal card == CPU: {same}")
    if err > LOGIT_TOL or not same:
        raise AssertionError(f"{what} parity failed: logits err {err:.3e}, "
                             f"tokens\n{tok_cpu}\n{tok_gpu}")
    del p_cpu
    if prefix:
        return
    eng = PagedEngine(p_gpu, ms, PagedServeConfig(
        n_slots=2, page_size=PS, n_pages=7, max_len=48, cache_dtype=torch.float32,
        prefix_cache=True))
    got = serve(eng, [(0, p.numpy(), 8) for p in prompts])
    if [g.tolist() for g in got] != tok_gpu.tolist():
        raise AssertionError(f"{what} engine differs from generate on the "
                             f"card:\n{got}\n{tok_gpu}")
    log(f"[{what}] engine on the card == generate on the card (2 streams)")


def reduced_prefix_encdec_parity():
    """Reduced paligemma (a prefix of 8 patch embeddings) and whisper (2
    encoder layers over 24 frames), 4 layers under plan_for_depth(3) (a
    pair and two single layers; biases and norms filled), fp32: the
    prefill logits on the card within LOGIT_TOL of the CPU's and greedy
    tokens equal, through ``generate`` (the paged pool refuses both
    models, as the JAX package's does)."""
    import copy
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import PagedEngine, PagedServeConfig, ServeConfig, generate, make_prefill

    pc = ParallelContext()
    for name in (PALI, WHISPER):
        cfg = reduced_config(get_config(name), n_layers=4)
        ms = T.build_structure(cfg, plan=plan_for_depth(cfg, 3))
        p_cpu = fill_biases(T.init_params(ms, torch.Generator().manual_seed(SEED),
                                          torch.float32, device="cpu"), SEED + 6,
                            plus_one=cfg.norm_plus_one)
        p_gpu = copy.deepcopy(p_cpu).to("cuda")
        gen = torch.Generator().manual_seed(SEED + 1)
        prompts = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        key, n = ("prefix", cfg.prefix_len) if cfg.prefix_len else ("frames", cfg.enc_seq)
        extra = {key: 0.5 * torch.randn((2, n, cfg.d_model), generator=gen)}
        extra_gpu = {key: extra[key].cuda()}
        sv = ServeConfig(max_len=48, cache_dtype=torch.float32)
        lg_cpu, _ = make_prefill(ms, pc, sv)(p_cpu, prompts, **extra)
        lg_gpu, _ = make_prefill(ms, pc, sv)(p_gpu, prompts.cuda(), **extra_gpu)
        err = (lg_gpu.cpu() - lg_cpu).abs().max().item()
        tok_cpu = generate(p_cpu, prompts, 16, ms=ms, pc=pc, sv=sv, **extra)
        tok_gpu = generate(p_gpu, prompts.cuda(), 16, ms=ms, pc=pc, sv=sv,
                           **extra_gpu).cpu()
        same = bool((tok_cpu == tok_gpu).all())
        log(f"[reduced] {cfg.name} pairs={ms.plan.pairs} {key} {n}: prefill logits "
            f"max_abs_err={err:.3e} (tol {LOGIT_TOL:g}); greedy tokens equal: {same}")
        if err > LOGIT_TOL or not same:
            raise AssertionError(f"reduced {cfg.name} parity failed: logits err "
                                 f"{err:.3e}, tokens\n{tok_cpu}\n{tok_gpu}")
        try:
            PagedEngine(p_gpu, ms, PagedServeConfig(n_slots=2, page_size=8, n_pages=9,
                                                    max_len=48))
        except ValueError as e:
            log(f"[reduced] {cfg.name}: PagedEngine refuses it: {e}")
        else:
            raise AssertionError(f"PagedEngine accepted {cfg.name}")


def interventions_parity():
    """``core.interventions.apply_intervened`` on the card against the CPU
    (reduced paligemma, 6 layers, fp32, a prefix of 8, norms filled): every
    plan kind (sequential, shuffle, prune, merge, a 3-way parallel group
    and parallel2, each parallel one in both forms) within LOGIT_TOL, and
    the run launched flash. On the card the sequential plan equals the
    model's own stack bit for bit, and the generic "tp" loop over groups of
    two is held to the LP pair path (stacked weights, one dual RMSNorm
    launch per norm) within LOGIT_TOL; whether it is bit for bit there is
    printed."""
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import interventions as IV
    from repro_torch.core.lp import LPPlan, extract_layers, lp_convert
    from repro_torch.kernels import ops
    from repro_torch.model import attention as A
    from repro_torch.model import stack as ST
    from repro_torch.model import transformer as T
    from repro_torch.model.params import tree_map
    from repro_torch.parallel.context import ParallelContext

    n, Sx = 6, 16
    cfg = reduced_config(get_config(PALI), n_layers=n)
    ms = T.build_structure(cfg)
    params = fill_biases(T.init_params(ms, torch.Generator().manual_seed(SEED),
                                       torch.float32, device="cpu"), SEED + 6,
                         plus_one=True)
    layers = {"cpu": extract_layers(params.tree()["segments"], ms.segments)}
    layers["cuda"] = [tree_map(lambda t: t.cuda(), p) for p in layers["cpu"]]
    x = {"cpu": torch.randn((2, Sx, cfg.d_model),
                            generator=torch.Generator().manual_seed(SEED + 2))}
    x["cuda"] = x["cpu"].cuda()
    plans = {"sequential": IV.sequential_plan(n),
             "shuffle": IV.shuffle_plan(n, 1, 4, torch.Generator().manual_seed(SEED)),
             "prune": IV.prune_plan(n, 2, 3)}
    for form in ("par", "tp"):
        plans[f"parallel {form}"] = IV.parallel_plan(n, 1, 3, form=form)
        plans[f"parallel2 {form}"] = IV.parallel2_plan(n, 1, 4, form=form)

    def run(dev, plan, lp=None):
        return IV.apply_intervened(lp or layers[dev], plan, x[dev], cfg=cfg,
                                   positions=torch.arange(Sx, device=dev)[None],
                                   prefix_len=cfg.prefix_len)

    ops.reset_launches()
    errs = {}
    for name, plan in plans.items():
        errs[name] = (run("cuda", plan).cpu() - run("cpu", plan)).abs().max().item()
    merged = {dev: IV.merge_avg(layers[dev], 2, 4) for dev in ("cpu", "cuda")}
    errs["merge"] = (run("cuda", merged["cuda"][1], merged["cuda"][0]).cpu()
                     - run("cpu", merged["cpu"][1], merged["cpu"][0])).abs().max().item()
    launches = dict(ops.LAUNCHES)
    log(f"[interventions] {cfg.name} {n} layers, prefix {cfg.prefix_len}: card vs "
        f"CPU max_abs_err " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tol {LOGIT_TOL:g}); launches {launches}")
    if max(errs.values()) > LOGIT_TOL:
        raise AssertionError(f"interventions card != CPU: {errs}")
    if not launches["flash_attention"]:
        raise AssertionError(f"interventions launched {launches}")

    def stack(pairs):
        segs, sp = lp_convert(cfg, layers["cuda"], LPPlan(pairs))
        return ST.apply_stack_full(sp, x["cuda"], segs, cfg=cfg, dims=A.attn_dims(cfg, 1),
                                   pc=ParallelContext(),
                                   positions=torch.arange(Sx, device="cuda")[None],
                                   prefix_len=cfg.prefix_len)[0]
    tp, pairs = run("cuda", plans["parallel2 tp"]), stack(((1, 2), (3, 4)))
    tp_err = (tp - pairs).abs().max().item()
    same_seq = torch.equal(run("cuda", plans["sequential"]), stack(()))
    log(f"[interventions] on the card: parallel2 tp vs LP pairs (1, 2), (3, 4) "
        f"max_abs_err {tp_err:.2e} (tol {LOGIT_TOL:g}; bit for bit: "
        f"{torch.equal(tp, pairs)}); sequential == the stack bit for bit: {same_seq}")
    if not (tp_err <= LOGIT_TOL and same_seq):
        raise AssertionError("interventions differ from the port's own stack")
    return max(errs.values())


def reduced_mamba_parity():
    """falcon-mamba cut to 4 layers, LP pairs (0,1), (2,3), fp32 weights and
    caches: the card against the CPU for ``generate`` and the engine, and
    the engine against ``generate`` on the card, with staggered traffic and
    with a preempted request (resumed by a full re-prefill and a replay)."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import plan_range
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import (PagedEngine, PagedServeConfig, ServeConfig,
                                   generate, make_prefill)

    pc = ParallelContext()
    cfg = reduced_config(get_config(MAMBA), n_layers=4)
    ms = T.build_structure(cfg, plan=plan_range(cfg, 0, 4))
    p_cpu = T.init_params(ms, torch.Generator().manual_seed(SEED),
                          torch.float32, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    prompts = torch.randint(0, cfg.vocab_size, (2, 16),
                            generator=torch.Generator().manual_seed(SEED + 1))
    sv = ServeConfig(max_len=48, cache_dtype=torch.float32)
    lg_cpu, _ = make_prefill(ms, pc, sv)(p_cpu, prompts)
    lg_gpu, _ = make_prefill(ms, pc, sv)(p_gpu, prompts.cuda())
    err = (lg_gpu.cpu() - lg_cpu).abs().max().item()
    tok_cpu = generate(p_cpu, prompts, 16, ms=ms, pc=pc, sv=sv)
    tok_gpu = generate(p_gpu, prompts.cuda(), 16, ms=ms, pc=pc, sv=sv).cpu()
    same = bool((tok_cpu == tok_gpu).all())
    log(f"[reduced] {cfg.name} pairs={ms.plan.pairs}: prefill logits "
        f"max_abs_err={err:.3e} (tol {LOGIT_TOL:g}); greedy tokens equal: {same}")
    if err > LOGIT_TOL or not same:
        raise AssertionError(f"reduced mamba parity failed: logits err {err:.3e}, "
                             f"tokens\n{tok_cpu}\n{tok_gpu}")
    rng = np.random.default_rng(SEED + 4)
    preempt = [(0, rng.integers(0, cfg.vocab_size, 8), 20),
               (0, rng.integers(0, cfg.vocab_size, 8), 20),
               (4, rng.integers(0, cfg.vocab_size, 8), 4)]
    for name, work, psv in (
            ("staggered", reduced_traffic(cfg.vocab_size),
             PagedServeConfig(n_slots=4, page_size=8, n_pages=33, max_len=48,
                              cache_dtype=torch.float32, prefix_cache=True)),
            ("preempted", preempt,
             PagedServeConfig(n_slots=4, page_size=8, n_pages=9, max_len=32,
                              cache_dtype=torch.float32, prefix_cache=True,
                              preempt_after=2))):
        eng = PagedEngine(p_gpu, ms, psv)
        got = serve(eng, work)
        cpu = serve(PagedEngine(p_cpu, ms, psv), work)
        gsv = ServeConfig(max_len=psv.max_len, cache_dtype=torch.float32)
        ref = [generate(p_gpu, torch.from_numpy(p).cuda()[None], n, ms=ms, pc=pc,
                        sv=gsv)[0].cpu().numpy() for _, p, n in work]
        n_gen = sum(a.tolist() == b.tolist() for a, b in zip(got, ref))
        n_cpu = sum(a.tolist() == b.tolist() for a, b in zip(got, cpu))
        c = eng.counters
        log(f"[reduced] {cfg.name} engine, {name}: {len(work)} requests, "
            f"{c['full_prefills']} exact prefills, preemptions "
            f"{eng.sched.preemptions_total}, replayed tokens {c['replay_tokens']}; "
            f"streams equal to generate on the card {n_gen}/{len(work)}, to the "
            f"engine on the CPU {n_cpu}/{len(work)}")
        if n_gen != len(work) or n_cpu != len(work) or eng.prefix is not None \
                or c["bucket_groups"]:
            raise AssertionError(f"reduced mamba engine parity failed ({name})")
        if name == "preempted" and not (eng.sched.preemptions_total
                                        and c["replay_tokens"]):
            raise AssertionError("the reduced mamba engine preempted nothing")


def reduced_hybrid_parity():
    """recurrentgemma cut to 6 layers (rec pairs (0,1), (3,4); attn_local
    layers 2 and 5; window 16), fp32 weights and caches: generate on the
    card == on the CPU for 2 prompts of 21 tokens (past the window: the
    ring wraps), prefill logits within LOGIT_TOL. At the window raised to
    the cache length (48, as the paged pool needs), the engine on the card
    == generate on the card == the engine on the CPU, staggered traffic."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lp import plan_range
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import (PagedEngine, PagedServeConfig, ServeConfig,
                                   generate, make_prefill)

    pc = ParallelContext()
    sv = ServeConfig(max_len=48, cache_dtype=torch.float32)
    base = reduced_config(get_config(HYBRID), n_layers=6)
    for cfg in (base, dataclasses.replace(base, window=sv.max_len)):
        ms = T.build_structure(cfg, plan=plan_range(cfg, 0, 6))
        p_cpu = fill_biases(T.init_params(ms, torch.Generator().manual_seed(SEED),
                                          torch.float32, device="cpu"), SEED + 6)
        p_gpu = copy.deepcopy(p_cpu).to("cuda")
        what = f"{cfg.name} window={cfg.window}"
        if cfg.window < sv.max_len:
            prompts = torch.randint(0, cfg.vocab_size, (2, cfg.window + 5),
                                    generator=torch.Generator().manual_seed(SEED + 1))
            lg_cpu, _ = make_prefill(ms, pc, sv)(p_cpu, prompts)
            lg_gpu, _ = make_prefill(ms, pc, sv)(p_gpu, prompts.cuda())
            err = (lg_gpu.cpu() - lg_cpu).abs().max().item()
            tok_cpu = generate(p_cpu, prompts, 16, ms=ms, pc=pc, sv=sv)
            tok_gpu = generate(p_gpu, prompts.cuda(), 16, ms=ms, pc=pc, sv=sv).cpu()
            same = bool((tok_cpu == tok_gpu).all())
            log(f"[reduced] {what} pairs={ms.plan.pairs}: {prompts.shape[1]}-token "
                f"prompts, prefill logits max_abs_err={err:.3e} (tol {LOGIT_TOL:g}); "
                f"greedy tokens equal card == CPU: {same}")
            if err > LOGIT_TOL or not same:
                raise AssertionError(f"reduced hybrid parity failed ({what}): logits "
                                     f"err {err:.3e}, tokens\n{tok_cpu}\n{tok_gpu}")
            continue
        work = reduced_traffic(cfg.vocab_size)
        psv = PagedServeConfig(n_slots=4, page_size=8, n_pages=33, max_len=48,
                               cache_dtype=torch.float32, prefix_cache=True)
        eng = PagedEngine(p_gpu, ms, psv)
        got = serve(eng, work)
        cpu = serve(PagedEngine(p_cpu, ms, psv), work)
        ref = [generate(p_gpu, torch.from_numpy(p).cuda()[None], n, ms=ms, pc=pc,
                        sv=sv)[0].cpu().numpy() for _, p, n in work]
        n_gen = sum(a.tolist() == b.tolist() for a, b in zip(got, ref))
        n_cpu = sum(a.tolist() == b.tolist() for a, b in zip(got, cpu))
        c = eng.counters
        log(f"[reduced] engine {what}: {len(work)} requests, {c['full_prefills']} exact "
            f"prefills, prefix cache {'on' if eng.prefix else 'off'}; streams equal to "
            f"generate on the card {n_gen}/{len(work)}, to the engine on the CPU "
            f"{n_cpu}/{len(work)}")
        if n_gen != len(work) or n_cpu != len(work) or eng.prefix is not None:
            raise AssertionError(f"reduced hybrid engine parity failed ({what})")


def reduced_traffic(vocab):
    """10 requests of the reduced engine check: 4 sharing a 16-token
    prefix, 6 cold, in staggered waves (submit step, prompt, max_new)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    shared = rng.integers(0, vocab, 16)
    fam = [np.concatenate([shared, rng.integers(0, vocab, n)]) for n in (5, 8, 11, 2)]
    cold = [rng.integers(0, vocab, n) for n in (3, 9, 17, 24, 30, 12)]
    prompts = [fam[0], cold[0], cold[1], fam[1], cold[2], cold[3], fam[2],
               cold[4], fam[3], cold[5]]
    return list(zip([0, 0, 0, 1, 1, 1, 2, 2, 4, 4], prompts,
                    [6, 4, 7, 5, 8, 3, 6, 5, 4, 7]))


def serve(eng, work, step_log=None):
    """Drive a PagedEngine through (submit step, prompt, max_new) traffic;
    returns the streams in submission order. ``step_log`` receives
    (seconds, stats) per step, each step ending with its tokens on the
    host."""
    rids, i = [], 0
    while i < len(work) or eng.sched.n_queued or eng.sched.n_running:
        while i < len(work) and work[i][0] <= eng.step_count:
            rids.append(eng.add_request(work[i][1], work[i][2]))
            i += 1
        t0 = time.perf_counter()
        stats = eng.step()
        if step_log is not None:
            step_log.append((time.perf_counter() - t0, stats))
    return [eng.results[r] for r in rids]


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

def main_path():
    """Phase 5: LP tinyllama-1.1b through ``generate``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.model import transformer as T

    cfg = get_config("tinyllama-1.1b")
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, 16))
    n_groups, n_pairs = model_counts(ms)
    assert (n_groups, n_pairs) == (16, 6), (n_groups, n_pairs)
    params = T.init_params(ms, torch.Generator(device="cuda").manual_seed(SEED),
                           torch.bfloat16, device="cuda")
    return generate_path("main", cfg, ms, params)


class DecodeProbe:
    """While on, keeps a copy of the inputs and output of the first layer's
    launch of each decode kernel of a path (ring for ``generate``, paged for
    the engine) at the decode steps ``steps``, and of the first launch of
    each wrapper in ``shapes`` at each shape it is given: the path's own
    launches on the model's own tensors, and no launch is added for the
    copy. ``check`` then holds each copy against the kernel's plain version
    on the same inputs (BF16_TOL in bf16), so a wrong body at the model's
    head shape fails the timed run itself. ``skip``: {wrapper of ``shapes``:
    launches passed over before the first one kept} (a pipeline stage's
    ticks before its first microbatch run on zeros)."""

    def __init__(self, ms, paged, steps=(0, 40), shapes=(), kv_mode="heads", skip=None):
        n_single, n_pair, _ = mixer_counts(ms) if paged else ring_decode_counts(
            ms, kv_mode)
        kind = "_paged" if paged else ""
        self.per_step = {name: per for name, per in (
            (f"decode_attention_pair{kind}", n_pair),
            (f"decode_attention{kind}", n_single)) if per}
        self.steps, self.shapes, self.skip = steps, shapes, dict(skip or {})
        self.kept, self.firsts, self.seen, self.orig = [], {}, {}, {}

    def __enter__(self):
        from repro_torch.kernels import ops

        def copy(x):
            return x.detach().clone() if hasattr(x, "clone") else x

        for name, per in self.per_step.items():
            fn = self.orig[name] = getattr(ops, name)

            def probe(*args, name=name, fn=fn, per=per, **kw):
                out = fn(*args, **kw)
                i = self.seen[name] = self.seen.get(name, -1) + 1
                if i % per == 0 and i // per in self.steps:
                    self.kept.append((name, i // per, [copy(a) for a in args],
                                      out.clone()))
                return out
            setattr(ops, name, probe)
        for name in self.shapes:
            fn = self.orig[name] = getattr(ops, name)

            def first(*args, name=name, fn=fn, **kw):
                out = fn(*args, **kw)
                if self.skip.get(name, 0) > 0:
                    self.skip[name] -= 1
                    return out
                key = (name, kw.get("kind"), *(
                    (tuple(a.shape), a.dtype) for a in args if hasattr(a, "shape")))
                if key not in self.firsts:
                    outs = out if isinstance(out, tuple) else (out,)   # the scan's (y, hT)
                    self.firsts[key] = ([copy(a) for a in args],
                                        {k: copy(v) for k, v in kw.items()},
                                        [o.clone() for o in outs])
                return out
            setattr(ops, name, first)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for name, fn in self.orig.items():
            setattr(ops, name, fn)

    def check(self, what):
        """Max abs error over the kept launches; raises if one disagrees, a
        decode kernel was not launched at every probed step or a wrapper of
        ``shapes`` not at all."""
        import torch
        from repro_torch.kernels import ops
        got = sorted((name, step) for name, step, _, _ in self.kept)
        want = sorted((name, step) for name in self.per_step for step in self.steps)
        if got != want:
            raise AssertionError(f"{what}: decode launches kept {got}, want {want}")
        missing = set(self.shapes) - {key[0] for key in self.firsts}
        if missing:
            raise AssertionError(f"{what}: {sorted(missing)} not launched")
        errs = []
        for name, step, args, out in self.kept:
            tol = BF16_TOL if out.dtype == torch.bfloat16 else FP32_TOL
            errs.append(compare(f"[{what}] {name}, decode step {step}, on the model path",
                                out, getattr(ops, f"{name}_plain")(*args), tol))
        for (name, _, *shapes), (args, kw, outs) in self.firsts.items():
            want = getattr(ops, f"{name}_plain")(*args, **kw)
            for out, ref in zip(outs, want if isinstance(want, tuple) else (want,)):
                tol = BF16_TOL if out.dtype == torch.bfloat16 else FP32_TOL
                errs.append(compare(
                    f"[{what}] {name} {' '.join(str(list(s)) for s, _ in shapes)} "
                    f"{kw.get('kind', '')}, first launch at this shape, on the model path",
                    out, ref, tol))
        self.kept.clear()
        self.firsts.clear()
        return max(errs)


def generate_path(what, cfg, ms, params, *, check_ms=None, inputs=None,
                  prompt_len=S, max_len=MAX_LEN):
    """A model through ``generate``: B = 4 prompts of ``prompt_len`` (128)
    random tokens, 64 new, bf16 ring cache of ``max_len`` (256), with the
    exact launch count of every kernel, and prefill ms and decode ms per
    step taken inside that one ``generate`` call. ``inputs``: generate's
    extra inputs (``prefix`` patch embeddings, whose positions come first,
    or encoder ``frames``). One decode step after the prefill is held
    against a prefill of the longer prompt under ``check_ms`` (default
    ``ms``; for a mixture of experts the structure at a capacity that drops
    nothing, since a prefill drops slots that a decode step keeps). Returns
    (launches, metrics)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import ServeConfig, generate, make_prefill

    pc = ParallelContext()
    inputs = inputs or {}
    n_groups, n_pairs = model_counts(ms)
    n_single, n_attn_pairs, n_rec = mixer_counts(ms)
    n_enc = sum(seg.count for seg in ms.enc_segments)
    n_cross = sum(seg.count for seg in ms.segments if seg.group.specs[0].cross_attn)
    P = cfg.prefix_len if "prefix" in inputs else 0
    log(f"[{what}] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.head_dim}, pairs "
        f"{ms.plan.pairs[0]}..{ms.plan.pairs[-1]} ({n_pairs}), {n_groups} groups"
        + (f", {n_enc} encoder layers over {inputs['frames'].shape[1]} frames"
           if n_enc else "") + (f", a prefix of {P}" if P else ""))
    prompts = torch.randint(0, cfg.vocab_size, (B, prompt_len),
                            generator=torch.Generator(device="cuda").manual_seed(SEED + 5),
                            device="cuda")
    sv = ServeConfig(max_len=max_len, cache_dtype=torch.bfloat16)

    generate(params, prompts, 2, ms=ms, pc=pc, sv=sv, **inputs)   # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    timings = {}
    with DecodeProbe(ms, paged=False) as probe:
        out = generate(params, prompts, N_NEW, ms=ms, pc=pc, sv=sv, timings=timings,
                       **inputs)
    launches = dict(ops.LAUNCHES)
    path_err = probe.check(f"{what} generate")

    # Per prefill one flash launch per encoder layer and per attention group,
    # and one per cross-attention group; per decode step one per
    # cross-attention group (its query row against the encoder's keys).
    steps = N_NEW - 1
    want = {"flash_attention": n_enc + n_single + n_attn_pairs + n_cross * (1 + steps),
            "dual_rmsnorm": norm_launches(cfg, n_pairs) * (1 + steps),
            "decode_attention": steps * n_single,
            "decode_attention_pair": steps * n_attn_pairs,
            "decode_attention_paged": 0, "decode_attention_pair_paged": 0,
            "ssm_scan": n_rec}
    log(f"[{what}] launches {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    logits, caches = make_prefill(ms, pc, sv)(params, prompts, **inputs)
    if tuple(out.shape) != (B, N_NEW) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {tuple(out.shape)} out of range")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    tok0 = logits.argmax(-1)
    if not bool((tok0 == out[:, 0]).all()):
        raise AssertionError("first generated token is not the prefill argmax")
    # One decode step against the prefill cache vs a prefill of the longer
    # prompt: the same logits up to bf16 rounding of two different paths.
    cms = check_ms or ms
    if cms is not ms:
        del logits, caches
        logits, caches = make_prefill(cms, pc, sv)(params, prompts, **inputs)
        tok0 = logits.argmax(-1)
    step_logits, _ = T.decode_step(params, tok0, caches, P + prompt_len, ms=cms, pc=pc)
    longer = torch.cat([prompts, tok0[:, None]], dim=1)
    full_logits, _, _ = T.forward_full(params, longer, ms=cms, pc=pc,
                                       prefix_embed=inputs.get("prefix"),
                                       enc_frames=inputs.get("frames"),
                                       attn_impl=sv.attn_impl)
    scale = full_logits[:, -1].abs().max().item()
    diff = (step_logits - full_logits[:, -1]).abs().max().item()
    log(f"[{what}] decode-step vs prefill logits: max_abs_diff={diff:.4f} "
        f"(logit scale {scale:.3f}, tol 0.1 x scale)")
    if diff > 0.1 * scale:
        raise AssertionError("decode step disagrees with prefill of the same stream")
    del logits, caches, step_logits, full_logits
    # Both from the one measured generate above.
    e2e = {"prefill_ms": timings["prefill_s"] * 1e3,
           "decode_ms_per_step": timings["decode_s"] / steps * 1e3,
           "decode_tok_per_s": B * steps / timings["decode_s"]}
    log(f"[{what}] " + " ".join(f"{k}={v:.3f}" for k, v in e2e.items()))
    e2e["decode_path_max_abs_err"] = path_err
    e2e["busy_share"] = profile_decode(
        lambda: generate(params, prompts, 9, ms=ms, pc=pc, sv=sv, **inputs),
        f"{cfg.name} generate(9 new)")
    return launches, e2e


def norm_launches(cfg, n_pairs):
    """Dual RMSNorm launches per forward: 2 per LP pair (one per phase) for
    RMSNorm models, 1 where the layers have no FFN phase (falcon-mamba). A
    LayerNorm model (granite-34b, dbrx, whisper) launches none: its
    ``dual_norm`` is plain PyTorch, as in the JAX package, which has no
    kernel for it."""
    if cfg.norm_kind == "rmsnorm":
        return (2 if cfg.block_pattern[0].ffn else 1) * n_pairs
    log(f"  {cfg.name}: norm_kind={cfg.norm_kind}: no dual_rmsnorm launch expected")
    return 0


def profile_decode(run, what="generate(9 new)"):
    """Device busy share and kernel time by name over a short run (a
    generate of a prefill and 8 decode steps, or 8 engine steps), from
    torch.profiler. Returns the busy share, or None when not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    if not busy_us:
        log("[profile] device time not measured: the profiler saw no device events")
        return None
    log(f"[profile] {what} wall_ms={wall_us / 1e3:.3f} device_busy_ms="
        f"{busy_us / 1e3:.3f} busy_share={busy_us / wall_us:.4f} "
        f"kernels={sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {us / 1e3:9.3f} ms  {us / busy_us:6.1%}  {name[:90]}")
    return busy_us / wall_us


# ---------------------------------------------------------------------------
# phase 6: the continuous-batching engine at full width
# ---------------------------------------------------------------------------

def engine_traffic(vocab, n_new=ENGINE_NEW):
    """16 requests in two waves of 8 (the second 4 steps after the first),
    ``n_new`` new tokens each: 8 share a 64-token prefix (4 pages) and add their
    own 16-96-token suffix, 8 are cold at 24-160 tokens. The second wave's
    hit suffixes and cold prompts fall into common buckets (32, 64, 128),
    so hit and cold rows share bucket launches."""
    import numpy as np
    rng = np.random.default_rng(SEED + 2)
    prefix = rng.integers(0, vocab, 64)
    fam = [np.concatenate([prefix, rng.integers(0, vocab, n)])
           for n in (16, 40, 60, 96, 20, 44, 64, 90)]
    cold = [rng.integers(0, vocab, n) for n in (24, 50, 100, 160, 30, 52, 110, 150)]
    wave1 = [p for pair in zip(fam[:4], cold[:4]) for p in pair]
    wave2 = [p for pair in zip(fam[4:], cold[4:]) for p in pair]
    return [(0, p, n_new) for p in wave1] + [(4, p, n_new) for p in wave2]


def engine_config(cache_dtype, **kw):
    from repro_torch.serve import PagedServeConfig
    return PagedServeConfig(n_slots=N_SLOTS, page_size=PS, max_len=MAX_LEN,
                            n_pages=N_PAGES, prefix_cache=True,
                            cache_dtype=cache_dtype, **kw)


def shared_bucket_launches(eng):
    """(hit rows, cold rows) of every bucket launch that held both, from
    the engine's prefill spans: one launch per (step, bucket) group here,
    since every group fits the program's rows."""
    from repro_torch.serve import bucket_for
    groups = {}
    for span in eng.telemetry.spans.values():
        for e in span.events_of("prefill"):
            if e.attrs.get("batched"):
                key = (e.step, bucket_for(e.attrs["tokens"], eng._buckets))
                groups.setdefault(key, []).append(e.attrs["kind"])
    return [(kinds.count("suffix"), kinds.count("full"))
            for kinds in groups.values()
            if "suffix" in kinds and "full" in kinds]


def first_divergence(params, ms, pc, prompt, want, got, inputs=None,
                     max_len=MAX_LEN):
    """First position where the engine's stream leaves generate()'s, and
    the top-2 margin and scale of generate's logits there (its own
    prefill + decode_step path; ``inputs``: the row's prefix or frames)."""
    import torch
    from repro_torch.model import transformer as T
    from repro_torch.serve import ServeConfig, make_prefill
    inputs = inputs or {}
    i = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
    sv = ServeConfig(max_len=max_len, cache_dtype=torch.float32)
    x = torch.from_numpy(prompt).cuda()[None]
    logits, caches = make_prefill(ms, pc, sv)(params, x, **inputs)
    t0 = len(prompt) + (ms.cfg.prefix_len if "prefix" in inputs else 0)
    for j in range(i):
        tok = torch.tensor([int(want[j])], device="cuda")
        logits, caches = T.decode_step(params, tok, caches, t0 + j, ms=ms, pc=pc)
    top = logits[0].float().topk(2).values
    return i, float(top[0] - top[1]), float(logits[0].abs().max())


def generate_streams(models, work):
    """``generate``'s greedy stream of each request (fp32 ring cache);
    ``models[i]`` is request i's (params, structure)."""
    import torch
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import ServeConfig, generate
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32)
    return [generate(p, torch.from_numpy(prompt).cuda()[None], n, ms=m,
                     pc=ParallelContext(), sv=sv)[0].cpu().numpy()
            for (p, m), (_, prompt, n) in zip(models, work)]


def held_to(what, models, work, got, want, inputs=None, max_len=MAX_LEN):
    """Each stream equal to ``want`` or leaving it at a near-tie of
    generate's logits (top-2 margin <= MARGIN_FRAC of scale); ``models[i]``
    is request i's (params, structure), ``inputs[i]`` its prefix or frames
    (none when None). Returns the count of equal streams."""
    from repro_torch.parallel.context import ParallelContext
    n_equal, worst = 0, 0.0
    inputs = inputs or [None] * len(work)
    for (p, m), (_, prompt, _), stream, ref, inp in zip(models, work, got, want, inputs):
        if ref.tolist() == stream.tolist():
            n_equal += 1
            continue
        j, margin, scale = first_divergence(p, m, ParallelContext(), prompt, ref,
                                            stream, inp, max_len)
        worst = max(worst, margin / scale)
        log(f"[{what}] stream of a {len(prompt)}-token prompt leaves its reference "
            f"at token {j}: top-2 margin {margin:.5f} of logit scale {scale:.3f} "
            f"({margin / scale:.5f}, limit {MARGIN_FRAC})")
    if worst > MARGIN_FRAC:
        raise AssertionError(f"{what}: a stream diverged away from a near-tie")
    return n_equal


def tinyllama_model():
    """tinyllama-1.1b under plan_for_depth(16), bf16 random weights from
    the seed, made on the card: the model of phases 6 and 8."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.model import transformer as T

    cfg = get_config("tinyllama-1.1b")
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, 16))
    params = T.init_params(ms, torch.Generator(device="cuda").manual_seed(SEED),
                           torch.bfloat16, device="cuda")
    return cfg, ms, params


def model_counts(ms):
    """(groups, pairs) of a model structure: per launch a prefill runs one
    flash launch per group and 2 dual RMSNorms per pair; a decode one paged
    decode launch per group (pair or single) and 2 norms per pair."""
    return sum(s.count for s in ms.segments), len(ms.plan.pairs)


def mixer_counts(ms):
    """(single attention layers, attention LP pairs, recurrent groups) of a
    model structure: per forward one flash launch per attention group and
    one scan per recurrent group (Mamba, RG-LRU); per decode step one
    decode launch per attention group (the pair form for a pair). A pair of
    mixed attention kinds (llama4's chunked + global) runs half by half:
    it counts as two single layers."""
    single = pair = rec = 0
    for seg in ms.segments:
        kinds = {spec.mixer for spec in seg.group.specs}
        if not seg.group.specs[0].mixer.startswith("attn"):
            rec += seg.count
        elif len(kinds) > 1:
            single += 2 * seg.count
        elif seg.group.pair:
            pair += seg.count
        else:
            single += seg.count
    return single, pair, rec


def ring_decode_counts(ms, kv_mode="heads"):
    """(single-layer ring decode launches, pair launches, sequence-sharded
    attention phases) of one decode step under ``kv_mode``: a layer whose
    ring ``kv_mode`` cuts along the sequence (``blocks.seq_sharded_kind``)
    decodes in torch ops with one gather, one max and one sum, and launches
    no kernel; a pair of mixed kinds runs half by half."""
    from repro_torch.model.blocks import seq_sharded_kind
    single = pair = seq = 0
    for seg in ms.segments:
        kinds = [spec.mixer for spec in seg.group.specs]
        if not kinds[0].startswith("attn"):
            continue
        cut = [seq_sharded_kind(ms.cfg, ms.dims, k, kv_mode) for k in kinds]
        if seg.group.pair and len(set(kinds)) == 1:
            pair += seg.count * (not cut[0])
            seq += seg.count * cut[0]
        else:
            single += seg.count * (len(kinds) - sum(cut))
            seq += seg.count * sum(cut)
    return single, pair, seq


MATRICES = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down", "w_rec", "w_out",
            "router")


def set_compute_dtype(params, dtype, segments=True):
    """Every weight but the layers' matrices (embeddings, norms, biases) to
    ``dtype``, in place. With fp32 the activations, caches and kernels run
    in fp32 on the bf16 model's own weights (each matrix widened at its
    GEMM: the matrices stay bf16 in memory); bf16 then restores the model
    exactly, since every value was a bf16 value. ``segments=False`` leaves
    the decoder's segments as they are (int8 FSDP shards: their values and
    scales keep their types, and the gather makes bf16 weights, widened
    at their use)."""
    for name, p in params.named_parameters():
        if not segments and name.startswith("segments."):
            continue
        if name.rsplit(".", 1)[-1] not in MATRICES:
            p.data = p.data.to(dtype)


def exact_prefills(ms):
    """True where the engine switches the prefix cache and the bucket
    ladder off and prefills every admission at its exact length: a
    recurrent mixer (its state has no page form) or a mixture of experts
    (as in the JAX engine)."""
    return any(not spec.mixer.startswith("attn") or spec.ffn == "moe"
               for seg in ms.segments for spec in seg.group.specs)


def engine_path(cfg, ms, params, *, fp32_compute=False, parity_new=ENGINE_NEW,
                parity_ms=None):
    """Returns (kernel launches of the timed run, engine metrics, the
    fp32-pool run's streams). The parity run holds the engine's streams in
    an fp32 pool against ``generate``'s, ``parity_new`` tokens each, both
    under ``parity_ms`` (default ``ms``; the MoE models' runs at a capacity
    that drops nothing); with ``fp32_compute`` both compute in fp32 on the
    bf16 weights (``set_compute_dtype``). The timed bf16 run's paged decode
    launches are held against their plain versions (``DecodeProbe``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import PagedEngine, default_buckets

    _, n_pairs = model_counts(ms)
    n_single, n_attn_pairs, n_rec = mixer_counts(ms)
    work = engine_traffic(cfg.vocab_size)
    log(f"[engine] {cfg.name} LP {ms.plan.pairs}: {len(work)} requests, "
        f"{N_SLOTS} slots, pages of {PS}, {N_PAGES} pages, buckets "
        f"{default_buckets(MAX_LEN, PS)}")

    # Parity run: bf16 weights, fp32 pool, streams against generate().
    if fp32_compute:
        set_compute_dtype(params, torch.float32)
    parity_work = engine_traffic(cfg.vocab_size, parity_new)
    pms = parity_ms or ms
    eng = PagedEngine(params, pms, engine_config(torch.float32))
    exact = eng.prefix is None   # prefix cache and buckets off: exact prefills
    if exact != exact_prefills(ms) or (exact and eng._buckets):
        raise AssertionError(f"{cfg.name}: prefix cache {eng.prefix}, buckets "
                             f"{eng._buckets}")
    got = serve(eng, parity_work)
    shared = shared_bucket_launches(eng)
    models = [(params, pms)] * len(parity_work)
    n_equal = held_to("engine", models, parity_work, got,
                      generate_streams(models, parity_work))
    del eng
    if fp32_compute:
        set_compute_dtype(params, torch.bfloat16)
    log(f"[engine] parity (fp32 pool{', fp32 compute' if fp32_compute else ''}, "
        f"{parity_new} new tokens): {n_equal}/{len(parity_work)} streams equal to "
        f"generate on the card; bucket launches holding hit and cold rows "
        f"(hit, cold): {shared}")
    if not shared and not exact:
        raise AssertionError("no bucket launch held both a radix-hit row and a "
                             "cold row")

    # Timed run: bf16 pool, every kernel launch counted.
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16))
    serve(eng, work[:N_SLOTS])                      # warm-up: one wave
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16))
    steps = []
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with DecodeProbe(ms, paged=True) as probe:
        out = serve(eng, work, steps)
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    path_err = probe.check(f"{cfg.name} engine")
    c = dict(eng.counters)
    exact = c["full_prefills"] + c["suffix_prefills"] - c["bucket_prefills"]
    prefill_launches = c["bucket_groups"] + exact
    decode_launches = sum(1 for _, st in steps if st["decoded"])
    want = {"dual_rmsnorm": norm_launches(cfg, n_pairs) * (prefill_launches + decode_launches),
            "decode_attention": 0, "decode_attention_pair": 0,
            "decode_attention_paged": n_single * decode_launches,
            "decode_attention_pair_paged": n_attn_pairs * decode_launches,
            "flash_attention": (n_single + n_attn_pairs) * prefill_launches,
            "ssm_scan": n_rec * prefill_launches}
    log(f"[engine] launches {launches} (want {want}; {prefill_launches} prefill "
        f"and {decode_launches} decode launches by the engine's counters)")
    if launches != want:
        raise AssertionError(f"engine launch counts {launches} != {want}")
    if any(len(o) != ENGINE_NEW or o.min() < 0 or o.max() >= cfg.vocab_size
           for o in out):
        raise AssertionError("engine streams of the wrong length or out of range")
    if exact and (c["bucket_groups"] or c["suffix_prefills"] or c["prefix_hits"]
                      or c["full_prefills"] != c["admitted"]):
        raise AssertionError(f"{cfg.name} engine prefills not all exact and cold: {c}")
    resident = eng.prefix.resident_pages if eng.prefix else 0
    live = eng.pool.live
    if eng.prefix:
        eng.prefix.evict(resident, eng.pool)      # nothing holds a page now
    eng.pool.check_balance()
    log(f"[engine] after drain: pool.live {live} == radix-resident {resident}; "
        f"after evicting the tree pool.live {eng.pool.live}")
    if live != resident or eng.pool.live != 0:
        raise AssertionError("pages still held after drain")
    dec = [dt for dt, st in steps if st["decoded"] and not st["admitted"]]
    dec_tokens = sum(st["decoded"] for _, st in steps
                     if st["decoded"] and not st["admitted"])
    metrics = {"wall_ms": wall_s * 1e3, "steps": len(steps),
               "decode_ms_per_step": sum(dec) / len(dec) * 1e3,
               "decode_tok_per_s": dec_tokens / sum(dec),
               "decoded": c["decoded"],
               "prefill_launches": {"bucket": c["bucket_groups"], "exact": exact},
               "prefix_hits": c["prefix_hits"], "hit_tokens": c["hit_tokens"],
               "pad_tokens": c["pad_tokens"],
               "parity_streams_equal": n_equal, "parity_streams": len(parity_work),
               "parity_new_tokens": parity_new, "shared_bucket_launches": len(shared),
               "decode_path_max_abs_err": path_err}
    log("[engine] " + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                               for k, v in metrics.items()))

    # Profiled window: 8 decode steps with all slots running.
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16))
    for _, prompt, n in work[:N_SLOTS]:
        eng.add_request(prompt, n)
    eng.step()
    eng.step()
    metrics["busy_share"] = profile_decode(lambda: [eng.step() for _ in range(8)],
                                           "engine 8 decode steps")
    return launches, metrics, got


# ---------------------------------------------------------------------------
# phase 8: the speculative and degraded engine paths at full width
# ---------------------------------------------------------------------------

def spec_config(cache_dtype):
    return engine_config(cache_dtype, spec_k=SPEC_K)


def degraded_config(cache_dtype):
    return engine_config(cache_dtype, degrade_delta=True, degrade_slots=DEG_SLOTS,
                         degrade_queue_depth=1, degrade_eff_depth=0)


def timed_serve(eng, work):
    """Serve ``work`` with every kernel launch counted from 0; returns
    (launches, wall seconds, per-step log, streams)."""
    import torch
    from repro_torch.kernels import ops
    steps = []
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = serve(eng, work, steps)
    wall_s = time.perf_counter() - t0
    return dict(ops.LAUNCHES), wall_s, steps, out


def decode_metrics(wall_s, steps):
    """Wall ms and steps; decode ms per step and decoded tok/s over the
    steps that admitted nothing."""
    dec = [dt for dt, st in steps if st["decoded"] and not st["admitted"]]
    dec_tokens = sum(st["decoded"] for _, st in steps
                     if st["decoded"] and not st["admitted"])
    return {"wall_ms": wall_s * 1e3, "steps": len(steps),
            "decode_ms_per_step": sum(dec) / len(dec) * 1e3,
            "decode_tok_per_s": dec_tokens / sum(dec)}


def reconcile(what, launches, want):
    log(f"[{what}] launches {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"{what} launch counts {launches} != {want}")


def spec_path(cfg, ms, params, plain_streams, plain_steps):
    """The speculative engine (k = 4 drafts at plan_range(0, 22), verify at
    40 rows). Returns (launches of the timed bf16 run, metrics)."""
    import torch
    from repro_torch.model.params import tree_map
    from repro_torch.serve import PagedEngine, validate_trace

    work = engine_traffic(cfg.vocab_size)
    n_groups, n_pairs = model_counts(ms)

    # Parity run: fp32 pool, streams against phase 6's plain engine.
    eng = PagedEngine(params, ms, spec_config(torch.float32))
    d_groups, d_pairs = model_counts(eng.ms_draft)
    log(f"[spec] drafter pairs {eng.ms_draft.plan.pairs[0]}..{eng.ms_draft.plan.pairs[-1]} "
        f"({d_pairs} pairs, {d_groups} groups), k={SPEC_K}, verify "
        f"{N_SLOTS * (SPEC_K + 1)} rows")
    if (d_groups, d_pairs) != (11, 11):
        raise AssertionError(f"drafter structure {d_groups} groups, {d_pairs} pairs")
    got = serve(eng, work)
    n_equal = held_to("spec", [(params, ms)] * len(work), work, got, plain_streams)
    c = eng.counters
    log(f"[spec] parity (fp32 pool): {n_equal}/{len(work)} streams equal to the "
        f"plain engine's; verify steps {c['verify_steps']}, accepted "
        f"{c['spec_accepted']}, rewound {c['spec_rewound']}")

    # Timed run: bf16 pool, every launch counted and reconciled.
    serve(PagedEngine(params, ms, spec_config(torch.bfloat16)), work[:N_SLOTS])
    eng = PagedEngine(params, ms, spec_config(torch.bfloat16))
    launches, wall_s, steps, out = timed_serve(eng, work)
    c = dict(eng.counters)
    if c["preempted"] or c["failed"] or c["verify_steps"] * SPEC_K != c["draft_steps"]:
        raise AssertionError(f"spec engine counters {c}")
    exact = c["full_prefills"] + c["suffix_prefills"] - c["bucket_prefills"]
    prefills = c["bucket_groups"] + exact
    # Every main bucket launch has its draft mirror; every request the
    # mirror did not prime (radix hits, exact prefills) gets a full-prompt
    # draft prefill.
    primed = sum(1 for sp in eng.telemetry.spans.values()
                 for e in sp.events_of("prefill")
                 if e.attrs.get("batched") and e.attrs["kind"] == "full")
    draft_prefills = c["bucket_groups"] + c["admitted"] - primed
    v, kd = c["verify_steps"], c["draft_steps"]
    want = {"dual_rmsnorm": 2 * n_pairs * (prefills + v) + 2 * d_pairs * (draft_prefills + kd),
            "decode_attention": 0, "decode_attention_pair": 0,
            "decode_attention_paged": (n_groups - n_pairs) * v + (d_groups - d_pairs) * kd,
            "decode_attention_pair_paged": n_pairs * v + d_pairs * kd,
            "flash_attention": n_groups * prefills + d_groups * draft_prefills,
            "ssm_scan": 0}
    reconcile("spec", launches, want)
    if any(len(o) != ENGINE_NEW or o.min() < 0 or o.max() >= cfg.vocab_size for o in out):
        raise AssertionError("spec engine streams of the wrong length or out of range")
    snap = eng.metrics_snapshot()["spec"]
    metrics = decode_metrics(wall_s, steps)
    metrics.update({k: c[k] for k in ("decoded", "draft_steps", "verify_steps",
                                      "spec_accepted", "spec_rejected", "spec_rewound")})
    metrics.update(accept_per_verify=snap["accept_per_verify"],
                   accept_rate=snap["accept_rate"], draft_prefills=draft_prefills,
                   parity_streams_equal=n_equal, parity_streams=len(work),
                   plain_engine_steps=plain_steps)
    trace = ROOT / "build" / "spec_trace.json"
    trace.parent.mkdir(exist_ok=True)
    eng.dump_trace(str(trace))
    doc = json.loads(trace.read_text())
    validate_trace(doc)
    n_spec = sum(1 for e in doc["traceEvents"] if e.get("cat") == "spec")
    if n_spec != len(eng.telemetry.spec_log) or not n_spec:
        raise AssertionError("trace spec slices != episodes")
    metrics["trace_events"] = len(doc["traceEvents"])
    log(f"[spec] trace {trace.relative_to(ROOT)}: {metrics['trace_events']} events "
        f"({n_spec} spec episodes), valid")
    log("[spec] " + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in metrics.items()))

    # The agreement regime: segments scaled by 0.1 (drafts agree more).
    # fp32 pools: spec streams held against a plain engine on the same
    # weights, with multi-token commits and partial rewinds; bf16: counted.
    tree = params.tree()
    scaled = dict(tree, segments=tree_map(lambda x: x * 0.1, tree["segments"]))
    eng = PagedEngine(scaled, ms, spec_config(torch.float32))
    got = serve(eng, work)
    want = serve(PagedEngine(scaled, ms, engine_config(torch.float32)), work)
    n_scaled = held_to("spec x0.1", [(scaled, ms)] * len(work), work, got, want)
    c = eng.counters
    log(f"[spec] segments x 0.1 parity (fp32 pool): {n_scaled}/{len(work)} streams "
        f"equal to the plain engine's; accepted {c['spec_accepted']}, rejected "
        f"{c['spec_rejected']}, rewound {c['spec_rewound']}")
    if not c["spec_accepted"]:
        raise AssertionError("the x0.1 parity run accepted no draft")
    scaled_fp32 = {"parity_streams_equal": n_scaled, "spec_accepted": c["spec_accepted"],
                   "spec_rejected": c["spec_rejected"], "spec_rewound": c["spec_rewound"]}
    eng = PagedEngine(scaled, ms, spec_config(torch.bfloat16))
    serve(eng, work)
    if not eng.counters["spec_accepted"]:
        raise AssertionError("the x0.1 bf16 run accepted no draft")
    metrics["scaled"] = {"accept_per_verify": eng.metrics_snapshot()["spec"]["accept_per_verify"],
                         "steps": eng.step_count, "plain_engine_steps": plain_steps,
                         "fp32": scaled_fp32}
    log(f"[spec] segments x 0.1: accept_per_verify "
        f"{metrics['scaled']['accept_per_verify']:.3f}, {eng.step_count} engine "
        f"steps (plain engine: {plain_steps})")
    del eng, scaled

    # Profiled window: 8 speculative steps with all slots running.
    eng = PagedEngine(params, ms, spec_config(torch.bfloat16))
    for _, prompt, n in work[:N_SLOTS]:
        eng.add_request(prompt, n)
    eng.step()
    metrics["busy_share"] = profile_decode(lambda: [eng.step() for _ in range(8)],
                                           "spec engine 8 steps")
    return launches, metrics


def cohort_launches(eng, cohort):
    """(prefill launches, decode launches) of one cohort, from the engine's
    spans (no preemption, every prefill bucketed): one bucket launch per
    (step, bucket) of the cohort's batched prefills, one decode launch per
    step in which a request of the cohort was on a slot."""
    from repro_torch.serve import bucket_for
    groups, dec = set(), set()
    for span in eng.telemetry.spans.values():
        if span.cohort != cohort:
            continue
        adm = span.events_of("admitted")[0].step
        dec.update(range(adm, span.events[-1].step + 1))
        for e in span.events_of("prefill"):
            if not e.attrs.get("batched"):
                raise AssertionError("an exact prefill in the degraded run")
            groups.add((e.step, bucket_for(e.attrs["tokens"], eng._buckets)))
    return len(groups), len(dec)


def degraded_path(cfg, ms, params):
    """The degraded-cohort engine (2 of 8 slots at plan_range(0, 22)).
    Returns (launches of the timed bf16 run, metrics)."""
    import torch
    from repro_torch.serve import COHORT_DEGRADED, COHORT_MAIN, PagedEngine

    work = engine_traffic(cfg.vocab_size)
    n_groups, n_pairs = model_counts(ms)

    # Parity run: fp32 pool, each stream against generate at its cohort's plan.
    eng = PagedEngine(params, ms, degraded_config(torch.float32))
    got = serve(eng, work)
    cohorts = [eng.request(r).cohort for r in sorted(eng._requests)]
    models = [(eng.params_deg, eng.ms_deg) if co == COHORT_DEGRADED else (params, ms)
              for co in cohorts]
    n_equal = held_to("degraded", models, work, got, generate_streams(models, work))
    n_deg = cohorts.count(COHORT_DEGRADED)
    log(f"[degraded] parity (fp32 pool): {n_equal}/{len(work)} streams equal to "
        f"generate at their cohort's plan; cohorts: {n_deg} degraded, "
        f"{cohorts.count(COHORT_MAIN)} main, degraded_admissions "
        f"{eng.counters['degraded_admissions']}")
    if not (n_deg and eng.counters["degraded_admissions"] and COHORT_MAIN in cohorts):
        raise AssertionError("the degraded engine did not serve both cohorts")
    g_groups, g_pairs = model_counts(eng.ms_deg)

    # Timed run: bf16 pool, launches reconciled per cohort.
    serve(PagedEngine(params, ms, degraded_config(torch.bfloat16)), work[:N_SLOTS])
    eng = PagedEngine(params, ms, degraded_config(torch.bfloat16))
    launches, wall_s, steps, out = timed_serve(eng, work)
    c = dict(eng.counters)
    if c["preempted"] or c["failed"]:
        raise AssertionError(f"degraded engine counters {c}")
    mp, md = cohort_launches(eng, COHORT_MAIN)
    dp, dd = cohort_launches(eng, COHORT_DEGRADED)
    if mp + dp != c["bucket_groups"]:
        raise AssertionError(f"bucket launches {mp} + {dp} != {c['bucket_groups']}")
    want = {"dual_rmsnorm": 2 * n_pairs * (mp + md) + 2 * g_pairs * (dp + dd),
            "decode_attention": 0, "decode_attention_pair": 0,
            "decode_attention_paged": (n_groups - n_pairs) * md + (g_groups - g_pairs) * dd,
            "decode_attention_pair_paged": n_pairs * md + g_pairs * dd,
            "flash_attention": n_groups * mp + g_groups * dp, "ssm_scan": 0}
    reconcile("degraded", launches, want)
    if any(len(o) != ENGINE_NEW or o.min() < 0 or o.max() >= cfg.vocab_size for o in out):
        raise AssertionError("degraded engine streams of the wrong length or out of range")
    metrics = decode_metrics(wall_s, steps)
    metrics.update(decoded=c["decoded"], degraded_admissions=c["degraded_admissions"],
                   launches_by_cohort={"main": {"prefill": mp, "decode": md},
                                       "degraded": {"prefill": dp, "decode": dd}},
                   parity_streams_equal=n_equal, parity_streams=len(work))
    log("[degraded] " + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                                 for k, v in metrics.items()))
    return launches, metrics


# ---------------------------------------------------------------------------
# phase 7: the Mamba path at full width
# ---------------------------------------------------------------------------

def mamba_model():
    """falcon-mamba-7b cut to MAMBA_LAYERS layers under
    plan_for_depth(MAMBA_EFF_DEPTH), fp32 random weights from the seed,
    made on the card (``init_params`` draws in fp32 and casts, so
    a later cast to bf16 gives the weights a bf16 init would)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.model import transformer as T

    cfg = dataclasses.replace(get_config(MAMBA), n_layers=MAMBA_LAYERS)
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, MAMBA_EFF_DEPTH))
    n_groups = sum(s.count for s in ms.segments)
    if ((n_groups, len(ms.plan.pairs)) != (MAMBA_EFF_DEPTH, MAMBA_LAYERS - MAMBA_EFF_DEPTH)
            or cfg.d_inner != DI):
        raise AssertionError(f"{cfg.name}: {n_groups} groups, pairs {ms.plan.pairs}")
    params = T.init_params(ms, torch.Generator(device="cuda").manual_seed(SEED),
                           torch.float32, device="cuda")
    n_params = sum(v.numel() for v in params.parameters())
    log(f"[mamba] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, d_inner "
        f"{cfg.d_inner}, N {cfg.ssm_state}, vocab {cfg.vocab_size}; pairs "
        f"{ms.plan.pairs[0]}..{ms.plan.pairs[-1]} ({len(ms.plan.pairs)}), "
        f"{n_groups} groups; {n_params / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return cfg, ms, params


def mamba_generate(cfg, ms, params):
    """The Mamba model through ``generate``: B = 4 prompts of 128, 64 new.
    Returns (launches, metrics)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import ServeConfig, generate, make_prefill

    pc = ParallelContext()
    n_groups = sum(s.count for s in ms.segments)
    n_pairs = len(ms.plan.pairs)
    prompts = torch.randint(0, cfg.vocab_size, (B, S),
                            generator=torch.Generator(device="cuda").manual_seed(SEED + 5),
                            device="cuda")
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.bfloat16)
    generate(params, prompts, 2, ms=ms, pc=pc, sv=sv)   # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    timings = {}
    out = generate(params, prompts, N_NEW, ms=ms, pc=pc, sv=sv, timings=timings)
    launches = dict(ops.LAUNCHES)
    steps = N_NEW - 1
    want = {name: 0 for name in launches}
    want.update(ssm_scan=n_groups, dual_rmsnorm=n_pairs * (1 + steps))
    log(f"[mamba] generate launches {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"mamba generate launch counts {launches} != {want}")

    logits, caches = make_prefill(ms, pc, sv)(params, prompts)
    if tuple(out.shape) != (B, N_NEW) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {tuple(out.shape)} out of range")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    dtypes = {(name, str(e.dtype)) for seg in caches for name, e in seg.items()}
    if dtypes != {("conv0", "torch.bfloat16"), ("h0", "torch.float32"),
                  ("conv", "torch.bfloat16"), ("h", "torch.float32")}:
        raise AssertionError(f"cache entries {sorted(dtypes)}")
    tok0 = logits.argmax(-1)
    if not bool((tok0 == out[:, 0]).all()):
        raise AssertionError("first generated token is not the prefill argmax")
    # One decode step on the prefill state vs a prefill of the longer
    # prompt: the recurrence by steps against the scan kernel.
    step_logits, _ = T.decode_step(params, tok0, caches, S, ms=ms, pc=pc)
    longer = torch.cat([prompts, tok0[:, None]], dim=1)
    full_logits, _, _ = T.forward_full(params, longer, ms=ms, pc=pc,
                                       attn_impl=sv.attn_impl)
    scale = full_logits[:, -1].abs().max().item()
    diff = (step_logits - full_logits[:, -1]).abs().max().item()
    log(f"[mamba] decode-step vs prefill logits: max_abs_diff={diff:.4f} "
        f"(logit scale {scale:.3f}, tol 0.1 x scale)")
    if diff > 0.1 * scale:
        raise AssertionError("mamba decode step disagrees with prefill of the same stream")
    del logits, caches, step_logits, full_logits
    e2e = {"prefill_ms": timings["prefill_s"] * 1e3,
           "decode_ms_per_step": timings["decode_s"] / steps * 1e3,
           "decode_tok_per_s": B * steps / timings["decode_s"]}
    log("[mamba] generate " + " ".join(f"{k}={v:.3f}" for k, v in e2e.items()))
    e2e["busy_share"] = profile_decode(
        lambda: generate(params, prompts, 9, ms=ms, pc=pc, sv=sv),
        "mamba generate(9 new)")
    return launches, e2e


def mamba_engine_parity(cfg, ms, params):
    """fp32 weights and pool: the engine's streams against ``generate``'s on
    the card, with phase 6's traffic. Returns the count of equal streams."""
    import torch
    from repro_torch.serve import PagedEngine

    work = engine_traffic(cfg.vocab_size)
    eng = PagedEngine(params, ms, engine_config(torch.float32))
    if eng.prefix is not None or eng._buckets:
        raise AssertionError("prefix cache or bucket ladder on for a recurrent mixer")
    got = serve(eng, work)
    models = [(params, ms)] * len(work)
    n_equal = held_to("mamba", models, work, got, generate_streams(models, work))
    log(f"[mamba] engine parity (fp32 weights and pool): {n_equal}/{len(work)} "
        f"streams equal to generate on the card")
    return n_equal


def mamba_engine(cfg, ms, params):
    """The Mamba model (bf16) behind ``PagedEngine`` with phase 6's geometry
    and traffic. Returns (launches of the timed run, metrics)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import PagedEngine

    n_groups = sum(s.count for s in ms.segments)
    n_pairs = len(ms.plan.pairs)
    work = engine_traffic(cfg.vocab_size)

    # Timed run: bf16 pool (the state h stays fp32), every launch counted.
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16))
    serve(eng, work[:N_SLOTS])                      # warm-up: one wave
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16))
    steps = []
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = serve(eng, work, steps)
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    c = dict(eng.counters)
    prefills = c["full_prefills"]
    decode_launches = sum(1 for _, st in steps if st["decoded"])
    want = {name: 0 for name in launches}
    want.update(ssm_scan=n_groups * prefills,
                dual_rmsnorm=n_pairs * (prefills + decode_launches))
    log(f"[mamba] engine launches {launches} (want {want}; {prefills} exact "
        f"prefills for {c['admitted']} admissions, {decode_launches} decode launches)")
    if launches != want:
        raise AssertionError(f"mamba engine launch counts {launches} != {want}")
    if (prefills != c["admitted"] or c["bucket_groups"] or c["suffix_prefills"]
            or c["prefix_hits"]):
        raise AssertionError(f"mamba engine prefills not all exact and cold: {c}")
    if any(len(o) != ENGINE_NEW or o.min() < 0 or o.max() >= cfg.vocab_size
           for o in out):
        raise AssertionError("engine streams of the wrong length or out of range")
    if eng.pool.live != 0:
        raise AssertionError("pages still held after drain")
    dec = [dt for dt, st in steps if st["decoded"] and not st["admitted"]]
    dec_tokens = sum(st["decoded"] for _, st in steps
                     if st["decoded"] and not st["admitted"])
    metrics = {"wall_ms": wall_s * 1e3, "steps": len(steps),
               "decode_ms_per_step": sum(dec) / len(dec) * 1e3,
               "decode_tok_per_s": dec_tokens / sum(dec),
               "decoded": c["decoded"],
               "prefill_launches": {"bucket": 0, "exact": prefills},
               "prefix_hits": c["prefix_hits"]}
    log("[mamba] engine " + " ".join(
        f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in metrics.items()))

    # Profiled window: 8 decode steps with all slots running.
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16))
    for _, prompt, n in work[:N_SLOTS]:
        eng.add_request(prompt, n)
    eng.step()
    eng.step()
    metrics["busy_share"] = profile_decode(lambda: [eng.step() for _ in range(8)],
                                           "mamba engine 8 decode steps")
    return launches, metrics


def mamba_path():
    """Phase 7: engine parity in fp32, then generate and the timed engine in
    bf16. Returns (generate's launches, the engine's launches, their
    metrics)."""
    import torch
    cfg, ms, params = mamba_model()
    n_equal = mamba_engine_parity(cfg, ms, params)
    params.to(torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    gen_launches, gen = mamba_generate(cfg, ms, params)
    eng_launches, eng = mamba_engine(cfg, ms, params)
    eng.update(parity_streams_equal=n_equal,
               parity_streams=len(engine_traffic(cfg.vocab_size)))
    return gen_launches, eng_launches, gen, eng


# ---------------------------------------------------------------------------
# phase 9: the dense family at full width
# ---------------------------------------------------------------------------

def dense_path(name):
    """Phase 9: ``name`` at its published widths, 3/4 of its layers' depth
    under plan_for_depth, bf16 random weights made on the card from the
    seed: phase 5's ``generate`` traffic, then phase 6's engine (fp32-pool
    streams held to ``generate`` under the near-tie rule, a timed bf16-pool
    run reconciled with the counters, a profiled window). Returns
    (generate's launches, the engine's launches, metrics)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.model import transformer as T

    import dataclasses
    cfg = get_config(name)
    if name in DENSE_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=DENSE_LAYERS[name])
    depth = cfg.n_layers * 3 // 4
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, depth))
    n_groups, n_pairs = model_counts(ms)
    if (n_groups, n_pairs) != (depth, cfg.n_layers - depth):
        raise AssertionError(f"{name}: {n_groups} groups, {n_pairs} pairs")
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(ms, torch.Generator(device="cuda").manual_seed(SEED),
                           torch.bfloat16, device="cuda")
    n_params = sum(v.numel() for v in params.parameters())
    weights_gib = torch.cuda.memory_allocated() / 2**30
    log(f"[dense] {name}: {cfg.n_layers} layers at depth {depth} ({n_pairs} pairs); "
        f"{n_params / 1e9:.3f} B parameters, {weights_gib:.2f} GiB on the card; "
        f"init peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    gen_launches, gen = generate_path(name, cfg, ms, params)
    # granite's fp32-compute parity widens 32 GiB of weights at every GEMM:
    # its streams are held over 8 new tokens, not 32, to keep the script's
    # time (the schedule still shares bucket launches between hit and cold
    # rows).
    parity_new = 8 if name == "granite-34b" else ENGINE_NEW
    eng_launches, eng, _ = engine_path(cfg, ms, params, fp32_compute=True,
                                       parity_new=parity_new)
    for path, launches, decode in (("generate", gen_launches, "decode_attention_pair"),
                                   ("engine", eng_launches, "decode_attention_pair_paged")):
        for kernel in ("flash_attention", decode):
            if not launches[kernel]:
                raise AssertionError(f"{kernel} was not launched on {name} {path}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[dense] {name}: max_memory_allocated {peak:.2f} GiB")
    return gen_launches, eng_launches, {
        "layers": cfg.n_layers, "depth": depth, "pairs": n_pairs,
        "params_b": n_params / 1e9, "weights_gib": weights_gib,
        "max_memory_allocated_gib": peak, "generate": gen, "engine": eng}


# ---------------------------------------------------------------------------
# phase 10: the hybrid family (recurrentgemma-9b) at full width
# ---------------------------------------------------------------------------

def hybrid_path():
    """Phase 10: LP recurrentgemma-9b at full width cut to HYBRID_LAYERS
    layers under plan_for_depth(HYBRID_EFF_DEPTH), bf16 random weights made
    on the card from the seed:
    phase 5's ``generate`` traffic, phase 6's engine (the prefix cache
    requested and off: exact prefills; streams held to ``generate`` in fp32
    compute on the bf16 weights), and the window run. Returns (launches of
    generate, the engine and the window run, metrics)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.model import transformer as T

    import dataclasses
    cfg = dataclasses.replace(get_config(HYBRID), n_layers=HYBRID_LAYERS)
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, HYBRID_EFF_DEPTH))
    counts = (model_counts(ms), mixer_counts(ms))
    n_pairs, n_attn = HYBRID_LAYERS - HYBRID_EFF_DEPTH, HYBRID_LAYERS // 3
    want = ((HYBRID_EFF_DEPTH, n_pairs),
            (n_attn, 0, HYBRID_LAYERS - n_attn - n_pairs))
    if counts != want or cfg.window != WINDOW:
        raise AssertionError(f"{cfg.name}: (groups, pairs), (attention singles, "
                             f"attention pairs, recurrent groups) = {counts}")
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(ms, torch.Generator(device="cuda").manual_seed(SEED),
                           torch.bfloat16, device="cuda")
    n_params = sum(v.numel() for v in params.parameters())
    weights_gib = torch.cuda.memory_allocated() / 2**30
    log(f"[hybrid] {cfg.name}: {cfg.n_layers} layers at depth {HYBRID_EFF_DEPTH} "
        f"({n_pairs} rec pairs, {want[1][2] - n_pairs} single rec, {n_attn} single "
        f"attn_local); "
        f"{n_params / 1e9:.3f} B parameters, {weights_gib:.2f} GiB on the card")
    gen_launches, gen = generate_path(cfg.name, cfg, ms, params)
    eng_launches, eng, _ = engine_path(cfg, ms, params, fp32_compute=True)
    win_launches, win = ring_run(cfg, ms, params, what=f"{cfg.name} window run",
                                 kind="window", ring=WINDOW,
                                 prompt_len=WINDOW_PROMPT, n_new=WINDOW_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[hybrid] {cfg.name}: max_memory_allocated {peak:.2f} GiB")
    return gen_launches, eng_launches, win_launches, {
        "layers": cfg.n_layers, "depth": HYBRID_EFF_DEPTH, "pairs": len(ms.plan.pairs),
        "params_b": n_params / 1e9, "weights_gib": weights_gib,
        "max_memory_allocated_gib": peak, "generate": gen, "engine": eng, "window": win}


def ring_run(cfg, ms, params, *, what, kind, ring, prompt_len, n_new, check=None):
    """A prompt of ``prompt_len`` = ring + 256 tokens at B = 1 through
    ``generate`` (bf16, ``n_new`` new tokens): the prefill's window or
    chunk mask (``kind``, span ``ring``) cuts the late rows, and every
    decode step reads a ring that has wrapped. The first attention layer's
    flash launch and its decode launches at steps 0 and 8 are copied and
    held against their plain versions (the flash kv head by kv head); the
    launches reconcile. Then, in fp32 compute on the same weights, prefill
    + one decode step equals the full forward over the prompt and the new
    token within WINDOW_TOL, on ``check`` = (structure, weights) (default
    the run's own). Returns (launches, metrics)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import ServeConfig, generate, make_prefill

    pc = ParallelContext()
    _, n_pairs = model_counts(ms)
    n_single, n_attn_pairs, n_rec = mixer_counts(ms)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 7),
                           device="cuda")
    sv = ServeConfig(max_len=prompt_len + n_new, cache_dtype=torch.bfloat16)
    generate(params, prompt, 2, ms=ms, pc=pc, sv=sv)   # warm-up
    flash_kept = []
    flash = ops.flash_attention

    def first_flash(*args, **kw):
        out = flash(*args, **kw)
        if not flash_kept:
            flash_kept.append(([a.clone() for a in args], dict(kw), out.clone()))
        return out
    torch.cuda.synchronize()
    ops.reset_launches()
    timings = {}
    ops.flash_attention = first_flash
    try:
        with DecodeProbe(ms, paged=False, steps=(0, 8)) as probe:
            out = generate(params, prompt, n_new, ms=ms, pc=pc, sv=sv,
                           timings=timings)
    finally:
        ops.flash_attention = flash
    launches = dict(ops.LAUNCHES)
    steps = n_new - 1
    want = {name: 0 for name in launches}
    want.update(flash_attention=n_single + n_attn_pairs, ssm_scan=n_rec,
                decode_attention=steps * n_single,
                decode_attention_pair=steps * n_attn_pairs,
                dual_rmsnorm=norm_launches(cfg, n_pairs) * (1 + steps))
    reconcile(what, launches, want)
    if tuple(out.shape) != (1, n_new) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"{what} tokens {tuple(out.shape)} out of range")
    decode_err = probe.check(what)
    (q, k, v), kw, got = flash_kept[0]
    if kw.get("kind") != kind or q.shape[1] != prompt_len:
        raise AssertionError(f"{what} flash launch {kw} at {tuple(q.shape)}")
    want_o = torch.cat([ops.flash_attention_plain(q[:, :, h:h + 1], k[:, :, h:h + 1],
                                                  v[:, :, h:h + 1], **kw)
                        for h in range(q.shape[2])], dim=2)
    flash_err = compare(f"[{what}] flash_attention, prefill of {prompt_len}, on the "
                        f"model path", got, want_o, BF16_TOL)
    del flash_kept, q, k, v, got, want_o

    cms, cparams = check or (ms, params)
    set_compute_dtype(params, torch.float32)
    try:
        sv32 = ServeConfig(max_len=prompt_len + n_new, cache_dtype=torch.float32)
        logits, caches = make_prefill(cms, pc, sv32)(cparams, prompt)
        tok0 = logits.argmax(-1)
        step_logits, _ = T.decode_step(cparams, tok0, caches, prompt_len, ms=cms, pc=pc)
        del caches
        full, _, _ = T.forward_full(cparams, torch.cat([prompt, tok0[:, None]], dim=1),
                                    ms=cms, pc=pc, attn_impl=sv32.attn_impl)
        full = full[:, -1]
        diff = (step_logits - full).abs().max().item()
        scale = full.abs().max().item()
        del logits, step_logits, full
    finally:
        set_compute_dtype(params, torch.bfloat16)
    log(f"[{what}] fp32 compute, {cms.cfg.n_layers} layers: prefill of {prompt_len} "
        f"+ one decode step (ring of {ring}, wrapped) vs the full forward over "
        f"{prompt_len + 1} tokens: logits max_abs_diff={diff:.3e} (logit scale "
        f"{scale:.3f}, tol {WINDOW_TOL:g})")
    if diff > WINDOW_TOL:
        raise AssertionError(f"{what}: the ring's decode step disagrees with the full "
                             "forward")
    metrics = {"prompt": prompt_len, "new_tokens": n_new,
               "prefill_ms": timings["prefill_s"] * 1e3,
               "decode_ms_per_step": timings["decode_s"] / steps * 1e3,
               "flash_path_max_abs_err": flash_err, "decode_path_max_abs_err": decode_err,
               "fp32_decode_vs_full_max_abs_diff": diff, "logit_scale": scale,
               "fp32_check_layers": cms.cfg.n_layers}
    log(f"[{what}] " + " ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in metrics.items()))
    return launches, metrics


# ---------------------------------------------------------------------------
# phase 11: the MoE family (dbrx-132b, llama4-scout) at full width
# ---------------------------------------------------------------------------

def moe_model(name, plan_pairs=None):
    """``name`` at its published widths cut to ``MOE_LAYERS`` layers, under
    plan_for_depth(MOE_EFF_DEPTH[name]) or the given pairs, bf16 random weights
    made on the card from the seed. Returns (cfg, ms, params)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import LPPlan, plan_for_depth
    from repro_torch.model import transformer as T

    cfg = dataclasses.replace(get_config(name), n_layers=MOE_LAYERS)
    plan = LPPlan(plan_pairs) if plan_pairs else plan_for_depth(cfg, MOE_EFF_DEPTH[name])
    ms = T.build_structure(cfg, plan=plan)
    params = T.init_params(ms, torch.Generator(device="cuda").manual_seed(SEED),
                           torch.bfloat16, device="cuda")
    return cfg, ms, params


def no_drops(ms):
    """``ms`` at the capacity factor E/k, where C >= T and nothing drops."""
    import dataclasses
    from repro_torch.model import transformer as T
    cfg = ms.cfg
    return T.build_structure(dataclasses.replace(
        cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k), plan=ms.plan,
        tp=ms.tp)


def first_moe_drops(ms, params):
    """Share of slots the capacity drops in the first MoE layer of one
    prefill of generate's prompts (B = 4 x 128): its dispatch recomputed
    from that layer's own inputs."""
    import torch
    from repro_torch.model import moe as MOE
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import ServeConfig, make_prefill

    prompts = torch.randint(0, ms.cfg.vocab_size, (B, S),
                            generator=torch.Generator(device="cuda").manual_seed(SEED + 5),
                            device="cuda")
    seen, single = [], MOE._moe_single

    def probe(p, xn, cfg, pc):
        if not seen:
            x = xn.reshape(-1, xn.shape[-1])
            idx, _, _ = MOE._route(x @ p["router"].to(x.dtype), cfg)
            keep = MOE.slot_positions(idx, cfg)[2]
            seen.append((int((~keep).sum()), keep.numel(), MOE.capacity(x.shape[0], cfg)))
        return single(p, xn, cfg, pc)
    MOE._moe_single = probe
    try:
        make_prefill(ms, ParallelContext(), ServeConfig(max_len=MAX_LEN))(params, prompts)
    finally:
        MOE._moe_single = single
    dropped, slots, cap = seen[0]
    log(f"[moe] {ms.cfg.name} first MoE layer, prefill of {B} x {S} at capacity "
        f"factor {ms.cfg.moe_capacity_factor}: C = {cap}, {dropped} of {slots} slots "
        f"dropped ({dropped / slots:.4f})")
    return dropped / slots


class FlashKinds:
    """While on, counts the flash launches of each mask kind (no launch is
    added)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.kinds, self.orig = {}, ops.flash_attention

        def count(*args, **kw):
            kind = kw.get("kind", "causal")
            self.kinds[kind] = self.kinds.get(kind, 0) + 1
            return self.orig(*args, **kw)
        ops.flash_attention = count
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention = self.orig


def moe_path(name):
    """Phase 11: ``name`` at its published widths, cut to MOE_LAYERS layers,
    bf16 random weights made on the card from the seed: phase 5's
    ``generate`` traffic at the published capacity factor (1.25; the share
    of slots dropped in the first MoE layer's prefill printed), then phase
    6's engine (exact prefills: the prefix cache and bucket ladder switch
    off for a mixture of experts, as in the JAX engine; fp32-pool streams
    held to ``generate`` in fp32 compute at the capacity factor E/k, where
    nothing drops; a timed bf16-pool run at 1.25 reconciled with the
    counters, its decode launches held against their plain versions). For
    llama4 the chunk run sits between the two, and the engine runs on new
    weights from the seed under LLAMA4_ENGINE_PAIRS. Returns ({path:
    launches}, metrics)."""
    import torch
    llama4 = name == LLAMA4
    torch.cuda.reset_peak_memory_stats()
    cfg, ms, params = moe_model(name)
    n_params = sum(v.numel() for v in params.parameters())
    weights_gib = torch.cuda.memory_allocated() / 2**30
    log(f"[moe] {name}: {cfg.n_layers} layers (cut), d {cfg.d_model}, {cfg.moe_experts} "
        f"experts top {cfg.moe_top_k}{' + shared' if cfg.moe_shared_expert else ''}, "
        f"d_ff {cfg.d_ff}; pairs {ms.plan.pairs} "
        f"{[[s.mixer for s in seg.group.specs] for seg in ms.segments if seg.group.pair]}; "
        f"{n_params / 1e9:.3f} B parameters, {weights_gib:.2f} GiB on the card")
    if ms.plan.pairs != MOE_PAIRS[name]:
        raise AssertionError(f"{name}: pairs {ms.plan.pairs}")
    metrics = {"layers": cfg.n_layers, "pairs": list(ms.plan.pairs),
               "params_b": n_params / 1e9, "weights_gib": weights_gib,
               "first_layer_drop_share": first_moe_drops(ms, params)}
    by_path = {}
    with FlashKinds() as kinds:
        by_path["generate"], metrics["generate"] = generate_path(
            name, cfg, ms, params, check_ms=no_drops(ms))
    log(f"[moe] {name} generate: flash launches by mask kind {kinds.kinds}")
    want_kinds = {"causal", "chunk"} if llama4 else {"causal"}
    if set(kinds.kinds) != want_kinds:
        raise AssertionError(f"{name} generate flash kinds {kinds.kinds}")
    if llama4:
        # The fp32 check at the capacity factor E/k: a prefill drops slots
        # that a decode step keeps.
        by_path["chunk"], metrics["chunk_run"] = ring_run(
            cfg, ms, params, what=f"{name} chunk run", kind="chunk", ring=CHUNK,
            prompt_len=CHUNK_PROMPT, n_new=CHUNK_NEW, check=(no_drops(ms), params))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        cfg, ms, params = moe_model(name, LLAMA4_ENGINE_PAIRS)
    by_path["engine"], metrics["engine"], _ = engine_path(
        cfg, ms, params, fp32_compute=True, parity_new=8, parity_ms=no_drops(ms))
    metrics["engine"]["pairs"] = list(ms.plan.pairs)
    for path, names in (("generate", ("flash_attention", "decode_attention",
                                      "decode_attention_pair")),
                        ("engine", ("flash_attention", "decode_attention_paged",
                                    "decode_attention_pair_paged"))):
        for kernel in names + (("dual_rmsnorm",) if llama4 else ()):
            if not by_path[path][kernel]:
                raise AssertionError(f"{kernel} was not launched on {name} {path}")
    metrics["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[moe] {name}: max_memory_allocated {metrics['max_memory_allocated_gib']:.2f} GiB")
    del params
    return by_path, metrics


# ---------------------------------------------------------------------------
# phase 12: the prefix-LM (paligemma-3b) and encoder-decoder (whisper-medium)
# ---------------------------------------------------------------------------

def prefix_lm_path():
    """Phase 12a: LP paligemma-3b at full width (18 layers under
    plan_for_depth(14): 4 pairs, 10 single layers), bf16 random weights
    made on the card from the seed, through ``generate``: 4 prompts of 128
    behind 256 patch embeddings (0.02 N(0, 1) from the seed), 64 new, a
    ring cache of 512; the launches reconcile with the plan, the decode
    launches at steps 0 and 40 are held against their plain versions, and
    flash runs the causal mask with the prefix. Returns (launches,
    metrics)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.model import transformer as T

    cfg = get_config(PALI)
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, PALI_EFF_DEPTH))
    counts = (model_counts(ms), mixer_counts(ms))
    if counts != ((14, 4), (10, 4, 0)) or cfg.prefix_len != PALI_PREFIX:
        raise AssertionError(f"{cfg.name}: (groups, pairs), (attention singles, "
                             f"attention pairs, recurrent groups) = {counts}")
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(ms, torch.Generator(device="cuda").manual_seed(SEED),
                           torch.bfloat16, device="cuda")
    n_params = sum(v.numel() for v in params.parameters())
    weights_gib = torch.cuda.memory_allocated() / 2**30
    log(f"[prefix-lm] {cfg.name}: {cfg.n_layers} layers at depth {PALI_EFF_DEPTH} "
        f"(pairs {ms.plan.pairs}); {n_params / 1e9:.3f} B parameters, "
        f"{weights_gib:.2f} GiB on the card")
    prefix = (0.02 * torch.randn((B, PALI_PREFIX, cfg.d_model), device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(SEED + 7))
              ).to(torch.bfloat16)
    with FlashKinds() as kinds:
        launches, gen = generate_path(cfg.name, cfg, ms, params, inputs={"prefix": prefix},
                                      max_len=PALI_MAX_LEN)
    log(f"[prefix-lm] {cfg.name} generate: flash launches by mask kind {kinds.kinds}")
    if set(kinds.kinds) != {"causal"}:
        raise AssertionError(f"{cfg.name} flash kinds {kinds.kinds}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[prefix-lm] {cfg.name}: max_memory_allocated {peak:.2f} GiB")
    return launches, {"layers": cfg.n_layers, "depth": PALI_EFF_DEPTH,
                      "pairs": list(ms.plan.pairs), "prefix": PALI_PREFIX,
                      "params_b": n_params / 1e9, "weights_gib": weights_gib,
                      "max_memory_allocated_gib": peak, "generate": gen}


def encdec_path():
    """Phase 12b: LP whisper-medium at full width (24 encoder layers; 24
    decoder layers under plan_for_depth(18): 6 pairs, 12 single layers),
    bf16 random weights made on the card from the seed, through
    ``generate``: frames [4, 1500, 1024] (N(0, 1) from the seed), 4 prompts
    of 32, 64 new, a ring cache of 128; the encoder timed on its own; the
    launches reconcile (flash: 24 encoder layers, 18 self- and 18
    cross-attention launches per prefill, and 18 cross-attention launches
    of one query row per decode step), the decode launches at steps 0 and
    40 are held against their plain versions. Returns (launches,
    metrics)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext

    cfg = get_config(WHISPER)
    ms = T.build_structure(cfg, plan=plan_for_depth(cfg, WHISPER_EFF_DEPTH))
    counts = (model_counts(ms), mixer_counts(ms), sum(s.count for s in ms.enc_segments))
    if counts != ((18, 6), (12, 6, 0), 24) or cfg.enc_seq != ENC_SEQ:
        raise AssertionError(f"{cfg.name}: (groups, pairs), (attention singles, "
                             f"attention pairs, recurrent groups), encoder layers "
                             f"= {counts}")
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(ms, torch.Generator(device="cuda").manual_seed(SEED),
                           torch.bfloat16, device="cuda")
    n_params = sum(v.numel() for v in params.parameters())
    weights_gib = torch.cuda.memory_allocated() / 2**30
    log(f"[encdec] {cfg.name}: {cfg.enc_layers} encoder + {cfg.n_layers} decoder "
        f"layers, decoder depth {WHISPER_EFF_DEPTH} (pairs {ms.plan.pairs}); "
        f"{n_params / 1e9:.3f} B parameters, {weights_gib:.2f} GiB on the card")
    frames = torch.randn((B, ENC_SEQ, cfg.d_model), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(SEED + 8)
                         ).to(torch.bfloat16)
    pc = ParallelContext()
    T._encoder(params, frames, ms, pc, attn_impl="chunked:16")   # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        T._encoder(params, frames, ms, pc, attn_impl="chunked:16")
    end.record()
    torch.cuda.synchronize()
    encoder_ms = start.elapsed_time(end) / 3
    log(f"[encdec] {cfg.name} encoder alone ({cfg.enc_layers} layers, {B} x {ENC_SEQ} "
        f"frames): {encoder_ms:.3f} ms")
    with FlashKinds() as kinds:
        launches, gen = generate_path(cfg.name, cfg, ms, params, inputs={"frames": frames},
                                      prompt_len=WHISPER_PROMPT, max_len=WHISPER_MAX_LEN)
    log(f"[encdec] {cfg.name} generate: flash launches by mask kind {kinds.kinds}")
    if set(kinds.kinds) != {"causal", "bidir"}:
        raise AssertionError(f"{cfg.name} flash kinds {kinds.kinds}")
    gen["encoder_ms"] = encoder_ms
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[encdec] {cfg.name}: max_memory_allocated {peak:.2f} GiB")
    return launches, {"enc_layers": cfg.enc_layers, "layers": cfg.n_layers,
                      "depth": WHISPER_EFF_DEPTH, "pairs": list(ms.plan.pairs),
                      "params_b": n_params / 1e9, "weights_gib": weights_gib,
                      "max_memory_allocated_gib": peak, "generate": gen}



# ---------------------------------------------------------------------------
# phase 13: LP-only recovery fine-tuning (launch.train) and its checks
# ---------------------------------------------------------------------------

def train_cut_parity():
    """Phase 13a: tinyllama-1.1b at its published widths cut to 2 layers,
    one LP pair (0, 1), fp32 (TF32 off), B = 2 x S = 64 from the seed. The
    card's loss (within TRAIN_LOSS_TOL), every leaf's gradient (within
    TRAIN_GRAD_TOL of that leaf's largest |g|) and one AdamW step (each
    master weight within 2 lr of the CPU's, Adam's step being about
    lr sign(g) where g is near 0; 99.9% within 1e-6) equal the CPU's; the
    card's state saved as a checkpoint and restored comes back bit for
    bit. Returns metrics."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_range
    from repro_torch.model import transformer as T
    from repro_torch.model.params import tree_items, tree_leaves, tree_map
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.train import OptConfig, TrainConfig, checkpoint as CK
    from repro_torch.train.trainer import make_train_step, state_from_params

    pc = ParallelContext()
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2)
    ms = T.build_structure(cfg, plan=plan_range(cfg, 0, 2))
    if ms.plan.pairs != ((0, 1),):
        raise AssertionError(f"pairs {ms.plan.pairs}")
    p_cpu = T.init_params(ms, torch.Generator().manual_seed(SEED), torch.float32,
                          device="cpu").tree()
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_CUT_B, TRAIN_CUT_S + 1),
                         generator=torch.Generator().manual_seed(SEED + 9))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    tc = TrainConfig(opt=OptConfig(lr=TRAIN_CUT_LR, warmup_steps=0,
                                   total_steps=10, weight_decay=0.01,
                                   schedule="const"))
    for dev in ("cpu", "cuda"):
        w = tree_map(lambda x: x.to(dev, copy=True).requires_grad_(True), p_cpu)
        b = {k: x.to(dev) for k, x in batch.items()}
        loss, _ = T.loss_fn(w, b, ms=ms, pc=pc, differentiable=True)
        grads = torch.autograd.grad(loss, tree_leaves(w))
        state = state_from_params(w, ms, pc, tc)
        state, m = make_train_step(ms, pc, tc)(state, b)
        out[dev] = (loss.detach().cpu(), [g.cpu() for g in grads], state,
                    float(m["grad_norm"]))
    l_cpu, g_cpu, s_cpu, n_cpu = out["cpu"]
    l_gpu, g_gpu, s_gpu, n_gpu = out["cuda"]
    loss_err = abs(l_gpu.item() - l_cpu.item())
    grad_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                   for a, b in zip(g_gpu, g_cpu))
    d = torch.cat([(a.cpu() - b).abs().reshape(-1) for a, b in
                   zip(tree_leaves(s_gpu["master"]), tree_leaves(s_cpu["master"]))])
    step_err, bulk = d.max().item(), (d <= 1e-6).float().mean().item()
    log(f"[train cut] {cfg.name} 2 layers, pair (0, 1), fp32, B {TRAIN_CUT_B} x S "
        f"{TRAIN_CUT_S}: loss card {l_gpu.item():.6f} cpu {l_cpu.item():.6f} "
        f"(err {loss_err:.3e}, tol {TRAIN_LOSS_TOL:g}); grads max err / leaf max "
        f"{grad_err:.3e} (tol {TRAIN_GRAD_TOL:g}); grad norm {n_gpu:.6f} / {n_cpu:.6f}; "
        f"one AdamW step: master max err {step_err:.3e} (bound 2 lr = "
        f"{2 * TRAIN_CUT_LR:g}), {bulk:.6f} of elements within 1e-6 (want >= 0.999)")
    if (loss_err > TRAIN_LOSS_TOL or grad_err > TRAIN_GRAD_TOL
            or step_err > 2 * TRAIN_CUT_LR or bulk < 0.999):
        raise AssertionError("the train step on the card disagrees with the CPU's")
    del out, s_cpu, g_cpu, g_gpu
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    CK.save(str(ckpt), s_gpu, s_gpu["step"])
    back = CK.logical_to_state(CK.restore(str(ckpt), CK.logical_like(ms)), ms, pc,
                               tc, device="cuda")
    same = back["step"] == s_gpu["step"] and all(
        torch.equal(a, b) for key in ("master", "m", "v")
        for a, b in zip(tree_leaves(back[key]), tree_leaves(s_gpu[key]))) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(back["params"].tree()),
                                          tree_leaves(s_gpu["params"].tree())))
    n_files = len(tree_items(CK.logical_like(ms)))
    log(f"[train cut] checkpoint of the card's state ({n_files} leaves) restored "
        f"on the card bit for bit: {same}")
    if not same:
        raise AssertionError("checkpoint round trip changed the state")
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"loss_max_abs_err": loss_err, "grad_max_rel_err": grad_err,
            "adamw_master_max_abs_err": step_err, "adamw_within_1e-6": bulk,
            "checkpoint_bit_for_bit": same}


def train_path():
    """Phase 13b: LP-only recovery fine-tuning (paper Table 2's recipe:
    AdamW, linear decay from 1e-4, wd 0.01, warmup 10) of tinyllama-1.1b at
    its published widths, all 22 layers, plan_for_depth(16), bf16 params
    with fp32 master weights and moments, random weights from the seed:
    TRAIN_STEPS steps of B = TRAIN_B x S = TRAIN_S from the port's
    synthetic source through ``launch.train.train_loop``. The training
    forward launches no kernel; the frozen leaves stay bit-identical; the
    eval step (kernels, no_grad) agrees with the differentiable loss
    within TRAIN_EVAL_TOL; then the fine-tuned weights serve 4 prompts of
    128 through ``generate``. Launches of the eval and of ``generate``
    reconcile exactly. Returns (launches, metrics)."""
    import statistics
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import RunConfig, build, train_loop
    from repro_torch.model import transformer as T
    from repro_torch.model.params import tree_items
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import ServeConfig, generate
    from repro_torch.train.trainer import init_state, make_eval_step, make_train_step

    rc = RunConfig(arch="tinyllama-1.1b", reduced=False, eff_depth=16,
                   steps=TRAIN_STEPS, seq_len=TRAIN_S, global_batch=TRAIN_B,
                   lr=1e-4, warmup=10, schedule="linear", weight_decay=0.01,
                   finetune_lp_only=True, param_dtype="bfloat16", log_every=1,
                   seed=SEED, device="cuda")
    cfg, ms, tc, src = build(rc)
    n_groups, n_pairs = model_counts(ms)
    if (n_groups, n_pairs, cfg.n_layers) != (16, 6, 22):
        raise AssertionError(f"groups, pairs, layers {n_groups, n_pairs, cfg.n_layers}")
    pc = ParallelContext()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(ms, torch.Generator(device="cuda").manual_seed(SEED), pc, tc,
                       device="cuda")
    items = tree_items(state["params"].tree())
    frozen = {path: p.detach().clone() for path, p in items if not p.requires_grad}
    trainable = {path: p.detach().clone() for path, p in items if p.requires_grad}
    n_train = sum(p.numel() for p in trainable.values())
    n_all = sum(p.numel() for _, p in items)
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, pairs {ms.plan.pairs}, "
        f"{n_all / 1e9:.3f} B parameters ({n_train / 1e9:.3f} B trainable, "
        f"{len(trainable)} of {len(items)} leaves), bf16 params + fp32 master/m/v; "
        f"{TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S}")
    marks = []

    def tick(step, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    ops.reset_launches()
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    out = train_loop(rc, state=state, hook=tick)
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"the training forward launched kernels {ops.LAUNCHES}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    med = statistics.median(step_ms[1:])
    losses = [h["loss"] for h in out["history"]]
    log(f"[train] ms per step {['%.1f' % t for t in step_ms]}; median of steps 2-"
        f"{TRAIN_STEPS} {med:.3f} ms, {TRAIN_B * TRAIN_S / med * 1e3:.0f} tokens/s; "
        f"max_memory_allocated {peak:.2f} GiB; loss per step "
        f"{['%.4f' % x for x in losses]}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    items = dict(tree_items(state["params"].tree()))
    moved = [p for p, x in trainable.items() if not torch.equal(items[p], x)]
    still = [p for p, x in frozen.items() if not torch.equal(items[p], x)]
    log(f"[train] frozen leaves bit-identical: {len(frozen) - len(still)}/{len(frozen)}; "
        f"trainable leaves moved: {len(moved)}/{len(trainable)}")
    if still or len(moved) < len(trainable) // 2:
        raise AssertionError(f"frozen leaves moved {still}, trainable moved {len(moved)}")
    del frozen, trainable

    busy = profile_decode(lambda: make_train_step(ms, pc, tc)(
        state, {k: x.cuda() for k, x in src.batch_at(TRAIN_STEPS).items()}),
        f"{cfg.name} one LP-only train step")
    ops.reset_launches()
    batch = {k: x.cuda() for k, x in src.batch_at(TRAIN_STEPS + 1).items()}
    ev = make_eval_step(ms, pc)(state["params"], batch)["loss"].item()
    with torch.no_grad():
        tl = T.loss_fn(state["params"], batch, ms=ms, pc=pc,
                       differentiable=True)[0].item()
    log(f"[train] eval step (kernels, no_grad) loss {ev:.6f}; differentiable "
        f"forward loss {tl:.6f}; |diff| {abs(ev - tl):.3e} (tol {TRAIN_EVAL_TOL:g})")
    if abs(ev - tl) > TRAIN_EVAL_TOL:
        raise AssertionError("the eval step disagrees with the train forward")
    prompts = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(SEED + 5))
    toks = generate(state["params"], prompts, TRAIN_NEW, ms=ms, pc=pc,
                    sv=ServeConfig(max_len=MAX_LEN, cache_dtype=torch.bfloat16))
    launches = dict(ops.LAUNCHES)
    if tuple(toks.shape) != (B, TRAIN_NEW) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {tuple(toks.shape)} out of range")
    n_single, n_attn_pairs, _ = mixer_counts(ms)
    steps = TRAIN_NEW - 1
    want = {"flash_attention": 2 * n_groups,
            "dual_rmsnorm": norm_launches(cfg, n_pairs) * (2 + steps),
            "decode_attention": steps * n_single,
            "decode_attention_pair": steps * n_attn_pairs,
            "decode_attention_paged": 0, "decode_attention_pair_paged": 0,
            "ssm_scan": 0}
    log(f"[train] eval + generate({TRAIN_NEW} new) on the fine-tuned weights: "
        f"launches {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    return launches, {
        "layers": cfg.n_layers, "pairs": list(ms.plan.pairs),
        "params_b": n_all / 1e9, "trainable_b": n_train / 1e9,
        "batch": TRAIN_B, "seq": TRAIN_S, "step_ms": step_ms,
        "median_step_ms": med, "tokens_per_s": TRAIN_B * TRAIN_S / med * 1e3,
        "max_memory_allocated_gib": peak, "loss": losses,
        "eval_loss": ev, "train_forward_loss": tl, "busy_share": busy}

# ---------------------------------------------------------------------------
# phase 14: the tools (launch.serve, the dry run and its report, examples)
# ---------------------------------------------------------------------------

def roofline_share(what, cfg, ms, shape, seconds, smi, *, cache_len):
    """The least time one H100 could take for one step of ``shape``
    (``analysis.roofline``: model + attention FLOPs at the bf16 peak, or
    the bf16 weights and the cache of ``cache_len`` positions at the HBM
    rate), over the measured ``seconds``."""
    from repro_torch.analysis.roofline import (Roofline, attention_flops,
                                               model_flops)
    from repro_torch.launch.dryrun import meta_elements
    from repro_torch.model import transformer as T
    mf = model_flops(cfg, shape)
    useful = 2.0 * T.param_count(ms) + 2.0 * meta_elements(
        T.cache_meta(ms, batch=shape.global_batch, max_len=cache_len))
    rl = Roofline(flops=mf + attention_flops(cfg, shape), bytes_accessed=useful,
                  model_flops=mf, useful_bytes=useful)
    share = rl.t_bound / seconds
    log(f"[tools] {what}: {seconds * 1e3:.3f} ms against a bound of "
        f"{rl.t_bound * 1e3:.4f} ms ({rl.bottleneck}): {share:.4f} of the "
        f"H100's peak; {smi}")
    return {"ms": seconds * 1e3, "bound_ms": rl.t_bound * 1e3,
            "bound_by": "operations" if rl.bottleneck == "compute" else "bytes",
            "share": share}


def serve_structure(argv):
    """The structure ``launch.serve.main(argv)`` builds, built here without
    weights, so that a probe knows a decode step's launches before the run."""
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.launch import serve
    from repro_torch.model import transformer as T
    args = serve.build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    return T.build_structure(cfg, plan=plan_for_depth(cfg, args.eff_depth), tp=1)


def batched_streams(params, ms, prompts, n_new, cache_dtype):
    """``generate``'s greedy stream of each prompt (numpy arrays), one call
    per prompt length, in a ring cache of ``cache_dtype``."""
    import numpy as np
    import torch
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import ServeConfig, generate
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=cache_dtype)
    by_len, out = {}, [None] * len(prompts)
    for i, prompt in enumerate(prompts):
        by_len.setdefault(len(prompt), []).append(i)
    for rows in by_len.values():
        x = torch.from_numpy(np.stack([prompts[i] for i in rows])).cuda()
        toks = generate(params, x, n_new, ms=ms, pc=ParallelContext(), sv=sv)
        for i, row in zip(rows, toks.cpu().numpy()):
            out[i] = row
    return out


def serve_continuous(what, ms, requests, new, steps, argv=()):
    """``launch.serve.main`` with ``--continuous``, ``requests`` requests of
    ``new`` tokens, under a ``DecodeProbe`` of the paged decode launches at
    ``steps`` and of flash and dual RMSNorm at each shape: every request
    finishes with all its tokens, and once the radix tree lets go of its
    pages the pool has freed every page it allocated. Returns (launches,
    the run)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    ops.reset_launches()
    with DecodeProbe(ms, paged=True, steps=steps,
                     shapes=("flash_attention", "dual_rmsnorm")) as probe:
        run = serve.main(SERVE_ARGV + ["--continuous", "--requests", str(requests),
                                       "--new-tokens", str(new), *argv])
    launches = dict(ops.LAUNCHES)
    run["path_err"] = probe.check(f"serve {what}")   # and drops its copies
    run["allocated"] = torch.cuda.memory_allocated() - base
    eng, res = run["engine"], run["results"]
    c = eng.counters
    if (c["finished"] != requests or len(res) != requests
            or any(len(v) != new for v in res.values())):
        raise AssertionError(f"serve {what}: requests unfinished: {c}")
    resident = eng.prefix.resident_pages if eng.prefix else 0
    live = eng.pool.live
    if eng.prefix:
        eng.prefix.evict(resident, eng.pool)
    eng.pool.check_balance()
    log(f"[tools] serve {what}: {c['finished']}/{requests} finished in "
        f"{eng.step_count} steps, {run['run_s']:.3f} s; pages alloc/freed "
        f"{eng.pool.allocated_total}/{eng.pool.freed_total} after evicting the "
        f"radix tree's {resident} (live before {live}); launches {launches}")
    if live != resident or eng.pool.allocated_total != eng.pool.freed_total:
        raise AssertionError(f"serve {what}: pages still held after drain")
    for name in ("flash_attention", "dual_rmsnorm", "decode_attention_paged",
                 "decode_attention_pair_paged"):
        if not launches[name]:
            raise AssertionError(f"serve {what}: {name} was not launched")
    return launches, run


def tools_path(smi):
    """Phase 14: (a) ``launch.serve.main`` in this process at full width,
    one-shot (tokens == a direct ``generate`` on the same weights and
    prompts, bit for bit; launches reconciled; prefill and decode shares
    of the H100 roofline), then continuous three times: the prefix cache
    and buckets (streams held to ``generate`` under the near-tie rule,
    trace validated, Prometheus metrics written), then ``--spec-k 4`` and
    ``--degrade-delta`` on fewer, shorter requests; each run under a
    ``DecodeProbe`` that holds its decode, flash and dual RMSNorm launches
    against their plain versions at its own shapes; (b) the dry run of the
    40 cells, LP on and off, the report, and the dry run's weights + page
    pool of (a)'s continuous engine within MEM_TOL of ``memory_allocated``;
    (c) the quickstart example on the card, probed in the same way.
    Returns (launches by path, metrics)."""
    import contextlib
    import importlib.util
    import io
    import torch
    from repro_torch.analysis import report
    from repro_torch.analysis.roofline import HBM_BYTES
    from repro_torch.configs import ShapeConfig, get_config, reduced_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, serve
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import ServeConfig, generate, validate_trace

    by_path, out = {}, {}
    shapes = ("flash_attention", "dual_rmsnorm")
    ms = serve_structure(SERVE_ARGV)
    new = int(SERVE_ARGV[SERVE_ARGV.index("--new-tokens") + 1])
    steps = new - 1
    # (a) one-shot: a warm and a timed generate, 2 x 31 decode steps
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    with DecodeProbe(ms, paged=False, steps=(0, 2 * steps - 1), shapes=shapes) as probe:
        run = serve.main(SERVE_ARGV)
    by_path["serve_oneshot"] = launches = dict(ops.LAUNCHES)
    path_err = probe.check("serve one-shot")
    cfg, params = run["cfg"], run["params"]
    if run["ms"].plan != ms.plan:
        raise AssertionError(f"serve built {run['ms'].plan}, the probe {ms.plan}")
    ms = run["ms"]
    batch, prompt_len = run["prompts"].shape
    direct = generate(params, run["prompts"].cuda(), new, ms=ms, pc=ParallelContext(),
                      sv=ServeConfig(max_len=prompt_len + new + 8,
                                     cache_dtype=torch.bfloat16))
    same = torch.equal(direct, run["tokens"])
    n_groups, n_pairs = model_counts(ms)
    n_single, n_attn_pairs, _ = mixer_counts(ms)
    want = {"flash_attention": 2 * n_groups,
            "dual_rmsnorm": 2 * norm_launches(cfg, n_pairs) * (1 + steps),
            "decode_attention": 2 * steps * n_single,
            "decode_attention_pair": 2 * steps * n_attn_pairs,
            "decode_attention_paged": 0, "decode_attention_pair_paged": 0,
            "ssm_scan": 0}
    log(f"[tools] serve one-shot {cfg.name} ({n_groups} groups, {n_pairs} pairs), "
        f"B {batch} x {prompt_len}, {new} new: compile {run['compile_s']:.3f} s, "
        f"run {run['run_s']:.3f} s; tokens == a direct generate bit for bit: {same}; "
        f"launches of both calls {launches} (want {want})")
    if not same:
        raise AssertionError("launch.serve's tokens differ from a direct generate")
    if launches != want:
        raise AssertionError(f"serve one-shot launches {launches} != {want}")
    out["oneshot"] = {
        "run_s": run["run_s"], "compile_s": run["compile_s"],
        "path_max_abs_err": path_err,
        "prefill": roofline_share(
            "serve one-shot prefill", cfg, ms,
            ShapeConfig("serve_prefill", prompt_len, batch, "prefill"),
            run["prefill_s"], smi, cache_len=prompt_len),
        "decode": roofline_share(
            "serve one-shot decode step (mean context)", cfg, ms,
            ShapeConfig("serve_decode", prompt_len + new // 2, batch, "decode"),
            run["decode_s"] / steps, smi, cache_len=prompt_len + new // 2)}
    del run, params, direct
    # (a) continuous, its streams held to generate, and (b)'s memory model
    # on its engine
    trace = ROOT / "build" / "serve_trace.json"
    prom = ROOT / "build" / "serve_metrics.prom"
    by_path["serve_continuous"], run = serve_continuous(
        "continuous", ms, SERVE_REQUESTS, new, SERVE_STEPS["continuous"],
        ["--trace-out", str(trace), "--metrics-out", str(prom)])
    validate_trace(json.loads(trace.read_text()))
    if "finished" not in prom.read_text():
        raise AssertionError("the Prometheus metrics were not written")
    eng = run["engine"]
    held = dryrun.engine_bytes(run["ms"], eng.psv)
    model = held["weights"] + held["pool"]
    err = abs(run["allocated"] - model) / model
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[tools] memory: the dry run counts {held['weights']} B of weights + "
        f"{held['pool']} B of page pool = {model} B; memory_allocated {run['allocated']} B "
        f"(rel err {err:.4f}, tol {MEM_TOL}); the card's total_memory {total} B "
        f"beside HBM_BYTES {HBM_BYTES:.0f} B; {smi}")
    if err > MEM_TOL:
        raise AssertionError("the dry run's memory model misses the engine's")
    prompts, res = run["prompts"], run["results"]
    work = [(0, prompt, new) for prompt in prompts]
    models = [(run["params"], run["ms"])] * len(work)
    n_equal = held_to("tools continuous", models, work, [res[r] for r in sorted(res)],
                      batched_streams(*models[0], prompts, new, torch.bfloat16))
    log(f"[tools] serve continuous: {n_equal}/{len(work)} streams equal to generate "
        f"(bf16 ring cache, as the pool) on the card")
    out["continuous"] = {"run_s": run["run_s"], "steps": eng.step_count,
                         "counters": eng.counters, "model_bytes": model,
                         "allocated_bytes": run["allocated"],
                         "total_memory": total, "path_max_abs_err": run["path_err"],
                         "streams_equal_to_generate": n_equal}
    del run, eng, models
    for argv, name in ((["--spec-k", "4"], "spec"), (["--degrade-delta"], "degraded")):
        by_path[f"serve_{name}"], run = serve_continuous(
            name, ms, SERVE_MODE_REQUESTS, SERVE_MODE_NEW, SERVE_STEPS[name], argv)
        c = run["engine"].counters
        if not c["verify_steps" if name == "spec" else "degraded_admissions"]:
            raise AssertionError(f"serve {name}: the mode did not engage: {c}")
        out[name] = {"run_s": run["run_s"], "steps": run["engine"].step_count,
                     "counters": c, "path_max_abs_err": run["path_err"]}
        del run
    # (b) the dry run and its report
    t = time.perf_counter()
    build = ROOT / "build"
    with contextlib.redirect_stdout(io.StringIO()):     # a line per cell
        dryrun.main(["--all", "--force", "--out", str(build / "dryrun_torch.json")])
        dryrun.main(["--all", "--force", "--no-lp",
                     "--out", str(build / "dryrun_torch_nolp.json")])
    log(report.render(build))
    recs = json.loads((build / "dryrun_torch.json").read_text())
    if len(recs) != 40 or any("error" in r for r in recs.values()):
        raise AssertionError("the dry run did not write 40 records")
    out["dryrun"] = {"s": time.perf_counter() - t, "over_budget": sorted(
        k for k, r in recs.items() if "memory" in r and r["memory"]["over_budget"])}
    # (c) the quickstart example on the card: 16 new tokens from its
    # 8-layer model at plan_for_depth(6)
    gc.collect()
    torch.cuda.empty_cache()
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    qcfg = reduced_config(get_config("tinyllama-1.1b"), n_layers=8)
    qms = T.build_structure(qcfg, plan=plan_for_depth(qcfg, 6), tp=1)
    ops.reset_launches()
    with DecodeProbe(qms, paged=False, steps=(0, 14), shapes=shapes) as probe:
        toks = mod.main(["--device", "cuda", "--steps", "50"])
    by_path["quickstart"] = dict(ops.LAUNCHES)
    out["quickstart"] = {"path_max_abs_err": probe.check("quickstart")}
    log(f"[tools] examples/quickstart_torch.py on the card: generated "
        f"{tuple(toks.shape)}; launches {by_path['quickstart']}")
    if toks.device.type != "cuda" or not by_path["quickstart"]["flash_attention"]:
        raise AssertionError("the quickstart did not run on the card")
    del mod, toks
    # (d) the serve command's ranks at --mesh 1x2, (e) the grid dry runs
    mesh_paths, out["mesh"] = serve_mesh()
    by_path.update(mesh_paths)
    out["dryrun_grids"] = dryrun_grids()
    return by_path, out


def serve_mesh():
    """Phase 14 (d): ``launch.serve.main(MESH_ARGV + MESH_RANKS)``, the
    command line's own launch of two rank processes over gloo on the card
    (``launch.mesh.spawn_ranks``), one-shot and then continuous. Every rank
    must launch flash, the dual RMSNorm and a decode kernel (the ring forms
    one-shot, the paged forms continuous); rank 0's streams are held to the
    same command at --mesh 1x1 in this process under ``held_to``'s
    near-tie rule, both in fp32 weights (``main(dtype=)``: tp = 2 and tp =
    1 then differ only in the order of the sums). Returns ({path: launches summed over the ranks},
    metrics)."""
    import torch
    from repro_torch.launch import serve

    by_path, out = {}, {}
    for mode, extra in (("oneshot", []),
                        ("continuous", ["--continuous", "--requests", str(MESH_REQUESTS)])):
        gc.collect()
        torch.cuda.empty_cache()
        ref = serve.main(MESH_ARGV + extra, dtype=torch.float32)
        t = time.perf_counter()
        got = serve.main(MESH_ARGV + extra + MESH_RANKS, dtype=torch.float32)
        run_s = time.perf_counter() - t
        decode = (("decode_attention_paged", "decode_attention_pair_paged")
                  if extra else ("decode_attention", "decode_attention_pair"))
        for rank, launches in enumerate(got["rank_launches"]):
            if not (launches["flash_attention"] and launches["dual_rmsnorm"]
                    and sum(launches[k] for k in decode)):
                raise AssertionError(f"serve --mesh 1x2 {mode}: rank {rank} launched "
                                     f"{launches}")
        prompts, ms, params = ref["prompts"], ref["ms"], ref["params"]
        if extra:
            work = [(0, prompt, MESH_NEW) for prompt in prompts]
            want = [ref["results"][r] for r in sorted(ref["results"])]
            streams = [got["results"][r] for r in sorted(got["results"])]
            max_len = ref["engine"].psv.max_len
            pool = got["pool"]
            if pool["allocated"] != pool["freed"] or pool["live"] != pool["resident"]:
                raise AssertionError(f"serve --mesh 1x2 continuous: pool {pool}")
        else:
            work = [(0, prompt, MESH_NEW) for prompt in prompts.numpy()]
            want, streams = ref["tokens"].cpu().numpy(), got["tokens"].numpy()
            max_len = prompts.shape[1] + MESH_NEW + 8
        n_equal = held_to(f"serve --mesh 1x2 {mode}", [(params, ms)] * len(work), work,
                          list(streams), list(want), max_len=max_len)
        by_path[f"serve_mesh_{mode}"] = {
            k: sum(r[k] for r in got["rank_launches"]) for k in got["rank_launches"][0]}
        out[mode] = {"run_s": run_s, "rank0_run_s": got["run_s"],
                     "rank_launches": got["rank_launches"],
                     "streams_equal_to_1x1": n_equal, "streams": len(work)}
        log(f"[tools] serve --mesh 1x2 --backend gloo {mode}: {n_equal}/{len(work)} "
            f"streams of rank 0 equal to --mesh 1x1 (fp32; the rest at near-ties); "
            f"launches per rank {got['rank_launches']}; command {run_s:.1f} s, rank 0's "
            f"run {got['run_s']:.3f} s")
        del ref, got, params
    return by_path, out


def dryrun_grids():
    """Phase 14 (e): the dry run of ``DRY_GRID_CELLS`` at ``--mesh 16x16``
    and ``--multi-pod``: rank 0's step on meta tensors, collectives
    recorded, no process started and nothing allocated on the card. No
    record may hold an error; each must have recorded collectives over its
    grid's axes. Returns {grid: {cell: record summary}, "s": seconds}."""
    import contextlib
    import io
    import torch
    from repro_torch.launch import dryrun
    build = ROOT / "build"
    t = time.perf_counter()
    before = torch.cuda.memory_allocated()
    out = {}
    for name, argv in DRY_GRIDS.items():
        path = build / f"dryrun_torch_grid_{name}.json"
        path.unlink(missing_ok=True)
        for arch, shape in DRY_GRID_CELLS:
            with contextlib.redirect_stdout(io.StringIO()):
                dryrun.main(["--arch", arch, "--shape", shape, *argv, "--out", str(path)])
        recs = json.loads(path.read_text())
        out[name] = {}
        for k, r in recs.items():
            if "error" in r or not r["coll"].get("total"):
                raise AssertionError(f"dry run {name} {k}: {r.get('error', r['coll'])}")
            out[name][k] = {"chips": r["chips"], "fsdp": r["fsdp"], "kv_mode": r["kv_mode"],
                            "accum": r["accum"], "peak_gb": r["memory"]["peak_gb"],
                            "coll": r["coll"], "s": r["compile_s"]}
            log(f"[tools] dry run {name} {k}: {r['chips']} ranks, kv {r['kv_mode']}, "
                f"fsdp {r['fsdp']}, accum {r['accum']}: rank 0 holds >= "
                f"{r['memory']['peak_gb']:.2f} GiB, its step's collectives "
                f"{r['coll']['n_ops']:.0f} all_reduce, {r['coll']['total'] / 1e9:.4f} GB "
                f"on the wire ({ {a: round(v / 1e9, 4) for a, v in r['coll'].items() if a.startswith('axis:')} } GB)")
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("the dry run allocated memory on the card")
    out["s"] = time.perf_counter() - t
    log(f"[tools] dry run of {len(DRY_GRID_CELLS)} cells at {list(DRY_GRIDS)}: "
        f"{out['s']:.1f} s")
    return out

# ---------------------------------------------------------------------------
# phase 15: tensor-parallel serving, the ranks as processes on one card
# ---------------------------------------------------------------------------

def tp_spawn(case, world, timeout=TP_TIMEOUT):
    """Run ``case`` (a function of ``TP_CASES``) in ``world`` rank processes
    (``python3 chip_smoke.py --tp-rank <spec>``) joined over ``TP_BACKEND``
    through a file store under build/tp, all on the one card. Waits for
    every rank; a rank that fails, or outlives ``timeout``, fails the phase
    (the others are killed). Prints rank 0's log (every rank's on a
    failure) and returns the ranks' results in rank order."""
    import shutil
    d = ROOT / "build" / "tp" / case
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    procs = []
    for rank in range(world):
        spec = {"case": case, "world": world, "rank": rank,
                "init": f"file://{d / 'store'}", "out": str(d / f"rank{rank}.json")}
        with open(d / f"rank{rank}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank",
                 json.dumps(spec)], stdout=f, stderr=subprocess.STDOUT))
    deadline = time.perf_counter() + timeout
    failed = None
    try:
        for rank, proc in enumerate(procs):
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            if rc != 0 and failed is None:
                failed = f"rank {rank} of {world} exited with {rc}"
                break
    except subprocess.TimeoutExpired:
        failed = f"a rank of {world} ran past {timeout} s"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank in range(world) if failed else (0,):
        text = (d / f"rank{rank}.log").read_text()
        log(f"[tp {case}] rank {rank} of {world}:\n" + "\n".join(
            f"  | {line}" for line in text.splitlines()[-(900 if rank == 0 else 60):]))
    if failed:
        raise AssertionError(f"tensor-parallel {case}: {failed}")
    return [json.loads((d / f"rank{rank}.json").read_text()) for rank in range(world)]


def tp_child(spec):
    """One rank of ``tp_spawn``: joins the group, runs its case, writes its
    result. Any failure exits non-zero."""
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.context import init_context
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pc = init_context(backend=TP_BACKEND, init_method=spec["init"],
                      world_size=spec["world"], rank=spec["rank"])
    out = TP_CASES[spec["case"]](pc)
    torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()
    Path(spec["out"]).write_text(json.dumps(out))
    return 0


def tp_case_probe(pc):
    """gloo's all-reduce on CUDA tensors, SUM and MAX, in each type the
    paths reduce (activations in fp32 and bf16, tokens and flags in int64
    and int32)."""
    import torch
    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.int64, torch.int32):
        x = torch.tensor([pc.rank + 1, -(pc.rank + 1)], device="cuda").to(dt)
        out[str(dt).split(".")[1]] = {"sum": pc.psum_tp(x).tolist(),
                                      "max": pc.pmax_tp(x).tolist(),
                                      "input_kept": x.tolist() == [pc.rank + 1, -(pc.rank + 1)]}
    return out


def tp_probe(got):
    """The ranks' ``tp_case_probe`` results, right on every rank: the
    backend takes CUDA tensors for all_reduce SUM and MAX on this card's
    PyTorch."""
    w = len(got)
    want = {"sum": [w * (w + 1) // 2, -(w * (w + 1) // 2)], "max": [w, -1],
            "input_kept": True}
    for rank, r in enumerate(got):
        for dt, res in r["probe"].items():
            if res != want:
                raise AssertionError(f"{TP_BACKEND} all_reduce on CUDA {dt}, rank "
                                     f"{rank}: {res}, want {want}")
    log(f"[tp] {TP_BACKEND} all_reduce SUM and MAX on CUDA "
        f"{', '.join(sorted(got[0]['probe']))} tensors: right on {w} ranks")
    return sorted(got[0]["probe"])


def tp_structure(tp, n_layers=TP2_LAYERS, eff_depth=TP2_EFF_DEPTH):
    """(cfg, ms): tinyllama-1.1b at its published widths cut to its first
    ``n_layers`` layers under plan_for_depth(``eff_depth``) at ``tp``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.lp import plan_for_depth
    from repro_torch.model import transformer as T
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=n_layers)
    return cfg, T.build_structure(cfg, plan=plan_for_depth(cfg, eff_depth), tp=tp)


def tp_model(pc, n_layers=TP2_LAYERS, eff_depth=TP2_EFF_DEPTH):
    """``tp_structure`` at the context's tp, bf16 random weights from the
    seed made on the card: the rank's shard of the weights tp = 1 makes
    (``init_params(rank=)``)."""
    import torch
    from repro_torch.model import transformer as T
    cfg, ms = tp_structure(pc.tp_size, n_layers, eff_depth)
    params = T.init_params(ms, torch.Generator(device="cuda").manual_seed(SEED),
                           torch.bfloat16, device="cuda",
                           rank=pc.rank if pc.tp_size > 1 else None)
    return cfg, ms, params


def tp_traffic(vocab, n_new):
    """Half of phase 6's traffic: the first 4 requests of each wave (two
    family members and two cold prompts each; the second wave's family
    members hit the first's pages), ``n_new`` new tokens each."""
    work = engine_traffic(vocab, n_new)
    return work[:4] + work[N_SLOTS:N_SLOTS + 4]


def tp_prompts(cfg):
    import torch
    return torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator(device="cuda").manual_seed(SEED + 7),
                         device="cuda")


def tp_streams(pc, cfg, ms, params, work, n_new, parts=("generate", "engine"),
               kv_mode="heads"):
    """fp32 compute on the bf16 weights: ``sharded_generate``'s tokens
    (B = 4 x 128, ``n_new`` new, the ring cache in ``kv_mode``'s layout) and
    the engine's streams on ``work`` (fp32 ring cache and pool), as lists;
    the ones ``parts`` leaves out are None. A mixture of experts runs at the
    capacity factor E/k (``no_drops``), where a prefill drops no slot that
    a decode step keeps."""
    import torch
    from repro_torch.serve import PagedEngine, ServeConfig, sharded_generate
    if cfg.moe_experts:
        ms = no_drops(ms)
    set_compute_dtype(params, torch.float32)
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.float32, kv_mode=kv_mode)
    gen = streams = None
    if "generate" in parts:
        gen = sharded_generate(params, tp_prompts(cfg), n_new, ms=ms, pc=pc,
                               sv=sv).cpu().tolist()
    if "engine" in parts:
        eng = PagedEngine(params, ms, engine_config(torch.float32), pc=pc)
        streams = [s.tolist() for s in serve(eng, work)]
    set_compute_dtype(params, torch.bfloat16)
    return gen, streams


def tp_timed(pc, cfg, ms, params, work, n_new, *, generate_too, engine_too=True,
             kv_mode="heads", prompts=None, inputs=None, max_len=MAX_LEN):
    """bf16 runs whose launches are counted and reconciled, and whose
    decode launches at steps 0 and 8 (and first flash and scan launch at
    each shape) are held against their plain versions (``DecodeProbe``):
    ``sharded_generate`` (``prompts``, by default 4 x 128, with the prefix
    or frames of ``inputs``, ``n_new`` new, a ring cache of ``max_len`` in
    ``kv_mode``'s layout; with ``generate_too``) and the engine on
    ``work`` (with ``engine_too``). Returns {path: {launches,
    head_map_launches, seconds, decode_path_max_abs_err, ...}}."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.model import attention as A
    from repro_torch.serve import PagedEngine, ServeConfig, sharded_generate
    _, n_pairs = model_counts(ms)
    n_single, n_attn_pairs, n_rec = mixer_counts(ms)
    shapes = (("flash_attention",) if n_single + n_attn_pairs else ()) + (
        ("ssm_scan",) if n_rec else ())
    out = {}
    if generate_too:
        sv = ServeConfig(max_len=max_len, cache_dtype=torch.bfloat16, kv_mode=kv_mode)
        prompts = tp_prompts(cfg) if prompts is None else prompts
        n_enc = sum(seg.count for seg in ms.enc_segments)
        n_cross = sum(seg.count for seg in ms.segments if seg.group.specs[0].cross_attn)
        d_single, d_pair, _ = ring_decode_counts(ms, kv_mode)
        torch.cuda.synchronize()
        ops.reset_launches()
        timings = {}
        with DecodeProbe(ms, paged=False, steps=(0, 8), shapes=shapes,
                         kv_mode=kv_mode) as probe:
            sharded_generate(params, prompts, n_new, ms=ms, pc=pc, sv=sv,
                             timings=timings, **(inputs or {}))
        steps = n_new - 1
        # Per prefill one flash launch per encoder layer, attention group
        # and cross-attention group; per decode step one per cross-attention
        # group (its query row against the encoder's keys) and one ring
        # decode launch per group whose ring is not cut along the sequence.
        reconcile(f"tp={pc.tp_size} rank {pc.rank} {cfg.name} sharded_generate "
                  f"kv_mode={kv_mode}", dict(ops.LAUNCHES),
                  {"flash_attention": n_enc + n_single + n_attn_pairs + n_cross * (1 + steps),
                   "dual_rmsnorm": norm_launches(cfg, n_pairs) * (1 + steps),
                   "decode_attention": steps * d_single,
                   "decode_attention_pair": steps * d_pair,
                   "decode_attention_paged": 0, "decode_attention_pair_paged": 0,
                   "ssm_scan": n_rec})
        out["generate"] = {"launches": dict(ops.LAUNCHES),
                           "head_map_launches": dict(ops.HEAD_MAP_LAUNCHES),
                           "prefill_ms": timings["prefill_s"] * 1e3,
                           "decode_ms_per_step": timings["decode_s"] / steps * 1e3,
                           "decode_path_max_abs_err": probe.check(
                               f"tp={pc.tp_size} rank {pc.rank} {cfg.name} "
                               f"sharded_generate kv_mode={kv_mode}")}
    if not engine_too:
        return out
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16), pc=pc)
    steps = []
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with DecodeProbe(ms, paged=True, steps=(0, 8), shapes=shapes) as probe:
        serve(eng, work, steps)
    wall_s = time.perf_counter() - t0
    launches, hm = dict(ops.LAUNCHES), dict(ops.HEAD_MAP_LAUNCHES)
    err = probe.check(f"tp={pc.tp_size} rank {pc.rank} {cfg.name} engine")
    c = eng.counters
    prefill_launches = c["bucket_groups"] + (c["full_prefills"] + c["suffix_prefills"]
                                             - c["bucket_prefills"])
    decode_launches = sum(1 for _, st in steps if st["decoded"])
    reconcile(f"tp={pc.tp_size} rank {pc.rank} {cfg.name} engine", launches, {
        "dual_rmsnorm": norm_launches(cfg, n_pairs) * (prefill_launches + decode_launches),
        "decode_attention": 0, "decode_attention_pair": 0,
        "decode_attention_paged": n_single * decode_launches,
        "decode_attention_pair_paged": n_attn_pairs * decode_launches,
        "flash_attention": (n_single + n_attn_pairs) * prefill_launches,
        "ssm_scan": n_rec * prefill_launches})
    want_hm = ({"decode_attention_paged": launches["decode_attention_paged"],
                "decode_attention_pair_paged": launches["decode_attention_pair_paged"]}
               if A.paged_head_map(ms.dims, pc) is not None else
               {"decode_attention_paged": 0, "decode_attention_pair_paged": 0})
    if hm != want_hm:
        raise AssertionError(f"rank {pc.rank}: head-mapped launches {hm} != {want_hm}")
    resident = eng.prefix.resident_pages if eng.prefix else 0
    live = eng.pool.live
    if eng.prefix:
        eng.prefix.evict(resident, eng.pool)
    eng.pool.check_balance()
    if live != resident or eng.pool.live != 0:
        raise AssertionError(f"rank {pc.rank}: pages still held after drain")
    if (eng.prefix is None) != exact_prefills(ms):
        raise AssertionError(f"{cfg.name}: prefix cache {eng.prefix} at tp={pc.tp_size}")
    out["engine"] = {"launches": launches, "head_map_launches": hm,
                     **decode_metrics(wall_s, steps), "decoded": c["decoded"],
                     "prefix_hits": c["prefix_hits"],
                     "bucket_groups": c["bucket_groups"],
                     "decode_path_max_abs_err": err}
    return out


def tp_step_records(pc, ms, params, prompts):
    """The collectives, as ``parallel.context.COLLECTIVES`` records them, of
    a prefill of ``prompts`` with its argmax and of one ``make_serve_step``
    decode step after it (bf16 ring cache): {"prefill": [...], "decode":
    [...]}. Under ``make_dry_context`` on meta tensors it is the dry run's
    record of the same step."""
    import torch
    from repro_torch.model import embedding as E
    from repro_torch.parallel import context
    from repro_torch.serve import ServeConfig, make_prefill, make_serve_step
    sv = ServeConfig(max_len=MAX_LEN, cache_dtype=torch.bfloat16)
    with torch.no_grad():
        context.reset_all_reduces()
        logits, caches = make_prefill(ms, pc, sv)(params, prompts)
        tok = E.vocab_parallel_argmax(logits, pc)
        prefill = context.recorded()
        context.reset_all_reduces()
        make_serve_step(ms, pc, sv)(params, tok, caches, prompts.shape[1])
        decode = context.recorded()
    context.reset_all_reduces()
    return {"prefill": prefill, "decode": decode}


def tp_records_held(ms, got):
    """Phase 15 (a): each rank's real record (``tp_step_records`` over
    gloo) equal to the dry run's for the same structure, rank and step
    (``make_dry_context``, meta weights and prompts): kinds, bytes, group
    sizes, axes and order. Returns the dry record's collective bytes."""
    import torch
    from repro_torch.analysis.roofline import collective_bytes
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import make_dry_context
    for rank, r in enumerate(got):
        dry = tp_step_records(make_dry_context(1, 1, ms.tp, rank=rank), ms,
                              T.abstract_params(ms, torch.bfloat16, rank=rank),
                              torch.empty((B, S), dtype=torch.int64, device="meta"))
        if dry != r["records"]:
            raise AssertionError(f"tp={ms.tp} rank {rank}: the real collectives differ "
                                 f"from the dry run's:\n{r['records']}\n{dry}")
    return {part: collective_bytes(recs) for part, recs in got[0]["records"].items()}


def tp_decode_all_reduces(pc, ms, params, work):
    """The context's all_reduce calls in one engine step that only decodes
    (the first request of ``work`` alone, past its prefill), by operation,
    held to LP's count: a sum per phase exit of each group (a Mamba group's
    x_proj sum and its exit; an LP pair's phase is one) and the embedding's,
    and 3 max (the vocab-parallel argmax's two and the finite flag's)."""
    import torch
    from repro_torch.parallel import context
    from repro_torch.serve import PagedEngine
    eng = PagedEngine(params, ms, engine_config(torch.bfloat16), pc=pc)
    eng.add_request(work[0][1], work[0][2])
    while not eng.counters["decoded"]:
        eng.step()
    context.reset_all_reduces()
    stats = eng.step()
    got = dict(context.ALL_REDUCES)
    groups = model_counts(ms)[0]
    want = {"sum": 1 + 2 * groups, "max": 3}
    if stats["decoded"] != 1 or stats["admitted"] or got != want:
        raise AssertionError(f"{ms.cfg.name} tp={pc.tp_size}: one decode step "
                             f"{stats} made {got} all_reduces, want {want}")
    log(f"[tp] rank {pc.rank} {ms.cfg.name}: one decode step, {groups} groups "
        f"({len(ms.plan.pairs)} LP pairs): all_reduce {got} (1 + 2 per group sums, "
        "3 max)")
    return {"groups": groups, "pairs": len(ms.plan.pairs), **got}


def tp_family_model(pc, name, pairs):
    """``name`` at its published widths cut to its ``TP_FAMILIES`` layers,
    under the LP ``pairs``, bf16 random weights from the seed made on the
    card: at tp > 1 the rank's shard of the weights tp = 1 makes."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import LPPlan
    from repro_torch.model import transformer as T
    cfg = dataclasses.replace(get_config(name), n_layers=TP_FAMILIES[name][0])
    ms = T.build_structure(cfg, plan=LPPlan(pairs), tp=pc.tp_size)
    params = T.init_params(ms, torch.Generator(device="cuda").manual_seed(SEED),
                           torch.bfloat16, device="cuda",
                           rank=pc.rank if pc.tp_size > 1 else None)
    return cfg, ms, params


def tp_family(pc, name, *, timed):
    """One family of (c) under the context ``pc``: fp32-compute streams of
    ``sharded_generate`` on the generate model and of the engine on the
    engine model (one model where the pairs agree), and with ``timed`` the
    bf16 runs (``tp_timed``) and one decode step's all-reduces. Each model
    is freed before the next."""
    import torch
    _, gen_pairs, eng_pairs = TP_FAMILIES[name]
    models = ([(gen_pairs, ("generate", "engine"))] if gen_pairs == eng_pairs else
              [(gen_pairs, ("generate",)), (eng_pairs, ("engine",))])
    out = {"timed": {}}
    for pairs, parts in models:
        cfg, ms, params = tp_family_model(pc, name, pairs)
        work = tp_traffic(cfg.vocab_size, TP_FAMILY_NEW)
        if pc.rank == 0:
            log(f"[tp] {name} at tp = {pc.tp_size}, {cfg.n_layers} layers, pairs "
                f"{ms.plan.pairs} ({', '.join(parts)}): {ms.dims}; "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        gen, streams = tp_streams(pc, cfg, ms, params, work, TP_FAMILY_NEW, parts)
        if gen is not None:
            out["generate"] = gen
        if streams is not None:
            out["engine"] = streams
        if timed:
            out["timed"].update(tp_timed(pc, cfg, ms, params, work, TP_FAMILY_NEW,
                                         generate_too="generate" in parts,
                                         engine_too="engine" in parts))
            if "engine" in parts:
                out["all_reduces"] = tp_decode_all_reduces(pc, ms, params, work)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_encdec_model(pc, name):
    """``name`` (whisper-medium or paligemma-3b) at its published widths cut
    to its ``TP_ENCDEC`` decoder layers (whisper also to as many encoder
    layers) under the LP pair (0, 1), bf16 random weights from the seed made
    on the card: the weights of the tp = 2 structure, whose vocabulary tp
    pads (whisper's 51865 to 51866), so that the draws of every later leaf
    agree; a rank keeps its shard, and tp = 1 the whole, cut back to its own
    shapes (the pad row and column, which no id looks up and the logits
    mask)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import LPPlan
    from repro_torch.model import transformer as T
    from repro_torch.model.params import ModelParams, init_tree, tree_map
    n = TP_ENCDEC[name][0]
    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, n_layers=n, enc_layers=n if cfg.enc_layers else 0)
    ms = T.build_structure(cfg, plan=LPPlan(((0, 1),)), tp=pc.tp_size)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if pc.tp_size > 1:
        return cfg, ms, T.init_params(ms, gen, torch.bfloat16, device="cuda", rank=pc.rank)
    tree = init_tree(T.model_template(T.build_structure(cfg, plan=ms.plan, tp=TP2)),
                     gen, torch.bfloat16, "cuda")
    tree = tree_map(lambda x, pd: x[tuple(slice(0, k) for k in pd.shape)].contiguous(),
                    tree, T.model_template(ms))
    return cfg, ms, ModelParams(tree)


def tp_encdec_inputs(cfg):
    """(prompts, extras, cache length) of (d), as phase 12 draws them:
    whisper's frames [4, 1500, D] (N(0, 1)) and prompts 4 x 32, cache 128;
    paligemma's prefix of 256 patch embeddings (0.02 N(0, 1)) and prompts
    4 x 128, cache 512; bf16, from the seed, alike on every rank."""
    import torch

    def gen(k):
        return torch.Generator(device="cuda").manual_seed(SEED + k)
    if cfg.enc_layers:
        extras = {"frames": torch.randn((B, ENC_SEQ, cfg.d_model), device="cuda",
                                        generator=gen(8)).to(torch.bfloat16)}
        prompt_len, max_len = WHISPER_PROMPT, WHISPER_MAX_LEN
    else:
        extras = {"prefix": (0.02 * torch.randn((B, PALI_PREFIX, cfg.d_model),
                                                device="cuda", generator=gen(7))
                             ).to(torch.bfloat16)}
        prompt_len, max_len = S, PALI_MAX_LEN
    prompts = torch.randint(0, cfg.vocab_size, (B, prompt_len), generator=gen(5),
                            device="cuda")
    return prompts, extras, max_len


def fp32_inputs(extras):
    """The frames in fp32 for the fp32-compute runs (the prefix takes the
    stream's type inside the model)."""
    import torch
    return {k: v.float() if k == "frames" else v for k, v in extras.items()}


def tp_encdec_collectives(pc, ms, params, prompts, extras, max_len, kv_mode):
    """The context's collectives in one ``make_serve_step`` decode step
    after a prefill, by kind, held to LP's count: a sum per phase exit of
    each group (self-attention, cross-attention where the layers have it,
    FFN) and the embedding's, the vocab-parallel argmax's 2 max, and per
    attention phase whose ring ``kv_mode`` cuts along the sequence one
    gather (q), one max and one sum more; an FSDP structure adds one
    gather per leaf of each group over the data ranks (two with int8
    shards: the values and the scales)."""
    import torch
    from repro_torch.model import embedding as E
    from repro_torch.parallel import context
    from repro_torch.serve import ServeConfig, make_prefill, make_serve_step
    sv = ServeConfig(max_len=max_len, cache_dtype=torch.bfloat16, kv_mode=kv_mode)
    with torch.no_grad():
        logits, caches = make_prefill(ms, pc, sv)(params, prompts, **extras)
        tok = E.vocab_parallel_argmax(logits, pc)
        del logits
        t0 = prompts.shape[1] + (ms.cfg.prefix_len if "prefix" in extras else 0)
        context.reset_all_reduces()
        make_serve_step(ms, pc, sv)(params, tok, caches, t0)
    got = {**context.ALL_REDUCES, **context.ALL_GATHERS}
    groups = model_counts(ms)[0]
    n_cross = sum(seg.count for seg in ms.segments if seg.group.specs[0].cross_attn)
    n_seq = ring_decode_counts(ms, kv_mode)[2]
    want = {"sum": 1 + 2 * groups + n_cross + n_seq, "max": 2 + n_seq,
            "gather": n_seq + fsdp_gathers(ms, pc)}
    if got != want:
        raise AssertionError(f"{ms.cfg.name} tp={pc.tp_size} kv_mode={kv_mode}: one "
                             f"decode step made {got} collectives, want {want}")
    log(f"[tp] rank {pc.rank} {ms.cfg.name} kv_mode={kv_mode}: one serve step, "
        f"{groups} groups ({n_cross} with cross-attention, {n_seq} attention phases "
        f"cut along the sequence, FSDP {ms.fsdp}, int8 {ms.quant}): collectives {got}")
    return {"groups": groups, "cross": n_cross, "seq_phases": n_seq, **got}


def fsdp_gathers(ms, pc):
    """Data gathers of one forward of an FSDP structure: one per leaf of
    each group (the leaf list of ``segment_metas``), two with int8 shards;
    none at one data rank or without FSDP."""
    from repro_torch.model import transformer as T
    if not ms.fsdp or pc.data_size == 1:
        return 0
    leaves = sum(seg.count * len(meta.chunks)
                 for seg, meta in zip(ms.segments, T.segment_metas(ms)))
    return leaves * (2 if ms.quant else 1)


def tp_encdec(pc, name, *, timed, modes=None):
    """One model of (d) under the context ``pc``, per kv mode of ``modes``
    (by default its ``TP_ENCDEC`` entry's): ``sharded_generate``'s
    fp32-compute tokens (with the frames or the prefix), and with ``timed``
    a bf16 run under ``DecodeProbe`` whose launches reconcile
    (``tp_timed``) and one decode step's collectives."""
    import torch
    from repro_torch.serve import ServeConfig, sharded_generate
    cfg, ms, params = tp_encdec_model(pc, name)
    prompts, extras, max_len = tp_encdec_inputs(cfg)
    if pc.rank == 0:
        enc = f"{cfg.enc_layers} encoder + " if cfg.enc_layers else ""
        log(f"[tp] {name} at tp = {pc.tp_size}, {enc}{cfg.n_layers} decoder layers, "
            f"pairs {ms.plan.pairs}: {ms.dims}; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    out = {}
    for mode in modes or TP_ENCDEC[name][1]:
        set_compute_dtype(params, torch.float32)
        sv = ServeConfig(max_len=max_len, cache_dtype=torch.float32, kv_mode=mode)
        gen = sharded_generate(params, prompts, TP_ENCDEC_NEW, ms=ms, pc=pc, sv=sv,
                               **fp32_inputs(extras))
        set_compute_dtype(params, torch.bfloat16)
        out[mode] = {"generate": gen.cpu().tolist()}
        if timed:
            out[mode]["timed"] = tp_timed(pc, cfg, ms, params, None, TP_ENCDEC_NEW,
                                          generate_too=True, engine_too=False,
                                          kv_mode=mode, prompts=prompts, inputs=extras,
                                          max_len=max_len)
            out[mode]["collectives"] = tp_encdec_collectives(pc, ms, params, prompts,
                                                             extras, max_len, mode)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_case_tp2(pc):
    """Rank of (a): first the probe (``tp_case_probe``), then tinyllama-1.1b,
    ``TP2_LAYERS`` layers, plan_for_depth(``TP2_EFF_DEPTH``), at tp = 2 (kv
    heads split: 2 of the 4 a rank): the collectives of a prefill and a
    serve step (``tp_step_records``), the timed runs, a decode step's
    all_reduce count; then (c), the families, and (d), the encoder-decoder
    and the prefix-LM."""
    import torch
    probe = tp_case_probe(pc)
    cfg, ms, params = tp_model(pc)
    work = tp_traffic(cfg.vocab_size, TP2_NEW)
    log(f"[tp2] rank {pc.rank}: {ms.dims}")
    out = {"probe": probe, "records": tp_step_records(pc, ms, params, tp_prompts(cfg)),
           "timed": tp_timed(pc, cfg, ms, params, work, TP2_NEW, generate_too=True),
           "all_reduces": tp_decode_all_reduces(pc, ms, params, work),
           "weights_bytes": sum(p.numel() * p.element_size() for p in params.parameters())}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (c): the recurrent and MoE families in the same processes
    out["families"] = {name: tp_family(pc, name, timed=True) for name in TP_FAMILIES}
    # (d): whisper and paligemma (both kv modes) in the same processes
    out["encdec"] = {name: tp_encdec(pc, name, timed=True) for name in TP_ENCDEC}
    return out


def tp_case_tp8(pc):
    """Rank of (b): tinyllama-1.1b cut to ``TP8_LAYERS`` layers under
    plan_for_depth(``TP8_EFF_DEPTH``) at tp = 8: 4 kv heads under 8 ranks,
    replicated, each rank's 4 q heads reading stored head rank // 2 through
    the paged kernels' head map; (e) the same at kv_mode "seq"; then (f),
    the sharded trainer (``tp_train``), (g), FSDP serving (``tp_fsdp``),
    and (h), the pipeline (``tp_pipe``)."""
    import torch
    from repro_torch.model import attention as A
    cfg, ms, params = tp_model(pc, TP8_LAYERS, TP8_EFF_DEPTH)
    work = tp_traffic(cfg.vocab_size, TP8_NEW)
    hm = A.paged_head_map(ms.dims, pc)
    log(f"[tp8] rank {pc.rank}: {ms.dims}, paged head map {hm}")
    gen, streams = tp_streams(pc, cfg, ms, params, work, TP8_NEW)
    timed = tp_timed(pc, cfg, ms, params, work, TP8_NEW, generate_too=False)
    # (e): the ring cache cut along the sequence (4 kv heads under 8 ranks)
    seq, _ = tp_streams(pc, cfg, ms, params, work, TP8_NEW, ("generate",),
                        kv_mode="seq")
    seq_timed = tp_timed(pc, cfg, ms, params, work, TP8_NEW, generate_too=True,
                         engine_too=False, kv_mode="seq")
    seq_collectives = tp_encdec_collectives(pc, ms, params, tp_prompts(cfg), {}, MAX_LEN,
                                            "seq")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (f): the sharded trainer on the (2, 2, 2) grid of the same ranks, (g)
    # FSDP serving on it, (h) the ranks as pipeline stages
    return {"generate": gen, "engine": streams, "timed": timed, "head_map": list(hm),
            "seq": {"generate": seq, "timed": seq_timed, "collectives": seq_collectives},
            "train": tp_train(pc), "fsdp": tp_fsdp(), "pipe": tp_pipe(pc)}


def tp_train_model(pc, fsdp=False):
    """(cfg, ms) of (f): tinyllama-1.1b at its published widths cut to
    ``TP_TRAIN_LAYERS`` layers under ``TP_TRAIN_PAIRS`` at the context's
    tp, FSDP over its data ranks when asked."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.lp import LPPlan
    from repro_torch.model import transformer as T
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=TP_TRAIN_LAYERS)
    return cfg, T.build_structure(cfg, plan=LPPlan(TP_TRAIN_PAIRS), tp=pc.tp_size,
                                  fsdp=fsdp, fsdp_data=pc.data_size if fsdp else 1)


def tp_train_batch(cfg, step):
    """Step ``step``'s GLOBAL batch from the port's synthetic source, on the card."""
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.data.synthetic import SynthConfig
    src = make_source(DataConfig(seq_len=TP_TRAIN_S, global_batch=TP_TRAIN_B, seed=SEED),
                      SynthConfig(vocab_size=cfg.vocab_size))
    return {k: x.cuda() for k, x in src.batch_at(step).items()}


def tp_train_steps(pc, mode):
    """``TP_TRAIN_STEPS`` steps of ``make_sharded_train_step`` in ``mode``
    (``TP_TRAIN_MODES``) from the seed's fp32 weights on the card: per step
    the metrics, ms (synchronised) and collectives by kind. The training
    forward must launch no kernel. Returns (state, ms, result)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.parallel import context
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train.trainer import init_state, make_sharded_train_step
    kw = TP_TRAIN_MODES[mode]
    cfg, ms = tp_train_model(pc, kw.get("fsdp", False))
    tc = TrainConfig(opt=OptConfig(**TP_TRAIN_OPT),
                     compress_pod=kw.get("compress_pod", False))
    state = init_state(ms, torch.Generator(device="cuda").manual_seed(SEED), pc, tc,
                       device="cuda")
    step = make_sharded_train_step(ms, pc, tc)
    out = {"metrics": [], "step_ms": [], "collectives": []}
    ops.reset_launches()
    for i in range(TP_TRAIN_STEPS):
        batch = tp_train_batch(cfg, i)
        context.reset_all_reduces()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t) * 1e3)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["collectives"].append({**context.ALL_REDUCES, **context.ALL_GATHERS,
                                   **context.SCATTERS})
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"(f) {mode}: the training forward launched {ops.LAUNCHES}")
    return state, ms, out


def tp_train_collectives(ms, pc, tc):
    """One step's collectives by kind, predicted from the leaf list (every
    leaf trained; attention + MLP groups): the tp phases forward and
    backward (sp: a gather in and a scatter out each way, the embedding's
    slice gathered back; without: a sum out forward, a sum in backward),
    the embedding's and the cross-entropy's sums and max, a tp sum per
    replicated leaf, per regular leaf the dp reduction (with compression a
    data scatter, a pod max and a pod sum) and gather, per FSDP group leaf
    a data gather and its backward scatter and a pod sum (or max and sum),
    the norm's two sums and the metrics' two means."""
    from repro_torch.model import transformer as T
    from repro_torch.train.trainer import leaf_infos
    infos = leaf_infos(ms, tc)
    n = {"sum": 0, "max": 0, "gather": 0, "scatter": 0}
    if pc.tp_size > 1:
        phases = 2 * sum(seg.count for seg in ms.segments)
        if pc.sp:
            n["gather"] += 2 * phases + 2
            n["scatter"] += 2 * phases + 1
            n["sum"] += 3
        else:
            n["sum"] += 2 * phases + 4
        n["max"] += 1
        n["sum"] += sum(li.tp_sum for li in infos) + 1
    compress = tc.compress_pod and pc.pod_size > 1
    if pc.dp_size > 1:
        n["sum"] += 3
        for li in infos:
            if li.fsdp:
                n["sum"] += pc.pod_size > 1
                n["max"] += compress
            else:
                n["gather"] += 1
                n["scatter"] += (pc.data_size > 1) if compress else 1
                n["max"] += compress
                n["sum"] += compress
    if ms.fsdp and pc.data_size > 1:
        group_leaves = sum(seg.count * len(meta.chunks)
                           for seg, meta in zip(ms.segments, T.segment_metas(ms)))
        n["gather"] += group_leaves
        n["scatter"] += group_leaves
    return n


def tp_train(world_pc):
    """(f), one rank: the grid over the world, each of ``TP_TRAIN_MODES``
    (sp on), then one eval step of the ZeRO run's weights on the rank's
    rows of step ``TP_TRAIN_STEPS``'s batch under ``DecodeProbe`` (flash
    and dual RMSNorm launches against their plain versions) beside the
    train forward's loss on the same rows."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.model import transformer as T
    from repro_torch.parallel.context import make_grid_context
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train.trainer import batch_shard, make_eval_step
    t = time.perf_counter()
    pc = make_grid_context(*TP_TRAIN_GRID, sp=True)
    out = {"grid_s": time.perf_counter() - t, "modes": {}}
    for mode in TP_TRAIN_MODES:
        state, ms, res = tp_train_steps(pc, mode)
        tc = TrainConfig(opt=OptConfig(**TP_TRAIN_OPT),
                         compress_pod=TP_TRAIN_MODES[mode].get("compress_pod", False))
        res["predicted"] = tp_train_collectives(ms, pc, tc)
        out["modes"][mode] = res
        if mode == "zero":
            params, zms = state["params"], ms
        del state
        gc.collect()
        torch.cuda.empty_cache()
    cfg = zms.cfg
    rows = batch_shard(tp_train_batch(cfg, TP_TRAIN_STEPS), pc)
    ops.reset_launches()
    with DecodeProbe(zms, paged=False, steps=(), shapes=("flash_attention",
                                                          "dual_rmsnorm")) as probe:
        ev = make_eval_step(zms, pc)(params, rows)
    out["eval_launches"] = dict(ops.LAUNCHES)
    out["eval_path_max_abs_err"] = probe.check(f"(f) eval rank {world_pc.rank}")
    with torch.no_grad():
        tl = pc.pmean_dp(T.loss_fn(params, rows, ms=zms, pc=pc, differentiable=True)[0])
    out["eval_loss"], out["train_forward_loss"] = float(ev["loss"]), float(tl)
    n_groups, n_pairs = model_counts(zms)
    out["eval_want"] = {"flash_attention": n_groups,
                        "dual_rmsnorm": norm_launches(cfg, n_pairs)}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_train_reference():
    """(f)'s tp = 1 run in this process, first: the ZeRO mode's steps on the
    same weights and batches (one rank: the whole batch)."""
    import torch
    from repro_torch.parallel.context import ParallelContext
    state, _, res = tp_train_steps(ParallelContext(), "zero")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_train_held(ref, got):
    """(f)'s checks over the ranks' results ``got``; returns the metrics."""
    for rank, r in enumerate(got):
        g = r["train"]
        for mode, res in g["modes"].items():
            if res["metrics"] != got[0]["train"]["modes"][mode]["metrics"]:
                raise AssertionError(f"(f) {mode}: rank {rank}'s metrics differ from rank 0's")
            for i, col in enumerate(res["collectives"]):
                if col != res["predicted"]:
                    raise AssertionError(f"(f) {mode} rank {rank} step {i}: collectives "
                                         f"{col}, predicted {res['predicted']}")
        if g["eval_launches"] != {**{k: 0 for k in g["eval_launches"]}, **g["eval_want"]}:
            raise AssertionError(f"(f) eval rank {rank}: launches {g['eval_launches']}, "
                                 f"want {g['eval_want']}")
        if abs(g["eval_loss"] - g["train_forward_loss"]) > TP_TRAIN_EVAL_TOL:
            raise AssertionError(f"(f) eval rank {rank}: loss {g['eval_loss']} vs the "
                                 f"train forward's {g['train_forward_loss']}")
    modes = got[0]["train"]["modes"]
    errs = {}
    for mode in ("zero", "fsdp"):
        for i, (m, w) in enumerate(zip(modes[mode]["metrics"], ref["metrics"])):
            for k in ("loss", "grad_norm"):
                e = abs(m[k] - w[k]) / abs(w[k])
                errs[f"{mode}_{k}_{i}"] = e
                if e > TP_TRAIN_TOL:
                    raise AssertionError(f"(f) {mode} step {i} {k}: {m[k]} vs tp = 1's "
                                         f"{w[k]} (relative {e:.2e})")
    c_err = abs(modes["compress"]["metrics"][-1]["loss"] - modes["zero"]["metrics"][-1]["loss"])
    if c_err > TP_TRAIN_COMPRESS_TOL:
        raise AssertionError(f"(f) compress_pod: loss {c_err} from the uncompressed run's")
    # Adam hides a gradient off by a constant factor from the loss: hold the
    # compressed run's first step to tp = 1's as well
    c1, w1 = modes["compress"]["metrics"][0], ref["metrics"][0]
    for k, tol in (("loss", TP_TRAIN_TOL), ("grad_norm", TP_TRAIN_COMPRESS_NORM_TOL)):
        e = abs(c1[k] - w1[k]) / abs(w1[k])
        errs[f"compress_{k}_0"] = e
        if e > tol:
            raise AssertionError(f"(f) compress_pod step 0 {k}: {c1[k]} vs tp = 1's "
                                 f"{w1[k]} (relative {e:.2e}, tol {tol:g})")
    return {"grid": list(TP_TRAIN_GRID), "layers": TP_TRAIN_LAYERS, "batch": TP_TRAIN_B,
            "seq": TP_TRAIN_S, "tp1": ref, "rel_err_vs_tp1": errs,
            "compress_loss_diff": c_err,
            "modes": {mode: {k: res[k] for k in ("metrics", "step_ms", "collectives")}
                      for mode, res in modes.items()},
            "grid_s": got[0]["train"]["grid_s"],
            "eval": {k: got[0]["train"][k] for k in (
                "eval_loss", "train_forward_loss", "eval_launches",
                "eval_path_max_abs_err")}}


def tp_fsdp_model(pc, quant=False, tp1=False):
    """(cfg, ms, params) of (g): tinyllama-1.1b at its published widths cut
    to ``TP_FSDP_LAYERS`` layers under ``TP_FSDP_PAIRS``, bf16 weights from
    the seed made on the card: FSDP over the context's data ranks at its tp
    (int8 shards with ``quant``), the rank's view at its tp and data index;
    with ``tp1`` the regular structure at tp = 1 on the same global
    weights."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lp import LPPlan
    from repro_torch.model import transformer as T
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=TP_FSDP_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if tp1:
        ms = T.build_structure(cfg, plan=LPPlan(TP_FSDP_PAIRS))
        return cfg, ms, T.init_params(ms, gen, torch.bfloat16, device="cuda")
    ms = T.build_structure(cfg, plan=LPPlan(TP_FSDP_PAIRS), tp=pc.tp_size, fsdp=True,
                           fsdp_data=pc.data_size, quant=quant)
    return cfg, ms, T.init_params(ms, gen, torch.bfloat16, device="cuda",
                                  rank=pc.tp_index() if pc.tp_size > 1 else None,
                                  data_index=pc.data_index())


def tp_fsdp_prompts(cfg):
    import torch
    return torch.randint(0, cfg.vocab_size, (TP_FSDP_B, TP_FSDP_S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(SEED + 9))


def tp_fsdp_work(cfg):
    """(g)'s engine traffic: the two prompts at step 0, again at step 2."""
    prompts = tp_fsdp_prompts(cfg).cpu().numpy()
    return [(step, p, TP_FSDP_NEW) for step in (0, 2) for p in prompts]


def int8_round_trip(x):
    """x [..., c] through int8 and back in fp32, per block of 128 values
    of each last-axis row (the last block short): scale = max(|block| /
    127, 1e-12), q = round(x / scale) within +-127, q * scale. Written out
    here, apart from the port's ``parallel/fsdp.py``, so a fault there
    does not reach the reference."""
    import torch
    x = x.float()
    c = x.shape[-1]
    block = torch.arange(c, device=x.device) // 128          # each value's block
    amax = torch.zeros(*x.shape[:-1], -(-c // 128), device=x.device).scatter_reduce(
        -1, block.expand_as(x), x.abs(), "amax")
    scale = (amax / 127).clamp_min(1e-12)[..., block]
    return torch.round(x / scale).clamp(-127, 127) * scale


def tp_fsdp_dequantised(params, ms):
    """The tp = 1 weights ``params`` (bf16) as (g)'s int8 ranks see them:
    each segment packed at the grid's (data, tp) (the layout the bf16
    shards' streams hold to tp = 1), each rank's chunk through int8 and
    back (``int8_round_trip``) and rounded to bf16, as the int8 gather
    serves it, unpacked. Returns new ``ModelParams``."""
    import torch
    from repro_torch.model import transformer as T
    from repro_torch.model.params import ModelParams, stack_trees, tree_map
    from repro_torch.parallel import fsdp as F
    tree = params.tree()
    _, data, tp = TP_TRAIN_GRID
    msq = T.build_structure(ms.cfg, plan=ms.plan, tp=tp, fsdp=True, fsdp_data=data,
                            quant=True)
    segs = []
    for sp, seg, meta in zip(tree["segments"], ms.segments, T.segment_metas(msq)):
        groups = ([tree_map(lambda v: v[i], sp) for i in range(seg.count)]
                  if seg.count > 1 else [sp])
        deq = tree_map(lambda v: int8_round_trip(v).to(torch.bfloat16),
                       F.pack_segment(groups, meta, data=msq.fsdp_data, tp=msq.tp,
                                      dtype=torch.bfloat16))
        back = F.unpack_segment(deq, meta, data=msq.fsdp_data, tp=msq.tp,
                                dtype=torch.bfloat16)
        segs.append(stack_trees(back) if seg.count > 1 else back[0])
    return ModelParams(dict(tree, segments=segs))


def tp_fsdp_generate(pc, cfg, ms, params, what):
    """``sharded_generate`` of (g)'s prompts in fp32 compute (fp32 ring):
    tokens, launches reconciled (per forward a flash launch per group and
    2 dual RMSNorms per pair; per decode step a ring launch per group, the
    pair's form for the pair) and held against their plain versions
    (``DecodeProbe``: the ring launches of the first and last decode step,
    the first flash and dual RMSNorm launch at each shape), ms per step
    over gloo, one serve step's collectives."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, sharded_generate
    set_compute_dtype(params, torch.float32, segments=not ms.quant)
    sv = ServeConfig(max_len=TP_FSDP_MAX_LEN, cache_dtype=torch.float32)
    prompts = tp_fsdp_prompts(cfg)
    n_single, n_attn_pairs, _ = mixer_counts(ms)
    d_single, d_pair, _ = ring_decode_counts(ms)
    steps = TP_FSDP_NEW - 1
    torch.cuda.synchronize()
    ops.reset_launches()
    timings = {}
    with DecodeProbe(ms, paged=False, steps=(0, steps - 1), shapes=TP_FSDP_SHAPES) as probe:
        toks = sharded_generate(params, prompts, TP_FSDP_NEW, ms=ms, pc=pc, sv=sv,
                                timings=timings)
    launches = dict(ops.LAUNCHES)
    err = probe.check(f"(g) rank {pc.rank} {what} sharded_generate")
    reconcile(f"(g) rank {pc.rank} {what} sharded_generate", launches, {
        "flash_attention": n_single + n_attn_pairs,
        "dual_rmsnorm": norm_launches(cfg, len(ms.plan.pairs)) * (1 + steps),
        "decode_attention": steps * d_single, "decode_attention_pair": steps * d_pair,
        "decode_attention_paged": 0, "decode_attention_pair_paged": 0, "ssm_scan": 0})
    set_compute_dtype(params, torch.bfloat16, segments=not ms.quant)
    col = tp_encdec_collectives(pc, ms, params, prompts, {}, TP_FSDP_MAX_LEN, "heads")
    return {"tokens": toks.cpu().tolist(), "launches": launches, "collectives": col,
            "path_max_abs_err": err, "prefill_ms": timings["prefill_s"] * 1e3,
            "decode_ms_per_step": timings["decode_s"] / steps * 1e3}


def tp_fsdp_engine(pc, cfg, ms, params):
    """``PagedEngine`` of (g)'s bf16 FSDP structure on ``tp_fsdp_work`` in
    fp32 compute (fp32 pool): streams, launches reconciled from the
    engine's counters and held against their plain versions (the paged
    launches of decode launches 0 and 2, the first flash and dual RMSNorm
    launch at each shape), wall and decode ms over gloo."""
    import torch
    from repro_torch.serve import PagedEngine, PagedServeConfig
    set_compute_dtype(params, torch.float32)
    psv = PagedServeConfig(n_slots=4, page_size=PS, max_len=TP_FSDP_MAX_LEN,
                           n_pages=4 * TP_FSDP_MAX_LEN // PS + 1, prefix_cache=True,
                           cache_dtype=torch.float32)
    eng = PagedEngine(params, ms, psv, pc=pc)
    with DecodeProbe(ms, paged=True, steps=(0, 2), shapes=TP_FSDP_SHAPES) as probe:
        launches, wall_s, steps, streams = timed_serve(eng, tp_fsdp_work(cfg))
    err = probe.check(f"(g) rank {pc.rank} engine")
    set_compute_dtype(params, torch.bfloat16)
    c = eng.counters
    n_single, n_attn_pairs, _ = mixer_counts(ms)
    prefill_launches = c["bucket_groups"] + (c["full_prefills"] + c["suffix_prefills"]
                                             - c["bucket_prefills"])
    decode_launches = sum(1 for _, st in steps if st["decoded"])
    reconcile(f"(g) rank {pc.rank} engine", launches, {
        "dual_rmsnorm": norm_launches(cfg, len(ms.plan.pairs))
        * (prefill_launches + decode_launches),
        "decode_attention": 0, "decode_attention_pair": 0,
        "decode_attention_paged": n_single * decode_launches,
        "decode_attention_pair_paged": n_attn_pairs * decode_launches,
        "flash_attention": (n_single + n_attn_pairs) * prefill_launches, "ssm_scan": 0})
    eng.prefix.evict(eng.prefix.resident_pages, eng.pool)
    eng.pool.check_balance()
    if eng.pool.live:
        raise AssertionError(f"(g) rank {pc.rank}: pages still held after drain")
    return {"streams": [x.tolist() for x in streams], "launches": launches,
            "path_max_abs_err": err,
            "prefix_hits": c["prefix_hits"], "suffix_prefills": c["suffix_prefills"],
            "wall_ms": wall_s * 1e3, "steps": len(steps)}


def tp_fsdp():
    """(g), one rank: the (pod, data, model) grid over the world, then the
    bf16 shards through ``sharded_generate`` and the engine, and the int8
    shards through ``sharded_generate``, each model made from the seed
    and freed after its runs."""
    import torch
    from repro_torch.parallel.context import make_grid_context
    pc = make_grid_context(*TP_TRAIN_GRID)
    out = {}
    for quant in (False, True):
        cfg, ms, params = tp_fsdp_model(pc, quant)
        key = "int8" if quant else "bf16"
        out[key] = tp_fsdp_generate(pc, cfg, ms, params, key)
        if not quant:
            out["engine"] = tp_fsdp_engine(pc, cfg, ms, params)
        out[key]["rank_shard_bytes"] = sum(p.numel() * p.element_size() for n, p
                                           in params.named_parameters()
                                           if n.startswith("segments."))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_fsdp_reference():
    """(g)'s tp = 1 streams in this process, before the ranks: fp32 compute
    on the regular structure's bf16 weights and on their dequantised int8
    copy. Returns (streams, streams on the dequantised weights)."""
    import torch
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serve import ServeConfig, generate
    cfg, ms, params = tp_fsdp_model(None, tp1=True)
    deq = tp_fsdp_dequantised(params, ms)
    sv = ServeConfig(max_len=TP_FSDP_MAX_LEN, cache_dtype=torch.float32)
    out = []
    for p in (params, deq):
        set_compute_dtype(p, torch.float32)
        out.append(generate(p, tp_fsdp_prompts(cfg), TP_FSDP_NEW, ms=ms,
                            pc=ParallelContext(), sv=sv).cpu().tolist())
    del params, deq
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_fsdp_held(ref, got):
    """(g)'s checks over the ranks' results: every rank equal to rank 0;
    the bf16 shards' streams to tp = 1's, the int8 shards' to tp = 1's on
    the dequantised weights, the engine's to the FSDP ``sharded_generate``
    streams of the same prompts (equal, or leaving at a near-tie of tp =
    1's logits; tp = 1's model is made anew only where a stream differs).
    Returns the metrics."""
    import numpy as np
    import torch
    for rank, r in enumerate(got):
        g = r["fsdp"]
        for key in ("bf16", "int8"):
            if g[key]["tokens"] != got[0]["fsdp"][key]["tokens"]:
                raise AssertionError(f"(g) {key}: rank {rank}'s tokens differ from rank 0's")
        if g["engine"]["streams"] != got[0]["fsdp"]["engine"]["streams"]:
            raise AssertionError(f"(g) engine: rank {rank}'s streams differ from rank 0's")
    g = got[0]["fsdp"]
    eng_want = [g["bf16"]["tokens"][i % TP_FSDP_B] for i in range(2 * TP_FSDP_B)]
    held = {}
    checks = (("bf16", g["bf16"]["tokens"], ref[0], False),
              ("int8", g["int8"]["tokens"], ref[1], True),
              ("engine", g["engine"]["streams"], eng_want, False))
    for what, have, want, deq in checks:
        if have == want:
            held[what] = (len(want), len(want))
            continue
        cfg, ms, params = tp_fsdp_model(None, tp1=True)
        if deq:
            params = tp_fsdp_dequantised(params, ms)
        set_compute_dtype(params, torch.float32)
        work = [(0, p, TP_FSDP_NEW) for p in tp_fsdp_prompts(cfg).cpu().numpy()]
        work = (work * 2)[:len(want)]
        held[what] = (held_to(f"(g) {what}", [(params, ms)] * len(work), work,
                              [np.array(x) for x in have], [np.array(x) for x in want],
                              max_len=TP_FSDP_MAX_LEN), len(want))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return {"grid": list(TP_TRAIN_GRID), "layers": TP_FSDP_LAYERS,
            "pairs": [list(p) for p in TP_FSDP_PAIRS], "equal_streams": held,
            "rank0": {k: {m: v for m, v in g[k].items()
                          if m not in ("tokens", "streams", "rank_shard_bytes")}
                      for k in ("bf16", "int8", "engine")},
            "rank_shard_bytes": {k: g[k]["rank_shard_bytes"] for k in ("bf16", "int8")}}


def tp_pipe_structure():
    """(cfg, ms) of (h): tinyllama-1.1b at its published widths,
    ``TP_PIPE_LAYERS`` layers in consecutive LP pairs (one segment)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.lp import LPPlan
    from repro_torch.model import transformer as T
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=TP_PIPE_LAYERS)
    return cfg, T.build_structure(cfg, plan=LPPlan(tuple(
        (i, i + 1) for i in range(0, TP_PIPE_LAYERS, 2))))


def tp_pipe_pair(cfg, ms, pair):
    """LP pair ``pair``'s fp32 weights, drawn from the seed + 100 + pair on
    the card (so a stage draws its own pair only)."""
    import torch
    from repro_torch.model import stack as ST
    from repro_torch.model.params import init_tree
    return init_tree(ST.group_template(cfg, ms.segments[0].group, 1),
                     torch.Generator(device="cuda").manual_seed(SEED + 100 + pair),
                     torch.float32, "cuda")


def tp_pipe_inputs(cfg):
    """(h)'s microbatches [TP_PIPE_MICRO, 1, TP_PIPE_S, D] fp32 and positions."""
    import torch
    x = torch.randn((TP_PIPE_MICRO, 1, TP_PIPE_S, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(SEED + 11))
    return x, torch.arange(TP_PIPE_S, device="cuda")[None]


def tp_pipe_stage_fn(cfg, ms, positions):
    """A stage: ``stack.apply_stack_full`` over one LP pair (one group)."""
    from repro_torch.model import stack as ST
    from repro_torch.parallel.context import ParallelContext
    seg = [ST.Segment(ms.segments[0].group, 1)]

    def stage_fn(params, x):
        return ST.apply_stack_full([params], x, seg, cfg=cfg, dims=ms.dims,
                                   pc=ParallelContext(), positions=positions)[0]
    return stage_fn


def tp_pipe_reference():
    """(h)'s unstaged forward in this process: the 16 layers (8 pairs, one
    segment) over each microbatch; saved for the ranks under build/tp."""
    import torch
    from repro_torch.model import stack as ST
    from repro_torch.model.params import stack_trees
    from repro_torch.parallel.context import ParallelContext
    cfg, ms = tp_pipe_structure()
    n_pairs = ms.segments[0].count
    seg = stack_trees([tp_pipe_pair(cfg, ms, i) for i in range(n_pairs)])
    x, positions = tp_pipe_inputs(cfg)
    t = time.perf_counter()
    with torch.no_grad():
        y = torch.stack([ST.apply_stack_full([seg], xm, ms.segments, cfg=cfg,
                                             dims=ms.dims, pc=ParallelContext(),
                                             positions=positions)[0] for xm in x])
    torch.cuda.synchronize()
    ms_ = (time.perf_counter() - t) * 1e3
    TP_PIPE_REF.parent.mkdir(parents=True, exist_ok=True)
    torch.save(y.cpu(), TP_PIPE_REF)
    del seg, y
    gc.collect()
    torch.cuda.empty_cache()
    return {"unstaged_ms": ms_}


def tp_pipe(world_pc):
    """(h), one rank: the world as the pipe, this rank's stage its LP pair
    (``stage_slice``), ``pipeline_apply`` over the microbatches; launches
    reconciled (per tick a flash launch and 2 dual RMSNorms) and the first
    of each on the stage's first microbatch (tick ``stage``: the ticks
    before it run on zeros) held against its plain version, the output
    against the unstaged forward's, collectives counted (a gather per tick,
    one sum)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.parallel import context
    from repro_torch.parallel.pp import pipe_group, pipeline_apply, stage_slice
    cfg, ms = tp_pipe_structure()
    group, stage = pipe_group()
    n_stages = world_pc.tp_size
    lo, hi = stage_slice(TP_PIPE_LAYERS, n_stages, stage)
    if (lo, hi) != (2 * stage, 2 * stage + 2):
        raise AssertionError(f"(h) stage {stage}: layers [{lo}, {hi}), want one LP pair")
    params = tp_pipe_pair(cfg, ms, stage)
    x, positions = tp_pipe_inputs(cfg)
    torch.cuda.synchronize()
    ops.reset_launches()
    context.reset_all_reduces()
    per_tick = {"flash_attention": 1, "dual_rmsnorm": norm_launches(cfg, 1)}
    t = time.perf_counter()
    with torch.no_grad(), DecodeProbe(ms, paged=False, steps=(), shapes=TP_FSDP_SHAPES, skip={
            name: n * stage for name, n in per_tick.items()}) as probe:
        y = pipeline_apply(tp_pipe_stage_fn(cfg, ms, positions), params, x, group=group,
                           stage=stage, n_stages=n_stages)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    ticks = TP_PIPE_MICRO + n_stages - 1
    launches = dict(ops.LAUNCHES)
    err_kernels = probe.check(f"(h) stage {stage}")
    reconcile(f"(h) stage {stage}", launches, {
        "flash_attention": ticks, "dual_rmsnorm": per_tick["dual_rmsnorm"] * ticks,
        "decode_attention": 0, "decode_attention_pair": 0, "decode_attention_paged": 0,
        "decode_attention_pair_paged": 0, "ssm_scan": 0})
    col = {**context.ALL_REDUCES, **context.ALL_GATHERS}
    if col != {"sum": 1, "max": 0, "gather": ticks}:
        raise AssertionError(f"(h) stage {stage}: collectives {col}, want a gather per "
                             f"tick ({ticks}) and one sum")
    want = torch.load(TP_PIPE_REF).cuda()
    err = float((y - want).abs().max())
    return {"stage": stage, "layers": [lo, hi], "launches": launches, "collectives": col,
            "max_abs_err": err, "bitwise": bool(torch.equal(y, want)), "wall_ms": wall_ms,
            "ticks": ticks, "path_max_abs_err": err_kernels}


def tp_fsdp_pipe_held(got, fsdp_ref, pipe_ref):
    """(g)'s and (h)'s checks over the tp8 ranks' results ``got``, against
    (g)'s tp = 1 streams and (h)'s unstaged forward (``pipe_ref``: its
    metrics; the output is in ``TP_PIPE_REF``). Returns ({path: launches
    summed over the ranks}, metrics)."""
    fsdp = tp_fsdp_held(fsdp_ref, got)
    by_path, metrics = {}, {}
    for path, key in (("tp8_fsdp_generate", "bf16"), ("tp8_fsdp_int8_generate", "int8"),
                      ("tp8_fsdp_engine", "engine")):
        by_path[path] = {k: sum(r["fsdp"][key]["launches"][k] for r in got)
                         for k in got[0]["fsdp"][key]["launches"]}
    fsdp["path_max_abs_err"] = {key: max(r["fsdp"][key]["path_max_abs_err"] for r in got)
                                for key in ("bf16", "int8", "engine")}
    metrics["tp8_fsdp"] = fsdp
    for key in ("bf16", "int8"):
        r0 = fsdp["rank0"][key]
        log(f"[tp8] (g) FSDP {key} shards on the (2, 2, 2) grid: sharded_generate "
            f"{fsdp['equal_streams'][key][0]}/{fsdp['equal_streams'][key][1]} streams "
            f"equal to tp = 1{' on the dequantised weights' if key == 'int8' else ''} "
            f"(fp32 compute; the rest at near-ties), every rank equal to rank 0; "
            f"prefill {r0['prefill_ms']:.1f} ms, decode {r0['decode_ms_per_step']:.1f} ms "
            f"per step over gloo (not a speed); launches on every rank within "
            f"{fsdp['path_max_abs_err'][key]:.3e} of their plain versions; a rank's shards "
            f"{fsdp['rank_shard_bytes'][key]} bytes; one serve step's collectives "
            f"{ {k: r0['collectives'][k] for k in ('sum', 'max', 'gather')} } (the "
            f"gathers from the leaf list)")
    e0 = fsdp["rank0"]["engine"]
    log(f"[tp8] (g) FSDP engine: {fsdp['equal_streams']['engine'][0]}/"
        f"{fsdp['equal_streams']['engine'][1]} streams equal to the FSDP sharded_generate's, "
        f"prefix hits {e0['prefix_hits']}, suffix prefills {e0['suffix_prefills']}, "
        f"launches within {fsdp['path_max_abs_err']['engine']:.3e} of plain, "
        f"{e0['steps']} steps in {e0['wall_ms']:.1f} ms over gloo; launches on all {TP8} "
        f"ranks {by_path['tp8_fsdp_engine']}")
    # (h) the pipeline, from the same ranks
    pipe = [r["pipe"] for r in got]
    for rank, r in enumerate(pipe):
        if r["stage"] != rank or r["max_abs_err"] > TP_PIPE_TOL:
            raise AssertionError(f"(h) rank {rank}: stage {r['stage']}, output "
                                 f"{r['max_abs_err']:.3e} from the unstaged forward's "
                                 f"(tol {TP_PIPE_TOL:g})")
    by_path["tp8_pipeline"] = {k: sum(r["launches"][k] for r in pipe)
                               for k in pipe[0]["launches"]}
    metrics["tp8_pipeline"] = {
        "layers": TP_PIPE_LAYERS, "stages": TP8, "microbatches": TP_PIPE_MICRO,
        "seq": TP_PIPE_S, "max_abs_err": max(r["max_abs_err"] for r in pipe),
        "bitwise": all(r["bitwise"] for r in pipe), "wall_ms": [r["wall_ms"] for r in pipe],
        "path_max_abs_err": max(r["path_max_abs_err"] for r in pipe),
        "collectives": pipe[0]["collectives"], **pipe_ref}
    log(f"[tp8] (h) pipeline of {TP8} stages, {TP_PIPE_LAYERS} layers (one LP pair a "
        f"stage), {TP_PIPE_MICRO} microbatches of [1, {TP_PIPE_S}]: output within "
        f"{metrics['tp8_pipeline']['max_abs_err']:.3e} of the unstaged forward (tol "
        f"{TP_PIPE_TOL:g}; bit for bit: {metrics['tp8_pipeline']['bitwise']}); each "
        f"stage's first flash and dual RMSNorm launch on its first microbatch within "
        f"{metrics['tp8_pipeline']['path_max_abs_err']:.3e} of plain; "
        f"{pipe[0]['ticks']} ticks, collectives per stage {pipe[0]['collectives']}; "
        f"rank 0 {pipe[0]['wall_ms']:.1f} ms over gloo, the unstaged forward "
        f"{pipe_ref['unstaged_ms']:.1f} ms; launches on all ranks {by_path['tp8_pipeline']}")
    return by_path, metrics


TP_CASES = {"tp2": tp_case_tp2, "tp8": tp_case_tp8}


def tp_reference(n_new, n_layers=TP2_LAYERS, eff_depth=TP2_EFF_DEPTH):
    """tp = 1 in this process on the same weights: the fp32-compute streams
    the ranks are held to, and the model (for ``held_to``'s near-tie
    check)."""
    from repro_torch.parallel.context import ParallelContext
    pc = ParallelContext()
    cfg, ms, params = tp_model(pc, n_layers, eff_depth)
    work = tp_traffic(cfg.vocab_size, n_new)
    gen, streams = tp_streams(pc, cfg, ms, params, work, n_new)
    return cfg, ms, params, work, gen, streams


def tp_check_ranks(what, got):
    """Every rank returned the same tokens (host decisions agree)."""
    for rank, r in enumerate(got[1:], 1):
        if r["generate"] != got[0]["generate"] or r["engine"] != got[0]["engine"]:
            raise AssertionError(f"{what}: rank {rank}'s tokens differ from rank 0's")


def tp_launches(timed):
    """Launches summed over the ranks (``timed``: each rank's ``tp_timed``
    result), per path, and the head-mapped ones."""
    paths = {}
    for path in timed[0]:
        paths[path] = {k: sum(r[path]["launches"][k] for r in timed)
                       for k in timed[0][path]["launches"]}
        paths[path + ":head_map"] = {
            k: sum(r[path]["head_map_launches"][k] for r in timed)
            for k in timed[0][path]["head_map_launches"]}
    return paths


def tp_family_held(name, ref, got):
    """The ranks' streams of one family of (c) against tp = 1's (``ref``),
    all equal or leaving at a near-tie of tp = 1's logits; tp = 1's model
    is made anew (from the seed) only where a stream differs. Returns
    {path: (equal streams, streams)}."""
    import numpy as np
    import torch
    from repro_torch.parallel.context import ParallelContext
    _, gen_pairs, eng_pairs = TP_FAMILIES[name]
    out = {}
    for path, pairs in (("generate", gen_pairs), ("engine", eng_pairs)):
        want, have = ref[path], got[0][path]
        if want == have:
            out[path] = (len(want), len(want))
            continue
        cfg, ms, params = tp_family_model(ParallelContext(), name, pairs)
        work = (tp_traffic(cfg.vocab_size, TP_FAMILY_NEW) if path == "engine" else
                [(0, p, TP_FAMILY_NEW) for p in tp_prompts(cfg).cpu().numpy()])
        pms = no_drops(ms) if cfg.moe_experts else ms
        set_compute_dtype(params, torch.float32)
        out[path] = (held_to(f"tp2 {name} {path}", [(params, pms)] * len(work), work,
                             [np.array(x) for x in have], [np.array(x) for x in want]),
                     len(want))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_encdec_held(name, want, got):
    """A stream set of (d) against tp = 1's (``want``), equal or leaving at
    a near-tie of tp = 1's logits; tp = 1's model is made anew (from the
    seed) only where a stream differs. Returns the count of equal
    streams."""
    import numpy as np
    import torch
    from repro_torch.parallel.context import ParallelContext
    if want == got:
        return len(want)
    cfg, ms, params = tp_encdec_model(ParallelContext(), name)
    prompts, extras, max_len = tp_encdec_inputs(cfg)
    extras = fp32_inputs(extras)
    set_compute_dtype(params, torch.float32)
    n = held_to(f"tp2 {name}", [(params, ms)] * B,
                [(0, p, TP_ENCDEC_NEW) for p in prompts.cpu().numpy()],
                [np.array(x) for x in got], [np.array(x) for x in want],
                inputs=[{k: v[i:i + 1] for k, v in extras.items()} for i in range(B)],
                max_len=max_len)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return n


def tp_path():
    """Phase 15: tensor-parallel serving over ``TP_BACKEND``, every rank a
    process on the one card. (a) tp = 2, tinyllama at ``TP2_LAYERS`` layers:
    the collectives of a prefill and a serve step held to the dry run's
    record, timed bf16 runs probed; (c) the four families and (d) whisper
    and paligemma (both kv modes) in (a)'s ranks, held to tp = 1 (near-tie
    rule); (b) tp = 8 at ``TP8_LAYERS``
    layers: the head-mapped paged kernels on every rank, tokens == tp = 1,
    and (e) the sequence-sharded ring: tokens == the heads mode's == tp =
    1's. Returns ({path: launches}, metrics)."""
    import torch
    by_path = {}

    # (a) tp = 2 after the probe; then (c) in the same ranks,
    # whose tp = 1 references this process makes first, one model at a time
    from repro_torch.parallel.context import ParallelContext
    t = time.perf_counter()
    fam_ref, fam_ref_s = {}, {}
    for name in TP_FAMILIES:
        t1 = time.perf_counter()
        fam_ref[name] = tp_family(ParallelContext(), name, timed=False)
        fam_ref_s[name] = time.perf_counter() - t1
    for name in TP_ENCDEC:   # (d): tp = 1 runs the heads layout only
        t1 = time.perf_counter()
        fam_ref[name] = tp_encdec(ParallelContext(), name, timed=False, modes=("heads",))
        fam_ref_s[name] = time.perf_counter() - t1
    cfg, ms = tp_structure(TP2)
    ref_s = time.perf_counter() - t
    t = time.perf_counter()
    got = tp_spawn("tp2", TP2)
    tp2_s = time.perf_counter() - t
    metrics = {"backend": TP_BACKEND, "probe_dtypes": tp_probe(got),
               "nccl_not_run": TP_NCCL_NOT_RUN}
    # (a)'s streams are the serve command's at --mesh 1x2 (phase 14 (d));
    # here the ranks' collectives are held to the dry run's
    coll = tp_records_held(ms, got)
    for path, launches in tp_launches([r["timed"] for r in got]).items():
        by_path[f"tp2_{path}"] = launches
    metrics["tp2"] = {"world": TP2, "layers": cfg.n_layers, "groups": model_counts(ms)[0],
                      "tp1_reference_s": ref_s, "run_s": tp2_s,
                      "records_equal_dry": True, "collective_bytes": coll,
                      "rank0": got[0]["timed"], "rank_weights_bytes": got[0]["weights_bytes"],
                      "all_reduces": got[0]["all_reduces"]}
    log(f"[tp2] {TP_BACKEND}, world {TP2}: every rank's collectives of a prefill "
        f"({coll['prefill']['n_ops']:.0f} all_reduce, {coll['prefill']['total']:.0f} B) and "
        f"a serve step ({coll['decode']['n_ops']:.0f}, {coll['decode']['total']:.0f} B on "
        f"the wire) equal the dry run's record (kinds, bytes, groups, axes, order); "
        f"tp = 1 references of (c) and (d) {ref_s:.1f} s, ranks (with (c)) {tp2_s:.1f} s")

    # (c) the families, from the same ranks
    metrics["tp2_families"] = {}
    for name in TP_FAMILIES:
        fam = [r["families"][name] for r in got]
        for rank, r in enumerate(fam[1:], 1):
            if r["generate"] != fam[0]["generate"] or r["engine"] != fam[0]["engine"]:
                raise AssertionError(f"tp=2 {name}: rank {rank}'s tokens differ from "
                                     "rank 0's")
        held = tp_family_held(name, fam_ref[name], fam)
        for path, launches in tp_launches([r["timed"] for r in fam]).items():
            by_path[f"tp2_{name}_{path}"] = launches
        ar = [r["all_reduces"] for r in fam]
        metrics["tp2_families"][name] = {
            "layers": TP_FAMILIES[name][0], "generate_pairs": TP_FAMILIES[name][1],
            "engine_pairs": TP_FAMILIES[name][2], "tp1_reference_s": fam_ref_s[name],
            "equal_streams": held, "rank0": fam[0]["timed"], "all_reduces": ar[0]}
        log(f"[tp2] {name}: sharded_generate {held['generate'][0]}/{held['generate'][1]} "
            f"and engine {held['engine'][0]}/{held['engine'][1]} streams equal to tp = 1 "
            f"(fp32 compute; the rest at near-ties); one decode step's all_reduce "
            f"{ {k: ar[0][k] for k in ('sum', 'max')} } over {ar[0]['groups']} groups "
            f"({ar[0]['pairs']} LP pairs); tp = 1 reference {fam_ref_s[name]:.1f} s")

    # (d) whisper and paligemma, from the same ranks
    metrics["tp2_encdec"] = {}
    for name in TP_ENCDEC:
        runs = [r["encdec"][name] for r in got]
        metrics["tp2_encdec"][name] = m = {"layers": TP_ENCDEC[name][0],
                                           "tp1_reference_s": fam_ref_s[name]}
        for mode in TP_ENCDEC[name][1]:
            for rank, r in enumerate(runs[1:], 1):
                if r[mode]["generate"] != runs[0][mode]["generate"]:
                    raise AssertionError(f"tp=2 {name} kv_mode={mode}: rank {rank}'s "
                                         "tokens differ from rank 0's")
            n_eq = tp_encdec_held(name, fam_ref[name]["heads"]["generate"],
                                  runs[0][mode]["generate"])
            for path, launches in tp_launches([r[mode]["timed"] for r in runs]).items():
                by_path[f"tp2_{name}_{mode}_{path}"] = launches
            col = runs[0][mode]["collectives"]
            m[mode] = {"equal_streams": (n_eq, B), "rank0": runs[0][mode]["timed"],
                       "collectives": col}
            log(f"[tp2] {name} kv_mode={mode}: sharded_generate {n_eq}/{B} streams "
                f"equal to tp = 1 (fp32 compute; the rest at near-ties), every rank "
                f"equal to rank 0; one serve step's collectives "
                f"{ {k: col[k] for k in ('sum', 'max', 'gather')} } over "
                f"{col['groups']} groups; tp = 1 reference {fam_ref_s[name]:.1f} s")

    # (b) tp = 8 at TP8_LAYERS layers: replicated kv, head-mapped paged decode
    t = time.perf_counter()
    cfg, ms, params, work, gen1, eng1 = tp_reference(TP8_NEW, TP8_LAYERS, TP8_EFF_DEPTH)
    ref_s = time.perf_counter() - t
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    train_ref = tp_train_reference()        # (f)'s tp = 1 run, before the ranks
    train_ref_s = time.perf_counter() - t
    t = time.perf_counter()
    fsdp_ref = tp_fsdp_reference()          # (g)'s tp = 1 streams
    pipe_ref = tp_pipe_reference()          # (h)'s unstaged forward
    gh_ref_s = time.perf_counter() - t
    t = time.perf_counter()
    got = tp_spawn("tp8", TP8)
    tp8_s = time.perf_counter() - t
    tp_check_ranks("tp=8", got)
    if got[0]["generate"] != gen1 or got[0]["engine"] != eng1:
        raise AssertionError("tp = 8 tokens differ from tp = 1")
    for rank, r in enumerate(got):
        hm = r["timed"]["engine"]["head_map_launches"]
        if r["head_map"] != [rank // 2] or not all(hm.values()):
            raise AssertionError(f"tp = 8 rank {rank}: head map {r['head_map']}, "
                                 f"head-mapped launches {hm}")
    for path, launches in tp_launches([r["timed"] for r in got]).items():
        by_path[f"tp8_{path}"] = launches
    # (e) the sequence-sharded ring: the heads mode's tokens and tp = 1's
    for rank, r in enumerate(got):
        if r["seq"]["generate"] != gen1 or r["seq"]["generate"] != r["generate"]:
            raise AssertionError(f"tp = 8 rank {rank}: kv_mode='seq' tokens differ from "
                                 "the heads mode's or tp = 1's")
    for path, launches in tp_launches([r["seq"]["timed"] for r in got]).items():
        by_path[f"tp8_seq_{path}"] = launches
    metrics["tp8"] = {"world": TP8, "layers": cfg.n_layers, "groups": model_counts(ms)[0],
                      "tp1_reference_s": ref_s, "run_s": tp8_s,
                      "tokens_equal_tp1": True, "rank0": got[0]["timed"],
                      "head_maps": [r["head_map"] for r in got],
                      "seq": {"tokens_equal_heads_and_tp1": True,
                              "rank0": got[0]["seq"]["timed"],
                              "collectives": got[0]["seq"]["collectives"]}}
    log(f"[tp8] kv_mode='seq': sharded_generate tokens == the heads mode's == tp = 1's "
        f"on every rank; one serve step's collectives "
        f"{ {k: got[0]['seq']['collectives'][k] for k in ('sum', 'max', 'gather')} }")
    # (f) the sharded trainer, from the same ranks
    train = tp_train_held(train_ref, got)
    train["tp1_reference_s"] = train_ref_s
    by_path["tp8_train_eval"] = {k: sum(r["train"]["eval_launches"][k] for r in got)
                                 for k in got[0]["train"]["eval_launches"]}
    metrics["tp8_train"] = train
    for mode, res in train["modes"].items():
        log(f"[tp8] (f) {mode} on the (2, 2, 2) grid: loss per step "
            f"{[m['loss'] for m in res['metrics']]}, grad_norm "
            f"{[m['grad_norm'] for m in res['metrics']]}; ms per step over gloo "
            f"(not a speed) {['%.1f' % x for x in res['step_ms']]}; collectives per "
            f"step {res['collectives'][0]} (as predicted from the leaf list)")
    log(f"[tp8] (f) tp = 1 loss {[m['loss'] for m in train_ref['metrics']]}, grad_norm "
        f"{[m['grad_norm'] for m in train_ref['metrics']]}; largest relative error of "
        f"zero and fsdp {max(e for k, e in train['rel_err_vs_tp1'].items() if not k.startswith('compress')):.3e} "
        f"(tol {TP_TRAIN_TOL:g}); compressed step 1 loss "
        f"{train['rel_err_vs_tp1']['compress_loss_0']:.3e} (tol {TP_TRAIN_TOL:g}) and "
        f"grad_norm {train['rel_err_vs_tp1']['compress_grad_norm_0']:.3e} (tol "
        f"{TP_TRAIN_COMPRESS_NORM_TOL:g}) from tp = 1's, loss after step "
        f"{TP_TRAIN_STEPS} {train['compress_loss_diff']:.3e} from the uncompressed (tol "
        f"{TP_TRAIN_COMPRESS_TOL:g}); every rank equal to rank 0")
    log(f"[tp8] (f) eval step: loss {train['eval']['eval_loss']:.6f} (kernels) vs the "
        f"train forward's {train['eval']['train_forward_loss']:.6f}; launches per rank "
        f"{train['eval']['eval_launches']}, first launches within "
        f"{train['eval']['eval_path_max_abs_err']:.3e} of plain; on all {TP8} ranks "
        f"{by_path['tp8_train_eval']}")
    # (g) FSDP serving and (h) the pipeline, from the same ranks
    gh_paths, gh = tp_fsdp_pipe_held(got, fsdp_ref, pipe_ref)
    gh["tp8_fsdp"]["tp1_references_s"] = gh_ref_s
    by_path.update(gh_paths)
    metrics.update(gh)
    log(f"[tp8] {TP_BACKEND}, world {TP8}: tokens == tp = 1 (sharded_generate "
        f"{B} x {TP8_NEW}, engine {len(work)} streams); every rank launched both "
        f"paged kernels with its head map [rank // 2]; tp = 1 reference {ref_s:.1f} s, "
        f"ranks {tp8_s:.1f} s")
    log(f"[tp] backend {TP_BACKEND} over the host, not NCCL: correctness runs, not "
        f"speed. Paths no card ran: {'; '.join(TP_NCCL_NOT_RUN)}")
    return by_path, metrics


# ---------------------------------------------------------------------------

KERNELS = {
    "dual_rmsnorm": ("cuda", "src/repro_torch/csrc/dual_rmsnorm.cu",
                     "src/repro/kernels/dual_rmsnorm.py:37"),
    "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:130"),
    "decode_attention_pair": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                              "src/repro/kernels/decode_attention.py:142"),
    "decode_attention_paged": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:258"),
    "decode_attention_pair_paged": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:273"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:92"),
    "ssm_scan": ("cuda", "src/repro_torch/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:50"),
}


def ptxas_summary(log_text):
    """One line per compiled kernel of an ``nvcc -Xptxas=-v`` log: its name
    with its template arguments, registers and spill bytes."""
    import re
    out, name, spill = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            # _ZN<namespace><len>name[I<template arguments>E]...: the
            # arguments as values (L[ib]<n>E) and type names (<len>name).
            k = re.search(r"\d+([a-z][a-z_]*kernel)(I(?:L[ib]-?\d+E|\d+\w+?(?=L|E)|[a-z])+E)?",
                          m.group(1))
            args = re.findall(r"L[ib](-?\d+)E|\d+(__nv_\w+?)(?=L|E)|I([fd])", k.group(2) or "") \
                if k else []
            name = (k.group(1) if k else m.group(1)) + (
                f"<{','.join(''.join(a) for a in args)}>" if args else "")
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            spill = f"spill {st} B stores / {ld} B loads"
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill}")
            name, spill = None, ""
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build   # fails outside a checkout of the repo
    if sys.argv[1:2] == ["--tp-rank"]:          # one rank of phase 15
        return tp_child(json.loads(sys.argv[2]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    per_source = build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f}s "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in per_source.items()) or 'cached'})")
    for src in build.SOURCES:
        for line in ptxas_summary(build.library_path(src).with_suffix(".log").read_text()):
            log(f"  {src}: {line}")

    if sys.argv[1:] == ["--norm-times"]:
        from repro_torch.kernels import ops
        print(json.dumps({"norm_times": norm_times(ops), "smi": smi.splitlines()[0]}))
        return 0
    if sys.argv[1:] == ["--decode-times"]:
        print(json.dumps({"decode_times": decode_times(), "smi": smi.splitlines()[0]}))
        return 0
    phase_s = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        log(f"[time] {name}: {phase_s[name]:.1f}s")
        return out

    phase_s["build"] = time.perf_counter() - t0
    rows = phase("3 kernels", check_kernels)
    phase("4 reduced parity", lambda: (reduced_parity(), reduced_mamba_parity(),
                                        full_width_cut("granite-34b", 2, 32),
                                        reduced_hybrid_parity(),
                                        full_width_cut(HYBRID, 3, 16),
                                        reduced_prefix_encdec_parity(),
                                        full_width_cut(PALI, 2, 16, prefix=True),
                                        interventions_parity()))
    by_path = {}                              # each path reads its own counts
    by_path["generate"], e2e = phase("5 generate", main_path)
    cfg, ms, params = tinyllama_model()
    by_path["engine"], engine, plain = phase("6 engine", engine_path, cfg, ms, params)
    by_path["engine_spec"], spec = phase("8 spec engine", spec_path, cfg, ms, params,
                                         plain, engine["steps"])
    by_path["engine_degraded"], degraded = phase("8 degraded engine", degraded_path,
                                                 cfg, ms, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()                  # the tinyllama weights are gone
    by_path["mamba_generate"], by_path["mamba_engine"], mamba_gen, mamba_eng = phase(
        "7 mamba", mamba_path)
    dense = {}
    for name in DENSE:
        gc.collect()
        torch.cuda.empty_cache()              # the previous model's weights are gone
        (by_path[f"{name}_generate"], by_path[f"{name}_engine"],
         dense[name]) = phase(f"9 {name}", dense_path, name)
    gc.collect()
    torch.cuda.empty_cache()                  # the dense models' weights are gone
    (by_path[f"{HYBRID}_generate"], by_path[f"{HYBRID}_engine"],
     by_path[f"{HYBRID}_window"], hybrid) = phase(f"10 {HYBRID}", hybrid_path)
    moe = {}
    for name in MOE:
        gc.collect()
        torch.cuda.empty_cache()              # the previous model's weights are gone
        paths, moe[name] = phase(f"11 {name}", moe_path, name)
        by_path.update({f"{name}_{path}": launches for path, launches in paths.items()})
    prefix_encdec = {}
    for name, fn in ((PALI, prefix_lm_path), (WHISPER, encdec_path)):
        gc.collect()
        torch.cuda.empty_cache()              # the previous model's weights are gone
        by_path[f"{name}_generate"], prefix_encdec[name] = phase(f"12 {name}", fn)
    gc.collect()
    torch.cuda.empty_cache()                  # whisper's weights are gone
    train = {"cut": phase("13 train cut", train_cut_parity)}
    by_path["train"], train["finetune"] = phase("13 train", train_path)
    gc.collect()
    torch.cuda.empty_cache()                  # the training state is gone
    tools_launches, tools = phase("14 tools", tools_path, smi.splitlines()[0])
    by_path.update(tools_launches)
    gc.collect()
    torch.cuda.empty_cache()
    tp_launches_by_path, tp = phase("15 tensor parallel", tp_path)
    head_map_by_path = {k.split(":")[0]: v for k, v in tp_launches_by_path.items()
                        if k.endswith(":head_map")}
    by_path.update({k: v for k, v in tp_launches_by_path.items()
                    if not k.endswith(":head_map")})
    for name in KERNELS:
        if not sum(p[name] for p in by_path.values()):
            raise AssertionError(f"{name} was launched on no main path")
    for path in ("mamba_generate", "mamba_engine"):
        if not by_path[path]["ssm_scan"]:
            raise AssertionError(f"ssm_scan was not launched on {path}")
    for path in ("engine_spec", "engine_degraded"):
        for name in ("dual_rmsnorm", "decode_attention_pair_paged", "flash_attention"):
            if not by_path[path][name]:
                raise AssertionError(f"{name} was not launched on {path}")
    for path, names in (("generate", ("decode_attention",)),
                        ("engine", ("decode_attention_paged",)),
                        ("window", ("decode_attention",))):
        for name in names + ("flash_attention", "ssm_scan", "dual_rmsnorm"):
            if not by_path[f"{HYBRID}_{path}"][name]:
                raise AssertionError(f"{name} was not launched on {HYBRID} {path}")
    for name in ("flash_attention", "dual_rmsnorm", "decode_attention",
                 "decode_attention_pair"):
        if not by_path["train"][name]:
            raise AssertionError(f"{name} was not launched on train")
    for path, names in (("tp2_generate", ("decode_attention", "decode_attention_pair")),
                        ("tp2_engine", ("decode_attention_paged",
                                        "decode_attention_pair_paged")),
                        ("tp8_engine", ("decode_attention_paged",
                                        "decode_attention_pair_paged"))):
        for name in names + ("flash_attention", "dual_rmsnorm"):
            if not by_path[path][name]:
                raise AssertionError(f"{name} was not launched on {path}")
    # (g) and (h): flash and the dual RMSNorm on every FSDP path and in the
    # pipeline's stages, the pair's ring and paged decode forms on FSDP's
    for path, names in (("tp8_fsdp_generate", ("decode_attention_pair",)),
                        ("tp8_fsdp_int8_generate", ("decode_attention_pair",)),
                        ("tp8_fsdp_engine", ("decode_attention_pair_paged",)),
                        ("tp8_pipeline", ())):
        for name in names + ("flash_attention", "dual_rmsnorm"):
            if not by_path[path][name]:
                raise AssertionError(f"{name} was not launched on {path}")
    for name in ("decode_attention_paged", "decode_attention_pair_paged"):
        if not head_map_by_path["tp8_engine"][name]:
            raise AssertionError(f"{name} took no head map on tp8_engine")
    # (d) and (e): flash (the encoder's, the cross-attention's and the prefix
    # mask at the rank's heads) on every path, the pair's ring decode where
    # the heads layout keeps it; the sequence-sharded rings launch no decode
    # kernel (``tp_timed`` reconciles them to 0)
    for path, names in ((f"tp2_{WHISPER}_heads_generate", ("decode_attention_pair",)),
                        (f"tp2_{PALI}_heads_generate", ("decode_attention_pair",
                                                        "dual_rmsnorm")),
                        (f"tp2_{PALI}_seq_generate", ("dual_rmsnorm",)),
                        ("tp8_seq_generate", ("dual_rmsnorm",))):
        for name in names + ("flash_attention",):
            if not by_path[path][name]:
                raise AssertionError(f"{name} was not launched on {path}")
    # (c): the scan on the recurrent families' tp = 2 paths, flash and the
    # ring / paged decode kernels on those with attention (the pair forms
    # where an attention pair runs: dbrx, llama4), and recurrentgemma's
    # replicated kv head read through the paged kernel's head map (its pairs
    # are RG-LRU pairs, so the pair kernel's head-mapped form is held in
    # phase 3 at its shape)
    for name in TP_FAMILIES:
        for path in ("generate", "engine"):
            paged = "_paged" if path == "engine" else ""
            names = (("ssm_scan",) if name in (MAMBA, HYBRID) else ()) + (
                () if name == MAMBA else ("flash_attention", f"decode_attention{paged}")) + (
                (f"decode_attention_pair{paged}",) if name in (DBRX, LLAMA4) else ())
            for kernel in names:
                if not by_path[f"tp2_{name}_{path}"][kernel]:
                    raise AssertionError(f"{kernel} was not launched on tp2 {name} {path}")
    if not head_map_by_path[f"tp2_{HYBRID}_engine"]["decode_attention_paged"]:
        raise AssertionError(f"decode_attention_paged took no head map on tp2 {HYBRID} "
                             "engine")
    for path in ("serve_oneshot", "serve_continuous", "serve_spec", "serve_degraded"):
        for name in ("flash_attention", "dual_rmsnorm"):
            if not by_path[path][name]:
                raise AssertionError(f"{name} was not launched on {path}")
    for model, names in ((PALI, ("dual_rmsnorm",)), (WHISPER, ())):
        for name in names + ("flash_attention", "decode_attention", "decode_attention_pair"):
            if not by_path[f"{model}_generate"][name]:
                raise AssertionError(f"{name} was not launched on {model} generate")

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        # Times in the type the paths launch: bf16, except the scan, whose
        # operands ssm_mix builds in fp32 whatever the weights' type.
        dtype = torch.float32 if name == "ssm_scan" else torch.bfloat16
        r = rows[(name, dtype)]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "dtype": str(dtype).split(".")[1],
                        "launches": sum(p[name] for p in by_path.values()),
                        "launches_by_path": {k: p[name] for k, p in by_path.items()},
                        "max_abs_err": max(rows[(name, d)]["max_abs_err"]
                                           for d in (torch.bfloat16, torch.float32)),
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        if name == "flash_attention":
            kernels[-1]["engine_bucket"] = rows[("flash_attention_bucket", dtype)]
        if name == "ssm_scan":
            kernels[-1]["shapes"] = {f"{k[1]} {str(k[2]).split('.')[1]}": e
                                     for k, e in rows.items() if k[0] == "ssm_shape"}
        if name in ("decode_attention_paged", "decode_attention_pair_paged"):
            kernels[-1]["verify"] = {str(d).split(".")[1]: rows[("verify", name, d)]
                                     for d in (torch.bfloat16, torch.float32)}
            kernels[-1]["head_map_launches_by_path"] = {
                k: p[name] for k, p in head_map_by_path.items()}
            kernels[-1]["head_map"] = {
                f"{k[2]} {str(k[3]).split('.')[1]}": e for k, e in rows.items()
                if k[0] == "head_map" and k[1] == name}
        at_dense = {f"{k[3]} {k[2]}": {**e, "fp32_max_abs_err": rows[(*k[:4], torch.float32)]
                                       ["max_abs_err"]}
                    for k, e in rows.items()
                    if k[0] == "dense" and k[1] == name and k[4] == torch.bfloat16}
        if at_dense:
            kernels[-1]["dense_shapes"] = at_dense
        if name == "dual_rmsnorm":
            kernels[-1].update(library="two F.rms_norm calls, one per path (timed only)",
                               shapes=rows["dual_rmsnorm_shapes"])
    print(json.dumps({"kernels": kernels, "launch_floor_ms": rows["launch_floor_ms"],
                      "launch_floor_pdl_ms": rows["launch_floor_pdl_ms"],
                      **e2e, "engine": engine, "engine_spec": spec,
                      "engine_degraded": degraded,
                      "mamba": {"generate": mamba_gen, "engine": mamba_eng},
                      "dense": dense, "hybrid": hybrid, "moe": moe,
                      "prefix_encdec": prefix_encdec, "train": train,
                      "tools": tools, "tensor_parallel": tp, "phase_s": phase_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
