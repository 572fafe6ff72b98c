#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing the result line:

1. build    — compile every ``src/repro_torch/csrc/*.cu`` (one nvcc
              each, all at once), print ptxas's register/shared-memory
              lines (the scan kernels' registers, spills and shared
              memory by kernel) and hold the autotuner's register estimate against
              them;
2. kernels  — call each kernel's wrapper at the main path's shapes (gram:
              the 8192 x 8192 matrix of the toy rows, a ragged shape and
              one whose rows are no multiple of a tile; fupdate: the hot
              loop at S = 16, 32 and the init pass; decision: every
              bucket against 4096 packed support rows, with the entry
              the bucket picks) and hold it against its plain PyTorch
              version on the card; relaunch decision on the same inputs
              (bitwise equal: its split sums are added in a fixed
              order); launch every menu entry of every family at a small
              ragged shape, in each precision its class takes, against
              its plain version and bitwise against its class's default
              entry;
3. main     — ``fit`` (f32 and bf16) then ``serve(...).score`` on the toy
              set at m = 8192, d = 128, with the kernels' launch counts
              set to 0 just before and read just after;
   shrink   — ``fit`` with no strategy at m = 32768 (f32 and bf16): it
              must take the shrinking driver, converge feasibly and agree
              with the blocked solve (``strategy="pallas"``) on the
              objective and both offsets; its solves (rows, offset,
              iterations) and fupdate's launches by class;
   paper    — the paper's Table 1 (linear, nu1 = 0.5, nu2 = 0.01,
              eps = 2/3, d = 2, m = 500-5000): the paper and mvp SMO,
              the blocked solver and the FISTA QP baseline, iterations,
              seconds (the second of two calls) and MCC; every SMO
              objective at most the QP's plus its tolerance;
   warm     — ``fit_update`` of the main path's f32 and bf16 fits after
              5% of the rows expire and 5% are appended, beside a cold
              fit of the same precision: warm route, every fupdate launch
              of the wide classes (the SIMT split tile, the wgmma split
              kernel), the same objective; the reconcile against the
              plain K @ gamma0; the artifact saved, loaded and refit
              bitwise;
   serve-wide — a bf16 model of d = 768 (BERT-base pooled embeddings)
              scored through the scorer at every bucket, and one of
              d = 2048 at the smallest, and the pooled screen's top
              bucket (d = 4096 against 32768 support rows), against the
              plain decision with no label flipped: each bucket takes a
              decision entry whose query tile fits d (a streamed one
              above 1664, the wide one at the pooled screen), and every
              entry that fits gives bitwise the same values; the wide
              entry's clusters a wave as the card gives them, held
              against tiling's;
   fleet    — the serving control plane: a ModelRegistry of three tenants
              (main-f32 and main-bf16 on the first 7783 [main] rows,
              wide-bf16 on [serve-wide]'s 4096 rows at d = 768), each
              fitted on first use; a few hundred requests of
              REQUEST_SIZES from one asyncio loop (``serve_async``)
              through an AdmissionController with per-tenant quotas and
              its AsyncDriver on the real clock, every result held against
              the tenant's direct score (bitwise at d = 128, within
              TOLERANCES at d = 768); one group that spans two buckets and
              one request over its quota (QuotaExceededError); a
              drift-gated refresh of main-f32 with the 409 remaining rows
              (warm: KS below 0.35, m = 8192, every fupdate launch wide)
              and with them shifted by 5 (cold), each objective within
              truth_tolerance of a cold fit of the same rows, the version
              bumped and later traffic scored by the new model; main-bf16
              published to shared memory and attached by a spawned process
              on the card that scores 1024 rows bitwise the publisher's,
              its leases counted 2, 1 and the segment unlinked; per bucket
              the traffic's launch latency (warm p50, p99) beside the
              scorer's and a ScoringService's on one quiet thread;
   dist     — the row-sharded solver and scorer in spawned rank processes
              (see ``_dist_phase``);
   ckpt     — ``FaultTolerantLoop`` over chunks of CKPT_CHUNK outer
              iterations of the blocked solve on the main path's rows (f32
              and bf16), checkpointed every 2 steps through its
              AsyncCheckpointer (keep 3), failures injected before steps
              3 and 6: two restarts, the final state bitwise the same loop
              run without failures, converged, feasible, the objective
              within truth_tolerance + 5e-3 of the main fit, 3 checkpoints
              left; a bf16 leaf through the manager on the card, bitwise;
   head     — ``fit_head`` on the card on 4096 toy rows at d = 768, held
              against the same head fitted on the CPU (no kernel launch:
              on-the-fly rows, as in the JAX package);
   cli      — ``repro_torch.launch.serve_slab`` in three processes at once:
              the single-model path (m = 8192, bf16, max batch 4096), the
              fleet (two models, deadlines, a quota, the async driver) and
              an attach of a model published here; JSON fields as the JAX
              package's CLI writes them, support rows and inside-slab
              counts as the same model served in process, streams' scores
              bitwise;
   lm       — the LM serving path (see ``_lm_phase``): the ten archs at
              their reduced sizes on the card against the CPU (logits,
              aux, decode against the full forward, MoE bitwise across
              calls); llama3.2-3b at full width, 2 layers, f32 against the
              CPU; at full width and depth in bf16, prefill 4 x 512
              tokens and 32 greedy decode steps twice (the same tokens;
              the first step's logits against a full forward; ms printed);
              the slab fitted on 2048 pooled, whitened hidden states
              (d = 3072, bf16, fupdate and decision launched, held
              against their plain versions and timed) scoring held-out
              and OOD text (AUC printed); ``repro_torch.launch.serve`` in
              a subprocess (its production path, on the (1, 1) mesh);
   lm-train — the LM training step (see ``_lm_train_phase``): the ten
              archs reduced, two steps on the card against the CPU (and
              twice on the card: bitwise or not); llama3.2-3b at full
              width, 2 layers, f32, one step's loss, grad norm and
              gradients against the CPU; at full width and depth in bf16
              (AdamW, remat "full"), 6 steps of 4 x 512 tokens: step time,
              tokens/s, MFU, peak memory, the step's split and a profiler
              window; the fault-tolerant loop with two injected failures;
              ``repro_torch.launch.train`` in a subprocess;
   lm-dist  — the sharded LM training step (see ``_lm_dist_phase``): four
              gloo ranks sharing the card on a (2, 2) mesh, LMD_ARCHS
              reduced ("tp" with fsdp, two steps) and llama3.2-3b at full
              width, 2 layers, f32 (tp with fsdp and Megatron's MLP, tp,
              fsdp: one step), each held against the single-device step
              on the card; then one NCCL rank on the (1, 1) mesh with
              [lm-train]'s configuration through the sharded code path:
              step ms, tokens/s, peak memory and host ms in collectives
              beside [lm-train]'s;
   lm-serve-dist — sharded LM serving (see ``_lm_serve_dist_phase``):
              four gloo ranks sharing the card on a (2, 2) mesh, under
              "tp" LMS_TP_ARCHS reduced, B = 1, a short SWA prompt and
              llama3.2-3b at full width, 2 layers, f32, under "fsdp"
              LMS_FSDP_ARCHS reduced and the short SWA prompt, prefill +
              greedy decode steps each held against the single-device
              run on the card (logits, tokens, every rank's cache shard);
              then one NCCL rank on the (1, 1) mesh with [lm]'s
              configuration, seed and prompt through the sharded path and
              the per-rank draw, under "tp" and under "fsdp", held step
              by step against the single-device run in the same process:
              prefill ms, decode ms a step, peak memory, collectives and
              host ms in them beside it;
   dryrun   — ``repro_torch.launch.dryrun`` (no card: rank 0 of the
              production mesh on meta tensors, a fake process group) in
              processes of its own for DRYRUN_CELLS, started before
              [examples] and read after [lm-ssm] (they use the host's
              cores while the card's phases run), each record's
              predicted peak, dominant term and MFU fraction printed;
              [lm-train]'s configuration predicted on the one-rank mesh:
              its argument bytes exactly the live train state's and a
              batch's, its peak beside the measured one (see
              ``_dryrun_phase``);
   examples — ``examples/torch_{quickstart,serve_ocssvm,lm_anomaly}.py``
              ``main()`` on the card: their numbers, fupdate (both
              classes) and decision launched, and fupdate held against
              its plain version at each fit's own shapes, d = 2 (see
              ``_examples_phase``);
   lm-ssm   — the scan kernels (``csrc/ssm_scan.cu``, ``csrc/wkv6.cu``;
              see ``_lm_ssm_phase``): each against its plain version at
              jamba's and rwkv6-7b's widths, timed beside its bound
              (wkv6 also at [lm-ssm] (c)'s training shape and one decode
              step, held and timed there too; its backward's workspace
              at most 128 MiB);
              rwkv6-7b served at full width and depth and trained at
              full width on 4 layers, each against the same run through
              the plain scans; one jamba Mamba block's forward and
              backward, peak memory through the kernels and through the
              chunked plain version. [lm], [lm-train], [lm-dist] (a) and
              [lm-serve-dist] (a) check that jamba's and rwkv6's layers
              launched the scan kernels, and [lm-train] that the card's
              two runs of both are bitwise equal;
4. autotune — the autotuner's path, with the counts set to 0 just before
              and read just after: a quick sweep on the card over
              ``QUICK_CELLS`` and the main path's fupdate and gram cells,
              in f32 (gram's SIMT class) and then bf16 (its wgmma class),
              its winners and seconds; then the f32 fit with the committed
              tile table and with an empty one, which must be bitwise
              equal;
5. timing   — device times of each kernel and its plain version (CUDA
              events around a CUDA graph of repeated calls), each with the
              menu entry it launched and where that came from, beside the
              least time the card could take (its bound) and, for gram
              linear, the one PyTorch call that computes the same
              (``x @ y.T``; ``torch.mm(..., out_dtype=float32)`` for 16-bit
              rows); what sets the wgmma gram's pace (its time at d = 64,
              128, 256, the output fixed) and a one-CTA fupdate (the floor
              of a launch in a graph); decision at every bucket and
              precision against SUPPORT rows and against the served
              model's, beside its plain version, its bound and its rbf
              exp floor, and at the top bucket with the linear kernel
              (no exp) beside rbf; bf16 decision at d = 768 and 2048;
              fupdate's wide classes at the warm path's shapes in f32
              and bf16; the scorer's latency per bucket on the host's
              clock, and its host share (latency minus the kernel's time
              at the bucket);
6. trace    — a torch.profiler window over PROFILE_ITERS iterations of
              the f32 fit: the device's busy and idle share from its own
              events, the top kernels by device time and the top
              operations by host time.

The last three lines are a JSON line with one entry per kernel, the
card's name and power limit as nvidia-smi gives them, and the result line
``{"ok": true, "device": {...}}``. Needs one card, the CUDA toolkit
(nvcc) and the repository's ``src/`` beside this file; imports nothing of
JAX.

    python3 chip_smoke.py --cards N

runs [dist] alone over N NCCL ranks, one card each (the cross-card path
a one-card run cannot reach), held against single-device fits of the
same rows on the first card, then [lm-dist] and [lm-serve-dist] over N
NCCL ranks (llama3.2-3b at full width and depth, bf16, on a (2, N/2)
mesh: training steps, then prefill and decode with the cache sharded,
under "tp" and under "fsdp"); it needs N cards.
"""
from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

SEED = 0
M, D = 8192, 128          # the largest m "auto" solves as one blocked solve
P, TOL = 16, 1e-3         # examples/serve_ocssvm.py's solver settings
# rbf width scaled with d (gamma * d = 1, as the example's 0.5 at d = 2).
# At d = 128 two toy rows lie ~39 apart in squared distance, so rbf(0.5)
# would make the Gram matrix nearly the identity and the uniform start
# nearly optimal: the solve could stop before its first iteration.
RBF_GAMMA = 1.0 / D
REQUEST_SIZES = (1, 63, 64, 65, 1000, 4096)
INIT_M = 2048             # the fused init pass: S = m <= BLOCK
# fupdate's (m, S): the hot loop at P = 8 and at P = 16, and the init pass.
FUPDATE_SHAPES = ((M, 16), (M, 2 * P), (INIT_M, INIT_M))
SUPPORT = 4096            # packed support rows the decision kernel meets
# [serve-wide]: the width of BERT-base pooled embeddings, scored at every
# bucket, and one past every resident 16-bit query tile (1664).
WIDE_D, WIDEST_D = 768, 2048
# ... and the pooled screen's launch (the benchmark's pooled4096 cells): the
# top bucket of d = 4096 rows against 32768 support rows, where the wide
# streamed entry runs (tiling.STREAMED_WIDE).
POOLED_D, POOLED_SUPPORT = 4096, 32768
SHRINK_M = 32768          # [shrink]: "auto" takes the shrinking driver
SOLVER_ATOL_FLOOR = 5e-3  # tests/test_engine_parity.py's solver floor
# [fleet]: windows of up to two top buckets (a group past 4096 rows spans
# buckets); a quota that binds below that (<= max_batch - 2); traffic in
# waves of FLEET_PER_WAVE requests a tenant, each with a deadline.
FLEET_MAX_BATCH = 2 * 4096
FLEET_QUOTA = 8000
FLEET_WAVES, FLEET_PER_WAVE = 25, 4
FLEET_DEADLINE_S = 0.01
# [fleet]'s attaching process: attach a published model on the card, score
# 1024 toy rows, save them, and report the attach time (the card's context
# made first, timed apart) and live leases.
FLEET_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from repro_torch.data import make_toy
from repro_torch.serve import attach, live_refs
key, spool = sys.argv[2], sys.argv[3]
t0 = time.perf_counter()
torch.zeros(1, device="cuda")             # the card's context, first
torch.cuda.synchronize()
context_s = time.perf_counter() - t0
t0 = time.perf_counter()
sm, lease = attach(key, dir=spool)
torch.cuda.synchronize()
attach_s = time.perf_counter() - t0
np.save(sys.argv[5], sm.score(make_toy(int(sys.argv[4]), 1024, d=sm.d)[0]))
refs = live_refs(key, dir=spool)
lease.close()
print(json.dumps({"attach_s": attach_s, "context_s": context_s,
                  "live_refs": refs, "device": str(sm.t_pad.device)}))
"""
# [dist]: requests of twice each bucket (per rank: every bucket, 64-4096)
# and one odd size; each spawned job's time limit (also its process
# group's timeout).
DIST_REQUESTS = (128, 512, 2048, 8192, 1001)
DIST_TIMEOUT_S = 600
# [ckpt]: outer iterations a step of the checkpointed fit, its steps, and
# the steps before which a failure is injected (checkpoints every 2 steps).
CKPT_CHUNK, CKPT_STEPS, CKPT_FAILS = 50, 12, (3, 6)
HEAD_M = 4096             # [head]: rows of pooled features at WIDE_D
# [cli]: each run of the serving CLI is ``repro_torch.launch.serve_slab``
# run as ``__main__`` (runpy, as ``python -m`` runs it) in a process of its
# own, which then writes its kernels' launches (from 0 at its start), its
# seconds from the interpreter's start-up on, and the scores of its
# request stream, if it ran one.
CLI_CHILD = """
import json, runpy, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import numpy as np
import repro_torch.serve as serve
from repro_torch.kernels.decision import ops as dec
from repro_torch.kernels.fupdate import ops as fup
counts_path, scores_path = sys.argv[2], sys.argv[3]
stream = serve.run_request_stream
def spy(svc, requests, coalesce=None):
    out = stream(svc, requests, coalesce=coalesce)
    np.save(scores_path, np.concatenate([np.asarray(s) for s in out]))
    return out
serve.run_request_stream = spy
sys.argv = ["serve_slab"] + sys.argv[4:]
runpy.run_module("repro_torch.launch.serve_slab", run_name="__main__",
                 alter_sys=True)
with open(counts_path, "w") as f:
    json.dump({"fupdate": [[list(e), n] for e, n in fup.FUPDATE.by_entry.items()],
               "decision": dec.DECISION.launches,
               "seconds": time.perf_counter() - t0}, f)
"""
# The JSON fields of the JAX package's CLI (src/repro/launch/serve_slab.py).
CLI_FIELDS = {
    "single": {"m", "n_sv", "precision", "cold_s", "stream_s", "requests",
               "queries", "buckets"},
    "multi": {"m", "models", "precision", "deadline_ms", "quota", "stream_s",
              "requests", "admitted", "rejected", "queries", "per_model"}}
CLI_TIMEOUT_S = 600
# [lm]: the LM serving path. llama3.2-3b at full width: prefill
# LM_BATCH x LM_PROMPT tokens, then LM_NEW greedy decode steps; at
# LM_PARITY_LAYERS layers in f32 against the CPU on LM_PARITY_S tokens;
# the slab fitted on LM_SLAB_M pooled in-distribution sequences of
# LM_SLAB_S tokens (ids below LM_SLAB_IDS) and scoring LM_SLAB_Q held-out
# and LM_SLAB_Q OOD ones (the top LM_SLAB_IDS ids), LM_FEAT_BATCH
# sequences a forward. Logits agree within tests/test_arch_smoke.py's
# tolerance (LM_ATOL, LM_RTOL); bf16 decode against the full forward
# within the bf16 TOLERANCES, atol scaled by the largest logit.
LM_ARCH = "llama3.2-3b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 512, 32
LM_PARITY_LAYERS, LM_PARITY_S = 2, 64
LM_SLAB_M, LM_SLAB_Q, LM_SLAB_S, LM_SLAB_IDS = 2048, 512, 64, 40
LM_FEAT_BATCH = 256
LM_ATOL, LM_RTOL = 5e-4, 1e-3
LM_CLI_ARGS = ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prompt-len",
               str(LM_PROMPT), "--new-tokens", str(LM_NEW)]
LM_CLI_TIMEOUT_S = 300
# The LM CLI serves a full-width arch on its production mesh (256 ranks);
# on one card its child stands the (1, 1) mesh in for that mesh.
LM_CLI_CHILD = """
import sys
from repro_torch.launch import mesh, serve
serve.make_production_mesh = lambda multi_pod=False: mesh.make_test_mesh(
    (1, 1), ("data", "model"))
serve.main(sys.argv[1:])
"""
# [lm-train]: the LM training step. The ten archs reduced, two steps of
# LMT_STEP_KW on the card against the CPU: loss, ce and aux within
# LMT_LOSS_ATOL / LMT_LOSS_RTOL, the grad norm within LMT_NORM_RTOL, the
# lr equal, the parameters as ``_params_close`` says. LM_ARCH at full
# width, LMT_PARITY_LAYERS layers, f32, B = 1, LMT_PARITY_S tokens: loss
# and grad norm as above, the gradients of wq / w1 / unembed within
# LMT_GRAD_RTOL and LMT_GRAD_ATOL of the leaf's largest value. At full
# width and depth in bf16: LMT_STEPS steps of LMT_BATCH x LMT_SEQ tokens
# (the median of steps 2.. timed) with ``make_train_step``'s defaults
# (the reference's: peak lr 3e-4 after 100 warm-up steps).
LMT_STEP_KW = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
LMT_LOSS_ATOL, LMT_LOSS_RTOL, LMT_NORM_RTOL = 1e-5, 1e-4, 1e-4
LMT_PARAM_ATOL, LMT_PARAM_RTOL, LMT_PARAM_FRAC = 1e-6, 1e-4, 1e-4
LMT_PARITY_LAYERS, LMT_PARITY_S = 2, 64
LMT_GRAD_ATOL, LMT_GRAD_RTOL = 1e-4, 1e-3
LMT_STEPS, LMT_BATCH, LMT_SEQ = 6, 4, 512
LMT_CLI_ARGS = ["--arch", LM_ARCH, "--reduced", "--steps", "20"]
# [lm-dist]: the sharded step. (a) LMD_RANKS gloo ranks on the card,
# LMD_ARCHS reduced and LM_ARCH at full width (LMD_FULL_LAYERS layers,
# f32, LMD_FULL_B x LMD_FULL_S tokens), held against the single-device
# step within LMD_RTOL (loss, ce, aux, grad norm); (b) one NCCL rank,
# [lm-train]'s configuration, seed and batches, each step's loss and grad
# norm within LMD_BF16_LOSS_RTOL / LMD_BF16_NORM_RTOL of [lm-train]'s
# (bf16 parameters: a sum run in another order moves an update's bf16
# rounding, and the steps drift apart; 1e-2 is ~2.5 bf16 ulps), the lr
# equal. LMD_CARDS_STEPS steps a rank with --cards.
LMD_RANKS, LMD_RTOL, LMD_TIMEOUT_S = 4, 1e-5, 600
LMD_BF16_LOSS_RTOL, LMD_BF16_NORM_RTOL = 1e-3, 1e-2
LMD_FULL_LAYERS, LMD_FULL_B, LMD_FULL_S = 2, 4, 64
LMD_CARDS_STEPS = 4
# The reduced archs (a) runs: the dense path, the MoE and the two whose
# layers launch the scan kernels. The other six re-ran on the card what
# tests/test_torch_lm_dist.py holds on the CPU against the JAX package,
# with no kernel and no path of their own on the card (ROADMAP B.10).
LMD_ARCHS = ("jamba-1.5-large-398b", "llama3.2-3b", "mixtral-8x22b",
             "rwkv6-7b")
# [lm-serve-dist]: sharded serving. (a) LMS_RANKS gloo ranks on the card,
# (2, 2): under "tp" with fsdp LMS_TP_ARCHS reduced (LMS_B x LMS_PROMPT,
# then LMS_STEPS greedy decode steps, a cache of LMS_CACHE), llama at
# B = 1, mixtral after a prompt shorter than its window, LM_ARCH at full
# width (LMS_FULL_LAYERS layers, f32, LMS_B x LMS_FULL_PROMPT,
# LMS_FULL_STEPS steps); under "fsdp" LMS_FSDP_ARCHS reduced and mixtral's
# short prompt; each held against the single-device run on the card: the
# logits of every step within LMS_ATOL, the greedy tokens equal, every
# rank's cache leaf the single-device cache's cut for it within LMS_ATOL.
# (b) one NCCL rank on (1, 1): [lm]'s configuration, seed and prompt
# (LM_BATCH x LM_PROMPT, LM_NEW steps, bf16) through the sharded path and
# the per-rank draw, under "tp" and then "fsdp", each followed by the
# single-device run in the same process fed its tokens: each step's
# logits within [lm]'s bf16 check (TOLERANCES["bf16"], atol scaled by
# the largest |logit|).
LMS_RANKS, LMS_ATOL, LMS_TIMEOUT_S = 4, 5e-4, 600
LMS_B, LMS_PROMPT, LMS_STEPS, LMS_CACHE = 4, 16, 8, 32
LMS_FULL_LAYERS, LMS_FULL_PROMPT, LMS_FULL_STEPS = 2, 64, 2
# The reduced archs (a) runs under "tp": the dense path and the two whose
# layers launch the scan kernels (the other seven re-ran on the card what
# tests/test_torch_lm_serve_dist.py holds on the CPU against the JAX
# package; ROADMAP B.10). Under "fsdp": the same, gemma3's sliding-window
# ring and mixtral's MoE besides.
LMS_TP_ARCHS = ("jamba-1.5-large-398b", "llama3.2-3b", "rwkv6-7b")
LMS_FSDP_ARCHS = ("gemma3-27b", "jamba-1.5-large-398b", "llama3.2-3b",
                  "rwkv6-7b")
# [dryrun]: ``repro_torch.launch.dryrun`` in processes of their own (its
# fake process group of 256 / 512 ranks never becomes this one's), each
# DRYRUN_CELLS cell (--arch, --shape, --mesh) one CLI process, all at once,
# beside one process that predicts [lm-train]'s configuration (LM_ARCH,
# LMT_BATCH x LMT_SEQ, one microbatch) on the one-rank mesh; no card.
DRYRUN_CELLS = ((LM_ARCH, "decode_32k", "single"),
                (LM_ARCH, "train_4k", "single"),
                (LM_ARCH, "prefill_32k", "multi"))
DRYRUN_TIMEOUT_S = 300
DRYRUN_PREDICT = """
import json, sys
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
arch, batch, seq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
rec = dryrun.cost_cell(get_arch(arch), {"seq_len": seq, "batch": batch,
                                        "step": "train"},
                       make_test_mesh((1, 1), ("data", "model")),
                       fsdp=False, microbatches=1)
print(json.dumps(rec))
"""
# [lm-ssm]: the scan kernels. The archs whose layers run them, and each
# one's kernel family. (a) the Mamba scan at jamba's widths, SSM_B x SSM_S,
# and the WKV recurrence at rwkv6-7b's, WKV_B x WKV_S; (b) rwkv6-7b served
# at [lm]'s LM_BATCH x LM_PROMPT, LM_NEW steps; (c) rwkv6-7b cut to
# SSM_TRAIN_LAYERS layers, SSM_TRAIN_STEPS steps of SSM_TRAIN_B x
# SSM_TRAIN_S tokens, and the f32 gradients of SSM_TRAIN_B x SSM_PAIR_S
# tokens through the kernels and through the plain scans (those take
# ~6 s for 512 positions on an H100, ~46 s for 4096); (d) one jamba Mamba
# block at SSM_B x SSM_S.
SCAN_ARCHS = {"jamba-1.5-large-398b": "ssm_scan", "rwkv6-7b": "wkv6"}
SSM_B, SSM_S = 1, 4096
WKV_B, WKV_S = 4, 512
SSM_TRAIN_LAYERS, SSM_TRAIN_STEPS, SSM_TRAIN_B, SSM_TRAIN_S = 4, 3, 2, 4096
SSM_PAIR_S = 512
# (c): each parameter's f32 gradient through the kernels within this
# relative L2 distance of the plain path's. f32 rounding through the four
# layers moves a leaf by ~1e-4 (on an H100 a few entries of some leaves,
# scan and dense alike, by up to 4e-4 of the leaf's largest); a wrong or
# missing gradient term moves its leaf by 1e-2 or more.
SSM_GRAD_RTOL = 1e-3
# (c), ROADMAP C.22: each path's WKV gradients within this relative L2
# distance of the plain recurrence in float64 on that path's own inputs
# (on an H100, the kernels and the plain scans: 9e-8 to 6.3e-7).
SSM_OWN_RTOL = 1e-5
# (b): the bf16 run through the kernels at most this many times as far
# from the f32 run as the bf16 run through the plain scans.
SSM_BF16_RATIO = 1.5
BF16_PEAK_FLOPS = 989e12  # the H100 SXM data sheet's dense bf16 rate
QP_SIZES = 4              # [paper] runs the QP at the first QP_SIZES sizes
PROFILE_ITERS = 100       # solver iterations inside the profiler window
# [dist]'s ranks' windows: the profiler's parse of its events took 34-40 s
# a job for 100 iterations whose solve took 1-2 s (ROADMAP B.10).
DIST_PROFILE_ITERS = 20
# gram: the kernel matrix of the main path's rows, a ragged shape and one
# whose rows are no multiple of a tile.
GRAM_SHAPES = ((M, M, D), (130, 77, 129), (M + 1, 300, D))
MENU_ROWS, MENU_D = 203, 45   # the menu check's ragged shape
# fupdate's S in the menu check: the hot loop's (narrow class) and a wide
# one (the split classes).
MENU_S = {"narrow": 20, "wide": 77}
GRAM_TIMED = (("linear", "f32"), ("linear", "bf16"), ("linear", "f16"),
              ("rbf", "f32"), ("rbf", "bf16"), ("rbf", "f16"))
# gram's feature widths at a fixed output: whether the output or the
# inputs set the wgmma kernel's pace.
GRAM_PACE_D = (64, 128, 256)
# The exp floor (the rbf decision's, one expf a query-support pair; the
# Mamba scan's, one a state-step) on the SFUs: 16 a clock on each of the
# H100's 132 SMs, at 1.98 GHz, the boost clock that the f32 peak of
# ``utils.roofline`` (132 x 128 FMA lanes x 2, 67 TFLOP/s) assumes.
SFU_EXPS_PER_S = 132 * 16 * 1.98e9


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def _traced(fit) -> dict:
    """``fit()`` (a solve) under torch.profiler: wall seconds, iterations,
    the device's busy seconds (the union of its own events' intervals:
    the operators' rows of key_averages() carry their kernels' time too),
    its events, and the top kernels by device time and operations by host
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in on_card):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    per_name = {}
    for e in on_card:
        calls, us = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"iters": int(res.iters), "wall_s": wall, "busy_s": busy_us / 1e6,
            "events": len(on_card),
            "device": [(n[:60], c, us / 1e3) for n, (c, us) in sorted(
                per_name.items(), key=lambda kv: -kv[1][1])[:10]],
            "host": [(e.key[:60], e.count, e.self_cpu_time_total / 1e3)
                     for e in host[:10]]}


def _say_trace(tag: str, what: str, tr: dict) -> None:
    iters, busy, wall = max(1, tr["iters"]), tr["busy_s"], tr["wall_s"]
    say(f"{tag} {what} iters={tr['iters']} wall_s={wall:.4f} "
        f"device_busy_s={busy:.6f} device_idle_share={1 - busy / wall:.4f} "
        f"device_ms_per_iter={1e3 * busy / iters:.4f} "
        f"device_events_per_iter={tr['events'] / iters:.1f}" if busy > 0
        else f"{tag} device time: not measured (the profiler saw none)")
    for name, calls, ms in tr["device"]:
        say(f"{tag} device {name!r}: calls={calls} ms={ms:.3f}")
    for key, calls, ms in tr["host"]:
        say(f"{tag} host {key!r}: calls={calls} self_cpu_ms={ms:.3f}")


def _dist_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of [dist], in its own process on the card (see
    ``repro_torch.launch.spawn_ranks``): the distributed fits of
    ``job["precisions"]`` on [main]'s data; with ``job["full"]`` also a
    ledger solve at m = 2048, the sharded fit at SHRINK_M and the sharded
    warm refit; then the sharded scorer on [main]'s served model. Returns
    plain numbers and numpy arrays for the parent to check, and under
    "times" where the rank's seconds went (``_dist_phase`` prints them)."""
    entered = time.time()
    import numpy as np
    import torch
    import torch.distributed as dist
    import repro_torch
    from repro_torch import api
    from repro_torch.core import SlabSpec, rbf
    from repro_torch.core.engine import (CollectiveLedger,
                                         artifact_from_result)
    from repro_torch.core.ocssvm import OCSSVMModel
    from repro_torch.data import make_toy
    from repro_torch.kernels import tiling
    from repro_torch.kernels.decision import ops as dec
    from repro_torch.kernels.fupdate import ops as fup
    from repro_torch.launch import make_solver_mesh
    from repro_torch.serve import pack_model

    torch.cuda.set_device(rank % job["cards"])     # cards=1: all on one
    dev = api.resolve_device("cuda")
    mesh, axes = make_solver_mesh()
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=rbf(RBF_GAMMA))
    X = make_toy(SEED, M, d=D)[0]
    narrow = {c.entry for c in tiling.menu("fupdate", 2 * P)}
    times = {"entered": entered, "setup_s": time.time() - entered}

    def reset():
        fup.FUPDATE.reset_counts()
        dec.DECISION.reset_counts()

    def drive(fn) -> tuple:
        reset()
        led = CollectiveLedger()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(led)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        iters = int(res.iters)
        by = fup.FUPDATE.by_entry
        n_narrow = sum(n for e, n in by.items() if e in narrow)
        return res, {
            "iters": iters, "seconds": secs,
            "ms_per_iter": 1e3 * secs / max(iters, 1),
            "converged": bool(res.converged),
            "gamma": res.model.gamma.cpu().numpy(),
            "rho": (float(res.model.rho1), float(res.model.rho2)),
            "fupdate": {"narrow": n_narrow,
                        "wide": sum(by.values()) - n_narrow},
            "decision": dec.DECISION.launches,
            "comm_s_per_iter": led.seconds / max(iters, 1),
            "comm_calls": led.calls, "ledger": led.summary()}

    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": torch.cuda.get_device_name(0), "fits": {}}
    main = {}
    for precision in job["precisions"]:
        main[precision], out["fits"][f"main-{precision}"] = drive(
            lambda led: repro_torch.fit(
                X, spec, strategy="distributed", mesh=mesh, data_axes=axes,
                P=P, tol=TOL, precision=precision, ledger=led))
    if job["full"]:
        _, out["fits"]["ledger-2048"] = drive(
            lambda led: repro_torch.fit(
                X[:2048], spec, strategy="distributed", mesh=mesh,
                data_axes=axes, P=P, tol=TOL, max_outer=50, ledger=led))
        routes, real = [], api.solve_sharded_shrinking

        def route_spy(*a, **k):
            routes.append("sharded-shrinking")
            return real(*a, **k)

        api.solve_sharded_shrinking = route_spy
        try:
            X_shr = make_toy(SEED, SHRINK_M, d=D)[0]
            _, rec = drive(lambda led: repro_torch.fit(
                X_shr, spec, strategy="sharded", mesh=mesh, data_axes=axes,
                P=P, tol=TOL, ledger=led))
        finally:
            api.solve_sharded_shrinking = real
        rec["routes"] = routes
        out["fits"]["shrink-f32"] = rec
        n_delta = M * 5 // 100
        X_new = np.concatenate([X[n_delta:],
                                make_toy(SEED + 7, n_delta, d=D)[0]])
        art = artifact_from_result(main["f32"], precision="f32")
        st = {}
        _, rec = drive(lambda led: repro_torch.fit_update(
            art, X_new, tol=TOL, mesh=mesh, data_axes=axes, stats_out=st,
            ledger=led))
        rec["stats"] = {k: st[k] for k in ("mode", "n_overlap", "n_fresh",
                                           "n_expired", "n_corr", "P")}
        out["fits"]["warm-f32"] = rec

    # Where a distributed iteration's time goes: a profiler window over
    # DIST_PROFILE_ITERS iterations (every rank runs it: the solve is SPMD).
    t0 = time.perf_counter()
    out["trace"] = _traced(lambda: repro_torch.fit(
        X, spec, strategy="distributed", mesh=mesh, data_axes=axes, P=P,
        tol=TOL, max_outer=DIST_PROFILE_ITERS))
    times["trace_s"] = time.perf_counter() - t0
    sv = job["served"]
    model = OCSSVMModel(
        gamma=torch.as_tensor(sv["gamma"], device=dev),
        rho1=torch.tensor(sv["rho1"], device=dev),
        rho2=torch.tensor(sv["rho2"], device=dev),
        X=torch.as_tensor(sv["X"], device=dev), spec=spec)
    sm = pack_model(model, tn=sv["tn"])
    scorer = sm.scorer(mesh=mesh, data_axis="data")
    queries = {n: make_toy(SEED + 1 + n, n, d=D)[0] for n in job["requests"]}
    reset()
    t0 = time.perf_counter()
    scores = {n: scorer.score(q) for n, q in queries.items()}
    torch.cuda.synchronize()
    out["score_seconds"] = time.perf_counter() - t0
    out["score_launches"] = {"decision": dec.DECISION.launches,
                             "fupdate": fup.FUPDATE.launches}
    out["scores"] = scores
    out["buckets"] = {n: scorer.bucket_used(n) for n in queries}
    # The rank's own single-device scorer (not counted: a check).
    out["local_bitwise"] = all(
        scores[n].tobytes() == sm.score(q).tobytes()
        for n, q in queries.items())
    times["returned"] = time.time()
    out["times"] = times
    return out


def _dist_phase(jobs: dict, ref: dict):
    """[dist]'s drive and checks: spawn each job's rank processes
    (``jobs``: backend -> (world size, job for ``_dist_rank``)) and hold
    what they return against the single-device results in ``ref`` (the
    card ``dev``, ``spec``, the served model ``sm``, the rows ``X`` /
    ``X_shr`` / ``X_new`` and the fits ``main`` (by precision), ``shrink``
    and ``warm``). Returns ({backend: fupdate launches by rank and fit},
    {backend: decision launches by rank})."""
    import numpy as np
    import torch
    from repro_torch.core import dual_objective_matfree
    from repro_torch.data import make_toy
    from repro_torch.kernels.precision import truth_tolerance
    from repro_torch.launch import spawn_ranks
    dev, spec, sm = ref["dev"], ref["spec"], ref["sm"]
    phase_t0 = time.perf_counter()
    ranks, job_s = {}, {}
    spawned = {}
    for backend, (world, job) in jobs.items():
        t0, spawned[backend] = time.perf_counter(), time.time()
        ranks[backend] = spawn_ranks(_dist_rank, world, backend=backend,
                                     args=(job,), timeout_s=DIST_TIMEOUT_S)
        job_s[backend] = time.perf_counter() - t0
    X_dev = torch.as_tensor(ref["X"], device=dev)
    Xs_shr = torch.as_tensor(ref["X_shr"], device=dev)
    Xn_warm = torch.as_tensor(ref["X_new"], device=dev)

    def held(rec, single, Xd, what, iters=True):
        """A rank's fit against the single-device fit of the same rows:
        converged, feasible, objective and offsets within truth_tolerance
        + SOLVER_ATOL_FLOOR, iterations within 10% (ROADMAP C.6)."""
        m = Xd.shape[0]
        g = torch.as_tensor(rec["gamma"], device=dev).double()
        check(rec["converged"], f"{what}: did not converge")
        check(abs(float(g.sum()) - spec.total()) < 1e-4,
              f"{what}: sum(gamma) = {float(g.sum())}")
        check(float(g.max()) <= spec.upper(m) + 1e-7
              and float(g.min()) >= spec.lower(m) - 1e-7,
              f"{what}: gamma leaves the box")
        o_d = float(dual_objective_matfree(g, Xd.double(), spec.kernel))
        o_s = float(dual_objective_matfree(single.model.gamma.double(),
                                           Xd.double(), spec.kernel))
        tol_o = truth_tolerance(precision_of[what], [o_s])
        check(abs(o_d - o_s) <= max(tol_o["atol"], SOLVER_ATOL_FLOOR)
              + tol_o["rtol"] * abs(o_s),
              f"{what}: objective {o_d} vs single-device {o_s}")
        rho_d = np.asarray(rec["rho"])
        rho_s = np.asarray([float(single.model.rho1),
                            float(single.model.rho2)])
        tol_r = truth_tolerance(precision_of[what], rho_s)
        check(np.all(np.abs(rho_d - rho_s)
                     <= max(tol_r["atol"], SOLVER_ATOL_FLOOR)
                     + tol_r["rtol"] * np.abs(rho_s)),
              f"{what}: rho {rho_d} vs single-device {rho_s}")
        i_s = int(single.iters)
        if iters:
            check(abs(rec["iters"] - i_s) <= max(1, 0.1 * i_s),
                  f"{what}: {rec['iters']} iterations vs single-device "
                  f"{i_s}")
        return o_d, o_s, i_s

    precision_of = {}
    dist_fupdate, dist_decision = {}, {}
    for backend, recs in ranks.items():
        world = len(recs)
        for key in recs[0]["fits"]:
            fits_k = [r["fits"][key] for r in recs]
            what = f"[dist] {backend} {key}"
            precision_of[what] = "bf16" if key.endswith("bf16") else "f32"
            check(all(f["iters"] == fits_k[0]["iters"] for f in fits_k),
                  f"{what}: iterations differ across ranks "
                  f"{[f['iters'] for f in fits_k]}")
            check(all(f["gamma"].tobytes() == fits_k[0]["gamma"].tobytes()
                      for f in fits_k),
                  f"{what}: gamma is not bitwise equal across ranks")
            for r, f in enumerate(fits_k):
                check(f["fupdate"]["narrow"] + f["fupdate"]["wide"] > 0,
                      f"{what} rank {r}: no fupdate launch")
                say(f"[dist] {backend} rank {r}/{world} {key}: iters="
                    f"{f['iters']} converged={f['converged']} seconds="
                    f"{f['seconds']:.3f} ms_per_iter={f['ms_per_iter']:.3f}"
                    f" fupdate_launches={f['fupdate']} decision_launches="
                    f"{f['decision']} comm_s_per_iter="
                    f"{f['comm_s_per_iter']:.6f} comm_calls="
                    f"{f['comm_calls']} ledger={json.dumps(f['ledger'])}")
            rec = fits_k[0]
            if key.startswith("main-"):
                p_ = key.split("-")[1]
                o_d, o_s, i_s = held(rec, ref["main"][p_], X_dev, what)
            elif key == "shrink-f32":
                check(rec["routes"] == ["sharded-shrinking"],
                      f"{what}: took {rec['routes']}, not the sharded "
                      f"shrinking driver")
                o_d, o_s, i_s = held(rec, ref["shrink"], Xs_shr, what)
            elif key == "warm-f32":
                st = rec["stats"]
                check(st["mode"] == "warm", f"{what}: {st['mode']} route")
                for r, f in enumerate(fits_k):
                    check(f["fupdate"]["narrow"] == 0
                          and f["fupdate"]["wide"] == f["iters"] + 1,
                          f"{what} rank {r}: {f['fupdate']} fupdate "
                          f"launches, not one wide per iteration plus the "
                          f"reconcile ({f['iters']} iters)")
                o_d, o_s, i_s = held(rec, ref["warm"], Xn_warm, what,
                                     iters=False)
                say(f"[dist] {backend} {key}: stats {json.dumps(st)}")
            else:
                continue
            say(f"[dist] {backend} {key}: objective {o_d:.9f} vs "
                f"single-device {o_s:.9f} (|diff| {abs(o_d - o_s):.3e}); "
                f"iterations {rec['iters']} vs {i_s}; gamma bitwise equal "
                f"on {world} rank(s)")
        # The O(P d) bill: the same per-iteration bytes at m = 8192 and
        # 2048, within tests/test_distributed.py's budget.
        if "ledger-2048" in recs[0]["fits"]:
            b_big = recs[0]["fits"]["main-f32"]["ledger"]["iteration_bytes"]
            b_small = recs[0]["fits"]["ledger-2048"]["ledger"][
                "iteration_bytes"]
            budget = 4 * world * P * (D + 4) * 4 + 256
            check(b_big == b_small and 0 < b_big <= budget,
                  f"[dist] iteration bytes {b_big} (m={M}) / {b_small} "
                  f"(m=2048), budget {budget}")
            say(f"[dist] {backend} ledger: iteration_bytes {b_big} at m={M} "
                f"and m=2048 (budget 4*n*P*(d+4)*4+256 = {budget})")
        # The sharded scorer, bitwise [main]'s single-device scores.
        for r, rec_r in enumerate(recs):
            check(rec_r["score_launches"]["decision"] > 0,
                  f"[dist] {backend} rank {r}: no decision launch")
            check(rec_r["local_bitwise"], f"[dist] {backend} rank {r}: "
                  f"sharded scores are not bitwise its local scorer's")
            for n, s_n in rec_r["scores"].items():
                q = make_toy(SEED + 1 + n, n, d=D)[0]
                check(s_n.shape == (n,) and
                      s_n.tobytes() == sm.score(q).tobytes(),
                      f"[dist] {backend} rank {r}: {n} rows not bitwise "
                      f"[main]'s single-device scores")
            say(f"[dist] {backend} rank {r}: scorer(mesh=) requests "
                f"{list(rec_r['scores'])} -> per-rank buckets "
                f"{list(rec_r['buckets'].values())}, seconds="
                f"{rec_r['score_seconds']:.4f}, launches="
                f"{rec_r['score_launches']}; bitwise [main]'s single-device "
                f"scores")
        dist_fupdate[backend] = {
            f"rank{r}": {k: f["fupdate"] for k, f in rec_r["fits"].items()}
            for r, rec_r in enumerate(recs)}
        dist_decision[backend] = {
            f"rank{r}": rec_r["score_launches"]["decision"]
            for r, rec_r in enumerate(recs)}
        _say_trace("[dist]", f"{backend} rank 0 distributed fit f32 m={M}",
                   recs[0]["trace"])
        tm = [r["times"] for r in recs]
        last = max(t["returned"] for t in tm)
        say(f"[dist] {backend}: {world} rank(s) on "
            f"{recs[0]['device']}, job seconds={job_s[backend]:.2f}: the "
            f"spawn to the last rank's function "
            f"{max(t['entered'] for t in tm) - spawned[backend]:.2f}, its "
            f"imports and data {max(t['setup_s'] for t in tm):.2f}, the "
            f"fits {sum(f['seconds'] for f in recs[0]['fits'].values()):.2f}"
            f" (rank 0), the profiler window "
            f"{max(t['trace_s'] for t in tm):.2f} (the traced solve's wall "
            f"{recs[0]['trace']['wall_s']:.2f}), the scorer "
            f"{recs[0]['score_seconds']:.2f}, the last rank's return to the "
            f"join {spawned[backend] + job_s[backend] - last:.2f}")
    say(f"[dist] phase seconds={time.perf_counter() - phase_t0:.2f}")
    return dist_fupdate, dist_decision


def _ckpt_phase(dev, X_np, spec, main_fits: dict, reset_counts,
                fupdate_classes) -> dict:
    """[ckpt]: ``FaultTolerantLoop`` over chunks of the blocked solve
    (``gram_mode="pallas"``: fupdate's hot loop) on [main]'s rows, f32 and
    bf16, checkpointed every 2 steps through its ``AsyncCheckpointer``
    (keep 3), with failures injected before CKPT_FAILS; then a bf16 leaf
    through the manager on the card. Held against the same loop run with
    no failure (bitwise) and [main]'s one-shot fits (``main_fits``, by
    precision). Returns the failing runs' launches by precision: fupdate's
    by class, and decision's."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import manager
    from repro_torch.core import (dual_objective_matfree, feasible_init,
                                  solve_blocked)
    from repro_torch.kernels.decision import ops as dec
    from repro_torch.kernels.precision import truth_tolerance
    from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
    phase_t0 = time.perf_counter()
    Xd = torch.as_tensor(X_np, device=dev)
    m = Xd.shape[0]

    class Cursor:
        """The loop's data pipeline: its batches are its step count."""

        def __init__(self):
            self.step = 0

        def next_batch(self):
            self.step += 1
            return self.step

        def state_dict(self):
            return {"step": self.step}

        def load_state_dict(self, d):
            self.step = d["step"]

    def loop(precision, directory, fails):
        def step(state, batch):
            res = solve_blocked(Xd, spec, P=P, tol=TOL, gram_mode="pallas",
                                precision=precision, gamma0=state["gamma"],
                                max_outer=CKPT_CHUNK)
            return ({"gamma": res.model.gamma, "rho1": res.model.rho1,
                     "rho2": res.model.rho2,
                     "iters": state["iters"] + res.iters},
                    {"gap": res.gap, "iters": res.iters})
        pending = set(fails)

        def inject(s):
            if s in pending:
                pending.discard(s)
                raise RuntimeError(f"injected failure before step {s}")
        init = {"gamma": feasible_init(m, spec, torch.float32, device=dev),
                "rho1": torch.zeros((), device=dev),
                "rho2": torch.zeros((), device=dev),
                "iters": torch.zeros((), dtype=torch.int32, device=dev)}
        return FaultTolerantLoop(step, init, Cursor(), directory,
                                 save_every=2, keep=3,
                                 failure_injector=inject)

    saves = [s for s in range(CKPT_STEPS) if (s + 1) % 2 == 0]
    launches, dec_launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for precision in ("f32", "bf16"):
            what = f"[ckpt] {precision}"
            want = loop(precision, f"{tmp}/{precision}-clean", ()).run(
                CKPT_STEPS)
            failing = loop(precision, f"{tmp}/{precision}", CKPT_FAILS)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = failing.run(CKPT_STEPS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches[precision] = fupdate_classes()
            dec_launches[precision] = dec.DECISION.launches
            check(failing.restarts == len(CKPT_FAILS),
                  f"{what}: {failing.restarts} restarts")
            for k in want:
                check(got[k].cpu().numpy().tobytes()
                      == want[k].cpu().numpy().tobytes(),
                      f"{what}: {k} is not bitwise the run with no failure")
            kept = sorted(d for d in os.listdir(f"{tmp}/{precision}")
                          if d.startswith("step_"))
            check(kept == [f"step_{s:09d}" for s in saves[-3:]],
                  f"{what}: checkpoints left {kept}")
            gap = failing.metrics_log[-1]["gap"]
            check(gap <= TOL, f"{what}: gap {gap} after {CKPT_STEPS} steps")
            check(launches[precision]["narrow"] > 0,
                  f"{what}: no narrow fupdate launch")
            g = got["gamma"].double()
            check(abs(float(g.sum()) - spec.total()) < 1e-4
                  and float(g.max()) <= spec.upper(m) + 1e-7
                  and float(g.min()) >= spec.lower(m) - 1e-7,
                  f"{what}: gamma is not feasible")
            o = float(dual_objective_matfree(g, Xd.double(), spec.kernel))
            one = main_fits[precision]
            o_main = float(dual_objective_matfree(
                one.model.gamma.double(), Xd.double(), spec.kernel))
            tol_o = truth_tolerance(precision, [o_main])
            check(abs(o - o_main) <= tol_o["atol"] + SOLVER_ATOL_FLOOR
                  + tol_o["rtol"] * abs(o_main),
                  f"{what}: objective {o} vs [main]'s {o_main}")
            say(f"{what} m={m} d={Xd.shape[1]}: {CKPT_STEPS} steps of "
                f"{CKPT_CHUNK} outer iterations, failures before steps "
                f"{CKPT_FAILS}: restarts={failing.restarts} steps_run="
                f"{len(failing.metrics_log)} iters={int(got['iters'])} "
                f"([main] one-shot {int(one.iters)}) gap={gap:.3e} "
                f"seconds={secs:.3f} fupdate_launches={launches[precision]} "
                f"objective={o:.9f} ([main] {o_main:.9f}); bitwise the run "
                f"with no failure; checkpoints left {kept}")
        # A bf16 leaf beside the state, through one asynchronous save.
        rows16 = Xd[:1024].to(torch.bfloat16)
        tree = {"rows": rows16, "state": got}
        ck = manager.AsyncCheckpointer(f"{tmp}/async", keep=3)
        t0 = time.perf_counter()
        fut = ck.save(0, tree)
        snap_s = time.perf_counter() - t0
        path = fut.result()
        write_s = time.perf_counter() - t0
        back = manager.restore(f"{tmp}/async", 0, tree)
        check(back["rows"].dtype == torch.bfloat16
              and back["rows"].device == rows16.device
              and torch.equal(back["rows"].view(torch.int16),
                              rows16.view(torch.int16))
              and torch.equal(back["state"]["gamma"].view(torch.int32),
                              got["gamma"].view(torch.int32)),
              "[ckpt] the bf16 leaf or the state did not round-trip "
              "bitwise on the card")
        nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
    say(f"[ckpt] AsyncCheckpointer.save of the bf16 rows (1024 x {D}) and "
        f"the state: returned in {snap_s:.4f} s (device-to-host copy), "
        f"written in {write_s:.4f} s ({nbytes} bytes); restored on "
        f"{back['rows'].device} bitwise, bf16 kept")
    say(f"[ckpt] phase seconds={time.perf_counter() - phase_t0:.2f}")
    return launches, dec_launches


def _head_phase(dev, reset_counts) -> dict:
    """[head]: ``fit_head`` on the card on HEAD_M toy rows of WIDE_D
    features (rbf(1/d): rbf(0.5) is degenerate at this width, ROADMAP
    C.9), held against the same head fitted on the CPU. Its blocked solve
    takes on-the-fly rows, as the JAX package's head does: no kernel
    launches. Returns the launches of the fit and one score."""
    import numpy as np
    import torch
    from repro_torch.core import SlabSpec, fit_head, rbf
    from repro_torch.data import make_toy
    from repro_torch.kernels.decision import ops as dec
    from repro_torch.kernels.fupdate import ops as fup
    from repro_torch.kernels.precision import TOLERANCES
    phase_t0 = time.perf_counter()
    F = make_toy(SEED, HEAD_M, d=WIDE_D)[0]
    Q = make_toy(SEED + 15, 1024, d=WIDE_D)[0]
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=rbf(1.0 / WIDE_D))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    head = fit_head(F, spec, tol=TOL)
    s_card = head.score(Q).cpu().numpy()
    card_s = time.perf_counter() - t0
    launches = {"fupdate": fup.FUPDATE.launches,
                "decision": dec.DECISION.launches}
    check(head.mean.device.type == dev.type,
          f"[head] fitted on {head.mean.device}")
    check(launches == {"fupdate": 0, "decision": 0},
          f"[head] launched {launches}: its blocked solve takes on-the-fly "
          f"rows, as in the JAX package")
    t0 = time.perf_counter()
    cpu = fit_head(F, spec, tol=TOL, device="cpu")
    s_cpu = cpu.score(Q).numpy()
    cpu_s = time.perf_counter() - t0
    for h, where in ((head, "card"), (cpu, "cpu")):
        check(int(h.result.iters) > 0 and bool(h.result.converged),
              f"[head] the {where} fit: {int(h.result.iters)} iterations, "
              f"converged={bool(h.result.converged)}")
    tol = TOLERANCES["f32"]
    for name in ("mean", "scale"):
        np.testing.assert_allclose(getattr(head, name).cpu().numpy(),
                                   getattr(cpu, name).numpy(), **tol,
                                   err_msg=f"[head] {name}")
    np.testing.assert_allclose(s_card, s_cpu, **tol, err_msg="[head] scores")
    sure = np.abs(s_cpu) > 1e-2 * np.abs(s_cpu).max()
    flips = int(np.sum(np.sign(s_card[sure]) != np.sign(s_cpu[sure])))
    check(flips == 0, f"[head] {flips} labels differ from the CPU head's")
    say(f"[head] fit_head m={HEAD_M} d={WIDE_D} rbf(1/{WIDE_D}) tol={TOL}: "
        f"card iters={int(head.result.iters)} n_sv="
        f"{int((head.model.gamma.abs() > 1e-7).sum())} seconds={card_s:.3f}"
        f" (fit + 1024 scores); cpu iters={int(cpu.result.iters)} seconds="
        f"{cpu_s:.3f}; scores max_abs_diff="
        f"{float(np.max(np.abs(s_card - s_cpu))):.3e} (max |score| "
        f"{float(np.abs(s_cpu).max()):.3e}), labels_checked="
        f"{int(sure.sum())}/1024 label_flips={flips}; launches={launches}")
    say(f"[head] phase seconds={time.perf_counter() - phase_t0:.2f}")
    return launches


def _cli_phase(src: Path) -> dict:
    """[cli]: the serving CLI in three processes at once (CLI_CHILD): the
    single-model path at m = M in bf16 with the top bucket, the fleet
    (registry, admission with a quota, the async driver), and an attach of
    the single run's model, published here. Held against the same model
    served in process: its support rows, its stream's scores bitwise and
    its inside-slab count. Returns each run's launches."""
    import numpy as np
    import repro_torch
    from repro_torch.core import SlabSpec
    from repro_torch.data import make_toy
    from repro_torch.kernels import tiling
    from repro_torch.launch import serve_slab
    from repro_torch.serve import (BUCKETS, ScoringService, publish,
                                   run_request_stream)
    phase_t0 = time.perf_counter()
    narrow = {c.entry for c in tiling.menu("fupdate", 2 * 16)}
    with tempfile.TemporaryDirectory() as spool:
        runs = {"single": ["--m", str(M), "--max-batch", str(BUCKETS[-1]),
                           "--precision", "bf16"],
                "multi": ["--models", "a=rbf:0.5", "--models", "b=linear",
                          "--deadline-ms", "20", "--quota", "256",
                          "--driver"],
                "attach": ["--shm-attach", f"{spool}/cli", "--max-batch",
                           str(BUCKETS[-1])]}
        args = {k: serve_slab._parser().parse_args(v) for k, v in runs.items()}
        # In process, what the single run fits and streams.
        a = args["single"]
        spec = SlabSpec(nu1=a.nu1, nu2=a.nu2, eps=a.eps,
                        kernel=serve_slab._kernel(a))
        t0 = time.perf_counter()
        sm = repro_torch.serve(make_toy(a.seed, a.m)[0], spec, tol=a.tol,
                               P=16, precision=a.precision)
        fit_s = time.perf_counter() - t0
        want = np.concatenate(run_request_stream(
            ScoringService(sm.scorer()), serve_slab._requests(a),
            coalesce=a.coalesce))
        inside_want = int((want >= 0).sum())
        fleet = {}
        am = args["multi"]
        for flag in am.models:
            name, spec_m = serve_slab._parse_model_flag(flag, am)
            fleet[name] = repro_torch.serve(
                make_toy(am.seed, am.m)[0], spec_m, tol=am.tol, P=16,
                precision=am.precision).n_sv
        lease = publish(sm, f"{spool}/cli", dir=spool)
        procs, outs = {}, {}
        try:
            for tag, argv in runs.items():
                files = [f"{spool}/{tag}.{x}" for x in
                         ("counts.json", "scores.npy", "stats.json")]
                cmd = [sys.executable, "-c", CLI_CHILD, str(src), *files[:2],
                       *argv, "--json", files[2]]
                procs[tag] = (files, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, env=dict(os.environ, REPRO_SHM_DIR=spool)))
            for tag, (files, p) in procs.items():
                out, err = p.communicate(timeout=CLI_TIMEOUT_S)
                check(p.returncode == 0, f"[cli] {tag} exited with "
                      f"{p.returncode}: {err[-2000:]}")
                with open(files[0]) as f:
                    counts = json.load(f)
                with open(files[2]) as f:
                    stats = json.load(f)
                scores = np.load(files[1]) if os.path.exists(files[1]) \
                    else None
                outs[tag] = (out, counts, stats, scores)
        finally:
            for _, p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            lease.close()

    launches = {"fupdate": {}, "decision": {}}
    for tag, (out, counts, stats, scores) in outs.items():
        by = {tuple(e): n for e, n in counts["fupdate"]}
        n_nar = sum(n for e, n in by.items() if e in narrow)
        launches["fupdate"][tag] = {"narrow": n_nar,
                                    "wide": sum(by.values()) - n_nar}
        launches["decision"][tag] = counts["decision"]
        kind = "multi" if tag == "multi" else "single"
        check(set(stats) == CLI_FIELDS[kind],
              f"[cli] {tag}: JSON fields {sorted(stats)}")
        check(counts["decision"] > 0, f"[cli] {tag}: no decision launch")
        (inside, total), = [tuple(map(int, x)) for x in re.findall(
            r"^decisions: (\d+)/(\d+) inside the slab$", out, re.M)]
        if tag == "multi":
            svs = dict((n, int(k)) for n, k in re.findall(
                r"^model (\S+): (\d+) SVs", out, re.M))
            check(svs == fleet, f"[cli] multi: support rows {svs}, in "
                  f"process {fleet}")
            check(stats["admitted"] + stats["rejected"] == am.requests
                  and total == stats["queries"] and inside <= total,
                  f"[cli] multi: {stats['admitted']} admitted, "
                  f"{stats['rejected']} rejected, {inside}/{total}")
        else:
            check(stats["n_sv"] == sm.n_sv and stats["precision"] == "bf16",
                  f"[cli] {tag}: n_sv {stats['n_sv']} {stats['precision']}"
                  f", in process {sm.n_sv} bf16")
            check(scores is not None and scores.tobytes() == want.tobytes(),
                  f"[cli] {tag}: the stream's scores are not bitwise the "
                  f"in-process model's")
            check((inside, total) == (inside_want, want.size),
                  f"[cli] {tag}: {inside}/{total} inside, in process "
                  f"{inside_want}/{want.size}")
        check((launches["fupdate"][tag]["narrow"] > 0) == (tag == "single"),
              f"[cli] {tag}: fupdate launches {launches['fupdate'][tag]}")
        for line in out.strip().splitlines():
            say(f"[cli] {tag} | {line}")
        say(f"[cli] {tag}: seconds={counts['seconds']:.2f} (the process, "
            f"after the interpreter's start), launches: fupdate "
            f"{launches['fupdate'][tag]}, decision {counts['decision']}")
    say(f"[cli] in process: serve m={M} bf16 n_sv={sm.n_sv} seconds="
        f"{fit_s:.3f}; every check held (fields, support rows, the single "
        f"and attached streams bitwise, {inside_want}/{want.size} inside)")
    say(f"[cli] phase seconds={time.perf_counter() - phase_t0:.2f} (the "
        f"three processes at once)")
    return launches


def _lm_phase(dev, src: Path, reset_counts, fupdate_classes,
              time_ms) -> dict:
    """[lm]: the LM serving path (``repro_torch.models``,
    ``train.serve_step``, ``launch.serve``) and the slab on its pooled,
    whitened features. In order: the ten archs at their ``reduced()`` sizes on the
    card against the same parameters on the CPU (logits, aux; the decode
    step against the full forward on the card; MoE bitwise across two
    calls); LM_ARCH at full width and LM_PARITY_LAYERS layers in f32
    against the CPU; LM_ARCH at full width and depth in bf16 (prefill,
    LM_NEW greedy decode steps, twice: the same tokens; the first decode
    step's logits against a full forward); the slab fitted by ``serve``
    on pooled hidden states (``strategy="pallas"``, bf16: fupdate and
    decision at d = d_model), its scores held against the plain decision
    and fupdate held against its plain version at the fit's shapes, each
    timed; the CLI in a subprocess. Returns the slab's launches and the
    JSON rows of the kernels at d = d_model."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.core import SlabSpec, pool_features, rbf
    from repro_torch.kernels import tiling
    from repro_torch.kernels.decision import ops as dec
    from repro_torch.kernels.decision.ref import decision_plain
    from repro_torch.kernels.fupdate import ops as fup
    from repro_torch.kernels.fupdate.ref import fupdate_plain
    from repro_torch.kernels.precision import TOLERANCES
    from repro_torch.kernels.scan import ops as sops
    from repro_torch.models.transformer import (forward, init_cache,
                                                init_params)
    from repro_torch.serve.scorer import bucket_for
    from repro_torch.train.serve_step import make_decode, make_prefill
    from repro_torch.utils.roofline import terms
    phase_t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 20)

    def inputs(cfg, B, S):
        """Numpy inputs of S positions for an arch (frontend stubs too)."""
        kw = {}
        if cfg.frontend == "audio":
            kw["embeds"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
        else:
            nv = cfg.n_frontend_tokens
            kw["tokens"] = rng.integers(0, cfg.vocab_size,
                                        (B, S - nv)).astype(np.int32)
            if nv:
                kw["vision_embeds"] = rng.standard_normal(
                    (B, nv, cfg.d_model)).astype(np.float32)
        return kw

    def on(kw, device, keep=slice(None)):
        """The inputs on ``device``, text positions sliced by ``keep``."""
        out = {}
        for k, v in kw.items():
            v = v if k == "vision_embeds" else v[:, keep]
            out[k] = torch.as_tensor(v, device=device)
        return out

    def close(out, ref, what, atol=LM_ATOL, rtol=LM_RTOL):
        out, ref = out.float().cpu(), ref.float().cpu()
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"[lm] {what}: shape {tuple(out.shape)} against "
              f"{tuple(ref.shape)}, or non-finite values")
        diff = (out - ref).abs()
        bad = int((diff > atol + rtol * ref.abs()).sum())
        check(bad == 0, f"[lm] {what}: {bad} values outside atol {atol:.3g}"
              f" rtol {rtol:.3g} (max abs diff {float(diff.max()):.3e})")
        return float(diff.max())

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    # -- the ten archs, reduced, on the card against the CPU ------------
    t0 = sync()
    scan_launches = {}
    for name in sorted(ARCHS):
        cfg = ARCHS[name].reduced()
        sops.reset_counts()
        cpu = init_params(cfg, torch.Generator().manual_seed(SEED),
                          device="cpu")
        card = copy.deepcopy(cpu).to(dev)
        kw = inputs(cfg, 2, 20)
        want, _, aux_w = forward(cpu, cfg, **on(kw, "cpu"))
        got, _, aux = forward(card, cfg, **on(kw, dev))
        err = close(got, want, f"{name} reduced: logits, card vs cpu")
        close(aux, aux_w, f"{name} reduced: aux loss, card vs cpu")
        note = ""
        if cfg.n_experts:
            again, _, aux2 = forward(card, cfg, **on(kw, dev))
            check(torch.equal(again, got) and torch.equal(aux2, aux),
                  f"[lm] {name} reduced: the MoE forward is not bitwise "
                  f"the same across two calls")
            note = "; MoE bitwise across two calls"
            # no capacity drop between the decode check's two batch shapes
            cfg = dataclasses.replace(cfg,
                                      capacity_factor=float(cfg.n_experts))
        full, _, _ = forward(card, cfg, **on(kw, dev))
        cache = init_cache(cfg, 2, 20, dtype=torch.float32, device=dev)
        _, cache, _ = forward(card, cfg, cache=cache,
                              **on(kw, dev, slice(None, -1)))
        last, _, _ = forward(card, cfg, cache=cache,
                             **on({k: v for k, v in kw.items()
                                   if k != "vision_embeds"}, dev,
                                  slice(-1, None)))
        derr = close(last[:, 0], full[:, -1],
                     f"{name} reduced: decode vs the full forward")
        if name in SCAN_ARCHS:
            scan_launches[name] = _scan_checked("lm", name, _scan_counts(),
                                                backward=False)
            note += f"; scan launches {scan_launches[name]}"
        say(f"[lm] reduced {name}: logits card vs cpu max_abs_diff="
            f"{err:.3e}, decode vs full forward max_abs_diff={derr:.3e}"
            f"{note}")
    say(f"[lm] reduced archs: all {len(ARCHS)} held, seconds="
        f"{sync() - t0:.2f}")

    # -- full width, LM_PARITY_LAYERS layers, f32: card vs cpu ----------
    full_cfg = get_arch(LM_ARCH)
    cfg = dataclasses.replace(full_cfg, n_layers=LM_PARITY_LAYERS,
                              param_dtype="float32")
    card = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    cpu = copy.deepcopy(card).to("cpu")
    kw = inputs(cfg, 1, LM_PARITY_S)
    t0 = sync()
    got, _, _ = forward(card, cfg, **on(kw, dev))
    card_ms = 1e3 * (sync() - t0)
    t0 = time.perf_counter()
    want, _, _ = forward(cpu, cfg, **on(kw, "cpu"))
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    v = cfg.vocab_size                 # the padded columns are -1e30
    err = close(got[..., :v], want[..., :v], f"{LM_ARCH} "
                f"{LM_PARITY_LAYERS} layers f32: logits card vs cpu")
    say(f"[lm] {LM_ARCH} full width (d={cfg.d_model}, vocab "
        f"{cfg.padded_vocab}), {LM_PARITY_LAYERS} layers, f32, B=1 S="
        f"{LM_PARITY_S}: logits card vs cpu max_abs_diff={err:.3e} (max "
        f"|logit| {float(want[..., :v].abs().max()):.3f}); forward ms card="
        f"{card_ms:.1f} (first call) cpu={cpu_ms:.1f}")
    del card, cpu, got, want

    # -- full width and depth, bf16: prefill + greedy decode ------------
    cfg = full_cfg
    t0 = sync()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    init_s = sync() - t0
    n_params = sum(p.numel() for p in params.parameters())
    # every parameter the count names, plus the final norm and the
    # padded vocab rows of embed and unembed
    check(n_params == cfg.param_count() + cfg.d_model + 2 * cfg.d_model
          * (cfg.padded_vocab - cfg.vocab_size),
          f"[lm] {n_params} parameters, param_count {cfg.param_count()}")
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
        LM_BATCH, LM_PROMPT)).astype(np.int32), device=dev)
    prefill, decode = make_prefill(cfg), make_decode(cfg)

    def generate():
        """(tokens (B, 1 + LM_NEW), the first decode step's logits,
        prefill ms, decode ms a step)."""
        cache = init_cache(cfg, LM_BATCH, LM_PROMPT + LM_NEW, device=dev)
        t0 = sync()
        logits, cache = prefill(params, cache, {"tokens": prompt})
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        t1 = sync()
        toks = [tok]
        for step in range(LM_NEW):
            logits, cache = decode(params, cache, tok)
            if step == 0:
                first = logits[:, 0].float()
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            toks.append(tok)
        t2 = sync()
        return (torch.cat(toks, dim=1), first, 1e3 * (t1 - t0),
                1e3 * (t2 - t1) / LM_NEW)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = [generate() for _ in range(2)]
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 2**30
               if dev.type == "cuda" else 0.0)
    check(torch.equal(runs[0][0], runs[1][0]),
          "[lm] the greedy tokens differ between two runs")
    v = cfg.vocab_size
    toks, first = runs[1][0], runs[1][1][:, :v]
    full_last = forward(params, cfg, tokens=torch.cat(
        [prompt, toks[:, :1]], dim=1))[0][:, -1, :v].float()
    top = float(full_last.abs().max())
    tol16 = TOLERANCES["bf16"]
    derr = close(first, full_last, f"{LM_ARCH} bf16: the first decode "
                 f"step vs the full forward", atol=tol16["atol"] * max(
                     1.0, top), rtol=tol16["rtol"])
    agree = int((first.argmax(-1) == full_last.argmax(-1)).sum())
    for i, (_, _, pre_ms, dec_ms) in enumerate(runs):
        say(f"[lm] {LM_ARCH} full width bf16 run {i + 1}: prefill "
            f"B={LM_BATCH} x {LM_PROMPT} tokens ms={pre_ms:.2f} "
            f"({LM_BATCH * LM_PROMPT / pre_ms * 1e3:.0f} tokens/s); decode "
            f"{LM_NEW} steps: ms/step={dec_ms:.2f} ms/token="
            f"{dec_ms / LM_BATCH:.3f}")
    say(f"[lm] {LM_ARCH} bf16: {n_params} parameters "
        f"({2 * n_params / 1e9:.2f} GB), init seconds={init_s:.2f}, peak "
        f"allocated {peak_gb:.2f} GiB; greedy tokens equal across the two "
        f"runs; first sequence {toks[0].tolist()}")
    say(f"[lm] {LM_ARCH} bf16: the first decode step vs the full forward "
        f"of prompt + token: max_abs_diff={derr:.3e} (max |logit| "
        f"{top:.3f}; atol {tol16['atol'] * max(1.0, top):.3f} rtol "
        f"{tol16['rtol']}); argmax equal in {agree}/{LM_BATCH}")

    # -- the slab on pooled hidden states at d = d_model ----------------
    def features(toks):
        out = []
        for i in range(0, toks.shape[0], LM_FEAT_BATCH):
            h, _, _ = forward(params, cfg, return_hidden=True,
                              tokens=torch.as_tensor(
                                  toks[i:i + LM_FEAT_BATCH], device=dev))
            out.append(pool_features(h.float(), "mean"))
        return torch.cat(out)

    hi = cfg.vocab_size - LM_SLAB_IDS
    t0 = sync()
    F = features(rng.integers(0, LM_SLAB_IDS, (LM_SLAB_M, LM_SLAB_S)))
    Q_in = features(rng.integers(0, LM_SLAB_IDS, (LM_SLAB_Q, LM_SLAB_S)))
    Q_out = features(rng.integers(hi, cfg.vocab_size,
                                  (LM_SLAB_Q, LM_SLAB_S)))
    feat_s = sync() - t0
    # whitened by the training features' mean and std, as fit_head does
    mean, scale = F.mean(dim=0), F.std(dim=0, correction=0) + 1e-6
    F, Q_in, Q_out = ((x - mean) / scale for x in (F, Q_in, Q_out))
    d = cfg.d_model
    spec = SlabSpec(nu1=0.2, nu2=0.1, eps=0.3, kernel=rbf(1.0 / d))
    reset_counts()
    t0 = sync()
    sm = repro_torch.serve(F.cpu().numpy(), spec, strategy="pallas",
                           precision="bf16", P=16, tol=TOL)
    s_in, s_out = sm.score(Q_in), sm.score(Q_out)
    slab_s = sync() - t0
    launches = {"fupdate": fupdate_classes(),
                "decision": dec.DECISION.launches}
    check(launches["fupdate"]["narrow"] > 0
          and launches["fupdate"]["wide"] > 0
          and launches["decision"] == 2,
          f"[lm] slab launches {launches}: the fit's narrow hot loop and "
          f"wide init pass, one decision launch for each score")
    auc = float((s_in[:, None] > s_out[None, :]).float().mean())
    kern = sm.spec.kernel
    r1, r2 = float(sm.rho1), float(sm.rho2)
    bucket = bucket_for(LM_SLAB_Q)
    cfg_dec = tiling.packed_decision_config(bucket, "bf16",
                                            sm.t_pad.shape[1],
                                            sm.t_pad.shape[0])
    tol32 = TOLERANCES["f32"]
    worst = {"decision": 0.0, "fupdate": 0.0}
    for what, Q, s in (("held-out", Q_in, s_in), ("OOD", Q_out, s_out)):
        q = torch.zeros((bucket, sm.t_pad.shape[1]), device=dev)
        q[:LM_SLAB_Q, :d] = Q
        ops = dec.prepare_packed(q, sm.t_pad, sm.gamma_pad, sm.t_norms,
                                 tm=min(bucket, 256), tn=sm.tn,
                                 precision="bf16")
        plain = decision_plain(*ops, r1, r2, kind="rbf",
                               gamma=kern.gamma)[:LM_SLAB_Q]
        top = float(plain.abs().max())
        err = close(s, plain, f"slab {what} scores vs the plain decision",
                    atol=tol32["atol"] * max(1.0, top), rtol=tol32["rtol"])
        worst["decision"] = max(worst["decision"], err)
        sure = plain.abs() > 1e-2 * top
        flips = int((torch.sign(s[sure]) != torch.sign(plain[sure])).sum())
        check(flips == 0, f"[lm] slab {what}: {flips} labels differ from "
              f"the plain decision")
    say(f"[lm] slab on pooled hidden states: m={LM_SLAB_M} x {LM_SLAB_S} "
        f"tokens (ids < {LM_SLAB_IDS}), d={d}, rbf(1/{d}), bf16, "
        f"strategy=pallas: fit iters={sm.fit_iters} n_sv={sm.n_sv}; "
        f"features seconds={feat_s:.2f} ({LM_SLAB_M + 2 * LM_SLAB_Q} "
        f"sequences), fit + 2 scores seconds={slab_s:.2f}; launches "
        f"{launches}; decision entry {cfg_dec.entry} "
        f"({tiling.kernel_of('decision', cfg_dec)}) at bucket {bucket}; "
        f"scores vs plain max_abs_diff={worst['decision']:.3e}, no label "
        f"flipped; AUC(held-out > OOD)={auc:.4f}; inside the slab: "
        f"held-out {int((s_in >= 0).sum())}/{LM_SLAB_Q}, OOD "
        f"{int((s_out >= 0).sum())}/{LM_SLAB_Q}")

    # The two kernels at the fit's and the score's shapes: held against
    # their plain versions and timed (launches made here do not count).
    def bound(nbytes, flops):
        t = terms(flops, nbytes, 0.0, 1, "bf16")
        return (1e3 * t.step_time_s,
                "bytes" if t.memory_s >= t.compute_s else "operations")

    rows = []
    m = LM_SLAB_M
    for s_sel in (32, m):          # the hot loop (2P), the init pass
        xsel = F[torch.as_tensor(rng.choice(m, s_sel, replace=False),
                                 device=dev)]
        delta = torch.as_tensor(rng.standard_normal(s_sel)
                                .astype(np.float32), device=dev)
        f0 = torch.as_tensor(rng.uniform(-1, 1, m).astype(np.float32),
                             device=dev)
        ops = fup.prepare(F, xsel, delta, torch.zeros_like(f0),
                          precision="bf16")
        step = fupdate_plain(*ops, kind="rbf", gamma=kern.gamma).abs().max()
        ops = fup.prepare(F, xsel, delta / step, f0, precision="bf16")
        c = fup.tiles(ops[0], s_sel)
        out = fup.launch(*ops, kern, c)()
        plain = fupdate_plain(*ops, kind="rbf", gamma=kern.gamma)
        top = float(plain.abs().max())
        err = close(out, plain, f"fupdate m={m} S={s_sel} d={d} bf16",
                    atol=tol32["atol"] * max(1.0, top), rtol=tol32["rtol"])
        worst["fupdate"] = max(worst["fupdate"], err)
        ms = time_ms(lambda: fup.launch(*ops, kern, c)(), iters=20)
        plain_ms = time_ms(lambda: fupdate_plain(
            *ops, kind="rbf", gamma=kern.gamma), iters=20)
        b_ms, b_by = bound((m + s_sel) * d * 2 + 4 * (3 * m + 2 * s_sel),
                           2 * m * s_sel * d + 2 * m * s_sel)
        cls = "narrow" if s_sel <= tiling.FUPDATE_NARROW_MAX_S else "wide"
        rows.append({
            "name": f"fupdate_{'wide_' * (cls == 'wide')}lm_bf16_d{d}",
            "route": "cuda", "source": "src/repro_torch/csrc/fupdate.cu",
            "replaces": "src/repro/kernels/fupdate/kernel.py:30",
            "launches": launches["fupdate"][cls], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "pass": True,
            "shape": f"m={m} S={s_sel} d={d} rbf bf16 ({cls} class, entry "
                     f"{c.entry}; [lm] slab fit on pooled hidden states)"})
        say(f"[timing] fupdate m={m} S={s_sel} d={d} rbf bf16 config "
            f"{c.entry} ({tiling.kernel_of('fupdate', c)}) kernel_ms="
            f"{ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by})"
            f" bound_share={b_ms / ms:.3f} max_abs_err={err:.3e}")
    nt, dp = sm.t_pad.shape
    q = torch.zeros((bucket, dp), device=dev)
    q[:LM_SLAB_Q, :d] = Q_out
    ops = dec.prepare_packed(q, sm.t_pad, sm.gamma_pad, sm.t_norms,
                             tm=min(bucket, 256), tn=sm.tn, precision="bf16")
    ms = time_ms(lambda: dec.launch(*ops, r1, r2, kern, cfg_dec)(), iters=20)
    plain_ms = time_ms(lambda: decision_plain(
        *ops, r1, r2, kind="rbf", gamma=kern.gamma), iters=20)
    b_ms, b_by = bound((bucket + nt) * dp * 2 + 4 * (2 * nt + 2 * bucket),
                       2 * bucket * nt * dp + 2 * bucket * nt)
    rows.append({
        "name": f"decision_lm_bf16_d{d}", "route": "cuda",
        "source": "src/repro_torch/csrc/decision.cu",
        "replaces": "src/repro/kernels/decision/kernel.py:27",
        "launches": launches["decision"], "max_abs_err": worst["decision"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "pass": True,
        "shape": f"queries={bucket} support={nt} d={d} rbf bf16 (entry "
                 f"{cfg_dec.entry}; [lm] slab scores)"})
    say(f"[timing] decision bf16 d={d} bucket={bucket} support={nt} config "
        f"{cfg_dec.entry} ({tiling.kernel_of('decision', cfg_dec)}) "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} "
        f"({b_by}) bound_share={b_ms / ms:.3f}")
    del params, F, Q_in, Q_out, sm
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the CLI, in a process of its own -------------------------------
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", LM_CLI_CHILD, *LM_CLI_ARGS],
        capture_output=True, text=True, timeout=LM_CLI_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=str(src)))
    check(out.returncode == 0, f"[lm] the CLI exited with {out.returncode}:"
          f" {out.stderr[-2000:]}")
    lines = out.stdout.strip().splitlines()
    check(len(lines) == 2 and lines[0].startswith(
        f"generated ({LM_BATCH}, {LM_NEW}) in ")
        and lines[1].startswith("first sequence: ["),
        f"[lm] the CLI printed {lines}")
    for line in lines:
        say(f"[lm] cli | {line}")
    say(f"[lm] cli: {' '.join(LM_CLI_ARGS)}, process seconds="
        f"{time.perf_counter() - t0:.2f}")
    say(f"[lm] phase seconds={time.perf_counter() - phase_t0:.2f}")
    pre_ms, dec_ms = runs[1][2], runs[1][3]
    return {"launches": launches, "rows": rows,
            "scan_launches": scan_launches,
            "prompt": prompt.cpu().numpy(), "prefill_ms": pre_ms,
            "decode_ms": dec_ms, "peak_gib": peak_gb}


def _params_close(got, want, lr: float, what: str) -> float:
    """Parameters after the second step, card against CPU: every entry
    within LMT_PARAM_ATOL + LMT_PARAM_RTOL |p|, but for at most
    LMT_PARAM_FRAC of a leaf's entries, which stay within 3 lr (AdamW
    normalises a gradient near zero to a step of about the lr, so a
    difference in its last bits can move such an entry by up to twice
    the lr). Returns the largest difference in units of the lr."""
    import torch
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.detach().float().cpu(), b.detach().float()
        diff = (a - b).abs()
        n_out = int((diff > LMT_PARAM_ATOL + LMT_PARAM_RTOL * b.abs()).sum())
        check(n_out <= LMT_PARAM_FRAC * b.numel()
              and bool((diff <= 3 * lr).all())
              and bool(torch.isfinite(a).all()),
              f"[lm-train] {what}: {n_out} of {b.numel()} entries outside "
              f"atol {LMT_PARAM_ATOL} rtol {LMT_PARAM_RTOL}, max diff "
              f"{float(diff.max()):.3e} (lr {lr:.3e})")
        worst = max(worst, float(diff.max()) / lr)
    return worst


def _lm_train_phase(dev, src: Path, reset_counts, launch_counts) -> dict:
    """[lm-train]: the LM training step (``repro_torch.train.train_step``,
    ``repro_torch.optim``, ``launch.train``), with the kernels' counts
    set to 0 just before and read just after: no Pallas kernel lies on
    this path, so it launches none of them. In order: the ten archs at
    their ``reduced()`` sizes, two ``make_train_step`` steps on the card
    against the same steps on the CPU, the card's run made twice (bitwise
    or not, printed: the embedding's and the MoE's backward scatter-add);
    LM_ARCH at full width and LMT_PARITY_LAYERS layers in f32, one step's
    loss, grad norm and gradients of wq / w1 / unembed against the CPU
    (the fused CE at the full vocab); LM_ARCH at full width and depth in
    bf16 (AdamW, remat "full"): LMT_STEPS steps of LMT_BATCH x LMT_SEQ
    tokens, ``make_train_step``'s default schedule (each step's loss, grad
    norm, lr and ms; the median of steps
    2.., tokens/s, MFU, the peak allocated memory), then one step taken
    apart (forward + backward, clip, update) and one under the profiler;
    ``FaultTolerantLoop`` on reduced LM_ARCH with failures injected at
    steps 6 and 11; ``repro_torch.launch.train`` in a subprocess."""
    import dataclasses
    import statistics
    import tempfile
    import types
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.data.synthetic import SyntheticPipeline
    from repro_torch.kernels.scan import ops as sops
    from repro_torch.models.transformer import init_params, param_tree
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
    from repro_torch.train import train_step as tts
    from repro_torch.utils.cost_analysis import storage_bytes
    from repro_torch.utils.tree import leaves, map_tree, unflatten
    phase_t0 = time.perf_counter()
    cpu = torch.device("cpu")

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    def to(tree, device):
        return map_tree(lambda t: t.to(device, copy=True), tree)

    def close(got, want, what, atol, rtol):
        got, want = got.detach().float().cpu(), want.detach().float().cpu()
        diff = (got - want).abs()
        bad = int((diff > atol + rtol * want.abs()).sum())
        check(got.shape == want.shape and bad == 0
              and bool(torch.isfinite(got).all()),
              f"[lm-train] {what}: {bad} values outside atol {atol:.3g} "
              f"rtol {rtol:.3g} (max abs diff {float(diff.max()):.3e})")
        return float(diff.max())

    def held(m, want, what):
        for k in ("loss", "ce", "aux"):
            close(m[k], want[k], f"{what} {k}", LMT_LOSS_ATOL, LMT_LOSS_RTOL)
        close(m["grad_norm"], want["grad_norm"], f"{what} grad norm", 0.0,
              LMT_NORM_RTOL)
        check(float(m["lr"]) == float(want["lr"]),
              f"[lm-train] {what}: lr {float(m['lr'])} against "
              f"{float(want['lr'])}")

    reset_counts()

    # -- the ten archs, reduced: two steps on the card against the CPU ----
    t0 = sync()
    varying = []
    scan_launches = {}
    for name in sorted(ARCHS):
        cfg = ARCHS[name].reduced()
        sops.reset_counts()
        host = tts.init_train_state(cfg, init_params(
            cfg, torch.Generator().manual_seed(SEED), device=cpu))
        cards = [to(host, dev) for _ in range(2)]
        pipe = SyntheticPipeline(cfg, batch=2, seq_len=16, seed=SEED,
                                 device=cpu)
        step = tts.make_train_step(cfg, **LMT_STEP_KW)
        for i in range(2):
            batch = pipe.next_batch()
            host, want = step(host, batch)
            on_card = {k: v.to(dev) for k, v in batch.items()}
            runs = [step(st, on_card) for st in cards]
            cards = [st for st, _ in runs]
            held(runs[0][1], want, f"{name} reduced step {i}")
        lr = float(want["lr"])
        ratio = _params_close(leaves(cards[0].params), leaves(host.params),
                              lr, f"{name} reduced: the parameters after 2 "
                              f"steps")
        same = all(torch.equal(a, b) for a, b in zip(leaves(cards[0]),
                                                      leaves(cards[1])))
        if not same:
            varying.append(name)
        scan = ""
        if name in SCAN_ARCHS:
            # the scan kernels' backward sums in a fixed order
            check(same, f"[lm-train] reduced {name}: the card's two runs "
                  f"are not bitwise equal")
            scan_launches[name] = _scan_checked("lm-train", name,
                                                _scan_counts(), backward=True)
            scan = f"; scan launches {scan_launches[name]}"
        say(f"[lm-train] reduced {name} ({cfg.optimizer}): 2 steps card vs "
            f"cpu held: loss={float(want['loss']):.6f} grad_norm="
            f"{float(want['grad_norm']):.6f}; parameters max diff "
            f"{ratio:.3e} lr; the card's two runs bitwise equal: {same}"
            f"{scan}")
    say(f"[lm-train] reduced archs: all {len(ARCHS)} held, seconds="
        f"{sync() - t0:.2f}; not bitwise across two runs on the card: "
        f"{varying or 'none'}")

    # -- full width, LMT_PARITY_LAYERS layers, f32: one step card vs cpu --
    full_cfg = get_arch(LM_ARCH)
    cfg = dataclasses.replace(full_cfg, n_layers=LMT_PARITY_LAYERS,
                              param_dtype="float32")
    check(cfg.padded_vocab >= tts.FUSED_CE_MIN_VOCAB,
          "[lm-train] the full-width step does not take the fused CE")
    card = param_tree(init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev))
    host = to(card, cpu)
    toks = np.random.default_rng(SEED + 21).integers(
        0, cfg.vocab_size, (1, LMT_PARITY_S + 1)).astype(np.int32)

    def grads(params, device):
        live = map_tree(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = tts.loss_fn(live, cfg, {
            "tokens": torch.as_tensor(toks[:, :-1], device=device),
            "labels": torch.as_tensor(toks[:, 1:], device=device)})
        g = unflatten(params, torch.autograd.grad(loss, leaves(live)))
        return loss.detach(), tts.global_norm(g), g

    t0 = sync()
    loss, gnorm, g = grads(card, dev)
    card_ms = 1e3 * (sync() - t0)
    t0 = time.perf_counter()
    loss_w, gnorm_w, g_w = grads(host, cpu)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    close(loss, loss_w, f"{LM_ARCH} full width f32 loss", LMT_LOSS_ATOL,
          LMT_LOSS_RTOL)
    close(gnorm, gnorm_w, f"{LM_ARCH} full width f32 grad norm", 0.0,
          LMT_NORM_RTOL)
    errs = {}
    for what, a, b in (
            [(f"{k} layer {r}", g["segments"]["l0"][blk][k][r],
              g_w["segments"]["l0"][blk][k][r])
             for blk, k in (("attn", "wq"), ("mlp", "w1"))
             for r in range(LMT_PARITY_LAYERS)]
            + [("unembed", g["unembed"], g_w["unembed"])]):
        top = float(b.abs().max())
        errs[what] = close(a, b, f"{LM_ARCH} full width f32 d/d{what}",
                           LMT_GRAD_ATOL * top, LMT_GRAD_RTOL) / top
    say(f"[lm-train] {LM_ARCH} full width (d={cfg.d_model}, vocab "
        f"{cfg.padded_vocab}: fused CE), {LMT_PARITY_LAYERS} layers, f32, "
        f"B=1 S={LMT_PARITY_S}: loss card={float(loss):.6f} "
        f"cpu={float(loss_w):.6f}, grad norm card={float(gnorm):.6f} "
        f"cpu={float(gnorm_w):.6f}; gradients max diff / max |grad|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; forward + backward ms card={card_ms:.1f} (first call) "
        f"cpu={cpu_ms:.1f}")
    del card, host, g, g_w

    # -- full width and depth, bf16, AdamW, remat "full" ------------------
    cfg = full_cfg
    check(cfg.remat == "full" and cfg.optimizer == "adamw"
          and cfg.dtype == torch.bfloat16,
          f"[lm-train] {LM_ARCH}: remat {cfg.remat}, {cfg.optimizer}, "
          f"{cfg.dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = sync()
    state = tts.init_train_state(cfg, init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev))
    init_s = sync() - t0
    ps = leaves(state.params)
    n_params = sum(t.numel() for t in ps)
    # the matmul weights: every matrix but the embedding table (a gather)
    n_mm = sum(t.numel() for t in ps if t.dim() >= 2) \
        - state.params["embed"].numel()
    state_gib = sum(t.numel() * t.element_size()
                    for t in leaves(state)) / 2**30
    state_bytes = storage_bytes(state)      # [dryrun]'s argument bytes
    watch = {"wq layer 0": state.params["segments"]["l0"]["attn"]["wq"][0],
             "final_norm": state.params["final_norm"],
             "unembed": state.params["unembed"]}
    before = {k: v.clone() for k, v in watch.items()}
    pipe = SyntheticPipeline(cfg, batch=LMT_BATCH, seq_len=LMT_SEQ,
                             seed=SEED, device=dev)
    step = tts.make_train_step(cfg)
    tokens = LMT_BATCH * LMT_SEQ
    secs, bf16_metrics = [], []
    for i in range(LMT_STEPS):
        batch = pipe.next_batch()
        batch_bytes = storage_bytes(batch)
        t0 = sync()
        state, m = step(state, batch)
        vals = {k: float(v) for k, v in m.items()}
        secs.append(sync() - t0)
        bf16_metrics.append(vals)
        check(all(np.isfinite(v) for v in vals.values()),
              f"[lm-train] {LM_ARCH} bf16 step {i}: {vals}")
        say(f"[lm-train] {LM_ARCH} full width bf16 step {i}: loss="
            f"{vals['loss']:.6f} grad_norm={vals['grad_norm']:.6f} lr="
            f"{vals['lr']:.3e} ms={1e3 * secs[-1]:.2f}")
        if i == 1:
            moved = {k: float((v != before[k]).float().mean())
                     for k, v in watch.items()}
            check(all(moved.values()), f"[lm-train] {LM_ARCH} bf16: the "
                  f"parameters did not move after step 2: {moved}")
    med = statistics.median(secs[2:])
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    check(peak_gib < card_gib, f"[lm-train] peak {peak_gib:.2f} GiB")
    mfu = 6 * n_mm * tokens / med / BF16_PEAK_FLOPS
    # remat re-runs each layer's forward, the fused CE its unembed matmul
    hfu = 8 * n_mm * tokens / med / BF16_PEAK_FLOPS
    say(f"[lm-train] {LM_ARCH} full width and depth, bf16, AdamW, remat "
        f"full, B={LMT_BATCH} x S={LMT_SEQ}: {n_params} parameters "
        f"({n_mm} in matmuls), state {state_gib:.2f} GiB, init seconds="
        f"{init_s:.2f}; median step of steps 2..{LMT_STEPS - 1} ms="
        f"{1e3 * med:.2f} (steps ms {[round(1e3 * s, 2) for s in secs]}), "
        f"tokens/s={tokens / med:.0f}, MFU={mfu:.4f} (6 N tokens; with the "
        f"remat forward and the CE's recomputed unembed, 8 N tokens: "
        f"{hfu:.4f}) against {BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16; "
        f"peak allocated {peak_gib:.2f} GiB of {card_gib:.2f}; share of "
        f"the entries moved by step 2: "
        + ", ".join(f"{k} {v:.4f}" for k, v in moved.items()))

    # one step taken apart: forward + backward, clip, update
    batch = pipe.next_batch()
    t0 = sync()
    live = map_tree(lambda t: t.detach().requires_grad_(True), state.params)
    loss, _ = tts.loss_fn(live, cfg, batch)
    g = unflatten(state.params, torch.autograd.grad(loss, leaves(live)))
    del live, loss
    t1 = sync()
    g, _ = tts.clip_by_global_norm(g, 1.0)
    t2 = sync()
    lr = warmup_cosine(state.step, peak_lr=3e-4, warmup_steps=100,
                       total_steps=10_000)
    params, opt_state = adamw.update(g, state.opt_state, state.params,
                                     lr=lr)
    t3 = sync()
    del g
    state = tts.TrainState(params, opt_state, state.step + 1)
    split = {"forward+backward": t1 - t0, "clip": t2 - t1,
             "update": t3 - t2}
    say(f"[lm-train] {LM_ARCH} bf16 one step taken apart, ms: "
        + ", ".join(f"{k}={1e3 * v:.2f}" for k, v in split.items())
        + f"; the AdamW update moves {22 * n_params / 1e9:.1f} GB at "
        f"least (22 B a parameter): bound ms="
        f"{1e3 * 22 * n_params / 3.35e12:.2f} at 3.35 TB/s")

    def one_step():
        nonlocal state
        state, m = step(state, pipe.next_batch())
        float(m["loss"])
        return types.SimpleNamespace(iters=1)

    _say_trace("[lm-train]", f"{LM_ARCH} bf16 one step under the profiler:",
               _traced(one_step))
    del state, watch, before, params, opt_state
    torch.cuda.empty_cache()

    # -- the fault-tolerant loop, reduced, on the card --------------------
    cfg = ARCHS[LM_ARCH].reduced()
    fails = {6, 11}

    def injector(s):
        if s in fails:
            fails.discard(s)
            raise RuntimeError("injected")

    t0 = sync()
    with tempfile.TemporaryDirectory() as d:
        loop = FaultTolerantLoop(
            tts.make_train_step(cfg, peak_lr=1e-3, warmup_steps=2,
                                total_steps=100),
            tts.init_train_state(cfg, init_params(
                cfg, torch.Generator(device=dev).manual_seed(SEED),
                device=dev)),
            SyntheticPipeline(cfg, batch=2, seq_len=16, seed=SEED,
                              device=dev),
            d, save_every=4, failure_injector=injector)
        loop.run(14)
    by_step, worst = {}, 0.0
    for m in loop.metrics_log:
        if m["step"] in by_step:
            worst = max(worst, abs(by_step[m["step"]] - m["loss"]))
        by_step[m["step"]] = m["loss"]
    check(loop.restarts == 2 and set(by_step) == set(range(14))
          and worst < 1e-5 and len(loop.metrics_log) > 14,
          f"[lm-train] loop: restarts {loop.restarts}, steps "
          f"{sorted(by_step)}, replayed loss diff {worst:.3e}")
    say(f"[lm-train] FaultTolerantLoop reduced {LM_ARCH} on the card, "
        f"failures at steps 6 and 11: restarts={loop.restarts}, "
        f"{len(loop.metrics_log)} steps run for 14, replayed losses max "
        f"diff {worst:.3e}, seconds={sync() - t0:.2f}")

    # -- the CLI, in a process of its own --------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *LMT_CLI_ARGS,
             "--ckpt-dir", d], capture_output=True, text=True,
            timeout=LM_CLI_TIMEOUT_S, env=dict(os.environ,
                                                PYTHONPATH=str(src)))
    check(out.returncode == 0, f"[lm-train] the CLI exited with "
          f"{out.returncode}: {out.stderr[-2000:]}")
    lines = out.stdout.strip().splitlines()
    check(len(lines) == 2 and re.fullmatch(r"step 0: loss \d+\.\d{4}",
                                           lines[0]) is not None
          and re.fullmatch(r"step 19: loss \d+\.\d{4} \(\d+ ms/step, "
                           r"restarts=0\)", lines[1]) is not None,
          f"[lm-train] the CLI printed {lines}")
    for line in lines:
        say(f"[lm-train] cli | {line}")
    say(f"[lm-train] cli: {' '.join(LMT_CLI_ARGS)}, process seconds="
        f"{time.perf_counter() - t0:.2f}")

    launches = launch_counts()
    check(not any(launches.values()), f"[lm-train] the training path "
          f"launched slab kernels: {launches}")
    say(f"[lm-train] launches {launches} (no Pallas kernel lies on the "
        f"training path); phase seconds={time.perf_counter() - phase_t0:.2f}")
    return {"launches": launches, "scan_launches": scan_launches,
            "step_ms": 1e3 * med,
            "tokens_s": tokens / med, "peak_gib": peak_gib,
            "metrics": bf16_metrics, "state_bytes": state_bytes,
            "batch_bytes": batch_bytes}


def _lm_dist_cases():
    """[lm-dist] (a)'s cases: LMD_ARCHS reduced on (2, 2) "tp" with
    fsdp, two steps, the parameters gathered; LM_ARCH at full width and
    LMD_FULL_LAYERS layers, f32, one step of LMD_FULL_B x LMD_FULL_S
    tokens, on (2, 2) "tp" with fsdp (``tp_mlp`` on: Megatron's MLP),
    "tp" without fsdp and "fsdp"."""
    mesh = [(2, 2), ("data", "model")]
    cases = [dict(key=f"{name} reduced tp fsdp", arch=name, mesh=mesh,
                  layout="tp", fsdp=True, steps=2, batch=4, seq=16,
                  params=True, step_kw=LMT_STEP_KW) for name in LMD_ARCHS]
    full = dict(reduced=False, mesh=mesh, steps=1, batch=LMD_FULL_B,
                seq=LMD_FULL_S, step_kw=LMT_STEP_KW, arch=LM_ARCH)
    over = dict(n_layers=LMD_FULL_LAYERS, param_dtype="float32")
    for key, layout, fsdp, tp_mlp in (("tp fsdp tp_mlp", "tp", True, True),
                                      ("tp", "tp", False, False),
                                      ("fsdp", "fsdp", False, False)):
        cases.append(dict(full, key=f"{LM_ARCH} full width {key}",
                          layout=layout, fsdp=fsdp,
                          overrides=dict(over, tp_mlp=tp_mlp)))
    return cases


def _lm_dist_phase(dev, lm_train: dict, reset_counts, launch_counts) -> dict:
    """[lm-dist]: the sharded LM training step (``repro_torch.sharding``,
    ``make_train_step(cfg, constrain=make_constrain(...))``) in spawned
    rank processes. Each rank sets the kernels' counts to 0 at its start
    and returns them read before any single-device run in it; the
    path's launches are their sum over the ranks of (a) and (b), and must
    be 0 (no Pallas kernel lies on the path). The single-device runs'
    launches are counted apart: (b)'s in its rank, the parent's (its
    counts set to 0 before (a) and read at the end) for the oracle of
    (a). The rank functions are ``tests/torch_dist_ranks.py``'s (torch
    and the port only), as the CPU tests run them.

    (a) four gloo ranks sharing the card, a (2, 2) ("data", "model")
    mesh (``_lm_dist_cases``), each case held against the port's
    single-device step on the card in f32 on the same parameters and
    batches (an MoE arch's capacity factor E on both sides; under "tp"
    the oracle's MoE aux is the mean over the data shards, as the
    sharded step's is): loss, ce, aux and grad norm within LMD_RTOL, the
    lr equal, the reduced archs' parameters after two steps as
    ``_params_close`` says. (b) one NCCL rank on the (1, 1) mesh:
    LM_ARCH at full width and depth in bf16 (AdamW, remat "full"),
    LMT_STEPS steps of LMT_BATCH x LMT_SEQ tokens through the sharded
    code path, on [lm-train]'s seed, parameters, batches and schedule:
    each step's loss and grad norm held against [lm-train]'s
    (``lm_train["metrics"]``) within LMD_BF16_LOSS_RTOL /
    LMD_BF16_NORM_RTOL, the lr equal; its median step (steps 2..),
    tokens/s, peak memory and host seconds in collectives beside
    [lm-train]'s, and beside the single-device step's run after it in
    the same rank process (``plain``: the same steps, timed alike); then
    one step of each under the profiler (``_traced``), in the rank."""
    import statistics
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch import spawn_ranks
    from repro_torch.utils.tree import leaves
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_dist_ranks as ranks_mod
    phase_t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()

    # -- (a) four gloo ranks sharing the card ------------------------------
    cases = _lm_dist_cases()
    t0, spawned = time.perf_counter(), time.time()
    with tempfile.TemporaryDirectory() as tmp:
        got = spawn_ranks(ranks_mod.lm_dist_steps, LMD_RANKS,
                          backend="gloo",
                          args=(dict(device="cuda", seed=SEED,
                                     cases=cases),),
                          timeout_s=LMD_TIMEOUT_S, dir=tmp)
    ranks_s = time.perf_counter() - t0
    by_call = {"a": _summed_launches(got)}
    scan_launches = _rank_scan_launches("lm-dist", got, cases, True)
    oracles = {}
    for case in cases:
        res = got[0][case["key"]]
        check(all(r[case["key"]]["metrics"] == res["metrics"]
                  for r in got[1:]),
              f"[lm-dist] {case['key']}: the ranks report different values")
        cfg = ranks_mod.lm_dist_cfg(case)
        okey = (case["arch"], case.get("reduced", True),
                ranks_mod.aux_groups(case) if cfg.n_experts else 1)
        if okey not in oracles:
            torch.cuda.empty_cache()
            oracles[okey] = ranks_mod.lm_oracle(case, dev, SEED)
        want, state = oracles[okey]
        for i, (g, w) in enumerate(zip(res["metrics"], want)):
            for k in ("loss", "ce", "aux", "grad_norm"):
                check(abs(g[k] - w[k]) <= LMD_RTOL * abs(w[k]),
                      f"[lm-dist] {case['key']} step {i} {k}: {g[k]!r} "
                      f"against the single-device {w[k]!r}")
            check(g["lr"] == w["lr"], f"[lm-dist] {case['key']}: lr")
        worst = None
        if case.get("params"):
            worst = _params_close(
                [torch.as_tensor(p) for p in res["params"]],
                [t.cpu() for t in leaves(state.params)], want[-1]["lr"],
                f"[lm-dist] {case['key']}")
        m = res["metrics"][-1]
        say(f"[lm-dist] (a) {case['key']} on 4 gloo ranks: "
            f"{len(res['metrics'])} step(s) held: loss={m['loss']:.6f} "
            f"grad_norm={m['grad_norm']:.6f} aux={m['aux']:.6f}"
            + ("" if worst is None else
               f"; parameters max diff {worst:.3e} lr")
            + f"; collectives a step {res['collective_calls']} "
            f"({res['ops']} in all), host ms in them "
            f"{[round(x, 1) for x in res['collective_ms']]}, step ms "
            f"{[round(x, 1) for x in res['ms']]}")
    del oracles, state
    torch.cuda.empty_cache()
    say(f"[lm-dist] (a) {len(cases)} cases held; ranks seconds="
        f"{ranks_s:.2f} (the spawn to the last rank's function "
        f"{max(r['entered'] for r in got) - spawned:.2f})")

    # -- (b) one NCCL rank, (1, 1), full width and depth, bf16 ------------
    case = dict(key="full", arch=LM_ARCH, reduced=False,
                mesh=[(1, 1), ("data", "model")], layout="tp", fsdp=False,
                steps=LMT_STEPS, batch=LMT_BATCH, seq=LMT_SEQ, plain=True,
                trace=True)
    t0, spawned = time.perf_counter(), time.time()
    with tempfile.TemporaryDirectory() as tmp:
        got = spawn_ranks(ranks_mod.lm_dist_steps, 1, backend="nccl",
                          args=(dict(device="cuda", seed=SEED,
                                     cases=[case], tracer=_traced),),
                          timeout_s=LMD_TIMEOUT_S, dir=tmp)
    by_call["b"] = _summed_launches(got)
    plain_b = _summed_launches(got, "oracle_launches")
    res = got[0]["full"]
    want = lm_train["metrics"]
    check(len(res["metrics"]) == len(want) == LMT_STEPS,
          f"[lm-dist] (b): {len(res['metrics'])} steps against "
          f"[lm-train]'s {len(want)}")
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for i, (g, w) in enumerate(zip(res["metrics"], want)):
        for k, rtol in (("loss", LMD_BF16_LOSS_RTOL),
                        ("grad_norm", LMD_BF16_NORM_RTOL)):
            rel = abs(g[k] - w[k]) / abs(w[k])
            worst[k] = max(worst[k], rel)
            check(np.isfinite(g[k]) and rel <= rtol,
                  f"[lm-dist] (b) step {i} {k}: {g[k]!r} against "
                  f"[lm-train]'s {w[k]!r} (rtol {rtol})")
        check(g["lr"] == w["lr"], f"[lm-dist] (b) step {i}: lr {g['lr']} "
              f"against [lm-train]'s {w['lr']}")
    med = statistics.median(res["ms"][2:])
    plain_med = statistics.median(res["plain_ms"][2:])
    tokens = LMT_BATCH * LMT_SEQ
    coll_ms = statistics.median(res["collective_ms"][2:])
    calls = statistics.median(res["collective_calls"][2:])
    say(f"[lm-dist] (b) {LM_ARCH} full width and depth, bf16, AdamW, remat "
        f"full, 1 NCCL rank on (1, 1), B={LMT_BATCH} x S={LMT_SEQ}, "
        f"[lm-train]'s seed and batches: losses "
        f"{[round(m['loss'], 6) for m in res['metrics']]}, grad norms "
        f"{[round(m['grad_norm'], 6) for m in res['metrics']]}; held "
        f"against [lm-train]'s: max rel diff loss {worst['loss']:.3e} "
        f"(rtol {LMD_BF16_LOSS_RTOL}), grad norm {worst['grad_norm']:.3e} "
        f"(rtol {LMD_BF16_NORM_RTOL}); the single-device step after it in "
        f"the same process: losses "
        f"{[round(m['loss'], 6) for m in res['plain_metrics']]}; median "
        f"step of steps 2..{LMT_STEPS - 1} ms={med:.2f} (steps ms "
        f"{[round(x, 2) for x in res['ms']]}; [lm-train] "
        f"{lm_train['step_ms']:.2f}; the single-device step in the same "
        f"process {plain_med:.2f}, steps ms "
        f"{[round(x, 2) for x in res['plain_ms']]}), tokens/s="
        f"{tokens / med * 1e3:.0f} ([lm-train] {lm_train['tokens_s']:.0f})"
        f", peak allocated {res['peak_gib']:.2f} GiB ([lm-train] "
        f"{lm_train['peak_gib']:.2f}; the single-device step in the same "
        f"process {res['plain_peak_gib']:.2f});"
        f" collectives a step {calls:.0f} ({res['ops']} in all, "
        f"{res['ledger'].get('step_bytes', 0) / len(res['ms']) / 2**30:.2f}"
        f" GiB a step), host ms in them a step (median of steps 2..) "
        f"{coll_ms:.2f} (each step "
        f"{[round(x, 2) for x in res['collective_ms']]}); process seconds="
        f"{time.perf_counter() - t0:.2f} (the spawn to the rank's function "
        f"{got[0]['entered'] - spawned:.2f})")
    _say_trace("[lm-dist]", "(b) one sharded step under the profiler:",
               res["trace"])
    _say_trace("[lm-dist]", "(b) one single-device step under the "
               "profiler, same process:", res["plain_trace"])

    launches = {k: by_call["a"][k] + by_call["b"][k] for k in by_call["a"]}
    oracle = launch_counts()
    check(not any(launches.values()), f"[lm-dist] the sharded training "
          f"path launched slab kernels in its ranks: {by_call}")
    check(not any(oracle.values()) and not any(plain_b.values()),
          f"[lm-dist] the single-device runs launched slab kernels: the "
          f"parent's oracle {oracle}, (b)'s in its rank {plain_b}")
    say(f"[lm-dist] launches on the sharded path, the ranks' counts summed: "
        f"{launches} ((a) {by_call['a']}, (b) {by_call['b']}; no Pallas "
        f"kernel lies on the sharded training path); the single-device "
        f"runs, apart: the parent's oracle {oracle}, (b)'s in its rank "
        f"{plain_b}; phase seconds={time.perf_counter() - phase_t0:.2f}")
    return {"launches": launches, "scan_launches": scan_launches,
            "step_ms": med, "coll_ms": coll_ms,
            "peak_gib": res["peak_gib"]}


def _lm_serve_dist_cases():
    """[lm-serve-dist] (a)'s cases on (2, 2): under "tp" with fsdp
    LMS_TP_ARCHS reduced, llama at B = 1 (positions over data + model),
    mixtral after a prompt of 5 (its ring longer than the prompt: C.12),
    LM_ARCH at full width, LMS_FULL_LAYERS layers, f32, LMS_FULL_STEPS
    steps (fsdp off below 4e9 parameters, as the launcher has it); under
    "fsdp" LMS_FSDP_ARCHS reduced and mixtral after a prompt of 5 (the
    rows over ("data", "model"), each mixer on the cache's rows over
    "data")."""
    mesh = [(2, 2), ("data", "model")]
    base = dict(mesh=mesh, fsdp=True, layout="tp", batch=LMS_B,
                prompt=LMS_PROMPT, steps=LMS_STEPS, cache_len=LMS_CACHE)
    cases = [dict(base, key=f"{name} reduced", arch=name)
             for name in LMS_TP_ARCHS]
    cases.append(dict(base, key=f"{LM_ARCH} reduced B=1", arch=LM_ARCH,
                      batch=1))
    cases.append(dict(base, key="mixtral-8x22b reduced prompt=5",
                      arch="mixtral-8x22b", prompt=5))
    cases.append(dict(base, key=f"{LM_ARCH} full width", arch=LM_ARCH,
                      reduced=False, fsdp=False, prompt=LMS_FULL_PROMPT,
                      steps=LMS_FULL_STEPS,
                      cache_len=LMS_FULL_PROMPT + 2 * LMS_FULL_STEPS,
                      overrides=dict(n_layers=LMS_FULL_LAYERS,
                                     param_dtype="float32")))
    fsdp = dict(base, fsdp=False, layout="fsdp")
    cases += [dict(fsdp, key=f"{name} reduced fsdp", arch=name)
              for name in LMS_FSDP_ARCHS]
    cases.append(dict(fsdp, key="mixtral-8x22b reduced prompt=5 fsdp",
                      arch="mixtral-8x22b", prompt=5))
    return cases


def _lm_serve_dist_phase(dev, lm: dict, reset_counts, launch_counts) -> dict:
    """[lm-serve-dist]: sharded LM serving (``train.serve_step`` with
    ``constrain=make_constrain(...)``, ``init_params_sharded``,
    ``sharding.state.init_cache_sharded``) in spawned rank processes,
    with ``tests/torch_dist_ranks.py``'s rank functions. Each rank sets
    the kernels' counts to 0 at its start and returns them read before
    any single-device run in it; the path's launches are their sum over
    the ranks of (a) and (b) and must be 0 (no Pallas kernel lies on the
    path). The single-device runs' launches are counted apart: (b)'s in
    its rank, the parent's (its counts set to 0 before (a) and read at
    the end) for the oracle of (a).

    (a) four gloo ranks sharing the card, (2, 2) "tp" and "fsdp"
    (``_lm_serve_dist_cases``), each case held against the single-device
    run on the card (``lm_serve_oracle``, same parameters and prompt;
    an MoE arch's capacity factor E on both sides): every step's logits
    within LMS_ATOL, the greedy tokens equal, the ranks alike, every
    rank's cache leaf the single-device leaf cut for that rank within
    LMS_ATOL. (b) one NCCL rank on the (1, 1) mesh: LM_ARCH at full width
    and depth in bf16, [lm]'s seed and prompt (``lm["prompt"]``),
    prefill then LM_NEW greedy steps through the sharded path ("tp",
    twice; then "fsdp", once), each followed by the single-device run in
    the same process fed the same tokens: prefill and each step's logits
    within the bf16 TOLERANCES (``_held_bf16``), the margin reported,
    and whether they are bitwise; prefill ms, tokens/s, decode ms a step
    (median of steps 2..), peak memory, the draw's seconds and peak,
    collectives a step and host ms in them, beside the single-device
    run's and [lm]'s. The fsdp cases' seconds, the ranks' and the
    checks', are printed on a line of their own."""
    import statistics
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch import spawn_ranks
    from repro_torch.launch.mesh import SolverMesh
    from repro_torch.sharding import shard
    from repro_torch.sharding.state import cache_specs
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_dist_ranks as ranks_mod
    phase_t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()

    def worst_diff(got, want, atol, rtol, what):
        """The largest |got - want| and its share of the allowed band;
        raises past it."""
        want = np.asarray(want, np.float32)
        diff = np.abs(np.asarray(got, np.float32) - want)
        band = atol + rtol * np.abs(want)
        bad = int((diff > band).sum())
        check(np.isfinite(got).all() and bad == 0,
              f"[lm-serve-dist] {what}: {bad} values outside atol "
              f"{atol:.3g} rtol {rtol:.3g} (max abs diff "
              f"{float(diff.max()):.3e})")
        return float(diff.max()), float((diff / band).max())

    # -- (a) four gloo ranks sharing the card ------------------------------
    cases = _lm_serve_dist_cases()
    t0, spawned = time.perf_counter(), time.time()
    with tempfile.TemporaryDirectory() as tmp:
        got = spawn_ranks(ranks_mod.lm_serve_steps, LMS_RANKS,
                          backend="gloo",
                          args=(dict(device="cuda", seed=SEED,
                                     cases=cases),),
                          timeout_s=LMS_TIMEOUT_S, dir=tmp)
    ranks_s = time.perf_counter() - t0
    by_call = {"a": _summed_launches(got)}
    scan_launches = _rank_scan_launches("lm-serve-dist", got, cases, False)
    fsdp_s = {"ranks": 0.0, "held": 0.0}
    for case in cases:
        held_t0 = time.perf_counter()
        res = got[0][case["key"]]
        check(all(np.array_equal(r[case["key"]]["tokens"], res["tokens"])
                  and all(np.array_equal(a, b) for a, b in zip(
                      r[case["key"]]["logits"], res["logits"]))
                  for r in got[1:]),
              f"[lm-serve-dist] {case['key']}: the ranks disagree")
        want = ranks_mod.lm_serve_oracle(case, dev, SEED)
        err = max(worst_diff(g, w, LMS_ATOL, 0.0, f"{case['key']} step {i}")
                  [0] for i, (g, w) in enumerate(zip(res["logits"],
                                                     want["logits"])))
        check(np.array_equal(res["tokens"], want["tokens"]),
              f"[lm-serve-dist] {case['key']}: greedy tokens differ from "
              f"the single-device run")
        cfg = ranks_mod.lm_dist_cfg(case)
        shape, axes = case["mesh"]
        n = int(np.prod(shape))
        specs = [sp for st in cache_specs(
            cfg, case["batch"], case["cache_len"],
            SolverMesh(tuple(axes), tuple(shape), tuple(range(n)), 0))
            for sp in st]
        cerr = 0.0
        for rank, r in enumerate(got):
            mesh = SolverMesh(tuple(axes), tuple(shape), tuple(range(n)),
                              rank)
            for j, (leaf, full, sp) in enumerate(zip(
                    r[case["key"]]["cache"], want["cache"], specs)):
                cut = shard(torch.as_tensor(full), sp, mesh).numpy()
                check(leaf.shape == cut.shape, f"[lm-serve-dist] "
                      f"{case['key']} rank {rank} cache leaf {j}: shape "
                      f"{leaf.shape} against {cut.shape}")
                cerr = max(cerr, worst_diff(
                    leaf, cut, LMS_ATOL, 0.0,
                    f"{case['key']} rank {rank} cache leaf {j}")[0])
        say(f"[lm-serve-dist] (a) {case['key']} on 4 gloo ranks, (2, 2) "
            f"{case['layout']}{' fsdp' * case['fsdp']}, B={case['batch']} "
            f"prompt {case['prompt']}, {case['steps']} decode steps: logits max "
            f"abs diff {err:.3e}, cache max abs diff {cerr:.3e} (atol "
            f"{LMS_ATOL}), tokens equal; draw s {res['draw_s']:.2f}, "
            f"prefill ms {res['prefill_ms']:.1f}, decode ms "
            f"{[round(x, 1) for x in res['ms']]}, collectives a decode "
            f"step {res['calls'][-1]} ({res['bytes'][-1]} bytes, host ms "
            f"{res['coll_ms'][-1]:.1f}); ops {res['ops']}; seconds in the "
            f"ranks {max(r[case['key']]['case_s'] for r in got):.2f}")
        del want
        if case["layout"] == "fsdp":
            fsdp_s["ranks"] += max(r[case["key"]]["case_s"] for r in got)
            fsdp_s["held"] += time.perf_counter() - held_t0
    torch.cuda.empty_cache()
    say(f"[lm-serve-dist] (a) {len(cases)} cases held; ranks seconds="
        f"{ranks_s:.2f} (the spawn to the last rank's function "
        f"{max(r['entered'] for r in got) - spawned:.2f})")

    # -- (b) one NCCL rank, (1, 1), [lm]'s configuration ------------------
    case = dict(key="full", arch=LM_ARCH, reduced=False,
                mesh=[(1, 1), ("data", "model")], fsdp=False, layout="tp",
                batch=LM_BATCH, prompt=LM_PROMPT, steps=LM_NEW,
                cache_len=LM_PROMPT + LM_NEW, plain=True, no_cache=True,
                runs=2, inputs={"tokens": lm["prompt"]})
    fcase = dict(case, key="full fsdp", layout="fsdp", runs=1)
    t0, spawned = time.perf_counter(), time.time()
    with tempfile.TemporaryDirectory() as tmp:
        got = spawn_ranks(ranks_mod.lm_serve_steps, 1, backend="nccl",
                          args=(dict(device="cuda", seed=SEED,
                                     cases=[case, fcase]),),
                          timeout_s=LMS_TIMEOUT_S, dir=tmp)
    b_s = time.perf_counter() - t0
    by_call["b"] = _summed_launches(got)
    plain_b = _summed_launches(got, "oracle_launches")
    res = got[0]["full"]
    plain = res["plain"]
    check(res["repeat_equal"], "[lm-serve-dist] (b): the two sharded runs "
          "gave different tokens")
    errs, shares, agree = _held_bf16(res, plain, case, "(b)")
    med = statistics.median(res["ms"][2:])
    plain_med = statistics.median(plain["ms"][2:])
    coll_ms = statistics.median(res["coll_ms"][2:])
    calls = statistics.median(res["calls"][2:])
    say(f"[lm-serve-dist] (b) {LM_ARCH} full width and depth, bf16, 1 NCCL "
        f"rank on (1, 1) tp, [lm]'s seed and prompt (B={LM_BATCH} x "
        f"{LM_PROMPT}), {LM_NEW} greedy decode steps through the sharded "
        f"path; the single-device run after it in the same process, fed "
        f"its tokens: logits max abs diff prefill {errs[0]:.3e}, decode "
        f"{max(errs[1:]):.3e} (largest share of the bf16 band "
        f"{max(shares):.3f}: margin {1 - max(shares):.1%}); argmax equal "
        f"in {agree}/{res['tokens'].size}; bitwise {_bitwise(res, plain)};"
        f" the two sharded runs' tokens equal; first sequence "
        f"{res['tokens'][0].tolist()}")
    say(f"[lm-serve-dist] (b) sharded, the second of two runs (the first: "
        f"prefill ms {res['first']['prefill_ms']:.2f}, decode ms/step "
        f"{statistics.median(res['first']['ms'][2:]):.2f}): prefill ms="
        f"{res['prefill_ms']:.2f} "
        f"({LM_BATCH * LM_PROMPT / res['prefill_ms'] * 1e3:.0f} tokens/s), "
        f"decode ms/step (median of steps 2..)={med:.2f} (steps "
        f"{[round(x, 2) for x in res['ms']]}), peak allocated "
        f"{res['peak_gib']:.2f} GiB; the per-rank draw seconds="
        f"{res['draw_s']:.2f}, peak {res['draw_gib']:.2f} GiB; collectives "
        f"a decode step {calls:.0f} ({res['ops']} in all; "
        f"{res['bytes'][-1] / 2**30:.3f} GiB a step), host ms in them a "
        f"step {coll_ms:.2f} (each step "
        f"{[round(x, 2) for x in res['coll_ms']]})")
    plain_tps = LM_BATCH * LM_PROMPT / plain["prefill_ms"] * 1e3
    say(f"[lm-serve-dist] (b) single-device, same process, the second of "
        f"two runs: prefill ms={plain['prefill_ms']:.2f} ({plain_tps:.0f} "
        f"tokens/s), decode ms/step={plain_med:.2f} (steps "
        f"{[round(x, 2) for x in plain['ms']]}), peak allocated "
        f"{plain['peak_gib']:.2f} GiB; [lm]: prefill ms="
        f"{lm['prefill_ms']:.2f}, decode ms/step={lm['decode_ms']:.2f}, "
        f"peak {lm['peak_gib']:.2f} GiB; process seconds={b_s:.2f} (the "
        f"spawn to the rank's function {got[0]['entered'] - spawned:.2f})")
    fres = got[0]["full fsdp"]
    ferrs, fshares, fagree = _held_bf16(fres, fres["plain"], fcase,
                                        "(b) fsdp")
    say(f"[lm-serve-dist] (b) fsdp: the same configuration through the "
        f"sharded path under \"fsdp\" on (1, 1) (the rows over (\"data\", "
        f"\"model\"), every weight gathered at use), once, after the tp "
        f"runs; the single-device run after it, fed its tokens: logits max "
        f"abs diff prefill {ferrs[0]:.3e}, decode {max(ferrs[1:]):.3e} "
        f"(largest share of the bf16 band {max(fshares):.3f}); argmax "
        f"equal in {fagree}/{fres['tokens'].size}; bitwise "
        f"{_bitwise(fres, fres['plain'])}; tokens equal the tp run's "
        f"{bool(np.array_equal(fres['tokens'], res['tokens']))}")
    fmed = statistics.median(fres["ms"][2:])
    say(f"[lm-serve-dist] (b) fsdp against tp (a measurement, no claim): "
        f"prefill ms={fres['prefill_ms']:.2f} (tp {res['prefill_ms']:.2f}),"
        f" decode ms/step (median of steps 2..)={fmed:.2f} (tp {med:.2f}; "
        f"steps {[round(x, 2) for x in fres['ms']]}), collectives a decode "
        f"step {statistics.median(fres['calls'][2:]):.0f} (tp {calls:.0f};"
        f" {fres['bytes'][-1] / 2**30:.3f} GiB a step, tp "
        f"{res['bytes'][-1] / 2**30:.3f}), host ms in them a step "
        f"{statistics.median(fres['coll_ms'][2:]):.2f} (tp {coll_ms:.2f}), "
        f"peak allocated {fres['peak_gib']:.2f} GiB (tp "
        f"{res['peak_gib']:.2f})")
    say(f"[lm-serve-dist] fsdp additions seconds="
        f"{fsdp_s['ranks'] + fsdp_s['held'] + fres['case_s']:.2f} ((a) "
        f"{sum(c['layout'] == 'fsdp' for c in cases)} cases: in the ranks "
        f"{fsdp_s['ranks']:.2f}, held in this process {fsdp_s['held']:.2f};"
        f" (b) {fres['case_s']:.2f}, its single-device run included)")

    launches = {k: by_call["a"][k] + by_call["b"][k] for k in by_call["a"]}
    oracle = launch_counts()
    check(not any(launches.values()), f"[lm-serve-dist] the sharded serving "
          f"path launched slab kernels in its ranks: {by_call}")
    check(not any(oracle.values()) and not any(plain_b.values()),
          f"[lm-serve-dist] the single-device runs launched slab kernels: "
          f"the parent's oracle {oracle}, (b)'s in its rank {plain_b}")
    say(f"[lm-serve-dist] launches on the sharded path, the ranks' counts "
        f"summed: {launches} ((a) {by_call['a']}, (b) {by_call['b']}; no "
        f"Pallas kernel lies on the sharded serving path); the "
        f"single-device runs, apart: the parent's oracle {oracle}, (b)'s "
        f"in its rank {plain_b}; phase seconds="
        f"{time.perf_counter() - phase_t0:.2f}")
    return {"launches": launches, "scan_launches": scan_launches,
            "decode_ms": med, "coll_ms": coll_ms}


def _bitwise(res: dict, plain: dict) -> bool:
    """Whether a sharded run's logits at every step (prefill first) are
    the single-device run's, bitwise."""
    import numpy as np
    return len(res["logits"]) == len(plain["logits"]) and all(
        np.array_equal(g, w) for g, w in zip(res["logits"], plain["logits"]))


def _held_bf16(res: dict, plain: dict, case: dict, what: str):
    """A bf16 sharded serving run's logits (``res``) held step by step
    against the single-device run fed its tokens (``plain``), over the
    real vocab, within the bf16 TOLERANCES with atol scaled by the step's
    largest |logit| ([lm]'s decode check; ROADMAP C.9). Says every step's
    numbers, then raises if a logit lies past the band; returns (each
    step's max abs diff, each step's largest share of the band, the
    places where the argmaxes agree)."""
    import numpy as np
    from repro_torch.kernels.precision import TOLERANCES
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_dist_ranks as ranks_mod
    tol = TOLERANCES["bf16"]
    vocab = ranks_mod.lm_dist_cfg(case).vocab_size
    check(len(res["logits"]) == len(plain["logits"]),
          f"[lm-serve-dist] {what}: {len(res['logits'])} steps against "
          f"{len(plain['logits'])}")
    errs, shares, bad = [], [], []
    for g, w in zip(res["logits"], plain["logits"]):
        w = np.asarray(w[:, :vocab], np.float32)
        g = np.asarray(g[:, :vocab], np.float32)
        band = tol["atol"] * max(1.0, float(np.abs(w).max())) \
            + tol["rtol"] * np.abs(w)
        diff = np.abs(g - w)
        bad.append(int((diff > band).sum()) + int((~np.isfinite(g)).sum()))
        errs.append(float(diff.max()))
        shares.append(float((diff / band).max()))
    agree = int((res["tokens"] == plain["tokens"]).sum())
    say(f"[lm-serve-dist] {what} against the single-device run, each step "
        f"(prefill first): largest share of the bf16 band "
        f"{[round(x, 3) for x in shares]}; logits outside it {bad}; max "
        f"abs diff {[float(f'{x:.3e}') for x in errs]}; argmax equal in "
        f"{agree}/{res['tokens'].size}")
    check(not any(bad), f"[lm-serve-dist] {what}: {sum(bad)} logits outside "
          f"the bf16 band (steps {[i for i, n in enumerate(bad) if n]}; "
          f"largest share {max(shares):.3f})")
    return errs, shares, agree


def bf16_against_f32(runs: dict, truth: list, vocab: int) -> dict:
    """How far bf16 runs of one model lie from the f32 run of the same
    parameters, step by step (ROADMAP C.19's yardstick). ``runs``: name ->
    each step's logits (prefill first), ``truth``: the f32 run's, all fed
    the same tokens; over the first ``vocab`` columns. A step's band is
    the bf16 TOLERANCES around the f32 logits, atol scaled by the step's
    largest |logit| ([lm]'s decode check). Returns, per run: each step's
    largest share of its band, the logits past it (a value that is not
    finite counts) and the max abs diff. Two runs that each lie inside
    their band lie apart by at most the sum of the two bands (triangle
    inequality), so the pair of the first two runs needs no check of its
    own: "pair" holds its shares of that sum and its max abs diff, a
    measurement."""
    import numpy as np
    from repro_torch.kernels.precision import TOLERANCES
    tol = TOLERANCES["bf16"]
    names = list(runs)
    out = {k: {"shares": [], "outside": [], "max_abs": []} for k in names}
    out["pair"] = {"shares": [], "max_abs": []}
    for step, t in enumerate(truth):
        t = np.asarray(t[:, :vocab], np.float32)
        band = tol["atol"] * max(1.0, float(np.abs(t).max())) \
            + tol["rtol"] * np.abs(t)
        xs = {k: np.asarray(runs[k][step][:, :vocab], np.float32)
              for k in names}
        for k, x in xs.items():
            diff = np.abs(x - t)
            out[k]["shares"].append(float(np.nanmax(diff / band)))
            out[k]["outside"].append(int(((diff > band)
                                          | ~np.isfinite(x)).sum()))
            out[k]["max_abs"].append(float(np.nanmax(diff)))
        diff = np.abs(xs[names[0]] - xs[names[1]])
        out["pair"]["shares"].append(float(np.nanmax(diff / (2 * band))))
        out["pair"]["max_abs"].append(float(np.nanmax(diff)))
    return out


def _held_bf16_against_f32(res: dict, plain: dict, truth: dict, case: dict,
                           what: str) -> dict:
    """A bf16 sharded serving run (``res``) and the single-device bf16 run
    (``plain``) each held, step by step, inside the bf16 band around the
    f32 run of the same parameters (``truth``; all three fed the sharded
    run's tokens; ``bf16_against_f32``), which bounds the two apart by
    the sum of their bands. Says every step's numbers, the pair's too,
    then raises if a logit lies past its band; returns the numbers."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_dist_ranks as ranks_mod
    vocab = ranks_mod.lm_dist_cfg(case).vocab_size
    check(len(res["logits"]) == len(plain["logits"])
          == len(truth["logits"]),
          f"[lm-serve-dist] {what}: {len(res['logits'])}, "
          f"{len(plain['logits'])} and {len(truth['logits'])} steps")
    got = bf16_against_f32({"sharded": res["logits"],
                            "single-device": plain["logits"]},
                           truth["logits"], vocab)
    runs = {k: v for k, v in got.items() if k != "pair"}
    pair = got["pair"]
    say(f"[lm-serve-dist] {what} against the f32 run of the same "
        f"parameters, each step (prefill first): " + "; ".join(
            f"{name} largest share of the bf16 band "
            f"{[round(a, 3) for a in v['shares']]} (max "
            f"{max(v['shares']):.3f}, logits outside "
            f"{sum(v['outside'])}, max abs diff {max(v['max_abs']):.3e})"
            for name, v in runs.items())
        + f"; the pair apart by a largest share of the sum of the two "
        f"bands {[round(a, 3) for a in pair['shares']]} (max abs diff "
        f"{max(pair['max_abs']):.3e}; a measurement)")
    bad = {k: [i for i, n in enumerate(v["outside"]) if n]
           for k, v in runs.items()}
    check(not any(bad.values()),
          f"[lm-serve-dist] {what}: logits past the bf16 yardstick at "
          f"steps {bad} (largest shares "
          f"{ {k: round(max(v['shares']), 3) for k, v in runs.items()} })")
    return got


def _ptxas_resources(lines) -> dict:
    """{kernel (name<template ints>): its registers, stack frame, spill
    stores and loads and static shared memory in bytes} from a build's
    ``ptxas -v`` lines (``_build.Built.ptxas``), for the scan kernels and
    scan.cuh's second passes."""
    pat = re.compile(r"(wkv_fwd|wkv_bwd|ssm_fwd|ssm_bwd|sum_parts_tree)"
                     r"((?:I(?:Li\d+E)+E)?)")

    def short(mangled):
        m = pat.search(mangled)
        if m is None:
            return None
        ints = re.findall(r"Li(\d+)E", m.group(2))
        return m.group(1) + (f"<{','.join(ints)}>" if ints else "")

    out, entry, props = {}, None, None
    for line in lines:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = short(m.group(1))
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = short(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props:
            out.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(entry, {}).update(
                registers=int(m.group(1)),
                smem=int(smem.group(1)) if smem else 0)
            entry = None
    return out


def _scan_counts() -> dict:
    """The scan kernels' launches since their counts were set to 0, by
    name (ssm_scan_fwd, ssm_scan_bwd, wkv6_fwd, wkv6_bwd)."""
    from repro_torch.kernels.scan import ops as sops
    return {k.entry[:-len("_launch")]: k.launches for k in sops.KERNELS}


def _scan_checked(tag: str, arch: str, counts: dict, backward: bool):
    """Raises unless ``arch``'s scan kernel launched forward (and, with
    ``backward``, backward) in ``counts``."""
    fam = SCAN_ARCHS[arch]
    need = [f"{fam}_fwd"] + ([f"{fam}_bwd"] if backward else [])
    check(all(counts[k] > 0 for k in need), f"[{tag}] {arch}: the scan "
          f"kernels were not launched on its path: {counts}")
    return {k: counts[k] for k in need}


def _rank_scan_launches(tag: str, got: list, cases: list,
                        backward: bool) -> dict:
    """The scan kernels' launches in each jamba / rwkv6 case's sharded
    run, as spawned ``lm_dist_steps`` / ``lm_serve_steps`` ranks report
    them, summed over the ranks; raises unless the arch's kernel
    launched."""
    out = {}
    for case in cases:
        if case["arch"] in SCAN_ARCHS:
            per = [r[case["key"]]["scan_launches"] for r in got]
            out[case["key"]] = _scan_checked(
                tag, case["arch"], {k: sum(c[k] for c in per)
                                    for k in per[0]}, backward)
    say(f"[{tag}] (a) scan launches on the sharded path, the ranks' counts "
        f"summed: {out}")
    return out


def _named_leaves(tree, prefix=""):
    """(path, leaf) of each leaf of a parameter tree, in
    ``utils.tree.leaves``' order (dicts by sorted key, lists in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _named_leaves(t, f"{prefix}[{i}]")
    else:
        yield prefix, tree


@contextlib.contextmanager
def _plain_scans():
    """The LM layers' scans through the plain versions
    (``kernels.scan.ref.ssm_scan_plain`` / ``wkv6_plain``: PyTorch
    operations on the card, chunked remat under autograd) in place of
    the kernels, for holding a model's run through the kernels against
    the same run without them."""
    from repro_torch.kernels.scan import ref as sref
    from repro_torch.models import mamba as tmam
    from repro_torch.models import rwkv as trwkv
    saved = tmam.ssm_scan, trwkv.wkv6
    tmam.ssm_scan, trwkv.wkv6 = sref.ssm_scan_plain, sref.wkv6_plain
    try:
        yield
    finally:
        tmam.ssm_scan, trwkv.wkv6 = saved


def _lm_ssm_phase(dev, reset_counts) -> dict:
    """[lm-ssm]: the scan kernels (``csrc/ssm_scan.cu``, ``csrc/wkv6.cu``)
    at published widths, and the two recurrent archs through them.

    (a) each kernel against its plain version on the same inputs: the
    Mamba scan at jamba's widths (SSM_B x SSM_S, inner 16384, N 16) and
    the WKV recurrence at rwkv6-7b's (WKV_B x WKV_S, H = D = 64),
    forward (y, last state) against ``ssm_scan_plain`` / ``wkv6_plain``
    and backward (every gradient) against autograd through them, within
    the f32 TOLERANCES (atol scaled by the largest plain value); each
    timed (CUDA events), beside its plain version's time and its bound;
    the Mamba gradients at SSM_B x SSM_S also against the plain version
    in float64 (each the kernel's at most twice the f32 plain version's
    relative L2 distance); the WKV kernels also at (c)'s training shape
    and at one decode step of (b), the Mamba kernels at [lm]'s prefill
    LM_BATCH x LM_PROMPT and its decode step (held against the plain
    version and timed, a decode step by graph replay); the backwards'
    global workspaces held to 150 MiB (Mamba, SSM_B x SSM_S) and 128 MiB
    (WKV, WKV_B x WKV_S).
    (b) rwkv6-7b at published width and depth, bf16, random weights:
    prefill LM_BATCH x LM_PROMPT tokens, LM_NEW greedy decode steps; the
    same run through the plain scans on the card, and the same
    parameters in f32 through each, all fed its tokens: the f32 runs'
    logits within the bf16 band of each other at every step ([lm]'s
    decode check), the bf16 runs' distance from the f32 run (C.19's
    yardstick), the kernels' at most SSM_BF16_RATIO times the plain
    scans'.
    (c) rwkv6-7b at published widths cut to SSM_TRAIN_LAYERS layers (so
    that AdamW's state fits one card), remat "full": SSM_TRAIN_STEPS
    steps of SSM_TRAIN_B x SSM_TRAIN_S tokens in bf16 through the kernels
    (step ms, peak memory); then, with the parameters in f32, the loss and
    the gradient of every parameter of SSM_TRAIN_B x SSM_PAIR_S tokens
    through the kernels and through the plain scans in the same process:
    the loss within [lm-train]'s rtol, each leaf's gradient within
    SSM_GRAD_RTOL of the plain path's in relative L2 distance (ms and
    peak memory of each); and, each layer's WKV inputs and gradients
    recorded on both paths (``tools/wkv6_grad_accuracy.py``), each path's
    WKV gradients within SSM_OWN_RTOL of the plain recurrence in float64
    on its own inputs (ROADMAP C.22). (d) one jamba Mamba block at
    published widths (jamba whole is 398B parameters), forward and
    backward at SSM_B x SSM_S, through
    the kernels and through the chunked plain version: outputs and
    gradients within the bf16 band, peak memory of each. The kernels'
    counts are set to 0 before (b) and read after (d); launches made in
    (a) do not count."""
    import dataclasses
    import statistics
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import SyntheticPipeline
    from repro_torch.kernels.autotune import graph_ms
    from repro_torch.kernels.precision import TOLERANCES
    from repro_torch.kernels.scan import ops as sops
    from repro_torch.kernels.scan import ref as sref
    from repro_torch.models.mamba import mamba_forward, mamba_init
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.train import train_step as tts
    from repro_torch.train.serve_step import make_decode, make_prefill
    from repro_torch.utils.roofline import terms
    from repro_torch.utils.tree import leaves, map_tree
    phase_t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    tol32, tol16 = TOLERANCES["f32"], TOLERANCES["bf16"]

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    def once_ms(fn):
        """fn()'s result and its device ms, timed once."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    def event_ms(fn, iters):
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def held(got, want, what, tol):
        """got against want within ``tol``, atol scaled by max |want|;
        returns the max abs diff and its largest share of the band."""
        got, want = got.detach().float(), want.detach().float()
        top = float(want.abs().max())
        band = tol["atol"] * max(1.0, top) + tol["rtol"] * want.abs()
        diff = (got - want).abs()
        bad = int((diff > band).sum()) + int((~torch.isfinite(got)).sum())
        check(got.shape == want.shape and bad == 0,
              f"[lm-ssm] {what}: {bad} values outside the band (max abs "
              f"diff {float(diff.max()):.3e}, max |want| {top:.3e})")
        return float(diff.max()), float((diff / band).max())

    def bound(nbytes, flops, exps):
        """The least time: bytes at 3.35 TB/s, f32 operations at 67
        TFLOP/s (``utils.roofline.terms``), and the exps on the SFUs at
        the same clock."""
        t = terms(flops, nbytes, 0.0, 1, "f32")
        exp_s = exps / SFU_EXPS_PER_S
        ms = 1e3 * max(t.memory_s, t.compute_s, exp_s)
        return ms, ("bytes" if t.memory_s >= max(t.compute_s, exp_s)
                    else "operations")

    def peak_reset():
        # tensors held only by reference cycles would otherwise count in
        # the next peak
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2**30

    # -- (a) each kernel against its plain version at published widths ----
    jamba, rwkv = get_arch("jamba-1.5-large-398b"), get_arch("rwkv6-7b")
    inner, N = jamba.ssm_inner, jamba.ssm_state
    H, D = rwkv.rwkv_heads, rwkv.rwkv_head_dim
    f32 = dict(dtype=torch.float32, device=dev)

    def rand(*shape, lo=None, hi=None):
        if lo is None:
            return torch.randn(shape, generator=gen, **f32)
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    def draw(fam, B, S):
        """A kernel's inputs at B x S: jamba's or rwkv6-7b's widths."""
        if fam == "ssm_scan":
            return [rand(B, S, inner), rand(B, S, inner, lo=1e-3, hi=0.1),
                    rand(B, S, N), rand(B, S, N),
                    -torch.arange(1, N + 1, **f32).repeat(inner, 1),
                    torch.ones(inner, **f32), 0.1 * rand(B, inner, N)]
        return [rand(B, S, H, D), rand(B, S, H, D), rand(B, S, H, D),
                torch.exp(-torch.exp(rand(B, S, H, D, lo=-6.0, hi=0.0))),
                0.1 * rand(H, D), 0.1 * rand(B, H, D, D)]

    ssm_in, wkv_in = draw("ssm_scan", SSM_B, SSM_S), draw("wkv6", WKV_B, WKV_S)
    # Bytes: each input read and each output written once (the carries
    # too); operations: the f32 FLOPs the recurrence needs (an FMA is 2),
    # not the kernels' instruction mix. Mamba, a state-step: 6 forward
    # (dt A, dt u B, the update, the y term), 17 backward (the recompute
    # and the gradient terms), one exp each way. WKV, a state-step: 5
    # forward (r S and w S + k v; the bonus r (u k) v is O(D) a step,
    # 6 D counted), 14 backward (the recompute 3, dr 2, dS_prev 3, dk 2,
    # dv 2, dw 2; the sums with u and gy v O(D) a step, 12 D counted).

    def ssm_spec(B, S):
        """ssm_scan_fwd's and ssm_scan_bwd's (bytes, FLOPs, exps) at B x S."""
        n, state = B * S * inner * N, B * inner * N
        nc = sref.n_chunks(S)[1]
        return {
            "ssm_scan_fwd": (
                4 * (3 * B * S * inner + 2 * B * S * N + inner * N + inner
                     + (2 + nc) * state),
                6 * n, n),
            "ssm_scan_bwd": (
                4 * (5 * B * S * inner + 4 * B * S * N + 2 * inner * N
                     + 2 * inner + (2 + nc) * state),
                17 * n, n),
        }

    def wkv_spec(B, S):
        """wkv6_fwd's and wkv6_bwd's (bytes, FLOPs, exps) at B x S."""
        n, state = B * S * H * D * D, B * H * D * D
        nc = sref.n_chunks(S)[1]
        return {
            "wkv6_fwd": (
                4 * (5 * B * S * H * D + H * D + (2 + nc) * state),
                5 * n + 6 * B * S * H * D, 0),
            "wkv6_bwd": (
                4 * (9 * B * S * H * D + 2 * H * D + (2 + nc) * state),
                14 * n + 12 * B * S * H * D, 0),
        }

    def f64_yardstick(ins, gy, gl, grads, plain_grads, names):
        """Each Mamba gradient's relative L2 distance from the plain
        version run in float64 on the same inputs, the kernel's and the
        f32 plain version's; raises unless the kernel's is at most twice
        the plain's (its sums over n and over channels are reordered)."""
        live = [t.detach().double().requires_grad_() for t in ins]
        outs = sref.ssm_scan_plain(*live)
        torch.autograd.backward(outs, [gy.double(), gl.double()])
        dist = {}
        for n, g, p, w in zip(names, grads, plain_grads, live):
            den = w.grad.norm().clamp_min(1e-300)
            dist[f"d{n}"] = (float((g.double() - w.grad).norm() / den),
                             float((p.double() - w.grad).norm() / den))
        del live, outs
        bad = {k: v for k, v in dist.items() if not v[0] <= 2 * v[1]}
        check(not bad, f"[lm-ssm] (a) ssm_scan_bwd gradients farther from "
              f"float64 than twice the f32 plain version's (kernel, plain): "
              f"{bad}")
        say(f"[lm-ssm] (a) ssm_scan_bwd B={SSM_B} S={SSM_S}: each "
            f"gradient's relative L2 distance from the plain version in "
            f"float64 on the same inputs (kernel, f32 plain): "
            f"{ {k: (f'{a:.3e}', f'{b:.3e}') for k, (a, b) in dist.items()} }")
        return dist

    spec = {**ssm_spec(SSM_B, SSM_S), **wkv_spec(WKV_B, WKV_S)}
    launches = {"ssm_scan": (sops.launch_ssm_fwd, sops.launch_ssm_bwd),
                "wkv6": (sops.launch_wkv6_fwd, sops.launch_wkv6_bwd)}
    rows = {}
    for fam, ins, plain_fn, out_names, in_names in (
            ("ssm_scan", ssm_in, sref.ssm_scan_plain, ("y", "h"),
             "u dt B C A D h0".split()),
            ("wkv6", wkv_in, sref.wkv6_plain, ("y", "S"),
             "r k v w u S0".split())):
        fwd_launch, bwd_launch = launches[fam]
        kin = [t.contiguous() for t in ins]
        y, last, carries = fwd_launch(*kin)()
        # The plain versions (thousands of small operations, no first-call
        # cost of their own) are timed once, on the calls the checks make:
        # the forward without autograd, the backward through autograd
        # (which recomputes each chunk, as the kernel does).
        with torch.no_grad():
            want, plain_fwd_ms = once_ms(lambda: plain_fn(*kin))
        errs = [held(g, w, f"{fam}_fwd {n}", tol32)[0]
                for g, w, n in zip((y, last), want, out_names)]
        gy = torch.randn(y.shape, generator=gen, **f32)
        gl = torch.randn(last.shape, generator=gen, **f32)
        grads = bwd_launch(gy, gl, *kin[:-1], carries)()
        live = [t.detach().requires_grad_() for t in kin]
        outs = plain_fn(*live)
        _, plain_bwd_ms = once_ms(
            lambda: torch.autograd.backward(outs, [gy, gl]))
        berrs = [held(g, w.grad, f"{fam}_bwd d{n}", tol32)[0]
                 for g, w, n in zip(grads, live, in_names)]
        if fam == "ssm_scan":
            yardstick = f64_yardstick(kin, gy, gl, grads,
                                      [w.grad for w in live], in_names)
        del live, outs
        times = {
            f"{fam}_fwd": (event_ms(lambda: fwd_launch(*kin)(), 5),
                           plain_fwd_ms),
            f"{fam}_bwd": (event_ms(lambda: bwd_launch(
                gy, gl, *kin[:-1], carries)(), 3), plain_bwd_ms),
        }
        shape = (f"B={SSM_B} S={SSM_S} inner={inner} N={N} (jamba)"
                 if fam == "ssm_scan" else
                 f"B={WKV_B} S={WKV_S} H={H} D={D} (rwkv6-7b)")
        for name, err in ((f"{fam}_fwd", max(errs)),
                          (f"{fam}_bwd", max(berrs))):
            ms, plain_ms = times[name]
            b_ms, b_by = bound(*spec[name])
            rows[name] = {
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{fam}.cu",
                "replaces": ("src/repro/models/mamba.py:47"
                             if fam == "ssm_scan" else
                             "src/repro/models/rwkv.py:96"),
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "pass": True,
                "shape": f"{shape}, f32 (lax.scan; no Pallas kernel)"}
            say(f"[lm-ssm] (a) {name} {shape}: max_abs_err={err:.3e} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.2f} bound_ms="
                f"{b_ms:.5f} ({b_by}) bound_share={b_ms / ms:.4f}")
        del kin, y, last, carries, grads, want
    rows["ssm_scan_bwd"]["f64_distance"] = yardstick
    del ssm_in, wkv_in, gy, gl
    # The backwards' global workspaces: the Mamba kernel's per-CTA and
    # per-row partial sums (its recomputed states stay on the chip), the
    # WKV kernel's sub-chunk starts and du's per-row sums.
    ssm_ws = sops.ssm_bwd_workspace(SSM_B, SSM_S, inner, N)
    ssm_ws_bytes = sum(4 * int(np.prod(s)) for s in ssm_ws)
    check(ssm_ws_bytes <= 150 * 2**20, f"[lm-ssm] (a) the ssm_scan "
          f"backward's workspace is {ssm_ws_bytes / 2**20:.1f} MiB, past 150")
    say(f"[lm-ssm] (a) ssm_scan_bwd global workspace at B={SSM_B} "
        f"S={SSM_S}: {ssm_ws_bytes / 2**20:.2f} MiB (dB's and dC's per-CTA "
        f"partials {ssm_ws[0]} each, dA's and dD's per-row ones)")
    ws_bytes = sum(4 * int(np.prod(s)) for s in sops.wkv6_bwd_workspace(
        WKV_B, WKV_S, H, D))
    check(ws_bytes <= 128 * 2**20, f"[lm-ssm] (a) the wkv6 backward's "
          f"workspace is {ws_bytes / 2**20:.1f} MiB, past 128")
    say(f"[lm-ssm] (a) wkv6_bwd global workspace at B={WKV_B} S={WKV_S}: "
        f"{ws_bytes / 2**20:.2f} MiB (sub-chunk starts, "
        f"{sops.wkv6_bwd_workspace(WKV_B, WKV_S, H, D)[0]}) + du's "
        f"per-row sums")

    # wkv6 at (c)'s training shape and at one decode step of (b), the
    # Mamba scan at [lm]'s prefill and decode step (at jamba's widths):
    # each kernel held against the plain version on the same inputs (timed
    # once, as above; ~5 s at the training shape), kernel ms, bound and
    # share by the same formulas.
    for fam, B, S, tag in (
            ("wkv6", SSM_TRAIN_B, SSM_TRAIN_S, "(c)'s training shape"),
            ("wkv6", WKV_B, 1, "(b)'s decode step"),
            ("ssm_scan", LM_BATCH, LM_PROMPT, "[lm]'s prefill"),
            ("ssm_scan", LM_BATCH, 1, "[lm]'s decode step")):
        fwd_launch, bwd_launch = launches[fam]
        plain_fn = (sref.ssm_scan_plain if fam == "ssm_scan"
                    else sref.wkv6_plain)
        out_names, in_names = (("y h".split(), "u dt B C A D h0".split())
                               if fam == "ssm_scan" else
                               ("y S".split(), "r k v w u S0".split()))
        ins = draw(fam, B, S)
        y, last, carries = fwd_launch(*ins)()
        gy = torch.randn(y.shape, generator=gen, **f32)
        gl = torch.randn(last.shape, generator=gen, **f32)
        grads = bwd_launch(gy, gl, *ins[:-1], carries)()
        plain, err = {}, {}
        with torch.no_grad():
            want, plain[f"{fam}_fwd"] = once_ms(lambda: plain_fn(*ins))
        err[f"{fam}_fwd"] = max(
            held(g, w, f"{fam}_fwd {n} at B={B} S={S}", tol32)[0]
            for g, w, n in zip((y, last), want, out_names))
        live = [t.detach().requires_grad_() for t in ins]
        outs = plain_fn(*live)
        _, plain[f"{fam}_bwd"] = once_ms(
            lambda: torch.autograd.backward(outs, [gy, gl]))
        err[f"{fam}_bwd"] = max(
            held(g, w.grad, f"{fam}_bwd d{n} at B={B} S={S}", tol32)[0]
            for g, w, n in zip(grads, live, in_names))
        del live, outs, want
        # A decode step's launch is shorter than the host's cost of one:
        # its device time by graph replay (autotune.graph_ms).
        timer = ((lambda fn, n: graph_ms(fn, iters=20 * n)) if S == 1
                 else event_ms)
        times = {f"{fam}_fwd": timer(lambda: fwd_launch(*ins)(), 5),
                 f"{fam}_bwd": timer(lambda: bwd_launch(
                     gy, gl, *ins[:-1], carries)(), 3)}
        sp = ssm_spec(B, S) if fam == "ssm_scan" else wkv_spec(B, S)
        widths = (f"inner={inner} N={N}" if fam == "ssm_scan"
                  else f"H={H} D={D}")
        for name, ms in times.items():
            b_ms, b_by = bound(*sp[name])
            say(f"[lm-ssm] (a) {name} B={B} S={S} {widths} ({tag}): "
                f"max_abs_err={err[name]:.3e} kernel_ms={ms:.4f} plain_ms="
                f"{plain[name]:.2f} bound_ms={b_ms:.5f} ({b_by}) "
                f"bound_share={b_ms / ms:.4f}")
        del ins, y, last, carries, gy, gl, grads
    peak_reset()

    say(f"[lm-ssm] (a) seconds={time.perf_counter() - phase_t0:.2f}")

    # -- (b) rwkv6-7b served at published width and depth ----------------
    part_t0 = time.perf_counter()
    reset_counts()
    rng = np.random.default_rng(SEED + 31)
    prompt = torch.as_tensor(rng.integers(0, rwkv.vocab_size, (
        LM_BATCH, LM_PROMPT)).astype(np.int32), device=dev)

    def generate(cfg, params, forced=None):
        """Logits of the prefill's last position and of each decode step,
        the tokens, prefill ms, decode ms a step and wkv6 launches a
        decode step; ``forced``: feed these tokens in place of the greedy
        ones."""
        prefill, decode = make_prefill(cfg), make_decode(cfg)
        cache = init_cache(cfg, LM_BATCH, LM_PROMPT + LM_NEW, device=dev)
        t0 = sync()
        logits, cache = prefill(params, cache, {"tokens": prompt})
        out = [logits[:, -1].float()]
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        t1 = sync()
        n0 = sops.WKV_FWD.launches
        toks = [tok]
        for step in range(LM_NEW):
            if forced is not None:
                tok = forced[:, step:step + 1]
            logits, cache = decode(params, cache, tok)
            out.append(logits[:, -1].float())
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            toks.append(tok)
        t2 = sync()
        return (out, torch.cat(toks, dim=1), 1e3 * (t1 - t0),
                1e3 * (t2 - t1) / LM_NEW,
                (sops.WKV_FWD.launches - n0) / LM_NEW)

    # The served bf16 model through the kernels, then through the plain
    # scans fed its tokens; the same parameters in f32 both ways, fed the
    # same tokens. Random weights at this depth carry a perturbation of a
    # logit far (on an H100: the two f32 runs 0.0026 apart at max |logit|
    # 4.48, each bf16 run ~0.41 from them): the kernels are held against
    # the plain scans in f32, within the bf16 band, and the bf16 runs by
    # C.19's yardstick, each against the f32 run, the kernels' run no
    # further from it than SSM_BF16_RATIO x the plain run.
    runs = {}
    for dt in ("bf16", "f32"):
        cfg = (rwkv if dt == "bf16"
               else dataclasses.replace(rwkv, param_dtype="float32"))
        peak_reset()
        t0 = sync()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED), device=dev)
        init_s = sync() - t0
        if dt == "bf16":
            n_params = sum(p.numel() for p in params.parameters())
            logits, toks, pre_ms, dec_ms, per_step = generate(cfg, params)
            serve_gib, serve_init_s = peak_gib(), init_s
            check(per_step == rwkv.n_layers, f"[lm-ssm] (b) {per_step} "
                  f"wkv6 launches a decode step against {rwkv.n_layers} "
                  f"layers")
            runs["bf16 kernels"] = logits
        else:
            runs["f32 kernels"] = generate(cfg, params, forced=toks)[0]
        counts = _scan_counts()
        with _plain_scans():
            plain = generate(cfg, params, forced=toks)
        check(_scan_counts() == counts, "[lm-ssm] (b) the plain run "
              "launched scan kernels")
        runs[f"{dt} plain"] = plain[0]
        if dt == "bf16":
            plain_pre, plain_dec = plain[2], plain[3]
        del params, plain
    v = rwkv.vocab_size
    shares = [held(g[:, :v], w[:, :v], f"(b) f32 step {i} logits, kernels "
                   f"vs plain", tol16)[1] for i, (g, w) in enumerate(
                       zip(runs["f32 kernels"], runs["f32 plain"]))]
    far = {k: max(float((g[:, :v] - w[:, :v]).abs().max())
                  for g, w in zip(runs[k], runs["f32 plain"]))
           for k in ("bf16 kernels", "bf16 plain", "f32 kernels")}
    pair = max(float((g[:, :v] - w[:, :v]).abs().max())
               for g, w in zip(runs["bf16 kernels"], runs["bf16 plain"]))
    check(far["bf16 kernels"] <= SSM_BF16_RATIO * far["bf16 plain"],
          f"[lm-ssm] (b) the bf16 run through the kernels lies "
          f"{far['bf16 kernels']:.4f} from the f32 run, the plain scans' "
          f"{far['bf16 plain']:.4f}")
    top = max(float(x[:, :v].abs().max()) for x in runs["f32 plain"])
    say(f"[lm-ssm] (b) rwkv6-7b full width and depth bf16 ({n_params} "
        f"parameters, param_count {rwkv.param_count()}; init seconds="
        f"{serve_init_s:.2f}): prefill {LM_BATCH} x {LM_PROMPT} ms="
        f"{pre_ms:.2f}, decode {LM_NEW} steps ms/step={dec_ms:.2f}, wkv6 "
        f"launches a decode step {per_step:.0f}; peak allocated "
        f"{serve_gib:.2f} GiB; through the plain scans: prefill ms="
        f"{plain_pre:.2f}, decode ms/step={plain_dec:.2f}. f32 parameters, "
        f"kernels against plain, largest share of the bf16 band a step "
        f"(prefill first) {[round(s, 4) for s in shares]}; largest |diff| "
        f"from the f32 plain run over the steps (max |logit| {top:.3f}): "
        f"{ {k: round(x, 5) for k, x in far.items()} }; the two bf16 runs "
        f"apart by {pair:.5f}; seconds={time.perf_counter() - part_t0:.2f}")
    del runs, logits
    peak_reset()

    # -- (c) rwkv6-7b at published widths, SSM_TRAIN_LAYERS layers -------
    # bf16 (the arch's type) through the kernels: SSM_TRAIN_STEPS timed
    # steps. bf16 rounding moves this model's gradients far (on an H100
    # the grad norm parts by 1.3% between the two paths at step 0 in bf16,
    # by 1.3e-5 in f32), so the paths are held against each other in f32,
    # leaf by leaf: a wrong du or dw moves the global norm of ~28 by less
    # than a leaf of norm 0.003-0.45 would show.
    part_t0 = time.perf_counter()
    cfg4 = dataclasses.replace(rwkv, n_layers=SSM_TRAIN_LAYERS, remat="full")
    peak_reset()
    state = tts.init_train_state(cfg4, init_params(
        cfg4, torch.Generator(device=dev).manual_seed(SEED), device=dev))
    n4 = sum(t.numel() for t in leaves(state.params))
    pipe = SyntheticPipeline(cfg4, batch=SSM_TRAIN_B, seq_len=SSM_TRAIN_S,
                             seed=SEED, device=dev)
    step = tts.make_train_step(cfg4)
    metrics, secs = [], []
    for _ in range(SSM_TRAIN_STEPS):
        batch = pipe.next_batch()
        t0 = sync()
        state, m = step(state, batch)
        metrics.append({k: float(x) for k, x in m.items()})
        secs.append(sync() - t0)
    check(all(np.isfinite(x) for m in metrics for x in m.values()),
          f"[lm-ssm] (c) bf16: {metrics}")
    train_gib = peak_gib()
    del state, step, pipe

    cfg32 = dataclasses.replace(cfg4, param_dtype="float32")
    params32 = tts.init_train_state(cfg32, init_params(
        cfg32, torch.Generator(device=dev).manual_seed(SEED),
        device=dev)).params
    names = [n for n, _ in _named_leaves(params32)]
    batch = SyntheticPipeline(cfg32, batch=SSM_TRAIN_B, seq_len=SSM_PAIR_S,
                              seed=SEED, device=dev).next_batch()
    # Each layer's WKV inputs and the gradients that reach them are
    # recorded on both paths (tools/wkv6_grad_accuracy.py), for C.22's
    # check below; the peaks include the records (~1 GiB).
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import wkv6_grad_accuracy as wga
    from repro_torch.models import rwkv as trwkv
    pair, calls = {}, {}
    for path in ("kernels", "plain"):
        peak_reset()
        base = torch.cuda.memory_allocated(dev) / 2**30
        counts = _scan_counts()
        with (_plain_scans() if path == "plain"
              else contextlib.nullcontext()), \
                wga.recording(trwkv.wkv6, calls.setdefault(path, [])):
            live = map_tree(lambda t: t.detach().requires_grad_(True),
                            params32)
            t0 = sync()
            # the loss alone: its extras' graph would keep every
            # parameter alive after the pass
            loss = tts.loss_fn(live, cfg32, batch)[0]
            ts = leaves(live)
            gs = torch.autograd.grad(loss, ts, allow_unused=True)
            pair[path] = dict(
                loss=float(loss.detach()), secs=sync() - t0,
                gib=peak_gib(), base=base,
                grads=[torch.zeros_like(t) if g is None else g
                       for t, g in zip(ts, gs)])
        if path == "plain":
            check(_scan_counts() == counts, "[lm-ssm] (c) the plain path "
                  "launched scan kernels")
        del live, ts, gs, loss
    a, b = pair["kernels"]["loss"], pair["plain"]["loss"]
    check(abs(a - b) <= LMT_LOSS_RTOL * abs(b),
          f"[lm-ssm] (c) f32 loss {a} against the plain path's {b}")
    rel = {name: (float((g - w).norm() / w.norm().clamp_min(1e-30))
                  if bool(torch.isfinite(g).all()) else float("inf"))
           for name, g, w in zip(names, pair["kernels"]["grads"],
                                 pair["plain"]["grads"])}
    bad = {n: x for n, x in rel.items() if not x <= SSM_GRAD_RTOL}
    check(not bad, f"[lm-ssm] (c) f32 gradients through the kernels "
          f"past {SSM_GRAD_RTOL} of the plain path's (relative L2): {bad}")
    scan_leaves = {n: f"{x:.2e}" for n, x in rel.items()
                   if n.rsplit("/", 1)[-1].split("[")[0]
                   in ("u", "w_base", "w_lora_a", "w_lora_b")}
    worst = max(rel, key=rel.get)
    del pair["kernels"]["grads"], pair["plain"]["grads"], params32
    # C.22: each path's scan gradients (dr, dk, dv, dw, du of every layer)
    # against the plain recurrence in float64 on that path's own recorded
    # inputs; and the float64 gradients of the two paths' inputs apart,
    # which is what the pair check above reads.
    exact, own = {}, {}
    for path in ("kernels", "plain"):
        recs = [c for c in calls[path] if "gy" in c]
        check(len(recs) == SSM_TRAIN_LAYERS and all(
            set(c["grads"]) == set(wga.NAMES) for c in recs),
            f"[lm-ssm] (c) recorded {len(recs)} WKV calls with gradients on "
            f"the {path} path, {SSM_TRAIN_LAYERS} layers expected")
        exact[path] = [wga.exact_grads(c) for c in recs]
        own[path] = {n: max(wga.rel(c["grads"][n], e[n])
                            for c, e in zip(recs, exact[path]))
                     for n in wga.NAMES}
    apart = {n: max(wga.rel(k[n], q[n]) for k, q in zip(exact["kernels"],
                                                        exact["plain"]))
             for n in wga.NAMES}
    del calls, exact, recs
    bad = {p: {n: x for n, x in o.items() if not x <= SSM_OWN_RTOL}
           for p, o in own.items()}
    check(not any(bad.values()), f"[lm-ssm] (c) WKV gradients farther "
          f"than {SSM_OWN_RTOL} from float64 on their own inputs: {bad}")
    med = 1e3 * statistics.median(secs[1:])
    say(f"[lm-ssm] (c) rwkv6-7b published widths, {SSM_TRAIN_LAYERS} layers "
        f"({n4} parameters), AdamW, remat full, {SSM_TRAIN_B} x "
        f"{SSM_TRAIN_S} tokens a step. bf16 through the kernels, "
        f"{SSM_TRAIN_STEPS} steps: losses "
        f"{[round(m['loss'], 6) for m in metrics]}, grad norms "
        f"{[round(m['grad_norm'], 5) for m in metrics]}, step ms "
        f"(median of steps 2..) {med:.2f}, peak allocated {train_gib:.2f} "
        f"GiB. f32 loss and gradients of {SSM_TRAIN_B} x {SSM_PAIR_S} "
        f"tokens, kernels against plain: loss {a:.7f} against {b:.7f}; "
        f"{len(names)} leaves' gradients within {SSM_GRAD_RTOL} (relative "
        f"L2), the largest {rel[worst]:.3e} ({worst}); the WKV leaves' "
        f"{scan_leaves}; ms kernels={1e3 * pair['kernels']['secs']:.2f} "
        f"plain={1e3 * pair['plain']['secs']:.2f}; peak allocated "
        f"kernels={pair['kernels']['gib']:.2f} GiB plain="
        f"{pair['plain']['gib']:.2f} GiB (live before each: "
        f"{pair['kernels']['base']:.2f}, {pair['plain']['base']:.2f}: the "
        f"parameters, then the kernels' gradients too; both passes' ms "
        f"and peaks include C.22's records of the WKV inputs and "
        f"gradients, ~1 GiB of clones a path); seconds="
        f"{time.perf_counter() - part_t0:.2f}")
    def fmt(d):
        return {n: f"{x:.2e}" for n, x in d.items()}

    say(f"[lm-ssm] (c) C.22: each path's WKV gradients against the plain "
        f"recurrence in float64 on its own recorded inputs, the largest "
        f"over the {SSM_TRAIN_LAYERS} layers in relative L2 (limit "
        f"{SSM_OWN_RTOL}): kernels {fmt(own['kernels'])}, plain "
        f"{fmt(own['plain'])}; the float64 gradients of the two paths' "
        f"inputs apart by {fmt(apart)}. What the seed-{SEED} pair can show: "
        f"a missing or wrong gradient term (it moves a leaf by 1e-2 or "
        f"more); what it cannot: the scans' own rounding, which the "
        f"layers' conditioning hides under the distance between the two "
        f"paths' inputs (the u leaves read it), and the float64 check "
        f"holds instead")
    peak_reset()

    # -- (d) one jamba Mamba block at published widths --------------------
    part_t0 = time.perf_counter()
    p = mamba_init(torch.Generator(device=dev).manual_seed(SEED), jamba,
                   jamba.dtype)
    x0 = torch.randn((SSM_B, SSM_S, jamba.d_model), generator=gen,
                     device=dev).to(jamba.dtype)
    gy = torch.randn(x0.shape, generator=gen, device=dev).to(jamba.dtype)
    block = {}
    for path in ("kernels", "plain"):
        peak_reset()
        base = torch.cuda.memory_allocated(dev) / 2**30
        live = {k: t.detach().requires_grad_() for k, t in p.items()}
        x = x0.detach().requires_grad_()
        t0 = sync()
        with (_plain_scans() if path == "plain"
              else contextlib.nullcontext()):
            y, _ = mamba_forward(live, x, jamba)
            y.backward(gy)
        block[path] = dict(ms=1e3 * (sync() - t0), gib=peak_gib(),
                           base=base,
                           y=y.detach(), dx=x.grad, dA=live["A_log"].grad,
                           dD=live["D"].grad, counts=_scan_counts())
        del live, x, y
    check(block["plain"]["counts"] == block["kernels"]["counts"],
          "[lm-ssm] (d) the plain path launched scan kernels")
    errs = {k: held(block["kernels"][k], block["plain"][k], f"(d) {k}",
                    tol16)[1] for k in ("y", "dx", "dA", "dD")}
    n_block = sum(t.numel() for t in p.values())
    say(f"[lm-ssm] (d) one jamba Mamba block at published widths (d "
        f"{jamba.d_model}, inner {inner}, N {N}, dt_rank "
        f"{jamba.dt_rank_actual}; {n_block} parameters of jamba's "
        f"{jamba.param_count()}: the cut), bf16, B={SSM_B} S={SSM_S}, "
        f"forward + backward: peak allocated kernels="
        f"{block['kernels']['gib']:.2f} GiB plain (chunked)="
        f"{block['plain']['gib']:.2f} GiB (live before each: "
        f"{block['kernels']['base']:.2f}, {block['plain']['base']:.2f}); "
        f"ms kernels={block['kernels']['ms']:.1f} plain="
        f"{block['plain']['ms']:.1f}; "
        f"largest share of the bf16 band {errs}; seconds="
        f"{time.perf_counter() - part_t0:.2f}")
    del p, block
    peak_reset()

    counts = _scan_counts()
    for k in rows:
        rows[k]["launches"] = counts[k]
        check(counts[k] > 0, f"[lm-ssm] {k} launched no time on the path")
    say(f"[lm-ssm] launches on (b)-(d) {counts}; phase seconds="
        f"{time.perf_counter() - phase_t0:.2f}")
    return {"rows": rows, "launches": counts,
            "serve": {"prefill_ms": pre_ms, "decode_ms": dec_ms,
                      "gib": serve_gib},
            "train_ms": med}


@contextlib.contextmanager
def _dryrun_started(src: Path):
    """[dryrun]'s processes (``repro_torch.launch.dryrun``: rank 0 of the
    production mesh on meta tensors, no card), all started at once: each
    DRYRUN_CELLS cell through the CLI and the prediction of [lm-train]'s
    configuration. Yields {"dir": their output directory, "procs": {name:
    [the process, its stdout and stderr files, its start, its seconds
    once it has exited, the thread that waits for it and notes them]}};
    on exit kills any process still running."""
    import threading
    env = dict(os.environ, PYTHONPATH=str(src))
    with tempfile.TemporaryDirectory() as d:
        argvs = {c: ["-m", "repro_torch.launch.dryrun", "--arch", c[0],
                     "--shape", c[1], "--mesh", c[2], "--out", d]
                 for c in DRYRUN_CELLS}
        argvs["predict"] = ["-c", DRYRUN_PREDICT, LM_ARCH, str(LMT_BATCH),
                            str(LMT_SEQ)]
        procs = {}
        try:
            for n, (name, argv) in enumerate(argvs.items()):
                out = open(os.path.join(d, f"{n}.out"), "w+")
                err = open(os.path.join(d, f"{n}.err"), "w+")
                t0 = time.perf_counter()
                proc = subprocess.Popen([sys.executable, *argv], stdout=out,
                                        stderr=err, text=True, env=env)
                entry = procs[name] = [proc, out, err, t0, None, None]

                def note(entry=entry):
                    entry[0].wait()
                    entry[4] = time.perf_counter() - entry[3]
                entry[5] = threading.Thread(target=note, daemon=True)
                entry[5].start()
            yield {"dir": d, "procs": procs}
        finally:
            for proc, out, err, *_ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.close()
                err.close()


def _dryrun_phase(started: dict, lm_train: dict, lm_dist: dict) -> dict:
    """[dryrun]: the processes ``_dryrun_started`` began, read: each
    DRYRUN_CELLS cell (status "ok"; each record's peak a rank, dominant
    term and MFU fraction printed: these are predictions for 256 / 512
    H100 cards), and [lm-train]'s own configuration on the one-rank
    mesh, held against what the card measured there: the argument bytes
    exactly the live train state's plus a batch's; the predicted peak
    beside [lm-train]'s ``max_memory_allocated`` (the single-device step)
    and [lm-dist] (b)'s (the same sharded path on one NCCL rank), their
    ratios printed — a measurement, not a check. "phase seconds" is the
    wait here, after [lm-ssm]; each process's own seconds are printed."""
    phase_t0 = time.perf_counter()
    d, procs = started["dir"], started["procs"]

    def result(name):
        proc, out, err, t0, _, waiter = procs[name]
        waiter.join(max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        check(not waiter.is_alive(), f"[dryrun] {name}: still running "
              f"after {DRYRUN_TIMEOUT_S} s")
        out.seek(0)
        err.seek(0)
        return proc.returncode, out.read(), err.read(), procs[name][4]

    recs = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        rc, _, err, secs = result((arch, shape, mesh))
        check(rc == 0, f"[dryrun] {arch} {shape} {mesh}: exited {rc}: "
              f"{err[-2000:]}")
        with open(os.path.join(d, f"{arch}__{shape}__{mesh}.json")) as f:
            rec = json.load(f)
        recs[(arch, shape, mesh)] = rec
        check(rec["status"] == "ok", f"[dryrun] {arch} {shape} {mesh}: "
              f"{rec['status']} {rec.get('error', '')}")
        m, r = rec["memory"], rec["roofline"]
        say(f"[dryrun] {arch} {shape} {rec['mesh']} (prediction for "
            f"{r['chips']} H100 cards, not a measurement): peak a rank "
            f"{m['peak_bytes_per_device'] / 1e9:.2f} GB (arguments "
            f"{m['argument_bytes_per_device'] / 1e9:.2f}, temp "
            f"{m['temp_bytes_per_device'] / 1e9:.2f}), fits 80 GB "
            f"{m['fits_80gb_hbm']}; dominant {r['dominant']} (compute "
            f"{r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, "
            f"collective {r['collective_s']:.4g} s), useful FLOPs ratio "
            f"{rec['analytic']['useful_flops_ratio']:.4f}, MFU fraction "
            f"{r['mfu_fraction']:.4f}; {rec['ops']} operations counted "
            f"in {rec['lower_s']} s; process seconds={secs:.2f}")
    rc, stdout, err, secs = result("predict")
    check(rc == 0, f"[dryrun] the prediction of [lm-train] exited {rc}: "
          f"{err[-2000:]}")
    pred = json.loads(stdout.strip().splitlines()[-1])["memory"]
    want = lm_train["state_bytes"] + lm_train["batch_bytes"]
    check(pred["argument_bytes_per_device"] == want,
          f"[dryrun] [lm-train]'s argument bytes: predicted "
          f"{pred['argument_bytes_per_device']}, the live state and batch "
          f"{want}")
    peak = pred["peak_bytes_per_device"] / 2**30
    say(f"[dryrun] [lm-train]'s configuration ({LM_ARCH}, bf16, AdamW, "
        f"remat full, B={LMT_BATCH} x S={LMT_SEQ}, one microbatch) on the "
        f"one-rank mesh: argument bytes {pred['argument_bytes_per_device']}"
        f" predicted = {lm_train['state_bytes']} of live train state + "
        f"{lm_train['batch_bytes']} of batch on the card (exact); peak "
        f"predicted {peak:.2f} GiB (temp "
        f"{pred['temp_bytes_per_device'] / 2**30:.2f}) against "
        f"max_memory_allocated {lm_train['peak_gib']:.2f} GiB in [lm-train] "
        f"(the single-device step: measured / predicted "
        f"{lm_train['peak_gib'] / peak:.3f}) and {lm_dist['peak_gib']:.2f} "
        f"GiB in [lm-dist] (b) (this path on one NCCL rank: "
        f"{lm_dist['peak_gib'] / peak:.3f}); process seconds={secs:.2f}; "
        f"phase seconds={time.perf_counter() - phase_t0:.2f}")
    return recs


def _examples_phase(dev, reset_counts, fupdate_classes,
                    hold_fupdate_at) -> dict:
    """[examples]: ``examples/torch_quickstart.py``,
    ``torch_serve_ocssvm.py`` and ``torch_lm_anomaly.py`` — their
    ``main()`` on the card, each with the kernels' counts set to 0 just
    before and read just after: quickstart's blocked fit and
    serve_ocssvm's fit launch ``fupdate`` (the fused provider), its
    scoring ``decision``; lm_anomaly's head takes on-the-fly rows
    (no launch). A fit's f-cache is checked by nothing but itself, so
    ``fupdate`` is then held against its plain version at each fit's own
    shapes (``hold_fupdate_at``): the example's rows (make_toy(0, m),
    d = 2), S = 2P for the narrow hot loop and S = m for the wide init
    pass (m <= BLOCK). serve_ocssvm holds ``decision`` itself. Prints
    their numbers; returns each one's launches and, for the fits,
    fupdate's max abs err by class."""
    import importlib.util
    import inspect
    import numpy as np
    import torch
    from repro_torch.data import make_toy
    from repro_torch.kernels.decision import ops as dec
    root = Path(__file__).resolve().parent / "examples"
    phase_t0 = time.perf_counter()
    launches = {}
    for name in ("torch_quickstart", "torch_serve_ocssvm",
                 "torch_lm_anomaly"):
        spec = importlib.util.spec_from_file_location(name,
                                                      root / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        reset_counts()
        t0 = time.perf_counter()
        got = mod.main(device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[name] = {"fupdate": fupdate_classes(),
                          "decision": dec.DECISION.launches}
        if name != "torch_lm_anomaly":
            # Both fits run the fused provider with P = 16 (this
            # script's P): the hot loop's S = 2P, the init pass's S = m.
            m = inspect.signature(mod.main).parameters["m"].default
            x_ex = make_toy(0, m)[0]
            check(all(launches[name]["fupdate"].values()),
                  f"[examples] {name}: fupdate launches "
                  f"{launches[name]['fupdate']}, a class never ran")
            launches[name]["fupdate_max_abs"] = {
                c: hold_fupdate_at(x_ex, s, mod.SPEC.kernel,
                                   f"[examples] {name} fupdate {c} m={m} "
                                   f"S={s} d={x_ex.shape[1]}")
                for c, s in (("narrow", 2 * P), ("wide", m))}
        if name == "torch_quickstart":
            check(got["paper_converged"] and got["blocked_converged"]
                  and np.isfinite(got["scores"]).all(),
                  f"[examples] {name}: {got}")
            nums = (f"paper iters={got['paper_iters']} MCC="
                    f"{got['paper_mcc']:.3f}; blocked iters="
                    f"{got['blocked_iters']} MCC={got['blocked_mcc']:.3f}; "
                    f"held-out accuracy={got['heldout_accuracy']:.3f}")
        elif name == "torch_serve_ocssvm":
            b = got["batches"]
            check(got["hit"] and all(np.isfinite(v["scores"]).all()
                                     for v in b.values()),
                  f"[examples] {name}: cache hit {got['hit']}")
            ms = {k: round(v["ms"], 3) for k, v in b.items()}
            acc = {k: round(v["acc"], 3) for k, v in b.items()}
            nums = (f"{got['n_sv']} SVs, fit iters={got['fit_iters']}, "
                    f"cold fit+pack ms={got['cold_ms']:.1f}, batch ms {ms}, "
                    f"accuracy {acc}, micro-batch launches="
                    f"{got['microbatch']['launches']}")
            check(launches[name]["decision"] > 0,
                  f"[examples] {name}: launches {launches[name]}")
        else:
            check(got["head_converged"] and np.isfinite(got["losses"]).all()
                  and got["losses"][-1] < got["losses"][0],
                  f"[examples] {name}: losses {got['losses'][:3]}..., head "
                  f"converged {got['head_converged']}")
            nums = (f"loss {got['losses'][0]:.4f} -> {got['losses'][-1]:.4f}"
                    f" in {len(got['losses'])} steps, head iters="
                    f"{got['head_iters']}, AUC={got['auc']:.4f}")
        say(f"[examples] {name}: {nums}; launches and fupdate max abs err "
            f"{launches[name]}; "
            f"seconds={secs:.2f}")
    say(f"[examples] phase seconds={time.perf_counter() - phase_t0:.2f}")
    return launches


def _summed_launches(got, key: str = "launches") -> dict:
    """The slab kernels' launches that spawned ``lm_dist_steps`` /
    ``lm_serve_steps`` ranks report under ``key`` ("launches": the
    sharded path's; "oracle_launches": the single-device runs' in the
    ranks), summed over the ranks."""
    return {k: sum(r[key][k] for r in got) for k in got[0][key]}


def _served(sm) -> dict:
    """A served model's compacted parts, for rank processes to repack."""
    return {"gamma": sm.model.gamma.cpu().numpy(),
            "X": sm.model.X.cpu().numpy(), "rho1": float(sm.model.rho1),
            "rho2": float(sm.model.rho2), "tn": sm.tn}


def _port_on_path() -> Optional[Path]:
    """The port's ``src/`` beside this file, put on the path, when a card
    is there and the sources are; else None, saying why on stderr."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return None
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not at {src}",
              file=sys.stderr)
        return None
    sys.path.insert(0, str(src))
    return src


def _say_cards_and_result() -> None:
    """The cards' names and power limits as nvidia-smi gives them, then
    the result line."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        say(line)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def cards_main(cards: int) -> int:
    """``chip_smoke.py --cards N``: [dist] alone over N NCCL ranks, one
    card each — the cross-card path a one-card run cannot reach — held
    against single-device fits of the same rows on the first card (the
    [main], [shrink] and [warm] solves, at their sizes). Prints the [dist]
    lines, the launches as JSON, the cards and the result line."""
    if _port_on_path() is None:
        return 1
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.api import resolve_device
    from repro_torch.core import SlabSpec, rbf
    from repro_torch.core.engine import artifact_from_result
    from repro_torch.data import make_toy
    from repro_torch.kernels import _build
    check(torch.cuda.device_count() >= cards,
          f"--cards {cards}: {torch.cuda.device_count()} card(s) here")
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    _build.build()
    say(f"[build] seconds={time.perf_counter() - t0:.2f}")
    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=rbf(RBF_GAMMA))
    X_np = make_toy(SEED, M, d=D)[0]
    fits = {p_: repro_torch.fit(X_np, spec, strategy="auto", P=P, tol=TOL,
                                precision=p_) for p_ in ("f32", "bf16")}
    sm = repro_torch.serve(X_np, spec, offsets="quantile", P=P, tol=TOL)
    X_shr = make_toy(SEED, SHRINK_M, d=D)[0]
    shrink = repro_torch.fit(X_shr, spec, P=P, tol=TOL)
    n_delta = M * 5 // 100
    X_new = np.concatenate([X_np[n_delta:],
                            make_toy(SEED + 7, n_delta, d=D)[0]])
    warm = repro_torch.fit_update(artifact_from_result(fits["f32"]), X_new,
                                  tol=TOL)
    torch.cuda.synchronize()
    jobs = {"nccl": (cards, dict(precisions=("f32", "bf16"), full=True,
                                 requests=DIST_REQUESTS, served=_served(sm),
                                 cards=cards))}
    fup_l, dec_l = _dist_phase(jobs, dict(
        dev=dev, spec=spec, sm=sm, X=X_np, X_shr=X_shr, X_new=X_new,
        main=fits, shrink=shrink, warm=warm))
    _lm_dist_cards(cards)
    _lm_serve_dist_cards(cards)
    say(json.dumps({"dist_launches": {"fupdate": fup_l, "decision": dec_l}}))
    _say_cards_and_result()
    return 0


def _lm_dist_cards(cards: int) -> None:
    """[lm-dist] (c): LM_ARCH at full width and depth in bf16 (AdamW,
    remat "full") on a (2, cards / 2) mesh of NCCL ranks, one card each,
    "tp" (fsdp off below 4e9 parameters, as the JAX launcher has it),
    LMD_CARDS_STEPS steps of LMT_BATCH x LMT_SEQ tokens: the ranks agree,
    the losses are finite; step ms, tokens/s, peak memory a rank and host
    ms in collectives."""
    import statistics
    import tempfile
    import numpy as np
    from repro_torch.launch import spawn_ranks
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_dist_ranks as ranks_mod
    check(cards % 2 == 0, f"--cards {cards}: [lm-dist] needs an even count")
    case = dict(key="full", arch=LM_ARCH, reduced=False,
                mesh=[(2, cards // 2), ("data", "model")], layout="tp",
                fsdp=False, steps=LMD_CARDS_STEPS, batch=LMT_BATCH,
                seq=LMT_SEQ)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        got = spawn_ranks(ranks_mod.lm_dist_steps, cards, backend="nccl",
                          args=(dict(device="cuda", seed=SEED, cases=[case],
                                     card_per_rank=True),),
                          timeout_s=LMD_TIMEOUT_S, dir=tmp)
    res = got[0]["full"]
    check(all(r["full"]["metrics"] == res["metrics"] for r in got[1:])
          and all(np.isfinite(v) for m in res["metrics"] for v in m.values()),
          f"[lm-dist] (c): {[r['full']['metrics'] for r in got]}")
    launches = _summed_launches(got)
    check(not any(launches.values()), f"[lm-dist] (c): the ranks launched "
          f"slab kernels: {launches}")
    med = statistics.median(res["ms"][1:])
    coll_ms = statistics.median(res["collective_ms"][1:])
    say(f"[lm-dist] (c) {LM_ARCH} full width and depth, bf16, {cards} NCCL "
        f"ranks on (2, {cards // 2}) tp: losses "
        f"{[round(m['loss'], 6) for m in res['metrics']]}; median step of "
        f"steps 1..{LMD_CARDS_STEPS - 1} ms={med:.2f} (steps ms "
        f"{[round(x, 2) for x in res['ms']]}), tokens/s="
        f"{LMT_BATCH * LMT_SEQ / med * 1e3:.0f}, peak allocated a rank "
        f"{max(r['full']['peak_gib'] for r in got):.2f} GiB, collectives a "
        f"step {res['collective_calls']}, host ms in them a step (median "
        f"of steps 1..) {coll_ms:.2f} (each step "
        f"{[round(x, 2) for x in res['collective_ms']]}); seconds="
        f"{time.perf_counter() - t0:.2f}")


def _lm_serve_dist_cards(cards: int) -> None:
    """[lm-serve-dist] (c): (b)'s configuration (LM_ARCH at full width and
    depth, bf16, [lm]'s batch and lengths) on a (2, cards / 2) mesh of
    NCCL ranks, one card each, the cache sharded by the cache rules
    (positions over "model", rows over "data"), under "tp" and then
    under "fsdp" (the rows over ("data", "model"), each mixer on the
    cache's rows): for each, the ranks agree, and the first rank's
    single-device run on its card after it (same parameters and prompt,
    fed the sharded run's tokens) and the f32 run of the same parameters:
    each bf16 run's prefill and decode logits within the bf16 band
    around the f32 run's (``_held_bf16_against_f32``, ROADMAP C.19),
    the margin and how far apart the two bf16 runs lie reported; prefill
    ms, decode ms a step, peak memory a rank and host ms in
    collectives."""
    import statistics
    import tempfile
    import numpy as np
    from repro_torch.launch import spawn_ranks
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_dist_ranks as ranks_mod
    check(cards % 2 == 0, f"--cards {cards}: [lm-serve-dist] needs an even "
          f"count")
    base = dict(arch=LM_ARCH, reduced=False,
                mesh=[(2, cards // 2), ("data", "model")], fsdp=False,
                batch=LM_BATCH, prompt=LM_PROMPT, steps=LM_NEW,
                cache_len=LM_PROMPT + LM_NEW, no_cache=True, runs=2,
                plain=True, truth=True)
    cases = [dict(base, key="full", layout="tp"),
             dict(base, key="full fsdp", layout="fsdp")]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        got = spawn_ranks(ranks_mod.lm_serve_steps, cards, backend="nccl",
                          args=(dict(device="cuda", seed=SEED, cases=cases,
                                     card_per_rank=True),),
                          timeout_s=LMS_TIMEOUT_S, dir=tmp)
    launches = _summed_launches(got)
    plain_c = _summed_launches(got, "oracle_launches")
    check(not any(launches.values()) and not any(plain_c.values()),
          f"[lm-serve-dist] (c): slab kernels launched: the ranks' sharded "
          f"path {launches}, the single-device runs {plain_c}")
    for case in cases:
        key, layout = case["key"], case["layout"]
        res = got[0][key]
        check(all(np.array_equal(r[key]["tokens"], res["tokens"])
                  and r[key]["repeat_equal"] for r in got)
              and all(np.isfinite(x).all() for x in res["logits"]),
              f"[lm-serve-dist] (c) {layout}: the ranks disagree or the "
              f"logits are not finite")
        med = statistics.median(res["ms"][2:])
        say(f"[lm-serve-dist] (c) {LM_ARCH} full width and depth, bf16, "
            f"{cards} NCCL ranks on (2, {cards // 2}) {layout}, B={LM_BATCH}"
            f" x {LM_PROMPT}, {LM_NEW} steps, the second of two runs (the "
            f"same tokens): prefill ms={res['prefill_ms']:.2f}, "
            f"decode ms/step (median of steps 2..)={med:.2f} (steps "
            f"{[round(x, 2) for x in res['ms']]}), peak allocated a rank "
            f"{max(r[key]['peak_gib'] for r in got):.2f} GiB, collectives "
            f"a step {res['calls'][-1]} ({res['bytes'][-1] / 2**20:.2f} "
            f"MiB), host ms in them a step "
            f"{statistics.median(res['coll_ms'][2:]):.2f}; first sequence "
            f"{res['tokens'][0].tolist()}; seconds in the ranks="
            f"{max(r[key]['case_s'] for r in got):.2f}")
        held = _held_bf16_against_f32(res, res["plain"], res["truth"], case,
                                      f"(c) {layout}")
        agree = int((res["tokens"] == res["plain"]["tokens"]).sum())
        pair = held["pair"]
        worst = max(max(held[k]["shares"])
                    for k in ("sharded", "single-device"))
        say(f"[lm-serve-dist] (c) {layout} held against the f32 run on card "
            f"0, with the single-device bf16 run, fed the sharded run's "
            f"tokens: largest share of the bf16 band {worst:.3f} (margin "
            f"{1 - worst:.1%}); the two bf16 runs apart by at most "
            f"{max(pair['shares']):.3f} of the sum of their bands (max abs "
            f"diff prefill {pair['max_abs'][0]:.3e}, decode "
            f"{max(pair['max_abs'][1:]):.3e}); argmax equal in "
            f"{agree}/{res['tokens'].size}")
    say(f"[lm-serve-dist] (c) seconds={time.perf_counter() - t0:.2f}")


def main() -> int:
    src = _port_on_path()
    if src is None:
        return 1
    import torch

    import numpy as np
    import repro_torch
    from repro_torch.core import SlabSpec, linear, poly, rbf
    from repro_torch.data import make_toy
    from repro_torch.kernels import _build
    from repro_torch.kernels.decision import ops as dec
    from repro_torch.kernels.decision.ref import decision_plain
    from repro_torch.kernels import autotune, tiling
    from repro_torch.kernels.fupdate import ops as fup
    from repro_torch.kernels.fupdate.ref import fupdate_plain
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram.ref import gram_plain
    from repro_torch.kernels.scan import ops as scan_ops
    from repro_torch.kernels.precision import (PRECISIONS, TOLERANCES,
                                               truth_tolerance)
    from repro_torch.utils.roofline import terms
    from repro_torch.serve import BUCKETS, pack_model
    from repro_torch.api import resolve_device
    from repro_torch.core.ocssvm import OCSSVMModel
    from repro_torch.configs.ocssvm_paper import PAPER_SPEC, TABLE1_SIZES

    dev = resolve_device("cuda")   # also switches TF32 off
    torch.manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    say(f"[build] {len(built)} sources in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k}: {v.seconds:.2f} s' for k, v in built.items())})")
    # The scan kernels' resources by kernel name (the backwards' shared
    # memory is dynamic, ``wkv6_bwd_smem_bytes`` / ``ssm_scan_bwd_smem_
    # bytes``, beside ptxas's static bytes); the other sources' ptxas lines
    # as they are.
    for name, b in built.items():
        if name in ("ssm_scan", "wkv6"):
            if b.ptxas:
                say(f"[build] {name} kernels (ptxas): "
                    f"{_ptxas_resources(b.ptxas)}")
            continue
        for line in b.ptxas:
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"[build] {name}: {line}")
    scan_ops.WKV_BWD.load()
    smem = scan_ops.WKV_BWD._lib.wkv6_bwd_smem_bytes
    say(f"[build] wkv_bwd dynamic shared memory bytes by D: "
        f"{ {D: smem(D) for D in scan_ops.WKV_HEAD_DIMS} }")
    scan_ops.SSM_BWD.load()
    smem = scan_ops.SSM_BWD._lib.ssm_scan_bwd_smem_bytes
    say(f"[build] ssm_bwd dynamic shared memory bytes by N at a chunk of "
        f"{scan_ops.CHUNK} steps: "
        f"{ {N: smem(N, scan_ops.CHUNK) for N in scan_ops.SSM_STATES} }")
    # The autotuner's feasibility model estimates registers from TR x TC;
    # ptxas says what each instantiation takes.
    regs = {}
    for name, b in built.items():      # the split kernels name no family
        regs.update(autotune.ptxas_registers(b.ptxas, name))
    if regs:            # the sources built here (a reused one prints none)
        n_inst = sum(len(tiling.precisions_of(f, tiling.config_of(e)))
                     for f, menu in tiling.MENUS.items() for e in menu
                     if built[f].ptxas)
        check(len(regs) == n_inst, f"ptxas named {len(regs)} kernel "
              f"instantiations, the menus {n_inst}")
        est = {k: autotune.register_estimate(k[0], tiling.config_of(k[2]))
               for k in regs}
        low = [(k, used, est[k]) for k, used in sorted(regs.items())
               if used > est[k]]
        say(f"[build] registers of {len(regs)} instantiations: "
            f"{min(regs.values())}-{max(regs.values())}; estimate below "
            f"ptxas for {len(low)}: {low}")
    else:
        say("[build] libraries reused: no ptxas lines to check")

    # -- 2. kernels against their plain versions ---------------------------
    # Check data: rbf on the main path's toy rows at its width; linear and
    # poly on the same rows scaled to unit length. On raw toy rows an
    # anomaly's linear or poly value is up to 1e4 times a target row's, and
    # a tolerance scaled by the largest output would not see an error on a
    # target row. Steps, weights and offsets are drawn so that what each
    # kernel adds is O(1) on most rows (see fupdate_operands and
    # support_model), and `hold` fails a cell whose tolerance is more than
    # 1% of the median of that work.
    X_np, _ = make_toy(SEED, M, d=D)
    unit = X_np / np.linalg.norm(X_np, axis=1, keepdims=True)
    rows = {"rbf": X_np, "linear": unit, "poly": unit}
    kernels = {"rbf": rbf(RBF_GAMMA), "linear": linear(),
               "poly": poly(gamma=1.0, coef0=1.0, degree=3)}

    def plain_kw(kind):
        k = kernels[kind]
        return dict(kind=kind, gamma=k.gamma, coef0=k.coef0, degree=k.degree)

    def hold(out, plain, work, what):
        """out against plain at the f32 tolerance of TOLERANCES, atol
        scaled by max |plain| as truth_tolerance scales it (both see the
        same operands, so only the summation order differs), a tolerance
        that must be at most 1% of the median |work|. On the card: the
        full-width gram matrices are 67M values. Returns (max abs err,
        max rel err, tolerance, tolerance / median |work|)."""
        out, plain, work = (a.float() for a in (out, plain, work))
        check(out.shape == plain.shape, f"{what}: shape {tuple(out.shape)}"
              f" against {tuple(plain.shape)}")
        check(bool(torch.isfinite(out).all()),
              f"{what}: non-finite kernel output")
        top = float(plain.abs().max())
        tol = dict(rtol=TOLERANCES["f32"]["rtol"],
                   atol=TOLERANCES["f32"]["atol"] * max(1.0, top))
        share = tol["atol"] / float(work.abs().median())
        check(share <= 1e-2, f"{what}: tolerance {tol} is {share:.3g} of "
              f"the median work of the kernel; the check would be blind")
        diff = (out - plain).abs()
        bad = int((diff > tol["atol"] + tol["rtol"] * plain.abs()).sum())
        err = float(diff.max())
        check(bad == 0, f"{what}: {bad} values outside {tol} "
              f"(max abs err {err:.3e})")
        return err, err / top, tol, share

    def fupdate_operands(kind, m, s, precision):
        """Prepared operands: s of the first m check rows at random, f
        uniform in [-1, 1], and a step scaled so that the largest update
        |k(x, xsel) @ delta| is 1."""
        x = torch.as_tensor(rows[kind][:m], device=dev)
        xsel = x[torch.as_tensor(rng.choice(m, s, replace=False),
                                 device=dev)]
        f = torch.as_tensor(rng.uniform(-1, 1, m).astype(np.float32),
                            device=dev)
        delta = torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                                device=dev)
        ops = fup.prepare(x, xsel, delta, torch.zeros_like(f),
                          precision=precision)
        step = fupdate_plain(*ops, **plain_kw(kind)).abs().max()
        return fup.prepare(x, xsel, delta / step, f, precision=precision)

    example_rng = np.random.default_rng(SEED + 1)

    def hold_fupdate_at(x_np, s, kern, what):
        """fupdate on the card at a path's own operands, in f32: the rows
        x_np (m, d) as the path gives them, s of them at random, f uniform
        in [-1, 1] and a step scaled as in fupdate_operands, held against
        fupdate_plain by ``hold`` (its worst error goes to the kernel's
        row of the kernels line). Returns the max abs err."""
        m = x_np.shape[0]
        kw = dict(kind=kern.name, gamma=kern.gamma, coef0=kern.coef0,
                  degree=kern.degree)
        x = torch.as_tensor(x_np, device=dev)
        xsel = x[torch.as_tensor(example_rng.choice(m, s, replace=False),
                                 device=dev)]
        f = torch.as_tensor(example_rng.uniform(-1, 1, m).astype(np.float32),
                            device=dev)
        delta = torch.as_tensor(
            example_rng.standard_normal(s).astype(np.float32), device=dev)
        ops = fup.prepare(x, xsel, delta, torch.zeros_like(f))
        step = fupdate_plain(*ops, **kw).abs().max()
        ops = fup.prepare(x, xsel, delta / step, f)
        out = fup.fupdate(*ops[:4], kern, xn=ops[4])
        torch.cuda.synchronize()
        plain = fupdate_plain(*ops, **kw)
        err, rel, tol, share = hold(out, plain, plain - ops[3], what)
        key = worst_key("fupdate", "f32", s)
        worst[key] = max(worst[key], err)
        say(f"{what}: max_abs={err:.3e} max_rel={rel:.3e} tol={tol} "
            f"tol/median_update={share:.2e}")
        return err

    worst = {"fupdate": 0.0, "fupdate_wide": 0.0, "fupdate_wide_bf16": 0.0,
             "decision": 0.0, "decision_d768": 0.0, "gram": 0.0,
             "gram_bf16": 0.0}

    def worst_key(family, precision, s=None):
        """gram's f32 (SIMT) and 16-bit (wgmma) classes are two rows, and
        so are fupdate's wide classes (S > 32; bf16 and f16 one row)
        beside its narrow one."""
        if family == "fupdate" and s is not None \
                and s > tiling.FUPDATE_NARROW_MAX_S:
            return "fupdate_wide" + ("" if precision == "f32" else "_bf16")
        return family + ("_bf16" if family == "gram" and precision != "f32"
                         else "")
    for (m, s) in FUPDATE_SHAPES:
        for kind, kern in kernels.items():
            for precision in PRECISIONS:
                ops = fupdate_operands(kind, m, s, precision)
                out = fup.fupdate(*ops[:4], kern, precision=precision,
                                  xn=ops[4])
                torch.cuda.synchronize()
                plain = fupdate_plain(*ops, **plain_kw(kind))
                err, rel, tol, share = hold(
                    out, plain, plain - ops[3],
                    f"fupdate m={m} S={s} {kind} {precision}")
                key = worst_key("fupdate", precision, s)
                worst[key] = max(worst[key], err)
                say(f"[kernels] fupdate m={m} S={s} d={D} {kind:6s} "
                    f"{precision:4s} max_abs={err:.3e} max_rel={rel:.3e} "
                    f"tol={tol} tol/median_update={share:.2e}")

    def check_queries(kind, n, d=D):
        q = make_toy(SEED + n, n, d=d)[0]
        if kind != "rbf":
            q = q / np.linalg.norm(q, axis=1, keepdims=True)
        return torch.as_tensor(q, device=dev)

    def support_model(kind, precision, d=D, n=SUPPORT):
        """A packed model of n check rows of d features (rbf at
        gamma = 1/d away from the main width). Its weights are positive,
        as almost all of a fitted model's are, and scaled so that
        |s| <= 1 over the largest bucket's queries; its offsets sit at the
        quartiles of that s. The outputs take both signs, and s is O(1)
        (with weights of both signs, s of the linear kernel gathers near
        0 and its output near -s^2, small beside the tolerance)."""
        kern = kernels[kind] if d == D else rbf(1.0 / d)
        T = torch.as_tensor(rows[kind][:n] if d == D
                            else make_toy(SEED, n, d=d)[0], device=dev)
        g = torch.as_tensor(np.abs(rng.standard_normal(n))
                            .astype(np.float32), device=dev)
        s = kern.cross(check_queries(kind, BUCKETS[-1], d), T) @ g
        g, s = g / s.abs().max(), s / s.abs().max()
        model = OCSSVMModel(gamma=g, rho1=torch.quantile(s, 0.25),
                            rho2=torch.quantile(s, 0.75), X=T,
                            spec=SlabSpec(kernel=kern))
        return pack_model(model, precision=precision, sv_threshold=0.0)

    def decision_operands(kind, sm, bucket, precision):
        q = torch.zeros((bucket, sm.t_pad.shape[1]), device=dev)
        q[:, :sm.d] = check_queries(kind, bucket, sm.d)
        return dec.prepare_packed(q, sm.t_pad, sm.gamma_pad, sm.t_norms,
                                  tm=min(bucket, 256), tn=sm.tn,
                                  precision=precision)

    for kind, kern in kernels.items():
        for precision in PRECISIONS:
            sm = support_model(kind, precision)
            rho1, rho2 = float(sm.model.rho1), float(sm.model.rho2)
            for bucket in BUCKETS:
                ops = decision_operands(kind, sm, bucket, precision)
                out = dec.decision_packed(
                    ops[0], sm.t_pad, sm.gamma_pad, sm.t_norms, rho1, rho2,
                    kern, tm=min(bucket, 256), tn=sm.tn, precision=precision)
                torch.cuda.synchronize()
                plain = decision_plain(*ops, rho1, rho2, **plain_kw(kind))
                # The work: how far s moves the output from its value at 0.
                err, rel, tol, share = hold(
                    out, plain, plain + rho1 * rho2,
                    f"decision bucket={bucket} {kind} {precision}")
                worst["decision"] = max(worst["decision"], err)
                cfg = dec.DECISION.last_config
                check(cfg == tiling.packed_decision_config(bucket,
                                                           precision),
                      f"decision bucket={bucket} {precision} launched {cfg}")
                again = dec.launch(*ops, rho1, rho2, kern, cfg)()
                torch.cuda.synchronize()
                check(torch.equal(out.view(torch.int32),
                                  again.view(torch.int32)),
                      f"decision bucket={bucket} {kind} {precision}: two "
                      f"launches on the same inputs differ")
                say(f"[kernels] decision bucket={bucket} support="
                    f"{sm.t_pad.shape[0]} d={D} {kind:6s} {precision:4s} "
                    f"entry {cfg.entry} max_abs={err:.3e} max_rel={rel:.3e} "
                    f"tol={tol} tol/median_work={share:.2e} "
                    f"relaunch=bitwise")

    def gram_rows(kind, m, d, seed):
        """Toy rows, unit-length for linear and poly (as above)."""
        r = X_np if (m, d, seed) == (M, D, SEED) else make_toy(seed, m,
                                                                d=d)[0]
        if kind != "rbf":
            r = r / np.linalg.norm(r, axis=1, keepdims=True)
        return torch.as_tensor(r, device=dev)

    for (gm, gn, gd) in GRAM_SHAPES:
        for kind, kern in kernels.items():
            x = gram_rows(kind, gm, gd, SEED)
            y = x if gn == gm else gram_rows(kind, gn, gd, SEED + 1)
            for precision in PRECISIONS:
                n0 = gram_ops.GRAM.launches
                out = gram_ops.gram(x, y, kern, precision=precision)
                torch.cuda.synchronize()
                check(gram_ops.GRAM.launches == n0 + 1,
                      "the gram wrapper launched no kernel")
                plain = gram_plain(x, y, precision=precision,
                                   **plain_kw(kind))
                err, rel, tol, share = hold(
                    out, plain, plain,
                    f"gram {gm}x{gn} d={gd} {kind} {precision}")
                key = worst_key("gram", precision)
                worst[key] = max(worst[key], err)
                del out, plain
                say(f"[kernels] gram {gm}x{gn} d={gd} {kind:6s} "
                    f"{precision:4s} max_abs={err:.3e} max_rel={rel:.3e} "
                    f"tol={tol} tol/median_value={share:.2e}")

    def menu_case(family, s, precision):
        """(launch(cfg), plain, work) at the menu check's ragged shape:
        rbf on toy rows, each kernel's work O(1) as above."""
        kern = rbf(1.0 / MENU_D)
        kw = dict(kind="rbf", gamma=kern.gamma)
        a = torch.as_tensor(make_toy(SEED + 2, MENU_ROWS, d=MENU_D)[0],
                            device=dev)
        if family == "gram":
            ops = gram_ops.prepare(a, a[:77], precision=precision)
            plain = gram_plain(ops[0], ops[1], precision=precision, **kw)
            return (lambda c: gram_ops.launch(*ops, kern, c)(), plain,
                    plain)
        if family == "fupdate":
            delta = torch.as_tensor(rng.standard_normal(s)
                                    .astype(np.float32), device=dev)
            f = torch.as_tensor(rng.uniform(-1, 1, MENU_ROWS)
                                .astype(np.float32), device=dev)
            ops = fup.prepare(a, a[:s], delta, torch.zeros_like(f),
                              precision=precision)
            step = fupdate_plain(*ops, **kw).abs().max()
            ops = fup.prepare(a, a[:s], delta / step, f,
                              precision=precision)
            plain = fupdate_plain(*ops, **kw)
            return (lambda c: fup.launch(*ops, kern, c)(), plain,
                    plain - ops[3])
        # Ragged for both classes: 203 support rows (no multiple of
        # SW = 64 or 32), d = 45 (16-bit rows padded to 48 for TMA).
        g = torch.as_tensor(np.abs(rng.standard_normal(MENU_ROWS))
                            .astype(np.float32), device=dev)
        s_ = gram_plain(a[:77], a, precision=precision, **kw) @ g
        g, s_ = g / s_.max(), s_ / s_.max()       # 0 < s <= 1
        r1, r2 = (float(torch.quantile(s_, p)) for p in (0.25, 0.75))
        ops = dec.prepare(a[:77], a, g, precision=precision)
        plain = decision_plain(*ops, r1, r2, **kw)
        return (lambda c: dec.launch(*ops, r1, r2, kern, c)(), plain,
                plain + r1 * r2)

    n_menu = 0
    for family, entries in tiling.MENUS.items():
        for idx, entry in enumerate(entries):
            cfg = tiling.config_of(entry, "explicit")
            for precision in tiling.precisions_of(family, cfg):
                s = None if family != "fupdate" else MENU_S[
                    "narrow" if tiling.kernel_of(family, cfg) in ("tile",
                                                                  "pipe")
                    else "wide"]
                check(cfg in tiling.menu(family, s, precision),
                      f"{family} menu entry {entry} outside its class")
                run, plain, work = menu_case(family, s, precision)
                out = run(cfg)
                base = run(tiling.default_config(family, s, precision))
                torch.cuda.synchronize()
                what = f"{family} menu entry {idx} {entry} {precision}"
                err, _, _, share = hold(out, plain, work, what)
                check(torch.equal(out.view(torch.int32),
                                  base.view(torch.int32)),
                      f"{what}: not bitwise equal to the default entry")
                key = worst_key(family, precision, s)
                worst[key] = max(worst[key], err)
                n_menu += 1
    say(f"[kernels] menus: {n_menu} launches (every entry of every family "
        f"in each precision of its class, {MENU_ROWS} rows, d={MENU_D}, "
        f"rbf): each agrees with its plain version and is bitwise its "
        f"class's default")

    # -- 3. the main path --------------------------------------------------
    # Each path runs with the counts set to 0 just before it and read just
    # after; fupdate's launches also by class (the narrow hot loop,
    # S <= 32; the wide init pass and reconcile, S > 32).
    narrow = {c.entry for c in tiling.menu("fupdate", 2 * P)}

    def reset_counts():
        for kern_ in (fup.FUPDATE, dec.DECISION, gram_ops.GRAM):
            kern_.reset_counts()
        scan_ops.reset_counts()

    def fupdate_classes():
        by = fup.FUPDATE.by_entry
        n_narrow = sum(n for e, n in by.items() if e in narrow)
        return {"narrow": n_narrow,
                "wide": sum(by.values()) - n_narrow}

    spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=kernels["rbf"])
    reset_counts()
    fits = {}
    for precision in ("f32", "bf16"):
        n0 = fup.FUPDATE.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = repro_torch.fit(X_np, spec, strategy="auto", P=P, tol=TOL,
                              precision=precision)
        torch.cuda.synchronize()
        fits[precision] = (res, time.perf_counter() - t0,
                           fup.FUPDATE.launches - n0)
    t0 = time.perf_counter()
    sm = repro_torch.serve(X_np, spec, offsets="quantile", P=P, tol=TOL)
    torch.cuda.synchronize()
    serve_fit_s = time.perf_counter() - t0
    queries = {n: make_toy(SEED + 1 + n, n, d=D)[0] for n in REQUEST_SIZES}
    scores = {n: sm.score(q) for n, q in queries.items()}
    launches = {"fupdate": fup.FUPDATE.launches,
                "decision": dec.DECISION.launches}
    main_classes = fupdate_classes()

    hi, lo = spec.upper(M), spec.lower(M)
    for precision, (res, secs, n_launch) in fits.items():
        g = res.model.gamma.double()
        iters = int(res.iters)
        check(bool(res.converged), f"{precision} fit did not converge")
        check(iters > 0, f"{precision} fit took no iteration")
        check(n_launch >= iters,
              f"{precision} fit: {n_launch} fupdate launches < {iters} iters")
        check(abs(float(g.sum()) - spec.total()) < 1e-4,
              f"{precision} fit: sum(gamma) = {float(g.sum())}")
        check(float(g.max()) <= hi + 1e-7 and float(g.min()) >= lo - 1e-7,
              f"{precision} fit: gamma leaves the box")
        say(f"[main] fit {precision}: m={M} d={D} iters={iters} converged="
            f"{bool(res.converged)} gap={float(res.gap):.3e} "
            f"rho=({float(res.model.rho1):.6f}, {float(res.model.rho2):.6f}) "
            f"sum_gamma={float(g.sum()):.6f} fupdate_launches={n_launch} "
            f"seconds={secs:.3f} ms_per_iter={1e3 * secs / iters:.3f}")
    check(launches["decision"] > 0, "serve launched no decision kernel")
    for n, s in scores.items():
        check(s.shape == (n,) and np.all(np.isfinite(s)),
              f"scores for {n} rows: shape {s.shape}")
        ref = sm.model.decision_function(
            torch.as_tensor(queries[n], device=dev)).cpu().numpy()
        np.testing.assert_allclose(s, ref, **truth_tolerance("f32", ref))
        # On target rows s sits between the offsets and the scores are far
        # smaller than that tolerance, so hold the labels as well: every
        # row whose plain score is more than 1% of the median |score| from
        # 0 gets the plain path's sign.
        sure = np.abs(ref) > 1e-2 * np.median(np.abs(ref))
        flips = int(np.sum(np.sign(s[sure]) != np.sign(ref[sure])))
        check(flips == 0, f"scores for {n} rows: {flips} labels differ "
              f"from the plain decision function")
        say(f"[main] serve score n={n}: max_abs_vs_plain="
            f"{float(np.max(np.abs(s - ref))):.3e} median_abs_score="
            f"{float(np.median(np.abs(ref))):.3e} labels_checked="
            f"{int(sure.sum())}/{n} label_flips={flips}")
    say(f"[main] serve: n_sv={sm.n_sv} packed={tuple(sm.t_pad.shape)} "
        f"fit+pack seconds={serve_fit_s:.3f} launches={launches} "
        f"fupdate_by_class={main_classes}")

    # The kernel path against the plain path end to end, small enough
    # for the CPU: the same solve on the card and on the CPU.
    Xs = X_np[:512]
    on_card = repro_torch.fit(Xs, spec, strategy="pallas", P=P, tol=TOL)
    on_cpu = repro_torch.fit(Xs, spec, strategy="pallas", P=P, tol=TOL,
                             device="cpu")
    for a, b, what in ((on_card.model.rho1, on_cpu.model.rho1, "rho1"),
                       (on_card.model.rho2, on_cpu.model.rho2, "rho2")):
        check(abs(float(a) - float(b)) <= 5e-3,
              f"card vs cpu {what}: {float(a)} vs {float(b)}")
    say(f"[main] m=512 card vs cpu: iters {int(on_card.iters)} vs "
        f"{int(on_cpu.iters)}, rho1 {float(on_card.model.rho1):.6f} vs "
        f"{float(on_cpu.model.rho1):.6f}")

    from repro_torch import api
    from repro_torch.core import (dual_objective, dual_objective_matfree,
                                  mcc, recover_rhos, shrinking, solve_qp)
    from repro_torch.core.engine import (SolverArtifact, artifact_from_result,
                                         make_provider, prepare_warm_start,
                                         raw_scores_blocked)
    path_launches = {"main": main_classes}

    def objective(res, X):
        return float(dual_objective_matfree(res.model.gamma.double(),
                                            X.double(),
                                            res.model.spec.kernel))

    def feasible(res, m, what):
        g = res.model.gamma.double()
        check(abs(float(g.sum()) - spec.total()) < 1e-4,
              f"{what}: sum(gamma) = {float(g.sum())}")
        check(float(g.max()) <= spec.upper(m) + 1e-7
              and float(g.min()) >= spec.lower(m) - 1e-7,
              f"{what}: gamma leaves the box")

    # -- 3b. [shrink]: "auto" above the blocked limit -----------------------
    phase_t0 = time.perf_counter()
    X_shr = make_toy(SEED, SHRINK_M, d=D)[0]
    Xs_dev = torch.as_tensor(X_shr, device=dev)
    routes, rounds = [], []
    api_shrink, inner_solve = api.solve_blocked_shrinking, \
        shrinking.solve_blocked

    def route_spy(*a, **k):
        routes.append("shrinking")
        return api_shrink(*a, **k)

    def round_spy(Xs, sp, **k):
        r = inner_solve(Xs, sp, **k)
        rounds.append((int(Xs.shape[0]), k.get("f_offset") is not None,
                       int(r.iters)))
        return r

    shrink_launches, shrink_fits = {}, {}
    api.solve_blocked_shrinking = route_spy
    shrinking.solve_blocked = round_spy
    try:
        for precision in ("f32", "bf16"):
            routes.clear()
            rounds.clear()
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = repro_torch.fit(X_shr, spec, P=P, tol=TOL,
                                  precision=precision)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            classes = fupdate_classes()
            shrink_launches[precision] = dict(classes)
            shrink_fits[precision] = res
            check(routes == ["shrinking"],
                  f"auto at m={SHRINK_M} took {routes}, not shrinking")
            check(bool(res.converged),
                  f"shrinking {precision} did not converge")
            feasible(res, SHRINK_M, f"shrinking {precision}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blk = repro_torch.fit(X_shr, spec, strategy="pallas", P=P,
                                  tol=TOL, precision=precision)
            torch.cuda.synchronize()
            blk_s = time.perf_counter() - t0
            o_s, o_b = objective(res, Xs_dev), objective(blk, Xs_dev)
            tol_o = truth_tolerance(precision, [o_b])
            check(abs(o_s - o_b) <= max(tol_o["atol"], SOLVER_ATOL_FLOOR)
                  + tol_o["rtol"] * abs(o_b),
                  f"shrinking {precision} objective {o_s} vs blocked {o_b}")
            rho_s = np.asarray([float(res.model.rho1),
                                float(res.model.rho2)])
            rho_b = np.asarray([float(blk.model.rho1),
                                float(blk.model.rho2)])
            tol_r = truth_tolerance(precision, rho_b)
            check(np.all(np.abs(rho_s - rho_b)
                         <= max(tol_r["atol"], SOLVER_ATOL_FLOOR)
                         + tol_r["rtol"] * np.abs(rho_b)),
                  f"shrinking {precision} rho {rho_s} vs blocked {rho_b}")
            say(f"[shrink] fit {precision} m={SHRINK_M} d={D} (auto -> "
                f"shrinking): rounds={len(rounds) - 1} solves (rows, "
                f"f_offset, iters)={rounds} iters={int(res.iters)} "
                f"converged={bool(res.converged)} seconds={secs:.3f} "
                f"fupdate_launches={classes} objective={o_s:.9f} "
                f"rho=({rho_s[0]:.6f}, {rho_s[1]:.6f})")
            say(f"[shrink] blocked {precision} m={SHRINK_M} (strategy="
                f"pallas): iters={int(blk.iters)} seconds={blk_s:.3f} "
                f"objective={o_b:.9f} rho=({rho_b[0]:.6f}, "
                f"{rho_b[1]:.6f}); |objective diff|={abs(o_s - o_b):.3e}")
    finally:
        api.solve_blocked_shrinking = api_shrink
        shrinking.solve_blocked = inner_solve
    path_launches["shrink"] = shrink_launches
    del Xs_dev
    say(f"[shrink] phase seconds={time.perf_counter() - phase_t0:.2f}")

    # -- 3c. [paper]: the paper's Table 1 on the card ------------------------
    phase_t0 = time.perf_counter()
    reset_counts()

    def timed(fn):
        """(result, seconds of the second of two calls)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for m in TABLE1_SIZES:
        Xp, yp = make_toy(SEED, m)
        Xp_dev = torch.as_tensor(Xp, device=dev)
        K = PAPER_SPEC.kernel.gram(Xp_dev)
        runs = {
            "paper": lambda: repro_torch.fit(
                Xp, PAPER_SPEC, strategy="paper", gram_mode="precomputed",
                tol=1e-3, max_iters=100_000),
            "mvp": lambda: repro_torch.fit(
                Xp, PAPER_SPEC, strategy="mvp", gram_mode="precomputed",
                tol=1e-3, max_iters=100_000),
            "blocked": lambda: repro_torch.fit(
                Xp, PAPER_SPEC, strategy="blocked", gram_mode="on_the_fly",
                P=16, tol=1e-3, max_outer=50_000),
        }
        row = {}
        for name, fn in runs.items():
            res, secs = timed(fn)
            row[name] = (int(res.iters), secs,
                         float(mcc(yp, res.model.predict(Xp_dev))),
                         float(dual_objective(res.model.gamma, K)))
        if m in TABLE1_SIZES[:QP_SIZES]:
            qp, secs = timed(lambda: solve_qp(Xp_dev, PAPER_SPEC,
                                              max_iters=20_000, tol=1e-9))
            # The QP returns gamma only: its offsets from its own scores.
            r1, r2 = recover_rhos(qp.gamma, K @ qp.gamma, PAPER_SPEC)
            qp_model = OCSSVMModel(gamma=qp.gamma, rho1=r1, rho2=r2,
                                   X=Xp_dev, spec=PAPER_SPEC)
            o_qp = float(qp.objective)
            row["qp"] = (int(qp.iters), secs,
                         float(mcc(yp, qp_model.predict(Xp_dev))), o_qp)
            for name in runs:
                check(row[name][3] <= o_qp + 5e-4 + 0.05 * abs(o_qp),
                      f"m={m} {name}: objective {row[name][3]} above the "
                      f"QP's {o_qp}")
        say(f"[paper] m={m} d=2 " + " ".join(
            f"{k}: iters={it} seconds={sec:.4f} mcc={mc:.4f} "
            f"objective={ob:.6e};" for k, (it, sec, mc, ob) in row.items()))
    path_launches["paper"] = fupdate_classes()
    check(fup.FUPDATE.launches == 0,
          "the paper's route launched fupdate: its selector holds both "
          "columns, as in the JAX package")
    say(f"[paper] phase seconds={time.perf_counter() - phase_t0:.2f} "
        f"(QP at m in {TABLE1_SIZES[:QP_SIZES]}) fupdate_launches="
        f"{path_launches['paper']}")

    # -- 3d. [warm]: a streaming refresh at the main cell's size -------------
    # In f32 and bf16, from the main path's fit of that precision: at the
    # delta-scaled P = 64 every iteration (S = 128) and the reconcile run
    # fupdate's wide classes (the SIMT split tile, the wgmma split kernel).
    phase_t0 = time.perf_counter()
    n_delta = M * 5 // 100        # 5% expiry and 5% append
    X_new = np.concatenate([X_np[n_delta:],
                            make_toy(SEED + 7, n_delta, d=D)[0]])
    Xn_dev = torch.as_tensor(X_new, device=dev)
    warm_launches, warm_shapes, warm_fits = {}, {}, {}
    for precision in ("f32", "bf16"):
        art = artifact_from_result(fits[precision][0], precision=precision)
        reset_counts()
        st = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = repro_torch.fit_update(art, X_new, tol=TOL, stats_out=st)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_classes = fupdate_classes()
        warm_launches[precision] = warm_classes
        warm_fits[precision] = warm
        t0 = time.perf_counter()
        cold = repro_torch.fit(X_new, spec, P=P, tol=TOL,
                               precision=precision)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        what = f"warm {precision}"
        check(st["mode"] == "warm", f"{what}: fit_update took the "
              f"{st['mode']} route")
        iters = int(warm.iters)
        check(sum(warm_classes.values()) == iters + 1,
              f"{what}: {warm_classes} fupdate launches, not one per "
              f"iteration plus the reconcile ({iters} iters)")
        check(warm_classes["narrow"] == 0
              and 2 * st["P"] > tiling.FUPDATE_NARROW_MAX_S,
              f"{what}: {warm_classes} at P = {st['P']}: not all wide")
        check(bool(warm.converged), f"{what}: the fit did not converge")
        feasible(warm, M, what)
        o_w, o_c = objective(warm, Xn_dev), objective(cold, Xn_dev)
        tol_o = truth_tolerance(precision, [o_c])
        check(abs(o_w - o_c) <= tol_o["atol"] + tol_o["rtol"] * abs(o_c),
              f"{what}: objective {o_w} vs cold {o_c}")
        say(f"[warm] fit_update {precision} m={M} d={D}: stats "
            + json.dumps({k: st[k] for k in ("mode", "n_overlap", "n_fresh",
                                             "n_expired", "n_corr", "P")})
            + f" warm iters={iters} seconds={warm_s:.3f} "
            f"fupdate_launches={warm_classes}; cold iters={int(cold.iters)} "
            f"seconds={cold_s:.3f}; objective warm={o_w:.9f} "
            f"cold={o_c:.9f}")
        # The reconcile alone: one wide fupdate on the card against the
        # plain K @ gamma0 of the provider's rows.
        ws, info = prepare_warm_start(art, Xn_dev, spec)
        prov = make_provider("pallas", Xn_dev, spec.kernel,
                             precision=precision)
        f_rec = prov.reconcile_scores(ws)
        cfg = fup.FUPDATE.last_config
        check(cfg.entry not in narrow, f"the reconcile launched {cfg}")
        truth = raw_scores_blocked(prov.X, ws.gamma0, spec.kernel)
        torch.cuda.synchronize()
        err, rel, tol, share = hold(f_rec, truth, truth,
                                    f"{what} reconcile")
        warm_shapes[precision] = (("warm hot loop", 2 * st["P"]),
                                  ("warm reconcile", info.n_corr))
        say(f"[warm] {precision} reconcile S={info.n_corr} entry "
            f"{cfg.entry}: vs raw_scores_blocked max_abs={err:.3e} "
            f"max_rel={rel:.3e} tol={tol} tol/median_f={share:.2e}")
        # The checkpoint: saved, loaded, and warm-started again, bitwise.
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "artifact.npz")
            art.save(path)
            again = repro_torch.fit_update(SolverArtifact.load(path), X_new,
                                           tol=TOL)
        check(torch.equal(warm.model.gamma.view(torch.int32),
                          again.model.gamma.view(torch.int32)),
              f"{what}: fit_update from the loaded artifact is not bitwise "
              f"the warm fit")
        say(f"[warm] {precision} artifact saved, loaded and refit: gamma "
            f"bitwise the warm fit's ({int(again.iters)} iters)")
    path_launches["warm"] = warm_launches
    del Xn_dev
    say(f"[warm] phase seconds={time.perf_counter() - phase_t0:.2f}")

    # -- 3e. [serve-wide]: 16-bit scoring at embedding widths ----------------
    # A bf16 model of BERT-base pooled embeddings' width (d = 768) scored
    # through the scorer at every bucket, one of d = 2048 at the smallest,
    # and the pooled screen's (d = 4096, 32768 support rows) at the top:
    # the resident query tile caps d at 640-1664 by the entry, so each
    # bucket takes an entry that fits (tiling.wgmma_fits), a streamed one
    # above 1664, the wide one (2-CTA clusters) at the pooled screen.
    phase_t0 = time.perf_counter()
    wide_models, serve_wide = {}, {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clusters = dec.wide_clusters("bf16")
    check(clusters == tiling.wide_clusters(),
          f"the card holds {clusters} clusters of the wide streamed entry at "
          f"once ({sms} SMs); tiling.decision_grid assumes "
          f"{tiling.wide_clusters()}")
    say(f"[serve-wide] wide streamed entry: {clusters} clusters of "
        f"{tiling.CLUSTER_CTAS} CTAs at once on {sms} SMs (tiling assumes "
        f"{tiling.wide_clusters()})")
    for d_w, buckets, n_sv in ((WIDE_D, BUCKETS, SUPPORT),
                               (WIDEST_D, BUCKETS[:1], SUPPORT),
                               (POOLED_D, BUCKETS[-1:], POOLED_SUPPORT)):
        smw = support_model("rbf", "bf16", d=d_w, n=n_sv)
        wide_models[d_w] = smw
        r1, r2 = float(smw.model.rho1), float(smw.model.rho2)
        kern_w = smw.spec.kernel
        reset_counts()
        outs, cfgs = {}, {}
        for bucket in buckets:
            outs[bucket] = smw.score(check_queries("rbf", bucket, d_w))
            cfgs[bucket] = dec.DECISION.last_config
        torch.cuda.synchronize()
        serve_wide[d_w] = dec.DECISION.launches
        check(serve_wide[d_w] == len(buckets),
              f"d={d_w}: {serve_wide[d_w]} decision launches for "
              f"{len(buckets)} buckets")
        if d_w == POOLED_D:
            check(dec.DECISION.by_entry[tiling.STREAMED_WIDE] == len(buckets),
                  f"the pooled screen's launches by entry: "
                  f"{dict(dec.DECISION.by_entry)}")
        for bucket in buckets:
            out, cfg = outs[bucket], cfgs[bucket]
            ops = decision_operands("rbf", smw, bucket, "bf16")
            check(cfg == tiling.packed_decision_config(
                bucket, "bf16", ops[0].shape[1], ops[1].shape[0]),
                f"d={d_w} bucket={bucket} launched {cfg}")
            if d_w == POOLED_D:
                check(cfg.entry == tiling.STREAMED_WIDE,
                      f"the pooled screen launched {cfg.entry}, not the wide "
                      f"streamed entry {tiling.STREAMED_WIDE}")
            plain = decision_plain(*ops, r1, r2, kind="rbf",
                                   gamma=kern_w.gamma)
            err, rel, tol, share = hold(out, plain, plain + r1 * r2,
                                        f"serve-wide d={d_w} b={bucket}")
            if d_w == WIDE_D:
                worst["decision_d768"] = max(worst["decision_d768"], err)
            sure = plain.abs() > 1e-2 * plain.abs().median()
            flips = int((torch.sign(out[sure]) != torch.sign(plain[sure]))
                        .sum())
            check(flips == 0, f"serve-wide d={d_w} bucket={bucket}: {flips} "
                  f"labels differ from the plain decision")
            # Every entry of the class that fits d, the streamed ones
            # (tiling.STREAMED_ENTRIES) among them, gives bitwise the
            # scorer's values.
            fits_d = [c for c in tiling.menu("decision", precision="bf16")
                      if tiling.wgmma_fits(c, ops[0].shape[1])]
            for c in fits_d:
                other = dec.launch(*ops, r1, r2, kern_w, c)()
                torch.cuda.synchronize()
                check(torch.equal(out.view(torch.int32),
                                  other.view(torch.int32)),
                      f"serve-wide d={d_w} bucket={bucket}: entry {c.entry} "
                      f"is not bitwise {cfg.entry}")
            say(f"[serve-wide] bf16 d={d_w} bucket={bucket} support="
                f"{smw.t_pad.shape[0]} entry {cfg.entry} "
                f"({tiling.kernel_of('decision', cfg)}) max_abs={err:.3e} "
                f"max_rel={rel:.3e} tol/median_work={share:.2e} "
                f"labels_checked={int(sure.sum())}/{bucket} label_flips="
                f"{flips}; bitwise across the {len(fits_d)} entries that "
                f"fit d")
    path_launches["serve-wide"] = {f"d={k}": v for k, v in serve_wide.items()}
    say(f"[serve-wide] phase seconds={time.perf_counter() - phase_t0:.2f} "
        f"decision launches={path_launches['serve-wide']}")

    # -- 3f. [fleet]: the serving control plane -----------------------------
    # Three tenants in one ModelRegistry, fitted on first use; a few hundred
    # requests of REQUEST_SIZES from one asyncio loop through an
    # AdmissionController (per-tenant quotas) and its AsyncDriver on the
    # real clock; a drift-gated warm and cold refresh; the bf16 tenant
    # published to shared memory and scored by a spawned process.
    from repro_torch.serve import (AdmissionController, AsyncDriver,
                                   ModelCache, ModelRegistry,
                                   QuotaExceededError, ScoringService,
                                   ShmKeyError, attach, live_refs, publish,
                                   serve_async)
    phase_t0 = time.perf_counter()
    reset_counts()
    fleet_m = M - n_delta                 # 7783 rows; refresh appends 409
    wide_spec = SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=rbf(1.0 / WIDE_D))
    reg = ModelRegistry(ModelCache())
    # The recipes leave P to the solver, so that fit_update scales it with
    # the delta (P = 64: fupdate's wide classes), as a streaming refresh
    # does.
    reg.register("main-f32", X_np[:fleet_m], spec, quota=FLEET_QUOTA,
                 tol=TOL)
    reg.register("main-bf16", X_np[:fleet_m], spec, quota=FLEET_QUOTA,
                 tol=TOL, precision="bf16")
    reg.register("wide-bf16", make_toy(SEED, SUPPORT, d=WIDE_D)[0],
                 wide_spec, quota=FLEET_QUOTA, tol=TOL, precision="bf16")
    tenants = reg.names()
    width = {"main-f32": D, "main-bf16": D, "wide-bf16": WIDE_D}
    first = {}
    for name in tenants:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first[name] = reg.get(name)
        torch.cuda.synchronize()
        check(first[name].fit_iters > 0, f"{name}: the fit took no "
              f"iteration")
        say(f"[fleet] {name}: fit on first use m={first[name].artifact.m} "
            f"d={first[name].d} iters={first[name].fit_iters} "
            f"n_sv={first[name].n_sv} seconds={time.perf_counter() - t0:.3f}")

    pools = {D: make_toy(SEED + 11, 2 * BUCKETS[-1], d=D)[0],
             WIDE_D: make_toy(SEED + 12, BUCKETS[-1], d=WIDE_D)[0]}
    frng = np.random.default_rng(SEED + 13)

    def request(name, n):
        pool = pools[width[name]]
        off = int(frng.integers(0, pool.shape[0] - n + 1))
        return pool[off:off + n]

    # BucketStats keeps launches, rows and summed seconds; the seconds of
    # each warm launch (a bucket's first on a scorer is cold, as in its
    # mean) are kept here as well, for percentiles: the record of each
    # BucketStats the tenants' services file a launch under is wrapped
    # (the instance's, not the class's). A rebuilt service carries its
    # predecessor's BucketStats over.
    lat = {}

    def timed(bs):
        if id(bs) not in lat:
            lat[id(bs)] = []
            rec = bs.record

            def record(queries, requests, dt, cold=False):
                if not cold:
                    lat[id(bs)].append(dt)
                return rec(queries, requests, dt, cold)
            bs.record = record
        return bs

    class TimedStats(dict):
        def setdefault(self, bucket, default=None):
            return timed(super().setdefault(bucket, default))

    def watch(svc):
        svc.stats = TimedStats({b: timed(s) for b, s in svc.stats.items()})

    ctrl = AdmissionController(reg, max_batch=FLEET_MAX_BATCH)
    for name in tenants:
        watch(ctrl.service(name))
    fleet_out = []       # (tenant, model it must score like, rows, scores)
    refreshes = {}

    async def wave(items, models):
        outs = await asyncio.gather(*(
            serve_async(name, q, controller=ctrl,
                        deadline=time.monotonic() + FLEET_DEADLINE_S)
            for name, q in items))
        fleet_out.extend((name, models[name], q, out)
                      for (name, q), out in zip(items, outs))

    async def drive():
        for _ in range(FLEET_WAVES):
            # At most FLEET_PER_WAVE requests a tenant a wave, each wave
            # awaited: a window holds at most 3 requests (<= 7096 rows)
            # when a 4th arrives, so no traffic request passes the quota.
            items = [(name, request(name, int(frng.choice(REQUEST_SIZES))))
                     for name in tenants for _ in range(FLEET_PER_WAVE)]
            frng.shuffle(items)
            await wave(items, first)
        # One group that spans buckets (4096 + 1000 rows) and one request
        # over its tenant's quota (3000 rows onto 5096 queued).
        far = time.monotonic() + 3600
        held = [request("main-bf16", n) for n in (4096, 1000)]
        handles = [ctrl.submit("main-bf16", q, deadline=far) for q in held]
        try:
            ctrl.submit("main-bf16", request("main-bf16", 3000),
                        deadline=far)
            rejected = None
        except QuotaExceededError as e:
            rejected = e
        groups0 = ctrl.service("main-bf16").flush_groups
        span = ctrl.flush_model("main-bf16")
        check(span == 2 and ctrl.service("main-bf16").flush_groups
              == groups0 + 1, f"the 5096-row group took {span} launches")
        fleet_out.extend(("main-bf16", first["main-bf16"], q, h.result())
                      for q, h in zip(held, handles))
        # The drift-gated refresh: the 409 remaining rows route warm and
        # land at the [main] shape; the same rows shifted by 5 route cold.
        for label, app in (("warm", X_np[fleet_m:]),
                           ("cold", X_np[fleet_m:] + 5.0)):
            v0 = reg.version("main-f32")
            by0 = dict(fup.FUPDATE.by_entry)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sm_r = reg.refresh("main-f32", append=app)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            by = {e: n - by0.get(e, 0)
                  for e, n in fup.FUPDATE.by_entry.items()}
            n_nar = sum(n for e, n in by.items() if e in narrow)
            refreshes[label] = (sm_r, secs, reg.refresh_stats("main-f32"),
                                {"narrow": n_nar,
                                 "wide": sum(by.values()) - n_nar},
                                reg.version("main-f32") - v0)
        # Traffic after the refresh scores against the new model.
        watch(ctrl.service("main-f32"))
        await wave([("main-f32", request("main-f32", n))
                    for n in (64, 1000, 4096)],
                   {"main-f32": reg.get("main-f32")})
        return rejected, span

    with AsyncDriver(ctrl) as driver:
        t0 = time.perf_counter()
        rejected, span = asyncio.run(drive())
        drive_s = time.perf_counter() - t0
    check(not driver.alive and driver.crashed is None,
          f"the driver did not stop cleanly: {driver.crashed!r}")
    check(rejected is not None and rejected.queued_rows == 5096
          and sum(s["rejected"] for s in ctrl.stats_dict().values()) == 1,
          f"quota: {rejected!r}, {ctrl.stats_dict()}")
    sm_new = reg.get("main-f32")
    check(ctrl.service("main-f32").scorer.model is sm_new,
          "the controller still serves the replaced main-f32 model")
    for label, (sm_r, _, st, cls_, bumped) in refreshes.items():
        drift = st["last_drift"]
        check(drift is not None and drift.drifted == (label == "cold")
              and st["modes"] == {"warm": 1, "cold": int(label == "cold")}
              and bumped == 1,
              f"{label} refresh: {st['modes']} drift {drift} version +"
              f"{bumped}")
    sm_w, _, st_w, cls_w, _ = refreshes["warm"]
    check(st_w["last_warm"]["mode"] == "warm" and sm_w.artifact.m == M,
          f"warm refresh: {st_w['last_warm']} m={sm_w.artifact.m}")
    check(cls_w["narrow"] == 0 and cls_w["wide"] > 0,
          f"warm refresh fupdate launches {cls_w}: not all wide")

    # Shared memory: main-bf16 published; a spawned process on the card
    # attaches it and scores 1024 rows.
    sm_pub = first["main-bf16"]
    with tempfile.TemporaryDirectory() as spool:
        key = f"{spool}/main-bf16"    # /dev/shm is the host's: our own key
        lease = publish(sm_pub, key, dir=spool)
        out_npy = str(Path(spool) / "child_scores.npy")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", FLEET_CHILD, str(src), key, spool,
             str(SEED + 14), out_npy], capture_output=True, text=True,
            timeout=600)
        child_s = time.perf_counter() - t0
        check(child.returncode == 0,
              f"the attaching process failed: {child.stderr[-2000:]}")
        got = json.loads(child.stdout.strip().splitlines()[-1])
        refs_after = live_refs(key, dir=spool)
        child_scores = np.load(out_npy)
        lease.close()
        try:
            attach(key, dir=spool)
            unlinked = False
        except ShmKeyError:
            unlinked = True
    check(got["live_refs"] == 2 and refs_after == 1 and unlinked,
          f"shm leases {got['live_refs']} -> {refs_after}, unlinked "
          f"{unlinked}")
    check(got["device"].startswith("cuda"), f"attached on {got['device']}")
    fleet_launches = {"fupdate": fupdate_classes(),
                      "decision": dec.DECISION.launches}
    path_launches["fleet"] = fleet_launches

    # The checks (their launches are not the path's). Each result against
    # the direct score of the model that served it, for the same rows:
    # bitwise at d <= 640, where every decision entry of a class adds each
    # sum in one order; at d = 768 within TOLERANCES (PERF.md [fleet]).
    q_shm = make_toy(SEED + 14, 1024, d=D)[0]
    check(sm_pub.score(q_shm).tobytes() == child_scores.tobytes(),
          "the attached model's scores are not bitwise the publisher's")
    n_bitwise, worst_wide = 0, 0.0
    for name, sm_ref, q, out in fleet_out:
        ref = sm_ref.score(q)
        check(out.shape == ref.shape and bool(np.all(np.isfinite(out))),
              f"{name}: scores {out.shape} for {len(q)} rows")
        same = out.tobytes() == ref.tobytes()
        n_bitwise += same
        if width[name] <= 640:
            check(same, f"{name}: {len(q)} rows not bitwise the direct "
                  f"score (max diff {np.max(np.abs(out - ref)):.3e})")
        else:
            np.testing.assert_allclose(out, ref,
                                       **truth_tolerance("f32", ref))
            worst_wide = max(worst_wide, float(np.max(np.abs(out - ref))))
    last = fleet_out[-1]
    check(first["main-f32"].score(last[2]).tobytes() != last[3].tobytes(),
          "traffic after the refresh scored like the replaced model")
    n_traffic = FLEET_WAVES * FLEET_PER_WAVE * len(tenants)
    say(f"[fleet] traffic: {n_traffic} requests in {FLEET_WAVES} waves, "
        f"then 2 held + 1 rejected + 3 after the refresh; the whole drive "
        f"(refreshes included) seconds={drive_s:.3f}; {n_bitwise} of "
        f"{len(fleet_out)} results bitwise the direct score (wide-bf16 "
        f"max_abs={worst_wide:.3e}); quota rejection: {rejected}; 4096 + "
        f"1000 rows flushed as one group in {span} launches")
    for name, st_ in ctrl.stats_dict().items():
        w = st_["windows"]
        say(f"[fleet] {name}: windows flushed={w['flushed']} opened="
            f"{w['opened']} inline={w['inline_flushes']} mean_fill_rows="
            f"{w['flushed_rows'] / max(1, w['flushed']):.1f} rejected="
            f"{st_['rejected']}")
        svc = ctrl.service(name)
        for b in sorted(svc.stats):
            bs = svc.stats[b]
            xs = sorted(lat.get(id(bs), []))
            warm = (f"warm={len(xs)} p50_ms={1e3 * xs[len(xs) // 2]:.4f} "
                    f"p99_ms="
                    f"{1e3 * xs[min(len(xs) - 1, int(0.99 * len(xs)))]:.4f}"
                    if xs else "warm none")
            say(f"[fleet] {name} bucket={b}: launches={bs.batches} rows="
                f"{bs.queries} requests={bs.requests} cold="
                f"{bs.cold_batches} (cold_ms={1e3 * bs.cold_s:.4f}) {warm} "
                f"mean_ms={1e3 * bs.mean_latency_s:.4f}")
    # Each refresh's objective against a cold fit of the same rows: the
    # [main] f32 fit (X_np) for the warm one; for the cold one (8601 rows,
    # which the refresh fitted with the shrinking driver) the blocked solve.
    blk = repro_torch.fit(np.concatenate([X_np, X_np[fleet_m:] + 5.0]), spec,
                          strategy="pallas", tol=TOL)
    for label, (sm_r, secs, st, cls_, _) in refreshes.items():
        art = sm_r.artifact
        Xd = torch.as_tensor(art.X, device=dev)
        o_r = float(dual_objective_matfree(
            torch.as_tensor(art.gamma, device=dev).double(), Xd.double(),
            spec.kernel))
        cold_fit = fits["f32"][0] if label == "warm" else blk
        o_c = objective(cold_fit, Xd)
        tol_o = truth_tolerance("f32", [o_c])
        check(abs(o_r - o_c) <= tol_o["atol"] + tol_o["rtol"] * abs(o_c),
              f"{label} refresh objective {o_r} vs cold {o_c}")
        drift = st["last_drift"]
        say(f"[fleet] refresh {label}: m={art.m} drift_ks="
            f"{drift.statistic:.4f} (threshold {drift.threshold}) iters="
            f"{sm_r.fit_iters} seconds={secs:.3f} fupdate_launches={cls_} "
            f"objective={o_r:.9f}; cold fit of the same rows: iters="
            f"{int(cold_fit.iters)} objective={o_c:.9f}")
    say(f"[fleet] shm: main-bf16 published ({sm_pub.n_sv} support rows); a "
        f"spawned process made the card's context in "
        f"{got['context_s']:.4f} s, then attached it in "
        f"{got['attach_s']:.4f} s on {got['device']} (the process: "
        f"{child_s:.2f} s) and scored 1024 rows bitwise the publisher's; "
        f"leases 2 -> {refs_after}, then unlinked")
    # Per bucket on the replaced main-f32 model, one thread, nothing else
    # running: the scorer's direct latency; a ScoringService's launch
    # latency (its BucketStats) and its whole submit + flush (host clock,
    # numpy in and out). Beside the traffic's launch latency above.
    sc = first["main-f32"].scorer()
    quiet = ScoringService(sc)
    for b in BUCKETS:
        q_b = pools[D][:b]
        direct, launch, whole = [], [], []
        for _ in range(20):
            t0 = time.perf_counter()
            sc.score(q_b)
            direct.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            quiet.submit(q_b)
            quiet.flush()
            whole.append(time.perf_counter() - t0)
            launch.append(quiet.stats[b].last_s)
        for xs in (direct, launch, whole):
            xs.sort()
        say(f"[fleet] main-f32 bucket={b} alone: scorer direct p50_ms="
            f"{1e3 * direct[10]:.4f} min_ms={1e3 * direct[0]:.4f}; service "
            f"launch p50_ms={1e3 * launch[10]:.4f}, submit+flush p50_ms="
            f"{1e3 * whole[10]:.4f}")
    say(f"[fleet] phase seconds={time.perf_counter() - phase_t0:.2f} "
        f"launches={fleet_launches}")

    # -- 3g. [dist]: the row-sharded solver and the sharded scorer ---------
    # Rank processes spawned on the one card: two gloo ranks (NCCL refuses
    # two ranks on one card), then one NCCL rank (world size 1). They load
    # the libraries built in phase 1. Each rank sets its counts to 0 just
    # before each drive and reads them just after.
    served = _served(sm)
    jobs = {"gloo": (2, dict(precisions=("f32", "bf16"), full=True,
                             requests=DIST_REQUESTS, served=served, cards=1)),
            "nccl": (1, dict(precisions=("f32",), full=False,
                             requests=DIST_REQUESTS[:1], served=served,
                             cards=1))}
    path_launches["dist"], dist_decision = _dist_phase(jobs, dict(
        dev=dev, spec=spec, sm=sm, X=X_np, X_shr=X_shr, X_new=X_new,
        main={p_: f[0] for p_, f in fits.items()}, shrink=shrink_fits["f32"],
        warm=warm_fits["f32"]))

    # -- 3h. [ckpt]: the fault-tolerant, checkpointed fit -------------------
    path_launches["ckpt"], ckpt_decision = _ckpt_phase(
        dev, X_np, spec, {p_: f[0] for p_, f in fits.items()}, reset_counts,
        fupdate_classes)

    # -- 3i. [head]: the slab head on pooled features ----------------------
    head_launches = _head_phase(dev, reset_counts)
    path_launches["head"] = head_launches["fupdate"]

    # -- 3j. [cli]: the serving CLI ----------------------------------------
    cli_launches = _cli_phase(src)
    path_launches["cli"] = cli_launches["fupdate"]

    # -- 3k. [lm]: the LM serving path and the slab on its features -------
    lm = _lm_phase(dev, src, reset_counts, fupdate_classes, autotune.graph_ms)
    path_launches["lm"] = lm["launches"]["fupdate"]

    # -- 3l. [lm-train]: the LM training step ------------------------------
    lm_train = _lm_train_phase(dev, src, reset_counts, lambda: {
        "fupdate": fup.FUPDATE.launches, "decision": dec.DECISION.launches,
        "gram": gram_ops.GRAM.launches})
    path_launches["lm-train"] = lm_train["launches"]

    # -- 3m. [lm-dist]: the sharded LM training step -----------------------
    lm_dist = _lm_dist_phase(dev, lm_train, reset_counts, lambda: {
        "fupdate": fup.FUPDATE.launches, "decision": dec.DECISION.launches,
        "gram": gram_ops.GRAM.launches})
    path_launches["lm-dist"] = lm_dist["launches"]

    # -- 3n. [lm-serve-dist]: sharded LM serving ----------------------------
    lm_serve_dist = _lm_serve_dist_phase(dev, lm, reset_counts, lambda: {
        "fupdate": fup.FUPDATE.launches, "decision": dec.DECISION.launches,
        "gram": gram_ops.GRAM.launches})
    path_launches["lm-serve-dist"] = lm_serve_dist["launches"]

    # -- 3o. [dryrun]: the dry run and [lm-train]'s predicted memory,
    # started here and read after [lm-ssm]: its processes use no card, so
    # they run on the host's cores while the card's phases do ----------
    with _dryrun_started(src) as dryrun_procs:
        # -- 3p. [examples]: the port's examples on the card ----------------
        examples = _examples_phase(dev, reset_counts, fupdate_classes,
                                   hold_fupdate_at)

        # -- 3q. [lm-ssm]: the scan kernels, rwkv6-7b and a jamba block --
        lm_ssm = _lm_ssm_phase(dev, reset_counts)
        _dryrun_phase(dryrun_procs, lm_train, lm_dist)
    path_launches["examples"] = {k: v["fupdate"] for k, v in examples.items()}
    scan_rows = list(lm_ssm["rows"].values())
    for row in scan_rows:
        fam = row["name"].rsplit("_", 1)[0]
        arch = next(a for a, f in SCAN_ARCHS.items() if f == fam)
        row["launches_by_path"] = {
            "lm": lm["scan_launches"][arch].get(row["name"], 0),
            "lm-train": lm_train["scan_launches"][arch].get(row["name"], 0),
            "lm-dist": {k: v.get(row["name"], 0) for k, v in
                        lm_dist["scan_launches"].items()},
            "lm-serve-dist": {k: v.get(row["name"], 0) for k, v in
                              lm_serve_dist["scan_launches"].items()},
            "lm-ssm": row["launches"]}

    # -- 4. the autotune path ----------------------------------------------
    for kern_ in (fup.FUPDATE, dec.DECISION, gram_ops.GRAM):
        kern_.launches = 0
    cells = autotune.QUICK_CELLS + tuple(
        c for c in autotune.MAIN_CELLS if c.family in ("fupdate", "gram"))
    t0 = time.perf_counter()
    swept = autotune.sweep(cells, precisions=("f32",), repeats=3)
    gram_f32_launches = gram_ops.GRAM.launches      # the SIMT class's
    swept16 = autotune.sweep(cells, precisions=("bf16",), repeats=3)
    sweep_s = time.perf_counter() - t0
    tune_launches = {"fupdate": fup.FUPDATE.launches,
                     "decision": dec.DECISION.launches,
                     "gram": gram_f32_launches,
                     "gram_bf16": gram_ops.GRAM.launches - gram_f32_launches}
    for w in swept["winners"] + swept16["winners"]:
        say(f"[autotune] winner {w['family']} m={w['m']} n={w['n']} "
            f"d={w['d']} {w['precision']}: (BM, BN, BK, TR, TC, DEPTH)="
            f"{tiling.row_config(w).entry}"
            f" best_us={1e6 * w['best_s']:.3f} {w['bound']}-bound")
    n_cand = len(swept["candidates"]) + len(swept16["candidates"])
    say(f"[autotune] quick sweep: {n_cand} candidates, "
        f"{len(swept['winners']) + len(swept16['winners'])} cells, "
        f"seconds={sweep_s:.2f}, launches={tune_launches}")
    for family in tune_launches:
        check(tune_launches[family] > 0, f"the sweep launched no {family}")
    entries = autotune.winners_to_entries(swept) \
        + autotune.winners_to_entries(swept16)
    tiling.validate_table({"entries": entries})   # valid table rows

    # The committed table against none: the fit's launches differ only in
    # rows per CTA, so the fits must be bitwise equal.
    tuned_fits = {}
    for label, table in (("committed", None), ("empty", {"entries": []})):
        tiling.set_tuned_table(table)
        fup.FUPDATE.last_config = None
        res = repro_torch.fit(X_np, spec, strategy="auto", P=P, tol=TOL)
        cfg = fup.FUPDATE.last_config
        tuned_fits[label] = res
        say(f"[autotune] fit f32 m={M} table={label}: fupdate (BM, BN, BK,"
            f" TR, TC, DEPTH)={cfg.entry} source={cfg.source} "
            f"iters={int(res.iters)} "
            f"rho=({float(res.model.rho1):.9f}, "
            f"{float(res.model.rho2):.9f})")
        if label == "committed":
            check(cfg.source in ("table-exact", "table-nearest"),
                  f"the fit's fupdate did not launch from the table: "
                  f"{cfg}")
        else:
            check(cfg.source == "default", f"empty table launched {cfg}")
    tiling.set_tuned_table(None)
    a, b = tuned_fits["committed"], tuned_fits["empty"]
    check(torch.equal(a.model.gamma.view(torch.int32),
                      b.model.gamma.view(torch.int32))
          and float(a.model.rho1) == float(b.model.rho1)
          and float(a.model.rho2) == float(b.model.rho2)
          and int(a.iters) == int(b.iters),
          "the fit with the committed table is not bitwise the fit with "
          "an empty table")
    say("[autotune] the fit with the committed table is bitwise the fit "
        "with an empty table (gamma, rho1, rho2, iters)")

    # -- 5. timing ----------------------------------------------------------
    time_ms = autotune.graph_ms    # device ms of one call, graph-replayed

    def bound(nbytes, flops, precision):
        t = terms(flops, nbytes, 0.0, 1, precision)
        return (1e3 * t.step_time_s,
                "bytes" if t.memory_s >= t.compute_s else "operations")

    # A kernel's time is that of its launch on prepared operands
    # (fup.launch, dec.launch), built on the stream that captures it; the
    # wrapper's casts and norms are not the kernel's work.
    timed = {}
    for (m, s) in FUPDATE_SHAPES:
        for precision in PRECISIONS:
            ops = fupdate_operands("rbf", m, s, precision)
            cfg = fup.tiles(ops[0], s)
            ms = time_ms(lambda: fup.launch(*ops, kernels["rbf"])())
            plain_ms = time_ms(lambda: fupdate_plain(*ops, **plain_kw("rbf")))
            es = ops[0].element_size()
            nbytes = (m + s) * D * es + 4 * (3 * m + 2 * s)
            flops = 2 * m * s * D + 2 * m * s
            b_ms, b_by = bound(nbytes, flops, precision)
            timed[("fupdate", m, s, precision)] = (ms, plain_ms, b_ms, b_by)
            say(f"[timing] fupdate m={m} S={s} d={D} rbf {precision:4s} "
                f"config {cfg.entry} ({cfg.source}) "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={b_ms:.5f} ({b_by}) "
                f"bound_share={b_ms / ms:.3f}")
    # fupdate's wide classes at the warm path's shapes, as it ran in each
    # precision: its hot loop at the delta-scaled P and its reconcile,
    # held against the plain version first (the init pass, m = S = 2048,
    # is timed above).
    for precision, shapes in warm_shapes.items():
        for what, s_w in shapes:
            ops = fupdate_operands("rbf", M, s_w, precision)
            out = fup.launch(*ops, kernels["rbf"])()
            plain = fupdate_plain(*ops, **plain_kw("rbf"))
            err, _, _, share = hold(out, plain, plain - ops[3],
                                    f"fupdate {what} S={s_w} {precision}")
            key = worst_key("fupdate", precision, s_w)
            worst[key] = max(worst[key], err)
            cfg = fup.tiles(ops[0], s_w)
            ms = time_ms(lambda: fup.launch(*ops, kernels["rbf"])())
            plain_ms = time_ms(lambda: fupdate_plain(*ops,
                                                     **plain_kw("rbf")))
            es = ops[0].element_size()
            b_ms, b_by = bound((M + s_w) * D * es + 4 * (3 * M + 2 * s_w),
                               2 * M * s_w * D + 2 * M * s_w, precision)
            timed[("fupdate", M, s_w, precision)] = (ms, plain_ms, b_ms,
                                                     b_by)
            say(f"[timing] fupdate {what} m={M} S={s_w} d={D} rbf "
                f"{precision:4s} config {cfg.entry} ({cfg.source}) "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={b_ms:.5f} ({b_by}) bound_share={b_ms / ms:.3f} "
                f"max_abs={err:.3e} tol/median_update={share:.2e}")
    # decision: against SUPPORT check rows and against the served model
    # (the f32 fit's support rows, packed in each precision), at every
    # bucket, with the entry the bucket picks, as the scorer launches it.
    served = {p: sm if p == "f32" else pack_model(sm.model, precision=p)
              for p in PRECISIONS}
    n_dec, n_dec_faster = 0, 0
    for precision in PRECISIONS:
        for smp in (support_model("rbf", precision), served[precision]):
            rho1, rho2 = float(smp.model.rho1), float(smp.model.rho2)
            for bucket in BUCKETS:
                ops = decision_operands("rbf", smp, bucket, precision)
                cfg = tiling.packed_decision_config(bucket, precision)
                ms = time_ms(lambda: dec.launch(*ops, rho1, rho2,
                                                kernels["rbf"], cfg)(),
                             iters=30)
                plain_ms = time_ms(lambda: decision_plain(
                    *ops, rho1, rho2, **plain_kw("rbf")), iters=30)
                es = ops[0].element_size()
                nt, dp = ops[1].shape
                nbytes = (bucket + nt) * dp * es + 4 * (2 * nt + 2 * bucket)
                flops = 2 * bucket * nt * dp + 2 * bucket * nt
                b_ms, b_by = bound(nbytes, flops, precision)
                exp_ms = 1e3 * bucket * nt / SFU_EXPS_PER_S
                timed[("decision", bucket, nt, precision)] = (
                    ms, plain_ms, b_ms, b_by)
                n_dec += 1
                n_dec_faster += ms <= plain_ms
                say(f"[timing] decision bucket={bucket} support={nt} "
                    f"(n_sv={smp.n_sv}) d={dp} rbf {precision:4s} config "
                    f"{cfg.entry} ({cfg.source}) kernel_ms={ms:.4f} "
                    f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
                    f"exp_floor_ms={exp_ms:.5f} bound_share={b_ms / ms:.3f}")
    say(f"[timing] decision no slower than its plain version in "
        f"{n_dec_faster} of {n_dec} (bucket, support, precision) cells")
    # What the kernel value costs: the same launches with the linear
    # kernel (no exp, one FMA a pair) beside rbf.
    for precision in ("f32", "bf16"):
        ops = decision_operands("rbf", support_model("rbf", precision),
                                BUCKETS[-1], precision)
        cfg = tiling.packed_decision_config(BUCKETS[-1], precision)
        pace = {k: time_ms(lambda: dec.launch(*ops, 0.0, 1.0, kernels[k],
                                              cfg)(), iters=30)
                for k in ("rbf", "linear")}
        say(f"[timing] decision bucket={BUCKETS[-1]} support={SUPPORT} "
            f"{precision} by kernel: rbf kernel_ms={pace['rbf']:.4f} linear "
            f"kernel_ms={pace['linear']:.4f}")
    # 16-bit decision at the embedding widths of [serve-wide], with the
    # entry the bucket and d pick, and at d = WIDE_D the streamed entry
    # beside it (what streaming the query tile costs where both fit).
    for d_w, bucket in ((WIDE_D, BUCKETS[0]), (WIDE_D, BUCKETS[-1]),
                        (WIDEST_D, BUCKETS[0]), (WIDEST_D, BUCKETS[-1]),
                        (POOLED_D, BUCKETS[-1])):
        smw = wide_models[d_w]
        r1, r2 = float(smw.model.rho1), float(smw.model.rho2)
        ops = decision_operands("rbf", smw, bucket, "bf16")
        nt, dp = ops[1].shape
        cfg = tiling.packed_decision_config(bucket, "bf16", dp, nt)
        kern_w = smw.spec.kernel
        ms = time_ms(lambda: dec.launch(*ops, r1, r2, kern_w, cfg)(),
                     iters=20)
        plain_ms = time_ms(lambda: decision_plain(
            *ops, r1, r2, kind="rbf", gamma=kern_w.gamma), iters=20)
        b_ms, b_by = bound((bucket + nt) * dp * 2 + 4 * (2 * nt + 2 * bucket),
                           2 * bucket * nt * dp + 2 * bucket * nt, "bf16")
        timed[("decision", bucket, nt, "bf16", d_w)] = (ms, plain_ms, b_ms,
                                                        b_by)
        streamed = ""
        if tiling.kernel_of("decision", cfg) != "stream":
            sc = next(c for c in tiling.menu("decision", precision="bf16")
                      if tiling.kernel_of("decision", c) == "stream")
            sc_ms = time_ms(lambda: dec.launch(*ops, r1, r2, kern_w, sc)(),
                            iters=20)
            streamed = f" streamed entry {sc.entry} kernel_ms={sc_ms:.4f}"
        say(f"[timing] decision bf16 d={d_w} (padded {dp}) bucket={bucket} "
            f"support={nt} config {cfg.entry} "
            f"({tiling.kernel_of('decision', cfg)}) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
            f"bound_share={b_ms / ms:.3f}{streamed}")

    # fupdate on the hot loop at the default config too (the table's
    # is timed above: the default is the one-stage tile, the table's the
    # pipelined entry the sweep chose), and on one CTA (m = 64: what a
    # launch costs in a graph beyond its work).
    for precision in ("f32", "bf16"):
        ops = fupdate_operands("rbf", M, 2 * P, precision)
        f_default_ms = time_ms(lambda: fup.launch(
            *ops, kernels["rbf"], tiling.default_config("fupdate", 2 * P))())
        f_cfg = fup.tiles(ops[0], 2 * P)
        one = fupdate_operands("rbf", 64, 2 * P, precision)
        f_one_ms = time_ms(lambda: fup.launch(
            *one, kernels["rbf"], f_cfg)())
        es = one[0].element_size()
        one_b_ms, one_b_by = bound((64 + 2 * P) * D * es
                                   + 4 * (3 * 64 + 2 * 2 * P),
                                   2 * 64 * 2 * P * D + 2 * 64 * 2 * P,
                                   precision)
        say(f"[timing] fupdate m={M} S={2 * P} d={D} rbf {precision} table "
            f"config {f_cfg.entry} ({f_cfg.source}) kernel_ms="
            f"{timed[('fupdate', M, 2 * P, precision)][0]:.4f}; default "
            f"config {tiling.default_config('fupdate', 2 * P).entry} "
            f"kernel_ms={f_default_ms:.4f}; one CTA (m=64) kernel_ms="
            f"{f_one_ms:.4f} bound_ms={one_b_ms:.6f} ({one_b_by})")
    # gram at full width, with its library call.
    for kind, precision in GRAM_TIMED:
        x = torch.as_tensor(rows[kind], device=dev)
        ops = gram_ops.prepare(x, x, precision=precision)
        kern = kernels[kind]
        cfg = gram_ops.tiles(ops[0], ops[1])
        dflt = tiling.default_config("gram", precision=precision)
        ms = time_ms(lambda: gram_ops.launch(*ops, kern)(), iters=20)
        default_ms = time_ms(lambda: gram_ops.launch(*ops, kern, dflt)(),
                             iters=20)
        plain_ms = time_ms(lambda: gram_plain(
            ops[0], ops[1], precision=precision, **plain_kw(kind)), iters=10)
        lib_ms, lib = None, "none (no one PyTorch call computes it)"
        if kind == "linear" and precision == "f32":
            lib_ms = time_ms(lambda: ops[0] @ ops[1].T, iters=20)
            lib = "x @ y.T (TF32 off)"
        elif kind == "linear":
            try:    # 16-bit operands, f32 output: one cuBLAS call, if any
                torch.mm(ops[0], ops[1].T, out_dtype=torch.float32)
                lib_ms = time_ms(lambda: torch.mm(
                    ops[0], ops[1].T, out_dtype=torch.float32), iters=20)
                lib = "torch.mm(x, y.T, out_dtype=float32)"
            except (TypeError, RuntimeError) as e:
                lib = f"none (torch.mm out_dtype: {type(e).__name__})"
        es = ops[0].element_size()
        nbytes = 2 * M * D * es + 2 * M * 4 + M * M * 4
        b_ms, b_by = bound(nbytes, 2.0 * M * M * D, precision)
        timed[("gram", kind, precision)] = (ms, plain_ms, b_ms, b_by, lib_ms)
        say(f"[timing] gram {M}x{M} d={D} {kind} {precision:4s} config "
            f"{cfg.entry} ({cfg.source}) kernel_ms={ms:.4f} default_config "
            f"{dflt.entry} ms={default_ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) bound_share={b_ms / ms:.3f} "
            f"library_ms={'none' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"[{lib}]")
        del ops
    # What sets the wgmma kernel's pace: the same output (M x M f32) from
    # d features. Were the inputs (loads, wgmma) its bound, its time would
    # grow with d; the output's bytes do not.
    pace = []
    for gd in GRAM_PACE_D:
        rows_d = torch.randn(M, gd, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(SEED))
        ops = gram_ops.prepare(rows_d, rows_d, precision="bf16")
        pace.append((gd, time_ms(lambda: gram_ops.launch(
            *ops, kernels["linear"])(), iters=20)))
        del ops
    say("[timing] gram bf16 linear at a fixed output, by feature width: "
        + ", ".join(f"d={gd} kernel_ms={ms:.4f}" for gd, ms in pace)
        + f" (output {M * M * 4 / 1e6:.0f} MB at "
        + ", ".join(f"{M * M * 4 / ms / 1e9:.3f}" for _, ms in pace)
        + " TB/s)")
    fill_out = torch.empty((M, M), device=dev)
    fill_ms = time_ms(lambda: fill_out.fill_(1.0), iters=20)
    say(f"[timing] the card's write rate: fill_ of the {M}x{M} f32 output "
        f"ms={fill_ms:.4f} ({M * M * 4 / fill_ms / 1e9:.3f} TB/s)")
    del fill_out

    scorer = sm.scorer()
    scorer.warmup()
    for bucket in BUCKETS:
        q = queries[REQUEST_SIZES[-1]][:bucket]
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            scorer.score(q)
            lat.append(time.perf_counter() - t0)
        lat.sort()
        p50 = 1e3 * lat[len(lat) // 2]
        # The host's share: what the request costs beyond the kernel's
        # device time at its bucket (query pad, copies, q norms, launch).
        k_ms = timed[("decision", bucket, sm.t_pad.shape[0], "f32")][0]
        say(f"[timing] serve score bucket={bucket} (numpy in/out, n_sv="
            f"{sm.n_sv}) p50_ms={p50:.4f} min_ms={1e3 * lat[0]:.4f} "
            f"kernel_ms={k_ms:.4f} host_ms={p50 - k_ms:.4f} "
            f"host_share={(p50 - k_ms) / p50:.3f}")
    say(f"[timing] max_memory_allocated="
        f"{torch.cuda.max_memory_allocated()} bytes")

    # -- 6. where a fit's time goes: a profiler window over one solve ------
    t0 = time.perf_counter()
    tr = _traced(lambda: repro_torch.fit(X_np, spec, strategy="auto", P=P,
                                         tol=TOL, max_outer=PROFILE_ITERS))
    _say_trace("[trace]", f"fit f32 m={M}", tr)
    say(f"[trace] the window's seconds={time.perf_counter() - t0:.2f} (the "
        f"profiler's parse of its events included)")

    f_ms, f_plain, f_b, f_by = timed[("fupdate", M, 2 * P, "f32")]
    w_s = warm_shapes["f32"][0][1]
    w_ms, w_plain, w_b, w_by = timed[("fupdate", M, w_s, "f32")]
    w16_s = warm_shapes["bf16"][0][1]
    v_ms, v_plain, v_b, v_by = timed[("fupdate", M, w16_s, "bf16")]
    e_nt = wide_models[WIDE_D].t_pad.shape[0]
    e_ms, e_plain, e_b, e_by = timed[("decision", BUCKETS[-1], e_nt, "bf16",
                                      WIDE_D)]
    d_ms, d_plain, d_b, d_by = timed[("decision", BUCKETS[-1], SUPPORT,
                                      "f32")]
    g_ms, g_plain, g_b, g_by, g_lib = timed[("gram", "linear", "f32")]
    h_ms, h_plain, h_b, h_by, h_lib = timed[("gram", "linear", "bf16")]
    say(json.dumps({"kernels": [
        {"name": "fupdate", "route": "cuda",
         "source": "src/repro_torch/csrc/fupdate.cu",
         "replaces": "src/repro/kernels/fupdate/kernel.py:30",
         "launches": launches["fupdate"], "max_abs_err": worst["fupdate"],
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_b, "bound_by": f_by,
         "library_ms": None, "pass": True,
         "shape": f"m={M} S={2 * P} d={D} rbf f32 (narrow class)",
         "launches_by_path": path_launches},
        {"name": "fupdate_wide", "route": "cuda",
         "source": "src/repro_torch/csrc/fupdate.cu",
         "replaces": "src/repro/kernels/fupdate/kernel.py:30",
         "launches": path_launches["warm"]["f32"]["wide"],
         "max_abs_err": worst["fupdate_wide"], "ms": w_ms,
         "plain_ms": w_plain, "bound_ms": w_b, "bound_by": w_by,
         "library_ms": None, "pass": True,
         "shape": f"m={M} S={w_s} d={D} rbf f32 (SIMT split class; warm "
                  f"hot loop)"},
        {"name": "fupdate_wide_bf16", "route": "cuda",
         "source": "src/repro_torch/csrc/fupdate.cu",
         "replaces": "src/repro/kernels/fupdate/kernel.py:30",
         "launches": path_launches["warm"]["bf16"]["wide"],
         "max_abs_err": worst["fupdate_wide_bf16"], "ms": v_ms,
         "plain_ms": v_plain, "bound_ms": v_b, "bound_by": v_by,
         "library_ms": None, "pass": True,
         "shape": f"m={M} S={w16_s} d={D} rbf bf16 (wgmma split class; "
                  f"warm hot loop)"},
        {"name": "decision_bf16_d768", "route": "cuda",
         "source": "src/repro_torch/csrc/decision.cu",
         "replaces": "src/repro/kernels/decision/kernel.py:27",
         "launches": serve_wide[WIDE_D],
         "max_abs_err": worst["decision_d768"], "ms": e_ms,
         "plain_ms": e_plain, "bound_ms": e_b, "bound_by": e_by,
         "library_ms": None, "pass": True,
         "shape": f"queries={BUCKETS[-1]} support={e_nt} d={WIDE_D} rbf "
                  f"bf16 ([serve-wide])"},
        {"name": "decision", "route": "cuda",
         "source": "src/repro_torch/csrc/decision.cu",
         "replaces": "src/repro/kernels/decision/kernel.py:27",
         "launches": launches["decision"], "max_abs_err": worst["decision"],
         "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_b, "bound_by": d_by,
         "library_ms": None, "pass": True,
         "launches_by_path": {"main": launches["decision"],
                              "serve-wide": path_launches["serve-wide"],
                              "fleet": path_launches["fleet"]["decision"],
                              "dist": dist_decision, "ckpt": ckpt_decision,
                              "head": head_launches["decision"],
                              "cli": cli_launches["decision"],
                              "lm": lm["launches"]["decision"],
                              "examples": {k: v["decision"] for k, v in
                                           examples.items()}},
         "shape": f"queries={BUCKETS[-1]} support={SUPPORT} d={D} rbf f32"},
        {"name": "gram", "route": "cuda",
         "source": "src/repro_torch/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram/kernel.py:27",
         "launches": tune_launches["gram"], "max_abs_err": worst["gram"],
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_b, "bound_by": g_by,
         "library_ms": g_lib, "pass": True,
         "shape": f"m=n={M} d={D} linear f32 (SIMT class)"},
        {"name": "gram_bf16", "route": "cuda",
         "source": "src/repro_torch/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram/kernel.py:27",
         "launches": tune_launches["gram_bf16"],
         "max_abs_err": worst["gram_bf16"], "ms": h_ms, "plain_ms": h_plain,
         "bound_ms": h_b, "bound_by": h_by, "library_ms": h_lib,
         "pass": True, "shape": f"m=n={M} d={D} linear bf16 (wgmma class)"},
    ] + lm["rows"] + scan_rows}))
    _say_cards_and_result()
    return 0


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--cards", type=int, default=1,
        help="run [dist] alone over this many NCCL ranks, one card each "
             "(default 1: every phase on one card)")
    args = parser.parse_args()
    sys.exit(main() if args.cards == 1 else cards_main(args.cards))
