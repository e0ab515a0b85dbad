#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage, from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit and no result line:

  1. device  — a CUDA card is required; prints its name and power limit.
  2. build   — compiles every kernel under src/repro_torch/kernels/csrc
               with nvcc (one process per source, all at once).
  3. kernels — each kernel against its plain PyTorch version on the same
               inputs, at the main path's operands and at two small ragged
               shapes (an empty row or row block, a row longer than one
               slot tile, a run that spans several tiles and three or more
               F-COO chunks, a dictionary larger than shared memory), in
               fp32 and bf16 storage, a second launch of each bit-identical
               to the first, and B5 and B6 (which write y = M w and
               w = M^T y) also against the TPU kernels' partials folded by
               the seg_rows combine, and B1-B6 against float64 oracles on
               the same stored operands, each within n u sum|terms| with
               n the longest chain of roundings in its summation order,
               the plain version's distance logged beside it (ragged:
               empty fiber rows, padding rows, a row longer than a batch,
               a packed batch spanning three or more rows);
               B1-B6 at every width they dispatch
               on (Ntheta 16, 64, 128 and 160, D in shared memory and
               from global memory), B1/B2 at row_tile 4, 8 and 16 with
               row blocks of several tiles, tiles longer than 32 slots
               and row blocks no tile visits; B1/B2 at the coo-solve
               cell's widths (Na 1,024, Ntheta 96: B1's two column
               slices of fp32 D); an empty
               F-COO Phi, which launches nothing; plus the kernel,
               kernel-sell and kernel-fcoo executors against the dense
               oracle on a small problem.
  4. main    — the single-subject solve at full width (STN96: Ntheta = 96,
               a 64^3 voxel grid, 50,000 fibers) through LifeEngine with
               the ``kernel`` executor and a compaction rebuild; the
               kernels' launch counts, the losses, and the weights against
               the ``opt`` executor on the same card.
  5. formats — the same solve with ``format="sell"`` (kernels B3/B4) and
               ``format="fcoo"`` (B5/B6), each with its launch counts,
               losses, peak memory, a torch.profiler breakdown of a step
               and weights against ``opt``; a second full sell solve and
               a second full fcoo solve each give bit-identical weights,
               and neither step runs an index_add_;
               the F-COO layout's encoded and card-resident bytes; then
               ``format="auto"`` under ``executor="kernel"`` (its measured
               rung times coo on B1, fcoo on B5, alto on its executor;
               sell is struck by its padding), whose FormatPlan and
               measured launches are logged and kept under build/learn/
               for phase 12, and whose chosen executor runs a few
               iterations.
  8. tune    — (after 5, before 6) ``tune="full"`` with
               ``compute_dtype="auto"`` on the kernel, kernel-sell and
               kernel-fcoo executors at full width, each with a fresh plan
               cache under build/: every candidate's measured cost, the
               winner and the search's seconds; a ``tune="cached"``
               rebuild that makes no measurement and gives the same plan;
               the winner's kernels against their plain versions where
               phase 3 has not held its layout; the tuned engine's
               launches and weights over 20 iterations; its step beside
               the untuned engine's.
  9. cohort  — synth_cohort(4, base_seed=0) at the main problem's size
               through BatchedLifeEngine (opt, naive, auto, and
               format="alto"), 20 iterations each, every subject against
               its own LifeEngine(opt) solve; step(10) twice equals
               run(20) bit for bit; step time, subjects per second, peak
               memory and a torch.profiler breakdown beside four single
               solves.
  10. checkpoint — the kernel engine run 50 iterations, saved through
               repro_torch.checkpoint.manager, restored into a fresh
               engine and run 50 more: bit-identical to 100 uninterrupted
               iterations; the same round trip for the cohort; the save
               and restore seconds and bytes.
  11. serve  — (after 10) a LifeService with observability on, slices of
               16 iterations, five jobs of 64: subjects 2 and 3 of phase
               9's cohort with format="sell" (B3/B4) and "fcoo" (B5/B6),
               subjects 0 and 1 with "auto" (one cohort bucket), and after
               the first tick the main problem with "auto" and priority
               1, which joins that bucket.  B3-B6's launches (2 DSC + 1.5
               WC per iteration of the solo jobs); the counter algebra at
               every tick; each solo job bit-identical to its own
               LifeEngine solve, each cohort job within the trajectory
               tolerance of its own opt solve; step histograms for every
               executor; engine.roofline.fraction of kernel-sell and
               kernel-fcoo in (0, 1.05]; then the same service killed
               after two ticks and resumed from its checkpoint by a fresh
               one, every job bit-identical to the uninterrupted run.
               Logs each job's latency, jobs/s, peak memory, the
               obs.snapshot() line, a Chrome trace under build/serve/ and
               the solo sell step with obs on and off.
  12. slice ten — (after 11) on phase 9's cohort and the main problem:
               12a learned selection: phase 5's and 8's plans, the
               format="auto" choices of subjects 0-2 under
               executor="kernel" and a tune="full" kernel-sell search on
               subject 0 train a predictor; subject 3, held out, builds
               LifeEngine(format="auto", tune="cached", executor="kernel")
               in a cache holding only predictor.json: both plans
               "predicted", 0 measurements, no autotune_plan call, 2
               learn.predict hits; 20 iterations (40 DSC + 30 WC launches)
               within the trajectory tolerance of its opt solve; a
               LifeFrontend's idle ticks then refine both plans in place.
               12b the front line (obs on, slices of 16): reject, shed and
               block at an admission bound of 2; phase 11's five jobs plus
               a tune="cached" sell job replaying phase 8's plan (no
               search) and a tune="full" fcoo job (one search); a w0 with
               a NaN (rejected), a job that raises in its cohort bucket
               (fails alone), a pending and a running job cancelled;
               events per slice; solo jobs bit-identical to their
               LifeEngine solves, cohort jobs within the trajectory
               tolerance of their opt solves; shutdown(drain=False) after
               the first slice and a fresh frontend resuming every job bit
               for bit; compact_every > 0 refused; jobs/s, latencies,
               peak memory, the admission instruments, obs.snapshot().
               12c science on the main problem: crossval (k=4, 50
               iterations) on kernel (B1/B2) below the null and within
               rtol 1e-3 of opt; a 200-fiber virtual lesion on sell
               (B3/B4) warm from phase 11's checkpoint (lesioned weights
               exactly 0, warm iterations <= cold, evidence within rtol
               1e-2 of opt); multires on fcoo (B5/B6) resumed bit for bit;
               the pruned support equal on the CPU; the lesioned problem
               resubmitted warm through the front line.  Launches: every
               solve's exactly 2 DSC + 1.5 WC per iteration (12a 40 + 30;
               12b B3/B4 128 + 96 for each 64-iteration sell job and the
               cancelled one's iterations, B5/B6 likewise for the fcoo
               jobs, the resumed legs 4 x 64 iterations; 12c B1/B2 400 +
               300, B3/B4 and B5/B6 from the iterations each solve ran,
               the resubmitted delta 32 + 24); launches inside the
               measured rung and the searches are counted apart and
               logged (their 20 ms warm-up makes them time-dependent).
  13. mesh   — (after 12) the mesh partition on the main problem:
               13a LifeEngine with executor="shard" and with format="sell"
               + executor="shard-sell" at (1, 1), 20 iterations each:
               B3/B4 launched exactly 2 DSC + 1.5 WC an iteration (one
               cell), weights within the trajectory tolerance of opt,
               shard-sell bit-identical to kernel-sell; a (2, 2) engine
               refused (4 devices against 1).  13b B3 and B4 at every
               cell shape of a (2, 2) sell partition (the common width,
               padding rows) and at an empty cell (built on purpose where
               the partition has none) against their plain versions and
               float64 oracles, each timed beside its bound, with its
               width, padding and bytes.  13c four ranks on the one card
               (fresh interpreters, gloo over CUDA tensors: NCCL refuses
               two ranks on one GPU), the partition built once in the
               parent and each rank's cell written under build/mesh:
               make_sharded_step at (2, 2) for 10 iterations within rtol
               1e-3 / atol 1e-4 of LifeEngine(opt), make_sharded_step_1d
               for 4, make_sharded_sell_ops (B3/B4 per rank, then
               all_reduce) within 1e-6 relative of the local mesh's sums;
               collective bytes per iteration (2-D below 1-D) and seconds
               per iteration, gloo through host memory.  13d one NCCL rank
               runs the 2-D step at (1, 1) for 5 iterations, bit-identical
               to the local mesh.  13e a LifeService (slices of 16) with a
               mesh=(1, 1) coo job and a sell job of 32 iterations, each
               bit-identical to its own LifeEngine(shard*) solve, again
               after a kill and resume; a mesh=(2, 2) submit refused.
  6. timing  — each kernel at the main path's shapes (CUDA events) beside
               its bound (the compulsory work of
               repro_torch/roofline/spmv_bytes.py), its plain version and
               one PyTorch library call; for B6 also the bound if every
               slot read its Y row from device memory.
  7. lm      — kernel B7 (the MoE expert FFN's grouped matmul) against its
               plain version in bf16 and fp32 at the prefill gate shape,
               the decode down shape, ragged shapes and expert layouts that
               change at every tile, unsorted and out of range; then MoE serving
               at full width: Phi-3.5-MoE cut to 8 layers (bf16, seeded
               random weights on the card), batch 4, a 512-token prompt,
               16 generated tokens through repro_torch.launch, once on B7
               and once, teacher-forced with the first run's tokens, on
               the plain expert path; B7's launches, the logits' agreement
               at every step, prefill and decode times, peak memory and a
               torch.profiler breakdown of the prefill and of one decode
               step; B7 timed at both shapes beside torch.bmm, and with
               every tile on one expert (that expert's W from L2).
  14. train  — (after 7) 14a B7's autograd Function (forward on B7, dx
               on B7 over a contiguous W^T, dW one torch.bmm) against
               autograd through the plain version at the training gate
               and down shapes (4 x 512 tokens, top-2 of 16 experts:
               capacity 320, t_tile 64) and a ragged layout, fp32 and
               bf16, a second backward bit-identical; the forward, dx,
               W^T copy and dW bmm timed.  14d (run next, before any
               profiler) reduced phi3.5-moe (fp32, B7's SIMT path) and
               reduced qwen1.5-4b through repro_torch.launch.train: 8
               steps with a checkpoint at step 4, a second main resumed
               from it, steps 5-8's losses bit for bit (1e-6 relative
               only where the profiler shows a kernel that may add with
               atomics).  14b phi3.5-moe at full width cut to 2 of 32
               layers, bf16, remat on, 6 steps of 4 x 512 tokens through
               the trainer's main: exactly 9 B7 launches per MoE layer
               per step, the loss finite and falling, step time, tokens/s,
               peak memory, a profiled step (B7 forward, dx, W^T copies,
               dW bmm by CUDA events; attention, MoE layers, optimizer
               and backward by record_function range; host gaps); the
               loss and grad_norm on the plain expert path from the same
               parameters and batch within 2e-2 relative.  14c the
               trainer's default architecture at full size
               (qwen1.5-4b, 40 layers, 8 x 128 tokens, every flag at the
               CLI's default but --steps 3): loss finite, parameters
               moved, step time, tokens/s, peak memory.
  15. long   — (after 14) sequences past 1,024 tokens; no kernel of the
               repo on this path, no library attention.  15a
               flash_attention at qwen1.5-4b's attention (20 heads, hd
               128, batch 1, 4,096 tokens, chunk 512) in fp32 and bf16:
               output and dq, dk, dv against autograd through
               dense_attention (fp32 rtol 1e-4 / atol 1e-5, bf16 2e-2 +
               2e-2 |x|), a second backward bit-identical, forward and
               forward + backward times beside scaled_dot_product_attention
               (a yardstick only) and the host's time to issue a forward;
               peak memory of both at 8,192 tokens.  15b qwen1.5-4b at
               full size (bf16): a 4,096-token prefill on flash against
               the same prefill with dense attention (2e-2 + 2e-2 |x|),
               then a 32,768-token prompt and 16 tokens through
               launch.serve.generate.  15c ssd_chunked at a mamba2-2.7b
               layer's geometry against a float64 recurrence on the card;
               mamba2-2.7b at full size: a 4,096-token prefill and 8
               decode steps against forward_train over 4,608 tokens,
               measured in bf16 and held within 2e-2 + 2e-2 |x| on a
               float32 copy of the same weights (in bf16 the decode step
               rounds where the chunked scan does not, in the reference
               as here), then 32,768 + 16 tokens.  15d zamba2-1.2b the
               same, the 32,768-token prompt with long_500k's cache
               budget of 524,288 positions.  15e mamba2-2.7b and
               zamba2-1.2b trained at full size (bf16, remat, 1 x 4,096
               tokens, 4 steps, --lr 3e-4) through the trainer's main:
               losses finite and falling, zamba2's flash calls counted;
               then reduced mamba2 and zamba2 (5 layers) resumed from a
               step-4 checkpoint, steps 5-8 bit for bit.  Prints
               {"long": ...} before the kernels line.
  16. mesh-lm — (after 15) the LM and the cohort on a (data, model) mesh:
               the trainer on one NCCL rank, four gloo ranks on the one
               card at (2, 2) against one process under a shape-only
               mesh, the elastic restart, the cohort's placement, serving
               through --model-axis 1; 16f Adafactor on the four gloo
               ranks (16b's model, steps and schedule) against one
               process under the shape-only mesh: losses, gradient norms,
               gathered weights and factors, B7's launches per rank.
               The mesh computes in the reference's tensor-parallel
               layout (column- and row-parallel projections, the
               residual stream split along the sequence, vocabulary-
               parallel embedding and loss); 16g serves phi3.5-moe at
               full width at 16b's depth through launch/serve.py
               --model-axis 2 on the four gloo ranks (4 x 128 prompts, 8
               tokens): the tokens of one process under the shape-only
               (2, 2) mesh, each rank's bytes a decode step equal to
               launch/dryrun.py's reckoning, its KV cache cache_specs'
               block.  16h the Mamba2 mixer in the same layout (column-
               parallel z, x, b, c, dt, channel-split convolutions, the
               scan on each rank's heads, a row-parallel out_proj, the
               ssm and hybrid streams split along the sequence):
               mamba2-2.7b and zamba2-1.2b at full width on the four
               gloo ranks against one process under the shape-only
               (2, 2) mesh, served at full depth through launch/serve.py
               --model-axis 2 (4 x 128 prompts, 8 tokens: the same
               tokens, the decode step's bytes equal to the reckoning,
               the ssm, conv and KV caches cache_specs' blocks) and
               trained (bf16, remat, AdamW, 16b's batch, sequence, steps
               and learning rate) cut to 4 of 64 and 8 of 38 layers:
               losses and gradient norms within 16b's limits, the bytes
               a step equal to the reckoning.  Prints {"mesh_lm": ...}.
  17. modal  — (after 16) the audio and vlm families at full width, bf16;
               no kernel of the repo on this path.  17a musicgen-large
               (48 layers): a prefill of 4 x 2,048 frame embeddings
               (flash past 1,024 positions) and 16 teacher-forced decode
               steps (the next frames fed in) through launch.steps'
               make_prefill / make_serve_step; 3 training steps at full
               depth (AdamW, remat, 4 x 1,024 frames, --lr 3e-4) through
               the trainer's main.  17b qwen2-vl-7b (28 layers): M-RoPE's
               rotated q and k on the card within 1e-5 of a float64 host
               rotation by the same float32 angles; a prefill of 2 x
               (1,024 image patches on a 32 x 32 grid at t = 0 + 1,024
               tokens), 16 greedy decode steps with the positions
               continued; 3 training steps with the layers cut to what
               the card holds.  In each family a float32 model at full
               width and 4 layers: a prefill past 1,024 positions and 8
               decode steps within 2e-2 + 2e-2 |x| of forward_train's
               logits at the same positions.  Losses finite and falling;
               prefill seconds, decode ms a step, tokens/s, step ms and
               peak memory.  Prints {"modal": ...}.
  18. examples — (after 17) the eight example programs of
               src/repro_torch/examples, each through its main with
               --device cuda and the reference example's default arguments
               (4 subjects for the serving ones; train_lm's checkpoints in
               a fresh directory under build/examples/, removed after):
               18a python -m repro_torch.examples.quickstart in a fresh
               interpreter (exit 0, its first line names the card), 18b
               quickstart's main, 18c quickstart on phase 4's problem
               (STN96 at 50,000 fibers, kept on the host since phase 6),
               18d serve_subjects, 18e serve_life (B3/B4's launches around
               it > 0, its SELL tenant within the trajectory tolerance of
               the same job on opt/coo), 18f serve_async (the statuses and
               counters its story gives), 18g prune_connectome, 18h
               distributed_life (the (4, 2) partition as 8 gloo ranks on
               the one card), 18i serve_lm, 18j train_lm (200 steps of
               the ~100M llama, the loss falling).  Each example's own
               assertions hold; its seconds and the numbers it prints are
               logged.  Prints {"examples": ...}.
 19. trace   — 14b's and 14c's train steps (each measured by one more
               step after its run: the growth of allocated memory over
               the state and batch, max_memory_allocated() after
               reset_peak_memory_stats() less memory_allocated() before,
               and its CUDA-event time) traced on tensors without data
               (roofline/trace_cost.py through launch.dryrun.trace_step):
               the measured growth within 10% of the trace's
               peak_temp_bytes; the traced FLOPs and bytes over the
               measured time (achieved TFLOP/s, TB/s) and the trace's own
               seconds, printed.  Prints {"trace": ...}.
 20. life-trace — (after 19) the 2-D and 1-D SBBNNLS steps of phase 13d
               (make_sharded_step on the (1, 1) LocalMesh's
               sharded_state, make_sharded_step_1d on
               build_life_shards_1d(phi, 1); each measured by one more odd
               and one more even iteration, as phase 19's steps are)
               traced on meta copies of the same operands through the dry
               run's launch.dryrun.trace_life: each measured growth within
               10% of the trace's peak_temp_bytes; the traced FLOPs and
               bytes over the measured time, printed.  Prints
               {"life_trace": ...}.
 21. configs — (after 20) the published configurations no earlier phase
               runs, bf16 at their widths, seeded weights drawn on the
               card (normal_init first held to the bits of the formula it
               replaced), each at the deepest stack the dry run's trace
               (launch.dryrun.trace_step, printed before the model is
               built) and its largest float32 draw fit on the card, its
               measured peak printed beside the trace.  21a kimi-k2 (2 of
               61 layers: the dense first layer and one MoE layer of 384
               experts, top-8, a shared expert, head_dim 112) served as
               phase 7 serves phi3.5-moe: 4 x 512 + 16 tokens, 3 B7
               launches per MoE layer per forward, B7 on the path's own
               activations, the plain expert path's logits on the steps
               routed alike, a profile; B7 timed at its prefill gate
               (t_tile 8) and decode down shapes.  21b granite-34b (88
               layers, multi-query, learned positions, LayerNorm, GELU),
               21d stablelm-12b (head_dim 160), 21e deepseek-7b: 4 x 512
               + 16 tokens and a profiled decode step; a 2,048-token
               prefill (flash in every layer) and 8 decode steps against
               forward_train, measured in bf16 at full depth and held
               within 2e-2 + 2e-2 |x| on a float32 copy of the first 4
               layers.  21c granite-34b through the trainer at its
               defaults (8 x 128, 3 steps) but --lr 1e-5, cut to the
               deepest stack within 70 GB by the trace: losses finite and
               falling, step 0's batch's loss lower after the steps than
               before, weights moved; that loss's backward: the learned
               position table's gradient nonzero on exactly the rows the
               batch reads, wk's and wv's nonzero.  21f flash at S 4,096
               at kimi-k2's (KV 8, group 8, hd 112), stablelm-12b's (KV
               8, group 4, hd 160) and granite-34b's (KV 1, group 48, hd
               128) geometries: held in fp32 within 1e-4 / 1e-5 of causal
               attention computed in float64 (dense_attention's fp32
               distance logged beside it); in bf16 against dense_attention
               as 15a, measured (there dense_attention's own bf16
               gradients lie beyond 2e-2 + 2e-2 |x| of float32's) and
               timed beside SDPA.  Prints {"configs": ...}.

Then it prints phases 15-21's JSON lines, one JSON line describing the
kernels, the card's name and power limit as nvidia-smi gives them, and,
last, the result line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: fp32 tolerance of the conformance matrix (tests/test_conformance.py:77)
FP32_TOL = dict(rtol=2e-4, atol=2e-5)
#: the conformance trajectory bound for weights (tests/test_conformance.py)
TRAJ_TOL = dict(rtol=2e-2, atol=2e-3)
#: shared memory one block may opt in to on an H100 (227 KB)
SMEM_OPTIN_BYTES = 232_448

MAIN_PROBLEM = dict(n_fibers=50_000, n_theta=96, n_atoms=96,
                    grid=(64, 64, 64), algorithm="PROB", seed=0)
MAIN_ITERS = 100
COMPACT_EVERY = 50
TIMED_LAUNCHES = 20
AUTO_ITERS = 10

REDUCED = ("reduced: coefficients per fiber {:.1f} (the generator's "
           "streamlines) vs ~1000 at the dry run's scales "
           "(launch/dryrun.py:139-143); the generator is a pure-Python loop "
           "and runs at this size in tens of seconds")

KERNELS = {
    "dsc_coo": dict(source="src/repro_torch/kernels/csrc/dsc.cu",
                    replaces="src/repro/kernels/dsc.py:94"),
    "wc_coo": dict(source="src/repro_torch/kernels/csrc/wc.cu",
                   replaces="src/repro/kernels/wc.py:77"),
    "dsc_sell": dict(source="src/repro_torch/kernels/csrc/dsc_sell.cu",
                     replaces="src/repro/kernels/dsc.py:152"),
    "wc_sell": dict(source="src/repro_torch/kernels/csrc/wc_sell.cu",
                    replaces="src/repro/kernels/wc.py:136"),
    "dsc_fcoo": dict(source="src/repro_torch/kernels/csrc/dsc_fcoo.cu",
                     replaces="src/repro/kernels/fcoo.py:65"),
    "wc_fcoo": dict(source="src/repro_torch/kernels/csrc/wc_fcoo.cu",
                    replaces="src/repro/kernels/fcoo.py:116"),
}
KERNELS["moe_gmm"] = dict(source="src/repro_torch/kernels/csrc/moe_gmm.cu",
                          replaces="src/repro/kernels/moe_gmm.py:33")
#: csrc/wc_sell.cu's kMinRows and kWarps: B4 gives each warp exactly
#: kMinRows fiber rows while blocks of kWarps such warps need no more blocks
#: than the card has SMs
WC_SELL_MIN_ROWS, WC_SELL_WARPS = 8, 16
#: unit roundoff of float32
U32 = 2.0 ** -24
#: the two kernels each full-width path runs, by LifeConfig.format
PATH_KERNELS = {"coo": ("dsc_coo", "wc_coo"), "sell": ("dsc_sell", "wc_sell"),
                "fcoo": ("dsc_fcoo", "wc_fcoo")}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def bf16_tol() -> dict:
    """The bf16-storage contract (repro_torch/tune/plan.py)."""
    from repro_torch.tune.plan import BF16_ATOL, BF16_RTOL
    return dict(rtol=BF16_RTOL, atol=BF16_ATOL)


# ----------------------------------------------------------------------------
# 1. device
# ----------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    # fp32 everywhere: no TF32 in matrix products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ----------------------------------------------------------------------------
# 2. build
# ----------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    seconds = _build.build()
    log("build", f"{len(seconds)} kernels in {time.perf_counter() - t0:.2f} s "
        f"(per source: {', '.join(f'{k} {v:.2f} s' for k, v in seconds.items())})")
    # one line per kernel: its name (demangled by the toolkit's cu++filt
    # where it has one), registers, shared memory and spills
    rows = []
    for name in seconds:
        path = _build.log_path(name)
        if not path.exists():
            continue
        entry = spills = ""
        for line in path.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                rows.append((name, entry,
                             f"{line.split(':', 1)[1].strip()}; {spills}"))
    filt = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    names = [entry for _, entry, _ in rows]
    if rows and os.path.exists(filt):
        names = subprocess.run([filt, *names], capture_output=True, text=True,
                               check=True, timeout=60).stdout.splitlines()
    for (name, _, usage), entry in zip(rows, names, strict=True):
        log("build", f"{name}: {entry}: {usage}")


# ----------------------------------------------------------------------------
# 3. kernels against their plain versions
# ----------------------------------------------------------------------------

def random_phi(nc: int, na: int, nv: int, nf: int, seed: int, *,
               hot: int = 0, skip_blocks: tuple = (), row_tile: int = 8):
    """A random Phi on the card, made with numpy from ``seed``.

    ``hot`` extra coefficients all land on voxel 3 and fiber 5 (a run that
    spans several tiles in both ops); voxels and fibers in the row blocks
    ``skip_blocks`` get no coefficient (row blocks no tile visits)."""
    from repro_torch.core.std import PhiTensor
    r = np.random.default_rng(seed)
    skipped = np.asarray([b * row_tile + i for b in skip_blocks
                          for i in range(row_tile)], np.int64)

    def ids(n, hot_id):
        allowed = np.setdiff1d(np.arange(n), skipped)
        return np.concatenate([r.choice(allowed, nc), np.full(hot, hot_id)])

    atoms = r.integers(0, na, nc + hot)
    voxels, fibers = ids(nv, 3), ids(nf, 5)
    values = r.normal(size=nc + hot)

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device="cuda")

    return PhiTensor(atoms=t(atoms, torch.int32), voxels=t(voxels, torch.int32),
                     fibers=t(fibers, torch.int32),
                     values=t(values, torch.float32),
                     n_atoms=na, n_voxels=nv, n_fibers=nf)


def kernel_operands(phi, *, c_tile: int, row_tile: int, compute_dtype: str):
    """The two kernels' operands for ``phi``, as the kernel executor builds
    them (output-side sorts, tile plans, padded tiles)."""
    from repro_torch.core.inspector import plan_tiles
    from repro_torch.core.restructure import sort_by_host
    from repro_torch.kernels.ops import coo_tiles
    phi_v, _ = sort_by_host(phi, "voxel")
    phi_w, _ = sort_by_host(phi, "fiber")
    dsc_plan = plan_tiles(phi_v.voxels.cpu().numpy(), phi.n_voxels,
                          c_tile=c_tile, row_tile=row_tile)
    wc_plan = plan_tiles(phi_w.fibers.cpu().numpy(), phi.n_fibers,
                         c_tile=c_tile, row_tile=row_tile)
    return (coo_tiles(phi_v, dsc_plan, phi_v.fibers, phi.n_voxels,
                      compute_dtype=compute_dtype),
            coo_tiles(phi_w, wc_plan, phi_w.voxels, phi.n_fibers,
                      compute_dtype=compute_dtype))


def run_dsc(t, d, w, plain: bool = False):
    from repro_torch.kernels import dsc
    fn = dsc.dsc_coo_plain if plain else dsc.dsc_coo
    return fn(t.tile_ptr, t.tile_len, t.atoms_p, t.others_p, t.values_p,
              t.local_row_p, d, w, row_tile=t.row_tile)


def run_wc(t, d, y, plain: bool = False):
    from repro_torch.kernels import wc
    fn = wc.wc_coo_plain if plain else wc.wc_coo
    return fn(t.tile_ptr, t.tile_len, t.atoms_p, t.others_p, t.values_p,
              t.local_row_p, d, y, row_tile=t.row_tile)


def compare(name: str, case: str, got, want, dtype: str, errors: dict) -> None:
    torch.cuda.synchronize()
    tol = FP32_TOL if dtype == "fp32" else bf16_tol()
    diff = (got - want).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    big = want.abs() > tol["atol"]      # relative error where it means one
    max_rel = float((diff[big] / want.abs()[big]).max()) if big.any() else 0.0
    log("kernels", f"{name} {case} {dtype}: max abs err {max_abs:.3e}, "
        f"max rel err {max_rel:.3e} where |plain| > atol (rtol "
        f"{tol['rtol']}, atol {tol['atol']})")
    torch.testing.assert_close(got, want, **tol)
    errors[name] = max(errors.get(name, 0.0), max_abs)


def check_kernels(case: str, phi, d32, *, c_tile: int, row_tile: int,
                  errors: dict, seed: int) -> dict:
    """Both kernels against their plain versions on ``phi``, fp32 and bf16
    storage.  Returns the shape facts this case exercised, each a
    (dsc, wc) pair where it differs by op."""
    from repro_torch.kernels.ops import storage_cast
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.rand(phi.n_fibers, generator=g, device="cuda")
    y = torch.randn(phi.n_voxels, d32.shape[1], generator=g, device="cuda")
    facts = {}
    for dtype in ("fp32", "bf16"):
        t_dsc, t_wc = kernel_operands(phi, c_tile=c_tile, row_tile=row_tile,
                                      compute_dtype=dtype)
        d = storage_cast(d32, dtype).contiguous()
        got = run_dsc(t_dsc, d, w)
        got_wc = run_wc(t_wc, d, y)
        plain = run_dsc(t_dsc, d, w, plain=True)
        plain_wc = run_wc(t_wc, d, y, plain=True)
        compare("dsc_coo", case, got, plain, dtype, errors)
        compare("wc_coo", case, got_wc, plain_wc, dtype, errors)
        hold_to_oracle("dsc_coo", case, dtype, got, plain,
                       *coo_oracle("dsc", t_dsc, d, w, got.shape[0]))
        hold_to_oracle("wc_coo", case, dtype, got_wc, plain_wc,
                       *coo_oracle("wc", t_wc, d, y, got_wc.shape[0]))
        # no atomics, one summation order: a second launch is bit-identical
        if not (torch.equal(got, run_dsc(t_dsc, d, w))
                and torch.equal(got_wc, run_wc(t_wc, d, y))):
            raise AssertionError(f"{case} {dtype}: a second launch differs")
        # row blocks no tile visits come out exactly zero
        spans, empty = [], []
        for name, t, out in (("dsc_coo", t_dsc, got), ("wc_coo", t_wc,
                                                        got_wc)):
            span = t.tile_ptr.diff().cpu()
            none = torch.nonzero(span == 0).flatten()
            rows = (none[:, None] * row_tile
                    + torch.arange(row_tile)[None, :]).flatten().cuda()
            if torch.count_nonzero(out[rows]).item():
                raise AssertionError(f"{name} {case}: unvisited row block is "
                                     "not zero")
            spans.append(span)
            empty.append(int(none.numel()))
        facts = dict(row_tile=row_tile, n_theta=int(d32.shape[1]),
                     empty_row_blocks=tuple(empty),
                     max_tiles_per_row_block=tuple(int(sp.max())
                                                   for sp in spans),
                     longest_tile=(int(t_dsc.tile_len.max()),
                                   int(t_wc.tile_len.max())),
                     dict_bytes={dt: d32.numel() * sz for dt, sz in
                                 (("fp32", 4), ("bf16", 2))})
    log("kernels", f"{case}: {facts}")
    return facts


def check_ragged_edges(case: str, facts: dict) -> None:
    """In both ops: a row block no tile visits, a row block of two or more
    tiles and a tile longer than one batch of 32 slots."""
    if (min(facts["empty_row_blocks"]) == 0
            or min(facts["max_tiles_per_row_block"]) < 2
            or min(facts["longest_tile"]) <= 32):
        raise AssertionError(f"{case} did not exercise its edges: {facts}")


def format_operands(phi, *, c_tile: int, row_tile: int, compute_dtype: str,
                    slot_tile: int = 32):
    """The four format kernels' layouts and device operands for ``phi``, as
    the kernel-sell and kernel-fcoo executors build them."""
    from repro_torch.formats.fcoo import FcooPhi
    from repro_torch.formats.sell import SellPhi
    from repro_torch.kernels import ops
    sd = SellPhi.encode(phi, op="dsc", row_tile=row_tile, slot_tile=slot_tile)
    sw = SellPhi.encode(phi, op="wc", row_tile=row_tile, slot_tile=slot_tile)
    fc = FcooPhi.encode(phi, c_tile=c_tile)
    return (sd, sw, fc,
            dict(dsc_sell=ops.sell_operands(sd, "cuda",
                                            compute_dtype=compute_dtype),
                 wc_sell=ops.sell_operands(sw, "cuda",
                                           compute_dtype=compute_dtype),
                 fcoo=ops.fcoo_operands(fc, "cuda",
                                        compute_dtype=compute_dtype)))


def run_format(name: str, o, d, x, plain: bool = False):
    """Format kernel ``name`` (or its plain version) on operands ``o``."""
    from repro_torch.kernels import dsc, fcoo, wc
    if name == "dsc_sell":
        fn = dsc.dsc_sell_plain if plain else dsc.dsc_sell
        return fn(o.atoms, o.others, o.values, o.row_nnz, d, x,
                  row_tile=o.row_tile)
    if name == "wc_sell":
        fn = wc.wc_sell_plain if plain else wc.wc_sell
        return fn(o.atoms, o.others, o.values, o.row_nnz, d, x)
    if name == "dsc_fcoo":
        fn = fcoo.dsc_fcoo_fused_plain if plain else fcoo.dsc_fcoo
        return fn(o.atoms, o.fibers, o.values, o.voxels, d, x,
                  n_voxels=o.n_voxels)
    fn = fcoo.wc_fcoo_fused_plain if plain else fcoo.wc_fcoo
    return fn(o.wc_perm, o.wc_fibers, o.atoms.reshape(-1),
              o.voxels.reshape(-1), o.values.reshape(-1), d, x,
              n_fibers=o.n_fibers)


def runs_across_chunks(fc, op: str) -> int:
    """Output rows whose run of one op continues from a chunk into the
    next (the case the carries and the ordered fold exist for)."""
    seg_rows = fc.seg_rows_dsc if op == "dsc" else fc.seg_rows_wc
    ranks = (fc.dsc_ranks if op == "dsc" else fc.wc_ranks).reshape(
        fc.n_chunks, fc.c_tile)
    last = seg_rows[np.arange(fc.n_chunks), ranks[:, -1]]
    return int(np.sum(last[:-1] == seg_rows[1:, 0]))


def longest_run_chunks(fc, op: str) -> int:
    """The most chunks one output row's run of one op touches."""
    ids = fc.voxels if op == "dsc" else fc.fibers[fc.wc_perm]
    chunk = np.arange(ids.size) // fc.c_tile
    _, first = np.unique(ids, return_index=True)
    last = ids.size - 1 - np.unique(ids[::-1], return_index=True)[1]
    return int((chunk[last] - chunk[first]).max(initial=-1) + 1)


def sell_batch_rows(sw):
    """The most fiber rows one of B4's packed batches spans (csrc/common.cuh:
    SellWalk packs the real slots of a warp's rows into batches of 32), or
    None where the rows are too many for each warp to own
    WC_SELL_MIN_ROWS of them."""
    rows_padded = sw.atoms.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if rows_padded > sms * WC_SELL_WARPS * WC_SELL_MIN_ROWS:
        return None
    rows = np.repeat(np.arange(sw.row_nnz.size), sw.row_nnz)
    warp = rows // WC_SELL_MIN_ROWS
    pos = np.arange(rows.size) - np.searchsorted(warp, warp)  # in the warp
    batch = warp * (sw.width * WC_SELL_MIN_ROWS) + pos // 32
    pairs = np.unique(np.stack([batch, rows]), axis=1)
    return int(np.unique(pairs[0], return_counts=True)[1].max(initial=0))


def dot_chain(n_theta: int) -> int:
    """Roundings of one slot's dot product in B2, B4 and B6
    (common.cuh:batch_dots): a lane's products, ceil(Ntheta / 8) columns or
    4 per float4, then a 3-step shuffle tree."""
    return max(-(-n_theta // 8), 4 * -(-n_theta // 32)) + 3


def run_stats(ids, chunk_of=None):
    """Per output id of a stream: (slots, chunks or tiles the id's slots
    lie in), each a numpy array over the ids present."""
    ids = ids.long()
    lengths = torch.bincount(ids)
    present = torch.nonzero(lengths).flatten()
    if chunk_of is None:
        return lengths[present].cpu().numpy(), None
    pairs = torch.unique(torch.stack([ids, chunk_of.long()]), dim=1)
    spans = torch.bincount(pairs[0], minlength=lengths.numel())
    return lengths[present].cpu().numpy(), spans[present].cpu().numpy()


def dsc_oracle(rows, a, f, val, d, w, n_out: int):
    """y = M w in float64 over the given slots, and sum |terms| per
    element."""
    da = d.double()[a]
    sc = w.double()[f] * val.double()
    want = torch.zeros(n_out, d.shape[1], dtype=torch.float64,
                       device="cuda").index_add_(0, rows, da * sc[:, None])
    scale = torch.zeros_like(want).index_add_(
        0, rows, da.abs() * sc.abs()[:, None])
    return want, scale


def wc_oracle(rows, a, v, val, d, y, n_out: int):
    """w = M^T y in float64 over the given slots, and sum |terms| per
    fiber."""
    da, yv = d.double()[a], y.double()[v]
    val = val.double()
    want = torch.zeros(n_out, dtype=torch.float64, device="cuda").index_add_(
        0, rows, (da * yv).sum(1) * val)
    scale = torch.zeros_like(want).index_add_(
        0, rows, (da.abs() * yv.abs()).sum(1) * val.abs())
    return want, scale


def coo_oracle(op: str, t, d, x, n_out: int):
    """B1 (op "dsc") or B2 ("wc") in float64 over a tile layout's real
    slots, with the longest rounding chain n of the kernel's order.  B1:
    w * value, then one FMA per slot of the row in slot order (n = the
    longest row + 2).  B2: a slot's dot and its value, a 5-level segmented
    scan within a batch of 32 slots, a carry per batch, batches in slot
    order and at most one more batch per tile the row spans."""
    n_tiles, c_tile = t.atoms_p.shape
    dev = t.atoms_p.device
    tile_rb = torch.searchsorted(t.tile_ptr.long(),
                                 torch.arange(n_tiles, device=dev),
                                 right=True) - 1
    real = torch.arange(c_tile, device=dev)[None, :] < t.tile_len[:, None]
    rows = (tile_rb[:, None] * t.row_tile + t.local_row_p)[real]
    tiles = torch.arange(n_tiles, device=dev)[:, None].expand(-1, c_tile)[real]
    a, o, val = t.atoms_p[real].long(), t.others_p[real].long(), \
        t.values_p[real]
    lengths, spans = run_stats(rows, tiles)
    if op == "dsc":
        want, scale = dsc_oracle(rows, a, o, val, d, x, n_out)
        n = int(lengths.max(initial=0)) + 2
    else:
        want, scale = wc_oracle(rows, a, o, val, d, x, n_out)
        n = dot_chain(d.shape[1]) + 1 + 5 + int(
            (-(-lengths // 32) + spans).max(initial=0))
    return want, scale, n


def format_oracle(name: str, o, d, x, n_out: int):
    """B3-B6 in float64 over their operands' slots (F-COO padding slots
    hold value 0), with the longest rounding chain n of each order.  B3:
    w * value, then one FMA per slot of the row (n = the longest row + 2).
    B4: a slot's dot and value, 5 scan levels, a carry per batch of 32 the
    row spans.  B5: w * value, an FMA per slot of the run within a chunk,
    then the run's carries added in chunk order (n = run + chunks + 2).
    B6: as B4 within a chunk (an open batch at each chunk edge), then the
    carries in chunk order.  Runs are counted over slots of nonzero value:
    a padding slot adds an exact 0."""
    from repro_torch.kernels.dsc import sell_slots
    if name in ("dsc_sell", "wc_sell"):
        real, rows = sell_slots(o.atoms, o.row_nnz)
        rows, a, other = rows[real], o.atoms[real].long(), \
            o.others[real].long()
        val = o.values[real]
        longest = int(o.row_nnz.max()) if o.row_nnz.numel() else 0
        if name == "dsc_sell":
            return (*dsc_oracle(rows, a, other, val, d, x, n_out),
                    longest + 2)
        return (*wc_oracle(rows, a, other, val, d, x, n_out),
                dot_chain(d.shape[1]) + 1 + 5 + -(-longest // 32))
    # a slot of value 0 (the padding) adds an exact 0: no rounding
    c_tile = o.atoms.shape[1]
    chunk = torch.arange(o.atoms.numel(), device=o.atoms.device) // c_tile
    a, v, f = (t.reshape(-1).long() for t in (o.atoms, o.voxels, o.fibers))
    val = o.values.reshape(-1)
    if name == "dsc_fcoo":
        live = val != 0
        lengths, spans = run_stats(v[live], chunk[live])
        return (*dsc_oracle(v, a, f, val, d, x, n_out),
                int((lengths + spans).max(initial=0)) + 2)
    perm = o.wc_perm.reshape(-1).long()
    live = val[perm] != 0
    lengths, spans = run_stats(o.wc_fibers.reshape(-1)[live], chunk[live])
    return (*wc_oracle(f, a, v, val, d, x, n_out),
            dot_chain(d.shape[1]) + 1 + 5 + int(
                (-(-lengths // 32) + 2 * spans).max(initial=0)))


def hold_to_oracle(name: str, case: str, dtype: str, got, plain, want,
                   scale, n: int) -> None:
    """``got`` against a float64 oracle on the same stored operands:
    |error| at most n * u * sum |terms| per output element, n the
    kernel's longest chain of float32 roundings.  The plain version's
    distance is logged beside it, not held."""
    err = (got.double() - want).abs()
    plain_err = (plain.double() - want).abs()

    def units(e) -> float:
        if not e.numel():
            return 0.0
        return float((e / (U32 * scale.clamp_min(1e-300))).max())

    log("kernels", f"{name} {case} {dtype} vs float64 oracle: max |err| "
        f"{units(err):.2f} u * sum|terms| (bound {n} u); plain version "
        f"{units(plain_err):.2f} u")
    if not bool((err <= n * U32 * scale + 1e-30).all()):
        raise AssertionError(f"{name} {case} {dtype}: off the float64 "
                             f"oracle by more than {n} u * sum|terms|")


def check_format_kernels(case: str, phi, d32, *, c_tile: int, row_tile: int,
                         errors: dict, seed: int, slot_tile: int = 32) -> dict:
    """B3-B6 against their plain versions on ``phi``, fp32 and bf16
    storage.  Returns the shape facts this case exercised."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import storage_cast
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.rand(phi.n_fibers, generator=g, device="cuda")
    y = torch.randn(phi.n_voxels, d32.shape[1], generator=g, device="cuda")
    for dtype in ("fp32", "bf16"):
        sd, sw, fc, o = format_operands(phi, c_tile=c_tile,
                                        row_tile=row_tile,
                                        compute_dtype=dtype,
                                        slot_tile=slot_tile)
        d = storage_cast(d32, dtype).contiguous()
        for name, ops_, x in (("dsc_sell", o["dsc_sell"], w),
                              ("wc_sell", o["wc_sell"], y),
                              ("dsc_fcoo", o["fcoo"], w),
                              ("wc_fcoo", o["fcoo"], y)):
            got = run_format(name, ops_, d, x)
            plain = run_format(name, ops_, d, x, plain=True)
            compare(name, case, got, plain, dtype, errors)
            # no atomics, one summation order: a second launch is identical
            if not torch.equal(got, run_format(name, ops_, d, x)):
                raise AssertionError(f"{name} {case} {dtype}: a second "
                                     "launch differs")
            hold_to_oracle(name, case, dtype, got, plain,
                           *format_oracle(name, ops_, d, x, got.shape[0]))
            if name in ("dsc_fcoo", "wc_fcoo"):
                # the fused B5 / B6 against the TPU kernel's partials
                # (plain) folded by the seg_rows combine
                folded = (ops.fcoo_dsc_folded if name == "dsc_fcoo"
                          else ops.fcoo_wc_folded)
                compare(name, f"{case} vs partials + combine", got,
                        folded(fc, ops_, d, x), dtype, {})
    facts = dict(
        empty_rows=int(np.sum(sd.row_nnz == 0) + np.sum(sw.row_nnz == 0)),
        longest_row=int(max(sd.row_nnz.max(initial=0),
                            sw.row_nnz.max(initial=0))),
        slot_tile=sd.slot_tile, sell_widths=(sd.width, sw.width),
        fcoo_chunks=fc.n_chunks, k=(fc.k_dsc, fc.k_wc),
        runs_across_chunks=(runs_across_chunks(fc, "dsc"),
                            runs_across_chunks(fc, "wc")),
        longest_run_chunks=(longest_run_chunks(fc, "dsc"),
                            longest_run_chunks(fc, "wc")),
        wc_empty_rows=int(np.sum(sw.row_nnz == 0)),
        wc_longest_row=int(sw.row_nnz.max(initial=0)),
        wc_padding_rows=sw.atoms.shape[0] - sw.n_rows,
        wc_batch_rows=sell_batch_rows(sw))
    log("kernels", f"{case} (formats): {facts}")
    return facts


def check_coo_solve_shape(errors: dict) -> None:
    """B1 and B2 at the widths of life_bench's ``ifod1-500k.coo-solve``
    (Na 1,024, Ntheta 96, c_tile 256, row_tile 8) on a ragged Phi: B1 holds
    fp32 D as two column slices of shared memory (``dsc.col_slices``) and
    bf16 D whole."""
    from repro_torch.kernels import _build, dsc
    optin = _build.smem_optin_bytes(torch.device("cuda"))
    slices = [dsc.col_slices(1024, 96, size, optin) for size in (4, 2)]
    if slices != [2, 1]:
        raise AssertionError(f"coo-solve widths: B1 takes {slices} column "
                             "slices in fp32 / bf16, expected [2, 1]")
    d = torch.as_tensor(np.random.default_rng(6).normal(size=(1024, 96)),
                        dtype=torch.float32, device="cuda")
    # 25 coefficients a voxel and 20 a fiber, as in the cases above: at 100
    # a fiber, B2's fp32 sums (|terms| ~770 a row) round past FP32_TOL on
    # their smallest rows in any order (the plain version's own error from
    # float64 reaches a third of it)
    phi = random_phi(400_000, 1024, 16_000, 20_000, seed=6, hot=700,
                     skip_blocks=(10, 11, 20))
    check_ragged_edges("coo-solve-widths", check_kernels(
        "coo-solve-widths", phi, d, c_tile=256, row_tile=8, errors=errors,
        seed=19))


def check_empty_fcoo() -> None:
    """An empty Phi: the F-COO ops launch nothing and give zeros."""
    from repro_torch.formats.fcoo import FcooPhi
    from repro_torch.kernels import _build, ops
    fc = FcooPhi.encode(random_phi(0, 8, 20, 10, seed=4))
    before = dict(_build.LAUNCHES)
    matvec, rmatvec = ops.make_fcoo_ops(
        fc, torch.randn(8, 16, device="cuda"))
    y = matvec(torch.rand(10, device="cuda"))
    w = rmatvec(torch.randn(20, 16, device="cuda"))
    torch.cuda.synchronize()
    if (tuple(y.shape), tuple(w.shape)) != ((20, 16), (10,)) \
            or y.count_nonzero() or w.count_nonzero() \
            or dict(_build.LAUNCHES) != before:
        raise AssertionError("empty F-COO Phi: expected zeros and no launch")
    log("kernels", "empty F-COO Phi: zeros of shape (Nv, Ntheta) and (Nf,), "
        "no launch")


def check_small_engine() -> None:
    """The kernel executors against the dense oracle on a small problem."""
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.core.std import materialize_dense
    from repro_torch.data.dmri import synth_connectome
    p = synth_connectome(n_fibers=64, n_theta=16, n_atoms=24,
                         grid=(10, 10, 10), seed=1, device="cuda")
    m = materialize_dense(p.phi, p.dictionary).double()
    g = torch.Generator(device="cuda").manual_seed(3)
    w = torch.rand(p.phi.n_fibers, generator=g, device="cuda")
    y = torch.randn(p.phi.n_voxels, 16, generator=g, device="cuda")
    for executor in ("kernel", "kernel-sell", "kernel-fcoo"):
        eng = LifeEngine(p, LifeConfig(executor=executor, c_tile=64,
                                       plan_cache_dir=""), device="cuda")
        got_mv = eng.matvec(w).double().reshape(-1)
        got_rmv = eng.rmatvec(y).double()
        torch.cuda.synchronize()
        torch.testing.assert_close(got_mv, m @ w.double(), **FP32_TOL)
        torch.testing.assert_close(got_rmv, m.T @ y.double().reshape(-1),
                                   **FP32_TOL)
        log("kernels", f"small problem: {executor} executor matches the "
            f"dense oracle (max abs err matvec "
            f"{float((got_mv - m @ w.double()).abs().max()):.3e}, rmatvec "
            f"{float((got_rmv - m.T @ y.double().reshape(-1)).abs().max()):.3e})")


def phase_kernels(problem, errors: dict) -> None:
    check_kernels("main-path", problem.phi, problem.dictionary, c_tile=256,
                  row_tile=8, errors=errors, seed=11)
    check_format_kernels("main-path", problem.phi, problem.dictionary,
                         c_tile=256, row_tile=8, errors=errors, seed=14)
    g = np.random.default_rng(2)
    ragged = random_phi(6000, 96, 1000, 300, seed=1, hot=700,
                        skip_blocks=(10, 11, 20))
    ragged_d = torch.as_tensor(g.normal(size=(96, 37)), dtype=torch.float32,
                               device="cuda")
    check_ragged_edges("ragged", check_kernels(
        "ragged", ragged, ragged_d, c_tile=64, row_tile=8, errors=errors,
        seed=12))
    facts = check_format_kernels("ragged", ragged, ragged_d, c_tile=64,
                                 row_tile=8, errors=errors, seed=15)
    # B4's edges: empty fiber rows, a row of more than one batch, padding
    # rows past n_rows, a packed batch spanning three or more rows
    if (facts["empty_rows"] == 0 or facts["longest_row"] <= facts["slot_tile"]
            or min(facts["runs_across_chunks"]) == 0
            or min(facts["longest_run_chunks"]) < 3
            or facts["wc_empty_rows"] == 0 or facts["wc_longest_row"] <= 32
            or facts["wc_padding_rows"] == 0
            or (facts["wc_batch_rows"] or 0) < 3):
        raise AssertionError("ragged case did not exercise the format "
                             f"kernels' edges: {facts}")
    big_d = torch.as_tensor(g.normal(size=(2048, 96)), dtype=torch.float32,
                            device="cuda")
    big = random_phi(20000, 2048, 3001, 999, seed=3, hot=300)
    facts = check_kernels("large-dictionary", big, big_d, c_tile=128,
                          row_tile=4, errors=errors, seed=13)
    # D does not fit whole in shared memory: B2-B6 read it from global
    # memory, B1 holds it as column slices (4 in fp32, 2 in bf16)
    if min(facts["dict_bytes"].values()) <= SMEM_OPTIN_BYTES:
        raise AssertionError("large-dictionary case fits whole in shared "
                             "memory")
    check_format_kernels("large-dictionary", big, big_d, c_tile=128,
                         row_tile=4, errors=errors, seed=16)
    # every width that the B1-B6 kernels dispatch on, with D staged in
    # shared memory (96 atoms) and read from global memory (8192 atoms;
    # B1 holds it as column slices at Ntheta 16, 4 in fp32 and 2 in bf16,
    # and at 64 in bf16, 8 of them: dsc.col_slices):
    # Ntheta 16, 64 and 128 take B2's and B6's float4 paths of 1, 2 and 4
    # vectors per lane and B1's read-only-cache path and B3's 1, 2 and 4
    # columns per lane, 160 B2's and B6's scalar path and B1's and B3's
    # two passes over the columns (96 and 37 ran above); row_tile 8 and 4
    # there, 16 below
    huge = random_phi(20000, 8192, 3001, 999, seed=5, hot=300)
    for n_theta in (16, 64, 128, 160):
        for label, p, na, c_tile, row_tile in (
                ("", ragged, 96, 64, 8),
                ("-global-dictionary", huge, 8192, 128, 4)):
            d_n = torch.as_tensor(g.normal(size=(na, n_theta)),
                                  dtype=torch.float32, device="cuda")
            if label and na * n_theta * 2 <= SMEM_OPTIN_BYTES:
                raise AssertionError(f"{na} x {n_theta} fits in shared "
                                     "memory")
            case = f"width-{n_theta}{label}"
            facts = check_kernels(case, p, d_n, c_tile=c_tile,
                                  row_tile=row_tile, errors=errors, seed=17)
            if not label:
                check_ragged_edges(case, facts)
            check_format_kernels(case, p, d_n, c_tile=c_tile,
                                 row_tile=row_tile, errors=errors, seed=17)
    d_96 = torch.as_tensor(g.normal(size=(96, 96)), dtype=torch.float32,
                           device="cuda")
    check_ragged_edges("row-tile-16", check_kernels(
        "row-tile-16", ragged, d_96, c_tile=64, row_tile=16, errors=errors,
        seed=18))
    check_coo_solve_shape(errors)
    check_empty_fcoo()
    check_small_engine()


# ----------------------------------------------------------------------------
# 4. main path at full width
# ----------------------------------------------------------------------------

def solve_and_check(phase: str, engine, problem, fmt: str) -> tuple:
    """Run ``engine`` (MAIN_ITERS iterations, compaction every
    COMPACT_EVERY) with every launch count set to 0 just before, and check
    its two kernels' counts (2 DSC + 1.5 WC per iteration), its losses and
    its weights.  Returns (weights, launches of the path's kernels)."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    built_s = engine.inspector_seconds
    _build.reset_launches()
    t0 = time.perf_counter()
    start.record()
    w, losses = engine.run()
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    dsc_name, wc_name = PATH_KERNELS[fmt]
    launches = {dsc_name: counts.get(dsc_name, 0),
                wc_name: counts.get(wc_name, 0)}
    want = {dsc_name: 2 * MAIN_ITERS, wc_name: MAIN_ITERS + MAIN_ITERS // 2}
    log(phase, f"launches {counts} (expected {want}: 2 DSC + 1.5 WC per "
        f"iteration, no probes, no other kernel); run of {MAIN_ITERS} "
        f"iterations: {start.elapsed_time(stop):.3f} ms by CUDA events, "
        f"{wall:.3f} s wall, of which the compaction rebuild (host "
        f"inspector) {engine.inspector_seconds - built_s:.3f} s; compaction "
        f"kept {engine.phi.n_coeffs} of {problem.phi.n_coeffs} coefficients;"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")

    ls = losses.cpu().numpy()
    log(phase, f"loss {ls[0]:.6e} -> {ls[-1]:.6e} "
        f"(first 10 mean {ls[:10].mean():.6e}, last 10 mean "
        f"{ls[-10:].mean():.6e})")
    if not np.all(np.isfinite(ls)):
        raise AssertionError("non-finite loss")
    if not (ls[-10:].mean() < ls[:10].mean() and ls[-1] < ls[0]):
        raise AssertionError("losses did not decrease over the window")
    if tuple(w.shape) != (problem.phi.n_fibers,) or not torch.isfinite(w).all():
        raise AssertionError("weights are not finite of shape (Nf,)")
    return w, launches


def time_steps(engine, state, k: int = 20) -> tuple:
    """Milliseconds per iteration of ``engine.step`` over ``k`` iterations
    (CUDA events) after two warm ones from ``state``; returns (ms, the
    warmed state)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    state, _ = engine.step(state, 2)
    start.record()
    engine.step(state, k)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / k, state


def steady_step(phase: str, engine, w) -> list:
    """Steady-state iteration time on the compacted operator, and where it
    goes on the device: returns profile_step's rows."""
    step_ms, state = time_steps(engine, engine.init_state(w))
    log(phase, f"steady-state step: {step_ms:.4f} ms per iteration (CUDA "
        "events over 20 iterations, compacted Phi)")
    return profile_step(phase, engine, state, step_ms)


def phase_main(problem) -> tuple:
    from repro_torch.core.life import LifeConfig, LifeEngine
    cfg = LifeConfig(executor="kernel", n_iters=MAIN_ITERS,
                     compact_every=COMPACT_EVERY, plan_cache_dir="")
    t0 = time.perf_counter()
    engine = LifeEngine(problem, cfg, device="cuda")
    log("main", f"kernel engine built in {time.perf_counter() - t0:.2f} s "
        f"(inspector {engine.inspector_seconds:.2f} s); dsc tiles "
        f"{engine.executor.plans['dsc_tiles'].n_tiles} x 256, occupancy "
        f"{engine.executor.plans['dsc_tiles'].occupancy():.3f}; wc tiles "
        f"{engine.executor.plans['wc_tiles'].n_tiles} x 256, occupancy "
        f"{engine.executor.plans['wc_tiles'].occupancy():.3f}")
    w, launches = solve_and_check("main", engine, problem, "coo")
    steady_step("main", engine, w)

    opt = LifeEngine(problem, dataclasses.replace(cfg, executor="opt"),
                     device="cuda")
    w_opt, _ = opt.run()
    torch.cuda.synchronize()
    diff = (w - w_opt).abs()
    log("main", f"weights vs opt executor: max abs diff {float(diff.max()):.3e}"
        f" (rtol {TRAJ_TOL['rtol']}, atol {TRAJ_TOL['atol']})")
    torch.testing.assert_close(w, w_opt, **TRAJ_TOL)
    log("main", f"prune stats {engine.prune_stats(w)}")
    log("main", REDUCED.format(problem.phi.n_coeffs / problem.phi.n_fibers))
    return launches, w_opt


def profile_step(phase: str, engine, state, step_ms: float,
                 k: int = 10) -> list:
    """Device time per iteration by kernel (torch.profiler over ``k``
    iterations) and the device's busy share of the iteration measured
    without the profiler.  Returns (ms, calls, name) per device kernel per
    iteration, [] if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.step(state, k)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue                  # host ops: their kernels are listed
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            name = evt.key
            for short in ("dsc_coo_kernel", "wc_coo_kernel",
                          "dsc_sell_kernel", "wc_sell_kernel",
                          "dsc_fcoo_kernel", "dsc_fcoo_fold_kernel",
                          "wc_fcoo_kernel", "wc_fcoo_fold_kernel"):
                if short in name:
                    name = short
            rows.append((us / k / 1e3, evt.count / k, name[:60]))
    if not rows:
        log(phase, "profiler saw no device time: breakdown not measured")
        return rows
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(phase, f"device time per iteration {busy:.4f} ms = "
        f"{busy / step_ms:.1%} of the {step_ms:.4f} ms step (torch.profiler "
        f"over {k} iterations); by kernel:")
    for ms, calls, name in rows[:10]:
        log(phase, f"  {ms:.4f} ms  {ms / busy:6.1%}  {calls:4.1f} calls  "
            f"{name}")
    return rows


# ----------------------------------------------------------------------------
# 5. the format paths at full width
# ----------------------------------------------------------------------------

def phase_formats(problem, w_opt) -> dict:
    """``format="sell"`` and ``format="fcoo"`` through LifeEngine at full
    width, each against ``opt``; then ``format="auto"``.  Returns the
    launches of B3-B6 on their paths."""
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.formats.select import DEFAULT_CANDIDATES
    cfg = LifeConfig(n_iters=MAIN_ITERS, compact_every=COMPACT_EVERY,
                     plan_cache_dir="")
    launches, layouts = {}, {}
    n_theta = problem.dictionary.shape[1]
    for fmt in ("sell", "fcoo"):
        phase = f"format-{fmt}"
        t0 = time.perf_counter()
        engine = LifeEngine(problem, dataclasses.replace(cfg, format=fmt),
                            device="cuda")
        plans = engine.executor.plans
        if fmt == "sell":
            sd, sw = plans["sell_dsc"], plans["sell_wc"]
            layouts[fmt] = sd.nbytes + sw.nbytes
            shape = (f"SELL dsc {sd.atoms.shape[0]} x {sd.width} (overhead "
                     f"{sd.padding_overhead:.2f}), wc {sw.atoms.shape[0]} x "
                     f"{sw.width} (overhead {sw.padding_overhead:.2f}), "
                     f"{layouts[fmt] / 2**20:.1f} MiB for the two encodes")
        else:
            fc = plans["fcoo"]
            layouts[fmt] = fc.nbytes
            card_bytes = plans["fcoo_operands"].nbytes
            shape = (f"F-COO {fc.n_chunks} chunks of {fc.c_tile}, k_dsc "
                     f"{fc.k_dsc}, k_wc {fc.k_wc}; FcooPhi.nbytes "
                     f"{fc.nbytes} ({fc.nbytes / 2**20:.1f} MiB, the host "
                     "encoding's nine arrays), FcooOperands.nbytes "
                     f"{card_bytes} ({card_bytes / 2**20:.1f} MiB on the "
                     "card: the stream, wc_perm and wc_fibers; the ranks and"
                     " segment maps stay on the host); per call B5 writes y "
                     f"and {fc.n_chunks * 2 * n_theta * 4 / 2**20:.2f} MiB of"
                     f" carries, B6 w and {fc.n_chunks * 2 * 8 / 2**20:.3f} "
                     "MiB of carries and their fibers (the TPU kernels' "
                     "partials would be "
                     f"{fc.n_chunks * fc.k_dsc * n_theta * 4 / 2**20:.1f} and"
                     f" {fc.n_chunks * fc.k_wc * 4 / 2**20:.2f} MiB, "
                     f"{np.mean(fc.seg_rows_dsc == fc.n_voxels):.1%} and "
                     f"{np.mean(fc.seg_rows_wc == fc.n_fibers):.1%} of their "
                     "rows padding segments)")
        log(phase, f"{engine.executor.name} engine built in "
            f"{time.perf_counter() - t0:.2f} s ({engine.format_plan.describe()}); "
            f"{shape}")
        w, launches_fmt = solve_and_check(phase, engine, problem, fmt)
        launches.update(launches_fmt)
        rows = steady_step(phase, engine, w)
        check_deterministic(problem, cfg, fmt, w, rows)
        diff = (w - w_opt).abs()
        log(phase, f"weights vs opt executor: max abs diff "
            f"{float(diff.max()):.3e} (rtol {TRAJ_TOL['rtol']}, atol "
            f"{TRAJ_TOL['atol']})")
        torch.testing.assert_close(w, w_opt, **TRAJ_TOL)
        del engine
        torch.cuda.empty_cache()
    log("formats", f"F-COO encoded bytes over the two SELL encodes: "
        f"{layouts['fcoo'] / layouts['sell']:.4f} (the reference's table12 "
        "gate is 0.6)")

    # the coo candidate is timed on B1, the executor that runs it here; the
    # plan is kept for phase 12's training cache
    import shutil
    from repro_torch.kernels import _build
    auto_dir = os.path.join(ROOT, "build", "learn", "phase5")
    shutil.rmtree(auto_dir, ignore_errors=True)
    _build.reset_launches()
    t0 = time.perf_counter()
    engine = LifeEngine(problem, dataclasses.replace(
        cfg, executor="kernel", format="auto", n_iters=AUTO_ITERS,
        compact_every=0, plan_cache_dir=auto_dir), device="cuda")
    torch.cuda.synchronize()
    measured = {k: v for k, v in _build.LAUNCHES.items() if v}
    plan = engine.format_plan
    st = plan.stats
    log("format-auto", f"resolved {plan.describe()} -> executor "
        f"{engine.executor.name} in {time.perf_counter() - t0:.2f} s, the "
        f"measured rung launching {measured} (B1 for coo, B5 for fcoo: one "
        f"warm-up call, 20 ms more of them, 3 timed); SELL "
        f"overhead dsc {st['dsc.sell_overhead']:.3f}, wc "
        f"{st['wc.sell_overhead']:.3f} (accept <= {cfg.sell_accept}, reject "
        f">= {cfg.sell_reject}); run mean dsc {st['dsc.run_mean']:.2f}, wc "
        f"{st['wc.run_mean']:.2f}")
    if plan.format not in DEFAULT_CANDIDATES or plan.reason not in (
            "heuristic", "autotune"):
        raise AssertionError(f"format=auto resolved to {plan.describe()}")
    w, losses = engine.run()
    torch.cuda.synchronize()
    ls = losses.cpu().numpy()
    if ls.shape != (AUTO_ITERS,) or not np.all(np.isfinite(ls)) \
            or not torch.isfinite(w).all():
        raise AssertionError("format=auto run is not finite")
    log("format-auto", f"{AUTO_ITERS} iterations on the chosen executor: "
        f"loss {ls[0]:.6e} -> {ls[-1]:.6e}")
    return launches


def check_deterministic(problem, cfg, fmt: str, w, rows: list) -> None:
    """A second full solve with ``format=fmt`` (a new engine, the same
    problem) gives the first one's weights bit for bit, and the step's
    profile holds no ``index_add_`` (B3-B6 write their outputs themselves,
    without atomics)."""
    from repro_torch.core.life import LifeEngine
    phase = f"format-{fmt}"
    engine = LifeEngine(problem, dataclasses.replace(cfg, format=fmt),
                        device="cuda")
    w2, _ = engine.run()
    torch.cuda.synchronize()
    same = torch.equal(w, w2)
    log(phase, f"a second full {fmt} solve gives bit-identical weights: "
        f"{same} (max abs diff {float((w - w2).abs().max()):.3e})")
    if not same:
        raise AssertionError(f"two {fmt} solves differ")
    if not rows:
        log(phase, "index_add_ in the step: not measured (the profiler saw "
            "no device time)")
        return
    scatters = [name for _, _, name in rows
                if "indexfunc" in name.lower() or "index_add" in name.lower()]
    log(phase, f"index_add_ kernels in the step's profile: "
        f"{scatters or 'none'}")
    if scatters:
        raise AssertionError(f"the {fmt} step runs an index_add_: "
                             f"{scatters}")


# ----------------------------------------------------------------------------
# 6. timing
# ----------------------------------------------------------------------------

def time_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def bound(bytes_moved: float, flops: float, flops_per_s=None):
    """Least milliseconds on the card and what sets them: the H100 SXM data
    sheet's rates at 700 W (repro_torch/roofline/analysis.py: HBM3 3.35
    TB/s, fp32 67 TFLOP/s unless ``flops_per_s`` is given)."""
    from repro_torch.roofline.analysis import bound as least_seconds
    t, by = least_seconds(bytes_moved, flops, flops_per_s)
    return t * 1e3, by


def csr_operator(phi, d, transpose: bool):
    """M (or M^T) as a torch CSR matrix: the library yardstick (the paper's
    STD-vs-CSR comparison).  The port never calls it."""
    n_theta = d.shape[1]
    rows = (phi.voxels.long()[:, None] * n_theta
            + torch.arange(n_theta, device="cuda")[None, :]).reshape(-1)
    cols = phi.fibers.long()[:, None].expand(-1, n_theta).reshape(-1)
    vals = (d[phi.atoms.long()] * phi.values[:, None]).reshape(-1)
    shape = (phi.n_voxels * n_theta, phi.n_fibers)
    idx = torch.stack([rows, cols])
    if transpose:
        idx, shape = idx.flip(0), shape[::-1]
    m = torch.sparse_coo_tensor(idx, vals, shape).coalesce().to_sparse_csr()
    del rows, cols, vals, idx
    return m



def phase_timing(problem, launches: dict, errors: dict) -> list:
    phi, d = problem.phi, problem.dictionary
    t_dsc, t_wc = kernel_operands(phi, c_tile=256, row_tile=8,
                                  compute_dtype="fp32")
    sd, sw, fc, o = format_operands(phi, c_tile=256, row_tile=8,
                                    compute_dtype="fp32")
    fo = o["fcoo"]
    nc, n_theta = phi.n_coeffs, d.shape[1]
    nv, nf = phi.n_voxels, phi.n_fibers
    w = torch.rand(nf, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(5))
    y = (run_dsc(t_dsc, d, w)[:nv] - problem.b).contiguous()
    # per kernel: its call, its plain version, its result over the function
    # y = M w or w = M^T y, and its compulsory work
    # (repro_torch/roofline/spmv_bytes.py): each index and value of a real
    # coefficient read once, D and the dense input read once, the output
    # (y or w) written once
    from repro_torch.roofline import spmv_bytes as sb
    kw = dict(d_bytes=d.numel() * d.element_size())
    work = {
        "dsc_coo": sb.dsc_coo(nc, n_theta, n_fibers=nf,
                              n_row_blocks=t_dsc.n_row_blocks,
                              n_tiles=t_dsc.tile_len.numel(),
                              row_tile=t_dsc.row_tile, **kw),
        "dsc_sell": sb.dsc_sell(nc, n_theta, n_fibers=nf,
                                n_rows=sd.row_nnz.size,
                                rows_padded=sd.atoms.shape[0], **kw),
        "dsc_fcoo": sb.stream(nc, n_theta, n_voxels=nv, n_fibers=nf, **kw),
        "wc_coo": sb.wc_coo(nc, n_theta, n_voxels=nv,
                            n_row_blocks=t_wc.n_row_blocks,
                            n_tiles=t_wc.tile_len.numel(),
                            row_tile=t_wc.row_tile, **kw),
        "wc_sell": sb.wc_sell(nc, n_theta, n_voxels=nv,
                              n_rows=sw.row_nnz.size,
                              rows_padded=sw.atoms.shape[0], **kw),
        "wc_fcoo": sb.wc_fcoo(nc, n_theta, n_voxels=nv, n_fibers=nf, **kw),
    }
    rows = [
        ("dsc_coo", w, lambda pl=False: run_dsc(t_dsc, d, w, plain=pl),
         lambda out: out[:nv]),
        ("dsc_sell", w,
         lambda pl=False: run_format("dsc_sell", o["dsc_sell"], d, w, pl),
         lambda out: out[:nv]),
        ("dsc_fcoo", w, lambda pl=False: run_format("dsc_fcoo", fo, d, w, pl),
         lambda out: out),
        ("wc_coo", y, lambda pl=False: run_wc(t_wc, d, y, plain=pl),
         lambda out: out[:nf]),
        ("wc_sell", y,
         lambda pl=False: run_format("wc_sell", o["wc_sell"], d, y, pl),
         lambda out: out[:nf]),
        ("wc_fcoo", y, lambda pl=False: run_format("wc_fcoo", fo, d, y, pl),
         lambda out: out),
    ]
    csr = {}
    entries = []
    for name, x, run, result in rows:
        op = name.split("_")[0]
        if op not in csr:
            csr.clear()
            torch.cuda.empty_cache()
            csr[op] = csr_operator(phi, d, transpose=(op == "wc"))
        m = csr[op]
        xv = x.reshape(-1, 1)
        lib_out = torch.sparse.mm(m, xv).reshape(-1)
        mine = result(run()).reshape(-1)
        torch.testing.assert_close(mine, lib_out, **FP32_TOL)
        ms = time_ms(run)
        plain_ms = time_ms(lambda: run(True))
        library_ms = time_ms(lambda: torch.sparse.mm(m, xv))
        bound_ms, bound_by = bound(work[name].bytes, work[name].flops)
        entry = dict(name=name, route="cuda", **KERNELS[name],
                     launches=launches[name], max_abs_err=errors[name],
                     ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms)
        extra = ""
        if name == "wc_fcoo":
            # fiber order gathers one Y row per slot; if no gathered row hit
            # in L2 (an estimate, not a bound: L2 hits are not measured)
            no_reuse_ms, _ = bound(
                work[name].bytes + nc * n_theta * 4 - nv * n_theta * 4,
                work[name].flops)
            extra = (f"; estimate with a Y row read from memory per slot "
                     f"(no L2 reuse) {no_reuse_ms:.4f} ms")
        log("timing", f"{name}: {ms:.4f} ms (bound {bound_ms:.4f} ms by "
            f"{bound_by}, {bound_ms / ms:.1%} of it){extra}; plain "
            f"{plain_ms:.4f} ms; torch.sparse.mm CSR {library_ms:.4f} ms; "
            f"Nc {nc}")
        entries.append(entry)
    csr.clear()
    torch.cuda.empty_cache()
    return entries


# ----------------------------------------------------------------------------
# 8. tuning at full width: tune="full", then a warm tune="cached" rebuild
# ----------------------------------------------------------------------------

#: the layout of each kernel executor that phase 3 holds against the plain
#: versions at the main path's shapes
MAIN_LAYOUTS = {"kernel": dict(c_tile=256, row_tile=8),
                "kernel-sell": dict(row_tile=8, slot_tile=32),
                "kernel-fcoo": dict(c_tile=256)}
#: (LifeConfig.executor, LifeConfig.format) of each tuned path
TUNE_PATHS = (("kernel", "coo"), ("opt", "sell"), ("opt", "fcoo"))
TUNE_ITERS = 20


def check_tuned_layout(phase: str, problem, name: str, params: dict,
                       errors: dict) -> None:
    """The winner's kernels against their plain versions at its layout,
    unless phase 3 held that layout already."""
    if params == MAIN_LAYOUTS[name]:
        log(phase, f"the winner's layout {params} is the main path's, held "
            "against the plain versions in phase 3")
        return
    case = f"tuned-{name}-" + "-".join(f"{k}{v}" for k, v in
                                       sorted(params.items()))
    phi, d = problem.phi, problem.dictionary
    if name == "kernel":
        check_kernels(case, phi, d, c_tile=params["c_tile"],
                      row_tile=params["row_tile"], errors=errors, seed=19)
    elif name == "kernel-sell":
        check_format_kernels(case, phi, d, c_tile=256,
                             row_tile=params["row_tile"],
                             slot_tile=params["slot_tile"], errors=errors,
                             seed=19)
    else:
        check_format_kernels(case, phi, d, c_tile=params["c_tile"],
                             row_tile=8, errors=errors, seed=19)


def warmed_calls_ms(fn, x, warm_seconds: float, idle_seconds: float) -> list:
    """ms per call of ``fn(x)`` over 3 calls between CUDA events, each time
    after ``idle_seconds`` of idle card and one warm-up call: with no more
    warm-up, then with ``warm_seconds`` more of warm-up calls."""
    out = []
    for warm in (0.0, warm_seconds):
        torch.cuda.synchronize()
        time.sleep(idle_seconds)
        until = time.perf_counter() + warm
        while True:
            fn(x)
            torch.cuda.synchronize()
            if time.perf_counter() >= until:
                break
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            fn(x)
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / 3)
    return out


def phase_tune(problem, errors: dict) -> None:
    """tune="full" with compute_dtype="auto" on each kernel executor (a
    fresh plan cache each), its measurements and winner; a tune="cached"
    rebuild that measures nothing and replays the plan; the tuned engine's
    launches and weights; its step beside the untuned engine's."""
    import shutil
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.core.registry import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.tune import search
    from repro_torch.tune.space import search_space
    opt_cfg = LifeConfig(executor="opt", n_iters=TUNE_ITERS,
                         plan_cache_dir="")
    w_opt = {}
    for executor, fmt in TUNE_PATHS:
        phase = f"tune-{fmt}"
        cache_dir = os.path.join(ROOT, "build", "tune-cache", fmt)
        shutil.rmtree(cache_dir, ignore_errors=True)
        cfg = LifeConfig(executor=executor, format=fmt, tune="full",
                         compute_dtype="auto", n_iters=TUNE_ITERS,
                         plan_cache_dir=cache_dir)
        n0 = search.measurement_count()
        t0 = time.perf_counter()
        engine = LifeEngine(problem, cfg, device="cuda")
        search_s = time.perf_counter() - t0
        plan, name = engine.tune_plan, engine.executor.name
        n_cands = len(search_space(name, cfg, budget=cfg.tune_budget))
        log(phase, f"tune=full: {plan.describe()}; search and build "
            f"{search_s:.2f} s, {search.measurement_count() - n0} timed "
            f"calls for {n_cands} candidates (tune_budget "
            f"{cfg.tune_budget}); cost 2 x DSC + 1.5 x WC per candidate "
            "(CUDA events over 3 calls after "
            f"{search.CUDA_WARM_SECONDS * 1e3:.0f} ms of warm-up), cheapest "
            "first:")
        for label, cost in sorted(plan.measurements.items(),
                                  key=lambda kv: kv[1]):
            log(phase, f"  {cost * 1e3:.4f} ms  {label}")
        if plan.reason != "search" or len(plan.measurements) != n_cands:
            raise AssertionError(f"{phase}: {plan.describe()} measured "
                                 f"{len(plan.measurements)} of {n_cands}")
        del engine
        n1 = search.measurement_count()
        t0 = time.perf_counter()
        warm = LifeEngine(problem, dataclasses.replace(cfg, tune="cached"),
                          device="cuda")
        made = search.measurement_count() - n1
        log(phase, f"tune=cached rebuild in {time.perf_counter() - t0:.2f} "
            f"s: {made} measurements, the same plan: "
            f"{warm.tune_plan == plan}")
        if made or warm.tune_plan != plan:
            raise AssertionError(f"{phase}: the warm rebuild measured {made}"
                                 " times or gave another plan")
        check_tuned_layout(phase, problem, name, plan.params, errors)

        torch.cuda.synchronize()
        _build.reset_launches()
        w, losses = warm.run()
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        dsc_name, wc_name = PATH_KERNELS[fmt]
        want = {dsc_name: 2 * TUNE_ITERS, wc_name: TUNE_ITERS
                + TUNE_ITERS // 2}
        ls = losses.cpu().numpy()
        log(phase, f"tuned engine, {TUNE_ITERS} iterations: launches "
            f"{counts} (expected {want}); loss {ls[0]:.6e} -> {ls[-1]:.6e}")
        if counts != want:
            raise AssertionError(f"{phase}: launch counts {counts} != {want}")
        if not (np.all(np.isfinite(ls)) and ls[-1] < ls[0]):
            raise AssertionError(f"{phase}: losses not finite or rising")
        dt = warm.resolved_compute_dtype
        for key in {"fp32", dt}:
            if key not in w_opt:
                w_opt[key], _ = LifeEngine(problem, dataclasses.replace(
                    opt_cfg, compute_dtype=key), device="cuda").run()
        tol = TRAJ_TOL if dt == "fp32" else bf16_tol()
        diff = float((w - w_opt["fp32"]).abs().max())
        same = float((w - w_opt[dt]).abs().max())
        log(phase, f"weights ({dt}) vs fp32 opt: max abs diff {diff:.3e} "
            f"(rtol {tol['rtol']}, atol {tol['atol']}); vs {dt} opt "
            f"{same:.3e} (rtol {TRAJ_TOL['rtol']}, atol {TRAJ_TOL['atol']})")
        torch.testing.assert_close(w, w_opt["fp32"], **tol)
        torch.testing.assert_close(w, w_opt[dt], **TRAJ_TOL)

        # the tuned step beside the untuned one, in turns on one card
        untuned = LifeEngine(problem, dataclasses.replace(
            cfg, tune="off", compute_dtype="fp32"), device="cuda")
        times = {"untuned": [], "tuned": []}
        for label in ("untuned", "tuned", "tuned", "untuned"):
            eng = warm if label == "tuned" else untuned
            times[label].append(time_steps(eng, eng.init_state(w))[0])
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        log(phase, f"step on the full Phi (CUDA events, 20 iterations, "
            f"turns untuned/tuned/tuned/untuned): tuned {ms['tuned']:.4f} "
            f"ms {plan.params} {dt}, untuned {ms['untuned']:.4f} ms "
            f"{MAIN_LAYOUTS[name]} fp32; tuned / untuned "
            f"{ms['tuned'] / ms['untuned']:.3f}")
        # the search's calls with one warm-up call and with its own, as a
        # candidate meets them: after an idle card, and freshly built
        w1 = torch.ones_like(w)
        y1 = torch.ones(problem.phi.n_voxels, problem.dictionary.shape[1],
                        device="cuda")
        warm_s = search.CUDA_WARM_SECONDS
        for label, ex, idle in (
                ("after 0.5 s of idle card", untuned.executor, 0.5),
                ("freshly built", REGISTRY.create(
                    name, problem.phi, problem, dataclasses.replace(
                        cfg, tune="off", compute_dtype="fp32")), 0.0)):
            dsc_ms = warmed_calls_ms(ex.matvec, w1, warm_s, idle)
            wc_ms = warmed_calls_ms(ex.rmatvec, y1, warm_s, idle)
            log(phase, f"untuned DSC / WC {label}, 3 calls after 1 warm-up "
                f"call: {dsc_ms[0]:.4f} / {wc_ms[0]:.4f} ms; after "
                f"{warm_s * 1e3:.0f} ms more (the search's warm-up): "
                f"{dsc_ms[1]:.4f} / {wc_ms[1]:.4f} ms")
        del warm, untuned, ex
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# 9. the cohort solve at full width
# ----------------------------------------------------------------------------

COHORT = 4
COHORT_ITERS = 20
#: (LifeConfig.executor, LifeConfig.format) of each cohort solve
COHORT_PATHS = (("opt", "coo"), ("naive", "coo"), ("auto", "coo"),
                ("opt", "alto"))


def phase_cohort(problem) -> list:
    """synth_cohort of COHORT subjects at the main problem's size, solved
    by BatchedLifeEngine on each recipe and format="alto", each subject
    against its own LifeEngine(opt) solve; the stepped API; step time,
    subjects per second, peak memory and a profile beside the
    single-subject solves.  Returns the cohort."""
    from repro_torch.core.batched import BatchedLifeEngine
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.data.dmri import synth_cohort
    kw = {k: v for k, v in MAIN_PROBLEM.items() if k != "seed"}
    t0 = time.perf_counter()
    cohort = synth_cohort(COHORT, base_seed=MAIN_PROBLEM["seed"],
                          device="cuda", **kw)
    log("cohort", f"synth_cohort({COHORT}, base_seed="
        f"{MAIN_PROBLEM['seed']}) in {time.perf_counter() - t0:.1f} s: Nc "
        f"{[p.phi.n_coeffs for p in cohort]}")
    p0 = cohort[0].phi
    if not all(torch.equal(getattr(p0, f), getattr(problem.phi, f))
               for f in ("atoms", "voxels", "fibers", "values")):
        raise AssertionError("subject 0 is not the main problem")

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    single_cfg = LifeConfig(executor="opt", n_iters=COHORT_ITERS,
                            plan_cache_dir="")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    start.record()
    singles = [LifeEngine(p, single_cfg, device="cuda").run()
               for p in cohort]
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    single_steps = []
    for p in cohort:
        eng = LifeEngine(p, single_cfg, device="cuda")
        single_steps.append(time_steps(eng, eng.init_state())[0])
    log("cohort", f"{COHORT} single-subject opt solves of {COHORT_ITERS} "
        f"iterations, one after another: {wall:.3f} s wall (engine builds "
        f"included), {start.elapsed_time(stop):.3f} ms by CUDA events, "
        f"{COHORT / wall:.2f} subjects/s; steps {single_steps} ms (sum "
        f"{sum(single_steps):.4f}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    for executor, fmt in COHORT_PATHS:
        phase = f"cohort-{executor}-{fmt}"
        cfg = LifeConfig(executor=executor, format=fmt,
                         n_iters=COHORT_ITERS, plan_cache_dir="")
        t0 = time.perf_counter()
        eng = BatchedLifeEngine(cohort, cfg, device="cuda")
        built = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        start.record()
        w, losses = eng.run()
        stop.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        if tuple(w.shape) != (COHORT, p0.n_fibers) or tuple(
                losses.shape) != (COHORT, COHORT_ITERS):
            raise AssertionError(f"{phase}: shapes {tuple(w.shape)}, "
                                 f"{tuple(losses.shape)}")
        if not (torch.isfinite(w).all() and torch.isfinite(losses).all()):
            raise AssertionError(f"{phase}: not finite")
        w_diff = l_diff = 0.0
        for s, (w1, l1) in enumerate(singles):
            torch.testing.assert_close(w[s], w1, **TRAJ_TOL)
            torch.testing.assert_close(losses[s], l1, rtol=TRAJ_TOL["rtol"],
                                       atol=0.0)
            w_diff = max(w_diff, float((w[s] - w1).abs().max()))
            l_diff = max(l_diff, float(((losses[s] - l1).abs()
                                        / l1.abs()).max()))
        plan = (f", {eng.format_plan.describe()}" if eng.format_plan
                else "")
        log(phase, f"built in {built:.2f} s (Nc padded to {eng.nc_padded}"
            f"{plan}); {COHORT_ITERS} iterations {wall:.3f} s wall, "
            f"{start.elapsed_time(stop):.3f} ms by CUDA events, "
            f"{COHORT / wall:.2f} subjects/s; peak memory {peak:.1f} MiB; "
            f"each subject vs its own opt solve: weights max abs diff "
            f"{w_diff:.3e} (rtol {TRAJ_TOL['rtol']}, atol "
            f"{TRAJ_TOL['atol']}), losses max rel diff {l_diff:.3e}")
        if (executor, fmt) == ("opt", "coo"):
            half = COHORT_ITERS // 2
            st, l1 = eng.step(eng.init_states(), half)
            st, l2 = eng.step(st, half)
            torch.cuda.synchronize()
            same = (torch.equal(st.w, w)
                    and torch.equal(torch.cat([l1, l2], dim=1), losses))
            log(phase, f"step({half}) twice equals run({COHORT_ITERS}) bit "
                f"for bit: {same}")
            if not same:
                raise AssertionError(f"{phase}: chained steps differ from "
                                     "the run")
            step_ms, state = time_steps(eng, eng.init_states(w))
            log(phase, f"steady step of the cohort: {step_ms:.4f} ms per "
                f"iteration (CUDA events over 20 iterations) against "
                f"{sum(single_steps):.4f} ms for the {COHORT} single steps; "
                f"{COHORT / (step_ms * COHORT_ITERS / 1e3):.1f} subjects/s "
                f"for {COHORT_ITERS}-iteration solves at that step")
            profile_step(phase, eng, state, step_ms)
        del eng
        torch.cuda.empty_cache()
    return cohort


# ----------------------------------------------------------------------------
# 10. checkpoint and resume
# ----------------------------------------------------------------------------

CKPT_HALF = 50


def save_restore(phase: str, path: str, tree: dict, template: dict) -> dict:
    """``tree`` saved and restored through the port's manager into the
    shape of ``template``, on the card; logs seconds and bytes."""
    from repro_torch.checkpoint import manager as ckpt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(path, CKPT_HALF, tree)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, flat, manifest = ckpt.restore(path)
    restored = ckpt.place(ckpt.unflatten_like(template, flat), "cuda")
    torch.cuda.synchronize()
    log(phase, f"saved in {save_s:.4f} s, restored onto the card in "
        f"{time.perf_counter() - t0:.4f} s: step {step}, "
        f"{manifest['n_arrays']} arrays, {manifest['bytes']} bytes "
        f"({manifest['dtypes']})")
    return restored


def phase_checkpoint(problem, cohort) -> None:
    """The kernel engine for CKPT_HALF iterations, saved, restored into a
    fresh engine and run CKPT_HALF more: bit-identical to 2 * CKPT_HALF
    uninterrupted iterations (no compaction).  The same for the cohort
    state."""
    import shutil
    from repro_torch.core.batched import BatchedLifeEngine
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.kernels import _build
    root = os.path.join(ROOT, "build", "checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    n = 2 * CKPT_HALF

    cfg = LifeConfig(executor="kernel", plan_cache_dir="")
    whole = LifeEngine(problem, cfg, device="cuda")
    st_whole, l_whole = whole.step(whole.init_state(), n)
    del whole
    first = LifeEngine(problem, cfg, device="cuda")
    st, l1 = first.step(first.init_state(), CKPT_HALF)
    del first
    fresh = LifeEngine(problem, cfg, device="cuda")
    restored = save_restore(
        "checkpoint", os.path.join(root, "single"),
        {"state": st, "losses": l1},
        {"state": fresh.init_state(), "losses": torch.zeros(CKPT_HALF)})
    torch.cuda.synchronize()
    _build.reset_launches()
    st2, l2 = fresh.step(restored["state"], CKPT_HALF)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    want = {"dsc_coo": 2 * CKPT_HALF, "wc_coo": CKPT_HALF + CKPT_HALF // 2}
    same = (torch.equal(st2.w, st_whole.w) and st2.it == st_whole.it
            and torch.equal(torch.cat([restored["losses"], l2]), l_whole))
    log("checkpoint", f"kernel engine: {CKPT_HALF} iterations, saved, "
        f"restored into a fresh engine, {CKPT_HALF} more (launches {counts},"
        f" expected {want}): bit-identical to {n} uninterrupted iterations:"
        f" {same} (max abs diff "
        f"{float((st2.w - st_whole.w).abs().max()):.3e})")
    if counts != want or not same:
        raise AssertionError("the resumed kernel solve differs")
    del fresh

    bcfg = LifeConfig(executor="opt", plan_cache_dir="")
    eng = BatchedLifeEngine(cohort, bcfg, device="cuda")
    a, la = eng.step(eng.init_states(), n)
    b, lb = eng.step(eng.init_states(), n)
    torch.cuda.synchronize()
    deterministic = torch.equal(a.w, b.w) and torch.equal(la, lb)
    st, l1 = eng.step(eng.init_states(), CKPT_HALF)
    fresh = BatchedLifeEngine(cohort, bcfg, device="cuda")
    restored = save_restore(
        "checkpoint", os.path.join(root, "cohort"),
        {"stacked": st, "losses": l1},
        {"stacked": fresh.init_states(),
         "losses": torch.zeros(COHORT, CKPT_HALF)})
    st2, l2 = fresh.step(restored["stacked"], CKPT_HALF)
    torch.cuda.synchronize()
    losses = torch.cat([restored["losses"], l2], dim=1)
    bits = torch.equal(st2.w, a.w) and torch.equal(losses, la)
    log("checkpoint", f"cohort (opt, {COHORT} subjects): two uninterrupted "
        f"runs of {n} bit-identical: {deterministic}; resumed after "
        f"{CKPT_HALF} bit-identical to uninterrupted: {bits} (max abs diff "
        f"{float((st2.w - a.w).abs().max()):.3e}); counters "
        f"{restored['stacked'].it.tolist()} -> {st2.it.tolist()}")
    if deterministic and not bits:
        raise AssertionError("the resumed cohort differs from a run that "
                             "repeats bit for bit")
    if not deterministic:
        torch.testing.assert_close(st2.w, a.w, **FP32_TOL)
        torch.testing.assert_close(losses, la, **FP32_TOL)
        log("checkpoint", "the cohort run does not repeat bit for bit; the "
            f"resumed one is within rtol {FP32_TOL['rtol']}, atol "
            f"{FP32_TOL['atol']}")
    if not np.array_equal(st2.it, np.full(COHORT, n)):
        raise AssertionError(f"cohort counters {st2.it} != {n}")
    del eng, fresh
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# 11. the LiFE solve service, with observability on
# ----------------------------------------------------------------------------

SERVE_ITERS = 64
SERVE_SLICE = 16
#: (job id, cohort subject or None for the main problem, format, priority),
#: in order of submission; the last arrives after the first tick
SERVE_JOBS = (("s2-sell", 2, "sell", 0), ("s3-fcoo", 3, "fcoo", 0),
              ("s0-auto", 0, "auto", 0), ("s1-auto", 1, "auto", 0),
              ("main-auto", None, "auto", 1))
#: an engine.roofline.fraction above this means the byte count is wrong
ROOFLINE_CEILING = 1.05


def serve_counters_hold(obs) -> bool:
    """The scheduler's counter algebra (serve/scheduler.py)."""
    return obs.value("serve.jobs.admitted") == (
        obs.value("serve.jobs.completed") + obs.value("serve.jobs.failed")
        + obs.value("serve.jobs.cancelled") + obs.value("serve.queue.depth")
        + obs.value("serve.jobs.running"))


def serve_trace(problem, cohort, *, ckpt_dir=None, kill_after=None) -> dict:
    """Drive a LifeService through SERVE_JOBS: four submissions, one tick,
    the late arrival, then ticks to the end (or ``kill_after`` ticks, when
    the service checkpoints and is dropped).  Checks the counter algebra
    at every tick.  Returns the service, its wall seconds and the seconds
    spent in submit (the host digest of each dataset)."""
    from repro_torch import obs
    from repro_torch.core.life import LifeConfig
    from repro_torch.serve import LifeService
    cfg = LifeConfig(executor="opt", n_iters=SERVE_ITERS,
                     plan_cache_dir=os.path.join(ROOT, "build", "serve",
                                                 "plans"))
    svc = LifeService(cfg, ckpt_dir=ckpt_dir, slice_iters=SERVE_SLICE,
                      checkpoint_every=kill_after or 0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = 0
    submit_s = 0.0
    for jid, subject, fmt, priority in SERVE_JOBS:
        if jid == SERVE_JOBS[-1][0]:
            svc.step()
            ticks += 1
        t1 = time.perf_counter()
        svc.submit(problem if subject is None else cohort[subject],
                   job_id=jid, format=fmt, priority=priority)
        submit_s += time.perf_counter() - t1
    while svc.scheduler.active() and ticks != kill_after:
        svc.step()
        ticks += 1
        if not serve_counters_hold(obs):
            raise AssertionError(f"serve: counter algebra broken at tick "
                                 f"{ticks}: {obs.snapshot()['counters']}")
    torch.cuda.synchronize()
    return dict(service=svc, seconds=time.perf_counter() - t0, ticks=ticks,
                submit_seconds=submit_s)


def phase_serve(problem, cohort) -> None:
    """Phase 11: a LifeService over the cohort and the main problem with
    observability on; bit-identical resume, launches, counters, the
    engines' step histograms and roofline gauges."""
    import shutil
    from repro_torch import obs
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.kernels import _build
    from repro_torch.serve import LifeService
    root = os.path.join(ROOT, "build", "serve")
    shutil.rmtree(root, ignore_errors=True)
    obs.enable()
    obs.reset()

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    run = serve_trace(problem, cohort)
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**20
    svc = run["service"]
    n = len(SERVE_JOBS)
    want = {"dsc_sell": 2 * SERVE_ITERS, "wc_sell": 3 * SERVE_ITERS // 2,
            "dsc_fcoo": 2 * SERVE_ITERS, "wc_fcoo": 3 * SERVE_ITERS // 2}
    latencies = {jid: svc.job(jid).prior_elapsed + svc.job(jid).finished_at
                 - svc.job(jid).submitted_at for jid, *_ in SERVE_JOBS}
    log("serve", f"{n} jobs of {SERVE_ITERS} iterations in {run['ticks']} "
        f"ticks of {SERVE_SLICE}: {run['seconds']:.3f} s wall (engine builds "
        f"and format selection included; submits, each hashing its dataset "
        f"on the host, {run['submit_seconds']:.3f} s), "
        f"{n / run['seconds']:.2f} jobs/s; "
        f"peak memory {peak:.1f} MiB; launches {counts} (expected {want}: "
        f"2 DSC + 1.5 WC per iteration of the solo sell and fcoo jobs)")
    log("serve", "latency by job (submit to finish): " + ", ".join(
        f"{jid} {t:.3f} s" for jid, t in latencies.items()))
    if counts != want:
        raise AssertionError(f"serve: launches {counts} != {want}")
    results = {jid: svc.result(jid) for jid, *_ in SERVE_JOBS}
    for jid, (w, losses) in results.items():
        if tuple(w.shape) != (problem.phi.n_fibers,) or tuple(
                losses.shape) != (SERVE_ITERS,):
            raise AssertionError(f"serve: {jid} shapes {tuple(w.shape)}, "
                                 f"{tuple(losses.shape)}")
        if not (torch.isfinite(w).all() and torch.isfinite(losses).all()):
            raise AssertionError(f"serve: {jid} not finite")

    snap = svc.metrics_snapshot()
    steps = {h["labels"].get("executor"): h for h in snap["histograms"]
             if h["name"] == "engine.step.seconds" and h["count"]}
    log("serve", "engine.step.seconds by executor: " + ", ".join(
        f"{ex} {h['count']} steps, p50 {h['quantiles']['p50'] * 1e3:.3f} ms"
        for ex, h in sorted(steps.items())))
    if set(steps) != {"opt", "kernel-sell", "kernel-fcoo"}:
        raise AssertionError(f"serve: step histograms for {sorted(steps)}")
    # gauges of engines built in earlier phases stay registered at 0
    fracs = {(g["labels"]["executor"], g["labels"]["format"]): g["value"]
             for g in snap["gauges"]
             if g["name"] == "engine.roofline.fraction" and g["value"]}
    gbps = {(g["labels"]["executor"], g["labels"]["format"]): g["value"]
            for g in snap["gauges"]
            if g["name"] == "engine.achieved_bandwidth.gbps"}
    log("serve", "last slice against the H100's 3.35 TB/s: " + ", ".join(
        f"{ex}/{fmt} {f:.4f} ({gbps[ex, fmt]:.1f} GB/s)"
        for (ex, fmt), f in sorted(fracs.items())))
    for key in (("kernel-sell", "sell"), ("kernel-fcoo", "fcoo")):
        if not 0.0 < fracs.get(key, 0.0) <= ROOFLINE_CEILING:
            raise AssertionError(f"serve: roofline fraction {key} "
                                 f"{fracs.get(key)} outside (0, "
                                 f"{ROOFLINE_CEILING}]")
    log("serve", "obs.snapshot() " + json.dumps(snap, allow_nan=False))
    trace_path = os.path.join(root, "serve_trace.json")
    with open(trace_path, "w") as f:
        f.write(obs.TRACER.to_chrome_json())
    log("serve", f"Chrome trace of {len(obs.TRACER.export_chrome())} spans "
        f"written to {os.path.relpath(trace_path, ROOT)}")

    # each job against its own engine's solve
    cfg = LifeConfig(executor="opt", n_iters=SERVE_ITERS, plan_cache_dir="")
    for jid, subject, fmt, _ in SERVE_JOBS:
        p = problem if subject is None else cohort[subject]
        w, losses = results[jid]
        solo = fmt in ("sell", "fcoo")
        w1, l1 = LifeEngine(p, dataclasses.replace(cfg, format=fmt if solo
                                                   else "coo"),
                            device="cuda").run()
        diff = float((w - w1).abs().max())
        if solo:
            same = torch.equal(w, w1) and torch.equal(losses, l1)
            log("serve", f"{jid} vs its own LifeEngine(format={fmt!r}) solve "
                f"of {SERVE_ITERS} iterations: bit-identical {same} (max abs "
                f"diff {diff:.3e})")
            if not same:
                raise AssertionError(f"serve: {jid} differs from its engine")
        else:
            torch.testing.assert_close(w, w1, **TRAJ_TOL)
            log("serve", f"{jid} (cohort bucket) vs its own LifeEngine(opt) "
                f"solve: max abs diff {diff:.3e} (rtol {TRAJ_TOL['rtol']}, "
                f"atol {TRAJ_TOL['atol']}), bit-identical "
                f"{torch.equal(w, w1) and torch.equal(losses, l1)}")
    # the cohort bucket's format, as BatchedLifeEngine resolved it (a
    # plan-cache hit now)
    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.formats.select import resolve_format
    fplan = resolve_format(cohort[0].phi, cohort[0],
                           dataclasses.replace(cfg, format="auto"),
                           PlanCache(os.path.join(root, "plans")),
                           allowed=("coo", "alto"), mesh_aware=False)
    log("serve", f"cohort bucket format: {fplan.describe()}")

    # killed after two ticks, resumed by a fresh service on its directory
    # (the counters start from 0 for each service)
    ck = os.path.join(root, "ckpt")
    obs.reset()
    serve_trace(problem, cohort, ckpt_dir=ck, kill_after=2)
    obs.reset()
    resumed = LifeService(LifeConfig(executor="opt", n_iters=SERVE_ITERS,
                                     plan_cache_dir=os.path.join(root,
                                                                 "plans")),
                          ckpt_dir=ck, slice_iters=SERVE_SLICE,
                          device="cuda")
    adopted = resumed.resumable_jobs
    for jid, subject, fmt, priority in SERVE_JOBS:
        resumed.submit(problem if subject is None else cohort[subject],
                       job_id=jid, format=fmt, priority=priority)
    done = {jid: resumed.scheduler.job(jid).done for jid, *_ in SERVE_JOBS}
    got = resumed.run()
    same = {jid: torch.equal(got[jid][0], results[jid][0])
            and torch.equal(got[jid][1], results[jid][1])
            for jid, *_ in SERVE_JOBS}
    log("serve", f"killed after 2 ticks with {adopted} checkpointed "
        f"(iterations done {done}); the resumed service's jobs bit-identical "
        f"to the uninterrupted run: {same}")
    if not all(same.values()):
        raise AssertionError("serve: a resumed job differs")
    if not serve_counters_hold(obs):
        raise AssertionError("serve: counter algebra broken after resume")

    # the solo sell step with obs on and off, side by side
    eng = LifeEngine(cohort[2], dataclasses.replace(cfg, format="sell"),
                     device="cuda")
    state, _ = eng.step(eng.init_state(), 2)
    times = {"on": [], "off": []}
    for mode in ("off", "on") * 5:
        (obs.enable if mode == "on" else obs.disable)()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step(state, SERVE_SLICE)
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - t0) * 1e3 / SERVE_SLICE)
    log("serve", f"solo sell step of {SERVE_SLICE} iterations, host clock "
        f"to device completion, ms per iteration: obs off "
        f"{sorted(times['off'])}, obs on {sorted(times['on'])}")
    obs.disable()
    obs.reset()
    del svc, resumed, eng
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# 12. learned selection, the async front line and the science workloads
# ----------------------------------------------------------------------------

LEARN_ITERS = 20
#: the front line's jobs: (job id, cohort subject or None for the main
#: problem, format, priority, tune, compute_dtype); phase 11's five, then
#: a tune="cached" sell job replaying phase 8's plan and a tune="full"
#: fcoo job that searches once
FRONT_JOBS = tuple(
    (jid, subject, fmt, priority, None, None)
    for jid, subject, fmt, priority in SERVE_JOBS) + (
    ("tc-sell", None, "sell", 0, "cached", "auto"),
    ("tf-fcoo", 3, "fcoo", 0, "full", None))
ADMISSION_BOUND = 2
LESION_FIBERS = 200
CROSSVAL_FOLDS = 4
CROSSVAL_ITERS = 50
RESUBMIT_ITERS = 16
WAIT_S = 300.0


def path_launches(fmt: str, iters: int) -> dict:
    """B1-B6's launches for ``iters`` iterations from an even counter on
    path ``fmt``: 2 DSC + 1.5 WC per iteration."""
    dsc, wc = PATH_KERNELS[fmt]
    return {dsc: 2 * iters, wc: iters + iters // 2}


def add_launches(total: dict, more: dict) -> dict:
    for k, v in more.items():
        if v:
            total[k] = total.get(k, 0) + v
    return total


class MeasuredLaunches:
    """Kernel launches made inside ``search.time_call`` (the measured rung
    of format selection and the tune searches), counted apart from the
    solves' so that those can be held exactly; the measured ones depend on
    the 20 ms warm-up and are logged."""

    def __enter__(self):
        from repro_torch.kernels import _build
        from repro_torch.tune import search
        self.counts: dict = {}
        self._search, self._orig = search, search.time_call

        def timed(fn, *args, **kw):
            before = dict(_build.LAUNCHES)
            try:
                return self._orig(fn, *args, **kw)
            finally:
                add_launches(self.counts, {
                    k: v - before.get(k, 0)
                    for k, v in _build.LAUNCHES.items()})

        search.time_call = timed
        return self

    def __exit__(self, *exc):
        self._search.time_call = self._orig


def hold_launches(phase: str, what: str, measured: dict, want: dict) -> None:
    """All launches since the last reset, less the measured ones, must be
    exactly ``want``."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    total = {k: v for k, v in _build.LAUNCHES.items() if v}
    solve = {k: v - measured.get(k, 0) for k, v in total.items()
             if v - measured.get(k, 0)}
    log(phase, f"{what}: launches {total}, of them in measurements "
        f"{measured or 'none'}; the solves' {solve} (expected {want})")
    if solve != want:
        raise AssertionError(f"{phase}: {what}: solve launches {solve} != "
                             f"{want}")


def copy_plans(src: str, dst: str) -> int:
    """Copy the ``.npz`` plan entries of cache ``src`` into ``dst``."""
    import shutil
    os.makedirs(dst, exist_ok=True)
    names = [n for n in os.listdir(src) if n.endswith(".npz")]
    for n in names:
        shutil.copy(os.path.join(src, n), os.path.join(dst, n))
    return len(names)


def plan_keys(p, name: str) -> tuple:
    """The FormatPlan key of ``format="auto"`` under ``executor="kernel"``
    and the TunePlan key of executor ``name`` (fp32, default budget) for
    problem ``p``, as the selector and the tuner compute them."""
    from repro_torch.bridge import to_numpy
    from repro_torch.core.plan_cache import format_plan_key, tune_plan_key
    from repro_torch.core.registry import REGISTRY
    from repro_torch.formats import select as fsel
    from repro_torch.tune.tuner import device_count
    ids = tuple(to_numpy(t) for t in (p.phi.atoms, p.phi.voxels,
                                       p.phi.fibers))
    sizes = (p.phi.n_atoms, p.phi.n_voxels, p.phi.n_fibers)
    fkey = format_plan_key(*ids, sizes=sizes, row_tile=8, slot_tile=32,
                           allowed=fsel.DEFAULT_CANDIDATES, backend="cuda",
                           coo_executor="kernel",
                           sell_accept=fsel.DEFAULT_SELL_ACCEPT,
                           sell_reject=fsel.DEFAULT_SELL_REJECT)
    tkey = tune_plan_key(*ids, sizes=sizes,
                         n_theta=int(p.dictionary.shape[1]), executor=name,
                         fmt=REGISTRY.consumes(name), backend="cuda",
                         n_devices=device_count("cuda"), compute_dtype="fp32",
                         budget=12, mesh=(1, 1))
    return fkey, tkey


def phase_learn(cohort) -> None:
    """12a: a predictor trained on phases 5 and 8's plans and subjects 0-2
    answers subject 3's cold start with zero measurements; the front
    line's idle ticks then refine both plans in place.  Launches: the
    predicted engine's 20 iterations exactly 2 DSC + 1.5 WC each of its
    path (40 + 30); the refinement's all inside measurements."""
    import shutil
    from repro_torch import obs
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.formats import select as fsel
    from repro_torch.formats.select import resolve_format
    from repro_torch.kernels import _build
    from repro_torch.learn import (clear_load_memo, predictor_path, refine,
                                   train_predictor)
    from repro_torch.serve import LifeFrontend
    from repro_torch.tune import search
    from repro_torch.tune.tuner import resolve_plan
    root = os.path.join(ROOT, "build", "learn")
    train_dir, cold_dir = (os.path.join(root, d) for d in ("train", "cold"))
    shutil.rmtree(train_dir, ignore_errors=True)
    shutil.rmtree(cold_dir, ignore_errors=True)
    refine.QUEUE.clear()
    clear_load_memo()
    obs.enable()
    obs.reset()

    # 1. the training cache
    t0 = time.perf_counter()
    copied = copy_plans(os.path.join(root, "phase5"), train_dir)
    for fmt in ("coo", "sell", "fcoo"):
        copied += copy_plans(os.path.join(ROOT, "build", "tune-cache", fmt),
                             train_dir)
    cache = PlanCache(train_dir)
    _build.reset_launches()
    with MeasuredLaunches() as m:
        picks = []
        for s in range(3):
            cfg = LifeConfig(executor="kernel", format="auto",
                             plan_cache_dir=train_dir)
            plan = resolve_format(cohort[s].phi, cohort[s], cfg, cache)
            picks.append(plan.format)
            log("learn", f"subject {s}: format=auto under executor=kernel "
                f"-> {plan.describe()}")
        sell_cfg = LifeConfig(executor="opt", format="sell", tune="full",
                              plan_cache_dir=train_dir)
        tplan = resolve_plan("kernel-sell", cohort[0].phi, cohort[0],
                             sell_cfg, cache)
    hold_launches("learn", "training selections and search", m.counts, {})
    log("learn", f"tune=full kernel-sell (fp32) on subject 0: "
        f"{tplan.describe()} over {len(tplan.measurements)} candidates")
    predictor = train_predictor(cache)
    if predictor is None or predictor.tune_model is None:
        raise AssertionError("learn: no predictor trained")
    log("learn", f"training cache: {copied} plans copied from phases 5 and "
        f"8, then subjects 0-2 picked {picks}; train_predictor: "
        f"{predictor.n_format_examples} format examples, "
        f"{predictor.n_tune_examples} tune examples, tune groups "
        f"{sorted(predictor.tune_model.groups)}; "
        f"{time.perf_counter() - t0:.2f} s")

    # 2-3. subject 3, held out, in a cache holding only predictor.json
    os.makedirs(cold_dir)
    shutil.copy(predictor_path(train_dir), predictor_path(cold_dir))
    calls = []
    orig_autotune = fsel.autotune_plan
    fsel.autotune_plan = lambda *a, **k: calls.append(1) or orig_autotune(
        *a, **k)
    try:
        n0 = search.measurement_count()
        t0 = time.perf_counter()
        cfg = LifeConfig(executor="kernel", format="auto", tune="cached",
                         n_iters=LEARN_ITERS, plan_cache_dir=cold_dir)
        engine = LifeEngine(cohort[3], cfg, device="cuda")
        build_s = time.perf_counter() - t0
        made = search.measurement_count() - n0
    finally:
        fsel.autotune_plan = orig_autotune
    fplan, tplan = engine.format_plan, engine.tune_plan
    hits = {kind: obs.value("learn.predict", kind=kind, outcome="hit")
            for kind in ("format", "tune")}
    log("learn", f"subject 3 cold start in {build_s:.2f} s: "
        f"{fplan.describe()}, {tplan.describe()} on executor "
        f"{engine.executor.name}; {made} measurements, {len(calls)} "
        f"autotune_plan calls; learn.predict hits {hits}; refine queue "
        f"{len(refine.QUEUE)}")
    if (fplan.reason, tplan.reason) != ("predicted", "predicted") or made \
            or calls or hits != {"format": 1.0, "tune": 1.0}:
        raise AssertionError("learn: the cold start was not predicted with "
                             "zero measurements")

    # 4. the predicted engine's solve against subject 3's opt solve
    _build.reset_launches()
    w, losses = engine.run()
    hold_launches("learn", f"{LEARN_ITERS} iterations on the predicted "
                  "plans", {}, path_launches(fplan.format, LEARN_ITERS))
    w_opt, _ = LifeEngine(cohort[3], LifeConfig(
        executor="opt", n_iters=LEARN_ITERS, plan_cache_dir=""),
        device="cuda").run()
    diff = float((w - w_opt).abs().max())
    log("learn", f"weights vs subject 3's opt solve: max abs diff "
        f"{diff:.3e} (rtol {TRAJ_TOL['rtol']}, atol {TRAJ_TOL['atol']}); "
        f"loss {float(losses[0]):.6e} -> {float(losses[-1]):.6e}")
    torch.testing.assert_close(w, w_opt, **TRAJ_TOL)
    name = engine.executor.name
    del engine

    # 5-6. the front line's idle ticks drain the refine queue
    fkey, tkey = plan_keys(cohort[3], name)
    cold = PlanCache(cold_dir)
    before = (cold.get_format_plan(fkey), cold.get_tune_plan(tkey))
    queued = len(refine.QUEUE)
    _build.reset_launches()
    with MeasuredLaunches() as m:
        t0 = time.perf_counter()
        fe = LifeFrontend(LifeConfig(plan_cache_dir=cold_dir),
                          idle_wait=0.001, device="cuda")
        deadline = time.monotonic() + WAIT_S
        done = lambda: obs.value("learn.refine.completed", kind="format") \
            + obs.value("learn.refine.completed", kind="tune") \
            + obs.value("learn.refine.failed", kind="format") \
            + obs.value("learn.refine.failed", kind="tune")
        while done() < queued and time.monotonic() < deadline:
            time.sleep(0.01)
        refine_s = time.perf_counter() - t0
        fe.shutdown(timeout=WAIT_S)
    hold_launches("learn", "refinement", m.counts, {})
    after = (cold.get_format_plan(fkey), cold.get_tune_plan(tkey))
    log("learn", f"refinement of {queued} tasks on the front line's idle "
        f"ticks: {refine_s:.2f} s; format {before[0].describe()} -> "
        f"{after[0].describe()}; tune {before[1].describe()} -> "
        f"{after[1].describe()} ({len(after[1].measurements)} candidates);"
        f" predicted format equals the refined one: "
        f"{before[0].format == after[0].format}; last error "
        f"{refine.QUEUE.last_error!r}")
    if (queued != 2 or len(refine.QUEUE) or refine.QUEUE.last_error
            is not None or after[0].reason not in ("heuristic", "autotune")
            or after[1].reason != "search"):
        raise AssertionError("learn: the refinement did not overwrite both "
                             "predicted plans")
    obs.disable()
    obs.reset()
    torch.cuda.empty_cache()


def front_problem(problem, cohort, subject):
    return problem if subject is None else cohort[subject]


def submit_front(fe, problem, cohort, jobs, adopted=()) -> dict:
    """``submit_async`` each of ``jobs``; returns {job id: handle}.  A job
    the service re-adopts from its checkpoint is resubmitted without its
    compute dtype: the checkpoint holds the one it resolved to."""
    handles = {}
    for jid, subject, fmt, priority, tune, dtype in jobs:
        handles[jid] = fe.submit_async(
            front_problem(problem, cohort, subject), job_id=jid, format=fmt,
            priority=priority, tune=tune,
            compute_dtype=None if jid in adopted else dtype, timeout=WAIT_S)
    return handles


def backpressure_demos() -> None:
    """The three policies at an admission bound of ADMISSION_BOUND, with
    the driver not started (the queue fills deterministically); cancelling
    a pending job frees a place without the driver."""
    import threading
    from repro_torch import obs
    from repro_torch.core.life import LifeConfig
    from repro_torch.serve import AdmissionQueueFull, LifeFrontend
    from repro_torch.data.dmri import synth_connectome
    p = synth_connectome(n_fibers=64, n_theta=16, n_atoms=24,
                         grid=(10, 10, 10), seed=1, device="cuda")
    cfg = LifeConfig(executor="opt", plan_cache_dir="")

    def frontend(policy):
        return LifeFrontend(cfg, max_queue=ADMISSION_BOUND,
                            backpressure=policy, start=False, device="cuda")

    fe = frontend("reject")
    held = [fe.submit_async(p, n_iters=4) for _ in range(ADMISSION_BOUND)]
    try:
        fe.submit_async(p, n_iters=4)
        raise AssertionError("front: reject admitted past the bound")
    except AdmissionQueueFull as exc:
        log("front", f"reject at {ADMISSION_BOUND} pending: "
            f"AdmissionQueueFull({exc}); serve.admission.rejected "
            f"{obs.value('serve.admission.rejected')}")
    for h in held:
        h.cancel()

    fe = frontend("shed")
    lo = fe.submit_async(p, n_iters=4, priority=0)
    mid = fe.submit_async(p, n_iters=4, priority=3)
    hi = fe.submit_async(p, n_iters=4, priority=5)
    low_new = fe.submit_async(p, n_iters=4, priority=1)
    log("front", f"shed at {ADMISSION_BOUND} pending: priority 0 -> "
        f"{lo.status()} ({lo.exception(timeout=1)}), a newcomer of "
        f"priority 1 -> {low_new.status()}, priorities 3 and 5 -> "
        f"{mid.status()}, {hi.status()}; serve.admission.shed "
        f"{obs.value('serve.admission.shed')}")
    if (lo.status(), low_new.status(), mid.status(), hi.status()) != (
            "shed", "shed", "pending", "pending"):
        raise AssertionError("front: shed did not evict the lowest priority")
    mid.cancel()
    hi.cancel()

    fe = frontend("block")
    held = [fe.submit_async(p, n_iters=4) for _ in range(ADMISSION_BOUND)]
    got = []
    t0 = time.perf_counter()
    th = threading.Thread(target=lambda: got.append(
        (fe.submit_async(p, n_iters=4, timeout=WAIT_S),
         time.perf_counter())))
    th.start()
    time.sleep(0.2)
    waiting = th.is_alive() and not got
    held[0].cancel()                     # frees one place
    th.join(WAIT_S)
    if not waiting or th.is_alive() or not got:
        raise AssertionError("front: block did not wait and then admit")
    log("front", f"block at {ADMISSION_BOUND} pending: the submitter waited "
        f"{got[0][1] - t0:.3f} s until a place freed, then its job was "
        f"admitted ({got[0][0].status()}); serve.admission.depth "
        f"{obs.value('serve.admission.depth')}")
    for h in (held[1], got[0][0]):
        h.cancel()


def front_results(handles: dict, jids) -> dict:
    return {jid: handles[jid].result(timeout=WAIT_S) for jid in jids}


def phase_front(problem, cohort) -> dict:
    """12b: the async front line over a LifeService (obs on, slices of 16)
    at full width.  Launches: exactly 2 DSC + 1.5 WC per iteration of the
    solo jobs (B3/B4: s2-sell and tc-sell 64 each and the cancelled sell
    job's iterations; B5/B6: s3-fcoo and tf-fcoo 64 each), besides
    tf-fcoo's one search; the resume legs together again 4 x 64 of the
    solo jobs and no search.  Returns the healthy jobs' results."""
    import dataclasses as dc
    import shutil
    from repro_torch import obs
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.kernels import _build
    from repro_torch.serve import (JobCancelledError, JobFailedError,
                                   LifeFrontend, LifeService)
    root = os.path.join(ROOT, "build", "frontline")
    shutil.rmtree(root, ignore_errors=True)
    plans = os.path.join(root, "plans")
    copied = copy_plans(os.path.join(ROOT, "build", "tune-cache", "sell"),
                        plans)
    cfg = LifeConfig(executor="opt", n_iters=SERVE_ITERS,
                     plan_cache_dir=plans)
    obs.enable()
    obs.reset()
    backpressure_demos()

    # 1, 3, 4: the jobs, two poisoned tenants, two cancellations
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with MeasuredLaunches() as m:
        t0 = time.perf_counter()
        fe = LifeFrontend(cfg, ckpt_dir=os.path.join(root, "ckpt"),
                          slice_iters=SERVE_SLICE, checkpoint_every=0,
                          max_queue=16, device="cuda", start=False)
        pending = fe.submit_async(cohort[1], job_id="cancel-pending",
                                  format="fcoo")
        if not pending.cancel() or pending.status() != "cancelled":
            raise AssertionError("front: a pending job did not cancel")
        first = [j for j in FRONT_JOBS if j[0] != SERVE_JOBS[-1][0]]
        handles = submit_front(fe, problem, cohort, first)
        nan_w0 = np.ones(problem.phi.n_fibers, np.float32)
        nan_w0[7] = np.nan
        handles["poison-nan"] = fe.submit_async(
            cohort[2], job_id="poison-nan", format="sell", w0=nan_w0,
            timeout=WAIT_S)
        handles["poison-run"] = fe.submit_async(
            dataclasses.replace(cohort[1], b=cohort[1].b[:-3]),
            job_id="poison-run", format="auto", timeout=WAIT_S)
        handles["cancel-running"] = fe.submit_async(
            cohort[1], job_id="cancel-running", format="sell",
            n_iters=100 * SERVE_ITERS, priority=2, timeout=WAIT_S)
        fe.start()
        # the most urgent job is cancelled after its first slice; the late
        # arrival joins once the cohort bucket has run a slice
        ev = handles["cancel-running"].events(timeout=WAIT_S)
        if next(ev)["type"] != "progress" or \
                not handles["cancel-running"].cancel():
            raise AssertionError("front: a running job did not cancel")
        next(handles["s0-auto"].events(timeout=WAIT_S))
        handles.update(submit_front(fe, problem, cohort,
                                    [j for j in FRONT_JOBS
                                     if j[0] == SERVE_JOBS[-1][0]]))
        jids = [j[0] for j in FRONT_JOBS]
        results = front_results(handles, jids)
        for jid in ("poison-nan", "poison-run", "cancel-running"):
            handles[jid].exception(timeout=WAIT_S)
        fe.shutdown(timeout=WAIT_S)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    svc = fe.service
    cancelled_done = svc.job("cancel-running").done
    want = {}
    for jid, _, fmt, *_ in FRONT_JOBS:
        if fmt in ("sell", "fcoo"):
            add_launches(want, path_launches(fmt, SERVE_ITERS))
    add_launches(want, path_launches("sell", cancelled_done))
    hold_launches("front", f"{len(jids)} jobs, 2 poisoned, 2 cancelled",
                  m.counts, want)
    latencies = {jid: svc.job(jid).prior_elapsed + svc.job(jid).finished_at
                 - svc.job(jid).submitted_at for jid in jids}
    log("front", f"{len(jids)} jobs of {SERVE_ITERS} iterations through "
        f"submit_async in {wall:.3f} s wall ({len(jids) / wall:.2f} jobs/s, "
        f"builds, selection, one search and intake hashing included); peak"
        f" memory {peak:.1f} MiB; latency by job: " + ", ".join(
            f"{jid} {t:.3f} s" for jid, t in latencies.items()))
    statuses = {jid: h.status() for jid, h in handles.items()}
    statuses["cancel-pending"] = pending.status()
    errors = {jid: repr(handles[jid].exception(timeout=WAIT_S))[:160]
              for jid in ("poison-nan", "poison-run", "cancel-running")}
    log("front", f"statuses {statuses}; errors {errors}")
    ended = {jid: handles[jid].exception(timeout=WAIT_S)
             for jid in ("poison-nan", "poison-run", "cancel-running")}
    if (statuses["poison-nan"] != "rejected"
            or not isinstance(ended["poison-nan"], ValueError)
            or statuses["poison-run"] != "failed"
            or not isinstance(ended["poison-run"], JobFailedError)
            or statuses["cancel-running"] != "cancelled"
            or not isinstance(ended["cancel-running"], JobCancelledError)
            or any(statuses[j] != "done" for j in jids)):
        raise AssertionError(f"front: unexpected statuses {statuses}")
    searches = {ex: obs.value("tune.searches", executor=ex)
                for ex in ("kernel-sell", "kernel-fcoo")}
    log("front", f"tune.searches {searches} (tc-sell replays phase 8's plan "
        f"from the {copied} plans copied, tf-fcoo searches once); "
        f"serve.admission depth {obs.value('serve.admission.depth')}, "
        f"rejected {obs.value('serve.admission.rejected')}, shed "
        f"{obs.value('serve.admission.shed')}")
    if searches != {"kernel-sell": 0.0, "kernel-fcoo": 1.0}:
        raise AssertionError(f"front: tune searches {searches}")
    if not serve_counters_hold(obs):
        raise AssertionError("front: counter algebra broken")

    # 5: events per slice; each job against its own solve
    n = SERVE_ITERS // SERVE_SLICE
    for jid in jids:
        w, losses = results[jid]
        if tuple(losses.shape) != (SERVE_ITERS,) or not (
                torch.isfinite(w).all() and torch.isfinite(losses).all()):
            raise AssertionError(f"front: {jid} not finite of its shape")
    evs = list(handles["s2-sell"].events(timeout=WAIT_S))
    progress = [e["done"] for e in evs if e["type"] == "progress"]
    log("front", f"s2-sell events: {len(progress)} progress events at "
        f"{progress}, then {evs[-1]}")
    if progress != [SERVE_SLICE * (i + 1) for i in range(n)] or \
            evs[-1] != {"type": "done"}:
        raise AssertionError("front: s2-sell's events are not one per slice")
    solo_cfg = dc.replace(cfg, n_iters=SERVE_ITERS)
    opt_w = {}
    for jid, subject, fmt, _, tune, dtype in FRONT_JOBS:
        p = front_problem(problem, cohort, subject)
        w, losses = results[jid]
        if fmt in ("sell", "fcoo"):
            jcfg = dc.replace(solo_cfg, format=fmt,
                              tune="cached" if tune else "off",
                              compute_dtype=dtype or "fp32")
            eng = LifeEngine(p, jcfg, device="cuda")
            w1, l1 = eng.run()
            same = torch.equal(w, w1) and torch.equal(losses, l1)
            log("front", f"{jid} vs its own LifeEngine({fmt}, tune="
                f"{jcfg.tune}, {eng.resolved_compute_dtype}"
                f"{', ' + eng.tune_plan.describe() if eng.tune_plan else ''}"
                f") solve: bit-identical {same}")
            if not same:
                raise AssertionError(f"front: {jid} differs from its engine")
        else:
            key = 0 if subject is None else subject
            if key not in opt_w:
                opt_w[key], _ = LifeEngine(p, dc.replace(
                    solo_cfg, plan_cache_dir=""), device="cuda").run()
            torch.testing.assert_close(w, opt_w[key], **TRAJ_TOL)
            log("front", f"{jid} (cohort bucket) vs its own opt solve: max "
                f"abs diff {float((w - opt_w[key]).abs().max()):.3e}")
    snap = svc.metrics_snapshot()
    log("front", "obs.snapshot() " + json.dumps(snap, allow_nan=False))

    # 6: shutdown(drain=False) mid-run, resumed by a fresh frontend
    healthy = list(FRONT_JOBS)
    ck = os.path.join(root, "ckpt-kill")
    obs.reset()
    _build.reset_launches()
    with MeasuredLaunches() as m:
        fe = LifeFrontend(cfg, ckpt_dir=ck, slice_iters=SERVE_SLICE,
                          checkpoint_every=0, device="cuda", start=False)
        killed = submit_front(fe, problem, cohort, healthy)
        fe.start()
        next(killed[SERVE_JOBS[-1][0]].events(timeout=WAIT_S))
        fe.shutdown(drain=False, timeout=WAIT_S)
        known = {j.job_id for j in fe.service.scheduler.jobs()}
        stopped = {jid: fe.service.job(jid).done if jid in known else None
                   for jid in killed}
        ended = {jid: type(h.exception(timeout=WAIT_S)).__name__
                 for jid, h in killed.items()}
        fresh = LifeFrontend(service=LifeService(
            cfg, ckpt_dir=ck, slice_iters=SERVE_SLICE, device="cuda"))
        adopted = fresh.service.resumable_jobs
        again = submit_front(fresh, problem, cohort, healthy, adopted)
        got = front_results(again, [j[0] for j in healthy])
        fresh.shutdown(timeout=WAIT_S)
    want = {}
    for jid, _, fmt, *_ in healthy:
        if fmt in ("sell", "fcoo"):
            add_launches(want, path_launches(fmt, SERVE_ITERS))
    hold_launches("front", "killed and resumed legs", m.counts, want)
    same = {jid: torch.equal(got[jid][0], results[jid][0])
            and torch.equal(got[jid][1], results[jid][1])
            for jid, *_ in healthy}
    log("front", f"shutdown(drain=False) after the first slice: iterations "
        f"done {stopped}, handles ended with {ended}; adopted {adopted}; "
        f"the fresh frontend's jobs bit-identical to the uninterrupted run:"
        f" {same}")
    if set(ended.values()) - {"ShutdownError", "NoneType"} or not adopted \
            or not all(same.values()):
        raise AssertionError("front: a resumed job differs or a handle "
                             "hung")

    # 7: compaction is refused by the service on the card
    try:
        LifeService(LifeConfig(compact_every=50), device="cuda")
        raise AssertionError("front: compact_every > 0 was accepted")
    except ValueError as exc:
        log("front", f"LifeService(LifeConfig(compact_every=50)) on the "
            f"card: ValueError({exc})")
    obs.disable()
    obs.reset()
    torch.cuda.empty_cache()
    return results


def phase_science(problem) -> None:
    """12c: the science workloads on the main problem.  Launches, exactly:
    crossval on kernel 4 folds x 50 iterations (B1 400, B2 300); the
    lesion's warm and cold sell solves (B3 2(w + c), B4 1.5(w + c) for
    their iterations w and c); multires on fcoo over both levels (B5
    2(l1 + l2), B6 1.5(l1 + l2)), its resumed call none; the resubmitted
    delta 16 sell iterations (B3 32, B4 24)."""
    import shutil
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.data.dmri import fiber_bundles
    from repro_torch.kernels import _build
    from repro_torch.science import (crossval_rmse, lesion_problem,
                                     multires_solve, prune_connectome,
                                     resubmit_delta, solve_to_convergence,
                                     virtual_lesion)
    from repro_torch.serve import LifeFrontend
    root = os.path.join(ROOT, "build", "science")
    shutil.rmtree(root, ignore_errors=True)

    # 1. crossval on B1/B2 and on opt
    t0 = time.perf_counter()
    _build.reset_launches()
    cv = crossval_rmse(problem, LifeConfig(executor="kernel",
                                           plan_cache_dir=""),
                       k=CROSSVAL_FOLDS, n_iters=CROSSVAL_ITERS,
                       device="cuda")
    hold_launches("science", "crossval on kernel", {},
                  path_launches("coo", CROSSVAL_FOLDS * CROSSVAL_ITERS))
    cv_opt = crossval_rmse(problem, LifeConfig(executor="opt",
                                               plan_cache_dir=""),
                           k=CROSSVAL_FOLDS, n_iters=CROSSVAL_ITERS,
                           device="cuda")
    rel = max(abs(a - b) / b for a, b in zip(cv.fold_rmse, cv_opt.fold_rmse))
    log("science", f"crossval k={CROSSVAL_FOLDS}, {CROSSVAL_ITERS} "
        f"iterations a fold: kernel {cv.fold_rmse}, opt {cv_opt.fold_rmse},"
        f" null {cv.null_rmse:.6f}; max rel diff {rel:.3e} (rtol 1e-3); "
        f"{time.perf_counter() - t0:.2f} s")
    if not all(r < cv.null_rmse for r in cv.fold_rmse) or rel > 1e-3:
        raise AssertionError("science: crossval off the null or off opt")

    # 2. a virtual lesion on sell, warm from phase 11's checkpoint
    t0 = time.perf_counter()
    bundle = fiber_bundles(problem, bundle_size=LESION_FIBERS, seed=0)[0]
    sell = LifeConfig(executor="opt", format="sell", plan_cache_dir="")
    ck = os.path.join(ROOT, "build", "serve", "ckpt")
    _build.reset_launches()
    rep = virtual_lesion(problem, bundle, sell, ckpt_dir=ck,
                         job_id="main-auto", device="cuda")
    lesioned = lesion_problem(problem, bundle)
    cold = solve_to_convergence(LifeEngine(lesioned, sell, device="cuda"))
    hold_launches("science", "lesion warm and cold sell solves", {},
                  path_launches("sell", rep.iters_warm + cold.iters))
    rep_opt = virtual_lesion(problem, bundle, LifeConfig(
        executor="opt", plan_cache_dir=""), ckpt_dir=ck, job_id="main-auto",
        device="cuda")
    zero = bool(np.all(rep.w_lesioned[bundle] == 0.0))
    log("science", f"virtual lesion of {bundle.size} fibers on sell, warm "
        f"from phase 11's main-auto: footprint {rep.footprint.size} voxels,"
        f" rmse {rep.rmse_full:.6f} -> {rep.rmse_lesioned:.6f}, evidence "
        f"{rep.evidence:+.6e} (opt {rep_opt.evidence:+.6e}); warm "
        f"{rep.iters_warm} iterations, cold {cold.iters}; lesioned fibers "
        f"exactly 0: {zero}; {time.perf_counter() - t0:.2f} s")
    if not zero or rep.iters_warm > cold.iters or rep.iters_full or \
            abs(rep.evidence - rep_opt.evidence) > 1e-2 * abs(
                rep_opt.evidence):
        raise AssertionError("science: the virtual lesion failed its holds")

    # 3. multires on fcoo, resumed from its checkpoint
    t0 = time.perf_counter()
    fcoo = LifeConfig(executor="opt", format="fcoo", plan_cache_dir="")
    mr_dir = os.path.join(root, "multires")
    _build.reset_launches()
    mr = multires_solve(problem, fcoo, factors=(2,), ckpt_dir=mr_dir,
                        device="cuda")
    again = multires_solve(problem, fcoo, factors=(2,), ckpt_dir=mr_dir,
                           device="cuda")
    hold_launches("science", "multires on fcoo and its resumed call", {},
                  path_launches("fcoo", mr.total_iters))
    same = bool(np.array_equal(again.final.w, mr.final.w))
    log("science", f"{mr.describe()}; resumed: {again.describe()} "
        f"(resumed_at {again.resumed_at}), final weights bit-identical "
        f"{same}; {time.perf_counter() - t0:.2f} s")
    if again.resumed_at != 2 or again.total_iters or not same:
        raise AssertionError("science: multires did not resume bit for bit")

    # 4. the pruned connectome, on the card and on the CPU
    pr = prune_connectome(problem, mr.final.w)
    pr_cpu = prune_connectome(problem.to("cpu"), mr.final.w)
    log("science", pr.describe() + f"; support equals the CPU's: "
        f"{np.array_equal(pr.support, pr_cpu.support)}")
    if not np.array_equal(pr.support, pr_cpu.support) or \
            pr.phi.n_coeffs != pr_cpu.phi.n_coeffs:
        raise AssertionError("science: the pruned support differs on the CPU")

    # 5. the lesioned problem resubmitted through the front line, warm
    _build.reset_launches()
    with LifeFrontend(LifeConfig(executor="opt", plan_cache_dir=""),
                      refine=False, device="cuda") as fe:
        h = resubmit_delta(fe, lesioned, rep.w_full, lesioned=bundle,
                           n_iters=RESUBMIT_ITERS, format="sell")
        w, losses = h.result(timeout=WAIT_S)
    hold_launches("science", "resubmitted delta", {},
                  path_launches("sell", RESUBMIT_ITERS))
    zero = bool((w[torch.as_tensor(bundle, device=w.device)] == 0).all())
    log("science", f"resubmit_delta through the front line: lesioned "
        f"weights exactly 0 {zero}; first loss {float(losses[0]):.6e} "
        f"against the cold start's {float(cold.losses[0]):.6e}")
    if not zero or not float(losses[0]) < float(cold.losses[0]):
        raise AssertionError("science: the warm resubmission failed")
    torch.cuda.empty_cache()


def phase_slice_ten(problem, cohort) -> None:
    """Phase 12: 12a learned selection, 12b the front line, 12c science."""
    for name, fn in (("learn", lambda: phase_learn(cohort)),
                     ("front", lambda: phase_front(problem, cohort)),
                     ("science", lambda: phase_science(problem))):
        t0 = time.perf_counter()
        fn()
        log(name, f"sub-phase took {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------------------
# 13. the mesh partition: shard / shard-sell, B3/B4 per cell, SPMD ranks
# ----------------------------------------------------------------------------

MESH_ITERS = 20
MESH_SHAPE = (2, 2)
MESH_SPMD_ITERS = 10
MESH_1D_ITERS = 4
MESH_NCCL_ITERS = 5
MESH_SERVE_ITERS = 32
MESH_SERVE_SLICE = 16
#: the SPMD steps against LifeEngine(opt) (tests/test_distributed.py:58)
SPMD_TOL = dict(rtol=1e-3, atol=1e-4)
#: per-rank SpMVs against the local mesh's ordered sums, relative to the
#: largest |value|
SPMD_OPS_RTOL = 1e-6
#: each SPMD run's deadline, the ranks' start-up included
SPMD_DEADLINE_S = 240.0
MESH_DIR = os.path.join(ROOT, "build", "mesh")


def mesh_solve(problem, cfg):
    """A LifeEngine solve of ``cfg`` with every launch count set to 0 just
    before; returns (engine, weights, losses, launches, seconds)."""
    from repro_torch.core.life import LifeEngine
    from repro_torch.kernels import _build
    eng = LifeEngine(problem, cfg, device="cuda")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    w, losses = eng.run()
    torch.cuda.synchronize()
    return (eng, w, losses, {k: v for k, v in _build.LAUNCHES.items() if v},
            time.perf_counter() - t0)


def mesh_engines(problem) -> dict:
    """13a: the registry's mesh executors at (1, 1) on the card: exact
    B3/B4 launches, weights against opt, shard-sell bit for bit
    kernel-sell, a (2, 2) engine refused."""
    from repro_torch.core.life import LifeConfig, LifeEngine
    base = LifeConfig(n_iters=MESH_ITERS, plan_cache_dir="")
    eng, w_opt, _, _, s_opt = mesh_solve(problem, base)
    opt_ms, _ = time_steps(eng, eng.init_state())
    sell_want = {"dsc_sell": 2 * MESH_ITERS, "wc_sell": 3 * MESH_ITERS // 2}
    got = {}
    for name, kw, want in (
            ("shard", dict(executor="shard"), {}),
            ("shard-sell", dict(executor="shard-sell", format="sell"),
             sell_want),
            ("kernel-sell", dict(executor="kernel-sell", format="sell"),
             sell_want)):
        eng, w, losses, counts, secs = mesh_solve(
            problem, dataclasses.replace(base, **kw))
        diff = float((w - w_opt).abs().max())
        step_ms, _ = time_steps(eng, eng.init_state())
        log("mesh", f"13a {name} (1, 1): executor {eng.executor.name}, "
            f"{MESH_ITERS} iterations in {secs:.3f} s (opt {s_opt:.3f} s), "
            f"launches {counts} (expected {want}), weights vs opt max abs "
            f"diff {diff:.3e}, loss {float(losses[-1]):.6e}; step "
            f"{step_ms:.4f} ms (opt {opt_ms:.4f} ms; CUDA events over 20 "
            f"iterations)")
        if eng.executor.name != name or counts != want:
            raise AssertionError(f"mesh: {name} ran {eng.executor.name} "
                                 f"with launches {counts} != {want}")
        torch.testing.assert_close(w, w_opt, **TRAJ_TOL)
        got[name] = (w, losses, counts)
    same = (torch.equal(got["shard-sell"][0], got["kernel-sell"][0])
            and torch.equal(got["shard-sell"][1], got["kernel-sell"][1]))
    log("mesh", f"13a shard-sell (1, 1) bit-identical to kernel-sell (the "
        f"cell is the whole Phi): {same}")
    if not same:
        raise AssertionError("mesh: shard-sell (1, 1) differs from "
                             "kernel-sell")
    try:
        LifeEngine(problem, dataclasses.replace(
            base, executor="shard-sell", format="sell",
            shard_rows=MESH_SHAPE[0], shard_cols=MESH_SHAPE[1]),
            device="cuda")
    except ValueError as exc:
        log("mesh", f"13a a {MESH_SHAPE} engine refused: {exc}")
        if "needs 4 devices, have 1" not in str(exc):
            raise
    else:
        raise AssertionError("mesh: a (2, 2) engine was not refused")
    return got["shard-sell"][2]


def sell_cell(shard, r: int, c: int):
    """Cell (r, c) of a sell ShardPhi as a SellPhi (views of the stacked
    arrays)."""
    from repro_torch.formats.sell import SellPhi
    return SellPhi(op=shard.op, atoms=shard.arrays["atoms"][r, c],
                   others=shard.arrays["others"][r, c],
                   values=shard.arrays["values"][r, c],
                   row_nnz=shard.arrays["row_nnz"][r, c],
                   row_tile=shard.row_tile, slot_tile=shard.slot_tile,
                   n_atoms=shard.n_atoms, n_voxels=shard.nv_local,
                   n_fibers=shard.nf_local)


def mesh_cells(problem, errors: dict) -> tuple:
    """13b: B3 and B4 at the cell shapes of a (2, 2) partition (and at an
    empty cell) against their plain versions and float64 oracles, timed
    beside their bounds.  Returns the sell ShardPhis and each cell's
    device operands."""
    from repro_torch.core.std import PhiTensor
    from repro_torch.formats.sell import SellPhi
    from repro_torch.formats.shard import encode_pair
    from repro_torch.kernels import ops
    from repro_torch.roofline import spmv_bytes as sb
    phi, d = problem.phi, problem.dictionary
    n_theta = d.shape[1]
    t0 = time.perf_counter()
    sd, sw = encode_pair(phi, cell_format="sell", R=MESH_SHAPE[0],
                         C=MESH_SHAPE[1], row_tile=8, slot_tile=32)
    log("mesh", f"13b {MESH_SHAPE} sell partition encoded in "
        f"{time.perf_counter() - t0:.2f} s: voxel cuts "
        f"{sd.voxel_cuts.tolist()}, fiber cuts {sd.fiber_cuts.tolist()}, "
        f"nv_local {sd.nv_local}, nf_local {sd.nf_local}, cell nnz "
        f"{sd.cell_nnz.tolist()}; DSC width {sd.arrays['atoms'].shape[3]} "
        f"(padding {sd.padding_overhead:.3f}, {sd.nbytes} bytes), WC width "
        f"{sw.arrays['atoms'].shape[3]} (padding "
        f"{sw.padding_overhead:.3f}, {sw.nbytes} bytes)")
    cells = {(r, c): (sell_cell(sd, r, c), sell_cell(sw, r, c))
             for r in range(MESH_SHAPE[0]) for c in range(MESH_SHAPE[1])}
    cases = {f"cell ({r},{c})": v for (r, c), v in cells.items()}
    if not (sd.cell_nnz == 0).any():
        # no cell of this partition is empty: build one on purpose, at the
        # partition's cell shape
        empty = PhiTensor(
            atoms=torch.zeros(0, dtype=torch.int32),
            voxels=torch.zeros(0, dtype=torch.int32),
            fibers=torch.zeros(0, dtype=torch.int32),
            values=torch.zeros(0), n_atoms=phi.n_atoms,
            n_voxels=sd.nv_local, n_fibers=sd.nf_local)
        cases["empty cell (built)"] = (
            SellPhi.encode(empty, op="dsc", row_tile=8, slot_tile=32),
            SellPhi.encode(empty, op="wc", row_tile=8, slot_tile=32))
    g = torch.Generator(device="cuda").manual_seed(13)
    operands = {}
    rows = []
    for case, (cd_, cw_) in cases.items():
        od = ops.sell_operands(cd_, "cuda")
        ow = ops.sell_operands(cw_, "cuda")
        w = torch.rand(sd.nf_local, generator=g, device="cuda")
        y = torch.randn(sd.nv_local, n_theta, generator=g, device="cuda")
        for name, o, x, cell in (("dsc_sell", od, w, cd_),
                                 ("wc_sell", ow, y, cw_)):
            got = run_format(name, o, d, x)
            plain = run_format(name, o, d, x, plain=True)
            compare(name, f"mesh {case}", got, plain, "fp32", errors)
            hold_to_oracle(name, f"mesh {case}", "fp32", got, plain,
                           *format_oracle(name, o, d, x, got.shape[0]))
            if cell.n_coeffs == 0 and got.count_nonzero():
                raise AssertionError(f"{name} mesh {case}: an empty cell "
                                     "wrote a nonzero")
            rows_padded = cell.atoms.shape[0]
            fn = sb.dsc_sell if name == "dsc_sell" else sb.wc_sell
            size = (dict(n_fibers=sd.nf_local) if name == "dsc_sell"
                    else dict(n_voxels=sd.nv_local))
            work = fn(cell.n_coeffs, n_theta, n_rows=cell.row_nnz.size,
                      rows_padded=rows_padded,
                      d_bytes=d.numel() * d.element_size(), **size)
            ms = time_ms(lambda: run_format(name, o, d, x))
            plain_ms = time_ms(lambda: run_format(name, o, d, x, True))
            bound_ms, bound_by = bound(work.bytes, work.flops)
            rows.append((case, name, cell, ms, plain_ms, bound_ms, bound_by))
            log("mesh", f"13b {name} {case}: nnz {cell.n_coeffs}, width "
                f"{cell.width}, padding {cell.padding_overhead:.3f}, "
                f"{cell.nbytes} bytes; {ms:.4f} ms (bound {bound_ms:.4f} ms "
                f"by {bound_by}), plain {plain_ms:.4f} ms")
        if case.startswith("cell"):
            operands[case] = (od, ow)
    return sd, sw, operands


def spmd_collectives(out: dict, prog: str, iters: int) -> dict:
    """collective_bytes of one rank's recorded collectives, per
    iteration."""
    from repro_torch.roofline.analysis import collective_bytes
    recs = [("all-reduce", int(b), int(g)) for b, g in
            zip(out[f"{prog}_coll_bytes"], out[f"{prog}_coll_groups"])]
    cb = collective_bytes(recs)
    return dict(bytes=cb["total"] / iters,
                all_reduces=cb["counts"]["all-reduce"] / iters)


def mesh_spmd(problem, sd, sw, operands) -> dict:
    """13c: four gloo ranks on the one card: the 2-D and 1-D steps against
    opt, B3/B4 per rank against the local mesh's sums, collective bytes
    and seconds.  13d: one NCCL rank at (1, 1) against the local mesh."""
    import shutil
    from repro_torch.core.life import LifeConfig
    from repro_torch.distributed import life_shard as LS
    from repro_torch.distributed import spmd
    from repro_torch.distributed.mesh import LocalMesh
    phi, d = problem.phi, problem.dictionary
    n_theta = d.shape[1]
    R, C = MESH_SHAPE
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    shards = LS.build_life_shards(phi, n_theta, R, C)
    blocks = LS.build_life_shards_1d(phi, R * C)
    g = torch.Generator(device="cuda").manual_seed(14)
    pw = torch.rand(phi.n_fibers, generator=g, device="cuda")
    py = torch.randn(phi.n_voxels, n_theta, generator=g, device="cuda")
    gloo_dir = os.path.join(MESH_DIR, "gloo4")
    sizes = spmd.write_inputs(gloo_dir, problem, shards, sell=(sd, sw),
                              blocks_1d=blocks,
                              probes=(pw.cpu().numpy(), py.cpu().numpy()))
    written = sum(os.path.getsize(os.path.join(gloo_dir, f))
                  for f in os.listdir(gloo_dir))
    log("mesh", f"13c partitions built and {R * C} rank files written once "
        f"in the parent: {time.perf_counter() - t0:.2f} s, {written} bytes")
    log("mesh", "13c four ranks on one card: gloo over CUDA tensors, chosen "
        "because NCCL refuses two ranks on one GPU ('Duplicate GPU "
        "detected'); these are gloo-through-host numbers, not NVLink ones")
    t0 = time.perf_counter()
    outs = spmd.run(gloo_dir, sizes, programs=("step2d", "step1d",
                                               "sell_ops"),
                    iters=dict(step2d=MESH_SPMD_ITERS, step1d=MESH_1D_ITERS),
                    backend="gloo", devices=["cuda:0"] * (R * C),
                    deadline_s=SPMD_DEADLINE_S)
    staged = [bool(o["staged"]) for o in outs]
    log("mesh", f"13c {R * C} ranks ran in {time.perf_counter() - t0:.2f} s "
        f"(start-up, loads and the three programs); gloo staged CUDA "
        f"tensors through host tensors: {staged}")

    base = LifeConfig(executor="opt", plan_cache_dir="")
    w_opt = {n: mesh_solve(problem, dataclasses.replace(base, n_iters=n))[1]
             .cpu().numpy() for n in (MESH_SPMD_ITERS, MESH_1D_ITERS)}
    w2 = LS.unshard_w(shards, np.concatenate(
        [outs[c]["step2d_w"] for c in range(C)]))
    w1 = outs[0]["step1d_w"]
    for label, w, ref in (("2-D", w2, w_opt[MESH_SPMD_ITERS]),
                          ("1-D", w1, w_opt[MESH_1D_ITERS])):
        log("mesh", f"13c {label} step vs LifeEngine(opt) on the card: max "
            f"abs diff {np.abs(w - ref).max():.3e} (rtol "
            f"{SPMD_TOL['rtol']}, atol {SPMD_TOL['atol']})")
        np.testing.assert_allclose(w, ref, **SPMD_TOL)

    # B3/B4 per rank, then all_reduce, against the local mesh's ordered
    # sums of the same kernels' per-cell outputs
    nv_l, nf_l = shards.nv_local, shards.nf_local
    pw_pad = torch.as_tensor(LS.shard_w(shards, pw.cpu().numpy()),
                             device="cuda")
    py_pad = torch.as_tensor(LS.shard_b(shards, py.cpu().numpy()),
                             device="cuda")
    worst = 0.0
    for r in range(R):
        for c in range(C):
            y_ref = sum(run_format("dsc_sell", operands[f"cell ({r},{cc})"][0],
                                   d, pw_pad[cc * nf_l:(cc + 1) * nf_l])[:nv_l]
                        for cc in range(C))
            w_ref = sum(run_format("wc_sell", operands[f"cell ({rr},{c})"][1],
                                   d, py_pad[rr * nv_l:(rr + 1) * nv_l]
                                   .contiguous())[:nf_l]
                        for rr in range(R))
            out = outs[r * C + c]
            for got, ref in ((out["sell_ops_y"], y_ref),
                             (out["sell_ops_w"], w_ref)):
                ref = ref.cpu().numpy()
                rel = float(np.abs(got - ref).max()
                            / max(np.abs(ref).max(), 1e-30))
                worst = max(worst, rel)
    launches = np.sum([o["sell_ops_launches"] for o in outs], axis=0)
    log("mesh", f"13c make_sharded_sell_ops on {R * C} ranks vs the local "
        f"mesh's ordered sums: worst relative diff {worst:.3e} (limit "
        f"{SPMD_OPS_RTOL}); B3/B4 launches over the ranks "
        f"{launches.tolist()} (expected [{R * C}, {R * C}])")
    if worst > SPMD_OPS_RTOL or launches.tolist() != [R * C, R * C]:
        raise AssertionError("mesh: the ranks' B3/B4 SpMVs are off the "
                             "local mesh")
    coll = {p: spmd_collectives(outs[0], p, n) for p, n in
            (("step2d", MESH_SPMD_ITERS), ("step1d", MESH_1D_ITERS))}
    secs = {p: max(float(o[f"{p}_seconds"]) for o in outs)
            for p in ("step2d", "step1d")}
    log("mesh", f"13c collective bytes moved per device and iteration "
        f"(roofline/analysis.py:collective_bytes, ring factors): 2-D "
        f"{coll['step2d']['bytes']:.0f} B in "
        f"{coll['step2d']['all_reduces']:.1f} all-reduces, 1-D "
        f"{coll['step1d']['bytes']:.0f} B in "
        f"{coll['step1d']['all_reduces']:.1f} (1-D / 2-D "
        f"{coll['step1d']['bytes'] / coll['step2d']['bytes']:.2f})")
    log("mesh", f"13c seconds per iteration (slowest rank, barrier to "
        f"barrier, gloo through host memory on one card): 2-D "
        f"{secs['step2d'] / MESH_SPMD_ITERS:.4f} s, 1-D "
        f"{secs['step1d'] / MESH_1D_ITERS:.4f} s")
    if not coll["step2d"]["bytes"] < coll["step1d"]["bytes"]:
        raise AssertionError("mesh: the 2-D step moved no fewer bytes than "
                             "the 1-D one")

    # 13d: the NCCL path one card can run, world size 1
    t0 = time.perf_counter()
    one = LS.build_life_shards(phi, n_theta, 1, 1)
    nccl_dir = os.path.join(MESH_DIR, "nccl1")
    out = spmd.run(nccl_dir, spmd.write_inputs(nccl_dir, problem, one),
                   programs=("step2d",), iters=dict(step2d=MESH_NCCL_ITERS),
                   backend="nccl", devices=["cuda:0"],
                   deadline_s=SPMD_DEADLINE_S)[0]
    mesh = LocalMesh(1, 1, "cuda")
    st = LS.sharded_state(mesh, one, problem)
    step = LS.make_sharded_step(mesh, one.meta)
    w = st["w"]
    for it in range(MESH_NCCL_ITERS):
        w, _ = step(st["dsc"], st["wc"], st["b"], w, it)
    w_local = w[0].cpu().numpy()
    _, w_eng, _, _, _ = mesh_solve(problem, dataclasses.replace(
        base, executor="shard", n_iters=MESH_NCCL_ITERS))
    same = np.array_equal(out["step2d_w"], w_local)
    log("mesh", f"13d one NCCL rank, make_sharded_step (1, 1) for "
        f"{MESH_NCCL_ITERS} iterations ({time.perf_counter() - t0:.2f} s "
        f"with its start-up): bit-identical to the local mesh's step "
        f"{same}; LifeEngine(shard) bit-identical "
        f"{np.array_equal(w_eng.cpu().numpy(), w_local)}")
    if not same:
        raise AssertionError("mesh: the NCCL rank differs from the local "
                             "mesh")
    # for phase 20: one more odd and even iteration of each step, measured
    measure_life_steps("2d", dict(st, w=w), step, MESH_NCCL_ITERS | 1)
    del st, w
    blocks = LS.build_life_shards_1d(phi, 1)
    cells = LS.coo_cells(mesh, {(0, 0): {k: v[0] for k, v in
                                         blocks.items()}}, "dsc",
                         n_atoms=phi.n_atoms, nv_local=phi.n_voxels,
                         nf_local=phi.n_fibers, dictionary=d)
    step = LS.make_sharded_step_1d(mesh, {})
    ops = dict(cells=cells, b=problem.b,
               w=torch.ones(phi.n_fibers, device="cuda"))
    for warm in range(2):
        ops["w"], _ = step(cells, ops["b"], ops["w"], warm)
    measure_life_steps("1d", ops, step, 3)
    del cells, ops
    torch.cuda.empty_cache()
    return {"dsc_sell": int(launches[0]), "wc_sell": int(launches[1])}


#: phase 20's measured SBBNNLS iterations: "<variant> <odd|even>" -> the
#: step's operands as meta copies, its iteration, the growth of allocated
#: memory over what the operands hold and its CUDA-event time
LIFE_STEP_MEMORY: dict = {}


def measure_life_steps(variant: str, operands: dict, step, it: int) -> None:
    """Iterations ``it`` (odd) and ``it + 1`` (even) of a warm SBBNNLS
    ``step`` on the card (2-D: ``sharded_state``'s operands, 1-D:
    ``cells``, ``b``, ``w``), each measured (:func:`measured`) and kept
    for phase 20 with meta copies of its operands."""
    from repro_torch.distributed import life_shard as LS
    args = ((operands["dsc"], operands["wc"]) if variant == "2d"
            else (operands["cells"],)) + (operands["b"],)
    w = operands["w"]
    for k in (it, it + 1):
        (w_new, _), growth, ms, before = measured(lambda: step(*args, w, k))
        label = f"{variant} {'odd' if k % 2 else 'even'}"
        LIFE_STEP_MEMORY[label] = dict(
            variant=variant, it=k, growth=growth, ms=ms, before=before,
            operands=LS.without_data(dict(operands, w=w)))
        log("mesh", f"13d {label} iteration {k}, one more: allocated "
            f"{before / 2**30:.3f} GiB before, peak growth {growth} B "
            f"({growth / 2**30:.3f} GiB), {ms:.3f} ms")
        w = w_new


def mesh_service(problem) -> dict:
    """13e: mesh jobs through LifeService: bit for bit their own engines,
    again after a kill and resume; a (2, 2) submit refused."""
    import shutil
    from repro_torch.core.life import LifeConfig
    from repro_torch.kernels import _build
    from repro_torch.serve import LifeService
    root = os.path.join(MESH_DIR, "serve")
    shutil.rmtree(root, ignore_errors=True)
    cfg = LifeConfig(n_iters=MESH_SERVE_ITERS,
                     plan_cache_dir=os.path.join(root, "plans"))
    jobs = (("mesh-coo", "coo", "shard"), ("mesh-sell", "sell", "shard-sell"))

    def service(**kw):
        svc = LifeService(cfg, slice_iters=MESH_SERVE_SLICE, device="cuda",
                          **kw)
        for jid, fmt, _ in jobs:
            svc.submit(problem, job_id=jid, format=fmt, mesh=(1, 1))
        return svc

    t0 = time.perf_counter()
    svc = service()
    torch.cuda.synchronize()
    _build.reset_launches()
    results = svc.run()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    want = {"dsc_sell": 2 * MESH_SERVE_ITERS,
            "wc_sell": 3 * MESH_SERVE_ITERS // 2}
    log("mesh", f"13e two mesh=(1, 1) jobs of {MESH_SERVE_ITERS} iterations "
        f"in slices of {MESH_SERVE_SLICE}: {time.perf_counter() - t0:.3f} s "
        f"wall with submits and builds; launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"mesh: service launches {counts} != {want}")
    for jid, fmt, ex in jobs:
        _, w, losses, _, _ = mesh_solve(problem, dataclasses.replace(
            cfg, executor=ex, format=fmt))
        same = (torch.equal(results[jid][0], w)
                and torch.equal(results[jid][1], losses))
        log("mesh", f"13e {jid} vs LifeEngine({ex}, (1, 1)): bit-identical "
            f"{same}")
        if not same:
            raise AssertionError(f"mesh: {jid} differs from its engine")
    ck = os.path.join(root, "ckpt")
    dying = service(ckpt_dir=ck, checkpoint_every=1)
    dying.step()
    dying.step()
    del dying
    resumed = LifeService(cfg, ckpt_dir=ck, slice_iters=MESH_SERVE_SLICE,
                          device="cuda")
    adopted = resumed.resumable_jobs
    for jid, _, _ in jobs:
        resumed.submit(problem, job_id=jid)      # format and mesh restored
    meta = {jid: (resumed.scheduler.job(jid).done,
                  resumed.scheduler.job(jid).mesh) for jid, _, _ in jobs}
    got = resumed.run()
    same = {jid: torch.equal(got[jid][0], results[jid][0])
            and torch.equal(got[jid][1], results[jid][1]) for jid, _, _ in jobs}
    log("mesh", f"13e killed after 2 ticks with {adopted} checkpointed "
        f"(done, mesh: {meta}); resumed jobs bit-identical {same}")
    if not all(same.values()):
        raise AssertionError("mesh: a resumed mesh job differs")
    try:
        svc.submit(problem, job_id="mesh-2x2", format="coo",
                   mesh=MESH_SHAPE)
    except ValueError as exc:
        log("mesh", f"13e a mesh={MESH_SHAPE} submit refused: {exc}")
        if "needs 4 devices, have 1" not in str(exc):
            raise
    else:
        raise AssertionError("mesh: a (2, 2) submit was not refused")
    return counts


def phase_mesh(problem, errors: dict) -> dict:
    """Phase 13: the mesh partition.  Returns B3/B4's launches on the mesh
    path (13a's shard-sell solve, 13c's ranks, 13e's sell job)."""
    t0 = time.perf_counter()

    def timed(sub: str, fn):
        t1 = time.perf_counter()
        out = fn()
        log("mesh", f"sub-phase {sub} took {time.perf_counter() - t1:.1f} s")
        return out

    launches = dict(timed("13a engines", lambda: mesh_engines(problem)))
    sd, sw, operands = timed("13b cells", lambda: mesh_cells(problem, errors))
    add_launches(launches, timed("13c/13d ranks", lambda: mesh_spmd(
        problem, sd, sw, operands)))
    add_launches(launches, timed("13e service", lambda: mesh_service(problem)))
    log("mesh", f"phase 13 took {time.perf_counter() - t0:.1f} s; B3/B4 "
        f"launches on the mesh path {launches}")
    return launches


# ----------------------------------------------------------------------------
# 7. MoE serving at full width, on kernel B7
# ----------------------------------------------------------------------------

LM_ARCH = "phi3.5-moe-42b-a6.6b"
#: 32 layers are 83.3 GB in bf16, more than the card's 80 GB
LM_LAYERS = 8
LM_BATCH, LM_PROMPT, LM_GEN = 4, 512, 16
#: teacher-forced logits of the B7 run against the plain expert path, as a
#: share of the logits' largest magnitude (bf16 products summed in another
#: order round differently in the last place)
LM_LOGIT_TOL = 2e-2
#: B7's plain-version contract (tests/test_torch_moe_gmm.py)
GMM_TOL = {"fp32": dict(rtol=1e-4, atol=1e-4),
           "bf16": dict(rtol=2e-2, atol=2e-2)}


def note_b7_err(errors: dict, case: str, err: float) -> None:
    """B7's largest error against its plain version over every case, and
    each case's own (the kernels line carries both)."""
    errors.setdefault("moe_gmm_cases", {})[case] = err
    errors["moe_gmm"] = max(errors.get("moe_gmm", 0.0), err)


def gmm_case(m: int, k: int, n: int, t_tile: int, ids, seed: int, *,
             zero_tiles: int = 0, n_experts: int = 0):
    """x (m, k) and W (E, k, n) in float32 on the card, made from ``seed``,
    W scaled as the model's experts are; E is ``n_experts`` or one past the
    largest id; the first ``zero_tiles`` tiles of x are zero rows (empty
    capacity slots)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.as_tensor(ids, dtype=torch.int32, device="cuda")
    e = n_experts or int(ids.max()) + 1
    x = torch.randn(m, k, generator=g, device="cuda")
    x[:zero_tiles * t_tile] = 0
    w = torch.randn(e, k, n, generator=g, device="cuda").mul_(
        (2 / (k + n)) ** 0.5)
    return ids, x, w


def check_gmm(case: str, ids, x32, w32, t_tile: int, errors: dict,
              zero_rows: int = 0) -> None:
    """B7 against its plain version in fp32 and bf16 on one case; a second
    launch is bit-identical and zero rows stay zero."""
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.ref import moe_gmm_ref
    m, k = x32.shape
    n = w32.shape[2]
    for dtype, x, w in (("fp32", x32, w32),
                        ("bf16", x32.bfloat16(), w32.bfloat16())):
        got = moe_gmm(ids, x, w, t_tile=t_tile, f_tile=8)
        want = moe_gmm_ref(x.view(-1, t_tile, k), w, ids).view(m, n)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        log("lm", f"B7 {case} {dtype} ({m} x {k} -> {n}, t_tile {t_tile}, "
            f"{ids.numel()} tiles, {w.shape[0]} experts): max abs err "
            f"{float(diff.max()):.3e} (rtol {GMM_TOL[dtype]['rtol']}, atol "
            f"{GMM_TOL[dtype]['atol']}); elements that differ at all "
            f"{float((diff > 0).float().mean()):.3e}")
        torch.testing.assert_close(got, want, **GMM_TOL[dtype])
        note_b7_err(errors, f"{case} {dtype}", float(diff.max()))
        if not torch.equal(got, moe_gmm(ids, x, w, t_tile=t_tile, f_tile=8)):
            raise AssertionError(f"B7 {case} {dtype}: a second launch differs")
        if zero_rows and got[:zero_rows].count_nonzero():
            raise AssertionError(f"B7 {case} {dtype}: zero rows are not zero")
        del got, want, diff
    torch.cuda.empty_cache()


def lm_shapes(cfg) -> dict:
    """B7's two shapes on the serve path: the prefill's gate product and
    the decode step's down product (expert-sorted rows, capacity per
    expert from the reference's formula)."""
    from repro_torch.models.moe import capacity_of, t_tile_of
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    out = {}
    for name, tokens, k, n in (("prefill gate", LM_BATCH * LM_PROMPT, d, f),
                               ("decode down", LM_BATCH, f, d)):
        cap = capacity_of(tokens, cfg.top_k, e, cfg.capacity_factor)
        t_tile = t_tile_of(cap)
        out[name] = dict(m=e * cap, k=k, n=n, t_tile=t_tile, capacity=cap,
                         ids=np.repeat(np.arange(e), cap // t_tile))
    return out


def phase_lm_kernels(cfg, errors: dict) -> None:
    shapes = lm_shapes(cfg)
    for i, (name, s) in enumerate(shapes.items()):
        # at decode most tiles are empty capacity slots: zero rows
        zero_tiles = 12 if name == "decode down" else 0
        ids, x, w = gmm_case(s["m"], s["k"], s["n"], s["t_tile"], s["ids"],
                             seed=20 + i, zero_tiles=zero_tiles)
        check_gmm(name, ids, x, w, s["t_tile"], errors,
                  zero_rows=zero_tiles * s["t_tile"])
        del x, w
    r = np.random.default_rng(22)
    for case, (t_tile, n_tiles, k, n) in {"ragged": (24, 37, 1000, 776),
                                          "ragged-long-tile": (72, 9, 264,
                                                               200)}.items():
        ids = r.integers(0, 16, n_tiles)
        ids[0] = 15                     # E = 16, ids not sorted
        ids, x, w = gmm_case(t_tile * n_tiles, k, n, t_tile, ids, seed=23)
        check_gmm(case, ids, x, w, t_tile, errors)
    # expert layouts at the model's widths: a new expert at every tile of
    # 64 rows (both groups of every 128-row block differ), at every tile of
    # 32 rows, and unsorted ids with some out of range (clamped to [0, 16))
    d, f = cfg.d_model, cfg.moe_d_ff
    for case, (t_tile, ids) in {
            "expert-every-tile": (64, np.arange(32) % 16),
            "expert-every-32-rows": (32, np.arange(48) % 16),
            "unsorted-out-of-range": (64, np.r_[r.integers(0, 16, 14),
                                                -2, 40])}.items():
        ids, x, w = gmm_case(t_tile * len(ids), d, f, t_tile, ids, seed=24,
                             n_experts=16)
        check_gmm(case, ids, x, w, t_tile, errors)
        del x, w


def profile_lm(label: str, fn, phase: str = "lm") -> None:
    """Device time of one call of ``fn`` by kernel (torch.profiler): B7's
    share, the attention sub-layers' and MoE layers' (record_function
    ranges around them) and the rest, against the call's wall time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    originals = {(L, "attention_prefill"): L.attention_prefill,
                 (L, "attention_decode"): L.attention_decode,
                 (MOE, "moe_ffn"): MOE.moe_ffn}

    def ranged(range_name, f):
        def wrapped(*a, **kw):
            with record_function(range_name):
                return f(*a, **kw)
        return wrapped

    for (mod, attr), f in originals.items():
        setattr(mod, attr, ranged("lm." + ("moe" if attr == "moe_ffn"
                                           else "attention"), f))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (mod, attr), f in originals.items():
            setattr(mod, attr, f)
    kernels, ranges, spans = [], {}, {}
    on_card = torch.autograd.DeviceType.CUDA
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = getattr(evt, "cuda_time_total", 0.0)
        if evt.key.startswith("lm."):
            # the host-side range sums its kernels' device time; the
            # card-side annotation spans first to last kernel, gaps included
            if evt.device_type == on_card:
                spans[evt.key] = us / 1e3
            else:
                ranges[evt.key] = total / 1e3
        elif evt.device_type == on_card and us > 0:
            kernels.append((us / 1e3, evt.count, evt.key[:70]))
    if not kernels:
        log(phase, f"{label}: profiler saw no device time: breakdown not "
            "measured")
        return
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    b7 = sum(k[0] for k in kernels if "moe_gmm_" in k[2])
    # B7 launches through ctypes, not a PyTorch op: a profiler that files
    # its kernels under the enclosing range (torch 2.11 does) counts them
    # in the MoE range too, and then the ranges sum past the busy time
    att, moe = ranges.get("lm.attention", 0.0), ranges.get("lm.moe", 0.0)
    b7_in_moe = b7 + att + moe > busy * (1 + 1e-6)
    if b7_in_moe:
        moe -= b7
    rest = busy - b7 - att - moe
    log(phase, f"{label}: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
        f"({busy / wall_ms:.1%}; torch.profiler, one call): B7 {b7:.3f} ms "
        f"({b7 / busy:.1%}); by record_function range, attention sub-layers "
        f"{att:.3f} ms ({att / busy:.1%}), the MoE layers' other kernels "
        f"(router, sort, dispatch, SiLU, combine) {moe:.3f} ms "
        f"({moe / busy:.1%}; B7 filed under the range and taken out of it: "
        f"{b7_in_moe}), the rest {rest:.3f} ms ({rest / busy:.1%}) "
        f"(0.000 for a range: not measured); the ranges' spans on the card, "
        f"gaps included: attention {spans.get('lm.attention', 0.0):.3f} ms, "
        f"MoE {spans.get('lm.moe', 0.0):.3f} ms")
    for ms, calls, name in kernels[:8]:
        log(phase, f"  {ms:.4f} ms  {ms / busy:6.1%}  {calls:4d} calls  {name}")


class LmRecording:
    """Within the block, every MoE layer appends its router's expert ids
    (T, k) to ``routes``; with ``errors`` a list, every expert FFN call
    also runs the plain expert products on the same input and appends the
    largest difference of B7's output from theirs, which must lie within
    the bf16 tolerance."""

    def __init__(self, routes: list, errors):
        self.routes, self.errors = routes, errors

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self.saved = MOE._top_k, MOE.expert_ffn
        top_k, ffn = self.saved

        def recording_top_k(probs, k):
            vals, idx = top_k(probs, k)
            self.routes.append(idx.cpu())
            return vals, idx

        def checked_ffn(p, xe, capacity):
            ye = ffn(p, xe, capacity)
            p.plain = True
            want = ffn(p, xe, capacity)
            p.plain = False
            torch.testing.assert_close(ye, want, **GMM_TOL["bf16"])
            self.errors.append(float((ye.float() - want.float()).abs().max()))
            return ye

        MOE._top_k = recording_top_k
        if self.errors is not None:
            MOE.expert_ffn = checked_ffn
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as MOE
        MOE._top_k, MOE.expert_ffn = self.saved
        return False


def seeded_model(cfg, phase: str = "lm"):
    """``cfg``'s model with seeded random weights drawn on the card, and
    the bytes of its weights."""
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          "cuda")
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(phase, f"{cfg.name}: {n_bytes / 1e9:.2f} GB of weights ({cfg.dtype}) "
        f"drawn on the card in {time.perf_counter() - t0:.2f} s")
    return model, n_bytes


def serve_batch(cfg, model, phase: str = "lm") -> dict:
    """LM_BATCH prompts of LM_PROMPT seeded tokens and LM_GEN generated
    ones through launch.serve.generate, after a short warm-up: the tokens
    (finite, in range, of the expected shape), each step's logits, the
    kernels' launches, prefill ms, decode ms a step and the peak of
    allocated memory (``max_memory_allocated``, weights included)."""
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate
    prompts = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size,
                                          (LM_BATCH, LM_PROMPT)),
        dtype=torch.int32, device="cuda")
    generate(cfg, model, prompts[:, :64], 2)           # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    tokens, logits, secs = generate(cfg, model, prompts, LM_GEN)
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_dec = LM_GEN - 1
    out = dict(prompts=prompts, tokens=tokens, logits=logits, launches=counts,
               prefill_ms=secs["prefill"] * 1e3,
               decode_ms=secs["decode"] * 1e3 / n_dec, peak_bytes=peak)
    log(phase, f"{cfg.name} serve batch {LM_BATCH} x prompt {LM_PROMPT}, "
        f"{LM_GEN} tokens (1 prefill + {n_dec} decode steps): launches "
        f"{counts}; prefill {out['prefill_ms']:.3f} ms "
        f"({LM_BATCH * LM_PROMPT / secs['prefill']:.1f} prompt tokens/s); "
        f"decode {out['decode_ms']:.3f} ms per step, "
        f"{LM_BATCH * n_dec / secs['decode']:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB ({peak} B)")
    if tuple(tokens.shape) != (LM_BATCH, LM_GEN) or not all(
            torch.isfinite(lg).all() for lg in logits) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: serve output is not finite tokens "
                             "of the expected shape")
    log(phase, f"{cfg.name} generated tokens (first row): "
        f"{tokens[0].tolist()}")
    return out


def phase_lm_serve(cfg, phase: str = "lm") -> dict:
    """Full-width serving on B7, then teacher-forced on the plain expert
    path.  Returns B7's launches in the B7 run, the generated tokens,
    prefill and decode ms, the peak memory and the routing agreement."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate
    from repro_torch.models.moe import capacity_of
    n_moe = cfg.n_layers - cfg.first_k_dense
    log(phase, f"{cfg.name} at {cfg.n_layers} of "
        f"{get_config(cfg.name).n_layers} layers ({cfg.first_k_dense} dense "
        f"first, {n_moe} MoE; d {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} KV heads, head_dim {cfg.resolved_head_dim}, "
        f"{cfg.n_experts} experts of ff {cfg.moe_d_ff}, top-{cfg.top_k}, "
        f"{cfg.n_shared_experts} shared, vocab {cfg.vocab_size}, {cfg.dtype})")
    model, n_bytes = seeded_model(cfg, phase)
    served = serve_batch(cfg, model, phase)
    prompts, tokens, logits = (served[k] for k in ("prompts", "tokens",
                                                   "logits"))
    counts = served["launches"]
    want = {"moe_gmm": n_moe * 3 * LM_GEN}
    log(phase, f"{cfg.name} B7 launches {counts} (expected {want}: 3 per MoE "
        f"layer per forward, none in a dense layer or a shared expert); "
        f"capacity per expert: prefill "
        f"{capacity_of(LM_BATCH * LM_PROMPT, cfg.top_k, cfg.n_experts, cfg.capacity_factor)}"
        f", decode {capacity_of(LM_BATCH, cfg.top_k, cfg.n_experts, cfg.capacity_factor)}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")

    # the same forwards again, teacher-forced with the B7 run's tokens: on
    # B7 with each MoE layer's expert FFN also run by the plain version on
    # the same input (the kernel held on the path's own activations), then
    # on the plain expert path; both runs record every router decision
    b7_routes, layer_err = [], []
    with LmRecording(b7_routes, layer_err):
        _, checked_logits, _ = generate(cfg, model, prompts, LM_GEN,
                                        forced=tokens)
    same_again = all(torch.equal(a, b) for a, b in zip(logits,
                                                       checked_logits))
    log(phase, f"B7 on the path's own activations: {len(layer_err)} expert "
        f"FFN calls (3 B7 products each) against the plain expert products "
        f"on the same input, max abs err {max(layer_err):.3e} (rtol "
        f"{GMM_TOL['bf16']['rtol']}, atol {GMM_TOL['bf16']['atol']}); the "
        f"teacher-forced B7 run's logits equal the first run's bit for bit: "
        f"{same_again}")
    plain_routes = []
    model.use_plain_experts(True)
    _build.reset_launches()
    with LmRecording(plain_routes, None):
        _, plain_logits, plain_secs = generate(cfg, model, prompts, LM_GEN,
                                               forced=tokens)
    model.use_plain_experts(False)
    if dict(_build.LAUNCHES):
        raise AssertionError(f"the plain expert path launched "
                             f"{dict(_build.LAUNCHES)}")
    n_dec = LM_GEN - 1
    worst, worst_same_route, alike = 0.0, 0.0, 0
    flipped, token_layers = 0, 0
    for i, (a, b) in enumerate(zip(logits, plain_logits)):
        peak_logit = float(b.float().abs().max())
        rel = float((a.float() - b.float()).abs().max()) / peak_logit
        routes = slice(i * n_moe, (i + 1) * n_moe)
        # per batch row, its tokens' token-layers routed otherwise
        row_flips = sum((x != y).any(dim=-1).reshape(LM_BATCH, -1).sum(1)
                        for x, y in zip(b7_routes[routes],
                                        plain_routes[routes]))
        flips = int(row_flips.sum())
        n_tl = n_moe * b7_routes[routes.start][..., 0].numel()
        flipped, token_layers = flipped + flips, token_layers + n_tl
        worst = max(worst, rel)
        if not flips:
            alike += 1
            worst_same_route = max(worst_same_route, rel)
        ulp = 2.0 ** (np.floor(np.log2(peak_logit)) - 7)
        log(phase, f"step {i}: max |logit diff| / max |logit| = {rel:.3e} "
            f"(max |logit| {peak_logit:.4f}, bf16 spacing there {ulp:.4g} = "
            f"{ulp / peak_logit:.2e} of it); tokens routed to another expert "
            f"than on B7: {flips} of {n_tl} token-layers (per row "
            f"{row_flips.tolist()}); argmax agrees on "
            f"{int((a.argmax(-1) == b.argmax(-1)).sum())} of {LM_BATCH} rows")
    log(phase, f"teacher-forced plain expert path: prefill "
        f"{plain_secs['prefill'] * 1e3:.3f} ms, decode "
        f"{plain_secs['decode'] * 1e3 / n_dec:.3f} ms per step; worst "
        f"relative logit difference {worst:.3e} over all steps, "
        f"{worst_same_route:.3e} over the {alike} of {LM_GEN} steps routed "
        f"alike in both runs (limit {LM_LOGIT_TOL} on those); token-layers "
        f"routed to another expert {flipped} of {token_layers} "
        f"({flipped / token_layers:.3e})")
    if not alike or worst_same_route > LM_LOGIT_TOL:
        raise AssertionError(f"B7 and the plain expert path disagree on a "
                             f"step routed alike: {worst_same_route:.3e} > "
                             f"{LM_LOGIT_TOL}")

    # where the time goes: the prefill and one decode step
    from repro_torch.launch.steps import make_prefill, make_serve_step
    from repro_torch.launch.serve import pad_cache
    prefill_step, serve_step = make_prefill(cfg), make_serve_step(cfg)
    state = {}

    def run_prefill():
        _, cache = prefill_step(model, {"tokens": prompts})
        state["cache"] = pad_cache(cache, LM_PROMPT + LM_GEN)

    profile_lm(f"{cfg.name} prefill", run_prefill, phase)
    profile_lm(f"{cfg.name} decode step", lambda: serve_step(model, dict(
        tokens=tokens[:, :1], cache=state["cache"], cache_index=LM_PROMPT)),
        phase)
    del model, state
    torch.cuda.empty_cache()
    return dict(launches=counts["moe_gmm"], tokens=tokens.cpu(),
                weight_bytes=n_bytes, prefill_ms=served["prefill_ms"],
                decode_ms=served["decode_ms"],
                peak_bytes=served["peak_bytes"], steps_alike=alike,
                flipped_token_layers=flipped, token_layers=token_layers,
                b7_ffn_calls=len(layer_err), b7_ffn_max_err=max(layer_err),
                worst_same_route=worst_same_route)


def gmm_bound(s: dict) -> tuple:
    """Least time of one bf16 product of shape ``s``: x, the selected
    experts' W and out moved once over HBM, against 2 M K N operations on
    the bf16 tensor cores."""
    from repro_torch.roofline.analysis import HW
    m, k, n = s["m"], s["k"], s["n"]
    n_sel = len(np.unique(s["ids"]))
    return bound(2 * (m * k + n_sel * k * n + m * n), 2.0 * m * k * n,
                 HW["peak_flops"])


def phase_lm_timing(cfg, launches: int, errors: dict) -> dict:
    """B7's kernels-line entry: its times at ``cfg``'s two serve shapes
    (:func:`b7_serve_rows`), the prefill gate product's as the entry's."""
    rows = b7_serve_rows(cfg)
    main_row = rows["prefill gate"]
    return dict(name="moe_gmm", route="cuda", **KERNELS["moe_gmm"],
                launches=launches, max_abs_err=errors["moe_gmm"],
                ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                library_ms=main_row["library_ms"], shape=main_row["shape"],
                one_expert_ms=main_row["one_expert_ms"],
                decode=rows["decode down"])


def b7_serve_rows(cfg, phase: str = "timing") -> dict:
    """B7 at ``cfg``'s two serve shapes in bf16 (CUDA events, 20 launches)
    beside its bound, itself with every tile on one expert, its plain
    version and torch.bmm over (E, capacity, K)."""
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.ref import moe_gmm_ref
    rows = {}
    for i, (name, s) in enumerate(lm_shapes(cfg).items()):
        ids, x, w = gmm_case(s["m"], s["k"], s["n"], s["t_tile"], s["ids"],
                             seed=30 + i)
        x, w = x.bfloat16(), w.bfloat16()
        e = w.shape[0]
        ms = time_ms(lambda: moe_gmm(ids, x, w, t_tile=s["t_tile"]))
        # every tile on expert 0: W (one expert's) is read from device
        # memory once and then hit in L2, so the gap to ms is what the
        # misses on 16 experts' W cost
        ids0 = torch.zeros_like(ids)
        one_expert_ms = time_ms(lambda: moe_gmm(ids0, x, w,
                                                t_tile=s["t_tile"]))
        plain_ms = time_ms(lambda: moe_gmm_ref(
            x.view(-1, s["t_tile"], s["k"]), w, ids))
        xb = x.view(e, s["capacity"], s["k"])
        library_ms = time_ms(lambda: torch.bmm(xb, w))
        bound_ms, bound_by = gmm_bound(s)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms,
                          one_expert_ms=one_expert_ms,
                          shape=f"{s['m']} x {s['k']} -> {s['n']}, t_tile "
                                f"{s['t_tile']}, {e} experts, bf16")
        log(phase, f"moe_gmm {name} ({rows[name]['shape']}): {ms:.4f} ms "
            f"(bound {bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} of "
            f"it; {2.0 * s['m'] * s['k'] * s['n'] / ms / 1e9:.1f} TFLOP/s); "
            f"every tile on expert 0 "
            f"{one_expert_ms:.4f} ms; plain {plain_ms:.4f} ms; "
            f"torch.bmm {library_ms:.4f} ms ({ms / library_ms:.2f}x)")
        del x, w, xb
        torch.cuda.empty_cache()
    return rows


def phase_lm(errors: dict) -> dict:
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    phase_lm_kernels(cfg, errors)
    served = phase_lm_serve(cfg)
    LM_SERVED["tokens"] = served["tokens"]
    return phase_lm_timing(cfg, served["launches"], errors)


# ----------------------------------------------------------------------------
# 14. training: B7's gradient, MoE and dense training at full width, resume
# ----------------------------------------------------------------------------

#: phi3.5-moe trained at full width, cut to this many of its 32 layers: at
#: 2 layers its state (bf16 weights and gradients, float32 moments) is
#: ~34 GB, at 4 layers ~66 GB before activations
TRAIN_LAYERS = 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 6
#: 14b's learning rate: at the CLI's default 3e-3 (set for the reduced
#: configs' weights) the full-width model's loss rose from 10.42 to 17.52
#: in four steps (gradient norm 58): Adam's first steps move every weight
#: by ~lr, 10-20% of these init scales (0.0138 for the experts, 0.0074
#: for the head)
TRAIN_LR = 3e-4
#: the plain expert path's loss and grad_norm against B7's, relative (bf16
#: products summed in other orders)
TRAIN_REL_TOL = 2e-2
#: a resumed run's losses against the uninterrupted run's where a kernel
#: that may add with atomics ran (relative); bit for bit otherwise
RESUME_ATOMIC_RTOL = 1e-6
#: kernel names of PyTorch ops that may add with atomics on the card
ATOMIC_HINTS = ("scatter", "index_add", "indexing_backward",
                "embedding_backward", "put_", "atomic")
TRAIN_DIR = os.path.join(ROOT, "build", "train")


def train_shapes(cfg) -> dict:
    """B7's two training shapes: the gate (and up) product and the down
    product of a batch of TRAIN_BATCH x TRAIN_SEQ tokens (capacity from the
    reference's formula)."""
    from repro_torch.models.moe import capacity_of, t_tile_of
    cap = capacity_of(TRAIN_BATCH * TRAIN_SEQ, cfg.top_k, cfg.n_experts,
                      cfg.capacity_factor)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    return {name: dict(n_exp=e, capacity=cap, t_tile=t_tile_of(cap), k=k,
                       n=n)
            for name, k, n in (("gate", d, f), ("down", f, d))}


def check_gmm_grad(case: str, s: dict, seed: int, errors: dict) -> None:
    """B7's autograd Function against autograd through its plain version
    in fp32 and bf16: the output, dx and dW within the contract, a second
    backward bit-identical."""
    from repro_torch.kernels.moe_gmm import grouped_matmul, segment_tiles
    from repro_torch.kernels.ref import moe_gmm_ref
    e, cap, t_tile, k, n = (s[x] for x in ("n_exp", "capacity", "t_tile",
                                           "k", "n"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    x32 = torch.randn(e * cap, k, generator=g, device="cuda")
    w32 = torch.randn(e, k, n, generator=g, device="cuda") * (
        2 / (k + n)) ** 0.5
    d32 = torch.randn(e * cap, n, generator=g, device="cuda")
    ids = segment_tiles(e, cap, t_tile, "cuda")

    def kernel(x, w, dout):
        x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = grouped_matmul(x, w, capacity=cap, t_tile=t_tile)
        return (out.detach(), *torch.autograd.grad(out, (x, w), dout))

    def plain(x, w, dout):
        x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = moe_gmm_ref(x.view(-1, t_tile, k), w, ids).view(-1, n)
        return (out.detach(), *torch.autograd.grad(out, (x, w), dout))

    for dtype in ("fp32", "bf16"):
        x, w, dout = ((x32, w32, d32) if dtype == "fp32" else
                      (x32.bfloat16(), w32.bfloat16(), d32.bfloat16()))
        tol = FP32_TOL if dtype == "fp32" else bf16_tol()
        got, want = kernel(x, w, dout), plain(x, w, dout)
        torch.cuda.synchronize()
        errs = []
        for name, a, b in zip(("out", "dx", "dW"), got, want):
            torch.testing.assert_close(a, b, **tol, msg=lambda m: (
                f"B7 grad {case} {dtype} {name}: {m}"))
            errs.append(float((a.float() - b.float()).abs().max()))
        again = kernel(x, w, dout)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"B7 grad {case} {dtype}: a second backward "
                                 "differs")
        # B7's own outputs are the forward and dx; dW is a torch.bmm, kept
        # apart with its largest magnitude (bf16's spacing grows with it)
        note_b7_err(errors, f"grad {case} {dtype} out", errs[0])
        note_b7_err(errors, f"grad {case} {dtype} dx", errs[1])
        dw_max = float(want[2].float().abs().max())
        errors.setdefault("dw_bmm", {})[f"{case} {dtype}"] = dict(
            max_abs_err=errs[2], max_abs=dw_max)
        log("train", f"14a B7 with a gradient, {case} {dtype} ({e} experts x "
            f"capacity {cap}, t_tile {t_tile}, {k} -> {n}): max abs err out "
            f"{errs[0]:.3e}, dx {errs[1]:.3e}; the dW bmm {errs[2]:.3e} "
            f"(largest |dW| {dw_max:.3e}) (rtol {tol['rtol']}, atol "
            f"{tol['atol']}); a second backward bit-identical")
        del got, want, again
    torch.cuda.empty_cache()


def time_gmm_grad(case: str, s: dict, seed: int) -> dict:
    """CUDA-event times of the four launches of one bf16 product's forward
    and backward: B7, B7 on W^T (dx), the W^T copy, the dW bmm."""
    from repro_torch.kernels import moe_gmm as GM
    e, cap, t_tile, k, n = (s[x] for x in ("n_exp", "capacity", "t_tile",
                                           "k", "n"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(e * cap, k, generator=g, device="cuda").bfloat16()
    w = (torch.randn(e, k, n, generator=g, device="cuda")
         * (2 / (k + n)) ** 0.5).bfloat16()
    dout = torch.randn(e * cap, n, generator=g, device="cuda").bfloat16()
    ids = GM.segment_tiles(e, cap, t_tile, "cuda")
    wt = GM.transposed_weights(w)
    row = {"fwd": time_ms(lambda: GM.moe_gmm(ids, x, w, t_tile=t_tile)),
           "dx": time_ms(lambda: GM.moe_gmm(ids, dout, wt, t_tile=t_tile)),
           "wt_copy": time_ms(lambda: GM.transposed_weights(w)),
           "dw_bmm": time_ms(lambda: GM.weight_grad(x, dout, e, cap))}
    log("train", f"14a times, {case} bf16 ({e * cap} x {k} -> {n}, CUDA "
        f"events over {TIMED_LAUNCHES} launches): forward {row['fwd']:.4f} "
        f"ms, dx on B7 {row['dx']:.4f} ms, W^T copy ({w.numel() * 2 / 1e6:.1f}"
        f" MB) {row['wt_copy']:.4f} ms, dW bmm {row['dw_bmm']:.4f} ms")
    del x, w, dout, wt
    torch.cuda.empty_cache()
    return row


class TrainProfile:
    """Within the block, every B7 launch, W^T copy and dW bmm is bracketed
    by CUDA events (B7 split into forward, recomputation included, and dx
    by whether GroupedMatmul.backward is running), and the attention
    sub-layers, the MoE layers and the optimizer run in record_function
    ranges."""

    TAGS = ("B7 forward", "B7 dx", "W^T copy", "dW bmm")

    def __enter__(self):
        from torch.profiler import record_function
        from repro_torch.kernels import moe_gmm as GM
        from repro_torch.launch import steps as ST
        from repro_torch.models import layers as L
        from repro_torch.models import moe as MOE
        self.events = {t: [] for t in self.TAGS}
        self.in_backward = False
        self.saved = [(GM, "moe_gmm", GM.moe_gmm),
                      (GM, "transposed_weights", GM.transposed_weights),
                      (GM, "weight_grad", GM.weight_grad),
                      (L, "attention_train", L.attention_train),
                      (MOE, "moe_ffn", MOE.moe_ffn),
                      (ST, "apply_updates", ST.apply_updates)]
        backward = GM.GroupedMatmul.backward

        def timed(tag, f):
            def wrapped(*a, **kw):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = f(*a, **kw)
                t1.record()
                name = ("B7 dx" if self.in_backward else "B7 forward"
                        ) if tag == "B7" else tag
                self.events[name].append((t0, t1))
                return out
            return wrapped

        def ranged(name, f):
            def wrapped(*a, **kw):
                with record_function(name):
                    return f(*a, **kw)
            return wrapped

        def marked_backward(ctx, dout):
            self.in_backward = True
            try:
                return backward(ctx, dout)
            finally:
                self.in_backward = False

        self.backward = backward
        GM.moe_gmm = timed("B7", GM.moe_gmm)
        GM.transposed_weights = timed("W^T copy", GM.transposed_weights)
        GM.weight_grad = timed("dW bmm", GM.weight_grad)
        L.attention_train = ranged("train.attention", L.attention_train)
        MOE.moe_ffn = ranged("train.moe", MOE.moe_ffn)
        ST.apply_updates = ranged("train.optimizer", ST.apply_updates)
        GM.GroupedMatmul.backward = staticmethod(marked_backward)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import moe_gmm as GM
        for mod, attr, f in self.saved:
            setattr(mod, attr, f)
        GM.GroupedMatmul.backward = staticmethod(self.backward)
        return False

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {t: (sum(a.elapsed_time(b) for a, b in ev), len(ev))
                for t, ev in self.events.items()}


def profile_train_step(label: str, fn) -> dict:
    """One training step under torch.profiler and TrainProfile: device busy
    against wall time, B7's four parts (CUDA events), the ranges' device
    time and the kernels that may add with atomics."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with TrainProfile() as tp, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    parts = tp.ms()
    kernels, ranges, backward = [], {}, 0.0
    on_card = torch.autograd.DeviceType.CUDA
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = getattr(evt, "cuda_time_total", 0.0)
        if evt.key.startswith(("train.", "autograd::engine::")):
            # a host range sums its ops' kernels; its card-side annotation
            # (a span, gaps included) is no kernel
            if evt.device_type == on_card:
                continue
            if evt.key.startswith("train."):
                ranges[evt.key] = total / 1e3
            else:
                backward += total / 1e3
        elif evt.device_type == on_card and us > 0:
            kernels.append((us / 1e3, evt.count, evt.key[:70]))
    atomic = sorted({k[2] for k in kernels
                     if any(h in k[2].lower() for h in ATOMIC_HINTS)})
    out = {"wall_ms": wall_ms, "parts": parts, "ranges": ranges,
           "atomic": atomic}
    if not kernels:
        log("train", f"{label}: profiler saw no device time: breakdown not "
            "measured")
        return out
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    out["busy_ms"] = busy
    b7 = "; ".join(f"{t} {ms:.3f} ms ({n} launches)"
                   for t, (ms, n) in parts.items())
    log("train", f"{label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({busy / wall_ms:.1%}; host gaps {wall_ms - busy:.3f} ms) "
        f"(torch.profiler, one step); by CUDA events: {b7}; by "
        f"record_function range (device time of the PyTorch ops inside; "
        f"B7 launches through ctypes and counts in none): attention "
        f"{ranges.get('train.attention', 0.0):.3f} ms (forward and "
        f"recomputation), MoE layers' dispatch, router and combine "
        f"{ranges.get('train.moe', 0.0):.3f} ms (forward and "
        f"recomputation), optimizer {ranges.get('train.optimizer', 0.0):.3f}"
        f" ms; backward nodes {backward:.3f} ms (recomputation inside them "
        f"counts in both)")
    for ms, calls, name in kernels[:10]:
        log("train", f"  {ms:.4f} ms  {ms / busy:6.1%}  {calls:4d} calls  "
            f"{name}")
    log("train", f"{label}: kernels that may add with atomics: "
        f"{atomic if atomic else 'none'}")
    return out


def loss_and_grad_norm(cfg, params, batch) -> tuple:
    """The loss and the gradient's global norm at ``params`` (no update)."""
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import global_norm
    leaves = params.reference_leaves()
    flat = [p for leaf in leaves.values() for p in leaf.members]
    total, m = T.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(total, flat)
    return float(m["loss"].detach()), float(global_norm({"all": grads}))


def phase_train_moe() -> dict:
    """14b: phi3.5-moe at full width, TRAIN_LAYERS layers, bf16, remat on,
    TRAIN_STEPS steps through the trainer's main; launches, losses, step
    times, peak memory; a profiled step; B7 against the plain expert
    path's loss and grad_norm from the same parameters and batch."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import synth_batch_for
    from repro_torch.kernels import _build
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_LAYERS)
    n_param = cfg.param_count()
    log("train", f"14b {LM_ARCH} at {TRAIN_LAYERS} of 32 layers (remat "
        f"{cfg.remat}, {cfg.dtype}): {n_param / 1e9:.3f} B parameters, state "
        f"reckoned {n_param * 12 / 1e9:.1f} GB (2 bf16 weight + 2 bf16 grad "
        f"+ 8 float32 moments a parameter)")
    argv = ["--arch", LM_ARCH, "--layers", str(TRAIN_LAYERS), "--steps",
            str(TRAIN_STEPS), "--global-batch", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
            "--log-every", "1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _build.reset_launches()
    run = train.main(argv)
    counts = dict(_build.LAUNCHES)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_moe = cfg.n_layers - cfg.first_k_dense
    want = {"moe_gmm": 9 * n_moe * TRAIN_STEPS}
    losses, run_metrics = run.losses, run.metrics
    steady = sorted(run.step_ms[2:6])
    med = (steady[1] + steady[2]) / 2
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log("train", f"14b {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens in {wall:.1f} s (init included): launches {counts} "
        f"(expected {want}: 3 forward + 3 recomputed + 3 dx per MoE layer "
        f"per step); losses {[round(x, 4) for x in losses]}; step ms (CUDA "
        f"events) {[round(x, 3) for x in run.step_ms]}; median of steps 3-6 "
        f"{med:.3f} ms, {tokens / med * 1e3:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB ({peak / 1e9:.1f} GB)")
    if counts != want:
        raise AssertionError(f"14b launch counts {counts} != {want}")
    if not np.isfinite(losses).all() or not (
            np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError(f"14b losses not finite and falling: {losses}")

    data = run.data
    batch = synth_batch_for(cfg, data, TRAIN_STEPS, device="cuda")
    step_fn = ST.make_train_step(run.cfg, run.opt)
    state = {"params": run.params, "opt": run.opt_state}

    def one_step():
        state["params"], state["opt"], _ = step_fn(state["params"],
                                                   state["opt"], batch)

    measure_step_memory("14b", run, one_step)
    prof = profile_train_step("14b profiled step", one_step)
    params = state["params"]
    del state, run
    torch.cuda.empty_cache()
    b7 = loss_and_grad_norm(cfg, params, batch)
    params.use_plain_experts(True)
    _build.reset_launches()
    plain = loss_and_grad_norm(cfg, params, batch)
    params.use_plain_experts(False)
    if dict(_build.LAUNCHES):
        raise AssertionError(f"the plain expert path launched "
                             f"{dict(_build.LAUNCHES)}")
    rel = [abs(a - b) / abs(b) for a, b in zip(b7, plain)]
    log("train", f"14b B7 against the plain expert path from the same "
        f"parameters and batch: loss {b7[0]:.6f} / {plain[0]:.6f} (relative "
        f"{rel[0]:.3e}), grad_norm {b7[1]:.6f} / {plain[1]:.6f} (relative "
        f"{rel[1]:.3e}; limit {TRAIN_REL_TOL})")
    if max(rel) > TRAIN_REL_TOL:
        raise AssertionError(f"14b B7 and the plain path differ: {rel}")
    del params
    torch.cuda.empty_cache()
    return dict(launches=counts["moe_gmm"], step_ms=med,
                tokens_per_s=tokens / med * 1e3, peak_gib=peak / 2**30,
                losses=losses,
                grad_norms=[m["grad_norm"] for m in run_metrics],
                profile={k: v for k, v in prof.items() if k != "parts"},
                b7_parts_ms={k: v[0] for k, v in prof["parts"].items()})


def phase_train_dense() -> dict:
    """14c: the trainer's default architecture at full size, every flag at
    the CLI's default but the step count."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    cfg = get_config("qwen1.5-4b")
    n_param = cfg.param_count()
    log("train", f"14c qwen1.5-4b, {cfg.n_layers} layers: {n_param / 1e9:.3f}"
        f" B parameters, state reckoned {n_param * 12 / 1e9:.1f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.main(["--arch", "qwen1.5-4b", "--steps", "3"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = run.losses
    moved = bool((run.params.final_norm.scale != 1).any())
    tokens = run.data.global_batch * run.data.seq_len
    med = float(np.median(run.step_ms[1:]))
    log("train", f"14c 3 steps of {run.data.global_batch} x "
        f"{run.data.seq_len} tokens in {wall:.1f} s (init included): losses "
        f"{[round(x, 4) for x in losses]}; step ms (CUDA events) "
        f"{[round(x, 3) for x in run.step_ms]}; median of steps 2-3 "
        f"{med:.3f} ms, {tokens / med * 1e3:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB ({peak / 1e9:.1f} GB); final_norm moved: "
        f"{moved}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and moved):
        raise AssertionError(f"14c: losses {losses}, parameters moved "
                             f"{moved}")
    from repro_torch.data.tokens import synth_batch_for
    from repro_torch.launch import steps as ST
    batch = synth_batch_for(run.cfg, run.data, 3, device="cuda")
    step_fn = ST.make_train_step(run.cfg, run.opt)

    def one_step():
        run.params, run.opt_state, _ = step_fn(run.params, run.opt_state,
                                               batch)

    measure_step_memory("14c", run, one_step)
    del run, batch
    torch.cuda.empty_cache()
    return dict(step_ms=med, tokens_per_s=tokens / med * 1e3,
                peak_gib=peak / 2**30, losses=losses)


def phase_train_resume(runs=((LM_ARCH, []), ("qwen1.5-4b", [])),
                       label: str = "14d") -> None:
    """14d (and 15e): reduced configs on the card, 8 steps with a
    checkpoint at step 4; a second main resumed from it gives steps 5-8's
    losses.  ``runs``: (arch, extra trainer flags)."""
    import shutil
    from repro_torch.data.tokens import synth_batch_for
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train
    for arch, extra in runs:
        name = arch.replace(".", "_")
        full, part = (os.path.join(TRAIN_DIR, f"{name}-{x}")
                      for x in ("full", "resumed"))
        for d in (full, part):
            shutil.rmtree(d, ignore_errors=True)
        flags = ["--arch", arch, "--reduced", "--steps", "8",
                 "--ckpt-every", "4", "--log-every", "100", *extra]
        a = train.main(flags + ["--ckpt-dir", full])
        os.makedirs(part)
        shutil.copytree(os.path.join(full, "step_0000000004"),
                        os.path.join(part, "step_0000000004"))
        b = train.main(flags + ["--ckpt-dir", part])
        want, got = a.losses[4:], b.losses
        batch = synth_batch_for(a.cfg, a.data, 8, device="cuda")
        step_fn = ST.make_train_step(a.cfg, a.opt)
        prof = profile_train_step(f"{label} {arch} reduced", lambda: step_fn(
            a.params, a.opt_state, batch))
        same = got == want
        worst = max(abs(x - y) / abs(y) for x, y in zip(got, want))
        log("train", f"{label} {arch} reduced ({a.cfg.dtype}, "
            f"{a.cfg.n_layers} layers): resumed at step "
            f"{b.start}; steps 5-8 losses {got} against the uninterrupted "
            f"{want}: bit for bit {same}, worst relative {worst:.3e}; "
            f"kernels that may add with atomics: {prof['atomic'] or 'none'}")
        if b.start != 4 or len(got) != 4:
            raise AssertionError(f"{label} {arch}: resumed at {b.start}")
        if not same and not (prof["atomic"] and worst <= RESUME_ATOMIC_RTOL):
            raise AssertionError(f"{label} {arch}: the resumed run differs "
                                 f"by {worst:.3e} relative")
        del a, b
    torch.cuda.empty_cache()


def check_train_grads(cfg, errors: dict) -> None:
    """14a: B7's gradient at the two training shapes and a ragged one."""
    for i, (case, s) in enumerate(train_shapes(cfg).items()):
        check_gmm_grad(case, s, seed=40 + i, errors=errors)
    # rows in tiles of 24 (not the kernel's 64-row blocks), 72-row
    # segments, and dx 96 columns wide (one partial column block); widths
    # above 128 must be multiples of 128 (the reference's f_tile rule)
    check_gmm_grad("ragged", dict(n_exp=3, capacity=72, t_tile=24, k=96,
                                  n=640), seed=42, errors=errors)


#: phase 19's measured steps: label -> the step's config, optimizer,
#: batch shape, its growth of allocated memory and its CUDA-event time
STEP_MEMORY: dict = {}


def measured(fn):
    """``fn()`` on the card: (its result, the growth of the allocated
    memory over what was allocated before, ``max_memory_allocated()``
    after ``reset_peak_memory_stats()`` less ``memory_allocated()``, its
    CUDA-event ms, the bytes allocated before)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return (out, torch.cuda.max_memory_allocated() - before,
            t0.elapsed_time(t1), before)


def measure_step_memory(label: str, run, one_step) -> None:
    """One more (warm) training step: the growth of the allocated memory
    over what the state and batch hold and its CUDA-event time
    (:func:`measured`), kept for phase 19 with the trainer ``run``'s
    config, optimizer and batch shape."""
    _, growth, ms, before = measured(one_step)
    STEP_MEMORY[label] = dict(cfg=run.cfg, opt=run.opt,
                              seq=run.data.seq_len,
                              batch=run.data.global_batch, growth=growth,
                              ms=ms, before=before)
    log("train", f"{label} one more step: allocated {before / 2**30:.3f} GiB "
        f"before, peak growth {growth} B ({growth / 2**30:.3f} GiB), "
        f"{ms:.3f} ms")


def phase_train(errors: dict) -> dict:
    from repro_torch.configs.base import get_config
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_LAYERS)
    check_train_grads(cfg, errors)
    times = {case: time_gmm_grad(case, s, seed=50 + i)
             for i, (case, s) in enumerate(train_shapes(cfg).items())}
    # the resume first: its runs are held bit for bit, before any profiler
    # has run in this process
    t1 = time.perf_counter()
    phase_train_resume()
    t2 = time.perf_counter()
    moe = phase_train_moe()
    t3 = time.perf_counter()
    dense = phase_train_dense()
    t4 = time.perf_counter()
    log("train", f"phase 14 took {t4 - t0:.1f} s: 14a {t1 - t0:.1f} s, 14d "
        f"{t2 - t1:.1f} s, 14b {t3 - t2:.1f} s, 14c {t4 - t3:.1f} s")
    return dict(launches=moe["launches"], shapes=times, moe=moe,
                dense=dense)


# ----------------------------------------------------------------------------
# 15. long sequences: flash attention, the SSM and the hybrid
# ----------------------------------------------------------------------------

#: the long phase's bf16 check: |got - want| <= 2e-2 + 2e-2 |want|
LONG_TOL = dict(rtol=2e-2, atol=2e-2)
#: flash against autograd through dense attention in fp32
FLASH_FP32_TOL = dict(rtol=1e-4, atol=1e-5)
#: qwen1.5-4b's attention geometry at train_4k's length
FLASH_GEOM = dict(B=1, S=4096, H=20, hd=128, chunk=512)
#: the length at which flash's and dense's peak memories are compared
FLASH_MEM_S = 8192
#: prefill_32k's length (its batch of 32 is a pod's; here batch 1), the
#: tokens generated after it, and long_500k's context (the cache budget)
LONG_PROMPT, LONG_GEN, LONG_S_MAX = 32_768, 16, 524_288
#: the prefill + decode check: a prompt of LONG_CHECK tokens, LONG_STEPS
#: decode steps, held to forward_train over LONG_CHECK + 512 tokens (a
#: multiple of 512, so flash runs in chunks of 512 there too)
LONG_CHECK, LONG_STEPS = 4096, 8
#: 15e: full-size training, batch 1 x LONG_TRAIN_SEQ tokens
LONG_TRAIN_SEQ, LONG_TRAIN_STEPS = 4096, 4
#: the ssm/hybrid reduced resumes: (arch, extra trainer flags)
LONG_RESUMES = (("mamba2-2.7b", []), ("zamba2-1.2b", ["--layers", "5"]))


def within(got, want, tol: dict) -> tuple:
    """(whether got is finite and |got - want| <= atol + rtol |want|
    everywhere, max |got - want|, max |got - want| / (atol + rtol |want|)),
    in float32."""
    a, b = got.float(), want.float()
    err = (a - b).abs()
    ratio = float((err / (tol["atol"] + tol["rtol"] * b.abs())).max())
    return bool(torch.isfinite(a).all()) and ratio <= 1.0, float(
        err.max()), ratio


def attention_flops(S: int, H: int, hd: int, backward: bool) -> float:
    """Causal attention's matrix-product FLOPs: QK^T and PV over the lower
    triangle (S^2 / 2 pairs, 2 hd FLOPs each), and in the backward the
    recomputed QK^T and four more products."""
    fwd = 2 * 2 * (S * S / 2) * hd * H
    return fwd * (1 + 5 / 2) if backward else fwd


def flash_check(dtype, g, errors: dict, geom: dict = FLASH_GEOM,
                label: str = "15a", hold: bool = True) -> dict:
    """Flash at ``geom`` (B, S, H, hd, chunk, and KV heads, H by default;
    q grouped (B, S, KV, H / KV, hd)) in one dtype: output and gradients
    against autograd through dense_attention (held within the dtype's
    tolerance where ``hold``, else measured), a second backward
    bit-identical, CUDA-event times beside SDPA's on the same tensors."""
    import torch.nn.functional as F
    from repro_torch.models.flash import flash_attention
    from repro_torch.models.layers import dense_attention
    B, S, H, hd, chunk = (geom[k] for k in ("B", "S", "H", "hd", "chunk"))
    KV = geom.get("KV", H)
    name = "fp32" if dtype == torch.float32 else "bf16"
    q, k, v, dout = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                     for shape in ((B, S, KV, H // KV, hd), (B, S, KV, hd),
                                   (B, S, KV, hd), (B, S, KV, H // KV, hd)))
    tol = FLASH_FP32_TOL if dtype == torch.float32 else LONG_TOL

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ts)
        return (out.detach(), *torch.autograd.grad(out, ts, dout))

    def dense(a, b, c):
        return dense_attention(a.reshape(B, S, H, hd), b, c).reshape(
            B, S, KV, H // KV, hd)

    got = grads(lambda a, b, c: flash_attention(a, b, c, chunk))
    want = grads(dense)
    errs, shares = {}, {}
    for part, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        ok, err, shares[part] = within(a, b, tol)
        errs[part] = err
        if hold and not ok:
            raise AssertionError(f"{label} flash {name} {part}: max abs err "
                                 f"{err:.3e} against dense beyond {tol}")
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*ts, chunk)
    first = torch.autograd.grad(out, ts, dout, retain_graph=True)
    second = torch.autograd.grad(out, ts, dout)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{label} flash {name}: a second backward "
                             f"differs")
    del got, want, first, second, out, ts
    torch.cuda.empty_cache()

    # times: the forward alone, forward + backward, beside SDPA on the same
    # tensors in its (B, H, S, hd) layout; and the host's time to issue one
    # forward (the pair loop's launches), against its device time
    qs, ds = (t.reshape(B, S, H, hd).transpose(1, 2) for t in (q, dout))
    ks, vs = (t.transpose(1, 2) for t in (k, v))
    # KV heads shared by H / KV query heads: SDPA's own grouped form
    gqa = {"enable_gqa": True} if KV != H else {}

    def fwd_bwd(fn, d, *args):
        args = [a.detach().requires_grad_() for a in args]
        torch.autograd.grad(fn(*args), args, d)

    with torch.no_grad():
        row = {"fwd_ms": time_ms(lambda: flash_attention(q, k, v, chunk)),
               "sdpa_fwd_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, is_causal=True, **gqa))}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flash_attention(q, k, v, chunk)
        row["fwd_host_ms"] = host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    row["fwd_bwd_ms"] = time_ms(lambda: fwd_bwd(
        lambda a, b, c: flash_attention(a, b, c, chunk), dout, q, k, v))
    row["sdpa_fwd_bwd_ms"] = time_ms(lambda: fwd_bwd(
        lambda a, b, c: F.scaled_dot_product_attention(a, b, c,
                                                       is_causal=True, **gqa),
        ds, qs, ks, vs))
    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    # q, k, v and out once (backward: q, k, v, out, dout read, dq, dk, dv
    # written)
    row["bound_fwd_ms"] = bound(2 * (H + KV) * B * S * hd * q.element_size(),
                                attention_flops(S, H, hd, False), peak)[0]
    row["bound_fwd_bwd_ms"] = bound(
        4 * (H + KV) * B * S * hd * q.element_size(),
        attention_flops(S, H, hd, True), peak)[0]
    row["max_abs_err"], row["share_of_tol"] = errs, shares
    errors.setdefault("flash", {})[f"{label} {name}"] = errs
    log("long", f"{label} flash {name} at B {B}, S {S}, H {H} (KV {KV}), hd "
        f"{hd}, chunk {chunk}: max abs err against autograd through dense "
        f"{', '.join(f'{k} {e:.3e}' for k, e in errs.items())} (rtol "
        f"{tol['rtol']}, atol {tol['atol']}; worst share of it "
        f"{max(shares.values()):.3f}, {'held' if hold else 'measured'}); a "
        f"second backward "
        f"bit-identical; forward {row['fwd_ms']:.3f} ms (host issue "
        f"{host_ms:.3f} ms), forward + backward {row['fwd_bwd_ms']:.3f} ms;"
        f" SDPA (is_causal) {row['sdpa_fwd_ms']:.3f} / "
        f"{row['sdpa_fwd_bwd_ms']:.3f} ms; bound {row['bound_fwd_ms']:.4f} /"
        f" {row['bound_fwd_bwd_ms']:.4f} ms (CUDA events over "
        f"{TIMED_LAUNCHES} runs)")
    return row


def flash_vs_oracle(g, geom: dict, label: str) -> dict:
    """Flash in float32 at ``geom`` (flash_check's geometry) against causal
    attention computed in float64 on the same inputs (its scores, softmax
    and autograd in float64): the output and dq, dk, dv within
    FLASH_FP32_TOL; dense_attention's float32 distance from the same
    oracle logged beside flash's.  dk and dv sum over a group's heads, so
    at large groups float32's own summation error is a fair share of the
    tolerance, and the oracle, not dense_attention's float32, is the
    reference."""
    from repro_torch.models.flash import flash_attention
    from repro_torch.models.layers import dense_attention
    B, S, H, hd, chunk = (geom[k] for k in ("B", "S", "H", "hd", "chunk"))
    KV = geom.get("KV", H)
    G = H // KV
    q, k, v, dout = (torch.randn(shape, generator=g, device="cuda")
                     for shape in ((B, S, KV, G, hd), (B, S, KV, hd),
                                   (B, S, KV, hd), (B, S, KV, G, hd)))

    def grads(fn, dtype):
        ts = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        out = fn(*ts)
        return (out.detach(), *torch.autograd.grad(out, ts, dout.to(dtype)))

    def oracle(a, b, c):
        s = torch.einsum("bqkgh,bskh->bkgqs", a, b) / hd ** 0.5
        causal = torch.ones(S, S, dtype=torch.bool, device=a.device).tril()
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        return torch.einsum("bkgqs,bskh->bqkgh", p, c)

    def dense(a, b, c):
        return dense_attention(a.reshape(B, S, H, hd), b, c).reshape(
            B, S, KV, G, hd)

    want = grads(oracle, torch.float64)
    torch.cuda.empty_cache()
    row = {}
    for name, fn in (("flash", lambda a, b, c: flash_attention(a, b, c,
                                                                chunk)),
                     ("dense", dense)):
        got = grads(fn, torch.float32)
        row[name] = {part: within(a.double(), b, FLASH_FP32_TOL)
                     for part, a, b in zip(("out", "dq", "dk", "dv"), got,
                                           want)}
        del got
        torch.cuda.empty_cache()
    log("long", f"{label} flash fp32 at B {B}, S {S}, H {H} (KV {KV}), hd "
        f"{hd}, chunk {chunk} against float64 attention: max abs err "
        + ", ".join(f"{p} {e:.3e}" for p, (_, e, _) in row["flash"].items())
        + f" (rtol {FLASH_FP32_TOL['rtol']}, atol {FLASH_FP32_TOL['atol']};"
        f" worst share of it {max(r for _, _, r in row['flash'].values()):.3f}"
        f", held); dense_attention in float32: "
        + ", ".join(f"{p} {e:.3e}" for p, (_, e, _) in row["dense"].items())
        + f" (worst share {max(r for _, _, r in row['dense'].values()):.3f},"
        f" measured)")
    for part, (ok, err, _) in row["flash"].items():
        if not ok:
            raise AssertionError(f"{label} flash fp32 {part}: max abs err "
                                 f"{err:.3e} against float64 attention "
                                 f"beyond {FLASH_FP32_TOL}")
    del want
    torch.cuda.empty_cache()
    return {name: {part: dict(max_abs_err=err, share_of_tol=share)
                   for part, (_, err, share) in parts.items()}
            for name, parts in row.items()}


def flash_memory(g) -> dict:
    """15a at FLASH_MEM_S, bf16: peak memory above the inputs of flash's and
    dense's forward + backward."""
    from repro_torch.models.flash import flash_attention
    from repro_torch.models.layers import dense_attention
    B, H, hd, chunk = (FLASH_GEOM[k] for k in ("B", "H", "hd", "chunk"))
    S = FLASH_MEM_S
    q, k, v = (torch.randn(shape, generator=g, device="cuda").bfloat16()
               for shape in ((B, S, H, 1, hd), (B, S, H, hd), (B, S, H, hd)))
    out = {}
    for label, fn in (
            ("flash", lambda a, b, c: flash_attention(a, b, c, chunk)),
            ("dense", lambda a, b, c: dense_attention(
                a.reshape(B, S, H, hd), b, c))):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        o = fn(*ts)
        torch.autograd.grad(o.float().square().sum(), ts)
        torch.cuda.synchronize()
        out[label] = (torch.cuda.max_memory_allocated() - base) / 2**30
        del o, ts
    torch.cuda.empty_cache()
    log("long", f"15a peak memory above the inputs at S {S} (bf16, forward +"
        f" backward): flash {out['flash']:.3f} GiB, dense "
        f"{out['dense']:.3f} GiB (dense's float32 scores alone "
        f"{B * H * S * S * 4 / 1e9:.1f} GB)")
    return out


def phase_long_flash(errors: dict) -> dict:
    g = torch.Generator(device="cuda").manual_seed(60)
    rows = {("fp32" if dt == torch.float32 else "bf16"): flash_check(
        dt, g, errors) for dt in (torch.float32, torch.bfloat16)}
    rows["peak_gib_s8192"] = flash_memory(g)
    return rows


def seeded_tokens(vocab: int, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, vocab, (1, n)), dtype=torch.int32,
                           device="cuda")


def long_model(arch: str):
    """``arch`` at full size, bf16, seeded random weights on the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    log("long", f"{arch}: {cfg.n_layers} layers, {cfg.param_count() / 1e9:.3f}"
        f" B parameters ({cfg.dtype}), on the card")
    return cfg, params


def check_decode_against_train(label: str, cfg, params, seed: int,
                               hold: bool, prompt: int = LONG_CHECK,
                               phase: str = "long") -> dict:
    """A ``prompt``-token prefill and LONG_STEPS decode steps (the tokens
    that follow in the sequence), each step's logits against
    forward_train's at its position over ``prompt`` + 512 tokens: within
    LONG_TOL where ``hold`` (the float32 model), else measured (bf16: the
    decode step rounds to bf16 where the chunked scan does not, in the
    reference as here, so the two drift apart with depth)."""
    from repro_torch.launch.serve import pad_cache
    from repro_torch.models import transformer as T
    dtype = str(next(params.parameters()).dtype).split(".")[1]
    tokens = seeded_tokens(cfg.vocab_size, prompt + 512, seed)
    logits, cache = T.prefill(cfg, params, {"tokens": tokens[:, :prompt]})
    state = {k: v.numel() * v.element_size() for k, v in cache.items()}
    steps = [logits[:, -1]]
    cache = pad_cache(cache, prompt + LONG_STEPS)
    for i in range(LONG_STEPS):
        pos = prompt + i
        logits, cache = T.decode_step(cfg, params, dict(
            tokens=tokens[:, pos:pos + 1], cache=cache, cache_index=pos))
        cache.pop("index")
        steps.append(logits[:, -1])
    del cache
    with torch.no_grad():
        full, _ = T.forward_train(cfg, params, {"tokens": tokens})
    errs, ratios = [], []
    for i, got in enumerate(steps):
        ok, err, ratio = within(got, full[:, prompt - 1 + i], LONG_TOL)
        errs.append(err)
        ratios.append(ratio)
        if hold and not ok:
            raise AssertionError(f"{label} {dtype}: position "
                                 f"{prompt - 1 + i}'s logits differ from "
                                 f"forward_train's by {err:.3e} (beyond "
                                 f"{LONG_TOL})")
    std = float(full[:, prompt - 1:].float().std())
    del full
    torch.cuda.empty_cache()
    log(phase, f"{label} {dtype}: prefill of {prompt} tokens and "
        f"{LONG_STEPS} decode steps against forward_train over "
        f"{prompt + 512}: max abs err per position "
        f"{[f'{e:.2e}' for e in errs]}, worst share of the limit 2e-2 + "
        f"2e-2 |x| {max(ratios):.3f} ({'held' if hold else 'measured'}; "
        f"the logits' std {std:.3f}); cache bytes after the prefill {state}")
    return dict(max_abs_err=max(errs), worst_share=max(ratios),
                state_bytes=state)


def long_generate(label: str, cfg, params, seed: int, s_max=None) -> dict:
    """A LONG_PROMPT-token prompt at batch 1 and LONG_GEN tokens through
    launch.serve.generate: prefill seconds, decode ms a step, tokens/s and
    peak memory."""
    from repro_torch.launch.serve import generate
    prompt = seeded_tokens(cfg.vocab_size, LONG_PROMPT, seed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tokens, logits, seconds = generate(cfg, params, prompt, LONG_GEN,
                                       s_max=s_max)
    peak = torch.cuda.max_memory_allocated()
    if tokens.shape != (1, LONG_GEN) or not all(
            bool(torch.isfinite(x).all()) for x in logits):
        raise AssertionError(f"{label}: generate gave {tuple(tokens.shape)} "
                             "tokens or non-finite logits")
    steps = LONG_GEN - 1
    row = dict(prefill_s=seconds["prefill"],
               decode_ms=seconds["decode"] / steps * 1e3,
               tokens_per_s=steps / seconds["decode"],
               prefill_tokens_per_s=LONG_PROMPT / seconds["prefill"],
               peak_gib=peak / 2**30,
               s_max=s_max or LONG_PROMPT + LONG_GEN)
    log("long", f"{label} prompt {LONG_PROMPT} + {LONG_GEN} tokens (batch 1, "
        f"S_max {row['s_max']}): prefill {row['prefill_s']:.3f} s "
        f"({row['prefill_tokens_per_s']:.0f} tokens/s), decode "
        f"{row['decode_ms']:.3f} ms a step ({row['tokens_per_s']:.2f} "
        f"tokens/s), peak memory {row['peak_gib']:.2f} GiB "
        f"({peak / 1e9:.1f} GB) (host clock, each ending in a "
        f"synchronisation)")
    return row


def phase_long_dense() -> dict:
    """15b: qwen1.5-4b at full size: a LONG_CHECK-token prefill on flash
    against the same prefill on dense attention, then prefill_32k's length
    at batch 1 and LONG_GEN tokens."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg, params = long_model("qwen1.5-4b")
    tokens = seeded_tokens(cfg.vocab_size, LONG_CHECK, 61)
    flash, _ = T.prefill(cfg, params, {"tokens": tokens})
    self_attention = L._self_attention
    L._self_attention = lambda q, k, v: L.dense_attention(q, k, v,
                                                          causal=True)
    try:
        dense, _ = T.prefill(cfg, params, {"tokens": tokens})
    finally:
        L._self_attention = self_attention
    ok, err, share = within(flash, dense, LONG_TOL)
    log("long", f"15b qwen1.5-4b prefill of {LONG_CHECK} tokens, flash "
        f"against dense attention: last logits max abs err {err:.3e}, "
        f"worst share of the limit 2e-2 + 2e-2 |x| {share:.3f}")
    if not ok:
        raise AssertionError(f"15b flash and dense prefills differ by {err}")
    del flash, dense
    torch.cuda.empty_cache()
    kv = 2 * cfg.n_layers * (LONG_PROMPT + LONG_GEN) * cfg.n_kv_heads \
        * cfg.resolved_head_dim * 2
    log("long", f"15b KV cache at {LONG_PROMPT + LONG_GEN} positions: "
        f"{kv / 1e9:.1f} GB")
    row = long_generate("15b qwen1.5-4b", cfg, params, 62)
    row.update(flash_vs_dense_err=err, flash_vs_dense_share=share,
               kv_bytes=kv)
    del params
    torch.cuda.empty_cache()
    return row


def phase_long_ssm(errors: dict) -> dict:
    """15c: ssd_chunked at one mamba2-2.7b layer's geometry against a
    float64 recurrence on the card; mamba2-2.7b at full size: prefill +
    decode against forward_train, then prefill_32k's length."""
    from repro_torch.models.mamba2 import ssd_chunked
    B, S, H, P, N, G, chunk = 1, 1024, 80, 64, 128, 1, 128
    g = torch.Generator(device="cuda").manual_seed(63)
    x = torch.randn((B, S, H, P), generator=g, device="cuda")
    dt = torch.rand((B, S, H), generator=g, device="cuda") * 0.8 + 0.1
    a = -(torch.rand((H,), generator=g, device="cuda") * 1.5 + 0.5)
    b = torch.randn((B, S, G, N), generator=g, device="cuda")
    c = torch.randn((B, S, G, N), generator=g, device="cuda")
    y, h = ssd_chunked(x, dt, a, b, c, chunk)
    h64 = torch.zeros((B, H, P, N), dtype=torch.float64, device="cuda")
    y64 = torch.empty((B, S, H, P), dtype=torch.float64, device="cuda")
    x6, dt6, a6 = x.double(), dt.double(), a.double()
    bh = b.double().repeat_interleave(H // G, dim=2)
    ch = c.double().repeat_interleave(H // G, dim=2)
    for t in range(S):
        decay = torch.exp(dt6[:, t] * a6[None, :])
        h64 = h64 * decay[..., None, None] + (
            dt6[:, t][..., None] * x6[:, t])[..., None] * bh[:, t][:, :, None]
        y64[:, t] = torch.einsum("bhpn,bhn->bhp", h64, ch[:, t])
    tol = dict(rtol=3e-4, atol=3e-4)
    errs = {}
    for label, got, want in (("y", y, y64), ("state", h, h64)):
        ok, errs[label], _ = within(got.double(), want, tol)
        if not ok:
            raise AssertionError(f"15c ssd_chunked {label}: max abs err "
                                 f"{errs[label]:.3e} beyond {tol}")
    errors["ssd"] = errs
    log("long", f"15c ssd_chunked at mamba2-2.7b's layer geometry (H {H}, P "
        f"{P}, N {N}, G {G}, chunk {chunk}, S {S}, fp32) against a float64 "
        f"sequential recurrence on the card: max abs err y "
        f"{errs['y']:.3e} (largest |y| {float(y64.abs().max()):.2f}), state "
        f"{errs['state']:.3e} (rtol {tol['rtol']}, atol {tol['atol']})")
    del x, dt, b, c, y, h, h64, y64, x6, dt6, bh, ch
    torch.cuda.empty_cache()
    cfg, params = long_model("mamba2-2.7b")
    bf16 = check_decode_against_train("15c mamba2-2.7b", cfg, params, 64,
                                      hold=False)
    row = long_generate("15c mamba2-2.7b", cfg, params, 65)
    fp32 = check_decode_against_train("15c mamba2-2.7b", cfg, params.float(),
                                      64, hold=True)
    row.update(decode_check_bf16=bf16, decode_check_fp32=fp32, ssd_err=errs)
    log("long", f"15c decode state: SSM {bf16['state_bytes']['ssm'] / 1e6:.1f}"
        f" MB + conv {bf16['state_bytes']['conv'] / 1e6:.2f} MB at any "
        f"context length")
    del params
    torch.cuda.empty_cache()
    return row


def phase_long_hybrid() -> dict:
    """15d: zamba2-1.2b at full size: prefill + decode against
    forward_train, then prefill_32k's length with long_500k's cache
    budget."""
    cfg, params = long_model("zamba2-1.2b")
    n_super, tail = divmod(cfg.n_layers, cfg.attn_every)
    log("long", f"15d zamba2-1.2b: {n_super} shared-block applications, a "
        f"tail of {tail}")
    bf16 = check_decode_against_train("15d zamba2-1.2b", cfg, params, 66,
                                      hold=False)
    kv = 2 * n_super * LONG_S_MAX * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    log("long", f"15d KV cache at S_max {LONG_S_MAX}: {kv / 1e9:.1f} GB, read "
        "whole by every decode step (attention_decode masks over S_max)")
    row = long_generate("15d zamba2-1.2b", cfg, params, 67,
                        s_max=LONG_S_MAX)
    fp32 = check_decode_against_train("15d zamba2-1.2b", cfg, params.float(),
                                      66, hold=True)
    row.update(decode_check_bf16=bf16, decode_check_fp32=fp32, kv_bytes=kv)
    del params
    torch.cuda.empty_cache()
    return row


def phase_long_train() -> dict:
    """15e: mamba2-2.7b and zamba2-1.2b at full size through the trainer's
    main (bf16, remat on, batch 1 x LONG_TRAIN_SEQ); then the reduced
    resumes."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    from repro_torch.models import layers as L
    out = {}
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        cfg = get_config(arch)
        n_param = cfg.param_count()
        calls = []
        flash = L.flash_attention
        L.flash_attention = lambda *a: (calls.append(a[-1]), flash(*a))[1]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            run = train.main(["--arch", arch, "--steps",
                              str(LONG_TRAIN_STEPS), "--global-batch", "1",
                              "--seq-len", str(LONG_TRAIN_SEQ), "--lr",
                              str(TRAIN_LR), "--log-every", "1"])
        finally:
            L.flash_attention = flash
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = run.losses
        med = float(np.median(run.step_ms[1:]))
        # flash forward per step: the forward and its recomputation
        want_calls = (2 * (cfg.n_layers // cfg.attn_every) * LONG_TRAIN_STEPS
                      if cfg.family == "hybrid"
                      and LONG_TRAIN_SEQ > L.BLOCK_THRESHOLD else 0)
        log("long", f"15e {arch} ({cfg.n_layers} layers, "
            f"{n_param / 1e9:.3f} B parameters, state reckoned "
            f"{n_param * 12 / 1e9:.1f} GB at 12 B a parameter), "
            f"{LONG_TRAIN_STEPS} steps of 1 x {LONG_TRAIN_SEQ} tokens in "
            f"{wall:.1f} s (init included): losses "
            f"{[round(x, 4) for x in losses]}; step ms (CUDA events) "
            f"{[round(x, 3) for x in run.step_ms]}; median of steps 2-"
            f"{LONG_TRAIN_STEPS} {med:.3f} ms, "
            f"{LONG_TRAIN_SEQ / med * 1e3:.1f} tokens/s; peak memory "
            f"{peak / 2**30:.2f} GiB ({peak / 1e9:.1f} GB); flash calls "
            f"{len(calls)} (expected {want_calls}: forward and remat "
            f"recomputation of each shared-block application; chunk "
            f"{sorted(set(calls))})")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"15e {arch}: losses {losses}")
        if len(calls) != want_calls:
            raise AssertionError(f"15e {arch}: {len(calls)} flash calls, "
                                 f"expected {want_calls}")
        out[arch] = dict(step_ms=med, tokens_per_s=LONG_TRAIN_SEQ / med * 1e3,
                         peak_gib=peak / 2**30,
                         state_gb=n_param * 12 / 1e9, losses=losses)
        del run
        torch.cuda.empty_cache()
    phase_train_resume(LONG_RESUMES, "15e")
    return out


def phase_long(errors: dict) -> dict:
    t = [time.perf_counter()]
    out = {"flash": phase_long_flash(errors)}
    t.append(time.perf_counter())
    out["dense"] = phase_long_dense()
    t.append(time.perf_counter())
    out["ssm"] = phase_long_ssm(errors)
    t.append(time.perf_counter())
    out["hybrid"] = phase_long_hybrid()
    t.append(time.perf_counter())
    out["train"] = phase_long_train()
    t.append(time.perf_counter())
    secs = [b - a for a, b in zip(t, t[1:])]
    out["seconds"] = dict(zip("abcde", secs))
    log("long", f"phase 15 took {t[-1] - t[0]:.1f} s: "
        + ", ".join(f"15{k} {v:.1f} s" for k, v in out["seconds"].items()))
    return out


# ----------------------------------------------------------------------------
# 16. the LM and the cohort on a (data, model) mesh
# ----------------------------------------------------------------------------

MESH_LM_DIR = os.path.join(ROOT, "build", "mesh-lm")
#: 16a and 16b train phi3.5-moe at full width at 14b's depth, batch and
#: learning rate: at 2 layers each of 16b's four ranks holds 8 of the 16
#: experts (bf16 weights and gradients), a quarter of the float32 moments
#: (ZeRO-1) and its tensor-parallel blocks of the dense weights
MESH_LM_STEPS = 3
#: 16a's largest relative gap per step to 14b's losses and gradient norms:
#: the mesh's attention takes the expanded-KV branch and 14b's the grouped
#: one (the H100 measured 1.649e-4 and 7.779e-3; about 5x each)
MESH_NCCL_REL_TOL = dict(losses=1e-3, grad_norms=4e-2)
#: 16b's largest relative gap per step to the single process of the same
#: G (which runs the tensor-parallel blocks' arithmetic,
#: ``hints.shape_blocks``): two data ranks' bf16 gradients are summed once
#: more in bf16 than one process's (the H100 measured 3.959e-4 and
#: 1.694e-3; about 5x each; one process at G = 1 is 8.9e-3 off in the
#: losses)
MESH_LM_REL_TOL = dict(losses=2e-3, grad_norms=1e-2)
#: 16b's final weights against the single process's, per leaf, as
#: ||w_mesh - w_single|| / ||w_single - w_init||: bf16 weights move about
#: one unit in the last place a step, so rounding leaves 0.055-0.154 on
#: the H100; about 2x that, below the 0.76-0.96 of a run without the
#: gradient's sum over data (the CPU rehearsal)
MESH_LM_UPDATE_TOL = 0.3
#: the leaves 16b gathers on rank 0 after its last step (the norms'
#: scales, 1.0 in bf16, do not move at this learning rate)
MESH_LM_LEAVES = ("embed", "layers/attn/wq", "layers/moe/router",
                  "layers/moe/wi_gate")
#: 16f's factors (``vr``, ``vc``) gathered on rank 0 after its last step
MESH_FACTORS = (("layers/attn/wq", "vr"), ("layers/attn/wq", "vc"),
                ("layers/moe/wi_gate", "vr"), ("layers/moe/wi_gate", "vc"))
#: 16f's factors against the single process's, per leaf, as
#: ||v_mesh - v_single|| / ||v_single||: means of squared bf16 gradients,
#: which two data ranks sum once more in bf16 than one process, and for
#: the experts' also tokens that a bf16 near-tie routes to another expert
#: (one column of vc was 19x off); the H100 measured 2.5e-3 and 9.5e-3
#: (wq's vr, vc), 1.3e-2 and 3.2e-2 (wi_gate's); about 5x each
MESH_FACTOR_TOL = {"layers/attn/wq": 5e-2, "layers/moe/wi_gate": 0.16}
#: the cohort on a mesh against the unplaced cohort (the reference's
#: tolerance, tests/test_distributed.py)
MESH_COHORT_TOL = dict(rtol=1e-4, atol=1e-5)
MESH_RANK_DEADLINE_S = 600.0
#: 16g: batch x prompt tokens and the tokens generated (one prefill, then
#: GEN - 1 decode steps), served by 16b's four ranks at 16b's depth
TP_SERVE = dict(batch=4, prompt=128, gen=8)
#: phase 7's served tokens and logits, which 16e is held to
LM_SERVED: dict = {}
#: 16h: the Mamba2 families' depth in training on the four ranks and in
#: one process (served at full depth): mamba2 4 of its 64 layers, zamba2
#: one super-layer of 6 and a tail of 2 (8 of 38).  Time sets the cut, not
#: memory: on an H100 a step through gloo takes seconds at these depths and
#: grows with depth, and the script must end within its time limit; the
#: ranks peak below 10 GiB each
SSM_MESH_LAYERS = {"mamba2-2.7b": 4, "zamba2-1.2b": 8}
SSM_MESH_REDUCED = ("reduced: trained at {} of {} layers (the time of a "
                    "step through gloo's host copies, which grows with "
                    "depth, within the script's time limit; not memory); "
                    "served at full depth")
#: the leaves 16h gathers on rank 0 after its last step and holds to one
#: process's as 16b does (MESH_LM_UPDATE_TOL): the small leaves every
#: ``model`` rank holds whole and uses a slice of (their gradients summed
#: over ``model``) and a column block.  ``norm_scale``, 1.0 in bf16, does
#: not move at this learning rate
SSM_MESH_LEAVES = ("layers/mamba/a_log", "layers/mamba/d_skip",
                   "layers/mamba/dt_bias", "layers/mamba/conv_bx",
                   "layers/mamba/conv_bb", "layers/mamba/wx")


def mesh_lm_argv(steps: int, extra=()) -> list:
    return ["--arch", LM_ARCH, "--layers", str(TRAIN_LAYERS), "--steps",
            str(steps), "--global-batch", str(TRAIN_BATCH), "--seq-len",
            str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--log-every", "1",
            *extra]


def mesh_restart_argv(steps: int, model_axis: int, ckpt: str) -> list:
    return ["--arch", LM_ARCH, "--reduced", "--steps", str(steps),
            "--seq-len", "64", "--global-batch", "8", "--lr", "1e-3",
            "--log-every", "1", "--model-axis", str(model_axis),
            "--device", "cuda:0", "--backend", "gloo", "--ckpt-dir", ckpt]


def adafactor_for(argv: list):
    """The trainer CLI's optimizer for ``argv`` (its learning rate and
    schedule) with Adafactor in AdamW's place (``train.main``'s ``opt``:
    the CLI has no flag for it)."""
    from repro_torch.launch import train
    return dataclasses.replace(train.cli_opt(train.parse_args(argv)),
                               kind="adafactor")


def b7_per_step(cfg) -> int:
    """B7 launches of one training step: 3 forward + 3 recomputed + 3 dx
    per MoE layer (14b's count)."""
    return 9 * (cfg.n_layers - cfg.first_k_dense)


def rel_diffs(got, want) -> list:
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def step_gaps(got: dict, want: dict) -> dict:
    """The largest relative gap per step of two runs' losses and gradient
    norms (``losses`` / ``grad_norms`` lists, compared over ``got``'s
    steps)."""
    return {k: max(rel_diffs(got[k], want[k])) for k in ("losses",
                                                           "grad_norms")}


def phase_mesh_nccl(trained: dict, cfg) -> dict:
    """16a: the trainer with --model-axis 1 on a (1, 1) mesh of one NCCL
    rank, held to 14b's unsharded run of the same seed (its losses and
    gradient norms per step)."""
    import torch.distributed as dist
    from repro_torch.distributed import spmd
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{spmd.free_port()}", world_size=1, rank=0)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _build.reset_launches()
        run = train.main(mesh_lm_argv(MESH_LM_STEPS, ["--model-axis", "1"]))
        counts = dict(_build.LAUNCHES)
        wall = time.perf_counter() - t0
        mesh = run.params.mesh_state.mesh
        live = (mesh.live, mesh.backend, dict(mesh.shape))
    finally:
        dist.destroy_process_group()
    peak = torch.cuda.max_memory_allocated()
    want = {"moe_gmm": b7_per_step(cfg) * MESH_LM_STEPS}
    got = dict(losses=run.losses,
               grad_norms=[m["grad_norm"] for m in run.metrics])
    gaps = step_gaps(got, trained)
    log("mesh-lm", f"16a {LM_ARCH} at {TRAIN_LAYERS} layers through "
        f"launch/train.py --model-axis 1 on a (1, 1) mesh of one NCCL rank "
        f"(live, backend, shape {live}): {MESH_LM_STEPS} steps in {wall:.1f} "
        f"s (init included), launches {counts} (expected {want}); losses "
        f"{[round(x, 4) for x in run.losses]} against 14b's "
        f"{[round(x, 4) for x in trained['losses'][:MESH_LM_STEPS]]}, "
        f"gradient norms {[round(x, 4) for x in got['grad_norms']]} against "
        f"{[round(x, 4) for x in trained['grad_norms'][:MESH_LM_STEPS]]}; "
        f"largest relative gaps {gaps} (limit {MESH_NCCL_REL_TOL}); step ms "
        f"(CUDA events) "
        f"{[round(x, 3) for x in run.step_ms]}; peak memory "
        f"{peak / 2**30:.2f} GiB; collectives recorded "
        f"{len(mesh.collectives)} (groups of one move nothing)")
    if live != (True, "nccl", {"data": 1, "model": 1}):
        raise AssertionError(f"16a ran on {live}")
    if counts != want:
        raise AssertionError(f"16a launch counts {counts} != {want}")
    if not np.isfinite(run.losses).all() or any(
            gaps[k] > MESH_NCCL_REL_TOL[k] for k in gaps):
        raise AssertionError(f"16a {got} against 14b's {trained}")
    out = dict(launches=counts["moe_gmm"], losses=run.losses,
               step_ms=run.step_ms, peak_gib=peak / 2**30, gaps=gaps)
    del run
    torch.cuda.empty_cache()
    return out


def picked_leaves(model, names=MESH_LM_LEAVES) -> dict:
    """The leaves ``names`` of a whole (unplaced) model, float32 on the
    host."""
    leaves = model.reference_leaves()
    return {k: leaves[k].stack([m.detach().float().cpu()
                                for m in leaves[k].members])
            for k in names}


def phase_mesh_single(cfg) -> dict:
    """16b's counterpart: one process under a shape-only (2, 2) mesh (the
    mesh run's dispatch groups, G = 2, and attention branch); keeps its
    final MESH_LM_LEAVES and the same leaves at initialisation (the
    trainer's seed)."""
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as HM
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    run = train.main(mesh_lm_argv(MESH_LM_STEPS),
                     mesh=HM.ShapeMesh((2, 2), ("data", "model")))
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"moe_gmm": b7_per_step(cfg) * MESH_LM_STEPS}
    log("mesh-lm", f"16b one process under a shape-only (2, 2) mesh: "
        f"launches {counts} (expected {want}); losses "
        f"{[round(x, 4) for x in run.losses]}; step ms "
        f"{[round(x, 3) for x in run.step_ms]}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    if counts != want:
        raise AssertionError(f"16b single launch counts {counts} != {want}")
    out = dict(launches=counts["moe_gmm"], losses=run.losses,
               grad_norms=[m["grad_norm"] for m in run.metrics],
               step_ms=run.step_ms, peak_gib=peak / 2**30,
               leaves=picked_leaves(run.params))
    del run
    torch.cuda.empty_cache()
    init = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    out["init"] = picked_leaves(init)
    del init
    torch.cuda.empty_cache()
    return out


def phase_mesh_single_adafactor(cfg) -> dict:
    """16f's counterpart: 16b's single process with Adafactor; keeps its
    final MESH_LM_LEAVES and MESH_FACTORS."""
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as HM
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = mesh_lm_argv(MESH_LM_STEPS)
    t0 = time.perf_counter()
    _build.reset_launches()
    run = train.main(argv, mesh=HM.ShapeMesh((2, 2), ("data", "model")),
                     opt=adafactor_for(argv))
    counts = dict(_build.LAUNCHES)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = {"moe_gmm": b7_per_step(cfg) * MESH_LM_STEPS}
    log("mesh-lm", f"16f one process under a shape-only (2, 2) mesh with "
        f"Adafactor ({run.opt}): launches {counts} (expected {want}); losses "
        f"{[round(x, 4) for x in run.losses]}; step ms "
        f"{[round(x, 3) for x in run.step_ms]}; peak memory "
        f"{peak / 2**30:.2f} GiB; {wall:.1f} s (init included)")
    if counts != want:
        raise AssertionError(f"16f single launch counts {counts} != {want}")
    if run.opt.kind != "adafactor" or "fac" not in run.opt_state:
        raise AssertionError(f"16f single ran {run.opt.kind}")
    out = dict(launches=counts["moe_gmm"], losses=run.losses,
               grad_norms=[m["grad_norm"] for m in run.metrics],
               step_ms=run.step_ms, peak_gib=peak / 2**30, wall_s=wall,
               leaves=picked_leaves(run.params),
               factors={f"{k}/{v}": run.opt_state["fac"][k][v].float().cpu()
                        for k, v in MESH_FACTORS})
    del run
    torch.cuda.empty_cache()
    return out


def mesh_rank_b7(params, cfg) -> dict:
    """B7 on this rank's own experts (EP) at the training step's segment
    shape, against its plain version; held to GMM_TOL's bf16 contract."""
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.ref import moe_gmm_ref
    from repro_torch.models.moe import capacity_of, t_tile_of
    w = params.layers[0].moe.wi_gate.detach()
    e = w.shape[0]
    cap = capacity_of(TRAIN_BATCH // 2 * TRAIN_SEQ, cfg.top_k,
                      cfg.n_experts, cfg.capacity_factor)
    t_tile = t_tile_of(cap)
    ids = torch.as_tensor(np.repeat(np.arange(e), cap // t_tile),
                          dtype=torch.int32, device=w.device)
    g = torch.Generator(device=w.device).manual_seed(70)
    x = torch.randn(e * cap, w.shape[1], generator=g, device=w.device
                    ).bfloat16()
    got = moe_gmm(ids, x, w, t_tile=t_tile)
    want = moe_gmm_ref(x.view(-1, t_tile, w.shape[1]), w, ids).view(
        e * cap, -1)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got, want, **GMM_TOL["bf16"])
    return dict(experts=e, capacity=cap, t_tile=t_tile, max_abs_err=err)


def mesh_rank_cohort(job: dict, dev: torch.device) -> None:
    """16d on this rank: phase 9's cohort (saved by the parent) on the
    process group's (2, 2) ProcessGroupMesh; rank 0 writes the weights,
    losses, seconds and collectives."""
    import torch.distributed as dist
    from repro_torch.core.batched import BatchedLifeEngine
    from repro_torch.core.life import LifeConfig
    problems = torch.load(job["cohort"], map_location=dev, weights_only=False)
    cfg = LifeConfig(executor="opt", n_iters=COHORT_ITERS, shard_rows=2,
                     shard_cols=2, plan_cache_dir="")
    eng = BatchedLifeEngine(problems, cfg, device=dev)
    torch.cuda.synchronize(dev)
    dist.barrier()
    t0 = time.perf_counter()
    w, losses = eng.run()
    torch.cuda.synchronize(dev)
    dist.barrier()
    seconds = time.perf_counter() - t0
    mesh = eng.mesh
    if dist.get_rank() == 0:
        np.savez(job["out"], W=w.cpu().numpy(), losses=losses.cpu().numpy(),
                 seconds=np.asarray(seconds),
                 coll_bytes=np.asarray([b for _, b, _ in mesh.collectives],
                                       np.int64),
                 coll_groups=np.asarray([g for _, _, g in mesh.collectives],
                                        np.int64),
                 staged=np.asarray(mesh.staged),
                 sharded=np.asarray([eng.subjects_sharded,
                                     eng.slots_sharded]))
    del eng, problems
    torch.cuda.empty_cache()


def tp_serve_argv(extra=(), arch: str = LM_ARCH,
                  layers: int = TRAIN_LAYERS) -> list:
    """launch/serve.py's arguments for 16g (16h: ``arch`` at full depth,
    ``layers`` 0)."""
    cut = ["--layers", str(layers)] if layers else []
    return ["--arch", arch, *cut, "--batch", str(TP_SERVE["batch"]),
            "--prompt-len", str(TP_SERVE["prompt"]), "--gen",
            str(TP_SERVE["gen"]), *extra]


def ssm_train_argv(arch: str, extra=()) -> list:
    """launch/train.py's arguments for 16h's training of ``arch``."""
    return ["--arch", arch, "--layers", str(SSM_MESH_LAYERS[arch]),
            "--steps", str(MESH_LM_STEPS), "--global-batch",
            str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--lr",
            str(TRAIN_LR), "--log-every", "1", *extra]


def mesh_rank_serve(job: dict, dev: torch.device, rank: int) -> None:
    """16g on this rank: launch/serve.py --model-axis 2, with the prefill
    and each decode step wrapped to record the mesh's collectives, the
    cache's shapes and bytes and the steps' seconds; writes a JSON."""
    from repro_torch.distributed import hints
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.roofline.analysis import collective_bytes
    seen: dict = {"steps": []}
    make_prefill, make_serve_step = serve.make_prefill, serve.make_serve_step

    def recorded_prefill(cfg):
        run = make_prefill(cfg)

        def prefill(params, batch, **kw):
            mesh = hints.live_mesh()
            n = len(mesh.collectives)
            logits, cache = run(params, batch, **kw)
            seen.update(prefill=list(mesh.collectives[n:]), mesh=mesh,
                        cache={k: [list(v.shape), v.numel() * v.element_size()]
                               for k, v in cache.items()})
            return logits, cache
        return prefill

    def recorded_step(cfg):
        run = make_serve_step(cfg)

        def step(params, batch):
            mesh = hints.live_mesh()
            n = len(mesh.collectives)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = run(params, batch)
            torch.cuda.synchronize(dev)
            seen["steps"].append((list(mesh.collectives[n:]),
                                  time.perf_counter() - t0))
            return out
        return step

    serve.make_prefill, serve.make_serve_step = recorded_prefill, recorded_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    try:
        tokens = serve.main(job["argv"])
    finally:
        serve.make_prefill, serve.make_serve_step = (make_prefill,
                                                     make_serve_step)
    mesh = seen["mesh"]
    out = dict(tokens=tokens.cpu().tolist(), launches=dict(_build.LAUNCHES),
               cache=seen["cache"], coords=mesh.coords, staged=mesh.staged,
               rs_emulated=list(mesh.rs_emulated),
               prefill=seen["prefill"],
               prefill_bytes=collective_bytes(seen["prefill"])["total"],
               steps=[r for r, _ in seen["steps"]],
               step_bytes=[collective_bytes(r)["total"]
                           for r, _ in seen["steps"]],
               step_counts=collective_bytes(seen["steps"][0][0])["counts"],
               step_ms=[t * 1e3 for _, t in seen["steps"]],
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    with open(f"{job['out']}-rank{rank}.json", "w") as f:
        json.dump(out, f)
    del tokens, mesh, seen
    torch.cuda.empty_cache()


def mesh_rank(jobs_path: str) -> int:
    """One gloo rank on cuda:0 of phase 16's spawn: joins the group the
    environment names, runs the job list in turn, writes a JSON per
    training job."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import shutil
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import spmd
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.roofline.analysis import collective_bytes
    dev = torch.device("cuda:0")
    with open(jobs_path) as f:
        jobs = json.load(f)
    spmd.join_process_group("gloo", dev)
    rank = dist.get_rank()
    try:
        for job in jobs:
            if job["kind"] == "copy":
                if rank == 0:
                    shutil.copytree(job["src"], job["dst"])
                dist.barrier()
                continue
            if job["kind"] == "cohort":
                mesh_rank_cohort(job, dev)
                continue
            if job["kind"] == "serve-tp":
                mesh_rank_serve(job, dev, rank)
                continue
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            _build.reset_launches()
            opt = (adafactor_for(job["argv"]) if job["kind"] ==
                   "train-adafactor" else None)
            run = train.main(job["argv"], opt=opt)
            counts = dict(_build.LAUNCHES)
            mesh = run.params.mesh_state.mesh
            cb = collective_bytes(mesh.collectives)
            out = dict(launches=counts, losses=run.losses,
                       grad_norms=[m["grad_norm"] for m in run.metrics],
                       step_ms=run.step_ms, staged=mesh.staged,
                       peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                       coll_bytes_per_step=cb["total"] / max(
                           1, len(run.step_ms)),
                       coll_counts=cb["counts"], coords=mesh.coords,
                       optimizer=run.opt.kind)
            if job["kind"] == "train-full":
                cfg = dataclasses.replace(get_config(LM_ARCH),
                                          n_layers=TRAIN_LAYERS)
                out["b7"] = mesh_rank_b7(run.params, cfg)
                lm = run.params.mesh_state
                leaves = {k: lm.gather_leaf(k).float()
                          for k in MESH_LM_LEAVES}
                if rank == 0:
                    torch.save(leaves, f"{job['out']}-leaves.pt")
                del lm, leaves
            if job["kind"] == "train-ssm":
                lm = run.params.mesh_state
                leaves = {k: lm.gather_leaf(k).float()
                          for k in SSM_MESH_LEAVES}
                if rank == 0:
                    torch.save(leaves, f"{job['out']}-leaves.pt")
                del lm, leaves
            if job["kind"] == "train-adafactor":
                lm = run.params.mesh_state
                specs = lm.opt_specs(run.opt)["fac"]
                saved = {k: lm.gather_leaf(k).float()
                         for k in MESH_LM_LEAVES}
                for k, v in MESH_FACTORS:
                    saved[f"{k}/{v}"] = SH.gather_shard(
                        run.opt_state["fac"][k][v], specs[k][v],
                        mesh).cpu()
                if rank == 0:
                    torch.save(saved, f"{job['out']}-leaves.pt")
                del lm, saved
            torch.cuda.synchronize(dev)
            out["job_s"] = time.perf_counter() - t0
            with open(f"{job['out']}-rank{rank}.json", "w") as f:
                json.dump(out, f)
            del run, mesh
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return 0


def weight_gaps(leaves: dict, single: dict, init: dict,
                names=MESH_LM_LEAVES) -> dict:
    """Per gathered leaf, (||w_mesh - w_single|| / ||w_single - w_init||,
    max abs diff)."""
    out = {}
    for k in names:
        w, ws = leaves[k], single[k]
        step = ws - init[k]
        out[k] = (float((w - ws).norm() / step.norm()),
                  float((w - ws).abs().max()))
    return out


def check_mesh_adafactor(cfg, single: dict, init: dict, prefix: str
                         ) -> dict:
    """16f: the four ranks' Adafactor job against the single process
    (``single``, :func:`phase_mesh_single_adafactor`), as 16b is held,
    and its gathered factors."""
    ranks = []
    for k in range(4):
        with open(f"{prefix}-rank{k}.json") as f:
            ranks.append(json.load(f))
    saved = torch.load(f"{prefix}-leaves.pt")
    gaps = step_gaps(ranks[0], single)
    updates = weight_gaps(saved, single["leaves"], init)
    factors = {}
    for key, want in single["factors"].items():
        got = saved[key]
        factors[key] = (float((got - want).norm() / want.norm()),
                        float(((got - want).abs() / want.abs().clamp(
                            min=1e-30)).max()))
    want = {"moe_gmm": b7_per_step(cfg) * MESH_LM_STEPS}
    for k, r in enumerate(ranks):
        log("mesh-lm", f"16f rank {k} cell {r['coords']} ({r['optimizer']}): "
            f"B7 launches {r['launches']} (expected {want}); step ms (CUDA "
            f"events) {[round(x, 1) for x in r['step_ms']]}; bytes moved per "
            f"device per step {r['coll_bytes_per_step'] / 1e9:.3f} GB "
            f"({r['coll_counts']}; staged through host memory: "
            f"{r['staged']}); peak memory {r['peak_gib']:.2f} GiB; job "
            f"{r['job_s']:.1f} s")
    log("mesh-lm", f"16f (2, 2) of four gloo ranks with Adafactor: losses "
        f"{[round(x, 4) for x in ranks[0]['losses']]} against the single "
        f"process's {[round(x, 4) for x in single['losses']]}, gradient "
        f"norms {[round(x, 4) for x in ranks[0]['grad_norms']]} against "
        f"{[round(x, 4) for x in single['grad_norms']]}; largest relative "
        f"gaps {gaps} (limit {MESH_LM_REL_TOL}); final weights per leaf "
        f"(||w_mesh - w_single|| / ||w_single - w_init||, max abs diff) "
        f"{updates} (limit {MESH_LM_UPDATE_TOL} on the first); factors "
        f"(||v_mesh - v_single|| / ||v_single||, max relative diff) "
        f"{factors} (limits {MESH_FACTOR_TOL} on the first)")
    for k, r in enumerate(ranks):
        if r["launches"] != want:
            raise AssertionError(f"16f rank {k} launches {r['launches']}")
        if r["optimizer"] != "adafactor":
            raise AssertionError(f"16f rank {k} ran {r['optimizer']}")
    if not np.isfinite(ranks[0]["losses"]).all() or any(
            gaps[k] > MESH_LM_REL_TOL[k] for k in gaps):
        raise AssertionError(f"16f {gaps} against the single process")
    if max(u for u, _ in updates.values()) > MESH_LM_UPDATE_TOL:
        raise AssertionError(f"16f final weights {updates}")
    if not all(np.isfinite(v) and v <= MESH_FACTOR_TOL[key.rsplit("/", 1)[0]]
               for key, (v, _) in factors.items()):
        raise AssertionError(f"16f factors {factors}")
    return dict(losses=ranks[0]["losses"], gaps=gaps, updates=updates,
                factors=factors, job_s=max(r["job_s"] for r in ranks),
                step_ms=[r["step_ms"] for r in ranks],
                bytes_per_step=[r["coll_bytes_per_step"] for r in ranks],
                coll_counts=ranks[0]["coll_counts"],
                peak_gib=[r["peak_gib"] for r in ranks],
                launches=sum(r["launches"]["moe_gmm"] for r in ranks))


def phase_mesh_ranks(cfg, single: dict, single_af: dict, single_tp: dict,
                     single_ssm: dict, cohort_path: str) -> dict:
    """16b, 16c, 16d, 16f, 16g and 16h's rank side: one spawn of four
    gloo ranks on cuda:0 (chip_smoke.py --mesh-rank), then the checks."""
    import shutil
    from repro_torch.checkpoint import manager as CK
    from repro_torch.distributed import spmd
    from repro_torch.launch.dryrun import step_collectives
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.roofline.analysis import collective_bytes
    d = MESH_LM_DIR
    full = os.path.join(d, "16b")
    adafactor = os.path.join(d, "16f")
    a, b = os.path.join(d, "ckpt-2x2"), os.path.join(d, "ckpt-1x4")
    restart = os.path.join(d, "16c")
    gloo_out = os.path.join(d, "16d-gloo.npz")
    for path in (a, b):
        shutil.rmtree(path, ignore_errors=True)
    jobs = [
        dict(kind="train-full", out=full, argv=mesh_lm_argv(
            MESH_LM_STEPS, ["--model-axis", "2", "--device", "cuda:0",
                            "--backend", "gloo"])),
        dict(kind="train-adafactor", out=adafactor, argv=mesh_lm_argv(
            MESH_LM_STEPS, ["--model-axis", "2", "--device", "cuda:0",
                            "--backend", "gloo"])),
        dict(kind="train", out=restart + "-2x2",
             argv=mesh_restart_argv(3, 2, a)),
        dict(kind="copy", src=a, dst=b),
        dict(kind="train", out=restart + "-resave",
             argv=mesh_restart_argv(3, 4, b)),
        dict(kind="train", out=restart + "-more",
             argv=mesh_restart_argv(5, 4, b)),
        dict(kind="cohort", cohort=cohort_path, out=gloo_out),
        dict(kind="serve-tp", out=os.path.join(d, "16g"), argv=tp_serve_argv(
            ["--model-axis", "2", "--device", "cuda:0", "--backend",
             "gloo"])),
        *ssm_rank_jobs(d),
    ]
    jobs_path = os.path.join(d, "jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    t0 = time.perf_counter()
    logs = spmd.launch([os.path.join(ROOT, "chip_smoke.py"), "--mesh-rank",
                        jobs_path], 4, os.path.join(d, "ranks"),
                       deadline_s=MESH_RANK_DEADLINE_S,
                       env={"PYTORCH_CUDA_ALLOC_CONF":
                            "expandable_segments:True"})
    wall = time.perf_counter() - t0
    staged = [k for k, text in enumerate(logs) if "staging" in text]
    log("mesh-lm", f"four gloo ranks on cuda:0 ran 16b, 16f, 16c, 16d, 16g "
        f"and 16h in {wall:.1f} s (process starts included); ranks that "
        f"staged their collectives through host memory: {staged}")

    # 16b
    ranks = []
    for k in range(4):
        with open(f"{full}-rank{k}.json") as f:
            ranks.append(json.load(f))
    losses = ranks[0]["losses"]
    gaps = step_gaps(ranks[0], single)
    leaves = torch.load(f"{full}-leaves.pt")
    updates = weight_gaps(leaves, single["leaves"], single["init"])
    want = {"moe_gmm": b7_per_step(cfg) * MESH_LM_STEPS}
    for k, r in enumerate(ranks):
        log("mesh-lm", f"16b rank {k} cell {r['coords']}: B7 launches "
            f"{r['launches']} (expected {want}) over its {r['b7']['experts']}"
            f" experts; B7 against its plain version on the rank's experts "
            f"({r['b7']['experts']} x {r['b7']['capacity']} rows, t_tile "
            f"{r['b7']['t_tile']}, bf16): max abs err "
            f"{r['b7']['max_abs_err']:.3e} (rtol {GMM_TOL['bf16']['rtol']}, "
            f"atol {GMM_TOL['bf16']['atol']}); step ms (CUDA events) "
            f"{[round(x, 1) for x in r['step_ms']]}; bytes moved per device "
            f"per step {r['coll_bytes_per_step'] / 1e9:.3f} GB "
            f"({r['coll_counts']}; gloo, staged through host memory: "
            f"{r['staged']}); peak memory {r['peak_gib']:.2f} GiB")
    log("mesh-lm", f"16b (2, 2) of four gloo ranks (EP: 8 experts a rank; "
        f"ZeRO-1 over data; G = 2): losses {[round(x, 4) for x in losses]} "
        f"against the single process's {[round(x, 4) for x in single['losses']]}"
        f", gradient norms {[round(x, 4) for x in ranks[0]['grad_norms']]} "
        f"against {[round(x, 4) for x in single['grad_norms']]}; largest "
        f"relative gaps {gaps} (limit {MESH_LM_REL_TOL}); final weights "
        f"gathered on rank 0 against the single process's, per leaf "
        f"(||w_mesh - w_single|| / ||w_single - w_init||, max abs diff): "
        f"{updates} (limit {MESH_LM_UPDATE_TOL} on the first); these are "
        f"gloo-through-host numbers on one card, not NVLink ones")
    for k, r in enumerate(ranks):
        if r["launches"] != want:
            raise AssertionError(f"16b rank {k} launches {r['launches']}")
        if r["b7"]["experts"] != cfg.n_experts // 2:
            raise AssertionError(f"16b rank {k} holds {r['b7']['experts']} "
                                 "experts")
    if not np.isfinite(losses).all() or any(
            gaps[k] > MESH_LM_REL_TOL[k] for k in gaps):
        raise AssertionError(f"16b {gaps} against the single process")
    if max(u for u, _ in updates.values()) > MESH_LM_UPDATE_TOL:
        raise AssertionError(f"16b final weights {updates}")

    # 16f
    af = check_mesh_adafactor(cfg, single_af, single["init"], adafactor)
    reckoned = {kind: collective_bytes(step_collectives(
        cfg, ShapeMesh(MESH_SHAPE, ("data", "model")), "train", TRAIN_SEQ,
        TRAIN_BATCH, OptConfig(kind=kind)))["total"]
        for kind in ("adafactor", "adamw")}
    log("mesh-lm", f"16f against 16b (AdamW) on the same ranks: bytes moved "
        f"per device per step {af['bytes_per_step'][0] / 1e9:.3f} GB against "
        f"{ranks[0]['coll_bytes_per_step'] / 1e9:.3f} GB (the dry run's "
        f"schedule, launch/dryrun.py:step_collectives, reckons "
        f"{reckoned['adafactor'] / 1e9:.3f} and "
        f"{reckoned['adamw'] / 1e9:.3f} GB); step ms "
        f"{[round(x, 1) for x in af['step_ms'][0]]} against "
        f"{[round(x, 1) for x in ranks[0]['step_ms']]}; peak memory per rank "
        f"{[round(x, 2) for x in af['peak_gib']]} GiB against "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB")

    # 16c
    first = CK.restore(a, 3)[1]
    again = CK.restore(b, 3)[1]
    same = sorted(first) == sorted(again) and all(
        torch.equal(first[k], again[k]) for k in first)
    with open(restart + "-2x2-rank0.json") as f:
        before = json.load(f)["losses"]
    with open(restart + "-more-rank0.json") as f:
        more = json.load(f)["losses"]
    log("mesh-lm", f"16c elastic restart ({LM_ARCH} reduced in width, a "
        f"cut: a full-width state of 2 layers is ~29 GB of whole tensors to "
        f"write): saved under (2, 2) after losses "
        f"{[round(x, 4) for x in before]}, restored and placed under (1, 4) "
        f"and saved again: {len(first)} arrays bit for bit the same: {same}; "
        f"two more steps under (1, 4): losses {[round(x, 4) for x in more]}")
    if not same:
        raise AssertionError("16c: the reshard changed the state")
    if len(more) != 2 or not np.isfinite(more).all() or not (
            more[-1] < before[0]):
        raise AssertionError(f"16c losses {more} after {before}")

    # 16g
    served = check_mesh_serve(cfg, single_tp, os.path.join(d, "16g"))

    # 16h
    ssm = check_mesh_ssm(single_ssm, d)

    # 16d's gloo side
    with np.load(gloo_out) as z:
        gloo = {k: z[k] for k in z.files}
    return dict(losses=losses, gaps=gaps, updates=updates, ranks=ranks,
                gloo=gloo, wall_s=wall, adafactor=af, serve_tp=served,
                ssm=ssm, launches=sum(r["launches"]["moe_gmm"] for r in ranks))


def phase_mesh_single_serve() -> dict:
    """16g's counterpart: launch/serve.py in one process under a
    shape-only (2, 2) mesh (the mesh run's dispatch groups and attention
    branch), the same seed, prompts and depth."""
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as HM
    from repro_torch.launch import serve
    torch.cuda.empty_cache()
    _build.reset_launches()
    t0 = time.perf_counter()
    tokens = serve.main(tp_serve_argv(), mesh=HM.ShapeMesh(
        MESH_SHAPE, ("data", "model"))).cpu()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    want = {"moe_gmm": 3 * TRAIN_LAYERS * TP_SERVE["gen"]}
    log("mesh-lm", f"16g one process under a shape-only (2, 2) mesh: "
        f"launch/serve.py {TP_SERVE}: launches {counts} (expected {want}) "
        f"in {wall:.1f} s; first row {tokens[0].tolist()}")
    if counts != want:
        raise AssertionError(f"16g single launch counts {counts} != {want}")
    torch.cuda.empty_cache()
    return dict(tokens=tokens, launches=counts["moe_gmm"], wall_s=wall)


def check_mesh_serve(cfg, single: dict, prefix: str,
                     label: str = "16g") -> dict:
    """16g (16h): the four ranks' tokens against the single process's;
    each rank's decode steps' collectives against launch/dryrun.py's
    reckoning (record for record) and each of its caches (KV; ssm, conv)
    against cache_specs' block."""
    from repro_torch.configs.base import cache_specs, meta_spec
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.dryrun import block_bytes, step_collectives
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.roofline.analysis import collective_bytes
    mesh = ShapeMesh(MESH_SHAPE, ("data", "model"))
    B, P, G = TP_SERVE["batch"], TP_SERVE["prompt"], TP_SERVE["gen"]
    s_max = P + G
    reckoned = sorted(tuple(r) for r in step_collectives(
        cfg, mesh, "decode", s_max, B, OptConfig()))
    reckoned_bytes = collective_bytes(reckoned)["total"]
    whole = cache_specs(cfg, B, s_max, meta_spec, cfg.torch_dtype)
    specs = SH.batch_layout(cfg, mesh, "decode", B)["cache"]
    want_launches = ({"moe_gmm": 3 * cfg.n_layers * G}
                     if cfg.family == "moe" else {})
    want_tokens = single["tokens"].tolist()
    ranks, failures = [], []
    for k in range(4):
        with open(f"{prefix}-rank{k}.json") as f:
            r = json.load(f)
        ranks.append(r)
        block = {key: [[b.stop - b.start for b in SH.shard_bounds(
            tuple(t.shape), specs[key], mesh, r["coords"])],
            block_bytes(t, specs[key], mesh)] for key, t in whole.items()}
        cache_ok = sorted(r["cache"]) == sorted(block) and all(
            r["cache"][key] == block[key] for key in block)
        steps_ok = all(sorted(tuple(x) for x in st) == reckoned
                       for st in r["steps"])
        held = "; ".join(
            f"{key} {r['cache'][key][0]} = {r['cache'][key][1] / 2**20:.2f} "
            f"MiB (cache_specs' block {block[key][0]}; a data rank's whole "
            f"{key} {t.numel() * t.element_size() / 2**20 / MESH_SHAPE[0]:.2f}"
            f" MiB)" for key, t in whole.items() if key in r["cache"])
        log("mesh-lm", f"{label} rank {k} cell {r['coords']}: launches "
            f"{r['launches']} (expected {want_launches}); caches {held}: "
            f"{cache_ok}; bytes moved a decode step "
            f"{[round(x) for x in r['step_bytes']]} (launch/dryrun.py "
            f"reckons {round(reckoned_bytes)}; record for record: "
            f"{steps_ok}) in {r['step_counts']}; the prefill's "
            f"{r['prefill_bytes'] / 1e6:.3f} MB; decode step ms (host "
            f"clock, synchronised) {[round(x, 1) for x in r['step_ms']]}; "
            f"staged through host memory: {r['staged']}; reduce-scatters "
            f"run as all-reduces on: {r['rs_emulated']}; peak memory "
            f"{r['peak_gib']:.2f} GiB")
        if r["tokens"] != want_tokens:
            failures.append(f"rank {k} tokens {r['tokens']} != "
                            f"{want_tokens}")
        if {n: c for n, c in r["launches"].items() if c} != want_launches:
            failures.append(f"rank {k} launches {r['launches']}")
        if not cache_ok:
            failures.append(f"rank {k} cache {r['cache']} != {block}")
        if not steps_ok:
            failures.append(f"rank {k} decode collectives {r['steps'][0]} "
                            f"!= {reckoned}")
    log("mesh-lm", f"{label} launch/serve.py --model-axis 2 ({cfg.name}, "
        f"{cfg.n_layers} layers) on four gloo ranks in the tensor-parallel "
        f"layout: tokens equal the single process's on every rank: "
        f"{all(r['tokens'] == want_tokens for r in ranks)}; first row "
        f"{ranks[0]['tokens'][0]}")
    if failures:
        raise AssertionError(f"{label} " + "; ".join(failures))
    return dict(step_bytes=ranks[0]["step_bytes"][0],
                reckoned_bytes=reckoned_bytes,
                prefill_bytes=ranks[0]["prefill_bytes"],
                cache_bytes={key: v[1]
                             for key, v in ranks[0]["cache"].items()},
                step_ms=[r["step_ms"] for r in ranks],
                peak_gib=[r["peak_gib"] for r in ranks],
                rs_emulated=ranks[0]["rs_emulated"],
                launches=sum(r["launches"].get("moe_gmm", 0) for r in ranks))


def serve_by_rows(arch: str, rows: int = 0) -> tuple:
    """launch/serve.py's greedy tokens for TP_SERVE at full depth (its
    seed, weights and prompts) in one process under a shape-only (2, 2)
    mesh, ``rows`` rows at a time (0: each data rank's rows in turn, as
    the ranks hold them: the card's matrix products round by the rows
    they are given).  Returns the tokens (B, GEN), each step's logits (B,
    GEN, V) float32 and each decode step's ms (host clock around the
    synchronised step, as the ranks time theirs), all on the host."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import hints
    from repro_torch.launch import mesh as HM
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    B, P, G = TP_SERVE["batch"], TP_SERVE["prompt"], TP_SERVE["gen"]
    rows = rows or B // MESH_SHAPE[0]
    make_serve_step, step_ms = serve.make_serve_step, []

    def timed_step(cfg):
        run = make_serve_step(cfg)

        def step(params, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(params, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return step

    hints.activate(HM.ShapeMesh(MESH_SHAPE, ("data", "model")))
    serve.make_serve_step = timed_step
    try:
        params = T.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0), "cuda")
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, P)), dtype=torch.int32, device="cuda")
        with torch.no_grad():
            runs = [serve.generate(cfg, params, prompts[r:r + rows], G)
                    for r in range(0, B, rows)]
    finally:
        serve.make_serve_step = make_serve_step
        hints.deactivate()
    del params
    tokens = torch.cat([t for t, _, _ in runs]).cpu()
    logits = torch.cat([torch.stack(lg, 1).float() for _, lg, _ in runs]
                       ).cpu()
    return tokens, logits, step_ms


def phase_mesh_single_ssm() -> dict:
    """16h's counterparts: mamba2-2.7b and zamba2-1.2b in one process
    under a shape-only (2, 2) mesh, the ranks' seed, prompts and batches:
    served at full depth (:func:`serve_by_rows`) and trained at
    SSM_MESH_LAYERS (launch/train.py); keeps the final SSM_MESH_LEAVES and
    the same leaves at initialisation (the trainer's seed)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as HM
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    out = {}
    for arch in SSM_MESH_LAYERS:
        torch.cuda.empty_cache()
        _build.reset_launches()
        t0 = time.perf_counter()
        tokens, _, decode_ms = serve_by_rows(arch)
        serve_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = train.main(ssm_train_argv(arch), mesh=HM.ShapeMesh(
            MESH_SHAPE, ("data", "model")))
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        out[arch] = dict(tokens=tokens, serve_s=serve_s, decode_ms=decode_ms,
                         losses=run.losses,
                         grad_norms=[m["grad_norm"] for m in run.metrics],
                         step_ms=run.step_ms, peak_gib=peak,
                         leaves=picked_leaves(run.params, SSM_MESH_LEAVES))
        del run
        torch.cuda.empty_cache()
        cut = dataclasses.replace(get_config(arch),
                                  n_layers=SSM_MESH_LAYERS[arch])
        init = T.init_params(cut, torch.Generator(device="cuda").manual_seed(
            0), "cuda")
        out[arch]["init"] = picked_leaves(init, SSM_MESH_LEAVES)
        del init
        log("mesh-lm", f"16h {arch} in one process under a shape-only (2, 2)"
            f" mesh: launch/serve.py's {TP_SERVE} at full depth, each data "
            f"rank's rows in turn, in {serve_s:.1f} s (weights made on the "
            f"card included), decode step ms (host clock, synchronised; "
            f"{TP_SERVE['batch'] // MESH_SHAPE[0]} rows a step) "
            f"{[round(x, 1) for x in decode_ms]}, "
            f"first row {tokens[0].tolist()}; trained at "
            f"{SSM_MESH_LAYERS[arch]} layers: losses "
            f"{[round(x, 4) for x in out[arch]['losses']]}, gradient norms "
            f"{[round(x, 4) for x in out[arch]['grad_norms']]}, step ms "
            f"{[round(x, 1) for x in out[arch]['step_ms']]}, peak memory "
            f"{peak:.2f} GiB; launches {counts} (none: no kernel of the "
            f"repo on this path)")
        if counts:
            raise AssertionError(f"16h {arch} single launches {counts}")
    torch.cuda.empty_cache()
    return out


def ssm_rank_jobs(d: str) -> list:
    """16h's jobs for the four ranks: each Mamba2 family served, then
    trained."""
    ext = ["--model-axis", "2", "--device", "cuda:0", "--backend", "gloo"]
    jobs = []
    for arch in SSM_MESH_LAYERS:
        jobs += [dict(kind="serve-tp", out=os.path.join(d, f"16h-{arch}"),
                      argv=tp_serve_argv(ext, arch=arch, layers=0)),
                 dict(kind="train-ssm",
                      out=os.path.join(d, f"16h-train-{arch}"),
                      argv=ssm_train_argv(arch, ext))]
    return jobs


def check_mesh_ssm(single: dict, d: str) -> dict:
    """16h: each Mamba2 family's serving (:func:`check_mesh_serve`) and
    training on the four ranks against one process: losses and gradient
    norms within MESH_LM_REL_TOL, the final SSM_MESH_LEAVES within
    MESH_LM_UPDATE_TOL (as 16b's), every rank's bytes a step equal to
    launch/dryrun.py's reckoning."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import step_collectives
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.roofline.analysis import collective_bytes
    out = {}
    for arch, layers in SSM_MESH_LAYERS.items():
        full = get_config(arch)
        served = check_mesh_serve(full, single[arch], os.path.join(
            d, f"16h-{arch}"), label=f"16h {arch}")
        cfg = dataclasses.replace(full, n_layers=layers)
        reckoned = collective_bytes(step_collectives(
            cfg, ShapeMesh(MESH_SHAPE, ("data", "model")), "train",
            TRAIN_SEQ, TRAIN_BATCH, OptConfig()))["total"]
        ranks = []
        for k in range(4):
            with open(os.path.join(d, f"16h-train-{arch}-rank{k}.json")) as f:
                ranks.append(json.load(f))
        gaps = step_gaps(ranks[0], single[arch])
        updates = weight_gaps(torch.load(os.path.join(
            d, f"16h-train-{arch}-leaves.pt")), single[arch]["leaves"],
            single[arch]["init"], SSM_MESH_LEAVES)
        for k, r in enumerate(ranks):
            log("mesh-lm", f"16h {arch} training rank {k} cell "
                f"{r['coords']}: step ms (CUDA events) "
                f"{[round(x, 1) for x in r['step_ms']]}; bytes moved per "
                f"device per step {r['coll_bytes_per_step'] / 1e9:.4f} GB "
                f"(reckoned {reckoned / 1e9:.4f}; {r['coll_counts']}; staged "
                f"through host memory: {r['staged']}); peak memory "
                f"{r['peak_gib']:.2f} GiB")
        log("mesh-lm", f"16h {arch} trained on four gloo ranks at (2, 2), "
            f"{SSM_MESH_REDUCED.format(layers, full.n_layers)}: losses "
            f"{[round(x, 4) for x in ranks[0]['losses']]} against the "
            f"single process's {[round(x, 4) for x in single[arch]['losses']]}"
            f", gradient norms {[round(x, 4) for x in ranks[0]['grad_norms']]}"
            f" against {[round(x, 4) for x in single[arch]['grad_norms']]}; "
            f"largest relative gaps {gaps} (limit {MESH_LM_REL_TOL}); final "
            f"weights per leaf (||w_mesh - w_single|| / ||w_single - "
            f"w_init||, max abs diff) {updates} (limit {MESH_LM_UPDATE_TOL} "
            f"on the first); these are gloo-through-host numbers on one "
            f"card, not NVLink ones")
        if not np.isfinite(ranks[0]["losses"]).all() or any(
                gaps[k] > MESH_LM_REL_TOL[k] for k in gaps):
            raise AssertionError(f"16h {arch} {gaps} against the single "
                                 "process")
        if not all(np.isfinite(u) and u <= MESH_LM_UPDATE_TOL
                   for u, _ in updates.values()):
            raise AssertionError(f"16h {arch} final weights {updates}")
        for k, r in enumerate(ranks):
            if abs(r["coll_bytes_per_step"] - reckoned) > 1e-9 * reckoned:
                raise AssertionError(f"16h {arch} rank {k} moved "
                                     f"{r['coll_bytes_per_step']} B a step, "
                                     f"the reckoning {reckoned}")
            if any(r["launches"].values()):
                raise AssertionError(f"16h {arch} rank {k} launches "
                                     f"{r['launches']}")
        out[arch] = dict(
            reduced=SSM_MESH_REDUCED.format(layers, full.n_layers),
            serve=served, serve_single_s=single[arch]["serve_s"],
            serve_single_step_ms=single[arch]["decode_ms"],
            train=dict(layers=layers, losses=ranks[0]["losses"], gaps=gaps,
                       updates=updates,
                       step_ms=[r["step_ms"] for r in ranks],
                       single_step_ms=single[arch]["step_ms"],
                       bytes_per_step=[r["coll_bytes_per_step"]
                                       for r in ranks],
                       reckoned_bytes=reckoned,
                       peak_gib=[r["peak_gib"] for r in ranks],
                       single_peak_gib=single[arch]["peak_gib"]))
    return out


def phase_mesh_cohort(cohort_path: str, gloo: dict) -> dict:
    """16d: the four-subject cohort from phase 9 on a (2, 2)
    ProcessGroupMesh of four gloo ranks and on a (1, 1) LocalMesh, against
    the unplaced cohort."""
    from repro_torch.core.batched import BatchedLifeEngine
    from repro_torch.core.life import LifeConfig
    from repro_torch.distributed.mesh import LocalMesh
    from repro_torch.roofline.analysis import collective_bytes
    cohort = torch.load(cohort_path, map_location="cuda", weights_only=False)
    cfg = LifeConfig(executor="opt", n_iters=COHORT_ITERS, plan_cache_dir="")
    W0, L0 = BatchedLifeEngine(cohort, cfg, device="cuda").run()
    t0 = time.perf_counter()
    local = BatchedLifeEngine(cohort, cfg, device="cuda",
                              mesh=LocalMesh(1, 1, "cuda"))
    W1, L1 = local.run()
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t0
    W0, L0, W1, L1 = (x.cpu().numpy() for x in (W0, L0, W1, L1))
    recs = list(zip(["all-reduce"] * len(gloo["coll_bytes"]),
                    gloo["coll_bytes"].tolist(), gloo["coll_groups"].tolist()))
    cb = collective_bytes(recs)
    errs = {}
    for name, (W, L) in (("gloo (2, 2)", (gloo["W"], gloo["losses"])),
                         ("local (1, 1)", (W1, L1))):
        errs[name] = (float(np.abs(W - W0).max()),
                      float(np.abs((L - L0) / L0).max()))
    log("mesh-lm", f"16d cohort of {len(cohort)} subjects, {COHORT_ITERS} "
        f"iterations (opt): against the unplaced cohort, max |W diff| and "
        f"relative loss diff {errs} (rtol {MESH_COHORT_TOL['rtol']}, atol "
        f"{MESH_COHORT_TOL['atol']}); the gloo solve {float(gloo['seconds']):.3f}"
        f" s, {cb['total'] / COHORT_ITERS / 1e6:.3f} MB moved per device per "
        f"iteration in {cb['counts']['all-reduce']} all-reduces (staged "
        f"through host memory: {bool(gloo['staged'])}; subjects, slots "
        f"sharded: {gloo['sharded'].tolist()}); the (1, 1) local "
        f"mesh's build and solve {local_s:.3f} s")
    for name, (W, L) in (("gloo", (gloo["W"], gloo["losses"])),
                         ("local", (W1, L1))):
        np.testing.assert_allclose(W, W0, err_msg=f"16d {name}",
                                   **MESH_COHORT_TOL)
        np.testing.assert_allclose(L, L0, rtol=MESH_COHORT_TOL["rtol"],
                                   err_msg=f"16d {name}")
    del cohort, local
    torch.cuda.empty_cache()
    return dict(errs=errs, gloo_s=float(gloo["seconds"]),
                bytes_per_iter=cb["total"] / COHORT_ITERS)


def phase_mesh_serve(cfg) -> dict:
    """16e: launch/serve.py --model-axis 1 at phase 7's depth, batch,
    prompts and seed: the same tokens."""
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    argv = ["--arch", LM_ARCH, "--layers", str(LM_LAYERS), "--batch",
            str(LM_BATCH), "--prompt-len", str(LM_PROMPT), "--gen",
            str(LM_GEN), "--model-axis", "1"]
    _build.reset_launches()
    tokens = serve.main(argv).cpu()
    counts = dict(_build.LAUNCHES)
    want = {"moe_gmm": 3 * LM_LAYERS * LM_GEN}
    same = torch.equal(tokens, LM_SERVED["tokens"])
    log("mesh-lm", f"16e launch/serve.py --model-axis 1 (a (1, 1) mesh: "
        f"the prefill's attention on the expanded-KV branch): launches "
        f"{counts} (expected {want}); tokens equal phase 7's: {same}")
    if counts != want:
        raise AssertionError(f"16e launch counts {counts} != {want}")
    if not same:
        rows, steps = torch.nonzero(tokens != LM_SERVED["tokens"],
                                    as_tuple=True)
        raise AssertionError(f"16e tokens differ from phase 7's at (row, "
                             f"step) {list(zip(rows.tolist(), steps.tolist()))}")
    torch.cuda.empty_cache()
    return dict(launches=counts["moe_gmm"])


def phase_mesh_lm(trained: dict, cohort_path: str) -> dict:
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_LAYERS)
    os.makedirs(MESH_LM_DIR, exist_ok=True)
    t = [time.perf_counter()]
    nccl = phase_mesh_nccl(trained, cfg)
    t.append(time.perf_counter())
    single = phase_mesh_single(cfg)
    single_af = phase_mesh_single_adafactor(cfg)
    single_tp = phase_mesh_single_serve()
    t_ssm = time.perf_counter()
    single_ssm = phase_mesh_single_ssm()
    ssm_single_s = time.perf_counter() - t_ssm
    ranks = phase_mesh_ranks(cfg, single, single_af, single_tp, single_ssm,
                             cohort_path)
    t.append(time.perf_counter())
    cohort = phase_mesh_cohort(cohort_path, ranks.pop("gloo"))
    t.append(time.perf_counter())
    served = phase_mesh_serve(cfg)
    t.append(time.perf_counter())
    secs = [b - a for a, b in zip(t, t[1:])]
    af = ranks["adafactor"]
    tp = ranks["serve_tp"]
    ssm = ranks["ssm"]
    af_s = single_af["wall_s"] + af["job_s"]
    log("mesh-lm", f"phase 16 took {t[-1] - t[0]:.1f} s: 16a {secs[0]:.1f} "
        f"s, 16b-16c with 16d's and 16f's ranks {secs[1]:.1f} s, 16d "
        f"{secs[2]:.1f} s, 16e {secs[3]:.1f} s, 16f {af_s:.1f} s (its one "
        f"process {single_af['wall_s']:.1f} s, its ranks' job "
        f"{af['job_s']:.1f} s inside the spawn), 16h's one process "
        f"{ssm_single_s:.1f} s")
    return dict(nccl=nccl, ranks=ranks, cohort=cohort, served=served,
                adafactor=af, serve_tp=tp, ssm=ssm,
                launches=(nccl["launches"] + single["launches"]
                          + single_af["launches"] + ranks["launches"]
                          + af["launches"] + served["launches"]
                          + single_tp["launches"] + tp["launches"]),
                seconds=secs + [af_s])


# ----------------------------------------------------------------------------
# 17. the audio and vlm families
# ----------------------------------------------------------------------------

#: 17a: batch x prefill frames (past BLOCK_THRESHOLD: flash runs) and the
#: teacher-forced decode steps after them
MODAL_AUDIO = dict(B=4, P=2048, steps=16)
#: 17b: batch, the image's grid side (grid^2 patches at t = 0), the text
#: tokens after it and the greedy decode steps
MODAL_VLM = dict(B=2, grid=32, text=1024, steps=16)
MODAL_TRAIN_STEPS = 3
#: training batches: (global batch, sequence); the vlm's image takes
#: min(vision_tokens, seq // 2) = 1,024 positions of its 2,048
MODAL_TRAIN = {"musicgen-large": (4, 1024), "qwen2-vl-7b": (2, 2048)}
#: GiB the vlm's depth cut leaves free beyond 12 B a parameter of state
#: (the float32 logits and their gradient at 2 x 2,048 x 152,064, the
#: optimizer's float32 temporaries of a 545 M-parameter embedding)
MODAL_RESERVE_GIB = 24
#: the float32 check: layers, prefill positions, decode steps, batch;
#: forward_train over MODAL_CHECK_P + 512 positions (flash, chunk 512)
MODAL_CHECK = dict(layers=4, P=1536, steps=8, B=2)
MROPE_TOL = 1e-5


def vlm_positions(B: int, grid: int, n_text: int) -> torch.Tensor:
    """Qwen2-VL's (3, B, grid^2 + n_text) positions on the card: the image
    patches at t = 0, h their row and w their column of the grid; the
    text after them from grid on, the same on all three axes."""
    vt = grid * grid
    pos = torch.empty((3, B, vt + n_text), dtype=torch.int32, device="cuda")
    i = torch.arange(vt, dtype=torch.int32, device="cuda")
    pos[0, :, :vt] = 0
    pos[1, :, :vt] = i // grid
    pos[2, :, :vt] = i % grid
    pos[:, :, vt:] = grid + torch.arange(n_text, dtype=torch.int32,
                                         device="cuda")
    return pos


def modal_inputs(cfg, B: int, n: int, seed: int, grid: int = 0) -> dict:
    """A whole sequence of ``n`` positions for ``cfg`` drawn on the card:
    audio ``frame_embeds`` (B, n, d); vlm ``grid^2`` ``image_embeds`` and
    ``n - grid^2`` ``tokens`` on :func:`vlm_positions`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.family == "audio":
        return {"frame_embeds": torch.randn(
            (B, n, cfg.d_model), generator=g, device="cuda").to(
                cfg.torch_dtype)}
    vt = grid * grid
    return {"image_embeds": torch.randn(
                (B, vt, cfg.d_model), generator=g, device="cuda").to(
                    cfg.torch_dtype),
            "tokens": torch.randint(0, cfg.vocab_size, (B, n - vt),
                                    generator=g, device="cuda",
                                    dtype=torch.int32),
            "positions": vlm_positions(B, grid, n - vt)}


def modal_prefix(cfg, seq: dict, P: int) -> dict:
    """The first ``P`` positions of a :func:`modal_inputs` sequence."""
    if cfg.family == "audio":
        return {"frame_embeds": seq["frame_embeds"][:, :P]}
    vt = seq["image_embeds"].shape[1]
    return {"image_embeds": seq["image_embeds"],
            "tokens": seq["tokens"][:, :P - vt],
            "positions": seq["positions"][:, :, :P]}


def modal_step(cfg, seq: dict, pos: int, logits=None) -> dict:
    """The decode step's inputs at position ``pos``: the sequence's own
    frame or token there (teacher-forced), or, given the last logits
    (B, V), the vlm's greedy token; a vlm step carries its positions."""
    if cfg.family == "audio":
        return {"frame_embeds": seq["frame_embeds"][:, pos:pos + 1]}
    vt = seq["image_embeds"].shape[1]
    tok = (seq["tokens"][:, pos - vt:pos - vt + 1] if logits is None else
           torch.argmax(logits, dim=-1).to(torch.int32)[:, None])
    B = tok.shape[0]
    text0 = int(seq["positions"][0, 0, vt]) - vt
    return {"tokens": tok, "positions": torch.full(
        (3, B, 1), text0 + pos, dtype=torch.int32, device="cuda")}


def modal_decode(cfg, params, seq: dict, P: int, n_steps: int,
                 greedy: bool) -> dict:
    """A prefill of ``P`` positions through launch.steps.make_prefill, then
    ``n_steps`` make_serve_step calls (teacher-forced, or greedy for the
    vlm): the last logits of each, seconds by the host clock (each ending
    in a synchronisation) and the flash calls of the prefill."""
    from repro_torch.launch.serve import pad_cache
    from repro_torch.launch.steps import make_prefill, make_serve_step
    from repro_torch.models import layers as L
    prefill, serve = make_prefill(cfg), make_serve_step(cfg)
    calls = []
    flash = L.flash_attention
    L.flash_attention = lambda *a: (calls.append(a[-1]), flash(*a))[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        logits, cache = prefill(params, modal_prefix(cfg, seq, P))
    finally:
        L.flash_attention = flash
    cache = pad_cache(cache, P + n_steps)
    torch.cuda.synchronize()
    seconds = {"prefill": time.perf_counter() - t0}
    steps = [logits[:, -1]]
    t0 = time.perf_counter()
    for i in range(n_steps):
        inputs = modal_step(cfg, seq, P + i, steps[-1] if greedy else None)
        logits, cache = serve(params, dict(inputs, cache=cache,
                                           cache_index=P + i))
        cache.pop("index")
        steps.append(logits[:, -1])
    torch.cuda.synchronize()
    seconds["decode"] = time.perf_counter() - t0
    return dict(steps=steps, seconds=seconds, flash_calls=len(calls),
                cache_bytes=sum(v.numel() * v.element_size()
                                for v in cache.values()))


def modal_check(label: str, cfg) -> dict:
    """A float32 model of ``cfg`` at full width and MODAL_CHECK's layers
    (seeded random weights): a prefill of MODAL_CHECK["P"] positions and
    MODAL_CHECK["steps"] teacher-forced decode steps, each step's logits
    within LONG_TOL of forward_train's at its position over P + 512."""
    from repro_torch.models import transformer as T
    c = dataclasses.replace(cfg, n_layers=MODAL_CHECK["layers"],
                            dtype="float32")
    params = T.init_params(c, torch.Generator(device="cuda").manual_seed(71),
                           "cuda")
    B, P, n = MODAL_CHECK["B"], MODAL_CHECK["P"], MODAL_CHECK["steps"]
    seq = modal_inputs(c, B, P + 512, 72, grid=MODAL_VLM["grid"])
    run = modal_decode(c, params, seq, P, n, greedy=False)
    with torch.no_grad():
        full, _ = T.forward_train(c, params, seq)
    errs, ratios = [], []
    for i, got in enumerate(run["steps"]):
        ok, err, ratio = within(got, full[:, P - 1 + i], LONG_TOL)
        errs.append(err)
        ratios.append(ratio)
        if not ok:
            raise AssertionError(f"{label} float32: position {P - 1 + i}'s "
                                 f"logits differ from forward_train's by "
                                 f"{err:.3e} (beyond {LONG_TOL})")
    log("modal", f"{label} float32 at {c.n_layers} layers, full width: "
        f"prefill of {B} x {P} positions ({run['flash_calls']} flash calls)"
        f" and {n} teacher-forced decode steps against forward_train over "
        f"{P + 512}: max abs err per position {[f'{e:.2e}' for e in errs]}"
        f", worst share of the limit 2e-2 + 2e-2 |x| {max(ratios):.3f}")
    del params, full, run
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs), worst_share=max(ratios))


def mrope_check(cfg) -> dict:
    """apply_mrope on the card at qwen2-vl's q and k shapes (float32, grid
    positions) against the same rotation on the host in float64: the
    float32 angles (the card's frequencies times the positions, one
    rounding, as on the card), their cosines and sines and the rotation in
    float64; the section of each frequency slot from the config's
    sections written out here."""
    from repro_torch.models import layers as L
    hd, theta, sections = (cfg.resolved_head_dim, cfg.rope_theta,
                           cfg.mrope_sections)
    B, grid, n_text = 2, MODAL_VLM["grid"], 64
    pos = vlm_positions(B, grid, n_text)
    sec = np.concatenate([np.full(s, i) for i, s in enumerate(sections)])
    sec = np.pad(sec, (0, max(0, hd // 2 - len(sec))))[:hd // 2]
    freqs = L.rope_freqs(hd, theta, device="cuda").cpu().numpy()
    pos_np = pos.cpu().numpy().astype(np.float32)
    angles = (pos_np.transpose(1, 2, 0)[..., sec] * freqs).astype(np.float64)
    cos, sin = np.cos(angles)[:, :, None, :], np.sin(angles)[:, :, None, :]
    g = torch.Generator(device="cuda").manual_seed(73)
    errs = {}
    for name, H in (("q", cfg.n_heads), ("k", cfg.n_kv_heads)):
        x = torch.randn((B, pos.shape[2], H, hd), generator=g, device="cuda")
        got = L.apply_mrope(x, pos, theta, sections).cpu().double().numpy()
        x1, x2 = np.split(x.cpu().double().numpy(), 2, axis=-1)
        want = np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
        errs[name] = float(np.abs(got - want).max())
    log("modal", f"17b M-RoPE (sections {sections}, theta {theta:g}, hd "
        f"{hd}) on {B} x ({grid}x{grid} patches + {n_text} tokens): max abs "
        f"err against float64 on the host q {errs['q']:.3e}, k "
        f"{errs['k']:.3e} (limit {MROPE_TOL:g}); slots per axis "
        f"{np.bincount(sec, minlength=3).tolist()}")
    if max(errs.values()) > MROPE_TOL:
        raise AssertionError(f"17b M-RoPE off by {errs}")
    return errs


def modal_train(label: str, cfg, extra=()) -> dict:
    """MODAL_TRAIN_STEPS steps through the trainer's main (bf16, remat,
    --lr TRAIN_LR as 14b and 15e: at the CLI's 3e-3 musicgen's loss rose,
    8.139 -> 8.154 -> 8.671): losses finite and falling, step ms,
    tokens/s, peak memory."""
    from repro_torch.launch import train
    batch, seq = MODAL_TRAIN[cfg.name]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.main(["--arch", cfg.name, "--steps", str(MODAL_TRAIN_STEPS),
                      "--global-batch", str(batch), "--seq-len", str(seq),
                      "--lr", str(TRAIN_LR), "--log-every", "1", *extra])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = run.losses
    med = float(np.median(run.step_ms[1:]))
    n_param, layers = run.cfg.param_count(), run.cfg.n_layers
    log("modal", f"{label} training, {layers} layers, "
        f"{n_param / 1e9:.3f} B parameters (state reckoned "
        f"{n_param * 12 / 1e9:.1f} GB at 12 B a parameter), "
        f"{MODAL_TRAIN_STEPS} steps of {batch} x {seq} in {wall:.1f} s (init "
        f"included): losses {[round(x, 4) for x in losses]}; step ms (CUDA "
        f"events) {[round(x, 3) for x in run.step_ms]}; median of steps 2-"
        f"{MODAL_TRAIN_STEPS} {med:.3f} ms, {batch * seq / med * 1e3:.1f} "
        f"tokens/s; peak memory {peak / 2**30:.2f} GiB")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: losses {losses}")
    del run
    torch.cuda.empty_cache()
    return dict(layers=layers, step_ms=med,
                tokens_per_s=batch * seq / med * 1e3, peak_gib=peak / 2**30,
                losses=losses, state_gb=n_param * 12 / 1e9)


def modal_serve(label: str, cfg, params, seq: dict, P: int, n_steps: int,
                greedy: bool) -> dict:
    """17a/17b's serving run at full size: prefill and decode times, peak
    memory, finite logits, flash on every layer of the prefill."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = modal_decode(cfg, params, seq, P, n_steps, greedy)
    peak = torch.cuda.max_memory_allocated()
    B = run["steps"][0].shape[0]
    if not all(bool(torch.isfinite(x).all()) for x in run["steps"]):
        raise AssertionError(f"{label}: non-finite logits")
    if run["flash_calls"] != cfg.n_layers:
        raise AssertionError(f"{label}: {run['flash_calls']} flash calls in "
                             f"the prefill, expected {cfg.n_layers}")
    sec = run["seconds"]
    row = dict(prefill_s=sec["prefill"], prefill_tokens_per_s=B * P /
               sec["prefill"], decode_ms=sec["decode"] / n_steps * 1e3,
               tokens_per_s=B * n_steps / sec["decode"],
               peak_gib=peak / 2**30, cache_bytes=run["cache_bytes"])
    log("modal", f"{label} prefill of {B} x {P} positions: "
        f"{row['prefill_s']:.3f} s ({row['prefill_tokens_per_s']:.0f} "
        f"positions/s; flash on all {run['flash_calls']} layers), "
        f"{n_steps} {'greedy' if greedy else 'teacher-forced'} decode steps:"
        f" {row['decode_ms']:.3f} ms a step ({row['tokens_per_s']:.1f} "
        f"tokens/s over the batch); cache {run['cache_bytes'] / 1e9:.2f} GB;"
        f" peak memory {row['peak_gib']:.2f} GiB (host clock, each ending "
        f"in a synchronisation)")
    return row


def phase_modal_audio() -> dict:
    """17a: musicgen-large at full size."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("musicgen-large")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    log("modal", f"17a musicgen-large: {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_codebooks} codebooks x {cfg.vocab_size}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters ({cfg.dtype})")
    a = MODAL_AUDIO
    seq = modal_inputs(cfg, a["B"], a["P"] + a["steps"], 74)
    row = modal_serve("17a musicgen-large", cfg, params, seq, a["P"],
                      a["steps"], greedy=False)
    del params, seq
    torch.cuda.empty_cache()
    row["train"] = modal_train("17a musicgen-large", cfg)
    row["check"] = modal_check("17a musicgen-large", cfg)
    return row


def phase_modal_vlm() -> dict:
    """17b: qwen2-vl-7b at full size, its training cut to the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("qwen2-vl-7b")
    row = {"mrope_err": mrope_check(cfg)}
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    log("modal", f"17b qwen2-vl-7b: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters ({cfg.dtype}), "
        f"M-RoPE sections {cfg.mrope_sections}")
    v = MODAL_VLM
    P = v["grid"] ** 2 + v["text"]
    seq = modal_inputs(cfg, v["B"], P, 75, grid=v["grid"])
    row.update(modal_serve("17b qwen2-vl-7b", cfg, params, seq, P,
                           v["steps"], greedy=True))
    del params, seq
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    base = dataclasses.replace(cfg, n_layers=0).param_count()
    per = dataclasses.replace(cfg, n_layers=1).param_count() - base
    layers = min(cfg.n_layers, int(
        ((free - MODAL_RESERVE_GIB * 2**30) / 12 - base) // per))
    log("modal", f"17b training cut to {layers} of {cfg.n_layers} layers: "
        f"{free / 2**30:.1f} GiB free, {MODAL_RESERVE_GIB} GiB held back, "
        f"12 B a parameter ({base / 1e9:.3f} B outside the layers, "
        f"{per / 1e6:.1f} M a layer; all 28 would be "
        f"{cfg.param_count() * 12 / 1e9:.1f} GB)")
    row["train"] = modal_train("17b qwen2-vl-7b", cfg,
                               ["--layers", str(layers)])
    row["check"] = modal_check("17b qwen2-vl-7b", cfg)
    return row


def phase_modal() -> dict:
    t = [time.perf_counter()]
    out = {"audio": phase_modal_audio()}
    t.append(time.perf_counter())
    out["vlm"] = phase_modal_vlm()
    t.append(time.perf_counter())
    out["seconds"] = dict(a=t[1] - t[0], b=t[2] - t[1])
    log("modal", f"phase 17 took {t[-1] - t[0]:.1f} s: 17a "
        f"{out['seconds']['a']:.1f} s, 17b {out['seconds']['b']:.1f} s")
    return out


# ----------------------------------------------------------------------------
# 18. the example programs (repro_torch/examples)
# ----------------------------------------------------------------------------

EXAMPLES_DIR = os.path.join(ROOT, "build", "examples")
#: the serving examples' subjects (their own default)
EXAMPLE_SUBJECTS = "4"
#: seconds the quickstart's command-line run may take, start-up included
EXAMPLE_CLI_TIMEOUT_S = 300


def example_cli() -> float:
    """18a: ``python -m repro_torch.examples.quickstart`` in a fresh
    interpreter, as a user starts it; returns its seconds."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart"], cwd=ROOT,
        env=env, capture_output=True, text=True,
        timeout=EXAMPLE_CLI_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0:
        raise RuntimeError(f"18a quickstart exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    if not lines or not lines[0].startswith("device: cuda"):
        raise AssertionError(f"18a quickstart's first line {lines[:1]} does "
                             "not name the card")
    log("examples", f"18a python -m repro_torch.examples.quickstart: exit 0 "
        f"in {seconds:.1f} s (a fresh interpreter); first line "
        f"{lines[0]!r}; {lines[-3].strip()!r}")
    return seconds


def quickstart_row(label: str, out: dict, seconds: float) -> dict:
    ls = out["losses"].cpu().numpy()
    row = dict(seconds=seconds, iterations=len(ls), loss_first=float(ls[0]),
               loss_last=float(ls[-1]),
               inspector_seconds=float(out["inspector_seconds"]),
               kept=int(out["stats"]["kept"]),
               total=int(out["stats"]["total"]),
               precision=float(out["stats"]["precision"]),
               recall=float(out["stats"]["recall"]), plans=out["plans"])
    if not np.isfinite(ls).all():
        raise AssertionError(f"{label}: a loss is not finite")
    log("examples", f"{label}: {seconds:.1f} s; loss {ls[0]:.3f} -> "
        f"{ls[-1]:.5f} in {len(ls)} iterations, inspector "
        f"{out['inspector_seconds']:.2f} s, kept {row['kept']}/"
        f"{row['total']}, plans {out['plans']}")
    return row


def check_serve_life(out: dict, launches: dict) -> dict:
    """18e's gates beyond the example's own: B3 and B4 launched, the SELL
    tenant within the trajectory tolerance of the same job on opt/coo."""
    from repro_torch.core.life import LifeConfig, LifeEngine
    from repro_torch.examples import serve_life
    sell = {k: launches.get(k, 0) for k in PATH_KERNELS["sell"]}
    n = len(out["cohort"])
    # the reference run and the killed + resumed one each take every SELL
    # iteration once: 2 DSC + 1.5 WC launches an iteration
    iters = 2 * serve_life.N_ITERS
    log("examples", f"18e serve_life B3/B4 launches {sell} (2 DSC + 1.5 WC "
        f"per iteration of the SELL tenant's {iters}: {2 * iters} / "
        f"{3 * iters // 2}); all launches {launches}")
    for k, v in sell.items():
        if v <= 0:
            raise AssertionError(f"18e serve_life launched {k} {v} times")
    jid = f"tenant-{n - 1}"
    w_sell = out["resumed"][jid][0]
    w_opt, _ = LifeEngine(out["cohort"][-1], LifeConfig(
        executor="opt", format="coo", n_iters=serve_life.N_ITERS,
        plan_cache_dir=""), device="cuda").run()
    err = float((w_sell - w_opt).abs().max())
    log("examples", f"18e {jid} (format=sell, kernel-sell) vs the same job "
        f"on opt/coo: max abs diff {err:.3e} (rtol {TRAJ_TOL['rtol']}, atol "
        f"{TRAJ_TOL['atol']})")
    np.testing.assert_allclose(w_sell.cpu().numpy(), w_opt.cpu().numpy(),
                               **TRAJ_TOL)
    return dict(launches=sell, sell_vs_opt=err,
                max_dw=out["max_dw"], progress_at_kill=out["progress"])


def phase_examples(stn96) -> dict:
    """18: each example's main on the card with the reference's default
    arguments, the quickstart once more on phase 4's problem and once
    from the command line."""
    import shutil
    from repro_torch.examples import (distributed_life, prune_connectome,
                                      quickstart, serve_async, serve_life,
                                      serve_lm, serve_subjects, train_lm)
    from repro_torch.kernels import _build
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    os.makedirs(EXAMPLES_DIR)
    # the examples' default plan cache
    os.environ["REPRO_PLAN_CACHE"] = os.path.join(EXAMPLES_DIR, "plans")
    torch.cuda.empty_cache()
    cuda = ["--device", "cuda"]
    out: dict = {}
    t_phase = time.perf_counter()

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        r = fn(*args, **kw)
        return r, time.perf_counter() - t0

    out["quickstart_cli"] = dict(seconds=example_cli())
    r, s = timed(quickstart.main, cuda)
    out["quickstart"] = quickstart_row("18b quickstart", r, s)
    r, s = timed(quickstart.run, problem=stn96, device="cuda")
    out["quickstart_stn96"] = quickstart_row(
        f"18c quickstart on phase 4's problem {MAIN_PROBLEM}", r, s)

    r, s = timed(serve_subjects.main, cuda + [EXAMPLE_SUBJECTS])
    out["serve_subjects"] = dict(seconds=s, subjects_per_s=r[
        "subjects_per_s"], final_losses=r["losses"][:, -1].tolist())
    log("examples", f"18d serve_subjects: {s:.1f} s; subjects/s "
        f"{r['subjects_per_s']}")

    _build.reset_launches()
    r, s = timed(serve_life.main, cuda + [EXAMPLE_SUBJECTS])
    launches = dict(_build.LAUNCHES)
    log("examples", f"18e serve_life: {s:.1f} s")
    out["serve_life"] = dict(seconds=s, **check_serve_life(r, launches))

    r, s = timed(serve_async.main, cuda + [EXAMPLE_SUBJECTS])
    n = int(EXAMPLE_SUBJECTS)
    want = {**{f"tenant-{i}": "done" for i in range(n)},
            "poisoned": "failed", "lo": "shed", "hi": "done"}
    counters = dict(admitted=n + 1.0, completed=float(n), failed=1.0)
    log("examples", f"18f serve_async: {s:.1f} s; statuses {r['statuses']}, "
        f"counters {r['counters']}")
    if r["statuses"] != want or r["counters"] != counters:
        raise AssertionError(f"18f serve_async: statuses {r['statuses']} / "
                             f"counters {r['counters']}, want {want} / "
                             f"{counters}")
    out["serve_async"] = dict(seconds=s, statuses=r["statuses"],
                              counters=r["counters"])

    r, s = timed(prune_connectome.main, cuda)
    out["prune_connectome"] = dict(
        seconds=s, iters_cold=int(r["solve"].iters),
        iters_warm=int(r["report"].iters_warm),
        evidence=float(r["report"].evidence),
        cv_rmse=float(r["cv"].mean_rmse))
    log("examples", f"18g prune_connectome: {s:.1f} s; cold "
        f"{r['solve'].iters} iterations, warm {r['report'].iters_warm}, "
        f"evidence {r['report'].evidence:+.6f}, crossval rmse "
        f"{r['cv'].mean_rmse:.5f}")

    torch.cuda.empty_cache()
    r, s = timed(distributed_life.main, cuda)
    out["distributed_life"] = dict(seconds=s, err=r["err"], cells=r["cells"],
                                   loss_last=float(r["losses"][-1]))
    log("examples", f"18h distributed_life: {s:.1f} s; {r['cells']}; max "
        f"|dw| {r['err']:.3e} against LifeEngine(opt) (gate 1e-2)")

    r, s = timed(serve_lm.main, cuda)
    out["serve_lm"] = dict(seconds=s, tok_s=r["tok_s"],
                           prefill_ms=r["seconds"]["prefill"] * 1e3,
                           decode_ms=r["seconds"]["decode"] * 1e3)
    log("examples", f"18i serve_lm: {s:.1f} s; prefill "
        f"{out['serve_lm']['prefill_ms']:.1f} ms, decode {r['tok_s']:.0f} "
        f"tok/s")
    del r
    torch.cuda.empty_cache()

    ckpt = os.path.join(EXAMPLES_DIR, "train_lm_ckpt")
    r, s = timed(train_lm.main, cuda + ["--ckpt-dir", ckpt])
    ls = r["losses"]
    out["train_lm"] = dict(seconds=s, steps=len(ls), loss_first=ls[0],
                           loss_last=ls[-1], tok_s=r["tok_s"],
                           params=r["cfg"].param_count())
    log("examples", f"18j train_lm: {s:.1f} s; {len(ls)} steps, loss "
        f"{ls[0]:.4f} -> {ls[-1]:.4f}, {r['tok_s']:.0f} tok/s at the last "
        f"logged step")
    del r
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log("examples", f"phase 18 took {out['seconds']:.1f} s: "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in out.items()
                    if isinstance(v, dict)))
    return out


# ----------------------------------------------------------------------------
# 19. the traced cost model against the card
# ----------------------------------------------------------------------------

#: phase 19's limit: the measured peak growth of a step against the trace's
#: peak_temp_bytes, relative
TRACE_MEM_TOL = 0.10


def phase_trace() -> dict:
    """19: 14b's and 14c's train steps traced on tensors without data
    (``launch.dryrun.trace_step``, ``roofline/trace_cost.py``): the trace's
    peak_temp_bytes against the growth of allocated memory that one more
    step of the same run showed on the card (``measure_step_memory``),
    within TRACE_MEM_TOL; the traced FLOPs and bytes over that step's
    CUDA-event time and the trace's own seconds, printed."""
    from repro_torch.launch import dryrun as D
    t0 = time.perf_counter()
    out, bad = {}, []
    for label, m in sorted(STEP_MEMORY.items()):
        cost = D.trace_step(m["cfg"], "train", m["seq"], m["batch"], None,
                            m["opt"])
        peak = cost.peak_temp_bytes
        rel = abs(m["growth"] - peak) / peak
        s = m["ms"] / 1e3
        top = sorted(cost.by_op.items(), key=lambda kv: -kv[1]["bytes"])[:6]
        out[label] = dict(
            arch=m["cfg"].name, layers=m["cfg"].n_layers, seq=m["seq"],
            batch=m["batch"], growth_bytes=m["growth"], traced_peak=peak,
            rel=rel, step_ms=m["ms"], traced_flops=cost.flops,
            traced_bytes=cost.bytes_accessed, tflops=cost.flops / s / 1e12,
            tb_per_s=cost.bytes_accessed / s / 1e12,
            trace_seconds=cost.seconds, loops=cost.loops)
        log("trace", f"19 {label} {m['cfg'].name} ({m['cfg'].n_layers} "
            f"layers, {m['batch']} x {m['seq']}): measured growth "
            f"{m['growth']} B, traced peak {peak:.0f} B, relative "
            f"{rel:.4f} (limit {TRACE_MEM_TOL}); traced {cost.flops:.4e} "
            f"FLOPs and {cost.bytes_accessed:.4e} B in {m['ms']:.3f} ms: "
            f"{cost.flops / s / 1e12:.1f} TFLOP/s, "
            f"{cost.bytes_accessed / s / 1e12:.3f} TB/s; trace "
            f"{cost.seconds:.2f} s, loops {cost.loops}; most bytes: "
            + ", ".join(f"{k} {v['bytes']:.3e}" for k, v in top))
        if rel > TRACE_MEM_TOL:
            bad.append(f"{label}: measured {m['growth']} B against the "
                       f"trace's {peak:.0f} B ({rel:.3f} relative)")
    if len(out) != 2:
        bad.append(f"phase 19 measured {sorted(out)}, not 14b and 14c")
    out["seconds"] = time.perf_counter() - t0
    log("trace", f"phase 19 took {out['seconds']:.1f} s")
    if bad:
        raise AssertionError("19: " + "; ".join(bad))
    return out


# ----------------------------------------------------------------------------
# 20. the dry run's traced SBBNNLS step against the card
# ----------------------------------------------------------------------------

def phase_life_trace() -> dict:
    """20: phase 13d's 2-D and 1-D SBBNNLS iterations traced on meta copies
    of their operands (``launch.dryrun.trace_life`` at (1, 1), the dry
    run's life-stn96 function): the trace's peak_temp_bytes against the
    growth of allocated memory the iteration showed on the card
    (``measure_life_steps``), within TRACE_MEM_TOL; the traced FLOPs and
    bytes over its CUDA-event time, printed."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import ShapeMesh
    t0 = time.perf_counter()
    one = ShapeMesh((1, 1), ("data", "model"))
    out, bad = {}, []
    for label, m in sorted(LIFE_STEP_MEMORY.items()):
        cost = D.trace_life(one, m["variant"], m["operands"], m["it"])
        peak = cost.peak_temp_bytes
        rel = abs(m["growth"] - peak) / peak
        s = m["ms"] / 1e3
        top = sorted(cost.by_op.items(), key=lambda kv: -kv[1]["bytes"])[:5]
        out[label] = dict(
            it=m["it"], growth_bytes=m["growth"], traced_peak=peak, rel=rel,
            step_ms=m["ms"], traced_flops=cost.flops,
            traced_bytes=cost.bytes_accessed,
            gflops=cost.flops / s / 1e9,
            tb_per_s=cost.bytes_accessed / s / 1e12,
            trace_seconds=cost.seconds)
        log("life-trace", f"20 {label} (iteration {m['it']}): measured "
            f"growth {m['growth']} B, traced peak {peak:.0f} B, relative "
            f"{rel:.4f} (limit {TRACE_MEM_TOL}); traced {cost.flops:.4e} "
            f"FLOPs and {cost.bytes_accessed:.4e} B in {m['ms']:.3f} ms: "
            f"{cost.flops / s / 1e9:.3f} GFLOP/s, "
            f"{cost.bytes_accessed / s / 1e12:.3f} TB/s; trace "
            f"{cost.seconds:.3f} s; most bytes: "
            + ", ".join(f"{k} {v['bytes']:.3e}" for k, v in top))
        if rel > TRACE_MEM_TOL:
            bad.append(f"{label}: measured {m['growth']} B against the "
                       f"trace's {peak:.0f} B ({rel:.3f} relative)")
    want = {f"{v} {p}" for v in ("2d", "1d") for p in ("odd", "even")}
    if set(out) != want:
        bad.append(f"phase 20 measured {sorted(out)}, not {sorted(want)}")
    out["seconds"] = time.perf_counter() - t0
    log("life-trace", f"phase 20 took {out['seconds']:.1f} s")
    if bad:
        raise AssertionError("20: " + "; ".join(bad))
    return out


# ----------------------------------------------------------------------------
# 21. the published configurations no earlier phase runs on the card
# ----------------------------------------------------------------------------

#: kimi-k2-1t-a32b (served at the depth the card holds: its dense first
#: layer and one MoE layer), then the dense configurations at full depth,
#: each with the seed of its CONFIG_CHECK-token prefill + decode check
CONFIG_MOE = "kimi-k2-1t-a32b"
CONFIG_DENSE = (("granite-34b", 81), ("stablelm-12b", 83),
                ("deepseek-7b", 85))
#: the prefill + decode check: a prompt past layers.BLOCK_THRESHOLD, so the
#: prefill runs flash; held within LONG_TOL on a float32 copy of the first
#: CONFIG_FP32_LAYERS layers, measured in bf16 at full depth (a bf16 decode
#: step rounds where the forward does not, and the two drift with depth)
CONFIG_CHECK, CONFIG_FP32_LAYERS = 2048, 4
#: device memory kept free beside a model's reckoned footprint
CONFIG_RESERVE_BYTES = 4 * 2**30
#: granite-34b trained at the trainer's defaults but the learning rate,
#: cut to the deepest stack whose weights, optimizer state, batch and
#: traced peak stay within CONFIG_TRAIN_BUDGET.  Over the 3 steps (a
#: warmup of 2) its loss rose at every rate from the CLI's 3e-3 down to
#: 3e-5 and fell at 1e-5 and 3e-6 (tools/granite_lr_sweep.py)
CONFIG_TRAIN_ARCH, CONFIG_TRAIN_BUDGET, CONFIG_TRAIN_STEPS = (
    "granite-34b", 70e9, 3)
CONFIG_TRAIN_LR = 1e-5
#: flash at the configurations' attention geometries (S 4,096)
CONFIG_FLASH = {
    "kimi-k2-1t-a32b": dict(B=1, S=4096, H=64, KV=8, hd=112, chunk=512),
    "stablelm-12b": dict(B=1, S=4096, H=32, KV=8, hd=160, chunk=512),
    "granite-34b": dict(B=1, S=4096, H=48, KV=1, hd=128, chunk=512),
}


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(t) for t in tree)
    return 0


def config_footprint(cfg, kind: str, seq: int, batch: int, opt=None) -> dict:
    """One ``kind`` step of ``batch`` x ``seq`` on one device as the dry run
    reckons it (``launch.dryrun.trace_step`` on tensors without data): the
    trace's peak temp bytes, the arguments' bytes (the weights, the batch,
    and for train the optimizer state) and the largest parameter's float32
    draw, which ``init_params`` holds beside the weights drawn before it."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as ST
    opt = opt or D.opt_for(cfg)
    cost = D.trace_step(cfg, kind, seq, batch, None, opt)
    model, state = ST.abstract_state(cfg, opt)
    params = list(model.parameters())
    weights = tensor_bytes(params)
    args = weights + tensor_bytes(D.step_batch(cfg, None, kind, seq, batch))
    if kind == "train":
        args += tensor_bytes(state)
    draw = 4 * max(p.numel() for p in params)
    return dict(layers=cfg.n_layers, weights=weights, args=args,
                temp=cost.peak_temp_bytes, total=args + cost.peak_temp_bytes,
                draw=draw, need=max(args + cost.peak_temp_bytes,
                                    weights + draw),
                trace_seconds=cost.seconds)


def card_room() -> int:
    """Bytes the card can still allocate, less CONFIG_RESERVE_BYTES."""
    return (torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved()
            - torch.cuda.memory_allocated() - CONFIG_RESERVE_BYTES)


def config_depth(arch: str) -> tuple:
    """``arch``'s configuration at the deepest stack whose serving step
    (LM_BATCH x LM_PROMPT prefill) and weight draws fit the card by the
    dry run's reckoning (:func:`config_footprint`), and that footprint;
    an MoE model keeps at least one MoE layer after its dense ones."""
    from repro_torch.configs.base import get_config
    full = get_config(arch)
    room = card_room()
    es = full.torch_dtype.itemsize
    least = full.first_k_dense + 1
    n = full.n_layers
    # weights alone (the analytic count) first: no trace of a stack that
    # cannot fit
    while n > least and dataclasses.replace(
            full, n_layers=n).param_count() * es > room:
        n -= 1
    refused = None
    while True:
        cfg = dataclasses.replace(full, n_layers=n)
        fp = config_footprint(cfg, "prefill", LM_PROMPT, LM_BATCH)
        if fp["need"] <= room or n == least:
            break
        refused, n = fp, n - 1
    gb = 1e9
    log("configs", f"{arch}: trace of a {LM_BATCH} x {LM_PROMPT} prefill on "
        f"one device at {n} of {full.n_layers} layers: temp "
        f"{fp['temp'] / gb:.3f} GB + arguments {fp['args'] / gb:.3f} GB = "
        f"{fp['total'] / gb:.3f} GB; the largest weight's float32 draw "
        f"{fp['draw'] / gb:.3f} GB beside the weights; the card holds "
        f"{room / gb:.3f} GB ({CONFIG_RESERVE_BYTES / 2**30:.0f} GiB kept "
        f"free); trace {fp['trace_seconds']:.2f} s"
        + ("" if refused is None else
           f"; cut: {refused['layers']} layers would need "
           f"{refused['need'] / gb:.3f} GB (weights "
           f"{refused['weights'] / gb:.3f} GB + the float32 draw "
           f"{refused['draw'] / gb:.3f} GB)"))
    if fp["need"] > room:
        raise AssertionError(f"21 {arch}: {n} layers need "
                             f"{fp['need'] / gb:.3f} GB of {room / gb:.3f}")
    return cfg, fp


def peak_beside_trace(arch: str, fp: dict, peak: int) -> dict:
    """The measured peak of allocated memory beside the trace's weights +
    arguments + temp."""
    rel = (peak - fp["total"]) / fp["total"]
    log("configs", f"{arch}: measured peak {peak} B ({peak / 1e9:.3f} GB) "
        f"beside the trace's {fp['total']:.0f} B ({fp['total'] / 1e9:.3f} "
        f"GB): {rel:+.4f} relative")
    return dict(traced_bytes=fp["total"], traced_temp_bytes=fp["temp"],
                measured_peak_bytes=peak, peak_rel=rel)


def check_normal_init_bits() -> None:
    """``normal_init`` on the card gives the bits of the float32-scaled
    formula it replaced, ``(randn * scale).to(dtype)``."""
    from repro_torch.models import layers as L
    shape, scale = (384, 256, 512), (2.0 / (256 + 512)) ** 0.5
    for dtype in (torch.float32, torch.bfloat16):
        got = L.normal_init(torch.Generator(device="cuda").manual_seed(5),
                            shape, scale, dtype, "cuda")
        want = (torch.randn(shape, generator=torch.Generator(
            device="cuda").manual_seed(5), device="cuda") * scale).to(dtype)
        if not torch.equal(got, want):
            raise AssertionError(f"21 normal_init {dtype}: not the bits of "
                                 f"the scaled copy")
    log("configs", f"normal_init on the card equals (randn * scale).to(dtype)"
        f" bit for bit at {shape} in float32 and bfloat16")


def phase_configs_moe() -> dict:
    """21a: kimi-k2 at the depth the card holds, served on B7 as phase 7
    serves phi3.5-moe (B7's launches, B7 on the path's own activations,
    the plain expert path), then B7 timed at its two serve shapes."""
    cfg, fp = config_depth(CONFIG_MOE)
    served = phase_lm_serve(cfg, "configs")
    row = dict(layers=cfg.n_layers, weight_gb=served["weight_bytes"] / 1e9,
               **peak_beside_trace(CONFIG_MOE, fp, served["peak_bytes"]),
               **{k: served[k] for k in (
                   "launches", "prefill_ms", "decode_ms", "steps_alike",
                   "flipped_token_layers", "token_layers", "b7_ffn_calls",
                   "b7_ffn_max_err", "worst_same_route")})
    row["b7"] = b7_serve_rows(cfg, "configs")
    return row


def profile_decode(cfg, model, served: dict, phase: str) -> None:
    """profile_lm of one decode step after the served prompts' prefill."""
    from repro_torch.launch.serve import pad_cache
    from repro_torch.launch.steps import make_prefill, make_serve_step
    _, cache = make_prefill(cfg)(model, {"tokens": served["prompts"]})
    cache = pad_cache(cache, LM_PROMPT + LM_GEN)
    serve_step = make_serve_step(cfg)
    profile_lm(f"{cfg.name} decode step", lambda: serve_step(model, dict(
        tokens=served["tokens"][:, :1], cache=cache, cache_index=LM_PROMPT)),
        phase)
    del cache
    torch.cuda.empty_cache()


def phase_configs_dense(arch: str, seed: int) -> dict:
    """21b/d/e: a dense configuration at the depth the card holds, bf16:
    LM_BATCH x LM_PROMPT + LM_GEN through generate, a CONFIG_CHECK-token
    prefill (flash in every layer) and LONG_STEPS decode steps against
    forward_train, measured; the same check held within LONG_TOL on a
    float32 copy of the first CONFIG_FP32_LAYERS layers."""
    from repro_torch.models import layers as L
    cfg, fp = config_depth(arch)
    model, n_bytes = seeded_model(cfg, "configs")
    served = serve_batch(cfg, model, "configs")
    profile_decode(cfg, model, served, "configs")
    calls, flash = [], L.flash_attention
    L.flash_attention = lambda *a: (calls.append(a[0].shape[-1]), flash(*a))[1]
    try:
        bf16 = check_decode_against_train(f"21 {arch}", cfg, model, seed,
                                          hold=False, prompt=CONFIG_CHECK,
                                          phase="configs")
    finally:
        L.flash_attention = flash
    # the prefill and forward_train each run flash once a layer
    want = 2 * cfg.n_layers
    log("configs", f"21 {arch}: flash calls in the check {len(calls)} "
        f"(expected {want}), head_dim {sorted(set(calls))}")
    if len(calls) != want or set(calls) != {cfg.resolved_head_dim}:
        raise AssertionError(f"21 {arch}: {len(calls)} flash calls at "
                             f"head_dim {sorted(set(calls))}")
    del model
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, n_layers=CONFIG_FP32_LAYERS)
    small, _ = seeded_model(cut, "configs")
    fp32 = check_decode_against_train(
        f"21 {arch} first {CONFIG_FP32_LAYERS} layers", cut, small.float(),
        seed, hold=True, prompt=CONFIG_CHECK, phase="configs")
    del small
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, weight_gb=n_bytes / 1e9,
                **peak_beside_trace(arch, fp, served["peak_bytes"]),
                prefill_ms=served["prefill_ms"],
                decode_ms=served["decode_ms"], decode_check_bf16=bf16,
                decode_check_fp32=fp32)


def phase_configs_train() -> dict:
    """21c: granite-34b through the trainer at its defaults but the
    learning rate (CONFIG_TRAIN_LR), cut to the deepest stack within
    CONFIG_TRAIN_BUDGET by the trace (:func:`config_footprint`): the losses
    finite and falling, step 0's batch's loss lower after the run than
    before it (each step draws another batch), the weights moved, the
    peak memory beside
    the trace's; that loss's backward: the learned position table's
    gradient nonzero on every row the batch reads and zero past the
    sequence, the multi-query wk's and wv's nonzero."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import synth_batch_for
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    argv = ["--arch", CONFIG_TRAIN_ARCH, "--steps", str(CONFIG_TRAIN_STEPS),
            "--lr", str(CONFIG_TRAIN_LR)]
    args = train.parse_args(argv)
    opt = train.cli_opt(args)
    full = get_config(CONFIG_TRAIN_ARCH)
    # 12 B a parameter: bf16 weights and gradients, float32 moments
    n = full.n_layers
    while n > 1 and dataclasses.replace(
            full, n_layers=n).param_count() * 12 > CONFIG_TRAIN_BUDGET:
        n -= 1
    while True:
        fp = config_footprint(dataclasses.replace(full, n_layers=n), "train",
                              args.seq_len, args.global_batch, opt)
        if fp["total"] <= CONFIG_TRAIN_BUDGET or n == 1:
            break
        n -= 1
    log("configs", f"21c {CONFIG_TRAIN_ARCH} training at {n} of "
        f"{full.n_layers} layers ({args.global_batch} x {args.seq_len}, the "
        f"trainer's defaults, --lr {args.lr}): trace of a step, temp "
        f"{fp['temp'] / 1e9:.3f} GB + weights, optimizer state and batch "
        f"{fp['args'] / 1e9:.3f} GB = {fp['total'] / 1e9:.3f} GB (budget "
        f"{CONFIG_TRAIN_BUDGET / 1e9:.0f} GB"
        + (f"; {n + 1} layers exceed it)" if n < full.n_layers else ")"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.main(argv + ["--layers", str(n)])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = run.losses
    # LayerNorm's bias starts at 0, where bf16 resolves a step of ~lr
    # (the scale's 1 + lr rounds back to 1)
    moved = bool((run.params.final_norm.bias != 0).any())
    med = float(np.median(run.step_ms[1:]))
    batch = synth_batch_for(run.cfg, run.data, 0, device="cuda")
    p = run.params
    attn = p.layers[0].attn
    loss, _ = T.loss_fn(run.cfg, p, batch)
    after = float(loss)
    log("configs", f"21c {CONFIG_TRAIN_STEPS} steps in {wall:.1f} s (init "
        f"included): losses {[round(x, 4) for x in losses]}; step 0's batch "
        f"{losses[0]:.4f} before, {after:.4f} after; step ms (CUDA events) "
        f"{[round(x, 3) for x in run.step_ms]}; peak memory {peak} B "
        f"({peak / 1e9:.3f} GB) beside the trace's {fp['total']:.0f} B "
        f"({(peak - fp['total']) / fp['total']:+.4f}); final_norm's bias "
        f"moved: {moved}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and after < losses[0] and moved):
        raise AssertionError(f"21c: losses {losses}, step 0's batch after "
                             f"{after}, parameters moved {moved}")
    gp, gk, gv = torch.autograd.grad(loss, [p.pos_embed, attn.wk, attn.wv])
    S = batch["tokens"].shape[1]
    read = int((gp[:S] != 0).any(dim=1).sum())
    past = int(gp[S:].count_nonzero())
    nz_k, nz_v = int(gk.count_nonzero()), int(gv.count_nonzero())
    log("configs", f"21c that loss's backward: pos_embed's gradient nonzero "
        f"on {read} of the {S} rows the batch reads, {past} nonzero "
        f"elements in the {gp.shape[0] - S} rows past it; layer 0's wk "
        f"{tuple(gk.shape)} and wv {tuple(gv.shape)} (one KV head) nonzero "
        f"elements {nz_k} / {nz_v}")
    if read != S or past or not nz_k or not nz_v:
        raise AssertionError(f"21c: pos_embed's gradient on {read} of {S} "
                             f"rows read and {past} elements past them; wk "
                             f"{nz_k}, wv {nz_v} nonzero")
    del run, batch, p, attn, loss, gp, gk, gv
    torch.cuda.empty_cache()
    return dict(layers=n, seq=args.seq_len, batch=args.global_batch,
                lr=args.lr, traced_bytes=fp["total"],
                measured_peak_bytes=peak, losses=losses,
                step0_batch_after=after, step_ms=med, pos_rows_read=read)


def phase_configs(errors: dict) -> dict:
    """21: the published configurations that no other phase runs on the
    card, in bf16 at their widths, seeded weights drawn on the card, each
    freed before the next: kimi-k2 (21a), granite-34b served (21b) and
    trained (21c), stablelm-12b (21d), deepseek-7b (21e), and flash at
    their attention geometries (21f)."""
    t = [time.perf_counter()]
    check_normal_init_bits()
    log("configs", f"phase 21 starts with {torch.cuda.memory_allocated()} B "
        f"allocated, {card_room() / 1e9:.3f} GB to use")
    out = {"models": {CONFIG_MOE: phase_configs_moe()}}
    t.append(time.perf_counter())
    (granite, gseed), *rest = CONFIG_DENSE
    out["models"][granite] = phase_configs_dense(granite, gseed)
    t.append(time.perf_counter())
    out["train"] = phase_configs_train()
    t.append(time.perf_counter())
    for arch, seed in rest:
        out["models"][arch] = phase_configs_dense(arch, seed)
        t.append(time.perf_counter())
    # held in float32 against float64 attention; bf16 measured and timed:
    # at these groups the bf16 gradients of dense_attention itself lie
    # beyond LONG_TOL of float32's (tools/flash_bf16_groups.py)
    g = torch.Generator(device="cuda").manual_seed(90)
    out["flash"] = {arch: {
        "fp32": flash_vs_oracle(g, geom, f"21 {arch}"),
        "bf16": flash_check(torch.bfloat16, g, errors, geom, f"21 {arch}",
                            hold=False)} for arch, geom in CONFIG_FLASH.items()}
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    secs = [b - a for a, b in zip(t, t[1:])]
    out["seconds"] = dict(zip("abcdef", secs))
    log("configs", f"phase 21 took {t[-1] - t[0]:.1f} s: "
        + ", ".join(f"21{k} {v:.1f} s" for k, v in out["seconds"].items()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(sys.argv[2])
    sys.path.insert(0, os.path.join(ROOT, "src"))
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()

    from repro_torch.data.dmri import synth_connectome
    t0 = time.perf_counter()
    problem = synth_connectome(**MAIN_PROBLEM, device="cuda")
    log("main", f"problem {MAIN_PROBLEM}: {problem.phi.n_coeffs} coefficients, "
        f"Nv {problem.phi.n_voxels}, Nf {problem.phi.n_fibers}, made in "
        f"{time.perf_counter() - t0:.1f} s")

    errors: dict = {}
    phase_kernels(problem, errors)
    launches, w_opt = phase_main(problem)
    launches.update(phase_formats(problem, w_opt))
    t0 = time.perf_counter()
    phase_tune(problem, errors)
    log("tune", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cohort = phase_cohort(problem)
    log("cohort", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_checkpoint(problem, cohort)
    log("checkpoint", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_serve(problem, cohort)
    log("serve", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_slice_ten(problem, cohort)
    log("slice-ten", f"phase 12 took {time.perf_counter() - t0:.1f} s")
    os.makedirs(MESH_LM_DIR, exist_ok=True)
    cohort_path = os.path.join(MESH_LM_DIR, "cohort.pt")
    torch.save([p.to("cpu") for p in cohort], cohort_path)
    del cohort
    torch.cuda.empty_cache()
    add_launches(launches, phase_mesh(problem, errors))
    torch.cuda.empty_cache()
    entries = phase_timing(problem, launches, errors)
    stn96 = problem.to("cpu")                 # for phase 18
    del problem, w_opt
    torch.cuda.empty_cache()
    entries.append(phase_lm(errors))
    trained = phase_train(errors)
    b7 = entries[-1]
    b7.update(serve_launches=b7["launches"], train_launches=trained["launches"],
              launches=b7["launches"] + trained["launches"],
              max_abs_err=errors["moe_gmm"],
              case_errs=errors["moe_gmm_cases"], dw_bmm=errors["dw_bmm"],
              train={k: trained[k] for k in ("shapes", "moe", "dense")})
    long = phase_long(errors)
    mesh_lm = phase_mesh_lm(trained["moe"], cohort_path)
    mesh_errs = [r["b7"]["max_abs_err"] for r in mesh_lm["ranks"]["ranks"]]
    b7.update(mesh_launches=mesh_lm["launches"],
              launches=b7["launches"] + mesh_lm["launches"],
              max_abs_err=max(b7["max_abs_err"], *mesh_errs),
              mesh_rank_errs=mesh_errs)
    modal = phase_modal()
    examples = phase_examples(stn96)
    trace = phase_trace()
    life_trace = phase_life_trace()
    configs = phase_configs(errors)
    b7.update(configs_launches=configs["models"][CONFIG_MOE]["launches"],
              launches=b7["launches"]
              + configs["models"][CONFIG_MOE]["launches"],
              configs=configs["models"][CONFIG_MOE]["b7"])
    for e in entries:
        if e["name"] in examples["serve_life"]["launches"]:
            e["examples_launches"] = examples["serve_life"]["launches"][
                e["name"]]
            e["launches"] += e["examples_launches"]
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"long": long}))
    print(json.dumps({"mesh_lm": {k: v for k, v in mesh_lm.items()
                                  if k != "ranks"}}))
    print(json.dumps({"modal": modal}))
    print(json.dumps({"examples": examples}))
    print(json.dumps({"trace": trace}))
    print(json.dumps({"life_trace": life_trace}))
    print(json.dumps({"configs": configs}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
