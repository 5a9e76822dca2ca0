#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card   — prints ``nvidia-smi``'s name and power limit of GPU 0;
2. build  — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
            with nvcc (sm_90a) and prints the build time and every
            kernel's registers, static shared memory and spills
            (``-Xptxas -v``); the fused SpMV + dot's thread-per-row kernel
            must keep as many blocks an SM (by registers) as spmv_ell's at
            every KMAX and type, within WALK_SPILL_LIMIT bytes of spills;
3. kernels — at the main path's shapes, holds each kernel against its plain
            PyTorch version (stated tolerance) and times kernel, plain version
            and, where one exists, a single PyTorch library call (CUDA events,
            median of 30 runs, L2 flushed before each run); spmv_ell,
            spmv_dot_ell and axpy_norm repeated bit for bit; spmv_dot_ell's
            y bitwise spmv_ell's at the same walk, and held also at a
            ragged m = 2,097,152 - 5, in f64 and at k = 27 (the subgroup
            walk); axpy_norm also in f64, at n - 3 (a scalar tail after the
            16-byte packs) and on the offset view x[1:] (the scalar route);
            spmv_dot_ell, axpy_norm and axpy_norm_rows (256 x 1,024, rows
            in pieces) each one device kernel a call under torch.profiler,
            and 1,000 back-to-back calls of each bit for bit;
            block_jacobi_apply at every (vector, storage) pair — f32 vectors
            with f32, bf16 and fp16 blocks, f64 vectors with f64, bf16 and
            fp16 blocks — within 2 bs eps of the vector's type, repeated
            bit for bit, with its CUPTI µs and beside its first design (one
            thread a row, kernels/block_jacobi/rowwise.cu, built in phase
            2) where that design had the pair; so at every later path's
            blocks (AMG, batched, serve, adaptive CGS); and held at block
            sizes no path uses, 5 (the general route), 40 and 64 (the wide
            route, a block's rows over several warps);
4. path   — solves poisson_3d(128) (2,097,152 rows, ELL k = 7, f32) with
            block-Jacobi CG through the CUDA executor, checks convergence, the
            true residual and every kernel's launch count, and repeats the
            solve in the torch space on the card for comparison; then (4b)
            pipelined CG on the same system in f64 (f64 block-Jacobi 8;
            in f32 its recurrences stagnate above 1e-6 at this size):
            convergence, the true residual, iterations within 2 of classic
            CG's on the same f64 system, the launches exactly (k + 2
            spmv_ell, k + 1 preconditioner applies), a repeat bit for bit,
            the torch space, device us an iteration of both loops; and
            (4c) FCG in f32 alike; a small solve is also held against the
            reference space on the CPU;
5. amg    — runs ``repro_torch.launch.amg_check`` on poisson_2d(1024)
            (1,048,576 rows, CSR, f32) through the CUDA executor: the
            smoothed-aggregation hierarchy (SpGEMM and transpose kernels), AMG-CG
            against block-Jacobi CG, the gate, each kernel's launch count
            against the hierarchy, the true residual, the setup split; then the
            same path in the torch space on the card (the hierarchy bitwise
            equal); a repeated AMG-CG solve with the run's preconditioner
            bitwise equal in each space (the CSR SpMV sums rows in a fixed
            order); then, at this path's shapes, spmv_ell on every level
            operator (timed, CSR torch.sparse.mm as library, and summed per
            V(1,1) cycle: A three times, P and R once a level, beside the
            profile's spmv_ell time an iteration), axpy_norm at the outer
            CG's vectors and block_jacobi_apply at the baseline's blocks
            against their plain versions (phase 3's tolerances), and the two
            SpGEMM kernels at level 0's shapes (bitwise), with their times;
            csr_permute also on every level's P^T (bitwise, each timed;
            level 0 with its CUPTI kernel time), on level 0's order less
            its last 3 entries (a scalar tail), on views of both arrays 4
            bytes past a 16-byte boundary (the scalar route) and in f64;
6. sellp  — Jacobi-CG on power_law_laplacian(2**21, seed=4) stored as SELL-P
            (C = 8, stride 8, f32) through the CUDA executor: convergence, the
            true residual, spmv_sellp's launch count against the loop's
            SpMVs, a repeat bit for bit, the torch space on the card (a
            repeat bit for bit too), the storage ELL would need; spmv_sellp
            held against its plain version (per row, 2 (w + 1) eps relative
            to the row's magnitudes, w its slice's width) and timed,
            torch.sparse.mm on the CSR as library; the same matrix at
            C = 32 and C = 12 held alike, each repeat bit for bit;
7. batch  — repro_torch.launch.batch_solve at 16,384 systems of 1,024 rows
            (f32 BatchEll, k = 3) with no preconditioner and with Jacobi,
            batch_cg with 8-row block-Jacobi, and BiCGSTAB at 1,024 x 64:
            every system converged, the error against the known solutions,
            each kernel's launches against the sweeps, a 4-sweep chunked
            advance bit for bit equal to the monolithic one, the torch space
            on the card (iterations within 1, x close); spmv_batch_ell
            (at the CG runs' operator on the narrow route and the BiCGSTAB
            run's on the wide route, each with its CUPTI kernel time and
            its launches by shape; the CG operator also on the wide route;
            then, untimed, a ragged wide shape and an offset values view
            whose rows are not 16-byte aligned, the middle band k = 24 on
            both routes, a ragged narrow shape, f64 at both path shapes,
            the wide route below and above one wave, and the long walk at
            k = 600 (f32), 300 (f64) and a ragged 601; each within 8 k eps
            and repeated bit for bit), row-batched
            axpy_norm (at the CG runs' rows, one block each, and at
            256 x 1,024, rows cut into pieces) and block_jacobi_apply held
            and timed at this path's shapes (torch.sparse.mm on the
            block-diagonal CSR of all systems as spmv_batch_ell's library
            call);
8. lm     — Zamba2-2.7B serving at full width and depth (54 Mamba2 layers,
            bf16, 2,646,049,440 random parameters from seed 0):
            (a) repro_torch.launch.serve on the CUDA executor, 8 prompts of
            2,048 tokens and 64 greedy tokens each: prefill ms, decode ms
            per step, tokens/s, peak memory, and the launches exactly
            (rmsnorm 19 per prefill and per decode step, flash_attention 9
            and ssd_scan 54 per prefill); (d) prefill(2,044) + 4 decode
            steps against prefill(2,048), each stage's launches counted,
            then torch.profiler over 4 decode steps and over one prefill
            (device busy share, kernels by time); (b) the same path in the
            torch space on the card, teacher-forced with (a)'s tokens:
            logits against (a)'s, top-1 agreement, no LM kernel launched;
            (c) full width at 12 layers in f32 (TF32 off), the cuda space
            against the torch space; then rmsnorm (d = 5,120 and 2,560, at
            the prefill's 16,384 rows and a decode step's 8, repeated bit
            for bit at the first), flash_attention (the path's shape,
            repeated bit for bit, a GQA, an offset, an fp16, a ragged
            S = Skv = 2,000 and an f32 shape)
            and ssd_scan (the path's shape, repeated bit for bit, the
            strided views of x, B and C mamba_forward hands over held bit
            for bit against contiguous copies, a strong decay, a ragged
            S = 2,044, f32 and a narrow G = 1, P = N = 32 shape) held
            against their plain versions and timed (F.rms_norm and
            F.scaled_dot_product_attention as library calls);
9. rwkv6  — RWKV6-3B serving at full width and depth (32 layers, bf16,
            3,094,374,400 random parameters from seed 0):
            (a) repro_torch.launch.serve on the CUDA executor, 8 prompts of
            2,048 tokens and 64 greedy tokens each, on the JAX package's
            init: prefill ms, decode ms per step, tokens/s, peak memory, and
            the launches exactly (rwkv6_scan_log 32 per prefill, 0 per
            decode step, every other kernel 0); then (b)-(d) on parameters
            whose w0, w_lora_b and mix_lora_b (zero at init) are seeded
            draws, so the decay depends on the data: (b) the cuda space
            against the torch space on the card (last-position prefill
            logits and 8 teacher-forced decode steps within 0.1 of max
            |logit|, top-1 agreement), and both bf16 routes against the f32
            result of the same weights (the cuda space's per-position error
            at the median and 99th percentile within 1.25 times the torch
            space's);
            (d) prefill(2,044) + 4 decode steps against prefill(2,048);
            torch.profiler over one prefill and over 4 decode steps; (c)
            full width at 8 layers in f32, the cuda space against the torch
            space; then rwkv6_scan_log held against its plain version at the
            path's shape (timed), a strong decay, a ragged tail, a tail of
            3 rows (shorter than one sub-chunk of 8) and f32.

10. krylov — at sizes users solve, through the CUDA executor, each solve
            counted from 0 (launches exactly), with the true residual and
            the torch space on the card: on convection_diffusion_2d(1024,
            Pe 5, upwind) as ELL (1,048,576 rows, k = 5, f32) with
            block-Jacobi 8, fused BiCGSTAB (spmv_dot_ell twice an iteration,
            with w = r-hat and w = s, axpy_norm once) and CGS (in f64 with
            f64 blocks: in f32 it diverges on this system), and CGS in f64
            with adaptive block-Jacobi (f64 vectors with fp16 / bf16
            blocks; each reduced class held and timed at the path's blocks
            first, launches pinned by storage), each converged within
            Stop(3000, 1e-6) to a true residual of NONSYM_TRUE_TOL and
            repeated bit for bit;
            GMRES(30) for at most 40 restart cycles (the residual falling
            cycle by cycle, the torch space's within 1e-3 at the same cycle
            count, device and wall ms a cycle); ParILU-preconditioned
            BiCGSTAB (host setup time, iterations beside block-Jacobi's, a
            repeat bit for bit); then mixed-precision IR on
            poisson_3d(128) in f64 as ELL, an f32 inner CgSolver with
            block-Jacobi under Stop(100, 1e-12): the f64 true residual below
            1e-9 and a tenth of a pure-f32 CG's, spmv_ell's f64 and f32
            launches counted apart.
11. serve — repro_torch.serve on the CUDA executor: (a) 2,048 requests of
            1,024 rows (4 banded SPD patterns, 60 % repeats) unpaced through
            SolveService, 256-slot ELL lanes, block-Jacobi 4, CG to 1e-5:
            SERVE-GATE, every host f64 true residual within SERVE_TRUE_TOL,
            4 pattern generates in the cold pass and none for a full-hit
            request, spmv_batch_ell, axpy_norm_rows and block_jacobi_apply
            launched exactly as the lanes' counted refreshes and advance
            sweeps imply, 8 busy-lane responses bitwise equal to solo
            engines', the inline engine twice bit for bit (and equal to the
            service), the torch space on the card over the first 1,024
            requests (iterations within 1, x within 1e-3), solves/s,
            latency p50/p99, and torch.profiler over the inline drain of the first 256 requests (device busy share,
            device µs an advance sweep, top kernels); (b) the first 1,024
            requests paced at half (a)'s rate: p50/p99; (c) 512 requests
            each on CSR lanes with ParILU and with AMG, and BiCGSTAB on ELL
            lanes with half the fresh matrices convection-diffusion
            patterns: launches exact, true residuals, hit accounting, a
            repeat bit for bit; (d) the first 256 requests traced: a valid
            Chrome trace, no dispatch above 1.05 of the HBM bound in the
            roofline summary, the metrics JSONL round-tripped; then the
            three kernels held and timed at a lane's operator and blocks,
            and a NaN system held to its own row in each.
12. dist  — repro_torch.distributed on phase 4's system (block-Jacobi 8 in
            the one storage class phase 4's adaptive rule picked): (a) a
            one-part DistEll on one rank (NCCL, this process) through
            dist_solve: iterations within 1 of phase 4's, x within 1e-3,
            the true residual, the launches and reductions exactly, a repeat
            bit for bit, device us an iteration; (b) DIST_RANKS ranks of
            524,288 rows time-sharing the card (gloo, spawned; every
            collective staged through host memory): CG in f32 within 1
            iteration and 1e-3 of (a), the launches exactly on every rank,
            three reductions an iteration, a repeat (profiled on rank 0)
            bit for bit and every rank's x the same bits; then a window of
            pipelined CG in f64 at exactly one reduction an iteration; (c)
            repro_torch.launch.dist_solve's entry point at 1,048,576 rows
            (Jacobi-CG on ELL, one rank): DIST-PARITY: PASS;
13. implicit — (a) make_implicit_solve on convection_diffusion_2d(1024,
            Pe 5, upwind), CSR, GMRES(30): one forward and one backward,
            the forward's true residual and the transposed solve's within
            1e-5, the values gradient equal to -lam[row] x[col] in f64
            within 1e-5, wall and device time; (b) the DEQ model
            (DeqConfig()) at batch 8 on the card: loss and gradients within
            1e-4 of the CPU's torch space, and in f64 the gradient along a
            seeded direction within 1e-3 of central differences.
14. families — the transformer families on random bf16 weights (seed 0),
            each through repro_torch.launch.serve on the CUDA executor at 8
            prompts of 2,048 tokens (token ids, or standard-normal
            embeddings for a stub frontend) and freed before the next:
            granite-8b (GQA 32/8, D 128), qwen2-moe-a2.7b (60 + 4 padded
            experts, top-4, shared expert), minicpm3-4b (MLA, 62 layers)
            and musicgen-large (stub frontend, sinusoidal positions,
            LayerNorm, tanh-GELU, MHA D 64) at full width and depth with 64
            greedy tokens; yi-9b, smollm-135m, pixtral-12b and olmoe-1b-7b
            at full width and 2 layers with 4 decode steps.  Each: (a) the
            serve call, its launches exactly (rmsnorm 2 L + 1 a prefill and
            a step, 4 L + 1 with MLA, none with LayerNorm; flash_attention
            L a prefill; every other kernel none), prefill ms, decode ms a
            step, tokens/s, peak memory; (d) a prefill and 4 decode steps
            each counted under torch.profiler (device busy share); (b) the
            torch space on the card teacher-forced with (a)'s tokens:
            logits within LM_BF16_TOL, the greedy tokens of both spaces, and
            for MoE the tokens routed to another expert set; (c) for the
            full-depth four, 2 layers in f32 within 1e-3, MoE routing
            identical.  Then repro_torch.core.coop on CUDA tensors, the
            cases of tests/core/test_coop.py, bitwise equal to the CPU's;
            and rmsnorm (d = 576, 768, 2,048, 4,096, and 256 at a row
            stride of 288 and over the MLA decode cache) and flash_attention
            (D 128 at 32/8, 32/4 and 16/16 heads, D 96 at 40 heads with v
            padded from 64, D 64 at 32/32 and 9/3 heads; f32 at D 96 and
            128) held against their plain versions and timed.
15. train — random weights from the port's init (seed 0) on the chain
            data of repro_torch.data (seed 17): (a) smollm-135m at full
            width and depth (30 layers, bf16) through
            repro_torch.launch.train.train on the CUDA executor, 40 steps
            of 8 x 2,048 tokens (warmup-cosine, peak 3e-3): the last 5
            losses' mean at least 0.25 below the first 5's and above the
            entropy floor less 0.05, launches exactly (rmsnorm 61 and
            flash_attention 30 a step, every other kernel 0: backward
            launches no hand-written kernel), warm step ms, tokens/s, peak
            memory, and 2 steps under torch.profiler split into forward,
            backward and optimizer; (b) the first step's loss and every
            leaf's gradient from the same weights and batch in both
            spaces: in the cuda space every leaf finite and non-zero; bf16
            at (a)'s size (the torch space's blocks checkpointed) loss
            within 1e-2 relative, ||g_cuda - g_torch|| / ||g_torch|| at
            most 0.1 a leaf; f32 at 2 layers (TF32 off) 1e-5 and 1e-3;
            (c) 2 layers, 20 steps of 8 x 512: a run stopped at step 10
            and resumed from CheckpointManager gives the uninterrupted
            run's first 10 losses bit for bit and the rest within rtol =
            atol = 2e-4; a simulated preemption checkpoints step 1; (d)
            one step each of zamba2-2.7b (one group of 6 Mamba2 layers
            and the shared block), rwkv6-3b (2 layers, w0 and the LoRA
            outputs seeded as in phase 9), minicpm3-4b and olmoe-1b-7b (2
            layers) at 2 x 2,048: launches exactly, every gradient finite
            and non-zero, (b)'s comparisons in bf16 and f32 (MoE routed as
            the cuda space routed; its bf16 gradients printed, not held);
            (e) compressed DP: 2 gloo ranks sharing the card, smollm-135m
            at 2 layers, 12 steps of 8 x 512 at constant 3e-3 without
            weight decay: the losses within 1e-4 of the same algorithm run
            in one process on the card, the last loss below the first
            less 0.1, the ranks' parameters bitwise equal; the
            uncompressed single-card run beside it, printed; (f)
            train_deq: DEQ-GATE:
            PASS; (g) the four kernels' autograd Functions at (a)'s and
            (d)'s shapes: the forward bitwise the bare kernel's, the
            gradients autograd's through the plain version, forward and
            backward ms.
16. tooling — (a) ``python -m repro_torch.launch.dryrun --all`` in a
            child process (TOOLING_JOBS worker processes on the host's
            cores, no card; it must end within TOOLING_DRYRUN_DEADLINE_S
            of the phase's start): every arch x live cell on the 16 x 16 mesh on
            the meta device, each cell's FLOPs and bytes a device, the
            one-card share's predicted peak, per-rank bytes, the collective
            census, the roofline terms, the bottleneck and useful_fraction
            printed as its record arrives; every cell must build; (b) as
            the records arrive, each cell's one-card share (one data
            replica of 16 x 16 with the model axis folded: batch
            global_batch // 16, the full sequence, the whole model at full
            width and depth in bf16, random weights from seed 0, the dry
            run's batch and cache structs made real on the card) whose
            predicted peak is within TOOLING_FIT of the card's memory, in
            the cuda space: a warm step and one timed step (ms, tokens/s;
            a prefill's from a zeroed cache),
            measured against predicted peak bytes, the step against the
            share's roofline, the LM kernels it must launch; a share
            predicted to fit that runs out of memory fails; the shares not
            run are listed with their predicted bytes; (c) each prefill
            share's last-position logits within LM_BF16_TOL: the first
            sequence's against the torch space on the card (chunked
            attention), the second's against that sequence run alone in
            the cuda space (so batch index 1 is held as well; MoE routes
            replayed in both); (d) flash_attention at S = Skv =
            32,768 (granite-8b's 32/8 heads, D 128, B 2; three query blocks
            held against a dense f32 computation of those rows only, SDPA's
            rows printed beside them, a repeat bitwise), rmsnorm at 65,536 rows of 4,096, ssd_scan at
            zamba2's and rwkv6_scan_log at rwkv6's 2 x 32,768, held against
            their plain versions and timed (TOOLING_REPS runs;
            flash_attention's plain time is the torch space's chunked
            attention, the dense one would not fit; SDPA causal its
            library call); (e) ``python -m repro_torch.launch.inspect
            solve`` for the five solvers at the default n on the card with
            --trace and --metrics, then trace, validate and metrics on
            those files: every exit code 0.

It then prints one JSON line describing the kernels and, last, the
``{"ok": true, "device": ...}`` line.  A kernel's ``launches`` there is the
sum over the paths' counted runs (phases 4 to 12 and 14: block-Jacobi,
pipelined and flexible CG; the AMG check; SELL-P CG; the four batched
solves; the two serve calls; BiCGSTAB, CGS, GMRES, ParILU-BiCGSTAB and
mixed-precision IR; the served stream of 11a and the three lanes of 11c;
the distributed CG on one rank, on four ranks (each rank's counts, summed)
and its pipelined window, and the launcher; the eight family serve calls;
``train``, 15a's 40 steps, ``train_families``, 15d's four cuda steps, and
``tooling_shares``, the timed step of each of 16b's shares),
each run counted from 0; ``launches_by_path`` gives each, and
block_jacobi_apply's storage variants carry the same per storage dtype.
``max_abs_err`` is the larger over the shapes the kernel was held at;
``at_amg_path_shape`` / ``at_batch_path_shape`` / ``at_serve_path_shape``
hold the times at those paths' shapes of a kernel whose row is timed at
phase 3's, and
``at_bicgstab_shape`` / ``at_row_pieces_shape`` those of phase 7's second
shapes, ``at_family_shapes`` rmsnorm's and flash_attention's at phase 14's,
``train_function`` each LM kernel's autograd Function at phase 15's,
``at_cell_shapes`` the four LM kernels' at phase 16's 32k shapes; rmsnorm's ``at_decode_shape`` holds its rows at a decode step's 8
rows and spmv_ell's ``at_amg_levels`` one row per AMG level operator and
their sum per V(1,1) cycle.  It imports
nothing of JAX or of the JAX package.  Without a CUDA device, or without the
repository beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
N_SIDE = 128
STOP_KW = dict(max_iters=3000, reduction_factor=1e-6)
PRECOND_OPTS = {"block_size": 8, "adaptive": True}
REPS = 30
#: back-to-back calls of each single-pass reduction held bit for bit
REPEATS = 1000
#: spill bytes allowed the fused thread-per-row kernel (spmv_dot.cu), whose
#: __launch_bounds__ pin spmv_ell's blocks an SM: at the path's KMAX 8 in
#: f32 (72 with CUDA 12.9), and at every other instantiation
WALK_SPILL_LIMIT = {(8, "float"): 128, None: 512}
#: the AMG path: amg_check on poisson_2d(1024) (1,048,576 rows); block-Jacobi
#: CG needs about 1,800 iterations there, AMG-CG about 15
AMG_N_SIDE = 1024
AMG_KW = dict(cycle="v", theta=0.08, tol=1e-6, max_iters=6000, iter_cut=5)
#: the SELL-P path: Jacobi-CG on power_law_laplacian(2**21, seed=4) (about 70
#: iterations; the longest row has 11,156 entries)
SELLP_N = 2 ** 21
SELLP_SEED = 4
#: the batched path: batch_solve's CG runs and its BiCGSTAB run
BATCH_ARGS = ["--batch", "16384", "--n", "1024"]
BATCH_BICGSTAB_ARGS = ["--batch", "1024", "--n", "64", "--solver", "bicgstab"]
#: phase 4b: pipelined CG runs phase 4's system in f64 with 8-row f64
#: block-Jacobi (the kernel takes f64 blocks only with f64 vectors).  In f32
#: its recurrences stagnate near 1e-5 at this size, where the recursive
#: residual drifts from the true one: the JAX package's own tests hold it
#: only to an f32-attainable 1e-6 on 80 rows and leave tighter stops to f64
PIPE_OPTS = {"block_size": 8}
#: phase 10: the nonsymmetric system convection_diffusion_2d(1024, Pe 5,
#: upwind) as ELL (1,048,576 rows, k = 5, f32); GMRES(30) runs at most
#: KRYLOV_GMRES_CYCLES restart cycles
KRYLOV_N_SIDE = 1024
KRYLOV_CONVDIFF = {"peclet": 5.0, "scheme": "upwind"}
KRYLOV_RESTART = 30
KRYLOV_GMRES_CYCLES = 40
#: true relative residual (f64 plain SpMV) the f32 BiCGSTAB / CGS solves of
#: phase 10 must reach when their recursive residual meets Stop(3000,
#: 1e-6): over ~700 iterations the two drift apart (block-Jacobi BiCGSTAB
#: ends at 1.8e-4 on an H100), so 1e-4 is out of f32's reach here
NONSYM_TRUE_TOL = 1e-3
#: mixed-precision IR on poisson_3d(N_SIDE) in f64; the pure-f32 CG it is
#: held against runs this many iterations (it stagnates long before)
IR_STOP = dict(max_iters=100, reduction_factor=1e-12)
IR_F32_ITERS = 1000
#: the serving path: Zamba2-2.7B at full width and depth (54 Mamba2 layers,
#: bf16), 8 prompts of 2,048 tokens, 64 greedy tokens each
LM_ARCH = "zamba2-2.7b"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 2048, 64
LM_KERNELS = ("rmsnorm", "flash_attention", "ssd_scan")
#: the cuda and torch spaces, and prefill + decode against prefill, agree on
#: bf16 logits within this share of max |logit|: each of the 63 residual
#: blocks rounds its output to bf16 (2^-8 relative), at other places on the
#: two routes, so the stream drifts by about sqrt(63) 2^-8 = 3.1e-2 of its
#: size; 0.1 is three times that
LM_BF16_TOL = 0.1
#: full width at 12 layers (2 groups) in f32, cuda against torch space:
#: f32 sums in another order only
LM_F32_LAYERS, LM_F32_BATCH, LM_F32_PROMPT = 12, 2, 1024
LM_F32_TOL = 1e-3
#: the RWKV6 serving path: RWKV6-3B at full width and depth (32 layers,
#: bf16), phase 8's size.  LM_BF16_TOL holds there too: 32 blocks of two
#: residual adds each round the stream to bf16 at other places on the two
#: routes, sqrt(64) 2^-8 = 3.1e-2 of its size, and 0.1 is three times that
RWKV_ARCH = "rwkv6-3b"
#: (b): teacher-forced decode steps compared; (c): f32 at 8 layers
RWKV_CMP_STEPS = 8
#: (b) also holds both bf16 routes to the f32 result of the same weights: at
#: the median and 99th percentile over positions, the cuda space's error
#: may exceed the torch space's by at most this factor.  Two bf16 routes
#: that round at other places sit equally far from f32 (the spread of a
#: median or p99 over 16,384 positions is a few per cent); a fault that
#: added error of the size of the bf16 noise would double it
RWKV_F32_REF_MARGIN = 1.25
RWKV_F32_LAYERS, RWKV_F32_BATCH, RWKV_F32_PROMPT = 8, 2, 1024
#: phase 14: the transformer families on random weights, each at phase 8's
#: size (8 prompts of 2,048 tokens): four at full width and depth with 64
#: greedy tokens, four at full width and FAMILY_SHALLOW_LAYERS layers with
#: 4 decode steps.  LM_BF16_TOL holds against the torch space on the card:
#: MiniCPM3's 62 blocks round the stream to bf16 after 124 residual adds at
#: other places on the two routes, sqrt(124) 2^-8 = 4.3e-2 of its size, and
#: 0.1 is more than twice that
FAMILY_FULL = ("granite-8b", "qwen2-moe-a2.7b", "minicpm3-4b", "musicgen-large")
FAMILY_SHALLOW = ("yi-9b", "smollm-135m", "pixtral-12b", "olmoe-1b-7b")
FAMILY_SHALLOW_LAYERS, FAMILY_SHALLOW_GEN = 2, 5
FAMILY_KERNELS = ("rmsnorm", "flash_attention")
#: (b): teacher-forced decode steps of the full models held to the torch
#: space; (c): f32 at this depth and size, cuda against torch space
FAMILY_CMP_STEPS = 8
FAMILY_F32_LAYERS, FAMILY_F32_BATCH, FAMILY_F32_PROMPT = 2, 2, 512

# phase 11: solve serving.  The stream: 2,048 systems of 1,024 rows over 4
# banded SPD patterns, 60 % of them repeating an earlier matrix (with a fresh
# right-hand side); 256 slots a lane, 8 sweeps a chunk, ELL lanes with
# 4-row block-Jacobi, so the three batched kernels carry the solves
SERVE_TRAFFIC = dict(num_requests=2048, gallery_size=4, repeat_ratio=0.6,
                     n=1024, seed=0)
SERVE_CONFIG = dict(slots=256, chunk_sweeps=8, solver="cg", fmt="ell",
                    precond="block_jacobi", block_size=4)
SERVE_STOP = (500, 1e-5)
#: true relative residual of every served solve (f64, on the host)
SERVE_TRUE_TOL = 1e-4
#: SERVE-GATE's p99 bound: 11a submits the whole stream at once, so its
#: p99 is the stream's own length and the bound only catches a stall; 11b
#: (half load) is held to the entry point's default
SERVE_UNPACED_P99_BOUND = 60.0
SERVE_P99_BOUND = 2.0
#: phase 12: ranks of 12b (time-sharing the one card, gloo) and their
#: collective timeout, and 12c's launcher arguments
DIST_RANKS = 4
DIST_TIMEOUT_S = 120.0
#: 12b's pipelined CG: a window (its reductions an iteration are the check;
#: phase 4b holds its convergence on one card)
DIST_PIPE_STOP = dict(max_iters=20, reduction_factor=1e-30)
DIST_LAUNCH = ["--n", "1048576", "--format", "ell", "--solver", "cg",
               "--precond", "jacobi"]
#: phase 13: 13a's stop, its profiled window of GMRES cycles, 13b's batch
IMPLICIT_STOP = dict(max_iters=3600, reduction_factor=1e-6)
IMPLICIT_WINDOW = 2
DEQ_BATCH = 8
# phase 15 (training): 15a smollm-135m at full width and depth, 40 steps of
# 8 x 2,048 tokens through launch/train.py (warmup-cosine, peak 3e-3), the
# loss to fall by TRAIN_DROP (the JAX package's learning criteria); 15b the
# first step's gradients against the torch space; 15c resume at 2 layers;
# 15d one step of four more families; 15e compressed DP over 2 gloo ranks;
# 15f train_deq; 15g the four autograd Functions
TRAIN_ARCH = "smollm-135m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 40
TRAIN_DATA_SEED = 17
TRAIN_DROP = 0.25
TRAIN_SHALLOW = 2
TRAIN_KERNELS = ("rmsnorm", "flash_attention", "ssd_scan", "rwkv6_scan_log")
TRAIN_BF16_LOSS_TOL, TRAIN_BF16_GRAD_TOL = 1e-2, 0.1
TRAIN_F32_LOSS_TOL, TRAIN_F32_GRAD_TOL = 1e-5, 1e-3
TRAIN_RESUME_STEPS, TRAIN_RESUME_STOP, TRAIN_RESUME_TOL = 20, 10, 2e-4
TRAIN_FAMILIES = (("zamba2-2.7b", 6), ("rwkv6-3b", 2), ("minicpm3-4b", 2),
                  ("olmoe-1b-7b", 2))
TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ = 2, 2048
TRAIN_DP_RANKS, TRAIN_DP_BATCH, TRAIN_DP_SEQ = 2, 8, 512
TRAIN_DP_STEPS, TRAIN_DP_LR = 12, 3e-3
# 15e's two runs in the JAX package (make_train_step, and
# make_compressed_dp_train_step on 2 host devices) on a CPU, from the same
# weights (their digest) and batches, in the model's bf16 and in f32:
# `python tests/_torch_dp_witness.py --full --n-layers 2 --global-batch 8
# --seq-len 512 --steps 12 [--dtype float32]`.  Held at every step: the
# compressed run within TRAIN_DP_JAX_TOL of the JAX package's (its test's
# tracking tolerance; an int8 level that a last-bit difference tips moves
# the two packages' compressed runs by 0.008 on one CPU), and in f32 the
# uncompressed run within TRAIN_DP_F32_TOL (the two packages agree to 3e-6
# on one CPU).  Printed: the bf16 uncompressed run against the JAX
# package's (at a constant 3e-3 the loss jumps, and bf16 rounding alone
# parts the two packages by 0.075 on one CPU), and the gap between the
# compressed and uncompressed runs, which the JAX package's test holds to
# 0.05 at its smoke config: at this width its own runs part by 0.55.
TRAIN_DP_DTYPES = ("bfloat16", "float32")
TRAIN_DP_JAX = {
    "bfloat16": {
        "weights": "28656dc0bd3e9c54ecb40c80dfed580ed0513d4b70bbc1e40f9ff1285b293715",
        "uncompressed": [10.889801025390625, 10.886301040649414, 10.902042388916016, 10.884702682495117, 10.98384952545166, 11.044591903686523, 11.03833293914795, 10.96202278137207, 10.847696304321289, 11.021780967712402, 10.889704704284668, 10.911555290222168],
        "compressed": [10.889799118041992, 10.89482307434082, 10.880023956298828, 10.836469650268555, 10.828363418579102, 10.837079048156738, 10.822349548339844, 10.689277648925781, 10.605104446411133, 10.472126960754395, 10.396097183227539, 10.529632568359375]},
    "float32": {
        "weights": "e9374ba20785f1556bfd20ff14ad128aaf078db23b40ee61e122f60ae9062ef5",
        "uncompressed": [10.889884948730469, 10.886127471923828, 10.90282917022705, 10.886022567749023, 10.983367919921875, 11.056111335754395, 11.04421329498291, 10.964518547058105, 10.843352317810059, 11.042598724365234, 10.918155670166016, 10.868815422058105],
        "compressed": [10.889884948730469, 10.894949913024902, 10.880416870117188, 10.837114334106445, 10.828764915466309, 10.838043212890625, 10.82271957397461, 10.687719345092773, 10.603631973266602, 10.47249984741211, 10.406219482421875, 10.528185844421387]}}
TRAIN_DP_JAX_TOL, TRAIN_DP_F32_TOL = 0.05, 1e-3
TRAIN_DEQ_STEPS = 4  # ≈7 s a step on the card (8 GMRES solves, host-paced)
# the Functions' gradients are autograd through the plain version itself
TRAIN_FUNCTION_TOL = 1e-6
# runs a Function's forward and forward + backward are timed over (the
# backward takes up to 80 ms)
TRAIN_FUNCTION_REPS = 10

#: phase 16: the dry run's worker processes (one thread each) beside the
#: card's work, a share runs where its predicted peak is within this share
#: of the card's memory, timing repetitions at 32k, the time from the
#: phase's start by which the dry run must have ended (its cells took
#: 150-340 s of wall beside the card's work; past this the phase fails)
#: and the solvers inspect runs
TOOLING_JOBS = 6
TOOLING_FIT = 0.9
TOOLING_REPS = 5
TOOLING_DRYRUN_DEADLINE_S = 420
TOOLING_SOLVERS = ("cg", "fcg", "bicgstab", "cgs", "gmres")

SERVE_HALF_LOAD_REQUESTS = 1024
#: 11a's torch-space comparison runs the stream's first requests only (the
#: stream and this comparison were cut, from 4,096 requests, so that phases
#: 12-13 fit the smoke's time)
SERVE_TORCH_REQUESTS = 1024
SERVE_PROFILE_REQUESTS = 256
SERVE_TRACE_REQUESTS = 256
SERVE_LANE_REQUESTS = 512
#: 11c: (label, ServeConfig changes, TrafficConfig changes)
SERVE_LANES = (
    ("ParILU CG, CSR", dict(fmt="csr", precond="parilu"), {}),
    ("AMG CG, CSR", dict(fmt="csr", precond="amg"), {}),
    ("block-Jacobi BiCGSTAB, ELL, nonsymmetric", dict(solver="bicgstab"),
     {"nonsym_ratio": 0.5}),
)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# -- timing ----------------------------------------------------------------------


def device_ms(torch, fn, flush, reps: int = REPS) -> float:
    """Median device time of ``fn`` in ms: CUDA events around each of
    ``reps`` runs, with the L2 cache flushed before each.  A sleep kernel
    holds the stream while the host enqueues, so host overhead does not
    enter."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bounds(nbytes: float, flops: float, copy_bw: float,
           peak_flops: float = None) -> dict:
    """Least time for the work at the H100's published rates (HBM bytes/s,
    and f32 flop/s unless ``peak_flops`` names another rate, such as the
    bf16 tensor cores'; ``repro_torch.core.params.H100``), and at the
    measured copy bandwidth."""
    from repro_torch.core.params import H100

    t_bytes = nbytes / H100.hbm_bandwidth * 1e3
    t_ops = flops / (peak_flops or H100.peak_flops_f32) * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "copy_bound_ms": nbytes / copy_bw * 1e3,
        "bytes": int(nbytes),
    }


# -- phases ------------------------------------------------------------------------


def phase_card(torch) -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    line = r.stdout.strip().splitlines()[0]
    say(line)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    return line


def ptxas_table(log: str) -> list:
    """(source, kernel, registers, static shared bytes, spilled bytes) of
    every entry function in ``nvcc -Xptxas -v`` output; names demangled with
    c++filt where the machine has it."""
    import re

    rows, src, fn, spill = [], "", None, 0
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        elif m := re.search(r"Function properties for (\S+)", line):
            fn = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = int(m.group(1))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append([src, fn, int(m.group(1)),
                         int(smem.group(1)) if smem else 0, spill])
            fn, spill = None, 0
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[1] for r in rows),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r[1] = n.replace("(anonymous namespace)::", "").split("(")[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def walk_occupancy_check(table: list) -> None:
    """Fails unless every ``spmv_dot_ell_rows_kernel<KMAX, T>`` keeps as many
    256-thread blocks an SM, as its registers allow, as
    ``spmv_ell_rows_kernel<KMAX, T>`` (both take the same dynamic shared
    memory), and spills no more than WALK_SPILL_LIMIT.  Reads demangled and
    mangled names alike."""
    import re

    def blocks(regs: int) -> int:  # registers come in 8s a thread
        return min(8, 65536 // (-(-regs // 8) * 8 * 256))

    seen = {}
    for _, fn, regs, _, spill in table:
        m = (re.search(r"(spmv_dot_ell|spmv_ell)_rows_kernel<(\d+), (float|double)>", fn)
             or re.search(r"(spmv_dot_ell|spmv_ell)_rows_kernelILi(\d+)E([fd])", fn))
        if m:
            kind = {"f": "float", "d": "double"}.get(m.group(3), m.group(3))
            seen[(m.group(1), int(m.group(2)), kind)] = (regs, spill)
    pairs = [(kmax, kind) for (name, kmax, kind) in seen if name == "spmv_dot_ell"]
    if not pairs:
        fail("no spmv_dot_ell_rows_kernel in the ptxas table")
    for kmax, kind in sorted(pairs):
        regs, spill = seen[("spmv_dot_ell", kmax, kind)]
        ell = seen.get(("spmv_ell", kmax, kind))
        if ell is None:
            fail(f"no spmv_ell_rows_kernel<{kmax}, {kind}> in the ptxas table")
        limit = WALK_SPILL_LIMIT.get((kmax, kind), WALK_SPILL_LIMIT[None])
        say(f"[build]   thread-per-row walk <{kmax}, {kind}>: fused "
            f"{blocks(regs)} blocks an SM ({regs} registers, {spill} bytes "
            f"spilled, limit {limit}), spmv_ell {blocks(ell[0])} ({ell[0]})")
        if blocks(regs) < blocks(ell[0]) or spill > limit:
            fail(f"spmv_dot_ell_rows_kernel<{kmax}, {kind}> keeps "
                 f"{blocks(regs)} blocks an SM against spmv_ell's "
                 f"{blocks(ell[0])}, or spills {spill} bytes (> {limit}): "
                 "revisit kWalkBlocks in spmv_dot.cu")


def phase_build() -> float:
    import threading

    from repro_torch.kernels import _build, block_jacobi_probe

    t0 = time.perf_counter()
    # block_jacobi_apply's first design, built beside the library
    first = {}
    side = threading.Thread(target=lambda: first.update(
        lib=block_jacobi_probe.build_rowwise()))
    side.start()
    try:
        _build.load()
    finally:
        side.join()
    if "lib" not in first:
        fail("kernels/block_jacobi/rowwise.cu did not build")
    _BJ_FIRST["rowwise"] = block_jacobi_probe.Rowwise()
    seconds = time.perf_counter() - t0
    say(f"[build] {seconds:.2f} s -> {_build.last_build.get('path')} "
        f"(and {first['lib']})")
    # registers and static shared memory of every kernel (the dynamic shared
    # memory of a launch is printed where the kernel is held)
    table = ptxas_table(str(_build.last_build.get("log", "")))
    for src, fn, regs, smem, spill in table:
        say(f"[build]   {src}: {fn}: {regs} registers, {smem} bytes static "
            f"smem, {spill} bytes spilled")
    walk_occupancy_check(table)
    return seconds


def copy_bandwidth(torch) -> float:
    """Bytes/s of a 1 GiB device-to-device clone (read + write counted)."""
    src = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    flush = torch.empty(1, dtype=torch.uint8, device="cuda")
    ms = device_ms(torch, lambda: src.clone(), flush)
    del src
    bw = 2 * (1 << 30) / (ms * 1e-3)
    say(f"[kernels] 1 GiB clone: {ms:.3f} ms -> {bw / 1e9:.1f} GB/s")
    return bw


def tree_tol_rows(terms, u: float = 2.0 ** -24):
    """Tolerance of a tree sum of each row of ``terms`` against the row's sum
    in f64, as a tensor (see :func:`tree_tol`; ``u`` the unit roundoff of
    the kernel's type)."""
    s = terms.double()
    total = (s * s).sum(dim=1)
    while s.shape[1] > 1:
        if s.shape[1] % 2:  # pad to even with a zero leaf
            padded = s.new_zeros(s.shape[0], s.shape[1] + 1)
            padded[:, :-1] = s
            s = padded
        s = s[:, 0::2] + s[:, 1::2]
        total = total + (s * s).sum(dim=1)
    return 16 * u * total.sqrt()


def tree_tol(terms, u: float = 2.0 ** -24) -> float:
    """Tolerance of an f32 tree sum of ``terms`` against their sum in f64.

    Each addition rounds by at most u|s| (u = 2^-24), and the roundings act as
    independent (the probabilistic model of Higham and Mary), so the error's
    spread is about u sqrt(sum of s^2 over the tree's nodes / 3).  The nodes
    are those of a balanced pairwise tree, leaves (the f32 terms themselves)
    included; the tolerance is 16 u times that root-sum-square, over 25 times
    the spread.  For the random-sign w.y at m = 2M this is a few hundredths,
    so dropping a typical block partial (128 terms, tens in size) fails.  For
    an f64 sum, u = 2^-53, and the f64 reference, itself a tree sum, adds an
    error of the same spread: 16 u stays over 11 times the spread of the
    difference."""
    return float(tree_tol_rows(terms.flatten()[None], u)[0])


def check(name: str, err: float, tol: float) -> None:
    say(f"[kernels] {name}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        fail(f"{name} disagrees with its plain version: {err} > {tol}")


def kernel_row(torch, flush, copy_bw, name, src, line, err, kernel_fn,
               plain_fn, nbytes, flops, library_fn=None,
               peak_flops=None, cupti=False, reps: int = REPS) -> dict:
    """One entry of the ``kernels`` line: the kernel's, its plain version's
    and (where one exists) a library call's device time, and the bounds;
    with ``cupti``, also the kernel's own device time in µs under
    torch.profiler (CUPTI, the L2 flushed before each call), beside the
    event time, which holds ≈3 µs of the event pair itself."""
    entry = {
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": line,
        "max_abs_err": err,
        "ms": device_ms(torch, kernel_fn, flush, reps),
        "plain_ms": device_ms(torch, plain_fn, flush, reps),
        "library_ms": (device_ms(torch, library_fn, flush, reps)
                       if library_fn is not None else None),
    }
    if cupti:
        from repro_torch.kernels.ell_norm_probe import _kernel_us

        # the profiler may drop a window's events: up to three windows, else
        # null (never NaN, which the JSON line cannot carry)
        entry["kernel_us"] = None
        for _ in range(3):
            us = _kernel_us(kernel_fn, flush.zero_)
            if us == us:
                entry["kernel_us"] = us
                break
        say(f"[kernels] {name}: {entry['kernel_us']} us of kernel time "
            "(CUPTI)")
    entry.update(bounds(nbytes, flops, copy_bw, peak_flops))
    say(f"[kernels] {name}: {entry['ms']:.4f} ms (plain {entry['plain_ms']:.4f}, "
        f"library {entry['library_ms']}, bound {entry['bound_ms']:.4f} "
        f"by {entry['bound_by']}, copy bound {entry['copy_bound_ms']:.4f})")
    return entry


def held_axpy_norm(torch, ex, x, w, where: str = "") -> dict:
    """Holds ``axpy_norm(alpha, x, w)`` against its plain version — z within
    2 eps of max |alpha x| + |w|, z.z against the f64 sum within tree_tol
    (eps and u of x's type) — and returns the rest of its ``kernel_row``
    arguments."""
    from repro_torch import kernels as K

    eps = torch.finfo(x.dtype).eps
    n = x.numel()
    cfg = ex.launch_config("axpy_norm", {"n": n, "itemsize": x.element_size()})
    geo = dict(block_threads=cfg["block_threads"], grid_blocks=cfg["grid_blocks"])
    alpha = torch.tensor(-0.37, dtype=x.dtype, device="cuda")
    z, ss = K.axpy_norm(alpha, x, w, **geo)
    z_ref = K.axpy_norm_plain(alpha, x, w)[0]
    z64 = alpha.double() * x.double() + w.double()
    err_z = float((z - z_ref).abs().max())
    err_s = float((ss.double() - (z64 * z64).sum()).abs())
    check(f"axpy_norm z{where}", err_z,
          2 * eps * float((alpha.abs() * x.abs() + w.abs()).max()))
    check(f"axpy_norm z.z{where}", err_s, tree_tol(z64 * z64, eps / 2))
    z2, ss2 = K.axpy_norm(alpha, x, w, **geo)
    if not (torch.equal(z2, z) and torch.equal(ss2, ss)):
        fail(f"axpy_norm{where} is not repeated bit for bit")
    return dict(err=max(err_z, err_s),
                kernel_fn=lambda: K.axpy_norm(alpha, x, w, **geo),
                plain_fn=lambda: K.axpy_norm_plain(alpha, x, w),
                nbytes=3 * n * x.element_size() + x.element_size(),
                flops=4 * n)


def held_spmv_dot(torch, ex, col_idx, values, x, w, where: str = "") -> dict:
    """Holds ``spmv_dot_ell`` against its plain version — y within 8 k eps of
    max_i sum_j |a_ij x_j|, w.y against the f64 sum within tree_tol — with
    the spec's geometry; y also bitwise equal to ``spmv_ell``'s at the same
    walk and repeated bit for bit with the dot.  Returns the geometry and
    the larger error."""
    from repro_torch import kernels as K

    eps = torch.finfo(values.dtype).eps
    m, k = values.shape
    cfg = ex.launch_config("spmv_dot", {"m": m, "k": k,
                                        "itemsize": values.element_size()})
    geo = {p: cfg[p] for p in ("block_threads", "subgroup")}
    y, d = K.spmv_dot_ell(col_idx, values, x, w, **geo)
    y_ref = K.spmv_dot_ell_plain(col_idx, values, x, w)[0]
    scale = float(K.spmv_ell_plain(col_idx, values.abs(), x.abs()).max())
    wy64 = w.double() * K.spmv_ell_plain(col_idx, values.double(), x.double())
    err_y = float((y - y_ref).abs().max())
    err_d = float((d.double() - wy64.sum()).abs())
    walk = ("one thread" if geo["subgroup"] == 1
            else f"{geo['subgroup']} lanes")
    check(f"spmv_dot_ell y{where} ({walk} a row, m = {m}, k = {k}, "
          f"{values.dtype})", err_y, 8 * k * eps * scale)
    check(f"spmv_dot_ell w.y{where}", err_d, tree_tol(wy64, eps / 2))
    y_ell = K.spmv_ell(col_idx, values, x, block_threads=geo["block_threads"],
                       subgroup=geo["subgroup"])
    if not torch.equal(y, y_ell):
        fail(f"spmv_dot_ell's y{where} is not spmv_ell's bit for bit at the "
             f"same walk ({walk} a row)")
    y2, d2 = K.spmv_dot_ell(col_idx, values, x, w, **geo)
    if not (torch.equal(y2, y) and torch.equal(d2, d)):
        fail(f"spmv_dot_ell{where} is not repeated bit for bit")
    say(f"[kernels] spmv_dot_ell{where}: y bitwise spmv_ell's, y and w.y "
        "repeated bit for bit")
    return dict(geo=geo, err=max(err_y, err_d))


def one_pass_checks(torch, calls) -> None:
    """Each wrapper in ``calls`` (name -> a call returning (result, sum)) runs
    exactly one device kernel a call (no fill, no second pass), and REPEATS
    back-to-back calls on one stream give the first call's bits: every sum,
    and the last call's result.  That holds the single-pass sum's ticket
    reset by every call and its last block seeing every block's partial."""
    from repro_torch.kernels.ell_norm_probe import device_kernels

    for name, fn in calls.items():
        ops = device_kernels(fn)
        say(f"[kernels] {name}: {len(ops)} device operation(s) in 5 calls: "
            f"{sorted(set(ops))}")
        if len(ops) != 5:
            fail(f"{name} runs {len(ops)} device operations in 5 calls, not "
                 "one kernel a call")
        first, first_sum = (t.clone() for t in fn())
        sums = []
        for _ in range(REPEATS):
            last, s = fn()
            sums.append(s)
        same = (bool((torch.stack(sums) == first_sum).all())
                and torch.equal(last, first))
        if not same:
            fail(f"{name}: {REPEATS} back-to-back calls do not all give the "
                 "first call's bits")
        say(f"[kernels] {name}: {REPEATS} back-to-back calls bitwise equal")


def held_block_jacobi(torch, ex, inv, vp, where: str = "") -> dict:
    """Holds ``block_jacobi_apply(inv, vp)`` against its plain version —
    within 2 bs eps of max_b,i sum_j |inv_bij v_bj|, eps of the vector's
    type — and repeated bit for bit, with the launch configuration the
    registry binding gives these blocks, and returns the rest of its
    ``kernel_row`` arguments (the library call is ``torch.bmm`` on the
    blocks in the vector's type)."""
    from repro_torch import kernels as K

    eps = torch.finfo(vp.dtype).eps
    nb, bs = vp.shape
    geo = {"block_threads": ex.launch_config(
        "block_jacobi", {"nb": nb, "bs": bs})["block_threads"]}
    inv_v = inv.to(vp.dtype)
    yb = K.block_jacobi_apply(inv, vp, **geo)
    yb_ref = K.block_jacobi_apply_plain(inv, vp)
    err = float((yb - yb_ref).abs().max())
    sc = float(K.block_jacobi_apply_plain(inv_v.abs(), vp.abs()).max())
    pair = (f"{str(vp.dtype).removeprefix('torch.')} vector, "
            f"{str(inv.dtype).removeprefix('torch.')} blocks")
    check(f"block_jacobi_apply[{pair}]{where} ({nb} x {bs})", err,
          2 * bs * eps * sc)
    if not torch.equal(K.block_jacobi_apply(inv, vp, **geo), yb):
        fail(f"block_jacobi_apply[{pair}]{where}: a repeat differs")
    vcol = vp[:, :, None]
    return dict(err=err,
                kernel_fn=lambda: K.block_jacobi_apply(inv, vp, **geo),
                plain_fn=lambda: K.block_jacobi_apply_plain(inv, vp),
                nbytes=(nb * bs * bs * inv.element_size()
                        + 2 * nb * bs * vp.element_size()),
                flops=2 * nb * bs * bs,
                library_fn=lambda: torch.bmm(inv_v, vcol))


#: the first design of block_jacobi_apply (one thread a row), built from
#: kernels/block_jacobi/rowwise.cu beside the library in phase 2
_BJ_FIRST = {}


def bj_row(torch, flush, copy_bw, ex, inv, vp, where: str = "") -> dict:
    """``block_jacobi_apply`` held (``held_block_jacobi``) and timed, with
    its CUPTI µs; beside it the first design's time (events and CUPTI) where
    that design had the pair, and for reduced storage the library's cast
    and product timed together."""
    from repro_torch.kernels.block_jacobi_probe import hold, kernel_us

    entry = kernel_row(torch, flush, copy_bw, "block_jacobi_apply",
                       "block_jacobi.cu",
                       "src/repro/kernels/block_jacobi/kernel.py:36",
                       **held_block_jacobi(torch, ex, inv, vp, where),
                       cupti=True)
    nb, bs = vp.shape
    entry.update(vector=str(vp.dtype).removeprefix("torch."),
                 storage=str(inv.dtype).removeprefix("torch."),
                 shape={"blocks": nb, "bs": bs})
    first = _BJ_FIRST["rowwise"](inv, vp)
    if first is None:
        entry["first_design"] = "refused: it had no entry for this pair"
        told = "first design refused the pair"
    else:
        hold(f"first design{where}", first(), inv, vp)
        entry["first_design_ms"] = device_ms(torch, first, flush)
        entry["first_design_us"] = kernel_us(first, flush)
        told = (f"first design {entry['first_design_ms']:.4f} ms, "
                f"{entry['first_design_us']} us")
    if inv.dtype != vp.dtype:
        vcol = vp[:, :, None]
        entry["library_with_cast_ms"] = device_ms(
            torch, lambda: torch.bmm(inv.to(vp.dtype), vcol), flush)
        told += f"; cast and bmm {entry['library_with_cast_ms']:.4f} ms"
    say(f"[kernels] block_jacobi_apply{where} ({entry['vector']} vector, "
        f"{entry['storage']} blocks, {nb} x {bs}): "
        f"{entry['kernel_us']} us CUPTI against a "
        f"{entry['bound_ms'] * 1e3:.2f} us bound; {told}; bmm "
        f"{entry['library_ms']:.4f} ms")
    return entry


def held_batch_ell(torch, ex, col_idx, values, X, where: str = "",
                   subgroup: int = None, library: bool = True) -> dict:
    """Holds ``spmv_batch_ell`` on (col_idx, values) and ``X`` against its
    plain version — within 8 k eps of max_b,i sum_j |a_bij x_bj| — and
    repeated bit for bit, with the launch configuration the registry
    binding gives this shape (or the route ``subgroup`` names), and returns
    the rest of its ``kernel_row`` arguments (the library call is
    ``torch.sparse.mm`` on the block-diagonal CSR of all systems, the ELL
    padding stored as explicit zeros)."""
    from repro_torch import kernels as K
    from repro_torch.kernels.spmv_batch_ell.kernel import vector_loads

    eps = torch.finfo(values.dtype).eps
    size = values.element_size()
    nb, m, k = values.shape
    n = X.shape[1]
    cfg = ex.launch_config("spmv_batch_ell", {"m": m, "k": k, "n": n,
                                              "itemsize": size})
    geo = dict(block_threads=cfg["block_threads"],
               subgroup=cfg["subgroup"] if subgroup is None else subgroup)
    y = K.spmv_batch_ell(col_idx, values, X, **geo)
    y_ref = K.spmv_batch_ell_plain(col_idx, values, X)
    scale = float(K.spmv_batch_ell_plain(col_idx, values.abs(), X.abs()).max())
    err = float((y - y_ref).abs().max())
    route = "narrow" if geo["subgroup"] == 1 else "wide"
    check(f"spmv_batch_ell{where} at {nb} x {m} x k = {k}, n = {n}, "
          f"{str(values.dtype).removeprefix('torch.')}, {route} route "
          f"(subgroup {geo['subgroup']}, 16-byte loads "
          f"{geo['subgroup'] > 1 and vector_loads(values)})", err,
          8 * k * eps * scale)
    if not torch.equal(K.spmv_batch_ell(col_idx, values, X, **geo), y):
        fail(f"spmv_batch_ell{where} at {nb} x {m} x k = {k}: a repeat "
             "differs")
    out = dict(err=err,
               kernel_fn=lambda: K.spmv_batch_ell(col_idx, values, X, **geo),
               plain_fn=lambda: K.spmv_batch_ell_plain(col_idx, values, X),
               nbytes=nb * m * k * size + m * k * 4 + nb * (n + m) * size,
               flops=2 * nb * m * k)
    if library:
        crow = torch.arange(nb * m + 1, device="cuda") * k
        ccol = (torch.arange(nb, device="cuda")[:, None, None] * n
                + col_idx.long()[None]).reshape(-1)
        A_bd = torch.sparse_csr_tensor(crow, ccol, values.reshape(-1),
                                       size=(nb * m, nb * n))
        Xc = X.reshape(-1, 1)
        out["library_fn"] = lambda: torch.sparse.mm(A_bd, Xc)
    return out


def batch_ell_cases(torch, ex, gen) -> list:
    """spmv_batch_ell held (within 8 k eps, repeated bit for bit) past the
    path's two shapes: a ragged wide shape whose rows are not 16-byte aligned
    and an offset values view (both single-entry loads), the middle band
    k = 24 on both routes, a ragged narrow shape, f64 at both path shapes,
    the wide route at a batch below and above one wave of blocks, and rows
    longer than the tile kernel takes (k = 600 in f32, 300 in f64, and a
    ragged 601: the long walk).
    Returns one record a case."""
    def arrays(nb, m, k, n, dtype, offset=0):
        cols = torch.randint(0, n, (m, k), generator=gen, device="cuda",
                             dtype=torch.int32)
        fill = torch.randint(0, k + 1, (m,), generator=gen, device="cuda")
        pad = torch.arange(k, device="cuda")[None, :] >= fill[:, None]
        cols[pad] = 0  # ELL padding: column 0, value 0
        # offset: the values start that many entries past an allocation
        flat = torch.randn(nb * m * k + offset, generator=gen, device="cuda",
                           dtype=dtype)
        vals = flat[offset:].view(nb, m, k)
        vals[:, pad] = 0
        X = torch.randn(nb, n, generator=gen, device="cuda", dtype=dtype)
        return cols, vals, X

    f32, f64 = torch.float32, torch.float64
    cases = [("ragged wide, rows not 16-byte aligned", (7, 61, 61, 61, f32), None),
             ("wide, offset values view", (3, 64, 64, 64, f32, 1), None),
             ("middle band, wide route", (5, 50, 24, 50, f32), None),
             ("middle band, narrow route", (5, 50, 24, 50, f32), 1),
             ("narrow, ragged m, k and nb", (3, 37, 5, 29, f32), None),
             ("f64 at the CG runs' shape", (16384, 1024, 3, 1024, f64), None),
             ("f64 at BiCGSTAB's shape", (1024, 64, 64, 64, f64), None),
             ("wide, below one wave", (3, 64, 64, 64, f32), None),
             ("wide, above one wave", (5000, 64, 64, 64, f32), None),
             # rows past the tile kernel's 32 x 4 packs: the long walk
             ("long rows, f32 k = 600", (8, 96, 600, 700, f32), None),
             ("long rows, f64 k = 300", (8, 96, 300, 400, f64), None),
             ("long rows, ragged f32 k = 601", (5, 33, 601, 650, f32), None)]
    out = []
    for label, shape, subgroup in cases:
        cols, vals, X = arrays(*shape)
        held = held_batch_ell(torch, ex, cols, vals, X, f" ({label})",
                              subgroup=subgroup, library=False)
        out.append({"case": label, "shape": dict(zip(
            ("nb", "m", "k", "n"), shape[:4])),
            "dtype": str(vals.dtype).removeprefix("torch."),
            "subgroup": subgroup, "max_abs_err": held["err"]})
    return out


def held_axpy_norm_rows(torch, ex, X, Y, gen, where: str = "") -> dict:
    """Holds ``axpy_norm_rows(alpha, X, Y)`` against its plain version — Z
    within 2 eps of |alpha x| + |y|, each row's Z.Z against its f64 sum
    within tree_tol of that row — with the binding's launch configuration,
    and returns the rest of its ``kernel_row`` arguments."""
    from repro_torch import kernels as K
    from repro_torch.kernels.axpy_norm.kernel import rows_chunks

    eps = torch.finfo(torch.float32).eps
    nb, n = X.shape
    alpha = torch.randn(nb, generator=gen, device="cuda")
    cfg = ex.launch_config("axpy_norm_rows", {"nb": nb, "n": n, "itemsize": 4})
    geo = dict(block_threads=cfg["block_threads"], grid_blocks=cfg["grid_blocks"])
    z, ss = K.axpy_norm_rows(alpha, X, Y, **geo)
    z_ref = K.axpy_norm_plain(alpha, X, Y)[0]
    z64 = alpha.double()[:, None] * X.double() + Y.double()
    err_z = float((z - z_ref).abs().max())
    check(f"axpy_norm_rows Z{where}", err_z, 2 * eps * float(
        (alpha.abs()[:, None] * X.abs() + Y.abs()).max()))
    err_s_rows = (ss.double() - (z64 * z64).sum(dim=1)).abs()
    worst = float((err_s_rows / tree_tol_rows(z64 * z64)).max())
    say(f"[kernels] axpy_norm_rows Z.Z{where} at {nb} x {n}, "
        f"{rows_chunks(nb, n, **geo)} piece(s) per row: max_abs_err "
        f"{float(err_s_rows.max()):.3e}; largest error {worst:.3f} of its "
        "row's tolerance")
    if not worst <= 1.0:
        fail(f"axpy_norm_rows' norms{where} disagree with their f64 sums")
    return dict(err=max(err_z, float(err_s_rows.max())),
                kernel_fn=lambda: K.axpy_norm_rows(alpha, X, Y, **geo),
                plain_fn=lambda: K.axpy_norm_plain(alpha, X, Y),
                nbytes=3 * nb * n * 4 + 2 * nb * 4, flops=4 * nb * n)


def phase_kernels(torch, A, A_host, P, ex, copy_bw) -> dict:
    """``A_host``: the matrix's host CSR arrays, for the library's CSR SpMV."""
    from repro_torch import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    m, k = A.values.shape
    x = torch.randn(m, generator=gen, device="cuda")
    w = torch.randn(m, generator=gen, device="cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    eps = torch.finfo(torch.float32).eps
    out = {}

    row = functools.partial(kernel_row, torch, flush, copy_bw)

    # spmv_ell — tolerance: 8 k eps relative to max_i sum_j |a_ij x_j|
    cfg = ex.launch_config("spmv_ell", {"m": m, "k": k})
    geo = dict(block_threads=cfg["block_threads"], subgroup=cfg["subgroup"])
    y = K.spmv_ell(A.col_idx, A.values, x, **geo)
    y_ref = K.spmv_ell_plain(A.col_idx, A.values, x)
    scale = float(K.spmv_ell_plain(A.col_idx, A.values.abs(), x.abs()).max())
    err = float((y - y_ref).abs().max())
    check("spmv_ell", err, 8 * k * eps * scale)
    same = torch.equal(K.spmv_ell(A.col_idx, A.values, x, **geo), y)
    walk = ("one thread" if geo["subgroup"] == 1
            else f"{geo['subgroup']} lanes")
    say(f"[kernels] spmv_ell ({walk} a row) repeated bitwise equal: {same}")
    if not same:
        fail("spmv_ell is not deterministic across runs")
    crow = torch.from_numpy(A_host["indptr"]).to("cuda")
    A_csr = torch.sparse_csr_tensor(
        crow, torch.from_numpy(A_host["indices"]).to("cuda"),
        torch.from_numpy(A_host["values"]).to("cuda"), size=A.shape)
    xs = x[:, None]
    ell_bytes = m * k * (4 + 4) + A.shape[1] * 4 + m * 4
    out["spmv_ell"] = row(
        "spmv_ell", "spmv_ell.cu", "src/repro/kernels/spmv_ell/kernel.py:53", err,
        lambda: K.spmv_ell(A.col_idx, A.values, x, **geo),
        lambda: K.spmv_ell_plain(A.col_idx, A.values, x),
        ell_bytes, 2 * m * k,
        lambda: torch.sparse.mm(A_csr, xs))

    # spmv_dot_ell — y as spmv_ell (and bitwise spmv_ell's); w.y against the
    # f64 sum, tree_tol; then a ragged m, f64 and the subgroup walk (k = 27)
    held = held_spmv_dot(torch, ex, A.col_idx, A.values, x, w)
    geo_d, err_d = held["geo"], held["err"]
    mr = m - 5
    err_d = max(err_d, held_spmv_dot(
        torch, ex, A.col_idx[:mr], A.values[:mr], x, w[:mr], " (ragged)")["err"])
    err_d = max(err_d, held_spmv_dot(
        torch, ex, A.col_idx, A.values.double(), x.double(), w.double(),
        " (f64)")["err"])
    mw, kw = 262_144, 27
    cw = torch.randint(0, mw, (mw, kw), generator=gen, device="cuda",
                       dtype=torch.int32)
    vw = torch.randn(mw, kw, generator=gen, device="cuda")
    pad = (torch.arange(kw, device="cuda")[None, :]
           >= torch.randint(0, kw + 1, (mw, 1), generator=gen, device="cuda"))
    cw[pad], vw[pad] = 0, 0.0
    held_w = held_spmv_dot(torch, ex, cw, vw, x[:mw], w[:mw], " (k = 27)")
    if held_w["geo"]["subgroup"] == 1:
        fail("spmv_dot_ell at k = 27 did not take the subgroup walk")
    err_d = max(err_d, held_w["err"])
    out["spmv_dot_ell"] = row(
        "spmv_dot_ell", "spmv_dot.cu", "src/repro/kernels/spmv_dot/kernel.py:62",
        err_d,
        lambda: K.spmv_dot_ell(A.col_idx, A.values, x, w, **geo_d),
        lambda: K.spmv_dot_ell_plain(A.col_idx, A.values, x, w),
        ell_bytes + m * 4 + 4, 2 * m * k + 2 * m)

    # axpy_norm at the path's n (16-byte packs), then f64, an n that is not a
    # multiple of the pack (a scalar tail) and the offset view x[1:] (the
    # scalar route)
    from repro_torch.kernels.axpy_norm.kernel import vector_width

    out["axpy_norm"] = row(
        "axpy_norm", "axpy_norm.cu", "src/repro/kernels/axpy_norm/kernel.py:39",
        **held_axpy_norm(torch, ex, x, w))
    for where, xa, wa, want in ((" (f64)", x.double(), w.double(), 2),
                                (" (n = m - 3)", x[:-3], w[:-3], 4),
                                (" (x[1:], unaligned)", x[1:], w[1:], 1)):
        if vector_width(xa, wa) != want:
            fail(f"axpy_norm{where} takes {vector_width(xa, wa)} elements a "
                 f"load, not {want}")
        out["axpy_norm"]["max_abs_err"] = max(
            out["axpy_norm"]["max_abs_err"],
            held_axpy_norm(torch, ex, xa, wa, where)["err"])

    # one kernel a call, and REPEATS back-to-back calls bit for bit, for both
    # and for axpy_norm_rows with its rows in pieces (a ticket per row)
    alpha = torch.tensor(-0.37, device="cuda")
    geo_a = {p: ex.launch_config("axpy_norm", {"n": m, "itemsize": 4})[p]
             for p in ("block_threads", "grid_blocks")}
    Xr = torch.randn(256, 1024, generator=gen, device="cuda")
    Yr = torch.randn(256, 1024, generator=gen, device="cuda")
    ar = torch.randn(256, generator=gen, device="cuda")
    geo_r = {p: ex.launch_config("axpy_norm_rows", {"nb": 256, "n": 1024,
                                                    "itemsize": 4})[p]
             for p in ("block_threads", "grid_blocks")}
    one_pass_checks(torch, {
        "spmv_dot_ell": lambda: K.spmv_dot_ell(A.col_idx, A.values, x, w, **geo_d),
        "axpy_norm": lambda: K.axpy_norm(alpha, x, w, **geo_a),
        "axpy_norm_rows (pieces)": lambda: K.axpy_norm_rows(ar, Xr, Yr, **geo_r),
    })

    # block_jacobi_apply — every (vector, storage) pair at the main path's
    # block count: f32 vectors with f32, bf16 and fp16 blocks, f64 vectors
    # with f64, bf16 and fp16 blocks
    nb, bs = P.num_blocks, P.block_size
    base = torch.cat([t.double() for t in P.inv_blocks])  # main-path blocks
    variants = []
    main_dtype = P.inv_blocks[0].dtype
    for vec in (torch.float32, torch.float64):
        vp = torch.randn(nb, bs, generator=gen, device="cuda", dtype=vec)
        for dtype in (vec, torch.bfloat16, torch.float16):
            variants.append(bj_row(torch, flush, copy_bw, ex,
                                   base.to(vec).to(dtype), vp))
    entry = dict(next(v for v in variants if v["vector"] == "float32" and
                      v["storage"] == str(main_dtype).removeprefix("torch.")))
    entry["storage_variants"] = variants
    out["block_jacobi_apply"] = entry
    # block sizes no path uses, held but not timed: 5 (the general route),
    # 40 and 64 (the wide route: a block's rows over several warps)
    for bs_x in (5, 40, 64):
        for vec, dtype in ((torch.float32, torch.float32),
                           (torch.float64, torch.float16)):
            inv_x = torch.randn(4096, bs_x, bs_x, generator=gen, device="cuda",
                                dtype=torch.float64).to(dtype)
            vp_x = torch.randn(4096, bs_x, generator=gen, device="cuda",
                               dtype=vec)
            held_block_jacobi(torch, ex, inv_x, vp_x, " (no path's block size)")
    return out


def phase_path(torch, A, b):
    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.precond import block_jacobi
    from repro_torch.solvers import Stop, cg

    stop = Stop(**STOP_KW)
    ex = make_executor("cuda")

    # the counted run: the user's call, block-Jacobi generated inside
    torch.cuda.synchronize()
    K.reset_launch_counts()
    ex.dispatch_log.clear()
    t0 = time.perf_counter()
    res = cg(A, b, M="block_jacobi", precond_opts=PRECOND_OPTS, stop=stop,
             executor=ex)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = K.launch_counts()
    by_storage = dict(K.block_jacobi_apply.launches_by_storage)
    log = dict(ex.dispatch_log)

    k = res.iterations
    say(f"[path] iterations {k}, converged {res.converged}, "
        f"recursive residual {float(res.residual_norm):.4e}, "
        f"time to solution {t_total:.4f} s (block-Jacobi setup and symmetry "
        "probe included)")
    if not res.converged:
        fail("the CUDA solve did not converge")
    x = res.x
    if x.shape != b.shape or not bool(torch.isfinite(x).all()):
        fail("solution has the wrong shape or non-finite values")

    # preconditioner alone (setup) and the loop alone, for time per iteration
    t0 = time.perf_counter()
    P = block_jacobi(A, PRECOND_OPTS["block_size"],
                     adaptive=PRECOND_OPTS["adaptive"], executor=ex)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_loop = cg(A, b, M=P, stop=stop, executor=ex, strict=False)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    if res_loop.iterations != k or not bool(torch.equal(res_loop.x, x)):
        fail("a repeated CUDA solve did not reproduce the first bit for bit")
    classes = len(P.inv_blocks)
    say(f"[path] block-Jacobi setup {t_setup:.4f} s; solve loop {t_loop:.4f} s "
        f"= {t_loop / k * 1e3:.4f} ms per iteration; precision_counts "
        f"{P.precision_counts}; storage {P.storage_bytes} bytes")
    say(f"[path] dispatch log {log}")
    say(f"[path] kernel launches {launches}; block_jacobi_apply by storage "
        f"{by_storage}")

    expected = {
        "spmv_ell": 1,  # the initial residual b - A x0
        "spmv_dot_ell": k,
        "axpy_norm": k,
        "block_jacobi_apply": (k + 1) * classes,  # once per class per apply
    }
    for name, want in expected.items():
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
        if launches[name] != want or log.get(name) != want:
            fail(f"{name}: {launches[name]} launches, {log.get(name)} "
                 f"dispatches, expected {want} for {k} iterations")
    # one apply launch per storage class present, per preconditioner apply
    want_storage = {dtype: k + 1 for dtype, _ in P.precision_counts}
    if by_storage != want_storage:
        fail(f"block_jacobi_apply launches by storage {by_storage}, expected "
             f"{want_storage}")

    # true residual with the plain SpMV in f64.  f32 CG stops on its
    # recursive residual; the true one drifts from it by about
    # eps32 * ||A|| ||x|| per step, so f32 cannot promise much below 1e-5.
    rel = true_residual(torch, A, x, b)
    say(f"[path] true relative residual {rel:.4e}")
    if not rel <= 1e-4:
        fail(f"true relative residual {rel} > 1e-4")

    # the same solve in the torch space on the card
    ex_t = make_executor("torch", device="cuda")
    t0 = time.perf_counter()
    res_t = cg(A, b, M="block_jacobi", precond_opts=PRECOND_OPTS, stop=stop,
               executor=ex_t)
    torch.cuda.synchronize()
    t_torch = time.perf_counter() - t0
    dx = float((res_t.x - x).norm() / res_t.x.norm())
    say(f"[path] torch space: iterations {res_t.iterations}, converged "
        f"{res_t.converged}, time to solution {t_torch:.4f} s; relative "
        f"difference of solutions {dx:.3e}")
    if abs(res_t.iterations - k) > 2:
        fail(f"iterations differ: cuda {k}, torch {res_t.iterations}")
    if not dx <= 1e-3:
        fail(f"solutions differ by {dx} > 1e-3 (relative)")
    t0 = time.perf_counter()
    res_tl = cg(A, b, M=P, stop=stop, executor=ex_t, strict=False)
    torch.cuda.synchronize()
    t_torch_loop = time.perf_counter() - t0
    say(f"[path] torch space loop {t_torch_loop:.4f} s = "
        f"{t_torch_loop / res_tl.iterations * 1e3:.4f} ms per iteration")
    profile = phase_profile(torch, A, b, P, ex)
    return launches, by_storage, {"iterations": k, "x": x,
                      "time_to_solution_s": t_total,
                      "setup_s": t_setup, "loop_s": t_loop,
                      "ms_per_iteration": t_loop / k * 1e3,
                      "precision_counts": P.precision_counts,
                      "true_relative_residual": rel,
                      "torch_space_iterations": res_t.iterations,
                      "torch_space_time_to_solution_s": t_torch,
                      "torch_space_ms_per_iteration":
                          t_torch_loop / res_tl.iterations * 1e3,
                      "profile": profile}


def phase_profile(torch, A, b, P, ex, iters: int = 50,
                  tag: str = "profile", named: str = None,
                  pipeline: bool = False) -> dict:
    """Device time by kernel over ``iters`` CG iterations preconditioned by
    ``P`` (torch.profiler; pipelined CG with ``pipeline``), and the device's
    busy share of the window's wall time; with ``named``, also the device
    time of every kernel whose name holds it (``named_us``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.solvers import Stop, cg

    stop = Stop(max_iters=iters, reduction_factor=1e-30)  # runs all iters
    cg(A, b, M=P, stop=stop, executor=ex, strict=False,
       pipeline=pipeline)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cg(A, b, M=P, stop=stop, executor=ex, strict=False, pipeline=pipeline)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): a PyTorch operator's CPU
    # event also carries its kernels' time and would count it twice
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    say(f"[{tag}] {iters} iterations: wall {wall_us:.0f} us, device busy "
        f"{busy:.0f} us ({busy / wall_us:.1%}); per iteration "
        f"{wall_us / iters:.1f} us wall, {busy / iters:.1f} us device")
    for dev, count, key in rows[:16]:
        say(f"[{tag}]   {dev / iters:9.2f} us/iter  {count:6d} calls  {key[:90]}")
    out = {"iterations": iters, "wall_us": wall_us, "device_busy_us": busy,
           "busy_share": busy / wall_us,
           "top": [{"name": key[:120], "calls": count, "us": dev}
                   for dev, count, key in rows[:16]]}
    if named:
        out["named_us"] = sum(dev for dev, _, key in rows if named in key)
    return out


# -- counted runs of the solver phases (4b, 4c, 10) ------------------------------------


def counted(torch, run):
    """``run()`` with every kernel's launch count set to 0 just before it and
    read just after: ``(result, wall s, launches, block_jacobi_apply by
    storage, spmv_ell by value type)``."""
    from repro_torch import kernels as K

    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, wall, K.launch_counts(),
            dict(K.block_jacobi_apply.launches_by_storage),
            dict(K.spmv_ell.launches_by_dtype))


def expect_launches(where: str, launches: dict, want: dict) -> None:
    """Fails unless each kernel in ``want`` was launched exactly that many
    times (at least once) and every other kernel not at all."""
    for name, got in launches.items():
        need = want.get(name, 0)
        if got != need or (name in want and need <= 0):
            fail(f"{where}: {name} launched {got} times, expected {need}")
    say(f"[{where}] kernel launches as expected: "
        f"{ {n: c for n, c in launches.items() if c} }")


def true_residual(torch, A, x, b) -> float:
    """||b - A x|| / ||b|| in f64 with the plain ELL SpMV."""
    from repro_torch import kernels as K

    ax = K.spmv_ell_plain(A.col_idx, A.values.double(), x.double())
    return float((b.double() - ax).norm() / b.double().norm())


def phase_pipelined(torch, host, b32, k_f32: int, us_f32: float):
    """Phase 4b: pipelined CG on phase 4's system in f64 (block-Jacobi 8,
    f64 blocks) through the cuda executor, beside classic CG on the same
    f64 system: convergence, the true residual, iterations within 2 of
    classic CG's (the JAX package's own allowance), the launches exactly
    (before the loop two SpMVs, A x and A u, and one preconditioner apply;
    an iteration one of each), a repeat bit for bit, the torch space on the
    card, and device us an iteration of both loops.  In f32 the pipelined
    recurrences cannot reach Stop(3000, 1e-6) at this size (see PIPE_OPTS)."""
    import numpy as np

    from repro_torch.core import make_executor
    from repro_torch.precond import block_jacobi
    from repro_torch.solvers import Stop, cg
    from repro_torch.sparse import ell_from_csr_host

    ip, ix, v, shape = host
    A = ell_from_csr_host(ip, ix, v.astype(np.float64), shape, device="cuda")
    b = b32.double()
    stop = Stop(**STOP_KW)
    ex = make_executor("cuda")
    P = block_jacobi(A, PIPE_OPTS["block_size"], executor=ex)
    classes = len(P.inv_blocks)
    classic = cg(A, b, M=P, stop=stop, executor=ex, strict=False)
    k_classic = classic.iterations
    res, t_total, launches, by_storage, _ = counted(torch, lambda: cg(
        A, b, M="block_jacobi", precond_opts=PIPE_OPTS, stop=stop,
        executor=ex, pipeline=True))
    k = res.iterations
    rel = true_residual(torch, A, res.x, b)
    rel_c = true_residual(torch, A, classic.x, b)
    say(f"[pipelined] f64: iterations {k} (classic CG {k_classic}; f32 "
        f"classic {k_f32}), converged {res.converged}, true relative residual "
        f"{rel:.4e} (classic {rel_c:.4e}), time to solution {t_total:.4f} s "
        "(setup and symmetry probe included)")
    if not res.converged or not bool(torch.isfinite(res.x).all()):
        fail("pipelined CG did not converge")
    if not rel <= 1e-4:
        fail(f"pipelined CG: true relative residual {rel} > 1e-4")
    if abs(k - k_classic) > 2:
        fail(f"pipelined CG took {k} iterations, classic CG {k_classic}")
    expect_launches("pipelined", launches, {
        "spmv_ell": k + 2, "block_jacobi_apply": (k + 1) * classes})
    again, t_loop, *_ = counted(torch, lambda: cg(
        A, b, M=P, stop=stop, executor=ex, strict=False, pipeline=True))
    if again.iterations != k or not bool(torch.equal(again.x, res.x)):
        fail("a repeated pipelined CG solve differs")
    ex_t = make_executor("torch", device="cuda")
    res_t, t_torch, *_ = counted(torch, lambda: cg(
        A, b, M=P, stop=stop, executor=ex_t, strict=False, pipeline=True))
    dx = float((res_t.x - res.x).norm() / res_t.x.norm())
    say(f"[pipelined] repeat bit for bit; loop {t_loop:.4f} s = "
        f"{t_loop / k * 1e3:.4f} ms an iteration; torch space: "
        f"{res_t.iterations} iterations, {t_torch:.4f} s, solutions differ "
        f"by {dx:.3e}")
    if abs(res_t.iterations - k) > 2 or not dx <= 1e-3:
        fail("pipelined CG: the torch space disagrees with the cuda space")
    profile = phase_profile(torch, A, b, P, ex, tag="profile pipelined",
                            pipeline=True)
    profile_c = phase_profile(torch, A, b, P, ex, tag="profile classic f64")
    say(f"[pipelined] device us an iteration: pipelined f64 "
        f"{profile['device_busy_us'] / profile['iterations']:.1f}, classic "
        f"f64 {profile_c['device_busy_us'] / profile_c['iterations']:.1f}, "
        f"classic f32 (phase 4) {us_f32:.1f}")
    return launches, by_storage, {
        "dtype": "float64", "iterations": k, "classic_iterations": k_classic,
        "true_relative_residual": rel, "classic_true_relative_residual": rel_c,
        "time_to_solution_s": t_total, "loop_s": t_loop,
        "ms_per_iteration": t_loop / k * 1e3,
        "torch_space_iterations": res_t.iterations,
        "torch_space_loop_s": t_torch, "profile": profile,
        "classic_profile": profile_c}


def phase_fcg(torch, A, b):
    """Phase 4c: FCG on phase 4's system (block-Jacobi 8, adaptive) through
    the cuda executor: convergence, the true residual, the launches exactly
    (one SpMV before the loop and one an iteration; one preconditioner
    apply before the loop and one an iteration) and the torch space."""
    from repro_torch.core import make_executor
    from repro_torch.precond import block_jacobi
    from repro_torch.solvers import Stop, fcg

    ex = make_executor("cuda")
    P = block_jacobi(A, PRECOND_OPTS["block_size"],
                     adaptive=PRECOND_OPTS["adaptive"], executor=ex)
    classes = len(P.inv_blocks)
    stop = Stop(**STOP_KW)
    res, wall, launches, by_storage, _ = counted(torch, lambda: fcg(
        A, b, M=P, stop=stop, executor=ex))
    k = res.iterations
    rel = true_residual(torch, A, res.x, b)
    say(f"[fcg] iterations {k}, converged {res.converged}, true relative "
        f"residual {rel:.4e}, {wall:.4f} s ({wall / k * 1e3:.4f} ms an "
        "iteration, symmetry probe included)")
    if not res.converged or not rel <= 1e-4:
        fail("FCG did not converge to a true residual of 1e-4")
    expect_launches("fcg", launches, {
        "spmv_ell": k + 1, "block_jacobi_apply": (k + 1) * classes})
    res_t = fcg(A, b, M=P, stop=stop, executor=make_executor("torch",
                                                             device="cuda"))
    dx = float((res_t.x - res.x).norm() / res_t.x.norm())
    say(f"[fcg] torch space: {res_t.iterations} iterations; solutions differ "
        f"by {dx:.3e}")
    if abs(res_t.iterations - k) > 2 or not dx <= 1e-3:
        fail("FCG: the torch space disagrees with the cuda space")
    return launches, by_storage, {"iterations": k, "true_relative_residual": rel,
                                  "wall_s": wall,
                                  "torch_space_iterations": res_t.iterations}


def _nonsym_solve(torch, tag, A, b, run, run_torch, want, iter_rel,
                  history_hold=None):
    """One counted solve of phase 10 in the cuda space: converged, a true
    residual of at most NONSYM_TRUE_TOL, the launches ``want(k)`` exactly, a
    repeat bit for bit; then the torch space on the card: converged,
    iterations within ``iter_rel`` of the cuda space's, x within 1e-3
    (relative).  With ``history_hold = (n, rtol)`` (both runs made with
    ``history=True``) the two spaces' residual norms also agree within
    ``rtol`` (relative) at each of the first n iterations; the first
    iteration where they part by more than 1e-3 is printed."""
    res, wall, launches, by_storage, _ = counted(torch, run)
    k = res.iterations
    rel = true_residual(torch, A, res.x, b)
    say(f"[krylov] {tag}: iterations {k}, converged {res.converged}, true "
        f"relative residual {rel:.4e}, {wall:.4f} s = {wall / k * 1e3:.4f} ms "
        "an iteration")
    if (not res.converged or not rel <= NONSYM_TRUE_TOL
            or not bool(torch.isfinite(res.x).all())):
        fail(f"{tag} did not converge to a true residual of {NONSYM_TRUE_TOL}")
    expect_launches(f"krylov {tag}", launches, want(k))
    again = run()
    if again.iterations != k or not bool(torch.equal(again.x, res.x)):
        fail(f"{tag}: a repeated solve differs")
    res_t, wall_t, *_ = counted(torch, run_torch)
    dx = float((res_t.x - res.x).norm() / res.x.norm())
    rel_t = true_residual(torch, A, res_t.x, b)
    say(f"[krylov] {tag}: repeat bit for bit; torch space {res_t.iterations} "
        f"iterations, {wall_t:.4f} s, true relative residual {rel_t:.4e}; "
        f"solutions differ by {dx:.3e}")
    if (not res_t.converged or abs(res_t.iterations - k) > iter_rel * k
            or not dx <= 1e-3):
        fail(f"{tag}: the torch space disagrees with the cuda space")
    summary = {
        "iterations": k, "true_relative_residual": rel, "wall_s": wall,
        "ms_per_iteration": wall / k * 1e3,
        "torch_space_iterations": res_t.iterations, "torch_space_wall_s": wall_t,
        "torch_space_true_relative_residual": rel_t, "relative_difference": dx}
    if history_hold is not None:
        n_h, rtol_h = history_hold
        both = min(k, res_t.iterations)
        d = ((res.history[:both] - res_t.history[:both]).abs()
             / res_t.history[:both].abs())
        worst = float(d[:n_h].max())
        far = torch.nonzero(d > 1e-3)
        parted = int(far[0, 0]) if far.numel() else None
        say(f"[krylov] {tag}: residual norms of the two spaces within "
            f"{worst:.3e} (relative) over the first {min(n_h, both)} "
            f"iterations; first parted by 1e-3 at iteration {parted}")
        if not worst <= rtol_h:
            fail(f"{tag}: the spaces' residual norms part by {worst:.3e} within "
                 f"the first {n_h} iterations, past {rtol_h}")
        summary.update(history_max_relative_difference=worst,
                       history_held_iterations=min(n_h, both),
                       history_parted_at=parted)
    return launches, by_storage, summary


def phase_krylov(torch, copy_bw):
    """Phase 10: the nonsymmetric solvers, ParILU and mixed-precision IR at
    sizes users solve (see the module docstring).  Returns the counted
    paths, the summary and block_jacobi_apply held at the adaptive CGS's
    reduced classes."""
    import numpy as np

    from repro_torch.core import make_executor
    from repro_torch.precond import block_jacobi
    from repro_torch.solvers import (CgSolver, Stop, bicgstab, cg, cgs, gmres,
                                     mixed_precision_ir, parilu_preconditioner)
    from repro_torch.sparse import csr_from_arrays, ell_from_csr_host, gallery

    ex = make_executor("cuda")
    ex_t = make_executor("torch", device="cuda")
    paths, out = {}, {}
    t0 = time.perf_counter()
    host = gallery.convection_diffusion_2d(KRYLOV_N_SIDE, **KRYLOV_CONVDIFF)
    A = ell_from_csr_host(*host, device="cuda")
    n = A.shape[0]
    b = torch.from_numpy(np.random.default_rng(SEED).standard_normal(n)
                         .astype(np.float32)).cuda()
    P = block_jacobi(A, PRECOND_OPTS["block_size"],
                     adaptive=PRECOND_OPTS["adaptive"], executor=ex)
    torch.cuda.synchronize()
    classes = len(P.inv_blocks)
    say(f"[krylov] convection_diffusion_2d({KRYLOV_N_SIDE}, {KRYLOV_CONVDIFF}): "
        f"{n} rows, ELL k = {A.max_nnz}, f32; block-Jacobi "
        f"{P.precision_counts}; setup {time.perf_counter() - t0:.2f} s")
    stop = Stop(**STOP_KW)

    # fused BiCGSTAB: spmv_dot_ell with w = r-hat and w = s, axpy_norm last
    paths["bicgstab"] = _nonsym_solve(
        torch, "BiCGSTAB (fused)", A, b,
        lambda: bicgstab(A, b, M=P, stop=stop, executor=ex),
        lambda: bicgstab(A, b, M=P, stop=stop, executor=ex_t),
        lambda k: {"spmv_ell": 1, "spmv_dot_ell": 2 * k, "axpy_norm": k,
                   "block_jacobi_apply": 2 * k * classes}, 0.25)
    out["bicgstab"] = paths["bicgstab"][2]

    # CGS in f64, with f64 block-Jacobi 8: in f32 its squared residual
    # polynomial overflows on this system in both spaces, with block-Jacobi
    # or ParILU (PERF.md §6; launch/precision_probe.py)
    A64 = ell_from_csr_host(host[0], host[1], host[2].astype(np.float64),
                            host[3], device="cuda")
    b64 = b.double()
    P64 = block_jacobi(A64, PRECOND_OPTS["block_size"], executor=ex)
    classes64 = len(P64.inv_blocks)
    paths["cgs"] = _nonsym_solve(
        torch, "CGS (f64)", A64, b64,
        lambda: cgs(A64, b64, M=P64, stop=stop, executor=ex),
        lambda: cgs(A64, b64, M=P64, stop=stop, executor=ex_t),
        lambda k: {"spmv_ell": 1 + 2 * k,
                   "block_jacobi_apply": 2 * k * classes64}, 0.25)
    out["cgs"] = paths["cgs"][2]

    # the same CGS with adaptive block-Jacobi: f64 vectors with bf16 / fp16
    # blocks (ROADMAP C13: the port refused the pair).  Each reduced class
    # is held and timed at this path's blocks first; the solve's launches
    # are kept as "float64/<storage>", apart from the f32 vectors' reduced
    # classes.  Iterations are held as the other runs', and the two spaces'
    # residual norms within 1e-5 over the first 300 iterations, where they
    # still agree: past them CGS parts the spaces by a few per cent of its
    # iterations on these blocks (PERF.md §6; the iteration they part at is
    # printed).
    t0 = time.perf_counter()
    P64a = block_jacobi(A64, PRECOND_OPTS["block_size"], adaptive=True,
                        executor=ex)
    torch.cuda.synchronize()
    classes64a = len(P64a.inv_blocks)
    reduced = [t for t in P64a.inv_blocks if t.dtype != torch.float64]
    say(f"[krylov] CGS (f64, adaptive): block-Jacobi {P64a.precision_counts}, "
        f"{P64a.storage_bytes} bytes (f64 blocks: {P64.storage_bytes}); setup "
        f"{time.perf_counter() - t0:.2f} s")
    if not reduced:
        fail("CGS (f64, adaptive): no block took reduced storage")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    held = {"block_jacobi_apply": [bj_row(
        torch, flush, copy_bw, ex, t,
        torch.randn(t.shape[0], t.shape[1], generator=gen, device="cuda",
                    dtype=torch.float64), " (adaptive CGS path)")
        for t in reduced]}
    launches_a, storage_a, out["cgs_adaptive"] = _nonsym_solve(
        torch, "CGS (f64, adaptive)", A64, b64,
        lambda: cgs(A64, b64, M=P64a, stop=stop, executor=ex, history=True),
        lambda: cgs(A64, b64, M=P64a, stop=stop, executor=ex_t, history=True),
        lambda k: {"spmv_ell": 1 + 2 * k,
                   "block_jacobi_apply": 2 * k * classes64a}, 0.25,
        history_hold=(300, 1e-5))
    k_a = out["cgs_adaptive"]["iterations"]
    want = {str(t.dtype).removeprefix("torch."): 2 * k_a
            for t in P64a.inv_blocks}
    if storage_a != want:
        fail(f"CGS (f64, adaptive): block_jacobi_apply by storage {storage_a}, "
             f"expected {want}")
    paths["cgs_adaptive"] = (launches_a, {
        (d if d == "float64" else f"float64/{d}"): c
        for d, c in storage_a.items()}, None)
    out["cgs_adaptive"].update(precision_counts=P64a.precision_counts,
                               launches_by_storage=storage_a,
                               seconds=time.perf_counter() - t0)
    say(f"[krylov] CGS (f64, adaptive): {out['cgs_adaptive']['seconds']:.1f} s "
        "with its held kernels")
    del A64, b64, P64, P64a, flush

    # GMRES(30): each cycle one SpMV for its residual, m in the Arnoldi
    # steps and one for the new residual, m + 1 preconditioner applies;
    # one SpMV before the first cycle
    m = KRYLOV_RESTART
    gstop = Stop(max_iters=KRYLOV_GMRES_CYCLES * m, reduction_factor=1e-6)
    res, wall, launches, by_storage, _ = counted(torch, lambda: gmres(
        A, b, restart=m, M=P, stop=gstop, executor=ex, history=True))
    cycles = res.iterations // m
    expect_launches("krylov GMRES", launches, {
        "spmv_ell": 1 + cycles * (m + 2),
        "block_jacobi_apply": cycles * (m + 1) * classes})
    hist = res.history[:cycles].double()
    rel = true_residual(torch, A, res.x, b)
    res_t, wall_t, *_ = counted(torch, lambda: gmres(
        A, b, restart=m, M=P, stop=gstop, executor=ex_t, history=True))
    hist_t = res_t.history[:cycles].double()
    d_res = float((hist - hist_t).abs().max() / hist_t.abs().max())
    prof = _device_profile(torch, lambda: gmres(
        A, b, restart=m, M=P, stop=Stop(2 * m, 1e-30), executor=ex),
        "GMRES(30), 2 cycles", 2, "cycle", tag="profile krylov")
    say(f"[krylov] GMRES({m}): {cycles} cycles ({res.iterations} iterations), "
        f"converged {res.converged}, true relative residual {rel:.4e}, "
        f"{wall:.4f} s = {wall / cycles * 1e3:.2f} ms wall a cycle; residual "
        f"by cycle {hist[0].item():.4e} .. {hist[-1].item():.4e}; torch space "
        f"{res_t.iterations} iterations, {wall_t / cycles * 1e3:.2f} ms a "
        f"cycle, residuals within {d_res:.3e}")
    if not bool(torch.isfinite(res.x).all()) or not bool(
            (hist[1:] <= hist[:-1] * (1 + 1e-3)).all()) or not hist[-1] < hist[0]:
        fail("GMRES: the residual is not decreasing cycle by cycle")
    if res_t.iterations != res.iterations or not d_res <= 1e-3:
        fail("GMRES: the torch space disagrees with the cuda space")
    again = gmres(A, b, restart=m, M=P, stop=gstop, executor=ex)
    if not bool(torch.equal(again.x, res.x)):
        fail("GMRES: a repeated solve differs")
    paths["gmres"] = (launches, by_storage, None)
    out["gmres"] = {"iterations": res.iterations, "cycles": cycles,
                    "converged": res.converged, "true_relative_residual": rel,
                    "wall_s": wall, "ms_per_cycle": wall / cycles * 1e3,
                    "torch_space_ms_per_cycle": wall_t / cycles * 1e3,
                    "residual_by_cycle": [float(h) for h in hist],
                    "profile": prof}

    # ParILU-preconditioned BiCGSTAB: setup on the host from the CSR form
    t0 = time.perf_counter()
    Mp = parilu_preconditioner(csr_from_arrays(*host, device="cuda"))
    torch.cuda.synchronize()
    t_parilu = time.perf_counter() - t0
    say(f"[krylov] ParILU setup and factorisation {t_parilu:.2f} s "
        f"({Mp.storage_bytes} bytes)")
    paths["parilu_bicgstab"] = _nonsym_solve(
        torch, "BiCGSTAB + ParILU", A, b,
        lambda: bicgstab(A, b, M=Mp, stop=stop, executor=ex),
        lambda: bicgstab(A, b, M=Mp, stop=stop, executor=ex_t),
        lambda k: {"spmv_ell": 1, "spmv_dot_ell": 2 * k, "axpy_norm": k}, 0.25)
    out["parilu_bicgstab"] = dict(paths["parilu_bicgstab"][2],
                                  setup_s=t_parilu,
                                  block_jacobi_iterations=out["bicgstab"]["iterations"])
    prof_b = _device_profile(torch, lambda: bicgstab(
        A, b, M=P, stop=Stop(50, 1e-30), executor=ex),
        "BiCGSTAB + block-Jacobi, 50 iterations", 50, "iteration",
        tag="profile krylov")
    out["bicgstab"]["profile"] = prof_b
    del A, b, P, Mp

    # mixed-precision IR: poisson_3d(128) in f64, an f32 inner CgSolver
    ip, ix, v, shape = gallery.poisson_3d(N_SIDE)
    A64 = ell_from_csr_host(ip, ix, v.astype(np.float64), shape, device="cuda")
    b64 = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        shape[0])).cuda()
    inner, solvers = [], []

    class Recorded(CgSolver):
        """The inner CG, recording each solve's iterations."""

        def solve(self, r, x0=None, *, executor=None):
            got = super().solve(r, x0, executor=executor)
            inner.append(got.iterations)
            solvers.append(self)
            return got

    res, wall, launches, by_storage, by_dtype = counted(torch, lambda: (
        mixed_precision_ir(A64, b64, stop=Stop(**IR_STOP), executor=ex,
                           inner_solver=Recorded,
                           inner_opts={"M": "block_jacobi",
                                       "precond_opts": PRECOND_OPTS})))
    k, k_in = res.iterations, sum(inner)
    rel = true_residual(torch, A64, res.x, b64)
    P32 = solvers[0].M  # the inner solver's block-Jacobi, on A in f32
    classes = len(P32.inv_blocks)
    expect_launches("krylov IR", launches, {
        "spmv_ell": 1 + 2 * k, "spmv_dot_ell": k_in, "axpy_norm": k_in,
        "block_jacobi_apply": (k_in + len(inner)) * classes})
    if by_dtype != {"float64": 1 + k, "float32": k}:
        fail(f"IR: spmv_ell launches by type {by_dtype}, expected f64 "
             f"{1 + k}, f32 {k}")
    A32 = A64.astype(torch.float32)
    pure = cg(A32, b64.float(), M=P32, stop=Stop(IR_F32_ITERS, 1e-12),
              executor=ex, strict=False)
    rel32 = true_residual(torch, A64, pure.x, b64)
    say(f"[krylov] mixed-precision IR: {k} outer sweeps, inner iterations "
        f"{inner}, converged {res.converged}, f64 true relative residual "
        f"{rel:.4e} (pure f32 CG after {pure.iterations} iterations: "
        f"{rel32:.4e}); {wall:.4f} s; spmv_ell by type {by_dtype}")
    if not res.converged or not rel < 1e-9 or not rel < 0.1 * rel32:
        fail("mixed-precision IR did not reach the f64 tolerance")
    if res.x.dtype != torch.float64:
        fail("mixed-precision IR returned another dtype than f64")
    paths["mixed_ir"] = (launches, by_storage, None)
    out["mixed_ir"] = {"outer_sweeps": k, "inner_iterations": inner,
                       "true_relative_residual": rel,
                       "pure_f32_true_relative_residual": rel32,
                       "wall_s": wall, "spmv_ell_by_dtype": by_dtype}
    return {name: (p[0], p[1]) for name, p in paths.items()}, out, held


class SpanTotals:
    """A tracer for ``repro_torch.observability.trace``: sums the host time
    of spans by name (the registry's dispatch events are not kept)."""

    def __init__(self):
        self.us = collections.Counter()

    def rel_us(self, t: float) -> float:
        return t * 1e6

    def complete(self, name, ts_us, dur_us, cat="span", args=None) -> None:
        if cat != "dispatch":
            self.us[name] += dur_us


def phase_amg(torch, copy_bw):
    """The AMG path: ``amg_check`` on poisson_2d(1024) through the CUDA
    executor (counted), its launch counts against the hierarchy, the true
    residual, the setup split, the loops alone, the same path in the torch
    space on the card, and the kernels held at this path's shapes: spmv_ell
    on every level operator, axpy_norm and block_jacobi_apply at the outer
    CG's and the baseline's operands, the two SpGEMM kernels at level 0."""
    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.launch.amg_check import run_amg_check
    from repro_torch.observability import trace
    from repro_torch.precond import make_preconditioner
    from repro_torch.solvers import Stop, cg
    from repro_torch.sparse import ops

    ex = make_executor("cuda")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    r = run_amg_check(AMG_N_SIDE, executor=ex, **AMG_KW)
    launches = K.launch_counts()
    by_storage = dict(K.block_jacobi_apply.launches_by_storage)
    if not r.ok:
        fail("AMG-GATE failed on the card")
    M, A, b = r.M, r.A, r.b
    nlev = len(M.levels)  # coarsened levels: num_levels - 1
    k_amg, k_bj = r.amg.iterations, r.block_jacobi.iterations
    say(f"[amg] hierarchy: {M.num_levels} levels; rows/nnz per level "
        + ", ".join(f"{L.A.shape[0]}/{L.A.nnz}" for L in M.levels)
        + f", coarse {M.coarse_A.shape[0]}/{M.coarse_A.nnz}; operator "
        f"complexity {M.operator_complexity:.4f}")
    say(f"[amg] launches by phase {r.launches}")
    say(f"[amg] dispatches by phase {r.dispatches}")

    # launch counts the hierarchy implies: per coarsened level three SpGEMMs
    # (A.T, A.P, R.(AP)) and one transpose (R = P^T); per V(1,1)-cycle five
    # ELL SpMVs per coarsened level (A.x in the pre-sweep, the residual
    # before restriction, R, P, A.x in the post-sweep), one cycle per
    # preconditioner apply and CG applies it k + 1 times; the fused CG body
    # launches axpy_norm once per iteration; block-Jacobi applies once per
    # storage class per apply
    classes = len(r.M_bj.inv_blocks)
    expected = {
        ("amg_setup", "spgemm_expand"): 3 * nlev,
        ("amg_setup", "csr_permute"): nlev,
        ("amg_solve", "spmv_ell"): 5 * nlev * (k_amg + 1),
        ("amg_solve", "axpy_norm"): k_amg,
        ("block_jacobi_solve", "axpy_norm"): k_bj,
        ("block_jacobi_solve", "block_jacobi_apply"): (k_bj + 1) * classes,
    }
    for (ph, name), want in expected.items():
        got = r.launches[ph][name]
        if got != want:
            fail(f"{name} launched {got} times in {ph}, expected {want}")
    for name in ("spgemm_expand", "csr_permute", "spmv_ell", "axpy_norm",
                 "block_jacobi_apply"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the AMG path")
    # the baseline applies each storage class once per preconditioner apply;
    # the AMG hierarchy's Jacobi smoother launches no block_jacobi_apply
    want_storage = {dtype: k_bj + 1 for dtype, _ in r.M_bj.precision_counts}
    say(f"[amg] block_jacobi_apply launches by storage {by_storage}")
    if by_storage != want_storage:
        fail(f"block_jacobi_apply launches by storage {by_storage}, expected "
             f"{want_storage}")

    # true residual of the AMG solution, f64 plain CSR SpMV
    x = r.amg.x
    if x.shape != b.shape or not bool(torch.isfinite(x).all()):
        fail("AMG solution has the wrong shape or non-finite values")
    rows = torch.repeat_interleave(
        torch.arange(A.shape[0], device="cuda"),
        (A.indptr[1:] - A.indptr[:-1]).long())
    ax = torch.zeros(A.shape[0], dtype=torch.float64, device="cuda").index_add_(
        0, rows, A.values.double() * x.double()[A.indices.long()])
    rel = float((b.double() - ax).norm() / b.double().norm())
    say(f"[amg] true relative residual {rel:.4e}")
    if not rel <= 1e-4:
        fail(f"AMG true relative residual {rel} > 1e-4")

    # the loops alone (no symmetry probe) for the time per iteration, each
    # within 2 iterations of the checked solve; the AMG-CG loop twice with
    # the run's preconditioner, the two bitwise equal: every sum on the path
    # has a fixed order (the outer CG's CSR SpMV is a segment sum, no
    # atomics)
    stop = Stop(max_iters=AMG_KW["max_iters"], reduction_factor=AMG_KW["tol"])

    def time_loops(run, exe):
        """(seconds, iterations) of each solve's loop alone."""
        out = {}
        for name, P, res in (("amg", run.M, run.amg),
                             ("block_jacobi", run.M_bj, run.block_jacobi)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = cg(run.A, run.b, stop=stop, M=P, executor=exe, strict=False)
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0, again.iterations)
            if not again.converged or abs(again.iterations - res.iterations) > 2:
                fail(f"a repeated {name} CG solve took {again.iterations} "
                     f"iterations against {res.iterations}")
            if name == "amg":
                third = cg(run.A, run.b, stop=stop, M=P, executor=exe,
                           strict=False)
                same = (third.iterations == again.iterations
                        and torch.equal(third.x, again.x))
                say(f"[amg] {exe.kernel_space} space: a repeated AMG-CG solve "
                    f"({again.iterations} iterations) bitwise equal: {same}")
                if not same:
                    fail(f"a repeated AMG-CG solve in the {exe.kernel_space} "
                         "space is not bitwise equal to the one before")
        return out

    loops = time_loops(r, ex)
    sec = r.seconds
    summary = {
        "levels": M.num_levels,
        "rows": [L.A.shape[0] for L in M.levels] + [M.coarse_A.shape[0]],
        "nnz": [L.A.nnz for L in M.levels] + [M.coarse_A.nnz],
        "operator_complexity": M.operator_complexity,
        "true_relative_residual": rel,
        "seconds": sec,
    }
    for name, res, setup_key, solve_key in (
            ("amg", r.amg, "amg_setup", "amg_solve"),
            ("block_jacobi", r.block_jacobi, "block_jacobi_setup",
             "block_jacobi_solve")):
        k = res.iterations
        tts = sec[setup_key] + sec[solve_key]
        loop_s, loop_k = loops[name]
        summary[name] = {"iterations": k, "converged": res.converged,
                         "time_to_solution_s": tts, "loop_s": loop_s,
                         "ms_per_iteration": loop_s / loop_k * 1e3}
        say(f"[amg] {name}-cg: {k} iterations, converged {res.converged}, "
            f"time to solution {tts:.4f} s (setup {sec[setup_key]:.4f}, solve "
            f"{sec[solve_key]:.4f} with the symmetry probe); loop alone "
            f"{loop_s:.4f} s for {loop_k} iterations = "
            f"{loop_s / loop_k * 1e3:.4f} ms per iteration")

    # the setup split: a second AMG setup under a span tracer
    totals = SpanTotals()
    trace.set_tracer(totals)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        make_preconditioner(A, "amg", executor=ex, cycle=AMG_KW["cycle"],
                            theta=AMG_KW["theta"])
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    finally:
        trace.set_tracer(None)
    us = totals.us
    split = {
        "aggregation": us["amg.aggregate"],
        "structure_passes": us["spgemm.structure"] + us["spgemm.coalesce"]
        + us["sptranspose.structure"],
        "numeric_passes": us["spgemm.numeric"] + us["sptranspose.numeric"],
        "coarse_inverse": us["amg.coarse_solver"],
    }
    split = {key: v / 1e6 for key, v in split.items()}
    split["rest"] = us["amg.setup"] / 1e6 - sum(split.values())
    split["total"] = traced_s
    summary["setup_split_s"] = split
    say(f"[amg] setup split (second setup, host clock, s): "
        + ", ".join(f"{key} {v:.4f}" for key, v in split.items())
        + " — numeric passes are the kernels with their index upload and the "
        "products' download; rest is the ELL mirrors, P's smoothing sum and "
        "host copies")

    # the same path in the torch space on the card: no kernel launches, the
    # same hierarchy bit for bit, iterations within 2, x within 1e-3
    ex_t = make_executor("torch", device="cuda")
    before = K.launch_counts()
    rt = run_amg_check(AMG_N_SIDE, executor=ex_t, **AMG_KW)
    if K.launch_counts() != before:
        fail("the torch space launched a port kernel")
    Mt = rt.M
    def same_csr(X, Y) -> bool:
        return all(torch.equal(getattr(X, f), getattr(Y, f))
                   for f in ("indptr", "indices", "values"))

    if Mt.num_levels != M.num_levels or not all(
            same_csr(getattr(L, f), getattr(Lt, f))
            for L, Lt in zip(M.levels, Mt.levels) for f in ("A", "P", "R")) \
            or not same_csr(M.coarse_A, Mt.coarse_A):
        fail("the torch-space hierarchy differs from the cuda-space one")
    dx = float((rt.amg.x - x).norm() / rt.amg.x.norm())
    say(f"[amg] torch space on the card: hierarchy bitwise equal; amg-cg "
        f"{rt.amg.iterations} iterations (cuda {k_amg}), block_jacobi-cg "
        f"{rt.block_jacobi.iterations} (cuda {k_bj}); relative difference of "
        f"the AMG solutions {dx:.3e}; setup {rt.seconds['amg_setup']:.4f} s, "
        f"AMG solve {rt.seconds['amg_solve']:.4f} s")
    if abs(rt.amg.iterations - k_amg) > 2 or not dx <= 1e-3:
        fail("the torch-space AMG solve disagrees with the cuda-space one")
    loops_t = time_loops(rt, ex_t)
    say("[amg] torch space loops alone: " + ", ".join(
        f"{name} {sec_:.4f} s for {k} iterations = {sec_ / k * 1e3:.4f} ms per "
        f"iteration" for name, (sec_, k) in loops_t.items()))
    summary["torch_space"] = {
        "amg_iterations": rt.amg.iterations,
        "block_jacobi_iterations": rt.block_jacobi.iterations,
        "seconds": rt.seconds, "x_relative_difference": dx,
        "ms_per_iteration": {name: sec_ / k * 1e3
                             for name, (sec_, k) in loops_t.items()}}
    summary["profile"] = phase_profile(torch, A, b, M, ex, iters=k_amg,
                                       tag="profile amg", named="spmv_ell")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    row = functools.partial(kernel_row, torch, flush, copy_bw)

    # spmv_ell at every operator the V-cycle applies (A, P, R per level,
    # k from 4 to about 100): against its plain version, tolerance as in
    # phase 3 (8 k eps relative to max_i sum_j |a_ij x_j|), and timed with
    # CSR torch.sparse.mm as library; then the V(1,1) cycle's sum, each
    # operator weighted by its ELL SpMVs a cycle (A 3, P 1, R 1)
    eps = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = 0.0
    levels = []
    weight = {"A": 3, "P": 1, "R": 1}
    for lvl, L in enumerate(M.levels):
        for name, E, C in (("A", L.A_op, L.A), ("P", L.P_op, L.P),
                           ("R", L.R_op, L.R)):
            m, k = E.values.shape
            xv = torch.randn(E.shape[1], generator=gen, device="cuda")
            cfg = ex.launch_config("spmv_ell", {"m": m, "k": k, "itemsize": 4})
            geo_l = dict(block_threads=cfg["block_threads"],
                         subgroup=cfg["subgroup"])
            y = K.spmv_ell(E.col_idx, E.values, xv, **geo_l)
            y_ref = K.spmv_ell_plain(E.col_idx, E.values, xv)
            sc = float(K.spmv_ell_plain(E.col_idx, E.values.abs(), xv.abs()).max())
            err = float((y - y_ref).abs().max())
            if not err <= 8 * k * eps * sc:
                fail(f"spmv_ell disagrees with its plain version on level {lvl} "
                     f"{name} ({m}x{E.shape[1]}, k = {k}): {err}")
            worst = max(worst, err / sc if sc else err)
            C_t = torch.sparse_csr_tensor(C.indptr.to(torch.int32),
                                          C.indices.to(torch.int32), C.values,
                                          size=C.shape)
            say(f"[kernels] spmv_ell at level {lvl} {name}: {m} x {E.shape[1]}, "
                f"k = {k}, subgroup {geo_l['subgroup']}")
            entry = row(
                "spmv_ell", "spmv_ell.cu", "src/repro/kernels/spmv_ell/kernel.py:53",
                err,
                lambda E=E, xv=xv, geo_l=geo_l: K.spmv_ell(E.col_idx, E.values,
                                                           xv, **geo_l),
                lambda E=E, xv=xv: K.spmv_ell_plain(E.col_idx, E.values, xv),
                m * k * 8 + E.shape[1] * 4 + m * 4, 2 * m * k,
                lambda C_t=C_t, xs=xv[:, None]: torch.sparse.mm(C_t, xs))
            entry.update(operator=f"level {lvl} {name}", level=lvl,
                         shape={"m": m, "n": E.shape[1], "k": k},
                         subgroup=geo_l["subgroup"], per_v_cycle=weight[name])
            levels.append(entry)
    say(f"[kernels] spmv_ell on the {3 * nlev} AMG level operators: largest "
        f"error {worst:.3e} relative to the row magnitudes (each within 8 k eps)")
    prof_us = summary["profile"]["named_us"] / k_amg
    v_cycle = {key: sum(e["per_v_cycle"] * e[key] for e in levels)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                           "copy_bound_ms")}
    v_cycle.update(launches=sum(e["per_v_cycle"] for e in levels),
                   profile_us_per_iteration=prof_us)
    say(f"[kernels] spmv_ell per V(1,1) cycle ({v_cycle['launches']} launches): "
        f"{v_cycle['ms']:.4f} ms (plain {v_cycle['plain_ms']:.4f}, CSR "
        f"torch.sparse.mm {v_cycle['library_ms']:.4f}, bound "
        f"{v_cycle['bound_ms']:.4f}); under the profiler {prof_us:.2f} us an "
        f"AMG-CG iteration")
    ell_levels = {"operators": levels, "v_cycle": v_cycle,
                  "max_abs_err": max(e["max_abs_err"] for e in levels)}

    # axpy_norm at the outer CG's vectors (n rows) and block_jacobi_apply at
    # the baseline's blocks, each storage class: as in phase 3
    xv = torch.randn(A.shape[0], generator=gen, device="cuda")
    wv = torch.randn(A.shape[0], generator=gen, device="cuda")
    held = {"axpy_norm": [row(
        "axpy_norm", "axpy_norm.cu", "src/repro/kernels/axpy_norm/kernel.py:39",
        **held_axpy_norm(torch, ex, xv, wv, " (AMG path)"))],
        "block_jacobi_apply": []}
    bs = r.M_bj.block_size
    for inv in r.M_bj.inv_blocks:
        vp = torch.randn(inv.shape[0], bs, generator=gen, device="cuda")
        held["block_jacobi_apply"].append(bj_row(
            torch, flush, copy_bw, ex, inv, vp, " (AMG path)"))

    # the two kernels at level 0's shapes: R.(AP) and P^T
    L0 = M.levels[0]
    AP = ops.spgemm(A, L0.P, executor=ex_t)
    _, _, _, idx1, _ = ops._spgemm_expansion(L0.R, AP)
    idx = torch.from_numpy(idx1).cuda()
    a_vals = L0.R.values
    b_pad = torch.cat([AP.values.new_zeros(1), AP.values])
    bt = ex.launch_config("spgemm", {})["block_threads"]
    out = K.spgemm_expand(a_vals, idx, b_pad, block_threads=bt)
    ref = K.spgemm_expand_plain(a_vals, idx, b_pad)
    err = float((out - ref).abs().max())
    say(f"[kernels] spgemm_expand at R.(AP) of level 0: T = {idx.shape[0]}, "
        f"K = {idx.shape[1]}, nnz(AP) = {AP.nnz}; bitwise equal to the plain "
        f"version: {torch.equal(out, ref)}")
    if not torch.equal(out, ref):
        fail(f"spgemm_expand differs from its plain version (max {err})")
    t, kw = idx.shape
    gathered = int(torch.unique(idx).numel()) * 4
    say("[kernels] spgemm_expand library_ms: null — no single PyTorch call "
        "computes the padded (T, K) expansion (a sparse product coalesces)")
    rows_out = {"spgemm_expand": row(
        "spgemm_expand", "spgemm.cu", "src/repro/kernels/spgemm/kernel.py:46",
        err, lambda: K.spgemm_expand(a_vals, idx, b_pad, block_threads=bt),
        lambda: K.spgemm_expand_plain(a_vals, idx, b_pad),
        4 * t + 8 * t * kw + gathered, t * kw)}
    rows_out["spgemm_expand"]["shape"] = {"T": t, "K": kw}

    # csr_permute on the transpose of every level's P (AMG setup's R = P^T),
    # bitwise; level 0's P^T timed as the row (with its CUPTI time), every
    # level's time beside it
    def permute_held(vals, order, label):
        out = K.csr_permute(vals, order, block_threads=bt)
        same = torch.equal(out, K.csr_permute_plain(vals, order.long()))
        say(f"[kernels] csr_permute at {label}: nnz = {order.numel()}, "
            f"{str(vals.dtype).removeprefix('torch.')}; bitwise equal to the "
            f"plain version: {same}")
        if not same:
            fail(f"csr_permute differs from its plain version at {label}")

    at_levels = []
    for lvl, L in enumerate(M.levels):
        order_np, _, _ = ops._transpose_structure(L.P)
        order = torch.from_numpy(order_np.astype("int32")).cuda()
        vals = L.P.values
        permute_held(vals, order, f"P^T of level {lvl}")
        entry = row("csr_permute", "spgemm.cu",
                    "src/repro/kernels/spgemm/kernel.py:92", 0.0,
                    lambda v=vals, o=order: K.csr_permute(v, o,
                                                          block_threads=bt),
                    lambda v=vals, o=order: K.csr_permute_plain(v, o),
                    12 * order.numel(), 0,
                    lambda v=vals, o=order: torch.index_select(v, 0, o),
                    cupti=lvl == 0)
        entry["shape"] = {"nnz": order.numel(), "level": lvl}
        at_levels.append(entry)
        if lvl == 0:
            order0, vals0 = order, vals
    # level 0's order less its last 3 entries (a count of 4 k + 1 here: a
    # scalar tail), both arrays as views 4 bytes past a 16-byte boundary (the
    # scalar route), f64
    nnz = order0.numel()
    permute_held(vals0, order0[:-3], "level 0's P^T, a ragged count")
    obuf = torch.empty(nnz + 1, dtype=torch.int32, device="cuda")
    obuf[1:] = order0
    vbuf = torch.empty(nnz + 1, dtype=vals0.dtype, device="cuda")
    vbuf[1:] = vals0
    permute_held(vbuf[1:], obuf[1:], "level 0's P^T, offset views")
    permute_held(vals0.double(), order0, "level 0's P^T, f64")
    rows_out["csr_permute"] = dict(at_levels[0], at_levels=at_levels[1:])
    return launches, by_storage, summary, rows_out, held, ell_levels


def phase_sellp(torch, copy_bw):
    """The SELL-P path: Jacobi-CG on power_law_laplacian(2**21, seed=4) as
    SELL-P through the CUDA executor (counted), then its checks, the torch
    space on the card, the loop's profile, and spmv_sellp held and timed at
    this matrix."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.solvers import Stop, cg, jacobi_preconditioner
    from repro_torch.sparse import gallery, sellp_from_csr_host

    t0 = time.perf_counter()
    ip, ix, v, shape = gallery.power_law_laplacian(SELLP_N, seed=SELLP_SEED)
    t_gallery = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = sellp_from_csr_host(ip, ix, v, shape, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    m = shape[0]
    row_nnz = np.diff(ip)
    ell_entries = m * int(row_nnz.max())
    say(f"[sellp] power_law_laplacian({m}, seed={SELLP_SEED}): {ix.size} "
        f"nonzeros, longest row {int(row_nnz.max())}; gallery {t_gallery:.2f} s, "
        f"SELL-P build {t_build:.2f} s")
    say(f"[sellp] storage: SELL-P {A.nnz} entries ({A.memory_bytes} bytes, C = "
        f"{A.slice_size}, stride {A.stride_factor}, widest slice "
        f"{A.max_slice_cols}); ELL would store {ell_entries} entries "
        f"({ell_entries * 8} bytes)")
    b = torch.from_numpy(np.random.default_rng(SEED).standard_normal(m)
                         .astype(np.float32)).cuda()
    stop = Stop(**STOP_KW)
    ex = make_executor("cuda")

    torch.cuda.synchronize()
    K.reset_launch_counts()
    ex.dispatch_log.clear()
    t0 = time.perf_counter()
    res = cg(A, b, M="jacobi", stop=stop, executor=ex)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = K.launch_counts()
    log = dict(ex.dispatch_log)
    k = res.iterations
    say(f"[sellp] cuda: iterations {k}, converged {res.converged}, time to "
        f"solution {t_total:.4f} s (Jacobi setup and symmetry probe included)")
    say(f"[sellp] kernel launches {launches}; dispatch log {log}")
    if not res.converged:
        fail("the SELL-P CG solve did not converge")
    x = res.x
    if x.shape != b.shape or not bool(torch.isfinite(x).all()):
        fail("SELL-P solution has the wrong shape or non-finite values")
    # SELL-P has no fused SpMV: the unfused loop applies A once for the
    # initial residual and once per iteration; the symmetry probe runs in
    # host numpy and launches nothing
    want = k + 1
    if launches["spmv_sellp"] != want or log.get("spmv_sellp") != want:
        fail(f"spmv_sellp: {launches['spmv_sellp']} launches, "
             f"{log.get('spmv_sellp')} dispatches, expected {want}")
    others = {n: c for n, c in launches.items() if c and n != "spmv_sellp"}
    if others:
        fail(f"the SELL-P path launched other kernels: {others}")

    ax = K.spmv_sellp_plain(A.col_idx, A.values.double(), A.slice_sets,
                            x.double(), m, A.slice_size)
    rel = float((b.double() - ax).norm() / b.double().norm())
    say(f"[sellp] true relative residual {rel:.4e}")
    if not rel <= 1e-4:
        fail(f"SELL-P true relative residual {rel} > 1e-4")

    # the loop alone, twice: the repeat must be bitwise equal (no atomics
    # on the cuda path: spmv_sellp writes each row once)
    P = jacobi_preconditioner(A, executor=ex)
    loops = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = cg(A, b, M=P, stop=stop, executor=ex, strict=False)
        torch.cuda.synchronize()
        loops.append(time.perf_counter() - t0)
        if again.iterations != k or not torch.equal(again.x, x):
            fail("a repeated SELL-P CG solve did not reproduce the first bit "
                 "for bit")
    t_loop = min(loops)
    say(f"[sellp] loop alone {t_loop:.4f} s = {t_loop / k * 1e3:.4f} ms per "
        f"iteration (repeat bitwise equal)")

    ex_t = make_executor("torch", device="cuda")
    t0 = time.perf_counter()
    res_t = cg(A, b, M="jacobi", stop=stop, executor=ex_t)
    torch.cuda.synchronize()
    t_torch = time.perf_counter() - t0
    Pt = jacobi_preconditioner(A, executor=ex_t)
    t0 = time.perf_counter()
    res_tl = cg(A, b, M=Pt, stop=stop, executor=ex_t, strict=False)
    torch.cuda.synchronize()
    t_torch_loop = time.perf_counter() - t0
    # the torch space sums each slice in a fixed order (a segment sum, no
    # atomics): a repeat is bitwise equal
    res_tl2 = cg(A, b, M=Pt, stop=stop, executor=ex_t, strict=False)
    same = (res_tl2.iterations == res_tl.iterations
            and torch.equal(res_tl2.x, res_tl.x))
    say(f"[sellp] torch space: a repeated solve bitwise equal: {same}")
    if not same:
        fail("a repeated torch-space SELL-P CG solve is not bitwise equal")
    dx = float((res_t.x - x).norm() / res_t.x.norm())
    say(f"[sellp] torch space: iterations {res_t.iterations}, time to solution "
        f"{t_torch:.4f} s, loop alone {t_torch_loop:.4f} s = "
        f"{t_torch_loop / res_tl.iterations * 1e3:.4f} ms per iteration; "
        f"relative difference of solutions {dx:.3e}")
    if abs(res_t.iterations - k) > 2 or not dx <= 1e-3:
        fail(f"torch-space SELL-P solve disagrees: {res_t.iterations} "
             f"iterations against {k}, x differs by {dx}")
    profile = phase_profile(torch, A, b, P, ex, iters=k, tag="profile sellp")

    # spmv_sellp at this matrix against its plain version, per row within
    # 2 (w + 1) eps of the row's magnitude (w its slice's width: both sums
    # round at most w times)
    eps = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    xv = torch.randn(m, generator=gen, device="cuda")
    C = A.slice_size
    cfg = ex.launch_config("spmv_sellp", {"m": m, "slice_size": C, "itemsize": 4})
    geo = dict(block_threads=cfg["block_threads"], wide_cols=cfg["wide_cols"])
    args = (A.col_idx, A.values, A.slice_sets, xv, m, C)
    y = K.spmv_sellp(*args, **geo)
    y_ref = K.spmv_sellp_plain(*args)
    mag = K.spmv_sellp_plain(A.col_idx, A.values.abs(), A.slice_sets,
                             xv.abs(), m, C)
    width = A.slice_cols.repeat_interleave(C)[:m].to(mag.dtype)
    err_rows = (y - y_ref).abs()
    ratio = float((err_rows / (2 * (width + 1) * eps * mag).clamp_min(1e-30)).max())
    err = float(err_rows.max())
    say(f"[kernels] spmv_sellp: max_abs_err {err:.3e}; largest error "
        f"{ratio:.3f} of its row's tolerance; shared memory "
        f"{cfg.smem_bytes} bytes a block")
    if not ratio <= 1.0:
        fail(f"spmv_sellp disagrees with its plain version ({ratio} of the "
             "per-row tolerance)")
    # the same matrix with C = 32 (one lane a row of the warp walk) and
    # C = 12 (not dividing 32: a thread a row), held alike, repeats bitwise
    held_at = {}
    for Cx in (32, 12):
        Ax = sellp_from_csr_host(ip, ix, v, shape, slice_size=Cx, device="cuda")
        cfg_x = ex.launch_config("spmv_sellp", {"m": m, "slice_size": Cx,
                                                "itemsize": 4})
        geo_x = dict(block_threads=cfg_x["block_threads"],
                     wide_cols=cfg_x["wide_cols"])
        args_x = (Ax.col_idx, Ax.values, Ax.slice_sets, xv, m, Cx)
        y_x = K.spmv_sellp(*args_x, **geo_x)
        same = torch.equal(y_x, K.spmv_sellp(*args_x, **geo_x))
        mag_x = K.spmv_sellp_plain(Ax.col_idx, Ax.values.abs(), Ax.slice_sets,
                                   xv.abs(), m, Cx)
        width_x = Ax.slice_cols.repeat_interleave(Cx)[:m].to(mag_x.dtype)
        err_x = (y_x - K.spmv_sellp_plain(*args_x)).abs()
        ratio_x = float((err_x / (2 * (width_x + 1) * eps * mag_x)
                         .clamp_min(1e-30)).max())
        held_at[f"C{Cx}"] = {"stored": Ax.nnz, "max_abs_err": float(err_x.max()),
                             "tolerance_share": ratio_x, **geo_x}
        say(f"[kernels] spmv_sellp at C = {Cx} ({Ax.nnz} stored): max_abs_err "
            f"{float(err_x.max()):.3e}, largest error {ratio_x:.3f} of its "
            f"row's tolerance; repeat bitwise equal: {same}")
        if not ratio_x <= 1.0 or not same:
            fail(f"spmv_sellp at C = {Cx} disagrees with its plain version or "
                 "does not repeat")
        err = max(err, float(err_x.max()))
        del Ax, y_x, mag_x, width_x, err_x
    A_csr = torch.sparse_csr_tensor(
        torch.from_numpy(ip.astype(np.int32)).cuda(),
        torch.from_numpy(ix).cuda(), torch.from_numpy(v).cuda(), size=shape)
    xs = xv[:, None]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    total = A.nnz
    row = kernel_row(
        torch, flush, copy_bw, "spmv_sellp", "spmv_sellp.cu",
        "src/repro/kernels/spmv_sellp/kernel.py:67", err,
        lambda: K.spmv_sellp(*args, **geo),
        lambda: K.spmv_sellp_plain(*args),
        total * 8 + A.slice_sets.numel() * 4 + 2 * m * 4, 2 * total,
        lambda: torch.sparse.mm(A_csr, xs))
    row["shape"] = {"m": m, "stored": total, "nnz": int(ix.size),
                    "widest_slice": A.max_slice_cols, **geo}
    row["held_at"] = held_at
    summary = {"rows": m, "nnz": int(ix.size), "sellp_entries": total,
               "ell_entries": ell_entries, "iterations": k,
               "time_to_solution_s": t_total, "loop_s": t_loop,
               "ms_per_iteration": t_loop / k * 1e3,
               "true_relative_residual": rel,
               "torch_space_iterations": res_t.iterations,
               "torch_space_time_to_solution_s": t_torch,
               "torch_space_ms_per_iteration":
                   t_torch_loop / res_tl.iterations * 1e3,
               "profile": profile}
    return launches, summary, {"spmv_sellp": row}


def _batch_checks(torch, label, res, xstar, launches, want, res_t):
    """One batched run's checks: every system converged, the error against
    the known solutions, the kernels' launches, and the torch-space run on
    the card (per-system iterations within 1, x within 1e-4)."""
    import numpy as np

    it = res.iterations.cpu().numpy()
    err = float(np.abs(res.x.cpu().numpy() - xstar).max())
    sweeps = int(it.max())
    say(f"[batch] {label}: {res.num_batch} systems, iterations "
        f"{it.min()}/{int(np.median(it))}/{sweeps} (min/median/max), error "
        f"{err:.3e}; launches {({n: c for n, c in launches.items() if c})}")
    if not bool(res.converged.all()):
        fail(f"{label}: not every system converged")
    if not err <= 1e-4:
        fail(f"{label}: error against the known solutions {err} > 1e-4")
    for name, count in want(sweeps).items():
        if launches[name] != count:
            fail(f"{label}: {name} launched {launches[name]} times, expected "
                 f"{count} for {sweeps} sweeps")
    others = {n: c for n, c in launches.items() if c and n not in want(sweeps)}
    if others:
        fail(f"{label}: unexpected kernel launches {others}")
    it_t = res_t.iterations.cpu().numpy()
    dx = float((res_t.x - res.x).abs().max())
    say(f"[batch] {label}, torch space on the card: largest iteration "
        f"difference {int(np.abs(it_t - it).max())}, largest x difference "
        f"{dx:.3e}")
    if np.abs(it_t - it).max() > 1 or not dx <= 1e-4:
        fail(f"{label}: the torch space disagrees with the cuda space")
    return sweeps, err


def _chunked_equal(torch, A, B, M, solver, ex, stop) -> int:
    """Advance the run in 4-sweep chunks and monolithically; fail unless the
    two end bit for bit equal.  Returns the number of chunks."""
    from repro_torch import batch as tb

    thresh = stop.threshold(tb.batch_norm2(B, executor=ex))
    X0 = torch.zeros_like(B)
    if solver == "cg":
        init = lambda: tb.batch_cg_init(A, B, X0, M=M, executor=ex)  # noqa: E731
        adv = functools.partial(tb.batch_cg_advance, A, stop=stop, M=M,
                                executor=ex)
    else:
        init = lambda: tb.batch_bicgstab_init(A, B, X0, executor=ex)  # noqa: E731
        adv = functools.partial(tb.batch_bicgstab_advance, A, stop=stop, M=M,
                                executor=ex)
    mono = adv(init(), thresh)
    state, chunks = init(), 0
    while True:
        nxt = adv(state, thresh, num_sweeps=4)
        if nxt.k == state.k:
            break
        state, chunks = nxt, chunks + 1
    if state.k != mono.k or not all(
            torch.equal(getattr(state, f), getattr(mono, f))
            for f in ("X", "R", "P", "iters", "rnorm")):
        fail(f"batched {solver}: the 4-sweep chunked run differs from the "
             "monolithic one")
    return chunks


def phase_batch(torch, copy_bw):
    """The batched path: batch_solve's CG runs (no preconditioner, Jacobi),
    batch_cg with block-Jacobi and batch_solve's BiCGSTAB run, each counted
    from 0 and checked; then the kernels held and timed at its shapes."""
    from repro_torch import batch as tb
    from repro_torch import kernels as K
    from repro_torch.kernels.axpy_norm.kernel import rows_chunks
    from repro_torch.launch import batch_solve

    launches_total = collections.Counter()
    storage_total = collections.Counter()
    summary = {}

    def counted(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = K.launch_counts()
        launches_total.update(counts)
        storage_total.update(K.block_jacobi_apply.launches_by_storage)
        return out, counts, seconds

    def torch_space(argv):
        return batch_solve.run(argv + ["--executor", "torch"]).result

    # spmv_batch_ell's launches by operator shape: the CG runs' and BiCGSTAB's
    by_shape = collections.Counter()

    # CG through the entry point, no preconditioner and Jacobi: one SpMV for the
    # initial residual and one per sweep, one fused update per sweep
    cg_want = lambda s: {"spmv_batch_ell": s + 1, "axpy_norm_rows": s}  # noqa: E731
    for precond in ("none", "jacobi"):
        argv = BATCH_ARGS + ["--precond", precond]
        r, counts, seconds = counted(lambda: batch_solve.run(argv))
        if not r.ok or counts != r.launches:
            fail(f"batch_solve {argv} failed or miscounted")
        sweeps, err = _batch_checks(torch, f"cg/{precond}", r.result, r.xstar,
                                    counts, cg_want, torch_space(argv))
        by_shape["cg"] += counts["spmv_batch_ell"]
        M = (tb.batch_jacobi_preconditioner(r.A, executor=r.executor)
             if precond == "jacobi" else None)
        chunks = _chunked_equal(torch, r.A, r.B, M, "cg", r.executor, r.stop)
        say(f"[batch] cg/{precond}: solve {r.seconds:.4f} s for {sweeps} "
            f"sweeps (whole run {seconds:.4f} s, host build included); "
            f"{chunks} chunks of 4 sweeps bit for bit equal to the monolithic "
            "run")
        summary[f"cg_{precond}"] = {"sweeps": sweeps, "error": err,
                                    "seconds": r.seconds,
                                    "run_seconds": seconds}
    A, B, xstar, ex, stop = r.A, r.B, r.xstar, r.executor, r.stop

    # batch_cg with 8-row block-Jacobi: block_jacobi_apply once per apply
    def bj_solve(exe):
        M = tb.batch_block_jacobi_preconditioner(A, 8, executor=exe)
        return M, tb.batch_cg(A, B, M=M, stop=stop, executor=exe)

    (Mbj, res), counts, seconds = counted(lambda: bj_solve(ex))
    bj_storage = dict(K.block_jacobi_apply.launches_by_storage)
    from repro_torch.core import make_executor
    ex_t = make_executor("torch", device="cuda")
    res_t = bj_solve(ex_t)[1]
    sweeps, err = _batch_checks(
        torch, "cg/block_jacobi", res, xstar, counts,
        lambda s: {"spmv_batch_ell": s + 1, "axpy_norm_rows": s,
                   "block_jacobi_apply": s + 1}, res_t)
    by_shape["cg"] += counts["spmv_batch_ell"]
    if bj_storage != {"float32": sweeps + 1}:
        fail(f"block_jacobi_apply by storage {bj_storage}, expected "
             f"{{'float32': {sweeps + 1}}}")
    chunks = _chunked_equal(torch, A, B, Mbj, "cg", ex, stop)
    say(f"[batch] cg/block_jacobi: setup and solve {seconds:.4f} s for "
        f"{sweeps} sweeps, {Mbj.precision_counts}; {chunks} chunks bit for "
        "bit equal")
    summary["cg_block_jacobi"] = {"sweeps": sweeps, "error": err,
                                  "seconds": seconds}

    # BiCGSTAB through the entry point: two SpMVs per sweep
    r, counts, seconds = counted(lambda: batch_solve.run(BATCH_BICGSTAB_ARGS))
    if not r.ok or counts != r.launches:
        fail("batch_solve (bicgstab) failed or miscounted")
    sweeps, err = _batch_checks(
        torch, "bicgstab", r.result, r.xstar, counts,
        lambda s: {"spmv_batch_ell": 2 * s + 1, "axpy_norm_rows": s},
        torch_space(BATCH_BICGSTAB_ARGS))
    by_shape["bicgstab"] += counts["spmv_batch_ell"]
    A_bi = r.A
    chunks = _chunked_equal(torch, r.A, r.B, None, "bicgstab", r.executor,
                            r.stop)
    say(f"[batch] bicgstab: solve {r.seconds:.4f} s for {sweeps} sweeps; "
        f"{chunks} chunks bit for bit equal")
    summary["bicgstab"] = {"sweeps": sweeps, "error": err, "seconds": r.seconds}
    summary["profile"] = phase_batch_profile(torch, A, B, stop, ex)

    # the kernels at this path's shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    nb, m, k = A.values.shape
    n = A.shape[1]
    X = torch.randn(nb, n, generator=gen, device="cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    row = functools.partial(kernel_row, torch, flush, copy_bw)
    rows = {"spmv_batch_ell": row(
        "spmv_batch_ell", "spmv_batch_ell.cu",
        "src/repro/kernels/spmv_batch_ell/kernel.py:51",
        **held_batch_ell(torch, ex, A.col_idx, A.values, X), cupti=True)}
    rows["spmv_batch_ell"]["shape"] = {"nb": nb, "m": m, "k": k}
    # and at the BiCGSTAB run's operator, whose k = n = 64 rows take the
    # wide route
    X_bi = torch.randn(A_bi.values.shape[0], A_bi.shape[1], generator=gen,
                       device="cuda")
    at_bi = row("spmv_batch_ell", "spmv_batch_ell.cu",
                "src/repro/kernels/spmv_batch_ell/kernel.py:51",
                **held_batch_ell(torch, ex, A_bi.col_idx, A_bi.values, X_bi,
                                 " (bicgstab)"), cupti=True)
    at_bi["shape"] = dict(zip(("nb", "m", "k"), A_bi.values.shape))
    rows["spmv_batch_ell"]["at_bicgstab_shape"] = at_bi
    # the CG runs' operator on the wide route too (2 lanes a row)
    wide_cg = held_batch_ell(torch, ex, A.col_idx, A.values, X,
                             " (CG shape, wide route)", subgroup=2,
                             library=False)
    cases = [{"case": "CG shape, wide route", "subgroup": 2,
              "max_abs_err": wide_cg["err"]}]
    cases += batch_ell_cases(torch, ex, gen)
    rows["spmv_batch_ell"]["held_cases"] = cases
    rows["spmv_batch_ell"]["launches_by_shape"] = {
        f"cg {nb} x {m}, k = {k}": by_shape["cg"],
        "bicgstab {} x {}, k = {}".format(*A_bi.values.shape): by_shape["bicgstab"]}
    say(f"[batch] spmv_batch_ell launches by shape "
        f"{rows['spmv_batch_ell']['launches_by_shape']}")
    if sum(by_shape.values()) != launches_total["spmv_batch_ell"]:
        fail("spmv_batch_ell's launches by shape do not add up to the path's")
    rows["spmv_batch_ell"]["max_abs_err"] = max(
        [rows["spmv_batch_ell"]["max_abs_err"], at_bi["max_abs_err"]]
        + [c["max_abs_err"] for c in cases])

    # row-batched axpy_norm at the CG runs' (nb, n), where each row is one
    # block, and at (256, 1024), where each row is cut into pieces whose
    # partials the row's last block adds (a ticket per row)
    rows["axpy_norm_rows"] = row(
        "axpy_norm_rows", "axpy_norm.cu",
        "src/repro/kernels/axpy_norm/kernel.py:39",
        **held_axpy_norm_rows(torch, ex, X, B, gen))
    rows["axpy_norm_rows"]["shape"] = {"nb": nb, "n": n}
    cfg = ex.launch_config("axpy_norm_rows", {"nb": 256, "n": 1024, "itemsize": 4})
    if rows_chunks(256, 1024, cfg["block_threads"], cfg["grid_blocks"]) < 2:
        fail("axpy_norm_rows keeps 256 x 1024 rows whole: its piece sum is "
             "not held")
    Xs = torch.randn(256, 1024, generator=gen, device="cuda")
    Ys = torch.randn(256, 1024, generator=gen, device="cuda")
    at_pieces = row("axpy_norm_rows", "axpy_norm.cu",
                    "src/repro/kernels/axpy_norm/kernel.py:39",
                    **held_axpy_norm_rows(torch, ex, Xs, Ys, gen, " (pieces)"))
    at_pieces["shape"] = {"nb": 256, "n": 1024}
    rows["axpy_norm_rows"]["at_row_pieces_shape"] = at_pieces
    rows["axpy_norm_rows"]["max_abs_err"] = max(
        rows["axpy_norm_rows"]["max_abs_err"], at_pieces["max_abs_err"])
    say("[kernels] axpy_norm_rows library_ms: null — no single PyTorch call "
        "writes Z = alpha X + Y and each row's Z.Z (a norm call needs Z first)")

    # block_jacobi_apply at the block-Jacobi run's blocks (f32, 8 x 8)
    inv = Mbj.inv_blocks[0]
    vp = torch.randn(inv.shape[0], inv.shape[1], generator=gen, device="cuda")
    held = {"block_jacobi_apply": [bj_row(torch, flush, copy_bw, ex, inv, vp,
                                          " (batch path)")]}
    return dict(launches_total), dict(storage_total), summary, rows, held


def phase_batch_profile(torch, A, B, stop, ex) -> dict:
    """Device time by kernel over one batched CG solve (torch.profiler) and
    the device's busy share of its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import batch as tb

    tb.batch_cg(A, B, stop=stop, executor=ex)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = tb.batch_cg(A, B, stop=stop, executor=ex)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    sweeps = int(res.iterations.max())
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    say(f"[profile batch] batched CG, {sweeps} sweeps: wall {wall_us:.0f} us, "
        f"device busy {busy:.0f} us ({busy / wall_us:.1%}); per sweep "
        f"{wall_us / sweeps:.1f} us wall, {busy / sweeps:.1f} us device")
    for dev, count, key in rows[:12]:
        say(f"[profile batch]   {dev / sweeps:9.2f} us/sweep  {count:6d} calls  "
            f"{key[:90]}")
    return {"sweeps": sweeps, "wall_us": wall_us, "device_busy_us": busy,
            "top": [{"name": key[:120], "calls": count, "us": dev}
                    for dev, count, key in rows[:12]]}


def phase_small_reference(torch) -> None:
    """A small solve in the cuda space against the port's reference space on
    the CPU: iterations within 1, solutions within 1e-4 (relative)."""
    import numpy as np

    from repro_torch.core import make_executor
    from repro_torch.solvers import Stop, cg
    from repro_torch.sparse import ell_from_csr_host, gallery

    ip, ix, v, shape = gallery.poisson_2d(16)
    b = np.random.default_rng(SEED).standard_normal(shape[0]).astype(np.float32)
    stop = Stop(max_iters=500, reduction_factor=1e-6)
    got = cg(ell_from_csr_host(ip, ix, v, shape, device="cuda"),
             torch.from_numpy(b).cuda(), M="block_jacobi", stop=stop,
             precond_opts={"block_size": 8}, executor=make_executor("cuda"))
    want = cg(ell_from_csr_host(ip, ix, v, shape, device="cpu"),
              torch.from_numpy(b), M="block_jacobi", stop=stop,
              precond_opts={"block_size": 8}, executor=make_executor("reference"))
    dx = float((got.x.cpu() - want.x).norm() / want.x.norm())
    say(f"[small] poisson_2d(16): cuda {got.iterations} iterations, reference "
        f"{want.iterations}; relative difference {dx:.3e}")
    if abs(got.iterations - want.iterations) > 1 or not dx <= 1e-4:
        fail("the small cuda solve disagrees with the reference space")


# -- phase 8: Zamba2-2.7B serving -----------------------------------------------------


def _rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _lm_counts(torch, K, want: dict, where: str) -> dict:
    """The LM kernels' launches since the last reset, held to ``want``."""
    counts = {n: K.launch_counts()[n] for n in LM_KERNELS}
    if counts != want:
        fail(f"{where}: LM kernel launches {counts}, expected {want}")
    return counts


def _device_profile(torch, run, label: str, per: int, unit: str,
                    tag: str = "profile lm") -> dict:
    """Device time by kernel over ``run()`` (torch.profiler) and the device's
    busy share of its wall time; ``per`` divides the totals (steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: an operator's CPU event also carries its
    # kernels' time and would count it twice
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    say(f"[{tag}] {label}: wall {wall_us:.0f} us, device busy {busy:.0f} us "
        f"({busy / wall_us:.1%}); per {unit} {wall_us / per:.1f} us wall, "
        f"{busy / per:.1f} us device")
    for dev, count, key in rows[:12]:
        say(f"[{tag}]   {dev / per:10.2f} us/{unit}  {count:6d} calls  "
            f"{key[:90]}")
    return {unit + "s": per, "wall_us": wall_us, "device_busy_us": busy,
            "busy_share": busy / wall_us,
            "top": [{"name": key[:120], "calls": count, "us": dev}
                    for dev, count, key in rows[:12]]}


def _held(torch, name, got, want, tol_rel, tol_abs) -> float:
    """Holds ``got`` to ``want`` elementwise within tol_rel |want| + tol_abs
    max |want|; returns max |got - want|."""
    diff = (got.float() - want.float()).abs()
    bound = tol_rel * want.float().abs() + tol_abs * float(want.float().abs().max())
    worst = float((diff / bound).max())
    err = float(diff.max())
    say(f"[kernels] {name}: max_abs_err {err:.3e}; largest error {worst:.3f} of "
        f"its tolerance ({tol_rel:.2e} |plain| + {tol_abs:.0e} max |plain|)")
    if not worst <= 1.0 or not _finite(torch, got):
        fail(f"{name} disagrees with its plain version")
    return err


def _finite(torch, t) -> bool:
    return bool(torch.isfinite(t.float()).all())


def phase_lm_kernels(torch, copy_bw) -> dict:
    """The three LM kernels at the serving path's shapes against their plain
    versions, timed (phase 3's protocol), with their bounds."""
    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.core.params import H100
    from repro_torch.kernels.flash_attention.kernel import flash_tile_plan

    ex = make_executor("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    row = functools.partial(kernel_row, torch, flush, copy_bw)
    bf16 = torch.bfloat16
    B, S = LM_BATCH, LM_PROMPT
    out = {}

    # rmsnorm: the shared block's norms (d = 5,120) and the final norm (2,560)
    # over B * S rows, bf16 x and f32 scale.  Both sides round one f32 result
    # to bf16: one bf16 ulp (2^-7 relative) apart at most, plus f32 order.
    # The prefill's B * S rows, then a decode step's B rows (where most
    # launches run); a repeat at the path's shape is bitwise equal.
    held = {}
    for rows in (B * S, B):
        for d in (2 * 2560, 2560):
            x = torch.randn(rows, d, generator=gen, device="cuda").to(bf16)
            w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
            rpb = ex.launch_config("nn_rmsnorm", {"rows": rows, "d": d,
                                                  "itemsize": 2})["rows_per_block"]
            y = K.rmsnorm(x, w, 1e-5, rows_per_block=rpb)
            err = _held(torch, f"rmsnorm at {rows} x {d}", y,
                        K.rmsnorm_plain(x, w, 1e-5), 2.0 ** -7, 1e-6)
            if (rows, d) == (B * S, 5120):
                same = torch.equal(K.rmsnorm(x, w, 1e-5, rows_per_block=rpb), y)
                say(f"[kernels] rmsnorm at {rows} x {d} repeated bitwise equal: "
                    f"{same}")
                if not same:
                    fail("rmsnorm is not deterministic across runs")
            w_lib = w.to(bf16)
            held[rows, d] = row(
                "rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:27",
                err, lambda: K.rmsnorm(x, w, 1e-5, rows_per_block=rpb),
                lambda: K.rmsnorm_plain(x, w, 1e-5),
                2 * rows * d * 2 + d * 4, 4 * rows * d,
                lambda: torch.nn.functional.rms_norm(x, (d,), w_lib, 1e-5))
            held[rows, d]["shape"] = {"rows": rows, "d": d}
            del x
    out["rmsnorm"] = held[B * S, 5120]
    out["rmsnorm"]["at_final_norm_shape"] = held[B * S, 2560]
    out["rmsnorm"]["at_decode_shape"] = [held[B, 5120], held[B, 2560]]
    out["rmsnorm"]["max_abs_err"] = max(e["max_abs_err"] for e in held.values())
    say("[kernels] rmsnorm library_ms: torch.nn.functional.rms_norm with the "
        "scale cast to bf16 (it takes one dtype)")

    # flash_attention at the path's shape, then GQA, offset, fp16, ragged
    # (S = Skv = 2,000: no multiple of the 128-query or 64-key tile) and f32
    # cases.  bf16 and fp16: one bf16 output ulp plus f32 softmax order (fp16
    # rounds finer, the tolerance is the same); f32: 1e-5 of max |out|.  A
    # repeat at the path's shape is bitwise equal.
    def qkv(Bq, Hq, Hkv, Sq, Skv, D, dtype):
        return (torch.randn(Bq, Hq, Sq, D, generator=gen, device="cuda").to(dtype),
                torch.randn(Bq, Hkv, Skv, D, generator=gen, device="cuda").to(dtype),
                torch.randn(Bq, Hkv, Skv, D, generator=gen, device="cuda").to(dtype))

    H, D = 32, 160
    bkv = ex.launch_config("nn_attention", {"S": S, "Skv": S, "D": D,
                                            "itemsize": 2})["block_kv"]
    q, k, v = qkv(B, H, H, S, S, D, bf16)
    o = K.flash_attention(q, k, v)
    errs = [_held(torch, f"flash_attention at B {B}, H {H}, S = Skv = {S}, D {D}",
                  o, K.flash_attention_plain(q, k, v), 2.0 ** -7, 1e-5)]
    same = torch.equal(o, K.flash_attention(q, k, v))
    say(f"[kernels] flash_attention: repeat bitwise equal: {same}; shared "
        f"memory {flash_tile_plan(D)} at D = {D}")
    if not same:
        fail("a repeated flash_attention is not bitwise equal")
    del o
    shapes = {}
    for label, args, tol in (
            ("gqa", (2, 32, 8, S, S, 128, bf16), (2.0 ** -7, 1e-5)),
            ("offset", (2, 32, 32, S // 2, S, D, bf16), (2.0 ** -7, 1e-5)),
            ("fp16", (2, 32, 32, S, S, D, torch.float16), (2.0 ** -7, 1e-5)),
            ("ragged", (2, 32, 32, 2000, 2000, D, bf16), (2.0 ** -7, 1e-5)),
            ("f32", (2, 32, 32, 512, 512, D, torch.float32), (0.0, 1e-5))):
        qq, kk, vv = qkv(*args)
        errs.append(_held(torch, f"flash_attention {label} {args[:6]}",
                          K.flash_attention(qq, kk, vv),
                          K.flash_attention_plain(qq, kk, vv), *tol))
        shapes[label] = dict(zip(("B", "Hq", "Hkv", "S", "Skv", "D"), args[:6]),
                             dtype=str(args[6]).removeprefix("torch."),
                             max_abs_err=errs[-1])
        del qq, kk, vv
    pairs = S * (S + 1) // 2  # causal (query, key) pairs of one head
    out["flash_attention"] = row(
        "flash_attention", "flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:118", max(errs),
        lambda: K.flash_attention(q, k, v),
        lambda: K.flash_attention_plain(q, k, v),
        4 * B * H * S * D * 2, 4 * D * B * H * pairs,
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True),
        peak_flops=H100.peak_flops_bf16)
    out["flash_attention"]["shape"] = {"B": B, "Hq": H, "Hkv": H, "S": S,
                                       "Skv": S, "D": D, "block_kv": bkv}
    out["flash_attention"]["held_at"] = shapes
    say("[kernels] flash_attention library_ms: "
        "F.scaled_dot_product_attention(is_causal=True), S = Skv")
    del q, k, v

    # ssd_scan at the path's shape: y within one bf16 ulp plus 1e-4 of max |y|
    # (chunk sums in another order, split products), the f32 state within
    # 1e-4 of its max; x, B and C are strided views of one conv output, as
    # mamba_forward hands them over, and must give the contiguous copies'
    # result bit for bit; a repeat is bitwise equal.  Then a strong decay,
    # a ragged tail, f32 (CUDA-core kernel, 1e-4 of max |y| alone), a
    # narrow shape (G = 1, P = N = 32: partial tiles) and bf16 at
    # P = N = 12, which the tensor-core kernel does not take (the CUDA-core
    # kernel in bf16).
    from repro_torch.kernels.ssd.kernel import ssd_tensor_cores

    Hs, P, G, N = 80, 64, 2, 64

    def ssd_inputs(Bq, Sq, Hq, Pq, Gq, Nq, dtype, dt_shift=-1.0, a_mul=1.0):
        conv = torch.randn(Bq, Sq, Hq * Pq + 2 * Gq * Nq, generator=gen,
                           device="cuda")
        conv[..., Hq * Pq:] *= 0.3
        xv, Bv, Cv = torch.split(conv.to(dtype), [Hq * Pq, Gq * Nq, Gq * Nq],
                                 dim=-1)
        dt = torch.nn.functional.softplus(
            torch.randn(Bq, Sq, Hq, generator=gen, device="cuda") + dt_shift)
        A = -a_mul * torch.exp(0.5 * torch.randn(Hq, generator=gen, device="cuda"))
        return (xv.reshape(Bq, Sq, Hq, Pq), dt, A, Bv.reshape(Bq, Sq, Gq, Nq),
                Cv.reshape(Bq, Sq, Gq, Nq))

    def ssd_held(label, args):
        tol = 2.0 ** -7 if args[0].dtype != torch.float32 else 0.0
        y, h = K.ssd_scan(*args)
        yp, hp = K.ssd_scan_plain(*args)
        return max(_held(torch, f"ssd_scan y {label}", y, yp, tol, 1e-4),
                   _held(torch, f"ssd_scan final state {label}", h, hp, 0.0, 1e-4))

    views = ssd_inputs(B, S, Hs, P, G, N, bf16)
    assert not views[0].is_contiguous()
    x, dt, A, Bm, Cm = (t.contiguous() for t in views)
    errs = [ssd_held(f"at B {B}, S {S}, H {Hs}, P {P}, G {G}, N {N}",
                     (x, dt, A, Bm, Cm))]
    y1, h1 = K.ssd_scan(*views)
    y2, h2 = K.ssd_scan(x, dt, A, Bm, Cm)
    y3, h3 = K.ssd_scan(x, dt, A, Bm, Cm)
    same_views = torch.equal(y1, y2) and torch.equal(h1, h2)
    same = torch.equal(y2, y3) and torch.equal(h2, h3)
    say(f"[kernels] ssd_scan: strided views bitwise equal to contiguous: "
        f"{same_views}; repeat bitwise equal: {same}")
    if not (same_views and same):
        fail("ssd_scan: strided views or a repeat are not bitwise equal")
    del y1, h1, y2, h2, y3, h3, views
    ssd_shapes = {}
    for label, shape, kw in (
            ("strong_decay", (2, S, 8, P, G, N, bf16), {"dt_shift": 2.0,
                                                         "a_mul": 8.0}),
            ("ragged_tail", (2, S - 4, 8, P, G, N, bf16), {}),
            ("f32", (2, 300, 8, P, G, N, torch.float32), {}),
            ("narrow", (2, S, 8, 32, 1, 32, bf16), {}),
            ("cuda_core_bf16", (2, 300, 8, 12, 2, 12, bf16), {})):
        case = ssd_inputs(*shape, **kw)
        tc = ssd_tensor_cores(case[0], case[3], case[4])
        if tc != (shape[6] == bf16 and label != "cuda_core_bf16"):
            fail(f"ssd_scan {label}: the tensor-core route is {tc}")
        errs.append(ssd_held(f"{label} {shape[:6]}", case))
        ssd_shapes[label] = dict(zip(("B", "S", "H", "P", "G", "N"), shape[:6]),
                                 dtype=str(shape[6]).removeprefix("torch."),
                                 **kw, route="mma.sync" if tc else "cuda cores",
                                 max_abs_err=errs[-1])
        del case
    L = 64
    chunks = -(-S // L)
    flops = 2 * L * (L * N + L * P + 2 * N * P) * B * Hs * chunks
    nbytes = (2 * B * S * Hs * P * 2 + B * S * Hs * 4 + 2 * B * S * G * N * 2
              + Hs * 4 + B * Hs * N * P * 4)
    out["ssd_scan"] = row(
        "ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd/kernel.py:98", max(errs),
        lambda: K.ssd_scan(x, dt, A, Bm, Cm),
        lambda: K.ssd_scan_plain(x, dt, A, Bm, Cm), nbytes, flops,
        peak_flops=H100.peak_flops_bf16)
    out["ssd_scan"]["shape"] = {"B": B, "S": S, "H": Hs, "P": P, "G": G, "N": N,
                                "chunk": L}
    out["ssd_scan"]["held_at"] = ssd_shapes
    say("[kernels] ssd_scan library_ms: null — no single PyTorch call computes "
        "the SSD scan")
    return out


def phase_lm(torch, copy_bw):
    """Zamba2-2.7B serving at full width and depth (bf16) through
    ``repro_torch.launch.serve`` on the CUDA executor, then the checks."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import make_executor
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm

    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    G = cfg.n_layers // cfg.shared_attn_every
    per_step = {"rmsnorm": 2 * G + 1, "flash_attention": 0, "ssd_scan": 0}
    per_prefill = {"rmsnorm": 2 * G + 1, "flash_attention": G,
                   "ssd_scan": cfg.n_layers}
    ex = make_executor("cuda")
    ex_t = make_executor("torch", device=dev)
    B, S, gen_len = LM_BATCH, LM_PROMPT, LM_GEN
    summary = {"arch": cfg.name, "batch": B, "prompt_len": S, "gen_len": gen_len}

    t0 = time.perf_counter()
    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    summary["init_s"] = time.perf_counter() - t0
    summary["params"] = n_params
    say(f"[lm] {cfg.name}: {cfg.n_layers} Mamba2 layers, d_model {cfg.d_model}, "
        f"shared block at {2 * cfg.d_model} every {cfg.shared_attn_every}; "
        f"{n_params} parameters ({n_params * 2 / 1e9:.3f} GB bf16), init "
        f"{summary['init_s']:.2f} s")

    # (a) the counted run: the user's entry point
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    res = serve_lib.serve(cfg, batch=B, prompt_len=S, gen_len=gen_len,
                          seed=SEED, executor=ex, device=dev, params=params)
    launches = K.launch_counts()
    want = {n: per_prefill[n] + (gen_len - 1) * per_step[n] for n in LM_KERNELS}
    for name in K.KERNELS:
        if launches[name] != want.get(name, 0):
            fail(f"serve: {name} launched {launches[name]} times, expected "
                 f"{want.get(name, 0)}")
    if res.tokens.shape != (B, gen_len) or not (
            0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab):
        fail(f"serve produced tokens of shape {tuple(res.tokens.shape)} or out "
             "of the vocabulary")
    if not _finite(torch, res.prefill_logits) or not all(
            _finite(torch, lg) for lg in res.step_logits):
        fail("serve produced non-finite logits")
    decode_ms = res.decode_s / (gen_len - 1) * 1e3
    summary.update(prefill_ms=res.prefill_s * 1e3, decode_ms_per_step=decode_ms,
                   decode_tokens_per_s=res.tokens_per_s,
                   prefill_tokens_per_s=B * S / res.prefill_s,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches={n: launches[n] for n in LM_KERNELS})
    say(f"[lm] (a) serve {B} x {S} + {gen_len} greedy tokens: prefill "
        f"{res.prefill_s * 1e3:.1f} ms ({B * S / res.prefill_s:.0f} tokens/s), "
        f"decode {decode_ms:.2f} ms per step ({res.tokens_per_s:.1f} tokens/s); "
        f"peak memory {summary['peak_memory_gb']:.2f} GB; launches "
        f"{summary['launches']}")

    # (d) cache and state offsets: prefill(S - 4) + 4 decode steps against the
    # full prefill, each stage counted; then the decode profile continues
    cache = lm.init_cache(cfg, B, S + 8, device=dev)
    K.reset_launch_counts()
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.prefill(params, cfg, res.prompt[:, :S - 4], cache=cache, executor=ex)
        torch.cuda.synchronize()
        summary["warm_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        _lm_counts(torch, K, per_prefill, "prefill")
        say(f"[lm] warm prefill of {B} x {S - 4} tokens: "
            f"{summary['warm_prefill_ms']:.1f} ms (the serve call's prefill "
            "is the process's first)")
        for j in range(4):
            K.reset_launch_counts()
            logits, cache = lm.decode_step(
                params, cfg, res.prompt[:, S - 4 + j:S - 3 + j],
                length=S - 4 + j, cache=cache, executor=ex)
            _lm_counts(torch, K, per_step, f"decode step {j}")
        err_d = _rel_err(logits[:, -1], res.prefill_logits)
        say(f"[lm] (d) prefill({S - 4}) + 4 decode steps against prefill({S}): "
            f"error {err_d:.3e} of max |logit| (tolerance {LM_BF16_TOL})")
        if not err_d <= LM_BF16_TOL:
            fail("the cache / state offsets disagree with the full prefill")
        summary["offsets_error"] = err_d

        def decode4(tokens=res.tokens[:, 0]):
            for j in range(4):
                logits, _ = lm.decode_step(params, cfg, tokens[:, None],
                                           length=S + j, cache=cache,
                                           executor=ex)
                tokens = torch.argmax(logits[:, -1], dim=-1)

        summary["profile_decode"] = _device_profile(
            torch, decode4, "4 decode steps", 4, "step")
        del cache
        cache_p = lm.init_cache(cfg, B, S, device=dev)
        summary["profile_prefill"] = _device_profile(
            torch, lambda: lm.prefill(params, cfg, res.prompt, cache=cache_p,
                                      executor=ex),
            f"prefill of {B} x {S}", 1, "prefill")
        del cache_p

        # (b) the same path in the torch space on the card, teacher-forced
        K.reset_launch_counts()
        cache_t = lm.init_cache(cfg, B, S + gen_len, device=dev)
        prefill_t = steps_lib.make_prefill_step(cfg, executor=ex_t)
        decode_t = steps_lib.make_decode_step(cfg, executor=ex_t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lt, cache_t = prefill_t(params, {"tokens": res.prompt}, cache_t)
        torch.cuda.synchronize()
        t_prefill_t = time.perf_counter() - t0
        errs = [_rel_err(lt, res.prefill_logits)]
        agree = [(lt.argmax(-1) == res.prefill_logits.argmax(-1)).float().mean()]
        for j, ref in enumerate(res.step_logits):
            lt, cache_t = decode_t(params, {"tokens": res.tokens[:, j:j + 1]},
                                   S + j, cache_t)
            errs.append(_rel_err(lt, ref))
            agree.append((lt.argmax(-1) == ref.argmax(-1)).float().mean())
        counts_t = {n: K.launch_counts()[n] for n in LM_KERNELS}
    del cache_t
    top1 = float(torch.stack(agree).mean())
    say(f"[lm] (b) torch space on the card: prefill {t_prefill_t * 1e3:.1f} ms; "
        f"prefill logits error {errs[0]:.3e}, decode steps' largest "
        f"{max(errs[1:]):.3e} of max |logit| (tolerance {LM_BF16_TOL}); top-1 "
        f"agreement {top1:.4f}; LM kernel launches {counts_t}")
    if any(counts_t.values()):
        fail("the torch space launched an LM kernel")
    if not max(errs) <= LM_BF16_TOL:
        fail("the cuda and torch spaces disagree on the serving path")
    summary.update(torch_space_prefill_ms=t_prefill_t * 1e3,
                   torch_space_prefill_error=errs[0],
                   torch_space_decode_error=max(errs[1:]), top1_agreement=top1)
    del params, res
    torch.cuda.empty_cache()

    # (c) full width, 12 layers, f32: the kernels cannot hide in bf16 noise
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, n_layers=LM_F32_LAYERS, dtype="float32")
    p32 = lm.init_model(cfg32, torch.Generator(dev).manual_seed(SEED + 1), dev)
    toks = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, size=(LM_F32_BATCH, LM_F32_PROMPT)), device=dev)
    out32 = {}
    with torch.inference_mode():
        for space, exe in (("cuda", ex), ("torch", ex_t)):
            c32 = lm.init_cache(cfg32, LM_F32_BATCH, LM_F32_PROMPT + 2, device=dev)
            lg, c32 = lm.prefill(p32, cfg32, toks, cache=c32, executor=exe)
            nxt = lg[:, -1].argmax(-1)[:, None]
            ld, c32 = lm.decode_step(p32, cfg32, nxt, length=LM_F32_PROMPT,
                                     cache=c32, executor=exe)
            out32[space] = (lg, ld)
    err_c = _rel_err(out32["cuda"][0], out32["torch"][0])
    err_cd = _rel_err(out32["cuda"][1], out32["torch"][1])
    say(f"[lm] (c) f32, {LM_F32_LAYERS} layers, {LM_F32_BATCH} x "
        f"{LM_F32_PROMPT}: prefill logits error {err_c:.3e}, decode step "
        f"{err_cd:.3e} of max |logit| (tolerance {LM_F32_TOL})")
    if not max(err_c, err_cd) <= LM_F32_TOL:
        fail("the f32 serving path disagrees between the cuda and torch spaces")
    summary.update(f32_prefill_error=err_c, f32_decode_error=err_cd)
    del p32, out32
    torch.cuda.empty_cache()

    rows = phase_lm_kernels(torch, copy_bw)
    return {n: launches[n] for n in K.KERNELS}, summary, rows


# -- phase 9: RWKV6-3B serving ---------------------------------------------------------


def _perturb_rwkv(torch, params, seed: int) -> None:
    """Replace each layer's w0, w_lora_b and mix_lora_b (zero in the JAX
    package's init, which makes every decay e^-1 and every token-shift mix
    data-independent) by seeded draws, in place: w0 uniform in (-3, 1.5)
    per channel (decays e^(-e^w0) from 0.95 to 0.01), LoRA outputs of order
    0.5, so the decay moves with the token."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for bp in params["blocks"]:
            tm = bp["time_mix"]
            r = tm["w_lora_b"].shape[0]
            tm["w0"].copy_(torch.rand(tm["w0"].shape, generator=gen,
                                      device="cuda") * 4.5 - 3.0)
            for key, scale in (("w_lora_b", 0.8), ("mix_lora_b", 0.5)):
                tm[key].copy_(scale / r ** 0.5 * torch.randn(
                    tm[key].shape, generator=gen, device="cuda"))


def _position_quantiles(torch, x, ref) -> dict:
    """max |x - ref| over the vocabulary at each position, over max |ref|:
    its median, 99th percentile and max; and top-1 agreement with ref."""
    err = ((x - ref).abs().amax(-1).flatten() / float(ref.abs().max())).double()
    q = torch.quantile(err, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                         device=err.device))
    return {"median": float(q[0]), "p99": float(q[1]), "max": float(err.max()),
            "top1": float((x.argmax(-1) == ref.argmax(-1)).float().mean())}


def _rwkv_counts(torch, K, n: int, where: str) -> None:
    """Every kernel's launches since the last reset: rwkv6_scan_log ``n``,
    every other kernel 0."""
    counts = K.launch_counts()
    want = {name: (n if name == "rwkv6_scan_log" else 0) for name in counts}
    if counts != want:
        bad = {k: v for k, v in counts.items() if v != want[k]}
        fail(f"{where}: kernel launches {bad}, expected rwkv6_scan_log {n} "
             "and no other")


def phase_rwkv_kernel(torch, copy_bw) -> dict:
    """rwkv6_scan_log at the serving path's shape against its plain version,
    timed (phase 3's protocol), with its bound; then a strong decay, a
    ragged tail, a tail shorter than one sub-chunk, f32, and bf16 at
    K = V = 12 (which the tensor-core kernel does not take) at smaller
    shapes."""
    from repro_torch import kernels as K
    from repro_torch.core.params import H100
    from repro_torch.kernels.rwkv6.kernel import rwkv6_tensor_cores

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    B, S, H, D = LM_BATCH, LM_PROMPT, 40, 64

    def inputs(Bq, Sq, Hq, dtype, mu, Dq=D):
        r, k, v = (torch.randn(Bq, Sq, Hq, Dq, generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        logw = -torch.exp(mu + torch.randn(Bq, Sq, Hq, Dq, generator=gen,
                                           device="cuda"))
        u = (0.5 * torch.randn(Hq, Dq, generator=gen, device="cuda")).to(dtype)
        return r, k, v, logw, u

    def held(label, args, tol_rel):
        """y: both sides round one f32 result to the inputs' type (one ulp,
        tol_rel of |plain|), beside 1e-4 of max |y| for chunk sums in
        another order; the f32 state within 1e-4 of its max."""
        y, s = K.rwkv6_scan_log(*args)
        yp, sp = K.rwkv6_scan_plain(*args)
        return max(_held(torch, f"rwkv6_scan_log y {label}", y, yp, tol_rel, 1e-4),
                   _held(torch, f"rwkv6_scan_log state {label}", s, sp, 0.0, 1e-4))

    bf16 = torch.bfloat16
    args = inputs(B, S, H, bf16, -1.0)
    errs = [held(f"at B {B}, S {S}, H {H}, K = V = {D}, bf16", args, 2.0 ** -7)]
    shapes = {}
    for label, shape, mu, Dq in (("strong_decay", (2, S, 8, bf16), 2.5, D),
                                 ("ragged_tail", (2, S - 4, 8, bf16), -1.0, D),
                                 ("sub_chunk_tail", (2, S + 3, 8, bf16), -1.0, D),
                                 ("f32", (2, 300, 8, torch.float32), -1.0, D),
                                 ("cuda_core_bf16", (2, 300, 8, bf16), -1.0, 12)):
        tol = 2.0 ** -7 if shape[3] == bf16 else 0.0
        case = inputs(*shape, mu, Dq)
        tc = rwkv6_tensor_cores(*case[:4])
        if tc != (shape[3] == bf16 and label != "cuda_core_bf16"):
            fail(f"rwkv6_scan_log {label}: the tensor-core route is {tc}")
        errs.append(held(f"{label} {shape[:3]} K = V = {Dq}", case, tol))
        shapes[label] = dict(zip(("B", "S", "H"), shape[:3]), K=Dq, V=Dq,
                             dtype=str(shape[3]).removeprefix("torch."),
                             logw_mu=mu, route="mma.sync" if tc else "cuda cores",
                             max_abs_err=errs[-1])
        del case
    y1, s1 = K.rwkv6_scan_log(*args)
    y2, s2 = K.rwkv6_scan_log(*args)
    if not (torch.equal(y1, y2) and torch.equal(s1, s2)):
        fail("rwkv6_scan_log: a repeat is not bitwise equal")
    del y1, s1, y2, s2
    # bytes: r, k, v, u read and y written in bf16, logw read in f32, the
    # state written in f32; operations: the chunk products at the kernel's
    # chunk
    L = 64
    chunks = -(-S // L)
    lower = L * (L - 1) // 2  # pairs s < t of a chunk
    nbytes = 4 * B * S * H * D * 2 + B * S * H * D * 4 + B * H * D * D * 4 + H * D * 2
    flops = B * H * chunks * (4 * L * D * D + 2 * lower * D + 4 * lower * D)
    row = kernel_row(torch, flush, copy_bw, "rwkv6_scan_log", "rwkv6_scan.cu",
                     "src/repro/kernels/rwkv6/kernel.py:124", max(errs),
                     lambda: K.rwkv6_scan_log(*args),
                     lambda: K.rwkv6_scan_plain(*args), nbytes, flops,
                     peak_flops=H100.peak_flops_bf16)
    row["shape"] = {"B": B, "S": S, "H": H, "K": D, "V": D, "chunk": L,
                    "dtype": "bfloat16", "logw_mu": -1.0}
    row["held_at"] = shapes
    # the tensor-core kernel's exponentials a chunk and head: the ratio form
    # on the diagonal 8 x 8 blocks (28 pairs each, K channels); then the
    # factors: r's (ra and the inter-chunk factor, 2 L K), the keys below
    # each warp's 16 rows (16 w K for warp w), the second sub-chunk's rows
    # and keys against the first (L K), the state update's operand (L K)
    # and the chunk decay (four lanes a state row, 4 K)
    ratio = (L // 8) * 28 * D
    factors = (2 * L * D + sum(16 * w for w in range(L // 16)) * D + L * D
               + L * D + 4 * D)
    say(f"[kernels] rwkv6_scan_log exponentials a call, counted from the "
        f"kernel's design at this shape (not measured): ratio form "
        f"{B * H * chunks * ratio}, all {B * H * chunks * (ratio + factors)}")
    say("[kernels] rwkv6_scan_log library_ms: null — no single PyTorch call "
        "computes the WKV6 scan")
    return {"rwkv6_scan_log": row}


def phase_rwkv(torch, copy_bw):
    """RWKV6-3B serving at full width and depth (bf16) through
    ``repro_torch.launch.serve`` on the CUDA executor, then the checks."""
    import copy
    import dataclasses

    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import make_executor
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import lm

    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(RWKV_ARCH)
    ex = make_executor("cuda")
    ex_t = make_executor("torch", device=dev)
    B, S, gen_len = LM_BATCH, LM_PROMPT, LM_GEN
    summary = {"arch": cfg.name, "batch": B, "prompt_len": S, "gen_len": gen_len}

    t0 = time.perf_counter()
    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    summary.update(init_s=time.perf_counter() - t0, params=n_params,
                   param_bytes=n_bytes)
    say(f"[rwkv6] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv_head_dim} heads of {cfg.rwkv_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters "
        f"({n_bytes / 1e9:.3f} GB), init {summary['init_s']:.2f} s")

    # (a) the counted run: the user's entry point, on the JAX package's init
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    res = serve_lib.serve(cfg, batch=B, prompt_len=S, gen_len=gen_len,
                          seed=SEED, executor=ex, device=dev, params=params)
    launches = K.launch_counts()
    _rwkv_counts(torch, K, cfg.n_layers, "serve")
    if res.tokens.shape != (B, gen_len) or not (
            0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab):
        fail(f"serve produced tokens of shape {tuple(res.tokens.shape)} or out "
             "of the vocabulary")
    if not _finite(torch, res.prefill_logits) or not all(
            _finite(torch, lg) for lg in res.step_logits):
        fail("serve produced non-finite logits")
    decode_ms = res.decode_s / (gen_len - 1) * 1e3
    summary.update(prefill_ms=res.prefill_s * 1e3, decode_ms_per_step=decode_ms,
                   decode_tokens_per_s=res.tokens_per_s,
                   prefill_tokens_per_s=B * S / res.prefill_s,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches={"rwkv6_scan_log": launches["rwkv6_scan_log"]})
    say(f"[rwkv6] (a) serve {B} x {S} + {gen_len} greedy tokens: prefill "
        f"{res.prefill_s * 1e3:.1f} ms ({B * S / res.prefill_s:.0f} tokens/s), "
        f"decode {decode_ms:.2f} ms per step ({res.tokens_per_s:.1f} tokens/s); "
        f"peak memory {summary['peak_memory_gb']:.2f} GB; launches "
        f"{summary['launches']}")
    prompt = res.prompt
    del res

    # (b)-(d) on parameters whose decay and mix depend on the data
    _perturb_rwkv(torch, params, SEED + 9)
    with torch.inference_mode():
        # (b) the cuda space: prefill (counted, timed warm) and greedy steps
        cache = lm.init_cache(cfg, B, S + RWKV_CMP_STEPS, device=dev)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lc, cache = lm.prefill(params, cfg, prompt, cache=cache, executor=ex)
        torch.cuda.synchronize()
        summary["warm_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        _rwkv_counts(torch, K, cfg.n_layers, "prefill")
        tokens = [lc[:, -1].argmax(-1)]
        steps_c = []
        for j in range(RWKV_CMP_STEPS):
            K.reset_launch_counts()
            lg, cache = lm.decode_step(params, cfg, tokens[-1][:, None],
                                       length=S + j, cache=cache, executor=ex)
            _rwkv_counts(torch, K, 0, f"decode step {j}")
            steps_c.append(lg[:, -1])
            tokens.append(lg[:, -1].argmax(-1))
        del cache
        if not _finite(torch, lc) or not all(_finite(torch, x) for x in steps_c):
            fail("the perturbed model produced non-finite logits")
        say(f"[rwkv6] warm prefill of {B} x {S} (perturbed decays): "
            f"{summary['warm_prefill_ms']:.1f} ms")

        # (d) prefill(S - 4) + 4 decode steps against the full prefill
        cache = lm.init_cache(cfg, B, S, device=dev)
        K.reset_launch_counts()
        lm.prefill(params, cfg, prompt[:, :S - 4], cache=cache, executor=ex)
        _rwkv_counts(torch, K, cfg.n_layers, f"prefill({S - 4})")
        errs_d = []
        for j in range(4):
            K.reset_launch_counts()
            lg, cache = lm.decode_step(params, cfg, prompt[:, S - 4 + j:S - 3 + j],
                                       length=S - 4 + j, cache=cache, executor=ex)
            _rwkv_counts(torch, K, 0, f"split decode step {j}")
            errs_d.append(_rel_err(lg[:, -1], lc[:, S - 4 + j]))
        err_d = max(errs_d)
        say(f"[rwkv6] (d) prefill({S - 4}) + 4 decode steps against "
            f"prefill({S}): error {err_d:.3e} of max |logit| (tolerance "
            f"{LM_BF16_TOL}; per step {[f'{e:.3e}' for e in errs_d]})")
        if not err_d <= LM_BF16_TOL:
            fail("the split prefill disagrees with the full prefill")
        summary["split_prefill_error"] = err_d

        def decode4(tokens=tokens[0]):
            for j in range(4):
                logits, _ = lm.decode_step(params, cfg, tokens[:, None],
                                           length=S + j, cache=cache,
                                           executor=ex)
                tokens = torch.argmax(logits[:, -1], dim=-1)

        summary["profile_decode"] = _device_profile(
            torch, decode4, "rwkv6 4 decode steps", 4, "step")
        del cache
        cache_p = lm.init_cache(cfg, B, S, device=dev)
        summary["profile_prefill"] = _device_profile(
            torch, lambda: lm.prefill(params, cfg, prompt, cache=cache_p,
                                      executor=ex),
            f"rwkv6 prefill of {B} x {S}", 1, "prefill")
        del cache_p

        # (b) the torch space on the card, teacher-forced with (b)'s tokens
        K.reset_launch_counts()
        cache_t = lm.init_cache(cfg, B, S + RWKV_CMP_STEPS, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lt, cache_t = lm.prefill(params, cfg, prompt, cache=cache_t,
                                 executor=ex_t)
        torch.cuda.synchronize()
        t_prefill_t = time.perf_counter() - t0
        err_all = _rel_err(lt, lc)
        err_p = _rel_err(lt[:, -1], lc[:, -1])
        agree = [(lt.argmax(-1) == lc.argmax(-1)).float().mean()]
        # both bf16 routes against the f32 result of the same parameters
        # (the torch space in f32, TF32 off), position by position
        pf = copy.deepcopy(params).float()
        cfg_f = dataclasses.replace(cfg, dtype="float32")
        lf, _ = lm.prefill(pf, cfg_f, prompt, executor=ex_t,
                           cache=lm.init_cache(cfg_f, B, S, device=dev))
        del pf
        to_f32 = {space: _position_quantiles(torch, x, lf)
                  for space, x in (("cuda", lc), ("torch", lt))}
        del lf, lt, lc
        errs = []
        for j in range(RWKV_CMP_STEPS):
            lg, cache_t = lm.decode_step(params, cfg, tokens[j][:, None],
                                         length=S + j, cache=cache_t,
                                         executor=ex_t)
            errs.append(_rel_err(lg[:, -1], steps_c[j]))
            agree.append((lg[:, -1].argmax(-1) == steps_c[j].argmax(-1))
                         .float().mean())
        counts_t = K.launch_counts()
        del cache_t
    top1 = float(torch.stack(agree).mean())
    say(f"[rwkv6] (b) torch space on the card: prefill {t_prefill_t * 1e3:.1f} "
        f"ms; last-position prefill logits error {err_p:.3e}, decode steps' "
        f"largest {max(errs):.3e} of max |logit| (tolerance {LM_BF16_TOL}); "
        f"every position {err_all:.3e}; top-1 agreement {top1:.4f}")
    for space, q in to_f32.items():
        say(f"[rwkv6] (b) {space} space bf16 against f32, per position: "
            f"median {q['median']:.3e}, p99 {q['p99']:.3e}, max {q['max']:.3e} "
            f"of max |logit|; top-1 agreement {q['top1']:.4f}")
    if any(counts_t.values()):
        fail(f"the torch space launched a kernel: {counts_t}")
    if not max(err_p, *errs) <= LM_BF16_TOL:
        fail("the cuda and torch spaces disagree on the RWKV6 serving path")
    for key in ("median", "p99"):
        if not to_f32["cuda"][key] <= RWKV_F32_REF_MARGIN * to_f32["torch"][key]:
            fail(f"the cuda space is farther from f32 than the torch space "
                 f"({key} {to_f32['cuda'][key]:.3e} against "
                 f"{to_f32['torch'][key]:.3e})")
    summary.update(torch_space_prefill_ms=t_prefill_t * 1e3,
                   torch_space_prefill_error=err_p,
                   torch_space_all_positions_error=err_all,
                   torch_space_decode_error=max(errs), top1_agreement=top1,
                   bf16_against_f32=to_f32)
    del params
    torch.cuda.empty_cache()

    # (c) full width, 8 layers, f32: the kernel cannot hide in bf16 noise
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, n_layers=RWKV_F32_LAYERS, dtype="float32")
    p32 = lm.init_model(cfg32, torch.Generator(dev).manual_seed(SEED + 1), dev)
    _perturb_rwkv(torch, p32, SEED + 2)
    toks = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, size=(RWKV_F32_BATCH, RWKV_F32_PROMPT)), device=dev)
    out32 = {}
    with torch.inference_mode():
        for space, exe in (("cuda", ex), ("torch", ex_t)):
            c32 = lm.init_cache(cfg32, RWKV_F32_BATCH, RWKV_F32_PROMPT + 1,
                                device=dev)
            lg, c32 = lm.prefill(p32, cfg32, toks, cache=c32, executor=exe)
            ld, c32 = lm.decode_step(p32, cfg32, toks[:, -1:],
                                     length=RWKV_F32_PROMPT, cache=c32,
                                     executor=exe)
            out32[space] = (lg, ld, c32.wkv.clone())
    err_c = _rel_err(out32["cuda"][0], out32["torch"][0])
    err_cd = _rel_err(out32["cuda"][1], out32["torch"][1])
    err_cs = _rel_err(out32["cuda"][2], out32["torch"][2])
    say(f"[rwkv6] (c) f32, {RWKV_F32_LAYERS} layers, {RWKV_F32_BATCH} x "
        f"{RWKV_F32_PROMPT}: prefill logits error {err_c:.3e}, decode step "
        f"{err_cd:.3e} of max |logit|, WKV states {err_cs:.3e} of their max "
        f"(tolerance {LM_F32_TOL})")
    if not max(err_c, err_cd, err_cs) <= LM_F32_TOL:
        fail("the f32 RWKV6 path disagrees between the cuda and torch spaces")
    summary.update(f32_prefill_error=err_c, f32_decode_error=err_cd,
                   f32_state_error=err_cs)
    del p32, out32
    torch.cuda.empty_cache()

    rows = phase_rwkv_kernel(torch, copy_bw)
    return {n: launches[n] for n in K.KERNELS}, summary, rows


# -- phase 11: solve serving ---------------------------------------------------------


def _serve_host_residual(req, x) -> float:
    """||b - A x|| / ||b|| of one request in f64 on the host (CSR rows)."""
    import numpy as np

    xd = x.astype(np.float64)
    terms = req.values.astype(np.float64) * xd[req.indices]
    ax = np.add.reduceat(terms, req.indptr[:-1].astype(np.int64))
    ax[np.diff(req.indptr) == 0] = 0.0
    b = req.b.astype(np.float64)
    return float(np.linalg.norm(b - ax) / np.linalg.norm(b))


def _fresh(req):
    """A copy of a request that an engine or service numbers and stamps
    anew."""
    import copy

    out = copy.copy(req)
    out.request_id = out.submitted_s = out.admitted_s = None
    return out


class ServeSweeps:
    """Counts the lanes' refresh calls and advance sweeps: wraps the
    (refresh, advance) pair every lane builds, each call in a profiler range
    (``serve.refresh``, ``serve.advance``)."""

    def __init__(self):
        from repro_torch.serve import engine

        self.engine = engine
        self.orig = engine._build_closures
        self.refreshes = self.sweeps = 0

    def __enter__(self):
        from torch.profiler import record_function

        def counting(setup, config, ex):
            refresh, advance = self.orig(setup, config, ex)

            def c_refresh(*args):
                self.refreshes += 1
                with record_function("serve.refresh"):
                    return refresh(*args)

            def c_advance(values, inv, state, thresh):
                with record_function("serve.advance"):
                    out = advance(values, inv, state, thresh)
                self.sweeps += out.k - state.k
                return out

            return c_refresh, c_advance

        self.engine._build_closures = counting
        return self

    def __exit__(self, *exc):
        self.engine._build_closures = self.orig
        return False

    def reset(self):
        self.refreshes = self.sweeps = 0

    def want(self, config) -> dict:
        """The launches of the three kernels these refreshes and sweeps
        imply: CG applies A and M once at a refresh and once a sweep,
        BiCGSTAB A once at a refresh and A and M twice a sweep; each sweep
        one fused residual update; CSR lanes reach no spmv_batch_ell, ParILU
        and AMG lanes no block_jacobi_apply."""
        per = 1 if config.solver == "cg" else 2
        at_refresh = 1 if config.solver == "cg" else 0
        want = {"axpy_norm_rows": self.sweeps}
        if config.fmt == "ell":
            want["spmv_batch_ell"] = self.refreshes + per * self.sweeps
        if config.precond == "block_jacobi":
            want["block_jacobi_apply"] = at_refresh * self.refreshes + per * self.sweeps
        return want


def _serve_profile(torch, run, label: str) -> dict:
    """Device time by kernel over ``run()`` (torch.profiler), the device's
    busy share of its wall time, and the device time of the kernels each
    ``serve.advance`` / ``serve.refresh`` range launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ranges = ("serve.advance", "serve.refresh")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    rows = [(e.self_device_time_total, e.count, e.key) for e in events
            if e.device_type == DeviceType.CUDA and e.key not in ranges
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    by_range = {e.key: {"calls": e.count, "device_us": e.device_time_total}
                for e in events
                if e.device_type == DeviceType.CPU and e.key in ranges}
    say(f"[profile serve] {label}: wall {wall_us:.0f} us, device busy "
        f"{busy:.0f} us ({busy / wall_us:.1%}); ranges {by_range}")
    for dev, count, key in rows[:12]:
        say(f"[profile serve]   {dev:12.1f} us  {count:7d} calls  {key[:90]}")
    return {"wall_us": wall_us, "device_busy_us": busy,
            "busy_share": busy / wall_us, "ranges": by_range,
            "top": [{"name": key[:120], "calls": count, "us": dev}
                    for dev, count, key in rows[:12]]}


def _serve_inline(torch, config, ex, traffic):
    """The stream through a fresh inline engine: ``({id: response}, wall s)``;
    ids count from 0 in stream order."""
    from repro_torch.serve import ContinuousBatchEngine

    eng = ContinuousBatchEngine(config, executor=ex)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _, req in traffic:
        eng.submit(_fresh(req))
    out = {r.request_id: r for r in eng.drain()}
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, eng


def _serve_checks(tag, traffic, by_id, first_id=0):
    """Every response converged to a host true residual <= SERVE_TRUE_TOL;
    returns the largest."""
    worst = 0.0
    for i, (_, req) in enumerate(traffic):
        resp = by_id[first_id + i]
        rel = _serve_host_residual(req, resp.x)
        worst = max(worst, rel)
        if not resp.converged or not rel <= SERVE_TRUE_TOL:
            fail(f"serve {tag}: request {resp.request_id} converged "
                 f"{resp.converged}, true relative residual {rel:.3e} (at most "
                 f"{SERVE_TRUE_TOL})")
    return worst


def _bitwise(tag, a: dict, b: dict, offset=0) -> None:
    import numpy as np

    for rid, r in a.items():
        o = b[rid + offset]
        if not (np.array_equal(r.x, o.x) and r.iterations == o.iterations):
            fail(f"serve {tag}: request {rid} differs bit for bit")


def _nan_rows_check(torch, ex, col_idx, vals, X, Y, inv, vp, gen) -> None:
    """A NaN row (a frozen slot may hold one after 0/0) stays in its row:
    at a lane's shapes, with one system's inputs NaN, every other row of
    spmv_batch_ell, axpy_norm_rows and block_jacobi_apply is bitwise that
    of the NaN-free call, and the NaN row is NaN."""
    from repro_torch import kernels as K

    S, n = X.shape
    m, k = col_idx.shape
    nbl = inv.shape[0] // S
    r = 3
    nan = float("nan")
    cfg = ex.launch_config("spmv_batch_ell", {"m": m, "k": k, "n": n,
                                              "itemsize": 4})
    ell = dict(block_threads=cfg["block_threads"], subgroup=cfg["subgroup"])
    cfg = ex.launch_config("axpy_norm_rows", {"nb": S, "n": n, "itemsize": 4})
    rows = dict(block_threads=cfg["block_threads"], grid_blocks=cfg["grid_blocks"])
    bt = ex.launch_config("block_jacobi", {"nb": inv.shape[0],
                                           "bs": inv.shape[1]})["block_threads"]
    alpha = torch.randn(S, generator=gen, device="cuda")
    Xn, valsn, vpn = X.clone(), vals.clone(), vp.clone()
    Xn[r] = nan
    valsn[r] = nan
    vpn[r * nbl:(r + 1) * nbl] = nan
    keep = torch.ones(S, dtype=torch.bool, device="cuda")
    keep[r] = False
    keep_b = keep.repeat_interleave(nbl)
    pairs = {
        "spmv_batch_ell": (K.spmv_batch_ell(col_idx, vals, X, **ell),
                           K.spmv_batch_ell(col_idx, valsn, Xn, **ell), keep),
        "axpy_norm_rows Z": (K.axpy_norm_rows(alpha, X, Y, **rows)[0],
                             K.axpy_norm_rows(alpha, Xn, Y, **rows)[0], keep),
        "axpy_norm_rows Z.Z": (K.axpy_norm_rows(alpha, X, Y, **rows)[1],
                               K.axpy_norm_rows(alpha, Xn, Y, **rows)[1], keep),
        "block_jacobi_apply": (K.block_jacobi_apply(inv, vp, block_threads=bt),
                               K.block_jacobi_apply(inv, vpn, block_threads=bt),
                               keep_b),
    }
    for name, (clean, dirty, kept) in pairs.items():
        if not (torch.equal(clean[kept], dirty[kept])
                and bool(torch.isnan(dirty[~kept]).all())):
            fail(f"serve: {name} lets a NaN row reach another row")
    say(f"[serve] a NaN system stays in its row in {', '.join(pairs)}")


def phase_serve(torch, card: str, copy_bw: float):
    """Phase 11: solve serving on the card (see the module docstring).
    Returns ``(paths, summary, held)``."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.core.params import H100
    from repro_torch.launch import solve_serve
    from repro_torch.observability import metrics, roofline_summary, trace
    from repro_torch.serve import (ContinuousBatchEngine, ServeConfig, SetupCache,
                                   SolveService, TrafficConfig, generate_traffic)
    from repro_torch.solvers import Stop

    t_phase = time.perf_counter()
    ex = make_executor("cuda")
    stop = Stop(*SERVE_STOP)
    config = ServeConfig(**SERVE_CONFIG, stop=stop)
    tcfg = TrafficConfig(**SERVE_TRAFFIC)
    t0 = time.perf_counter()
    traffic = generate_traffic(tcfg)
    gen_s = time.perf_counter() - t0
    say(f"[serve] ({card}) traffic: {len(traffic)} requests of n = {tcfg.n}, "
        f"gallery {tcfg.gallery_size}, repeat {tcfg.repeat_ratio}: built on the "
        f"host in {gen_s:.3f} s")
    paths, summary, held = {}, {"card": card, "traffic_s": gen_s}, {}
    sweeps = ServeSweeps()
    with sweeps:
        # 11a: the stream unpaced through the service, counted from 0
        svc = SolveService(config, executor=ex)
        with svc:
            torch.cuda.synchronize()
            K.reset_launch_counts()
            sweeps.reset()
            ex.dispatch_log.clear()
            t_run = time.perf_counter()
            solve_serve._warmup(svc, tcfg)
            cold = dict(ex.dispatch_log)
            metrics.reset()
            t1 = time.perf_counter()
            ids = [svc.submit(req) for _, req in traffic]
            responses = svc.gather(ids, timeout=600.0)
            wall = time.perf_counter() - t1
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t_run
            launches = K.launch_counts()
            storage = dict(K.block_jacobi_apply.launches_by_storage)
            want = sweeps.want(config)
            refreshes, n_sweeps = sweeps.refreshes, sweeps.sweeps
            ok = solve_serve.report(responses, wall, SERVE_UNPACED_P99_BOUND)
            h = metrics.histogram("serve_latency_s")
            p50, p99 = h.quantile(0.5), h.quantile(0.99)
            # a guaranteed full hit: the last request's matrix, whose factors
            # are the newest in its pattern's values tier
            ex.dispatch_log.clear()
            (hit,) = svc.gather([svc.submit(_fresh(traffic[-1][1]))],
                                timeout=60.0)
            hit_log = dict(ex.dispatch_log)
        if not ok:
            fail("serve 11a: SERVE-GATE failed")
        if cold.get("serve_generate_pattern") != tcfg.gallery_size:
            fail(f"serve 11a: the cold pass generated {cold} patterns, expected "
                 f"{tcfg.gallery_size}")
        hit_gen = (hit_log.get("serve_generate_pattern", 0)
                   + hit_log.get("serve_generate_factors", 0))
        if hit_gen or not (hit.pattern_hit and hit.factors_hit and hit.converged):
            fail(f"serve 11a: the full-hit request launched {hit_gen} generate "
                 f"operations (pattern hit {hit.pattern_hit}, factors hit "
                 f"{hit.factors_hit})")
        expect_launches("serve 11a", launches, want)
        by_id = {r.request_id: r for r in responses}
        worst = _serve_checks("11a", traffic, by_id, first_id=ids[0])
        rate = len(responses) / wall
        iters = [r.iterations for r in responses]
        p_hits = sum(r.pattern_hit for r in responses)
        f_hits = sum(r.factors_hit for r in responses)
        say(f"[serve] ({card}) 11a: {len(responses)} solves in {wall:.4f} s = "
            f"{rate:.1f} solves/s; latency p50 {p50} s, p99 {p99} s (bucket "
            f"bounds, every request submitted at once); iterations "
            f"{min(iters)}-{max(iters)} (mean {np.mean(iters):.2f}); "
            f"{refreshes} refreshes and {n_sweeps} advance sweeps in the run "
            f"(warm-up included, {run_s:.4f} s); pattern hits {p_hits}, factor "
            f"hits {f_hits}; largest true residual {worst:.3e}; cold pass "
            f"{cold.get('serve_generate_pattern')} pattern generates, full-hit "
            f"request {hit_gen}")
        paths["solve_serve"] = (launches, storage)
        summary["throughput"] = {
            "requests": len(responses), "wall_s": wall, "solves_per_s": rate,
            "latency_p50_s": p50, "latency_p99_s": p99, "run_s": run_s,
            "refreshes": refreshes, "sweeps": n_sweeps,
            "iterations_mean": float(np.mean(iters)), "pattern_hits": p_hits,
            "factor_hits": f_hits, "max_true_residual": worst,
            "launches": {k: v for k, v in launches.items() if v}}

        # busy = solo for 8 requests: solo engines of the same configuration
        solo_cache = SetupCache()
        for i in range(8):
            solo = ContinuousBatchEngine(config, executor=ex, cache=solo_cache)
            solo.submit(_fresh(traffic[i][1]))
            (s,) = solo.drain()
            b = by_id[ids[i]]
            if not (np.array_equal(s.x, b.x) and s.iterations == b.iterations):
                fail(f"serve 11a: request {ids[i]} in the busy lane differs "
                     "from a solo engine's")
        say(f"[serve] 11a: 8 busy-lane responses equal solo engines' bit for bit")

        # the inline engine twice, bit for bit alike and equal to the
        # service's responses; then the first SERVE_PROFILE_REQUESTS of the
        # stream under torch.profiler (the whole stream's 10^6 events would
        # take minutes to collect)
        sweeps.reset()
        inline1, wall_i, _ = _serve_inline(torch, config, ex, traffic)
        sweeps_1 = sweeps.sweeps
        inline2, wall_i2, _ = _serve_inline(torch, config, ex, traffic)
        _bitwise("inline repeat", inline1, inline2)
        _bitwise("service against inline", inline1, by_id, offset=ids[0])
        sweeps.reset()
        prof = _serve_profile(
            torch, lambda: _serve_inline(torch, config, ex,
                                         traffic[:SERVE_PROFILE_REQUESTS]),
            f"({card}) inline engine drain, the first "
            f"{SERVE_PROFILE_REQUESTS} requests")
        adv = prof["ranges"].get("serve.advance", {})
        per_sweep = (adv.get("device_us", 0.0) / sweeps.sweeps
                     if sweeps.sweeps else None)
        say(f"[serve] ({card}) 11a: inline engine {wall_i:.4f} / "
            f"{wall_i2:.4f} s ({len(traffic) / wall_i:.1f} solves/s), {sweeps_1} "
            f"sweeps, repeat bit for bit, equal to the service's; profiled "
            f"window: device busy {prof['busy_share']:.1%}, {sweeps.sweeps} "
            f"sweeps at {per_sweep} us of device time an advance sweep, "
            f"{prof['wall_us'] / max(sweeps.sweeps, 1):.1f} us of wall a sweep "
            "(admissions included)")
        summary["inline"] = {"wall_s": [wall_i, wall_i2], "sweeps": sweeps_1,
                             "profile_requests": SERVE_PROFILE_REQUESTS,
                             "profile_sweeps": sweeps.sweeps,
                             "device_us_per_advance_sweep": per_sweep,
                             "profile": prof}

        # the torch space on the card, over the stream's first
        # SERVE_TORCH_REQUESTS requests
        ex_t = make_executor("torch", device="cuda")
        inline_t, wall_t, _ = _serve_inline(torch, config, ex_t,
                                            traffic[:SERVE_TORCH_REQUESTS])
        worst_dx, worst_di = 0.0, 0
        for rid, o in inline_t.items():
            r = inline1[rid]
            dx = float(np.linalg.norm(o.x - r.x) / np.linalg.norm(r.x))
            worst_dx, worst_di = max(worst_dx, dx), max(worst_di,
                                                        abs(o.iterations - r.iterations))
            if not o.converged or abs(o.iterations - r.iterations) > 1 or not dx <= 1e-3:
                fail(f"serve 11a: request {rid} in the torch space: iterations "
                     f"{o.iterations} against {r.iterations}, x within {dx:.3e}")
        say(f"[serve] ({card}) 11a: torch space on the card, the first "
            f"{len(inline_t)} requests in {wall_t:.4f} s "
            f"({len(inline_t) / wall_t:.1f} solves/s); iterations within "
            f"{worst_di}, x within {worst_dx:.3e} (relative)")
        summary["torch_space"] = {"wall_s": wall_t, "max_iteration_delta": worst_di,
                                  "max_relative_dx": worst_dx}

        # 11b: the first 1,024 requests at half 11a's rate (Poisson gaps scaled)
        half = traffic[:SERVE_HALF_LOAD_REQUESTS]
        scale = tcfg.rate_hz / (0.5 * rate)
        paced = [(gap * scale, _fresh(req)) for gap, req in half]
        responses_b, wall_b = solve_serve.run_serve(config, tcfg, executor=ex,
                                                    traffic=paced)
        ok_b = solve_serve.report(responses_b, wall_b, SERVE_P99_BOUND)
        hb = metrics.histogram("serve_latency_s")
        lat = sorted(r.latency_s for r in responses_b)
        exact = {q: lat[min(len(lat) - 1, int(q * len(lat)))] for q in (0.5, 0.99)}
        if not ok_b:
            fail("serve 11b: SERVE-GATE failed at half load")
        by_b = {r.request_id: r for r in responses_b}
        _serve_checks("11b", half, by_b, first_id=min(by_b))
        say(f"[serve] ({card}) 11b: {len(responses_b)} requests at "
            f"{0.5 * rate:.1f} requests/s (half of 11a): {wall_b:.4f} s, "
            f"latency p50 {hb.quantile(0.5)} s, p99 {hb.quantile(0.99)} s "
            f"(bucket bounds; from the responses {exact[0.5] * 1e3:.3f} ms and "
            f"{exact[0.99] * 1e3:.3f} ms)")
        summary["half_load"] = {"requests": len(responses_b), "rate": 0.5 * rate,
                                "wall_s": wall_b, "p50_s": hb.quantile(0.5),
                                "p99_s": hb.quantile(0.99),
                                "p50_exact_s": exact[0.5],
                                "p99_exact_s": exact[0.99]}

        # 11c: the other lanes, counted from 0, repeated bit for bit
        lane_launches = collections.Counter()
        lane_storage = collections.Counter()
        summary["lanes"] = {}
        for label, kw, extra in SERVE_LANES:
            cfg_l = ServeConfig(**{**SERVE_CONFIG, **kw}, stop=stop)
            tc = TrafficConfig(**{**SERVE_TRAFFIC, **extra,
                                  "num_requests": SERVE_LANE_REQUESTS})
            tr = generate_traffic(tc)
            K.reset_launch_counts()
            sweeps.reset()
            metrics.reset()
            got, wall_l, eng = _serve_inline(torch, cfg_l, ex, tr)
            counts = K.launch_counts()
            expect_launches(f"serve 11c {label}", counts, sweeps.want(cfg_l))
            lane_launches.update(counts)
            lane_storage.update(K.block_jacobi_apply.launches_by_storage)
            worst_l = _serve_checks(f"11c {label}", tr, got)
            resp = list(got.values())
            p_h = sum(r.pattern_hit for r in resp)
            f_h = sum(r.factors_hit for r in resp)
            st = eng.cache.stats()
            if (st["serve_cache_hits_pattern"] != p_h
                    or st["serve_cache_misses_pattern"] != len(resp) - p_h
                    or st["serve_cache_hits_values"] != f_h or not p_h or not f_h):
                fail(f"serve 11c {label}: cache accounting {st} against "
                     f"{p_h} pattern and {f_h} factor hits")
            again, _, _ = _serve_inline(torch, cfg_l, ex, tr)
            _bitwise(f"11c {label} repeat", got, again)
            its = [r.iterations for r in resp]
            say(f"[serve] ({card}) 11c {label}: {len(resp)} solves in "
                f"{wall_l:.4f} s ({len(resp) / wall_l:.1f} solves/s), "
                f"iterations {min(its)}-{max(its)}, largest true residual "
                f"{worst_l:.3e}, pattern hits {p_h}, factor hits {f_h}, "
                f"{sweeps.sweeps} sweeps; repeat bit for bit")
            summary["lanes"][label] = {
                "wall_s": wall_l, "solves_per_s": len(resp) / wall_l,
                "iterations": [min(its), max(its)], "sweeps": sweeps.sweeps,
                "max_true_residual": worst_l, "pattern_hits": p_h,
                "factor_hits": f_h,
                "launches": {k: v for k, v in counts.items() if v}}
        paths["solve_serve_lanes"] = (dict(lane_launches), dict(lane_storage))

        # 11d: the first 256 requests traced
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            tpath, mpath = f"{tmp}/serve_trace.json", f"{tmp}/serve.jsonl"
            ex.dispatch_log.clear()
            trace.reset()
            with trace.tracing(tpath):
                responses_d, wall_d = solve_serve.run_serve(
                    config, tcfg, executor=ex, pace=False,
                    traffic=[(g, _fresh(r)) for g, r in
                             traffic[:SERVE_TRACE_REQUESTS]])
            errors = trace.validate_trace(tpath)
            with open(tpath) as f:
                n_events = len(json.load(f)["traceEvents"])
            trace.reset()
            rows = roofline_summary(ex.dispatch_events,
                                    hbm_bandwidth=H100.hbm_bandwidth)
            metrics.export_jsonl(mpath)
            back = metrics.load_jsonl(mpath)
            same = back == json.loads(json.dumps(metrics.samples(), default=str))
        if errors:
            fail(f"serve 11d: the trace is invalid: {errors[:5]}")
        if not all(r.converged for r in responses_d):
            fail("serve 11d: a traced request did not converge")
        top = max(rows, key=lambda r: r["frac_of_bound"])
        for r in rows:
            if r["op"] in ("spmv_batch_ell", "axpy_norm", "block_jacobi_apply",
                           "batch_blas_dot", "batch_blas_norm2"):
                say(f"[serve] ({card}) 11d roofline {r['op']}/{r['space']}: "
                    f"{r['count']} dispatches, {r['est_bytes']} bytes, "
                    f"{r['wall_us']:.1f} us (synchronised), {r['gbs']:.2f} GB/s, "
                    f"{r['frac_of_bound']:.4f} of 3.35 TB/s")
        if not top["frac_of_bound"] <= 1.05:
            fail(f"serve 11d: {top['op']} at {top['frac_of_bound']:.3f} of the "
                 "HBM bound")
        if not same or not any(r["name"] == "dispatch_total" for r in back):
            fail("serve 11d: the metrics JSONL does not round-trip")
        say(f"[serve] ({card}) 11d: {len(responses_d)} requests traced in "
            f"{wall_d:.4f} s, {n_events} trace events valid; {len(rows)} "
            f"roofline rows, the highest {top['op']} at "
            f"{top['frac_of_bound']:.4f} of the bound; {len(back)} metric "
            "series round-trip through JSONL")
        summary["traced"] = {"requests": len(responses_d), "wall_s": wall_d,
                             "trace_events": n_events,
                             "max_frac_of_bound": top["frac_of_bound"],
                             "max_frac_op": top["op"],
                             "metric_series": len(back)}

    # the three kernels at this path's shapes: a lane's operator and blocks
    lane = next(iter(svc.engine.lanes.values()))
    S, n = lane.B.shape
    col_idx = lane.setup.col_idx
    vals = lane.values.reshape(S, *col_idx.shape)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    X = torch.randn(S, n, generator=gen, device="cuda")
    Y = torch.randn(S, n, generator=gen, device="cuda")
    inv = lane.inv
    vp = torch.randn(inv.shape[0], inv.shape[1], generator=gen, device="cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    row = functools.partial(kernel_row, torch, flush, copy_bw)
    held["spmv_batch_ell"] = [row(
        "spmv_batch_ell", "spmv_batch_ell.cu",
        "src/repro/kernels/spmv_batch_ell/kernel.py:51",
        **held_batch_ell(torch, ex, col_idx, vals, X, " (serve)"), cupti=True)]
    held["spmv_batch_ell"][-1]["shape"] = {"nb": S, "m": col_idx.shape[0],
                                           "k": col_idx.shape[1]}
    held["axpy_norm_rows"] = [row(
        "axpy_norm_rows", "axpy_norm.cu", "src/repro/kernels/axpy_norm/kernel.py:39",
        **held_axpy_norm_rows(torch, ex, X, Y, gen, " (serve)"))]
    held["axpy_norm_rows"][-1]["shape"] = {"nb": S, "n": n}
    held["block_jacobi_apply"] = [bj_row(torch, flush, copy_bw, ex, inv, vp,
                                         " (serve)")]
    _nan_rows_check(torch, ex, col_idx, vals, X, Y, inv, vp, gen)
    summary["phase_s"] = time.perf_counter() - t_phase
    say(f"[serve] ({card}) phase 11: {summary['phase_s']:.1f} s")
    return paths, summary, held


# -- phase 12: the distributed solver layer -------------------------------------------


def _host_residual(host, x, b) -> float:
    """||b - A x|| / ||b|| in f64 on the host, A a host CSR triplet."""
    import numpy as np

    ip, ix, v = host[:3]
    rows = np.repeat(np.arange(len(ip) - 1), np.diff(ip))
    x = np.asarray(x, np.float64)
    b = np.asarray(b, np.float64)
    ax = np.bincount(rows, weights=np.asarray(v, np.float64) * x[ix],
                     minlength=len(b))
    return float(np.linalg.norm(b - ax) / np.linalg.norm(b))


def _counted_world(torch, run):
    """``run()`` with the kernel and collective counts set to 0 just before
    it and read just after: ``(result, wall s, launches, block_jacobi_apply
    by storage, collectives)``."""
    from repro_torch import kernels as K
    from repro_torch.distributed import comm

    torch.cuda.synchronize()
    K.reset_launch_counts()
    comm.reset_collective_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, K.launch_counts(),
            dict(K.block_jacobi_apply.launches_by_storage),
            comm.collective_counts())


def _dist_cg_launches(k: int, one_block: bool) -> dict:
    """A distributed block-Jacobi CG's launches on one rank over ``k``
    iterations (one storage class): with one block and no padding the fused
    loop's SpMV + dot is one spmv_dot_ell; with a halo every apply is three
    spmv_ell (interior, boundary, halo) and the dot a torch op."""
    if one_block:
        return {"spmv_ell": 1, "spmv_dot_ell": k, "axpy_norm": k,
                "block_jacobi_apply": k + 1}
    return {"spmv_ell": 3 * (k + 1), "axpy_norm": k, "block_jacobi_apply": k + 1}


def _dist_rank(cfg: dict) -> dict:
    """Phase 12b's rank (spawned into a gloo world of DIST_RANKS sharing the
    card): its rows of phase 4's system, block-Jacobi CG in f32 (counted,
    then repeated, the repeat profiled on rank 0), and DIST_PIPE_STOP's
    window of pipelined CG in f64 (counted).  Returns counts, times and a
    digest of every x."""
    import hashlib

    import numpy as np

    from repro_torch.core import make_executor
    from repro_torch.distributed import DistEll, Partition, comm, dist_preconditioner
    from repro_torch.solvers import Stop, cg
    from repro_torch.sparse import gallery

    import torch

    marks = {"enter": time.time()}
    rank, size = comm.world()
    ip, ix, v, shape = gallery.poisson_3d(cfg["n_side"])
    marks["gallery"] = time.time()
    n = shape[0]
    b = torch.from_numpy(np.random.default_rng(cfg["seed"]).standard_normal(n)
                         .astype(np.float32)).cuda()
    ex = make_executor("cuda")
    t0 = time.perf_counter()
    Ad = DistEll.from_host(ip, ix, v, Partition.uniform(n, size), device="cuda")
    Pd = dist_preconditioner(Ad, "block_jacobi", executor=ex, **cfg["precond"])
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    marks["setup"] = time.time()
    stop = Stop(**cfg["stop"])

    def digest(x):
        return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()

    res, wall, launches, storage, coll = _counted_world(
        torch, lambda: cg(Ad, b, M=Pd, stop=stop, executor=ex))
    # the repeat, profiled on rank 0 (every rank runs it; the others
    # unprofiled): the device time of a whole solve
    box = []
    run = lambda: box.append(cg(Ad, b, M=Pd, stop=stop, executor=ex))  # noqa: E731
    prof = (_device_profile(torch, run, "12b f32 CG repeat", res.iterations,
                            "iteration", tag="dist 4 ranks")
            if rank == 0 else run())
    again = box[0]
    marks["cg_and_repeat"] = time.time()
    out = {"rank": rank, "setup_s": setup, "halo_cols": Ad.num_halo_cols,
           "iterations": res.iterations, "converged": res.converged,
           "wall_s": wall, "launches": launches, "storage": storage,
           "collectives": coll, "digest": digest(res.x), "profile": prof,
           "repeat_equal": (again.iterations == res.iterations
                            and bool(torch.equal(again.x, res.x))),
           "x": res.x.cpu().numpy() if rank == 0 else None}
    A64 = Ad.astype(torch.float64)
    P64 = dist_preconditioner(A64, "block_jacobi", executor=ex,
                              block_size=cfg["precond"]["block_size"])
    pres, pwall, plaunch, pstorage, pcoll = _counted_world(
        torch, lambda: cg(A64, b.double(), M=P64, executor=ex, pipeline=True,
                          stop=Stop(**cfg["pipe_stop"])))
    marks["pipelined"] = time.time()
    out["marks"] = marks
    out["pipelined"] = {"iterations": pres.iterations,
                        "converged": pres.converged, "wall_s": pwall,
                        "launches": plaunch, "storage": pstorage,
                        "collectives": pcoll, "digest": digest(pres.x),
                        "x": pres.x.cpu().numpy() if rank == 0 else None}
    return out


def _sum_counts(dicts) -> dict:
    out = collections.Counter()
    for d in dicts:
        out.update({k: c for k, c in d.items() if c})
    return dict(out)


def phase_dist(torch, host, b, k4: int, x4, storage4) -> tuple:
    """Phase 12: the distributed solver layer (see the module docstring).
    Returns the counted paths (launches and block_jacobi_apply by storage)
    and the phase's record."""
    import numpy as np

    from repro_torch.core import make_executor
    from repro_torch.distributed import (DistEll, Partition, comm,
                                         dist_preconditioner)
    from repro_torch.solvers import Stop, cg

    t_phase = time.perf_counter()
    ip, ix, v, shape = host
    n = shape[0]
    stop = Stop(**STOP_KW)
    # phase 4's adaptive rule stored every block in one class: that dtype,
    # named, is the uniform storage a distributed block-Jacobi takes
    if len(storage4) != 1:
        fail(f"phase 4's block-Jacobi has {len(storage4)} storage classes; "
             "the distributed one needs one")
    precond = {"block_size": PRECOND_OPTS["block_size"],
               "adaptive": storage4[0][0]}
    b_np = b.cpu().numpy()
    out = {}

    # 12a: one rank, NCCL, in this process
    def one_rank():
        ex = make_executor("cuda")
        t0 = time.perf_counter()
        Ad = DistEll.from_host(ip, ix, v, Partition.uniform(n, 1), device="cuda")
        Pd = dist_preconditioner(Ad, "block_jacobi", executor=ex, **precond)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        # the first solve is counted (it also opens the NCCL communicator);
        # the repeat is the loop's wall
        res, _, launches, storage, coll = _counted_world(
            torch, lambda: cg(Ad, b, M=Pd, stop=stop, executor=ex))
        again, wall, *_ = _counted_world(
            torch, lambda: cg(Ad, b, M=Pd, stop=stop, executor=ex))
        prof = phase_profile(torch, Ad, b, Pd, ex, tag="profile dist 1 rank")
        return (setup, res, wall, launches, storage, coll,
                again.iterations == res.iterations
                and bool(torch.equal(again.x, res.x)), prof)

    (setup, res, wall, launches_a, storage_a, coll, repeat_ok,
     prof_a) = comm.run_world(one_rank, 1, backend="nccl", in_process=True)[0]
    k = res.iterations
    dx = float((res.x - x4).norm() / x4.norm())
    rel = _host_residual(host, res.x.cpu().numpy(), b_np)
    us_a = prof_a["device_busy_us"] / prof_a["iterations"]
    say(f"[dist 1 rank] DistEll over 1 rank (NCCL): setup {setup:.2f} s; CG "
        f"{k} iterations (phase 4: {k4}), converged {res.converged}, x "
        f"against phase 4's {dx:.3e} (relative), true relative residual "
        f"{rel:.4e}; loop {wall:.4f} s = {wall / k * 1e3:.4f} ms an "
        f"iteration, {us_a:.1f} us of device time an iteration; collectives "
        f"{coll} ({coll['reduction'] / k:.2f} reductions an iteration); "
        f"repeat bit for bit {repeat_ok}")
    if not res.converged or abs(k - k4) > 1:
        fail(f"12a: {k} iterations against phase 4's {k4}")
    if not dx <= 1e-3 or not rel <= 1e-4 or not repeat_ok:
        fail("12a: x, the true residual or the repeat is off")
    expect_launches("dist 1 rank", launches_a, _dist_cg_launches(k, True))
    if coll["reduction"] != 3 + 3 * k or coll["halo"] != 0:
        fail(f"12a: collectives {coll}, expected {3 + 3 * k} reductions")
    out["one_rank"] = {"iterations": k, "x_rel_diff": dx, "true_rel_res": rel,
                       "setup_s": setup, "loop_s": wall,
                       "ms_per_iteration": wall / k * 1e3,
                       "device_us_per_iteration": us_a, "collectives": coll,
                       "profile": prof_a}

    # 12b: DIST_RANKS ranks sharing the card, gloo, spawned
    cfg = {"n_side": N_SIDE, "seed": SEED, "stop": STOP_KW, "precond": precond,
           "pipe_stop": DIST_PIPE_STOP}
    t0 = time.perf_counter()
    t_spawn = time.time()
    ranks = comm.run_world(_dist_rank, DIST_RANKS, (cfg,), backend="gloo",
                           timeout_s=DIST_TIMEOUT_S, join_timeout_s=300.0,
                           threads=2)
    t_world = time.perf_counter() - t0
    t_back = time.time()
    # where the world's time went: each mark the latest rank's, from spawn
    steps = ["enter", "gallery", "setup", "cg_and_repeat", "pipelined"]
    at = {k: max(r["marks"][k] for r in ranks) - t_spawn for k in steps}
    say(f"[dist 4 ranks] world timeline from spawn (s, slowest rank): "
        + ", ".join(f"{k} {at[k]:.1f}" for k in steps)
        + f", back in the parent {t_back - t_spawn:.1f}")
    r0 = ranks[0]
    kb = r0["iterations"]
    for key in ("iterations", "digest"):
        if len({r[key] for r in ranks}) != 1:
            fail(f"12b: the ranks disagree on {key}")
    if not all(r["repeat_equal"] and r["converged"] for r in ranks):
        fail("12b: a rank did not converge or its repeat differs")
    dxb = float(np.linalg.norm(r0["x"] - res.x.cpu().numpy())
                / np.linalg.norm(r0["x"]))
    relb = _host_residual(host, r0["x"], b_np)
    collb = r0["collectives"]
    prof_b = r0["profile"]
    us_b = prof_b["device_busy_us"] / prof_b["iterations"]
    say(f"[dist 4 ranks] {DIST_RANKS} ranks time-sharing one H100, gloo "
        f"(no interconnect measured): world {t_world:.1f} s (spawn, setup "
        f"{max(r['setup_s'] for r in ranks):.2f} s); CG f32 {kb} iterations "
        f"(12a: {k}), x against 12a's {dxb:.3e}, true relative residual "
        f"{relb:.4e}; loop {r0['wall_s']:.3f} s = "
        f"{r0['wall_s'] / kb * 1e3:.3f} ms an iteration; rank 0 "
        f"{us_b:.1f} us of device time an iteration; collectives {collb} "
        f"({collb['reduction'] / kb:.2f} reductions and "
        f"{collb['halo'] / kb:.2f} halo exchanges an iteration); halo "
        f"columns {r0['halo_cols']}; repeat bit for bit on every rank")
    if abs(kb - k) > 1 or not dxb <= 1e-3 or not relb <= 1e-4:
        fail("12b: CG on 4 ranks disagrees with 12a")
    for r in ranks:
        expect_launches(f"dist 4 ranks, rank {r['rank']}", r["launches"],
                        _dist_cg_launches(kb, False))
    if collb["reduction"] != 3 + 3 * kb:
        fail(f"12b: classic CG took {collb['reduction']} reductions, "
             f"expected 3 an iteration")
    pipe = [r["pipelined"] for r in ranks]
    kp = pipe[0]["iterations"]
    collp = pipe[0]["collectives"]
    if len({p["digest"] for p in pipe}) != 1:
        fail("12b: pipelined CG: the ranks disagree on x")
    relp = _host_residual(host, pipe[0]["x"], b_np)
    say(f"[dist 4 ranks] pipelined CG f64, a window of {kp} iterations: true "
        f"relative residual {relp:.4e}, loop {pipe[0]['wall_s']:.3f} s = "
        f"{pipe[0]['wall_s'] / kp * 1e3:.3f} ms an iteration; collectives "
        f"{collp} ({(collp['reduction'] - 2) / kp:.2f} reductions an "
        f"iteration past the two before the loop)")
    if collp["reduction"] != kp + 2 or kp != DIST_PIPE_STOP["max_iters"]:
        fail(f"12b: pipelined CG took {collp['reduction']} reductions for "
             f"{kp} iterations (one an iteration expected)")
    for p in pipe:
        expect_launches("dist 4 ranks pipelined", p["launches"], {
            "spmv_ell": 3 * (kp + 2), "block_jacobi_apply": kp + 1})
    out["four_ranks"] = {
        "label": "4 ranks time-sharing one H100; no interconnect measured",
        "world_s": t_world, "timeline_s": at, "iterations": kb, "x_rel_diff_12a": dxb,
        "true_rel_res": relb, "loop_s": r0["wall_s"],
        "ms_per_iteration": r0["wall_s"] / kb * 1e3,
        "device_us_per_iteration_rank0": us_b, "collectives": collb,
        "pipelined": {"iterations": kp, "collectives": collp,
                      "loop_s": pipe[0]["wall_s"], "true_rel_res": relp},
        "profile_rank0": prof_b}

    # 12c: the launcher's entry point, as `python -m` calls it, in this
    # process (one card: one rank, NCCL); counted from 0
    from repro_torch.launch import dist_solve

    rep, t_launch, launches_c, storage_c, _ = _counted_world(
        torch, lambda: dist_solve.run(DIST_LAUNCH))
    if not rep["ok"]:
        fail("12c: repro_torch.launch.dist_solve ended DIST-PARITY: FAIL")
    out["launcher"] = {"args": DIST_LAUNCH, "seconds": t_launch,
                       "iterations": rep["iterations"],
                       "wall_s": rep["wall_s"], "diff": rep["diff"]}
    out["seconds"] = time.perf_counter() - t_phase
    say(f"[dist] phase 12 took {out['seconds']:.1f} s")
    paths = {
        "dist_cg_1_rank": (launches_a, storage_a),
        "dist_cg_4_ranks": (_sum_counts(r["launches"] for r in ranks),
                            _sum_counts(r["storage"] for r in ranks)),
        "dist_pipelined_cg_4_ranks": (_sum_counts(p["launches"] for p in pipe),
                                      _sum_counts(p["storage"] for p in pipe)),
        "dist_launcher": (launches_c, storage_c),
    }
    return paths, out


# -- phase 13: the implicit layer ------------------------------------------------------


def phase_implicit(torch) -> dict:
    """Phase 13: the implicit layer at a user's size (13a) and the DEQ model
    (13b); see the module docstring."""
    import numpy as np

    from repro_torch.core import make_executor
    from repro_torch.models import deq
    from repro_torch.nn.implicit import make_implicit_solve
    from repro_torch.solvers import Stop
    from repro_torch.sparse import gallery

    t_phase = time.perf_counter()
    ex = make_executor("cuda")
    out = {}
    marks = {}
    # 13a: one forward and one backward of GMRES(30) on phase 10's operator
    ip, ix, v, shape = gallery.convection_diffusion_2d(KRYLOV_N_SIDE,
                                                       **KRYLOV_CONVDIFF)
    n = shape[0]
    rng = np.random.default_rng(SEED)
    b_np = rng.standard_normal(n).astype(np.float32)
    g_np = rng.standard_normal(n).astype(np.float32)
    solve = make_implicit_solve(ip, ix, shape, restart=KRYLOV_RESTART,
                                stop=Stop(**IMPLICIT_STOP), executor=ex)
    vals = torch.tensor(v, device="cuda", requires_grad=True)
    b = torch.tensor(b_np, device="cuda", requires_grad=True)
    g = torch.from_numpy(g_np).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = solve(vals, b)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    x.backward(g)
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    marks["13a solves"] = time.perf_counter() - t_phase
    x_np = x.detach().cpu().numpy()
    lam = b.grad.cpu().numpy()
    rel = _host_residual((ip, ix, v), x_np, b_np)
    # the transposed residual ||g - A^T lam|| / ||g||, in f64 on the host
    at_lam = np.bincount(ix, weights=v.astype(np.float64)
                         * lam.astype(np.float64)[np.repeat(np.arange(n),
                                                            np.diff(ip))],
                         minlength=n)
    rel_t = float(np.linalg.norm(g_np - at_lam) / np.linalg.norm(g_np))
    rows = np.repeat(np.arange(n), np.diff(ip))
    want = -lam.astype(np.float64)[rows] * x_np.astype(np.float64)[ix]
    got = vals.grad.cpu().numpy().astype(np.float64)
    dv = float(np.abs(got - want).max() / np.abs(want).max())
    marks["13a host checks"] = time.perf_counter() - t_phase
    # device time: a capped forward of IMPLICIT_WINDOW cycles, profiled
    window = make_implicit_solve(
        ip, ix, shape, restart=KRYLOV_RESTART, executor=ex,
        stop=Stop(max_iters=IMPLICIT_WINDOW * KRYLOV_RESTART,
                  reduction_factor=1e-30))
    prof = _device_profile(torch, lambda: window(vals.detach(), b.detach()),
                           f"13a forward, {IMPLICIT_WINDOW} GMRES cycles",
                           IMPLICIT_WINDOW, "cycle", tag="implicit")
    us_cycle = prof["device_busy_us"] / IMPLICIT_WINDOW
    marks["13a profile"] = time.perf_counter() - t_phase
    say(f"[implicit] convection_diffusion_2d({KRYLOV_N_SIDE}, "
        f"{KRYLOV_CONVDIFF}): {n} rows, CSR, GMRES({KRYLOV_RESTART}) "
        f"{IMPLICIT_STOP}: forward {t_fwd:.3f} s, true relative residual "
        f"{rel:.3e}; backward {t_bwd:.3f} s, transposed residual "
        f"{rel_t:.3e}; values gradient against -lam[row] x[col] in f64 "
        f"{dv:.3e} (relative); {us_cycle:.0f} us of device time a cycle")
    if not (rel <= 1e-5 and rel_t <= 1e-5 and dv <= 1e-5):
        fail("13a: a residual or the values gradient is off")
    out["implicit"] = {"n": n, "forward_s": t_fwd, "backward_s": t_bwd,
                       "true_rel_res": rel, "transposed_rel_res": rel_t,
                       "values_grad_rel_err": dv,
                       "device_us_per_cycle": us_cycle, "profile": prof}

    # 13b: the DEQ model, batch DEQ_BATCH, on the card against the CPU
    def loss_and_grads(cfg, params, batch):
        params = {k: p.detach().clone().requires_grad_(True)
                  for k, p in params.items()}
        loss = deq.deq_loss(params, batch, cfg)
        loss.backward()
        return loss.detach(), {k: p.grad for k, p in params.items()}

    cfg = deq.DeqConfig(device="cuda", executor=ex)
    cfg_cpu = deq.DeqConfig(device="cpu", executor=make_executor("torch"))
    params = deq.init_deq(torch.Generator().manual_seed(SEED), cfg)
    params["theta"] = torch.from_numpy(
        rng.standard_normal(cfg.nnz).astype(np.float32)).cuda()
    # the teacher's targets are data: drawn on the CPU, then moved
    u, y = (t.cuda() for t in deq.synthetic_batch(SEED, DEQ_BATCH, cfg_cpu))
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(cfg, params, (u, y))
    torch.cuda.synchronize()
    t_deq = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_c, grads_c = loss_and_grads(
        cfg_cpu, {k: p.cpu() for k, p in params.items()}, (u.cpu(), y.cpu()))
    t_cpu = time.perf_counter() - t0
    d_loss = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    d_grad = max(float((grads[k].cpu() - grads_c[k]).abs().max()
                       / grads_c[k].abs().max()) for k in grads)
    # f64: the directional derivative against central differences
    t0 = time.perf_counter()
    cfg64 = deq.DeqConfig(device="cuda", executor=ex, dtype=torch.float64)
    p64 = {k: p.double() for k, p in params.items()}
    batch64 = (u.double(), y.double())
    _, g64 = loss_and_grads(cfg64, p64, batch64)
    gen = np.random.default_rng(SEED + 1)
    dirs = {k: torch.from_numpy(gen.standard_normal(tuple(p.shape))).cuda()
            for k, p in p64.items()}
    eps = 1e-6
    with torch.no_grad():
        lp = deq.deq_loss({k: p64[k] + eps * dirs[k] for k in p64}, batch64, cfg64)
        lm = deq.deq_loss({k: p64[k] - eps * dirs[k] for k in p64}, batch64, cfg64)
    fd = float((lp - lm) / (2 * eps))
    an = float(sum((g64[k] * dirs[k]).sum() for k in g64))
    d_fd = abs(an - fd) / max(abs(fd), 1e-30)
    t_f64 = time.perf_counter() - t0
    say(f"[implicit] DEQ {cfg.n_side}x{cfg.n_side}, d_in {cfg.d_in}, batch "
        f"{DEQ_BATCH}: loss {float(loss):.6e}, forward + backward "
        f"{t_deq:.3f} s (CPU {t_cpu:.3f} s; the f64 check {t_f64:.3f} s); against the CPU's torch space: loss {d_loss:.2e}, "
        f"gradients {d_grad:.2e} (relative); f64 directional derivative "
        f"{an:.6e} against central differences {fd:.6e} ({d_fd:.2e})")
    if not (d_loss <= 1e-4 and d_grad <= 1e-4 and d_fd <= 1e-3):
        fail("13b: the DEQ's loss or gradients disagree")
    out["deq"] = {"batch": DEQ_BATCH, "loss": float(loss), "seconds": t_deq,
                  "cpu_seconds": t_cpu, "f64_check_seconds": t_f64,
                  "loss_rel_err_cpu": d_loss, "grad_rel_err_cpu": d_grad,
                  "fd_rel_err_f64": d_fd}
    out["seconds"] = time.perf_counter() - t_phase
    marks["13b"] = out["seconds"]
    out["timeline_s"] = marks
    say(f"[implicit] phase 13 took {out['seconds']:.1f} s; timeline (s): "
        + ", ".join(f"{k} {t:.1f}" for k, t in marks.items()))
    return out


# -- phase 14: the transformer families and cooperative groups ------------------------


def _family_counts(cfg) -> tuple:
    """rmsnorm and flash_attention launches of one prefill and of one decode
    step: the blocks' two norms (four with MLA's q and kv norms; none with
    LayerNorm) and the final one; one flash attention a layer a prefill."""
    L = cfg.n_layers
    norms = 0 if cfg.norm_kind == "layernorm" else (
        4 * L + 1 if cfg.family == "mla" else 2 * L + 1)
    return ({"rmsnorm": norms, "flash_attention": L},
            {"rmsnorm": norms, "flash_attention": 0})


def _family_launches(K, want: dict, where: str) -> dict:
    """Every kernel's launches since the last reset: FAMILY_KERNELS as in
    ``want``, the rest none."""
    counts = K.launch_counts()
    for name in K.KERNELS:
        if counts[name] != want.get(name, 0):
            fail(f"{where}: {name} launched {counts[name]} times, expected "
                 f"{want.get(name, 0)}")
    return {n: counts[n] for n in FAMILY_KERNELS}


class _Routes:
    """While active (``moe._router`` wrapped), records the MoE router's
    top-k expert ids call by call; with ``replay``, a list of such ids (the
    cuda space's), routes each call to the recorded experts instead, their
    weights the softmax of this call's own router logits renormalised over
    them (``moe._router``'s rule), so a comparison of two spaces holds the
    kernels' numerics and not the discrete choices those numerics tip."""

    def __init__(self, torch, moe_lib, replay=None):
        self.torch = torch
        self.moe = moe_lib
        self.replay = replay
        self.ids = []

    def __enter__(self):
        self.orig = self.moe._router

        def wrapped(router_w, x2, cfg):
            w, ids, m = self.orig(router_w, x2, cfg)
            if self.replay is not None:
                ids = self.replay[len(self.ids)]
                probs = self.torch.softmax(x2.float() @ router_w, dim=-1)
                w = probs.gather(-1, ids)
                w = w / w.sum(dim=-1, keepdim=True)
            self.ids.append(ids)
            return w, ids, m

        self.moe._router = wrapped
        return self

    def __exit__(self, *exc):
        self.moe._router = self.orig


def _route_flips(a: list, b: list) -> dict:
    """Tokens whose expert set differs between two recordings: on the first
    layer and over all layers (the calls both recordings hold)."""
    per_layer = [int((x.sort(dim=-1).values != y.sort(dim=-1).values)
                     .any(dim=-1).sum()) for x, y in zip(a, b)]
    return {"tokens": int(a[0].shape[0]), "calls": len(per_layer),
            "first_layer": per_layer[0], "all_layers": sum(per_layer)}


def _serve_family(torch, cfg, gen_len: int, full: bool, copy_bw) -> tuple:
    """One configuration: (a) the counted serve call, (d) a counted prefill
    and decode steps under torch.profiler, (b) the torch space on the card
    teacher-forced, (c) f32 at reduced depth (full-depth models); returns
    the serve call's launches and the summary."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.nn import moe as moe_lib

    t_cfg = time.perf_counter()
    dev = torch.device("cuda")
    ex = make_executor("cuda")
    ex_t = make_executor("torch", device=dev)
    B, S = LM_BATCH, LM_PROMPT
    per_prefill, per_step = _family_counts(cfg)
    moe = cfg.family == "moe"
    tag = f"[families] {cfg.name}"
    summary = {"arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
               "batch": B, "prompt_len": S, "gen_len": gen_len}

    t0 = time.perf_counter()
    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    summary.update(init_s=time.perf_counter() - t0, params=n_params)
    say(f"{tag}: {cfg.family}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads; {n_params} parameters "
        f"({n_params * 2 / 1e9:.3f} GB bf16), init {summary['init_s']:.2f} s")

    # (a) the counted run: the user's entry point
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with _Routes(torch, moe_lib) as routes_a:  # keeps references: no extra work
        res = serve_lib.serve(cfg, batch=B, prompt_len=S, gen_len=gen_len,
                              seed=SEED, executor=ex, device=dev,
                              params=params)
    want = {n: per_prefill[n] + (gen_len - 1) * per_step[n]
            for n in FAMILY_KERNELS}
    launches = _family_launches(K, want, f"{cfg.name} serve")
    if res.tokens.shape != (B, gen_len) or not (
            0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab):
        fail(f"{cfg.name}: serve produced tokens of shape "
             f"{tuple(res.tokens.shape)} or out of the vocabulary")
    if not _finite(torch, res.prefill_logits) or not all(
            _finite(torch, lg) for lg in res.step_logits):
        fail(f"{cfg.name}: serve produced non-finite logits")
    decode_ms = res.decode_s / (gen_len - 1) * 1e3
    summary.update(prefill_ms=res.prefill_s * 1e3, decode_ms_per_step=decode_ms,
                   decode_tokens_per_s=res.tokens_per_s,
                   prefill_tokens_per_s=B * S / res.prefill_s,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=launches, per_prefill=per_prefill,
                   per_step=per_step)
    say(f"{tag} (a) serve {B} x {S} + {gen_len} greedy tokens: prefill "
        f"{res.prefill_s * 1e3:.1f} ms, decode {decode_ms:.2f} ms a step "
        f"({res.tokens_per_s:.1f} tokens/s); peak memory "
        f"{summary['peak_memory_gb']:.2f} GB; launches {launches} (a prefill "
        f"{per_prefill}, a step {per_step})")

    with torch.inference_mode():
        # (d) a warm prefill and decode steps, each counted, under the profiler
        steps = min(4, gen_len - 1)
        cache = lm.init_cache(cfg, B, S + steps, device=dev)
        K.reset_launch_counts()
        summary["profile_prefill"] = _device_profile(
            torch, lambda: lm.prefill(params, cfg, cache=cache, executor=ex,
                                      **serve_lib.feed(cfg, params,
                                                       res.prompt)),
            f"{cfg.name} prefill of {B} x {S}", 1, "prefill", tag="families")
        _family_launches(K, per_prefill, f"{cfg.name} prefill")
        summary["warm_prefill_ms"] = summary["profile_prefill"]["wall_us"] / 1e3

        def decode_steps(tokens=res.tokens):
            for j in range(steps):
                lm.decode_step(params, cfg, length=S + j, cache=cache,
                               executor=ex,
                               **serve_lib.feed(cfg, params, tokens=tokens[:, j]))

        K.reset_launch_counts()
        summary["profile_decode"] = _device_profile(
            torch, decode_steps, f"{cfg.name} {steps} decode steps", steps,
            "step", tag="families")
        _family_launches(K, {n: steps * per_step[n] for n in FAMILY_KERNELS},
                         f"{cfg.name} decode steps")
        del cache

        # (b) the torch space on the card, teacher-forced with (a)'s tokens
        # (and, for MoE, routed as (a) routed: replayed)
        K.reset_launch_counts()
        cmp_steps = min(FAMILY_CMP_STEPS, gen_len - 1)
        cache_t = lm.init_cache(cfg, B, S + cmp_steps, device=dev)
        prefill_t = steps_lib.make_prefill_step(cfg, executor=ex_t)
        decode_t = steps_lib.make_decode_step(cfg, executor=ex_t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _Routes(torch, moe_lib, replay=routes_a.ids if moe else None):
            lt, cache_t = prefill_t(params, serve_lib.feed(cfg, params,
                                                           res.prompt), cache_t)
            torch.cuda.synchronize()
            t_prefill_t = time.perf_counter() - t0
            errs = [_rel_err(lt, res.prefill_logits)]
            picks = [lt.argmax(-1)]  # the torch space's greedy token, each step
            for j in range(cmp_steps):
                lt, cache_t = decode_t(params, serve_lib.feed(
                    cfg, params, tokens=res.tokens[:, j]), S + j, cache_t)
                errs.append(_rel_err(lt, res.step_logits[j]))
                picks.append(lt.argmax(-1))
        if moe:
            # the torch space routing by its own router: the tokens whose
            # expert set flips, and what the flips do to the logits (a
            # finding, not held)
            cache_f = lm.init_cache(cfg, B, S, device=dev)
            with _Routes(torch, moe_lib) as routes_t:
                lf, _ = prefill_t(params, serve_lib.feed(cfg, params,
                                                         res.prompt), cache_f)
            summary["route_flips_bf16"] = _route_flips(
                routes_a.ids[:cfg.n_layers], routes_t.ids)
            summary["free_routing_prefill_error"] = _rel_err(
                lf, res.prefill_logits)
            del cache_f, lf, routes_t
        _family_launches(K, {}, f"{cfg.name} torch space")
        del cache_t
    picks = torch.stack(picks, dim=1)  # (B, cmp_steps + 1)
    top1 = float((picks == res.tokens[:, :cmp_steps + 1]).float().mean())
    summary.update(torch_space_prefill_ms=t_prefill_t * 1e3,
                   torch_space_prefill_error=errs[0],
                   torch_space_decode_error=max(errs[1:]),
                   top1_agreement=top1, compared_steps=cmp_steps,
                   greedy_tokens=res.tokens[0, :cmp_steps + 1].tolist(),
                   torch_space_greedy_tokens=picks[0].tolist())
    say(f"{tag} (b) torch space on the card: prefill {t_prefill_t * 1e3:.1f} ms; "
        f"prefill logits error {errs[0]:.3e}, {cmp_steps} decode steps' largest "
        f"{max(errs[1:]):.3e} of max |logit| (tolerance {LM_BF16_TOL}); greedy "
        f"tokens agree at {top1:.4f} of (row, step): cuda "
        f"{summary['greedy_tokens']}, torch "
        f"{summary['torch_space_greedy_tokens']} (row 0)"
        + (f"; MoE routed as the cuda space routed; routing by its own "
           f"router instead: {summary['route_flips_bf16']} tokens with "
           f"another expert set, prefill logits error "
           f"{summary['free_routing_prefill_error']:.3e}" if moe else ""))
    if not max(errs) <= LM_BF16_TOL:
        fail(f"{cfg.name}: the cuda and torch spaces disagree on the serving "
             "path")
    del params, res, routes_a
    torch.cuda.empty_cache()

    if full:
        # (c) full width at reduced depth in f32: the kernels cannot hide in
        # bf16 noise, and MoE must route identically in both spaces
        cfg32 = dataclasses.replace(cfg, n_layers=FAMILY_F32_LAYERS,
                                    dtype="float32")
        p32 = lm.init_model(cfg32, torch.Generator(dev).manual_seed(SEED + 1),
                            dev)
        prompt = serve_lib._prompt(cfg32, FAMILY_F32_BATCH, FAMILY_F32_PROMPT,
                                   SEED + 1, dev)
        out32, routes = {}, {}
        with torch.inference_mode():
            for space, exe in (("cuda", ex), ("torch", ex_t)):
                c32 = lm.init_cache(cfg32, FAMILY_F32_BATCH,
                                    FAMILY_F32_PROMPT + 2, device=dev)
                with _Routes(torch, moe_lib) as rec:
                    lg, c32 = lm.prefill(p32, cfg32, cache=c32, executor=exe,
                                         **serve_lib.feed(cfg32, p32, prompt))
                    nxt = lg[:, -1].argmax(-1)
                    ld, c32 = lm.decode_step(
                        p32, cfg32, length=FAMILY_F32_PROMPT, cache=c32,
                        executor=exe, **serve_lib.feed(cfg32, p32, tokens=nxt))
                out32[space], routes[space] = (lg, ld), rec.ids
        err_c = _rel_err(out32["cuda"][0], out32["torch"][0])
        err_cd = _rel_err(out32["cuda"][1], out32["torch"][1])
        summary.update(f32_prefill_error=err_c, f32_decode_error=err_cd)
        flips = None
        if moe:
            flips = _route_flips(routes["cuda"], routes["torch"])
            summary["route_flips_f32"] = flips
        say(f"{tag} (c) f32, {FAMILY_F32_LAYERS} layers, {FAMILY_F32_BATCH} x "
            f"{FAMILY_F32_PROMPT}: prefill logits error {err_c:.3e}, decode "
            f"step {err_cd:.3e} of max |logit| (tolerance {LM_F32_TOL})"
            + (f"; routing {flips}" if moe else ""))
        if not max(err_c, err_cd) <= LM_F32_TOL:
            fail(f"{cfg.name}: the f32 path disagrees between the cuda and "
                 "torch spaces")
        if moe and flips["all_layers"]:
            fail(f"{cfg.name}: in f32 the cuda and torch spaces route "
                 f"differently ({flips})")
        del p32, out32, routes
        torch.cuda.empty_cache()
    summary["seconds"] = time.perf_counter() - t_cfg
    return launches, summary


def phase_family_kernels(torch, copy_bw) -> dict:
    """rmsnorm and flash_attention at phase 14's new shapes against their
    plain versions, timed (phase 3's protocol) beside their bounds and
    library calls; flash_attention also in f32 at D 96 and 128 (phase
    14c's path, the CUDA-core kernel, bound at the f32 rate)."""
    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.core.params import H100

    ex = make_executor("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    row = functools.partial(kernel_row, torch, flush, copy_bw)
    bf16 = torch.bfloat16
    B, S = LM_BATCH, LM_PROMPT
    out = {"rmsnorm": [], "flash_attention": []}

    # rmsnorm: (label, rows, d, row stride, scale dtype); MLA's q and kv
    # norms take a bf16 scale, its kv norm reads the latent columns of the
    # kv projection (rows 288 apart) a prefill and the whole latent cache
    # (8 x 2,112 rows) a decode step
    for label, rows, d, ld, wdt in (
            ("smollm-135m", B * S, 576, 576, torch.float32),
            ("minicpm3-4b q_norm", B * S, 768, 768, bf16),
            ("minicpm3-4b kv_norm, strided", B * S, 256, 288, bf16),
            ("minicpm3-4b kv_norm, decode cache", B * (S + LM_GEN), 256, 256,
             bf16),
            ("qwen2-moe / olmoe", B * S, 2048, 2048, torch.float32),
            ("granite / yi", B * S, 4096, 4096, torch.float32)):
        base = torch.randn(rows, ld, generator=gen, device="cuda").to(bf16)
        x = base[:, :d]
        w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(wdt)
        rpb = ex.launch_config("nn_rmsnorm", {"rows": rows, "d": d,
                                              "itemsize": 2})["rows_per_block"]
        y = K.rmsnorm(x, w, 1e-5, rows_per_block=rpb)
        err = _held(torch, f"rmsnorm {label} at {rows} x {d} (row stride {ld})",
                    y, K.rmsnorm_plain(x, w, 1e-5), 2.0 ** -7, 1e-6)
        if ld != d:
            same = torch.equal(y, K.rmsnorm(x.contiguous(), w, 1e-5,
                                            rows_per_block=rpb))
            say(f"[kernels] rmsnorm strided rows bitwise equal to a contiguous "
                f"copy's: {same}")
            if not same:
                fail("rmsnorm: strided rows differ from a contiguous copy")
        w_lib = w.to(bf16)
        entry = row("rmsnorm", "rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:27", err,
                    lambda: K.rmsnorm(x, w, 1e-5, rows_per_block=rpb),
                    lambda: K.rmsnorm_plain(x, w, 1e-5),
                    2 * rows * d * 2 + d * w.element_size(), 4 * rows * d,
                    lambda: torch.nn.functional.rms_norm(x, (d,), w_lib, 1e-5))
        entry["shape"] = {"config": label, "rows": rows, "d": d,
                          "row_stride": ld, "scale": str(wdt).removeprefix(
                              "torch.")}
        out["rmsnorm"].append(entry)
        del base, x, y

    def qkv(Bq, Hq, Hkv, Sq, D, dtype, Dv=None):
        r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
        v = r(Bq, Hkv, Sq, Dv or D)
        if Dv:  # MLA: v padded with zeros to the q / k head dim
            v = torch.nn.functional.pad(v, (0, D - Dv))
        return r(Bq, Hq, Sq, D), r(Bq, Hkv, Sq, D), v

    # bf16 at the serving shapes; f32 (the CUDA-core kernel) at phase 14c's
    for label, (Bq, Hq, Hkv, Sq, D, Dv, dtype) in (
            ("granite-8b / pixtral-12b", (B, 32, 8, S, 128, None, bf16)),
            ("yi-9b", (B, 32, 4, S, 128, None, bf16)),
            ("qwen2-moe / olmoe", (B, 16, 16, S, 128, None, bf16)),
            ("minicpm3-4b (v 64 padded to 96)", (B, 40, 40, S, 96, 64, bf16)),
            ("musicgen-large", (B, 32, 32, S, 64, None, bf16)),
            ("smollm-135m", (B, 9, 3, S, 64, None, bf16)),
            ("minicpm3-4b f32", (2, 40, 40, FAMILY_F32_PROMPT, 96, 64,
                                 torch.float32)),
            ("qwen2-moe f32", (2, 16, 16, FAMILY_F32_PROMPT, 128, None,
                               torch.float32))):
        q, k, v = qkv(Bq, Hq, Hkv, Sq, D, dtype, Dv)
        o = K.flash_attention(q, k, v)
        tol = (2.0 ** -7, 1e-5) if dtype == bf16 else (0.0, 1e-5)
        err = _held(torch, f"flash_attention {label}: B {Bq}, {Hq}/{Hkv} heads, "
                    f"S = Skv = {Sq}, D {D}", o, K.flash_attention_plain(q, k, v),
                    *tol)
        if Dv and not bool((o[..., Dv:] == 0).all()):
            fail("flash_attention: the padded v columns did not give zeros")
        lib = functools.partial(torch.nn.functional.scaled_dot_product_attention,
                                q, k, v, is_causal=True, enable_gqa=Hq != Hkv)
        entry = row("flash_attention", "flash_attention.cu",
                    "src/repro/kernels/flash_attention/kernel.py:118", err,
                    lambda: K.flash_attention(q, k, v),
                    lambda: K.flash_attention_plain(q, k, v),
                    2 * Bq * (Hq + Hkv) * Sq * D * q.element_size(),
                    4 * D * Bq * Hq * (Sq * (Sq + 1) // 2), lib,
                    peak_flops=H100.peak_flops_bf16 if dtype == bf16 else None)
        entry["shape"] = {"config": label, "B": Bq, "Hq": Hq, "Hkv": Hkv,
                          "S": Sq, "Skv": Sq, "D": D,
                          "dtype": str(dtype).removeprefix("torch.")}
        out["flash_attention"].append(entry)
        del q, k, v, o
    say("[kernels] phase 14 library_ms: F.rms_norm (scale cast to bf16) and "
        "F.scaled_dot_product_attention(is_causal=True, enable_gqa)")
    return out


def phase_coop(torch) -> dict:
    """repro_torch.core.coop on CUDA tensors against the same calls on the
    CPU, bitwise (values and dtype), over the cases of tests/core/
    test_coop.py."""
    from repro_torch.core import coop

    gen = torch.Generator().manual_seed(SEED + 14)
    cases = []

    def normal(*shape):
        return torch.randn(*shape, generator=gen)

    def bits(*shape):
        return torch.randint(0, 2, shape, generator=gen).bool()

    for size in (2, 4, 8, 16, 32, 64, 128):
        cases.append((f"sum {size}", lambda x, s=size: coop.subgroup(x, s).sum(),
                      normal(4, 128)))
    for name in ("max", "min"):
        cases.append((name, lambda x, n=name: getattr(coop.subgroup(x, 8), n)(),
                      normal(2, 64)))
    for size in (2, 4, 8, 16, 32):
        cases.append((f"inclusive_scan {size}",
                      lambda x, s=size: coop.subgroup(x, s).inclusive_scan(),
                      normal(3, 64)))
    for size in (8, 16, 32):
        for bm in range(8):
            cases.append((f"shfl_xor {bm} of {size}",
                          lambda x, s=size, b=bm: coop.subgroup(x, s).shfl_xor(b),
                          normal(2, 128)))
    cases.append(("shfl 3", lambda x: coop.subgroup(x, 8).shfl(3), normal(2, 32)))
    cases.append(("shfl_down 2", lambda x: coop.subgroup(x, 8).shfl_down(2),
                  normal(2, 32)))
    cases.append(("thread_rank", lambda x: coop.subgroup(x, 8).thread_rank(),
                  normal(2, 32)))
    for size in (2, 4, 8, 16, 32):
        for rep in range(3):
            pred = bits(128)
            for op in ("ballot", "any", "all", "count"):
                cases.append((f"{op} {size} #{rep}",
                              lambda p, s=size, o=op: getattr(
                                  coop.subgroup(p, s, warp_size=32), o)(p),
                              pred))
    wave = torch.tensor([i % 3 == 0 for i in range(64)] * 2)
    for op in ("ballot", "count"):
        cases.append((f"{op} 8 of 64 lanes",
                      lambda p, o=op: getattr(coop.subgroup(p, 8, 64), o)(p),
                      wave))
    full = bits(2, 64)
    full[:, 63] = True
    for op in ("ballot", "count", "all", "any"):
        cases.append((f"{op} 64 of 64 lanes, lane 63 set",
                      lambda p, o=op: getattr(coop.subgroup(p, 64, 64), o)(p),
                      full))
    for dt in (torch.int32, torch.int64):
        cases.append((f"popcnt {dt}", coop.popcnt,
                      torch.randint(-2 ** 31, 2 ** 31 - 1, (64,), generator=gen,
                                    dtype=torch.int64).to(dt)))
    u64 = torch.randint(-2 ** 62, 2 ** 62, (64,), generator=gen)
    u64[0] = -1
    u64[1] = -2 ** 63
    cases.append(("popcnt uint64", coop.popcnt, u64.view(torch.uint64)))
    cases.append(("popcnt uint32", coop.popcnt,
                  torch.randint(0, 2 ** 32 - 1, (64,), generator=gen).to(
                      torch.uint32)))

    bad = []
    for label, fn, x in cases:
        want = fn(x)
        got = fn(x.cuda())
        if got.device.type != "cuda" or got.dtype != want.dtype or not \
                torch.equal(got.cpu(), want):
            bad.append(label)
    say(f"[coop] {len(cases)} cases of tests/core/test_coop.py on CUDA tensors: "
        f"{len(cases) - len(bad)} bitwise equal to the CPU's")
    if bad:
        fail(f"coop on CUDA differs from the CPU: {bad}")
    return {"cases": len(cases), "bitwise_equal": len(cases) - len(bad)}


def phase_families(torch, copy_bw) -> tuple:
    """Phase 14: the dense, MoE and MLA families served on the ported
    kernels (see the module docstring), cooperative groups on the card, and
    the two LM kernels at the families' shapes."""
    import dataclasses

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    paths, summary = {}, {"models": {}}
    for arch in FAMILY_FULL + FAMILY_SHALLOW:
        cfg = get_config(arch)
        full = arch in FAMILY_FULL
        if not full:
            cfg = dataclasses.replace(cfg, n_layers=FAMILY_SHALLOW_LAYERS)
        launches, summary["models"][arch] = _serve_family(
            torch, cfg, LM_GEN if full else FAMILY_SHALLOW_GEN, full, copy_bw)
        paths[f"{arch}_serve"] = launches
    summary["coop"] = phase_coop(torch)
    rows = phase_family_kernels(torch, copy_bw)
    summary["seconds"] = time.perf_counter() - t_phase
    say(f"[families] phase 14 took {summary['seconds']:.1f} s: "
        + ", ".join(f"{a} {m['seconds']:.1f}"
                    for a, m in summary["models"].items()))
    return paths, summary, rows


# -- phase 15: training ----------------------------------------------------------


def _train_batch(torch, cfg, batch: int, seq: int, step: int = 0,
                 seed: int = TRAIN_DATA_SEED) -> dict:
    """Step ``step``'s global batch of the chain data on the card."""
    from repro_torch.data import DataConfig, global_step_batch

    dcfg = DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
        stub_embed_dim=cfg.d_model if cfg.frontend == "stub_embeddings" else 0)
    return {k: torch.from_numpy(v).cuda()
            for k, v in global_step_batch(dcfg, step).items()}


def _grad_rel(torch, ga, gb) -> dict:
    """{leaf path: ||ga - gb|| / ||gb||} over two gradient trees."""
    from repro_torch.core import tree as tree_lib

    fa, fb = tree_lib.flat(ga), tree_lib.flat(gb)
    out = {}
    for key, b in fb.items():
        a = fa[key].float()
        b = b.float()
        nb = float(torch.linalg.vector_norm(b))
        out[key] = float(torch.linalg.vector_norm(a - b)) / max(nb, 1e-30)
    return out


def _nonzero_grads(torch, grads, where: str) -> None:
    """Every leaf of ``grads`` finite and not all zero, or fail."""
    from repro_torch.core import tree as tree_lib

    bad = [k for k, g in tree_lib.flat(grads).items()
           if not (_finite(torch, g) and bool((g != 0).any()))]
    if bad:
        fail(f"{where}: {len(bad)} parameter leaves got a zero or non-finite "
             f"gradient, e.g. {bad[:5]}")
    say(f"[train] {where}: all {len(tree_lib.leaves(grads))} parameter leaves "
        "have a finite, non-zero gradient")


def _train_launches(cfg) -> dict:
    """Kernel launches of one training step of ``cfg`` (the forward's; the
    backward recomputes the plain versions and launches none)."""
    if cfg.family == "rwkv6":
        return {"rwkv6_scan_log": cfg.n_layers}
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.shared_attn_every
        return {"rmsnorm": 2 * groups + 1, "flash_attention": groups,
                "ssd_scan": cfg.n_layers}
    return dict(_family_counts(cfg)[0])


def _expect_train(K, want: dict, where: str) -> dict:
    """Every kernel's launches since the last reset as in ``want`` (absent:
    0); returns the LM kernels' counts."""
    counts = K.launch_counts()
    bad = {n: counts[n] for n in K.KERNELS if counts[n] != want.get(n, 0)}
    if bad:
        fail(f"{where}: kernel launches {bad}, expected "
             f"{ {n: want.get(n, 0) for n in bad} }")
    return {n: counts[n] for n in TRAIN_KERNELS}


def _space_grads(torch, cfg, params, batch, ex, ex_t, where: str,
                 moe: bool, hold: bool, loss_tol: float, grad_tol: float,
                 remat: bool = False):
    """The first step's loss and gradients in the cuda space (counted, each
    leaf finite and non-zero) and in the torch space on the same
    parameters and batch (with ``remat`` every block checkpointed, so that
    one layer's plain attention scores are held at a time; MoE routed as
    the cuda space routed); with ``hold``, the loss within ``loss_tol``
    relative and every leaf's gradient within ``grad_tol``
    (||g_cuda - g_torch|| / ||g_torch||)."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.launch import steps as steps_lib
    from repro_torch.nn import moe as moe_lib

    K.reset_launch_counts()
    with _Routes(torch, moe_lib) as routes:
        loss_c, _, g_c = steps_lib.loss_and_grads(params, cfg, batch, ex)
    torch.cuda.synchronize()
    counts = _expect_train(K, _train_launches(cfg), f"{where} cuda step")
    _nonzero_grads(torch, g_c, f"{where} cuda space")
    cfg_t = dataclasses.replace(cfg, remat="block") if remat else cfg
    with _Routes(torch, moe_lib, replay=routes.ids if moe else None):
        loss_t, _, g_t = steps_lib.loss_and_grads(params, cfg_t, batch, ex_t)
    torch.cuda.synchronize()
    rel = _grad_rel(torch, g_c, g_t)
    worst = max(rel, key=rel.get)
    loss_err = abs(float(loss_c) - float(loss_t)) / abs(float(loss_t))
    out = {"loss_cuda": float(loss_c), "loss_torch": float(loss_t),
           "loss_rel_err": loss_err, "grad_rel_max": rel[worst],
           "grad_rel_worst_leaf": worst, "grad_rel_median":
           statistics.median(rel.values()), "leaves": len(rel),
           "launches": counts}
    say(f"[train] {where}: loss cuda {float(loss_c):.6f}, torch "
        f"{float(loss_t):.6f} (rel {loss_err:.3e}, tolerance {loss_tol}); "
        f"gradient ||g_cuda - g_torch|| / ||g_torch|| over {len(rel)} leaves: "
        f"median {out['grad_rel_median']:.3e}, largest {rel[worst]:.3e} at "
        f"{worst} (tolerance {grad_tol}{'' if hold else ', printed only'})")
    for key in sorted(rel, key=rel.get, reverse=True)[:4]:
        say(f"[train]   {key}: {rel[key]:.3e}")
    if hold and not (loss_err <= loss_tol and rel[worst] <= grad_tol):
        fail(f"{where}: the cuda and torch spaces' loss or gradients disagree")
    del g_c, g_t
    torch.cuda.empty_cache()
    return out


def _train_profile(torch, cfg, params, ex, steps: int = 2) -> dict:
    """``steps`` train steps split into forward (loss), backward (gradients)
    and optimizer, each timed by CUDA events, the whole under
    torch.profiler (device busy share)."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.models import lm
    from repro_torch.optim import adamw, warmup_cosine_schedule

    opt = adamw(warmup_cosine_schedule(3e-3, 4, TRAIN_STEPS), weight_decay=0.01)
    state = opt.init(params)
    batches = [_train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, s)
               for s in range(steps)]
    leaves = tree_lib.leaves(params)
    marks = []

    def run():
        for batch in batches:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss, _ = lm.loss_fn(params, cfg, batch, executor=ex)
            ev[1].record()
            grads = torch.autograd.grad(loss, leaves)
            ev[2].record()
            it = iter(grads)
            opt.update(params, tree_lib.tree_map(lambda _: next(it), params),
                       state)
            ev[3].record()
            marks.append(ev)
            del loss, grads

    prof = _device_profile(torch, run, f"{cfg.name} train steps", steps,
                           "step", tag="profile train")
    torch.cuda.synchronize()
    split = {name: statistics.median(e[i].elapsed_time(e[i + 1])
                                     for e in marks)
             for i, name in enumerate(("forward_ms", "backward_ms",
                                       "optimizer_ms"))}
    say(f"[train] {cfg.name} step split under the profiler (median of "
        f"{steps}): forward {split['forward_ms']:.1f} ms, backward "
        f"{split['backward_ms']:.1f} ms, optimizer {split['optimizer_ms']:.1f} ms")
    prof.update(split)
    return prof


def phase_train_main(torch, card: str) -> tuple:
    """15a: smollm-135m at full width and depth through launch/train.py's
    train() on the CUDA executor, then 15b: the first step's loss and
    gradients against the torch space, in bf16 at 15a's size and in f32 at
    2 layers (TF32 off)."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import make_executor
    from repro_torch.data import DataConfig, entropy_floor
    from repro_torch.launch import train as train_lib
    from repro_torch.models import lm
    from repro_torch.nn.common import trainable

    cfg = get_config(TRAIN_ARCH)
    ex = make_executor("cuda")
    ex_t = make_executor("torch", device="cuda")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    say(f"[train] 15a {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}, "
        f"{cfg.dtype}; {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens through repro_torch.launch.train.train ({card})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    params, losses = train_lib.train(cfg, steps=TRAIN_STEPS,
                                     global_batch=TRAIN_BATCH,
                                     seq_len=TRAIN_SEQ, log_every=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_step = _train_launches(cfg)
    launches = _expect_train(
        K, {n: TRAIN_STEPS * c for n, c in per_step.items()},
        f"{cfg.name} train()")
    peak = torch.cuda.max_memory_allocated()
    floor = entropy_floor(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                     global_batch=TRAIN_BATCH,
                                     seed=TRAIN_DATA_SEED))
    start, end = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    step_ms = wall / TRAIN_STEPS * 1e3
    summary = {"arch": cfg.name, "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
               "seq_len": TRAIN_SEQ, "losses": losses, "first5": start,
               "last5": end, "entropy_floor": floor, "wall_s": wall,
               "step_ms": step_ms,
               "tokens_per_s": TRAIN_STEPS * tokens / wall,
               "peak_memory_bytes": peak, "launches": launches,
               "launches_per_step": per_step}
    say(f"[train] 15a: loss {losses[0]:.4f} -> {losses[-1]:.4f}; mean of the "
        f"first 5 {start:.4f}, of the last 5 {end:.4f} (need <= start - "
        f"{TRAIN_DROP} and > floor {floor:.4f} - 0.05); train() took "
        f"{wall:.2f} s by the wall clock, set-up and the first step "
        f"included: {step_ms:.1f} ms a step, "
        f"{summary['tokens_per_s']:.0f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches} "
        f"({per_step} a step)")
    if not (end <= start - TRAIN_DROP and end > floor - 0.05):
        fail(f"{cfg.name}: training did not learn the chain "
             f"({start:.4f} -> {end:.4f})")
    summary["profile"] = _train_profile(torch, cfg, params, ex)
    del params
    torch.cuda.empty_cache()

    # 15b: the first step from seed-0 weights, both spaces
    params = trainable(lm.init_model(cfg, device="cuda"))
    batch = _train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ)
    summary["bf16_vs_torch"] = _space_grads(
        torch, cfg, params, batch, ex, ex_t, f"15b {cfg.name} bf16", False,
        True, TRAIN_BF16_LOSS_TOL, TRAIN_BF16_GRAD_TOL, remat=True)
    del params
    cfg32 = dataclasses.replace(cfg, n_layers=TRAIN_SHALLOW, dtype="float32")
    params = trainable(lm.init_model(cfg32, device="cuda"))
    summary["f32_vs_torch"] = _space_grads(
        torch, cfg32, params, batch, ex, ex_t,
        f"15b {cfg.name} f32 {TRAIN_SHALLOW} layers", False, True,
        TRAIN_F32_LOSS_TOL, TRAIN_F32_GRAD_TOL)
    del params, batch
    torch.cuda.empty_cache()
    return launches, summary


def phase_train_resume(torch) -> dict:
    """15c: checkpoint and resume on the card (smollm-135m, full width, 2
    layers, 20 steps of TRAIN_DP_BATCH x TRAIN_DP_SEQ), and a simulated
    preemption."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_lib
    from repro_torch.runtime import PreemptionHandler

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_SHALLOW)
    kw = dict(steps=TRAIN_RESUME_STEPS, global_batch=TRAIN_DP_BATCH,
              seq_len=TRAIN_DP_SEQ, log_every=TRAIN_RESUME_STEPS)
    with tempfile.TemporaryDirectory() as d:
        _, full = train_lib.train(cfg, **kw)
        _, first = train_lib.train(cfg, ckpt_dir=d, ckpt_every=TRAIN_RESUME_STOP,
                                   stop_at_step=TRAIN_RESUME_STOP, **kw)
        _, rest = train_lib.train(cfg, ckpt_dir=d,
                                  ckpt_every=TRAIN_RESUME_STOP, resume=True,
                                  **kw)
    with tempfile.TemporaryDirectory() as d:
        handler = PreemptionHandler()
        handler.simulate()
        train_lib.train(cfg, ckpt_dir=d, ckpt_every=1000, preemption=handler,
                        **kw)
        preempt_step = CheckpointManager(d).latest_step()
    head = TRAIN_RESUME_STOP
    tail_err = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(rest, full[head:]))
    out = {"steps": TRAIN_RESUME_STEPS, "stop": head,
           "first_bitwise": first == full[:head],
           "rest_bitwise": rest == full[head:],
           "rest_max_rel": tail_err,
           "rest_within_tol": all(abs(a - b) <= TRAIN_RESUME_TOL
                                  + TRAIN_RESUME_TOL * abs(b)
                                  for a, b in zip(rest, full[head:])),
           "preemption_checkpoint_step": preempt_step}
    say(f"[train] 15c resume: first {head} losses bitwise "
        f"{out['first_bitwise']}; the resumed {len(rest)} within rtol = atol "
        f"= {TRAIN_RESUME_TOL}: {out['rest_within_tol']} (largest relative "
        f"{tail_err:.3e}, bitwise {out['rest_bitwise']}); preemption "
        f"checkpointed step {preempt_step}")
    if not (out["first_bitwise"] and len(rest) == TRAIN_RESUME_STEPS - head
            and out["rest_within_tol"] and preempt_step == 1):
        fail("15c: resume or preemption failed")
    return out


def phase_train_families(torch) -> tuple:
    """15d: one bf16 train step each of zamba2-2.7b (one group), rwkv6-3b,
    minicpm3-4b and olmoe-1b-7b at full width, batch TRAIN_FAMILY_BATCH x
    TRAIN_FAMILY_SEQ: launches exactly, every gradient finite and non-zero,
    and the cuda space against the torch space in bf16 and in f32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import make_executor
    from repro_torch.models import lm
    from repro_torch.nn.common import trainable

    ex = make_executor("cuda")
    ex_t = make_executor("torch", device="cuda")
    total, out = {}, {}
    for arch, layers in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        moe = cfg.family == "moe"
        res = {"layers": layers}
        for dtype in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, dtype=dtype)
            params = trainable(lm.init_model(c, device="cuda"))
            if c.family == "rwkv6":
                # w0, w_lora_b and mix_lora_b are zero at init, which leaves
                # the LoRA inputs' gradients zero: seeded draws (phase 9's)
                _perturb_rwkv(torch, params, SEED + 2)
            batch = _train_batch(torch, c, TRAIN_FAMILY_BATCH,
                                 TRAIN_FAMILY_SEQ)
            bf16 = dtype == "bfloat16"
            res[dtype] = _space_grads(
                torch, c, params, batch, ex, ex_t, f"15d {arch} {dtype}",
                moe, not (moe and bf16),
                TRAIN_BF16_LOSS_TOL if bf16 else TRAIN_F32_LOSS_TOL,
                TRAIN_BF16_GRAD_TOL if bf16 else TRAIN_F32_GRAD_TOL)
            if bf16:
                for n, v in res[dtype]["launches"].items():
                    total[n] = total.get(n, 0) + v
            del params, batch
            torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t0
        out[arch] = res
    return total, out


def phase_train_dp(torch) -> dict:
    """15e: compressed data parallelism, TRAIN_DP_RANKS gloo ranks sharing
    the card (smollm-135m full width, 2 layers), beside the uncompressed
    single-card run on the same global batches, in each of
    TRAIN_DP_DTYPES, from the weights ``dp_weights`` draws from a frozen
    numpy stream (their digest the JAX package's runs': TRAIN_DP_JAX).
    Held: the compressed run within TRAIN_DP_JAX_TOL of the JAX package's
    at every step, the f32 uncompressed run within TRAIN_DP_F32_TOL, the
    bf16 compressed loss falling by 0.1, the ranks' parameters bitwise
    equal.  Printed: the bf16 uncompressed run against the JAX package's,
    and the gap between the compressed and uncompressed runs beside the
    JAX package's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed import comm
    from repro_torch.distributed.train_cases import (dp_weights, param_digest,
                                                     run_train_cases)
    from repro_torch.core import make_executor
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adamw, constant_schedule

    def gap(a, b):
        return max(abs(x - y) for x, y in zip(a, b))

    ex = make_executor("cuda")
    opt = adamw(constant_schedule(TRAIN_DP_LR), weight_decay=0.0)
    unc = {}
    for dtype in TRAIN_DP_DTYPES:
        cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                                  n_layers=TRAIN_SHALLOW, dtype=dtype)
        params = dp_weights(cfg, "cuda")
        digest = param_digest(params)
        if digest != TRAIN_DP_JAX[dtype]["weights"]:
            fail(f"15e {dtype}: the weights on the card ({digest}) are not "
                 f"the ones the JAX package's runs started from")
        state = opt.init(params)
        step = steps_lib.make_train_step(cfg, opt, executor=ex)
        unc[dtype] = []
        for i in range(TRAIN_DP_STEPS):
            batch = _train_batch(torch, cfg, TRAIN_DP_BATCH, TRAIN_DP_SEQ, i)
            params, state, m = step(params, state, batch)
            unc[dtype].append(float(m["loss"]))
        del params, state
        torch.cuda.empty_cache()
    kw = dict(arch=TRAIN_ARCH, steps=TRAIN_DP_STEPS,
              global_batch=TRAIN_DP_BATCH, seq_len=TRAIN_DP_SEQ, lr=TRAIN_DP_LR,
              smoke=False, n_layers=TRAIN_SHALLOW, data_seed=TRAIN_DATA_SEED)
    t0 = time.perf_counter()
    res = comm.run_world(
        run_train_cases, TRAIN_DP_RANKS,
        ([dict(op="compressed_dp", dtype=d, **kw) for d in TRAIN_DP_DTYPES],
         "cuda"),
        threads=max(1, (os.cpu_count() or 2) // TRAIN_DP_RANKS),
        timeout_s=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    out = {"ranks": TRAIN_DP_RANKS, "steps": TRAIN_DP_STEPS, "wall_s": wall}
    ok = True
    for n, dtype in enumerate(TRAIN_DP_DTYPES):
        jax_runs = TRAIN_DP_JAX[dtype]
        com = res[0][n]["losses"]
        digests = {r[n]["digest"] for r in res}
        o = {"compressed_losses": com, "uncompressed_losses": unc[dtype],
             "compressed_vs_jax": gap(com, jax_runs["compressed"]),
             "uncompressed_vs_jax": gap(unc[dtype], jax_runs["uncompressed"]),
             "compressed_vs_uncompressed": gap(com, unc[dtype]),
             "jax_compressed_vs_uncompressed": gap(jax_runs["compressed"],
                                                   jax_runs["uncompressed"]),
             "ranks_bitwise_equal": len(digests) == 1}
        out[dtype] = o
        unc_tol = TRAIN_DP_F32_TOL if dtype == "float32" else None
        say(f"[train] 15e {dtype}: compressed DP ({TRAIN_DP_RANKS} gloo ranks "
            f"on the card) {com[0]:.4f} -> {com[-1]:.4f}; largest step "
            f"difference from the JAX package's runs: compressed "
            f"{o['compressed_vs_jax']:.4f} (tolerance {TRAIN_DP_JAX_TOL}), "
            f"uncompressed {o['uncompressed_vs_jax']:.3e} "
            + (f"(tolerance {unc_tol})" if unc_tol else "(printed)")
            + f"; final parameters bitwise equal across ranks: "
            f"{o['ranks_bitwise_equal']}")
        say(f"[train] 15e {dtype}: compressed against uncompressed, largest "
            f"step difference {o['compressed_vs_uncompressed']:.4f} on the "
            f"card, {o['jax_compressed_vs_uncompressed']:.4f} in the JAX "
            f"package (its test holds 0.05 at its smoke config; printed)")
        for name, card in (("compressed", com), ("uncompressed", unc[dtype])):
            say(f"[train]   {name:12s} card {[round(x, 4) for x in card]}")
            say(f"[train]   {name:12s} JAX  "
                f"{[round(x, 4) for x in jax_runs[name]]}")
        ok = ok and o["compressed_vs_jax"] <= TRAIN_DP_JAX_TOL \
            and o["ranks_bitwise_equal"] \
            and (unc_tol is None or o["uncompressed_vs_jax"] <= unc_tol)
    com = out[TRAIN_DP_DTYPES[0]]["compressed_losses"]
    say(f"[train] 15e: both worlds in {wall:.1f} s; the {TRAIN_DP_DTYPES[0]} "
        f"compressed loss falls {com[0] - com[-1]:.4f} (need 0.1)")
    if not (ok and com[-1] < com[0] - 0.1):
        fail("15e: a run left the JAX package's, compressed DP did not "
             "learn, or the ranks' parameters are unequal")
    return out


def phase_train_deq(torch) -> dict:
    """15f: train_deq on the card."""
    import contextlib
    import io

    from repro_torch.launch import train as train_lib

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ok = train_lib.train_deq(steps=TRAIN_DEQ_STEPS, batch=DEQ_BATCH,
                                 device="cuda")
    text = buf.getvalue()
    for line in text.splitlines():
        say(f"[train] 15f {line}")
    if not ok or "DEQ-GATE: PASS" not in text:
        fail("15f: train_deq did not pass its gate")
    return {"steps": TRAIN_DEQ_STEPS, "seconds": time.perf_counter() - t0}


def _function_case(torch, name, kernel, plain, inputs, flush) -> dict:
    """One kernel's autograd Function at one shape: the forward bitwise the
    bare kernel's, the gradients against autograd through the plain
    version (a seeded cotangent), forward and backward device ms."""
    from repro_torch.kernels._autograd import kernel_call

    bare = kernel(*inputs)
    bare = bare if isinstance(bare, tuple) else (bare,)
    xs = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
    out = kernel_call(kernel, plain, *xs)
    out = out if isinstance(out, tuple) else (out,)
    if not all(torch.equal(a, b) for a, b in zip(out, bare)):
        fail(f"{name}: the autograd Function's forward is not the bare "
             "kernel's")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cot = torch.randn(out[0].shape, generator=gen, device="cuda").to(out[0].dtype)
    wrt = [x for x in xs if x.requires_grad]
    got = torch.autograd.grad(out[0], wrt, cot)
    ref_in = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
    ref_out = plain(*ref_in)
    ref_out = ref_out[0] if isinstance(ref_out, tuple) else ref_out
    want = torch.autograd.grad(ref_out, [x for x in ref_in if x.requires_grad],
                               cot)
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.float().abs().max()) for w in want)
    say(f"[kernels] {name} Function: forward bitwise the kernel's; gradients "
        f"max |diff| {err:.3e} against autograd through the plain version "
        f"(max |grad| {scale:.3e})")
    if not err <= TRAIN_FUNCTION_TOL * scale:
        fail(f"{name}: the Function's gradients disagree with the plain "
             "version's")

    def fwd():
        with torch.enable_grad():
            kernel_call(kernel, plain, *xs)

    def fwd_bwd():
        o = kernel_call(kernel, plain, *xs)
        o = o[0] if isinstance(o, tuple) else o
        torch.autograd.grad(o, wrt, cot)

    t_f = device_ms(torch, fwd, flush, TRAIN_FUNCTION_REPS)
    t_fb = device_ms(torch, fwd_bwd, flush, TRAIN_FUNCTION_REPS)
    return {"shape": [list(t.shape) for t in inputs], "forward_ms": t_f,
            "backward_ms": t_fb - t_f, "grad_max_abs_err": err}


def phase_train_functions(torch) -> dict:
    """15g: the four autograd Functions at 15a's and 15d's shapes."""
    import dataclasses
    import functools

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm, rmsnorm_plain
    from repro_torch.kernels.rwkv6.kernel import rwkv6_scan_log, rwkv6_scan_plain
    from repro_torch.kernels.ssd.kernel import ssd_scan, ssd_scan_plain

    flush = torch.empty(64 * 2**20, dtype=torch.int8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    out = {n: [] for n in TRAIN_KERNELS}
    smol = get_config(TRAIN_ARCH)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    d, H, Hkv = smol.d_model, smol.n_heads, smol.n_kv_heads
    D = smol.resolved_head_dim
    eps = smol.norm_eps
    out["rmsnorm"].append(_function_case(
        torch, "rmsnorm (15a)", functools.partial(rmsnorm, eps=eps),
        functools.partial(rmsnorm_plain, eps=eps),
        [rnd(B, S, d), torch.ones(d, device="cuda")], flush))
    out["flash_attention"].append(_function_case(
        torch, "flash_attention (15a)", flash_attention, flash_attention_plain,
        [rnd(B, H, S, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)], flush))
    Bf, Sf = TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ
    zam = get_config("zamba2-2.7b")
    d2 = 2 * zam.d_model
    D2 = d2 // zam.n_heads
    out["rmsnorm"].append(_function_case(
        torch, "rmsnorm (15d zamba2 shared block)",
        functools.partial(rmsnorm, eps=zam.norm_eps),
        functools.partial(rmsnorm_plain, eps=zam.norm_eps),
        [rnd(Bf, Sf, d2), torch.ones(d2, device="cuda")], flush))
    out["flash_attention"].append(_function_case(
        torch, "flash_attention (15d zamba2, D 160)", flash_attention,
        flash_attention_plain,
        [rnd(Bf, zam.n_heads, Sf, D2), rnd(Bf, zam.n_kv_heads, Sf, D2),
         rnd(Bf, zam.n_kv_heads, Sf, D2)], flush))
    d_inner = zam.ssm_expand * zam.d_model
    Hs, P, N, G = (d_inner // zam.ssm_head_dim, zam.ssm_head_dim,
                   zam.ssm_state, zam.ssm_groups)
    dt = torch.nn.functional.softplus(rnd(Bf, Sf, Hs, dtype=torch.float32) - 2)
    A = -torch.exp(rnd(Hs, dtype=torch.float32, scale=0.5))
    out["ssd_scan"].append(_function_case(
        torch, "ssd_scan (15d zamba2)", ssd_scan, ssd_scan_plain,
        [rnd(Bf, Sf, Hs, P), dt, A, rnd(Bf, Sf, G, N), rnd(Bf, Sf, G, N)],
        flush))
    rw = get_config("rwkv6-3b")
    Hr, K = rw.d_model // rw.rwkv_head_dim, rw.rwkv_head_dim
    logw = -torch.exp(rnd(Bf, Sf, Hr, K, dtype=torch.float32, scale=0.5) - 1)
    out["rwkv6_scan_log"].append(_function_case(
        torch, "rwkv6_scan_log (15d rwkv6)", rwkv6_scan_log, rwkv6_scan_plain,
        [rnd(Bf, Sf, Hr, K, scale=0.5), rnd(Bf, Sf, Hr, K, scale=0.5),
         rnd(Bf, Sf, Hr, K), logw.contiguous(), rnd(Hr, K, scale=0.5)],
        flush))
    mla = get_config("minicpm3-4b")
    dqk = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    out["flash_attention"].append(_function_case(
        torch, "flash_attention (15d minicpm3, D 96)",
        functools.partial(flash_attention, scale=dqk ** -0.5),
        functools.partial(flash_attention_plain, scale=dqk ** -0.5),
        [rnd(Bf, mla.n_heads, Sf, dqk), rnd(Bf, mla.n_heads, Sf, dqk),
         rnd(Bf, mla.n_heads, Sf, dqk)], flush))
    for name, cases in out.items():
        for c in cases:
            say(f"[kernels] {name} Function at {c['shape'][0]}: forward "
                f"{c['forward_ms']:.3f} ms, backward {c['backward_ms']:.3f} ms")
    return out


def phase_train(torch, card: str) -> tuple:
    """Phase 15: training on the ported kernels (see the module
    docstring)."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    summary, t = {}, {}
    t0 = time.perf_counter()
    launches, summary["main"] = phase_train_main(torch, card)
    t["15ab"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary["resume"] = phase_train_resume(torch)
    t["15c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fam_launches, summary["families"] = phase_train_families(torch)
    t["15d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary["compressed_dp"] = phase_train_dp(torch)
    t["15e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary["deq"] = phase_train_deq(torch)
    t["15f"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    functions = phase_train_functions(torch)
    t["15g"] = time.perf_counter() - t0
    summary["seconds"] = time.perf_counter() - t_phase
    summary["part_seconds"] = t
    say(f"[train] phase 15 took {summary['seconds']:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in t.items()))
    return {"train": launches, "train_families": fam_launches}, summary, functions


# -- phase 16: the tooling -------------------------------------------------------


def _tooling_dryrun_start():
    """``repro_torch.launch.dryrun --all`` in a child process (TOOLING_JOBS
    workers of one thread each, on the host's cores, while the card runs
    the shares): its records land one by one in experiments/dryrun_torch/,
    its log in chiprun_out/dryrun_all.log."""
    import shutil

    out = ROOT / "experiments" / "dryrun_torch"
    shutil.rmtree(out, ignore_errors=True)
    log_dir = ROOT / "chiprun_out"
    log_dir.mkdir(exist_ok=True)
    log = open(log_dir / "dryrun_all.log", "w")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    # a session of its own: its pool's workers are stopped with it
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--jobs",
         str(TOOLING_JOBS)], cwd=str(ROOT), env=env, stdout=log,
        stderr=subprocess.STDOUT, start_new_session=True)
    return proc, log, out


def _tooling_records(out, order, proc, deadline: float):
    """The dry run's records as they arrive (a file appears whole), the
    first ready one in ``order`` each time, until the dry run has ended
    and every present record was taken: yields ``(arch, shape, record)``.
    Fails if the dry run is still running at ``deadline``
    (``time.perf_counter()``)."""
    pending = list(order)
    while pending:
        ready = [c for c in pending if (out / f"{c[0]}__{c[1]}.json").exists()]
        if not ready:
            if proc.poll() is not None:
                return
            if time.perf_counter() > deadline:
                fail(f"the dry run had not ended within "
                     f"{TOOLING_DRYRUN_DEADLINE_S} s of phase 16's start; "
                     f"cells without a record: {pending}")
            time.sleep(0.5)
            continue
        arch, shape = ready[0]
        pending.remove((arch, shape))
        yield arch, shape, json.loads((out / f"{arch}__{shape}.json").read_text())


def _tooling_print_cell(rec: dict) -> None:
    pd, r, mf = rec["per_device"], rec["roofline"], rec["model_flops"]
    census = {op: (int(e["count"]), float(e["bytes"]))
              for op, e in rec["collectives"].items()}
    say(f"[tooling] dryrun {rec['arch']} x {rec['shape']} x {rec['mesh']}: "
        f"{pd['logical_flops']:.6g} flop and {pd['logical_bytes_fused_est']:.6g} "
        f"B fused ({pd['logical_bytes_unfused']:.6g} unfused) a device; peak "
        f"{rec['share']['peak_bytes']:.6g} B a one-card share (batch "
        f"{rec['share']['batch']}); per rank {rec['per_rank_bytes']}; "
        f"collectives {census}; roofline compute {r['compute_s'] * 1e3:.4f} ms, "
        f"memory {r['memory_s'] * 1e3:.4f} ms, collective "
        f"{r['collective_s'] * 1e3:.4f} ms -> {r['bottleneck']}; useful "
        f"{mf['useful_fraction']}")


def _tooling_real(torch, meta, gen, vocab: int):
    """A real tensor on the card for each ``meta`` one of a batch or cache
    struct: token ids drawn below ``vocab``, embeddings standard normal,
    a cache zeroed."""
    from repro_torch.core import tree as tree_lib

    def real(t):
        if t.dtype in (torch.int32, torch.int64):
            return torch.randint(0, vocab, tuple(t.shape), generator=gen,
                                 device="cuda", dtype=t.dtype)
        return torch.zeros(tuple(t.shape), dtype=t.dtype, device="cuda")

    if isinstance(meta, dict) and ("tokens" in meta or "embeds" in meta):
        out = {}
        for k, t in meta.items():
            if k == "embeds":
                out[k] = torch.randn(tuple(t.shape), generator=gen,
                                     device="cuda").to(t.dtype)
            else:
                out[k] = real(t)
        if "labels" in out and "tokens" in out:
            out["labels"] = out["tokens"]
        return out
    return tree_lib.tree_map(real, meta)


def _tooling_share(torch, rec: dict) -> tuple:
    """One cell's one-card share on the card in the cuda space: built from
    the dry run's structs, one warm step, one timed step; measured against
    predicted peak bytes, the step against the share's roofline; a prefill's
    last-position logits of the second sequence against that sequence run
    alone in the cuda space, and of the first against the torch space (MoE
    routes replayed in both)."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.core import make_executor
    from repro_torch.launch import dryrun
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch.mesh import Mesh, use_mesh
    from repro_torch.models import lm
    from repro_torch.nn import moe as moe_lib
    from repro_torch.nn.common import trainable

    arch, shape = rec["arch"], rec["shape"]
    cell = dryrun.build_cell(arch, shape)
    cfg, kind = cell.cfg, cell.shape.kind
    B, S = cell.share_batch, cell.shape.seq_len
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED + 16)
    folded = Mesh({name: 1 for name in cell.mesh.axis_names})
    ex = make_executor("cuda")
    tag = f"[tooling] share {arch} x {shape} (batch {B}, {S} tokens)"
    summary = {"arch": arch, "shape": shape, "kind": kind, "batch": B,
               "seq_len": S, "predicted_peak_bytes": rec["share"]["peak_bytes"],
               "bound_ms": rec["share"]["roofline"]["bound_s"] * 1e3}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    if cfg.family == "rwkv6":
        # phase 9 (b)'s seeded decays: at the JAX package's init (every
        # decay e^-1) the bf16 model is 0.3-0.4 of max |logit| from its own
        # f32 result in either space, at 2,048 tokens as at 32k
        _perturb_rwkv(torch, params, SEED + 9)
    meta = cell.args(B)
    if kind == "train":
        params = trainable(params)
        args = [params, cell.optimizer.init(params),
                _tooling_real(torch, meta[2], gen, cfg.vocab)]
    elif kind == "prefill":
        args = [params, _tooling_real(torch, meta[1], gen, cfg.vocab),
                _tooling_real(torch, meta[2], gen, cfg.vocab)]
    else:
        args = [params, _tooling_real(torch, meta[1], gen, cfg.vocab), S - 1,
                _tooling_real(torch, meta[3], gen, cfg.vocab)]
    torch.cuda.synchronize()
    summary["setup_s"] = time.perf_counter() - t0
    step = cell.step(ex)
    routes = None
    try:
        torch.cuda.reset_peak_memory_stats()
        with use_mesh(folded):
            step(*args)  # warm
            if kind == "prefill":
                # a prefill starts from an empty cache: Zamba2's reads the
                # conv window the warm step left there
                for leaf in tree_lib.leaves(args[2]):
                    leaf.zero_()
            torch.cuda.synchronize()
            K.reset_launch_counts()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            with _Routes(torch, moe_lib) as routes:
                t1 = time.perf_counter()
                start.record()
                out = step(*args)
                end.record()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
            launches = K.launch_counts()
    except torch.cuda.OutOfMemoryError as e:
        fail(f"{tag}: predicted {rec['share']['peak_bytes']:.6g} B fits, but "
             f"the step ran out of memory: {e}")
    peak = torch.cuda.max_memory_allocated() - base
    ms = start.elapsed_time(end)
    tokens = B * (S if kind != "decode" else 1)
    summary.update(step_ms=ms, wall_ms=wall * 1e3, tokens_per_s=tokens / (ms * 1e-3),
                   measured_peak_bytes=peak,
                   peak_ratio=peak / rec["share"]["peak_bytes"],
                   roofline_fraction=summary["bound_ms"] / ms,
                   launches={k: v for k, v in launches.items() if v})
    say(f"{tag}: step {ms:.3f} ms (wall {wall * 1e3:.3f}), {tokens / (ms * 1e-3):.1f} "
        f"tokens/s; peak {peak:.6g} B measured against {rec['share']['peak_bytes']:.6g} "
        f"predicted ({summary['peak_ratio']:.4f}); roofline {summary['bound_ms']:.3f} "
        f"ms, {summary['roofline_fraction']:.4f} of it; launches "
        f"{summary['launches']}")
    used = {n for n, v in launches.items() if v}
    want = {"rmsnorm"} if cfg.norm_kind == "rmsnorm" else set()
    if kind != "decode" and not cfg.is_attention_free:
        want.add("flash_attention")
    if cfg.family == "hybrid" and kind != "decode":
        want.add("ssd_scan")
    if cfg.family == "rwkv6" and kind != "decode":
        want.add("rwkv6_scan_log")
    if not want <= used:
        fail(f"{tag}: kernels {sorted(want - used)} were not launched")
    if kind == "prefill":
        logits = out[0].float()
        if not _finite(torch, logits):
            fail(f"{tag}: non-finite logits")
        out = None
        del args[2]
        torch.cuda.empty_cache()
        # the second sequence (the largest batch offsets) alone at batch
        # index 0 in the cuda space, held against the batch's: a fault that
        # touches only batch index 1 shows here, and index 0 is held
        # against the torch space below
        second = {k: v[1:2] for k, v in args[1].items()}
        replay = ([ids[S:2 * S] for ids in routes.ids]
                  if cfg.family == "moe" else None)
        with torch.no_grad(), use_mesh(folded), \
                _Routes(torch, moe_lib, replay=replay):
            alone = step(params, second, lm.init_cache(cfg, 1, S, dev))[0].float()
        err2 = _rel_err(logits[1:2], alone)
        summary.update(second_alone_err=err2,
                       second_alone_bitwise=bool(torch.equal(logits[1:2], alone)))
        say(f"{tag}: the second sequence's last-position logits against the "
            f"same sequence alone (batch 1, cuda space"
            f"{', routes replayed' if replay else ''}): {err2:.4e} of max "
            f"|logit| (tolerance {LM_BF16_TOL}); bitwise: "
            f"{summary['second_alone_bitwise']}")
        if not err2 <= LM_BF16_TOL:
            fail(f"{tag}: the second sequence's logits are {err2} of max "
                 f"|logit| from the same sequence run alone")
        del alone
        torch.cuda.empty_cache()
        logits = logits[:1]
        ex_t = make_executor("torch", device=dev)
        first = {k: v[:1] for k, v in args[1].items()}
        cache1 = lm.init_cache(cfg, 1, S, dev)
        replay = [ids[:S] for ids in routes.ids] if cfg.family == "moe" else None
        t1 = time.perf_counter()
        # TF32 in the reference's f32 products (its chunked attention's):
        # quicker at 32k, its rounding far inside LM_BF16_TOL
        torch.backends.cuda.matmul.allow_tf32 = True
        with torch.no_grad(), use_mesh(folded), \
                _Routes(torch, moe_lib, replay=replay):
            ref = cell.step(ex_t)(params, first, cache1)[0].float()
        torch.cuda.synchronize()
        torch.backends.cuda.matmul.allow_tf32 = False
        err = _rel_err(logits, ref)
        summary.update(torch_space_err=err,
                       torch_space_s=time.perf_counter() - t1,
                       top1_agree=bool((logits.argmax(-1) == ref.argmax(-1)).all()))
        say(f"{tag}: last-position logits against the torch space (chunked "
            f"attention, TF32, the first sequence"
            f"{', routes replayed' if replay else ''}): {err:.4e} of max "
            f"|logit| (tolerance {LM_BF16_TOL}); top-1 "
            f"agrees: {summary['top1_agree']}; {summary['torch_space_s']:.1f} s")
        if not err <= LM_BF16_TOL:
            fail(f"{tag}: logits {err} of max |logit| from the torch space")
        del ref, cache1
    elif kind == "train":
        summary["loss"] = float(out[2]["loss"])
        if not summary["loss"] == summary["loss"]:
            fail(f"{tag}: the loss is not finite")
    elif not _finite(torch, out[0]):
        fail(f"{tag}: non-finite logits")
    del out, args, params
    torch.cuda.empty_cache()
    return summary, launches


def _tooling_flash_rows(torch, q, k, v, o, starts) -> float:
    """The flash kernel's output rows of three query blocks (128 rows from
    each of ``starts``) against a dense f32 computation of those rows only
    (the whole dense plain version at 32k would hold 137 GB of scores for
    one sequence), held together as phase 8 holds a whole output: one bf16
    ulp of each element plus 1e-5 of the largest over the rows held (the
    last rows average 32k values, so their own largest is 0.05 where the
    first rows' reaches 3.6); returns the largest error.  SDPA's rows
    (causal) are printed on the same ruler beside them, not held."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    kf = torch.repeat_interleave(k, H // Hkv, dim=1).float()
    vf = torch.repeat_interleave(v, H // Hkv, dim=1).float()
    refs = []
    for r0 in starts:
        rows = torch.arange(r0, r0 + 128, device="cuda")
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r0 + 128].float(),
                         kf) / D ** 0.5
        kv = torch.arange(S, device="cuda")
        s = s.masked_fill(kv[None, :] > rows[:, None], float("-inf"))
        refs.append(torch.softmax(s, dim=-1) @ vf)
        del s
    ref = torch.cat(refs, dim=2)
    del refs
    err = _held(torch, f"flash_attention rows {list(starts)} (+128 each) at "
                f"S = Skv = {S}", torch.cat([o[:, :, r0:r0 + 128]
                                             for r0 in starts], dim=2),
                ref, 2.0 ** -7, 1e-5)
    # the library call's rows on the same ruler, for comparison only
    lib = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    lib = torch.cat([lib[:, :, r0:r0 + 128] for r0 in starts], dim=2).float()
    ratio = float(((lib - ref).abs() / (2.0 ** -7 * ref.abs() + 1e-5
                                        * float(ref.abs().max()))).max())
    say(f"[kernels] scaled_dot_product_attention rows at S = Skv = {S} (not "
        f"held): max_abs_err {float((lib - ref).abs().max()):.3e}; largest "
        f"error {ratio:.3f} of the same tolerance")
    return err


def phase_tooling_kernels(torch, copy_bw) -> dict:
    """The four LM kernels at the shape cells' shapes: flash_attention at
    S = Skv = 32,768 (granite-8b's heads, the prefill share's batch),
    rmsnorm at 65,536 rows (granite's d), ssd_scan at zamba2's and
    rwkv6_scan_log at rwkv6's 2 x 32,768; each held against its plain
    version and timed with its bound and library call."""
    from repro_torch import kernels as K
    from repro_torch.core.params import H100
    from repro_torch.nn.attention import attention_chunked

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    bf16 = torch.bfloat16
    B, S = 2, 32768
    out = {}

    H, Hkv, D = 32, 8, 128
    q = torch.randn(B, H, S, D, generator=gen, device="cuda").to(bf16)
    k = torch.randn(B, Hkv, S, D, generator=gen, device="cuda").to(bf16)
    v = torch.randn(B, Hkv, S, D, generator=gen, device="cuda").to(bf16)
    o = K.flash_attention(q, k, v)
    err = _tooling_flash_rows(torch, q, k, v, o, (0, S // 2 - 64, S - 128))
    same = torch.equal(o, K.flash_attention(q, k, v))
    if not same:
        fail("flash_attention at 32k: a repeat is not bitwise equal")
    del o
    pairs = S * (S + 1) // 2
    out["flash_attention"] = kernel_row(
        torch, flush, copy_bw, "flash_attention", "flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:118", err,
        lambda: K.flash_attention(q, k, v),
        lambda: attention_chunked(q, k, v),
        2 * B * (H + Hkv) * S * D * 2, 4 * D * B * H * pairs,
        functools.partial(torch.nn.functional.scaled_dot_product_attention,
                          q, k, v, is_causal=True, enable_gqa=True),
        peak_flops=H100.peak_flops_bf16, reps=TOOLING_REPS)
    out["flash_attention"]["shape"] = {"B": B, "Hq": H, "Hkv": Hkv, "S": S,
                                       "Skv": S, "D": D,
                                       "plain": "attention_chunked (chunk 512)"}
    del q, k, v

    rows, d = B * S, 4096
    x = torch.randn(rows, d, generator=gen, device="cuda").to(bf16)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    err = _held(torch, f"rmsnorm at {rows} x {d}", K.rmsnorm(x, w, 1e-5),
                K.rmsnorm_plain(x, w, 1e-5), 2.0 ** -7, 1e-6)
    w_lib = w.to(bf16)
    out["rmsnorm"] = kernel_row(
        torch, flush, copy_bw, "rmsnorm", "rmsnorm.cu",
        "src/repro/kernels/rmsnorm/kernel.py:27", err,
        lambda: K.rmsnorm(x, w, 1e-5), lambda: K.rmsnorm_plain(x, w, 1e-5),
        2 * rows * d * 2 + d * 4, 4 * rows * d,
        lambda: torch.nn.functional.rms_norm(x, (d,), w_lib, 1e-5))
    out["rmsnorm"]["shape"] = {"rows": rows, "d": d}
    del x

    Hs, P, G, N = 80, 64, 2, 64
    conv = torch.randn(B, S, Hs * P + 2 * G * N, generator=gen, device="cuda")
    conv[..., Hs * P:] *= 0.3
    xv, Bv, Cv = torch.split(conv.to(bf16), [Hs * P, G * N, G * N], dim=-1)
    xs = xv.reshape(B, S, Hs, P).contiguous()
    Bm, Cm = (t.reshape(B, S, G, N).contiguous() for t in (Bv, Cv))
    del conv, xv, Bv, Cv
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, Hs, generator=gen, device="cuda") - 1.0)
    A = -torch.exp(0.5 * torch.randn(Hs, generator=gen, device="cuda"))
    y, h = K.ssd_scan(xs, dt, A, Bm, Cm)
    yp, hp = K.ssd_scan_plain(xs, dt, A, Bm, Cm)
    err = max(_held(torch, f"ssd_scan y at B {B}, S {S}", y, yp, 2.0 ** -7, 1e-4),
              _held(torch, f"ssd_scan state at B {B}, S {S}", h, hp, 0.0, 1e-4))
    del y, h, yp, hp
    L = 64
    out["ssd_scan"] = kernel_row(
        torch, flush, copy_bw, "ssd_scan", "ssd_scan.cu",
        "src/repro/kernels/ssd/kernel.py:98", err,
        lambda: K.ssd_scan(xs, dt, A, Bm, Cm),
        lambda: K.ssd_scan_plain(xs, dt, A, Bm, Cm),
        2 * B * S * Hs * P * 2 + B * S * Hs * 4 + 2 * B * S * G * N * 2
        + Hs * 4 + B * Hs * N * P * 4,
        2 * L * (L * N + L * P + 2 * N * P) * B * Hs * -(-S // L),
        peak_flops=H100.peak_flops_bf16, reps=TOOLING_REPS)
    out["ssd_scan"]["shape"] = {"B": B, "S": S, "H": Hs, "P": P, "G": G, "N": N}
    del xs, dt, A, Bm, Cm

    H, D = 40, 64
    r, kk, vv = (torch.randn(B, S, H, D, generator=gen, device="cuda").to(bf16)
                 for _ in range(3))
    logw = -torch.exp(-1.0 + torch.randn(B, S, H, D, generator=gen, device="cuda"))
    u = (0.5 * torch.randn(H, D, generator=gen, device="cuda")).to(bf16)
    args = (r, kk, vv, logw, u)
    y, st = K.rwkv6_scan_log(*args)
    yp, sp = K.rwkv6_scan_plain(*args)
    err = max(_held(torch, f"rwkv6_scan_log y at B {B}, S {S}", y, yp, 2.0 ** -7,
                    1e-4),
              _held(torch, f"rwkv6_scan_log state at B {B}, S {S}", st, sp, 0.0,
                    1e-4))
    del y, st, yp, sp
    lower = L * (L - 1) // 2
    out["rwkv6_scan_log"] = kernel_row(
        torch, flush, copy_bw, "rwkv6_scan_log", "rwkv6_scan.cu",
        "src/repro/kernels/rwkv6/kernel.py:124", err,
        lambda: K.rwkv6_scan_log(*args), lambda: K.rwkv6_scan_plain(*args),
        4 * B * S * H * D * 2 + B * S * H * D * 4 + B * H * D * D * 4 + H * D * 2,
        B * H * -(-S // L) * (4 * L * D * D + 2 * lower * D + 4 * lower * D),
        peak_flops=H100.peak_flops_bf16, reps=TOOLING_REPS)
    out["rwkv6_scan_log"]["shape"] = {"B": B, "S": S, "H": H, "K": D, "V": D}
    del args, r, kk, vv, logw, u
    torch.cuda.empty_cache()
    return out


def phase_tooling_inspect(torch) -> dict:
    """``inspect solve`` for each solver at the default n on the card with a
    trace and metrics, then ``trace``, ``validate`` and ``metrics`` on those
    files; every command must return 0."""
    from repro_torch.launch import inspect as inspect_lib
    from repro_torch.observability import metrics, trace

    out_dir = ROOT / "chiprun_out" / "inspect"
    out_dir.mkdir(parents=True, exist_ok=True)
    rcs = {}
    for solver in TOOLING_SOLVERS:
        tr, me = out_dir / f"{solver}.json", out_dir / f"{solver}.jsonl"
        trace.reset()
        metrics.reset()
        rcs[f"solve {solver}"] = inspect_lib.main(
            ["solve", "--solver", solver, "--trace", str(tr), "--metrics",
             str(me)])
        trace.disable()
        for cmd, path in (("trace", tr), ("validate", tr), ("metrics", me)):
            rcs[f"{cmd} {solver}"] = inspect_lib.main([cmd, str(path)])
    bad = {k: v for k, v in rcs.items() if v != 0}
    say(f"[tooling] inspect: {len(rcs)} commands, exit codes {rcs}")
    if bad:
        fail(f"inspect commands failed: {bad}")
    return rcs


def phase_tooling(torch, copy_bw) -> tuple:
    """Phase 16: the dry run of every cell (in a child process), the
    one-card shares predicted to fit (run as their records arrive), the four
    LM kernels at the cells' shapes, and inspect on the card."""
    from repro_torch.configs import ARCH_IDS, cells

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    proc, log, out = _tooling_dryrun_start()
    _, total = torch.cuda.mem_get_info()
    limit = TOOLING_FIT * total
    say(f"[tooling] dry run started ({TOOLING_JOBS} processes); shares run "
        f"where the predicted peak is within {TOOLING_FIT} of the card's "
        f"{total} B ({limit:.6g} B)")
    order = sorted(((a, s) for a in ARCH_IDS for s in cells(a)),
                   key=lambda c: (c[0] in ("zamba2_2_7b", "rwkv6_3b"),
                                  c[1] == "train_4k"))
    summary = {"shares": [], "not_run": [], "limit_bytes": limit,
               "card_bytes": total}
    launches = collections.Counter()
    records, t = {}, {}
    try:
        # the four kernels at the cells' shapes first: the card would wait
        # for the dry run's first records meanwhile
        t0 = time.perf_counter()
        rows = phase_tooling_kernels(torch, copy_bw)
        t["kernels"] = time.perf_counter() - t0
        deadline = t_phase + TOOLING_DRYRUN_DEADLINE_S
        for arch, shape, rec in _tooling_records(out, order, proc, deadline):
            records[arch, shape] = rec
            _tooling_print_cell(rec)
            peak = rec["share"]["peak_bytes"]
            if peak > limit:
                summary["not_run"].append({"arch": arch, "shape": shape,
                                           "predicted_peak_bytes": peak})
                say(f"[tooling] share {arch} x {shape} not run: predicted "
                    f"peak above the limit ({peak:.6g} B)")
                continue
            t_share = time.perf_counter()
            s, counts = _tooling_share(torch, rec)
            s["seconds"] = time.perf_counter() - t_share
            say(f"[tooling] share {arch} x {shape}: {s['seconds']:.1f} s, "
                f"{time.perf_counter() - t_phase:.1f} s into the phase")
            summary["shares"].append(s)
            launches.update(counts)
            if "dryrun_seen_ended_s" not in summary and proc.poll() is not None:
                summary["dryrun_seen_ended_s"] = time.perf_counter() - t_phase
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            fail(f"the dry run had not ended within {TOOLING_DRYRUN_DEADLINE_S} "
                 f"s of phase 16's start")
        summary.setdefault("dryrun_seen_ended_s", time.perf_counter() - t_phase)
    finally:
        import signal

        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        log.close()
    tail = (ROOT / "chiprun_out" / "dryrun_all.log").read_text().splitlines()[-3:]
    say(f"[tooling] dry run exit code {rc}: {tail}")
    missing = [(a, s) for a in ARCH_IDS for s in cells(a)
               if (a, s) not in records]
    if rc != 0 or missing:
        fail(f"the dry run failed (exit code {rc}); cells without a record: "
             f"{missing}")
    summary["cells"] = len(records)
    summary["dryrun_cell_s"] = max(r["build_s"] for r in records.values())
    t["shares"] = time.perf_counter() - t_phase - t["kernels"]
    t0 = time.perf_counter()
    summary["inspect"] = phase_tooling_inspect(torch)
    t["inspect"] = time.perf_counter() - t0
    summary["part_seconds"] = t
    summary["seconds"] = time.perf_counter() - t_phase
    say(f"[tooling] phase 16 took {summary['seconds']:.1f} s: {len(records)} "
        f"cells built (the dry run seen ended {summary['dryrun_seen_ended_s']:.1f} "
        f"s in), {len(summary['shares'])} shares run, "
        f"{len(summary['not_run'])} not run; parts (s) {t}")
    return dict(launches), summary, rows


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import make_executor
    from repro_torch.precond import block_jacobi
    from repro_torch.sparse import ell_from_csr_host, gallery

    t_start = time.perf_counter()
    card = phase_card(torch)
    build_s = phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    ip, ix, v, shape = gallery.poisson_3d(N_SIDE)
    A_host = dict(indptr=ip.astype(np.int32), indices=ix, values=v)
    A = ell_from_csr_host(ip, ix, v, shape, device="cuda")
    b = torch.from_numpy(
        np.random.default_rng(SEED).standard_normal(shape[0]).astype(np.float32)
    ).cuda()
    ex = make_executor("cuda")
    P = block_jacobi(A, PRECOND_OPTS["block_size"],
                     adaptive=PRECOND_OPTS["adaptive"], executor=ex)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    say(f"[setup] poisson_3d({N_SIDE}): {shape[0]} rows, ELL k = "
        f"{A.max_nnz}, {A.memory_bytes} bytes; block-Jacobi "
        f"{P.precision_counts}, {P.storage_bytes} bytes; {setup_s:.2f} s")

    copy_bw = copy_bandwidth(torch)
    rows = phase_kernels(torch, A, A_host, P, ex, copy_bw)
    del P
    launches, by_storage, path = phase_path(torch, A, b)
    x4 = path.pop("x")
    paths = {"block_jacobi_cg": (launches, by_storage)}
    prof4 = path["profile"]
    pipe_launches, pipe_storage, path["pipelined_cg"] = phase_pipelined(
        torch, (ip, ix, v, shape), b, path["iterations"],
        prof4["device_busy_us"] / prof4["iterations"])
    fcg_launches, fcg_storage, path["fcg"] = phase_fcg(torch, A, b)
    paths.update({"pipelined_cg": (pipe_launches, pipe_storage),
                  "fcg": (fcg_launches, fcg_storage)})
    phase_small_reference(torch)
    del A
    amg_launches, amg_storage, path["amg"], amg_rows, held_amg, ell_levels = \
        phase_amg(torch, copy_bw)
    rows.update(amg_rows)
    rows["spmv_ell"]["at_amg_levels"] = ell_levels
    rows["spmv_ell"]["max_abs_err"] = max(rows["spmv_ell"]["max_abs_err"],
                                          ell_levels["max_abs_err"])
    sellp_launches, path["sellp"], sellp_rows = phase_sellp(torch, copy_bw)
    rows.update(sellp_rows)
    batch_launches, batch_storage, path["batch"], batch_rows, held_batch = \
        phase_batch(torch, copy_bw)
    rows.update(batch_rows)
    lm_launches, path["zamba2_serve"], lm_rows = phase_lm(torch, copy_bw)
    rows.update(lm_rows)
    rwkv_launches, path["rwkv6_serve"], rwkv_rows = phase_rwkv(torch, copy_bw)
    rows.update(rwkv_rows)
    krylov_paths, path["krylov"], held_cgs = phase_krylov(torch, copy_bw)
    serve_paths, path["solve_serve"], held_serve = phase_serve(torch, card,
                                                               copy_bw)
    dist_paths, path["distributed"] = phase_dist(
        torch, (ip, ix, v, shape), b, path["iterations"], x4,
        path["precision_counts"])
    path["implicit"] = phase_implicit(torch)
    family_paths, path["lm_families"], family_rows = phase_families(torch,
                                                                   copy_bw)
    train_paths, path["train"], train_functions = phase_train(torch, card)
    tool_launches, path["tooling"], tool_rows = phase_tooling(torch, copy_bw)
    paths.update({"amg_check": (amg_launches, amg_storage),
                  "sellp_cg": (sellp_launches, {}),
                  "batch_solve": (batch_launches, batch_storage),
                  "zamba2_serve": (lm_launches, {}),
                  "rwkv6_serve": (rwkv_launches, {}), **krylov_paths,
                  **serve_paths, **dist_paths,
                  **{p: (c, {}) for p, c in family_paths.items()},
                  **{p: (c, {}) for p, c in train_paths.items()},
                  "tooling_shares": (tool_launches, {})})
    # phase 16's cell shapes of the four LM kernels, and the larger error
    for name, extra in tool_rows.items():
        rows[name]["at_cell_shapes"] = extra
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        extra["max_abs_err"])
    # each LM kernel's autograd Function, held and timed (15g)
    for name, cases in train_functions.items():
        rows[name]["train_function"] = cases
    # phase 14's shapes of the two LM kernels, and the larger error
    for name, extra in family_rows.items():
        rows[name]["at_family_shapes"] = extra
        rows[name]["max_abs_err"] = max(
            [rows[name]["max_abs_err"]] + [e["max_abs_err"] for e in extra])

    # a kernel also held at a later path's shapes: that row, and the larger
    # error (for block_jacobi_apply, in the variant of its storage)
    for key, held in (("at_amg_path_shape", held_amg),
                      ("at_batch_path_shape", held_batch),
                      ("at_serve_path_shape", held_serve),
                      ("at_adaptive_cgs_path_shape", held_cgs)):
        for name, extra in held.items():
            for e in extra:
                targets = [v for v in rows[name].get("storage_variants", ())
                           if v["storage"] == e.get("storage")
                           and v.get("vector") == e.get("vector")] or [rows[name]]
                for t in targets:
                    t[key] = e
                    t["max_abs_err"] = max(t["max_abs_err"], e["max_abs_err"])
    for entry in rows.values():
        variants = entry.get("storage_variants")
        if variants:
            entry["max_abs_err"] = max(v["max_abs_err"] for v in variants)

    # launches: the sum over the paths' counted runs, and each path's;
    # block_jacobi_apply's storage variants likewise, per storage dtype
    for name, entry in rows.items():
        entry["launches_by_path"] = {p: counts.get(name, 0)
                                     for p, (counts, _) in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        for var in entry.get("storage_variants", ()):
            # f64 vectors' reduced classes are counted as "float64/<storage>"
            counted_as = (var["storage"] if var["vector"] == "float32"
                          or var["storage"] == "float64"
                          else f"float64/{var['storage']}")
            var["launches_by_path"] = {
                p: storage.get(counted_as, 0)
                for p, (_, storage) in paths.items()}
            var["launches"] = sum(var["launches_by_path"].values())
    for name, entry in rows.items():
        if entry["launches"] <= 0:
            fail(f"kernel {name} was launched on none of the paths")
    say(json.dumps({"card": card, "build_s": build_s,
                    "copy_gbs": copy_bw / 1e9, "path": path,
                    "total_s": time.perf_counter() - t_start}))
    say(json.dumps({"kernels": list(rows.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
